"""The ``3D`` and ``BEV`` Vernier heads trained on a model axis
(models/vernier.py: each head on its slab of lengths up to its gather),
on the port's one-process mesh (``make_mesh(1, devices, n_model)``,
parallel/local.py) on the CPU, against JAX's step on
``make_mesh(n_data=1, n_model=2)`` (the voxel under ``P("data", None,
None, "model", None)``, as ``make_train_step`` puts it for every head)
and against the port's one-device step.

The setup of tests/test_torch_variants_train.py (``tiny_vernier_config``
at 384x1280, 4 instances, ``3D`` with ``grid_type="3D"`` and 3 parts),
one step with ``warmup_steps=0``: ``3D`` on the grid 8 x 16 x 12 (its
hourglass's units of 4 lengths split 8 / 4 at n_model 2, where GSPMD
splits 6 / 6 and pads), ``BEV`` on 8 x 16 x 16 (the HRNet after its
stride-2 conv needs the 16 lengths): 8 / 8 at n_model 2, 8 / 4 / 4 at
n_model 3.

* Against JAX's float32 mesh step, the port's float64 step on
  make_mesh(1, 2) at the margins of tests/test_torch_parallel_train.py
  (JAX's own float32 drift): losses 1e-3 relative, ``grad_norm`` 2e-3,
  gradients 0.06 global relative L2 and each within 0.2 of its scale,
  BatchNorm statistics 1e-4 of scale; for BEV ``grad_norm`` within
  1e-2, the gradients 0.1 global relative L2 and the statistics 1e-3 of
  scale.  BEV is the ill-conditioned head
  (tests/test_torch_variants_train.py), and JAX's jitted step assembles
  its inputs and targets inside the jit, where they differ from its
  eager ones (at voxel edges: the port follows the eager ones).  Measured
  on a CPU on this batch, JAX against itself: its float64 step from the
  eager inputs and targets (tests/test_torch_variants_train.py's
  witness) gives ``grad_norm`` 842.988, its float32 mesh step 835.316
  (835.392 in float64 on the mesh), 0.0618 apart in the clipped
  gradients (global relative L2) and 8.3e-4 of scale in the statistics.
  The port gives 842.962, 0.0618 and 1.3e-4 from the mesh step.
* In float64 (the model, GroupNorm's moments; the sampler's projections
  and the losses stay float32) against the port's one-device step: 3D on
  make_mesh(1, 2), BEV on make_mesh(1, 2) and make_mesh(1, 3): losses
  and ``grad_norm`` to 1e-5 relative, gradients and BatchNorm statistics
  to 1e-5 (global relative L2; each element within 1e-5 of its tensor's
  scale or 1e-8), the parameters within Adam's sign-flip bound 2 x lr
  and 1e-5 global relative L2.
* Each position's head takes its slab of lengths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.parallel.api import make_mesh as jmake_mesh
from snvc_tpu.parallel.api import shard_instance_batch as jshard
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train import make_train_step as jmake_train_step
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    as_numpy,
    float64_moments,
    vernier_record,
)
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
TC = dict(lr=1e-3, warmup_steps=0, total_steps=50, grad_clip=5.0)
HEADS = {"3D": dict(vernier_type="3D", grid_type="3D", num_parts=3,
                    grid_resolution=(8, 16, 12)),
         "BEV": dict(vernier_type="BEV", grid_resolution=(8, 16, 16))}
# (head, n_model) -> the slabs of the lengths
SPLITS = {("3D", 2): [8, 4], ("BEV", 2): [8, 8], ("BEV", 3): [8, 4, 4]}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record(jcfg, v):
    jmod = JVernier(jcfg)
    jtc = JTrainConfig(**TC)
    state = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                   batch_stats=v["batch_stats"],
                   opt_state=jmake_optimizer(jtc).init(v["params"]))
    mesh = jmake_mesh(n_data=1, n_model=2)
    step = jmake_train_step(jmod, jcfg, jtc, mesh=mesh)
    state, m = step(state, jshard(jbatch(jcfg, seed=0), mesh),
                    jax.random.PRNGKey(1))
    state = jax.device_get(state)
    return dict(
        metrics=[{k: float(a) for k, a in m.items()}],
        grads={n: w / 0.1 for n, w in convert_variables(
            {"params": state.opt_state[1][0].mu}).items()},
        stats=convert_variables({"batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def runs():
    tc = TrainConfig(**TC)
    res = dict(jax={}, one={}, local={})
    for head, kw in HEADS.items():
        jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE, **kw)
        H, W = jcfg.resolution
        nh, nw, nl = jcfg.grid_resolution
        x = np.zeros((1, H, W, 3), np.float32)
        p = np.zeros((1, nh * nw * nl, 2), np.float32)
        v = random_variables(JVernier(jcfg), x, x, p, p, seed=3)
        res["jax"][head] = _jax_record(jcfg, v)
        tcfg = torch_vernier_config(jcfg)
        case = (tcfg, tc, as_numpy(convert_variables(v)),
                as_numpy(synthetic_batch_arrays(tcfg, seed=0)))
        with float64_moments(True):
            res["one"][head] = vernier_record(*case, True, steps=1)
            for h, n in SPLITS:
                if h == head:
                    res["local"][(h, n)] = vernier_record(
                        *case, True, mesh=make_mesh(1, ["cpu"] * n, n),
                        steps=1)
    return res


def _rel_l2(got, want):
    num = sum(float(((got[n].double() - w.double()) ** 2).sum())
              for n, w in want.items())
    return np.sqrt(num / sum(float((w.double() ** 2).sum())
                             for w in want.values()))


@pytest.mark.parametrize("split", list(SPLITS), ids=str)
def test_each_position_holds_its_slab_of_lengths(runs, split):
    shapes = runs["local"][split]["voxel_shapes"]
    assert sorted(s[3] for s in shapes) == sorted(SPLITS[split])


@pytest.mark.parametrize("split", list(SPLITS), ids=str)
def test_float64_step_matches_one_device(runs, split):
    got, want = runs["local"][split], runs["one"][split[0]]
    for k, w in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=1e-5,
                                   err_msg=k)
    for key in ("grads", "stats", "params"):
        if want[key]:
            assert _rel_l2(got[key], want[key]) <= 1e-5, key
    for key in ("grads", "stats"):
        for n, w in want[key].items():
            torch.testing.assert_close(
                got[key][n], w, rtol=0,
                atol=max(1e-5 * float(w.abs().max()), 1e-8),
                msg=f"{key} {n}")
    err = np.concatenate([(got["params"][n] - w).abs().numpy().ravel()
                          for n, w in want["params"].items()])
    assert err.max() <= 2.0 * TC["lr"] + 1e-8


@pytest.mark.parametrize("head", list(HEADS))
def test_step_matches_jax_mesh_step(runs, head):
    got, want = runs["local"][(head, 2)], runs["jax"][head]
    heads = {"ncf"} if head == "3D" else {"ncf", "occupancy"}
    assert heads | {"total", "grad_norm"} == set(want["metrics"][0])
    # the module docstring: BEV's jitted inputs and targets
    norm_rtol, grads_l2, stats_tol = ((1e-2, 0.1, 1e-3) if head == "BEV"
                                      else (2e-3, 0.06, 1e-4))
    for k, w in want["metrics"][0].items():
        rtol = norm_rtol if k == "grad_norm" else 1e-3
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    for n, g in grads.items():
        w = want["grads"][n]
        err = float((g - w).abs().max())
        assert err <= 0.2 * float(w.abs().max()) + 1e-7, (n, err)
    assert _rel_l2(grads, want["grads"]) <= grads_l2
    for n, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n].float().numpy(),
                                   w.numpy(), rtol=0,
                                   atol=stats_tol * np.abs(w.numpy()).max(),
                                   err_msg=n)
