"""The one-process data x model mesh of the port driving the Vernier step
(``make_train_step(mesh=make_mesh(n_data, devices, n_model))``,
parallel/local.py: a thread a position, one backward) on the CPU, against
JAX's one-process mesh steps and against the port's one-device step and
process-group form.

The setup of tests/test_torch_tensor_parallel_train.py
(``tiny_vernier_config`` at 384x1280, the seeded
``synthetic_batch_arrays`` batch, one step with ``warmup_steps=0``) on
the grid 8 x 16 x 12: at n_model 2 its 12 lengths split 8 / 4 (units of
4, the hourglass's 2^levels, spread as ``np.array_split`` spreads them),
where GSPMD splits them 6 / 6 and pads the hourglass's 3-length level.

* JAX's ``make_train_step`` on ``make_mesh(n_data=1, n_model=2)`` (4
  instances) and ``make_mesh(n_data=2, n_model=2)`` (8 instances, 4 a
  data position: 2-3 a position reach the host's oneDNN crash): the
  port's float64 step on the same one-process meshes at the margins of
  tests/test_torch_tensor_parallel_train.py (JAX's own float32 drift):
  losses 1e-3 relative, ``grad_norm`` 2e-3, each gradient within 0.2 of
  its scale and 0.06 global relative L2, BatchNorm statistics 1e-4 of
  scale, the parameters within Adam's sign-flip bound 2 x lr.
* In float64 (the model, GroupNorm's moments; the sampler's projections
  and the losses stay float32, alike on every side), the one-process
  step against the port's one-device step on make_mesh(1, 2), (2, 2)
  and, with the bbox head (``CoordHead`` and ``FCModel`` after the
  gather, whose gradients each model position computes whole), on
  make_mesh(1, 3) over the grid's 16-length form (8 / 4 / 4), and
  against two gloo ranks of the process-group form on
  the 8 / 4 split: losses and ``grad_norm`` to 1e-5 relative, gradients
  and BatchNorm statistics to 1e-5 (global relative L2; each element
  within 1e-5 of its tensor's scale or 1e-8), the parameters after the
  update to 1e-5 (global relative L2; 99.9 % of the elements within
  1e-8, each within the sign-flip bound).
* Each position's head takes its slab of lengths.

The ranks import the port only (tests/torch_parallel_ranks.py); rank 0
takes the one-device step after its own, while this process runs JAX.
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
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    as_numpy,
    float64_moments,
    spawn_ranks,
    tp_vernier,
    vernier_record,
)
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
GRID = (8, 16, 12)
TC = dict(lr=1e-3, warmup_steps=0, total_steps=50, grad_clip=5.0)
LOSSES = ("ncf", "occupancy", "coordinates", "total", "grad_norm")
# name -> (n_data, n_model, instances, grid, bbox head)
MESHES = {"data1_model2": (1, 2, 4, GRID, False),
          "data2_model2": (2, 2, 8, GRID, False),
          "data1_model3_bbox": (1, 3, 4, (8, 16, 16), True)}
JAX_MESHES = ("data1_model2", "data2_model2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(instances, grid, bbox):
    return jtiny(max_instances=instances, image_size=IMAGE_SIZE,
                 grid_resolution=grid, use_bbox_head=bbox)


def _jax_record(jcfg, v, n_data, n_model):
    """JAX's step on make_mesh(n_data, n_model) as the port's record:
    metrics, the clipped gradients (the first moment holds 0.1 x them),
    the statistics and the parameters after the step."""
    jmod = JVernier(jcfg)
    jtc = JTrainConfig(**TC)
    state = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                   batch_stats=v["batch_stats"],
                   opt_state=jmake_optimizer(jtc).init(v["params"]))
    mesh = jmake_mesh(n_data=n_data, n_model=n_model)
    step = jmake_train_step(jmod, jcfg, jtc, mesh=mesh)
    state, m = step(state, jshard(jbatch(jcfg, seed=0), mesh),
                    jax.random.PRNGKey(1))
    state = jax.device_get(state)
    return dict(
        metrics=[{k: float(a) for k, a in m.items()}],
        grads={n: w / 0.1 for n, w in convert_variables(
            {"params": state.opt_state[1][0].mu}).items()},
        stats=convert_variables({"batch_stats": state.batch_stats}),
        params=convert_variables({"params": state.params}))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks run while this process takes JAX's mesh steps and
    then the port's one-process and one-device steps."""
    tc = TrainConfig(**TC)
    cases, variables = {}, {}
    for name, (nd, nm, inst, grid, bbox) in MESHES.items():
        jcfg = _config(inst, grid, bbox)
        tcfg = torch_vernier_config(jcfg)
        H, W = jcfg.resolution
        nh, nw, nl = grid
        x = np.zeros((1, H, W, 3), np.float32)
        p = np.zeros((1, nh * nw * nl, 2), np.float32)
        variables[name] = v = random_variables(JVernier(jcfg), x, x, p, p,
                                               seed=3)
        cases[name] = (tcfg, tc, as_numpy(convert_variables(v)),
                       as_numpy(synthetic_batch_arrays(tcfg, seed=0)))
    with spawn_ranks(tp_vernier, 2, str(tmp_path_factory.mktemp("v_loc")),
                     2, [cases["data1_model2"]], ()) as ranks:
        jax_recs = {}
        for name in JAX_MESHES:
            nd, nm, inst, grid, bbox = MESHES[name]
            jax_recs[name] = _jax_record(_config(inst, grid, bbox),
                                         variables[name], nd, nm)
        local, one = {}, {}
        with float64_moments(True):
            for name, (nd, nm, *_) in MESHES.items():
                mesh = make_mesh(nd, ["cpu"] * (nd * nm), nm)
                local[name] = vernier_record(*cases[name], True, mesh=mesh,
                                             steps=1)
                one[name] = vernier_record(*cases[name], True, steps=1)
        return dict(jax=jax_recs, local=local, one=one, gloo=ranks())


def _rel_l2(got, want):
    num = sum(float(((got[n].double() - w.double()) ** 2).sum())
              for n, w in want.items())
    return np.sqrt(num / sum(float((w.double() ** 2).sum())
                             for w in want.values()))


def _assert_float64_close(got, want, lr):
    """The float64 rule of the module docstring."""
    for k, w in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=1e-5,
                                   err_msg=k)
    assert want["stats"]
    for key in ("grads", "stats", "params"):
        assert _rel_l2(got[key], want[key]) <= 1e-5, key
    for key in ("grads", "stats"):
        for n, w in want[key].items():
            assert key == "stats" or w.dtype == torch.float64, n
            torch.testing.assert_close(
                got[key][n], w, rtol=0,
                atol=max(1e-5 * float(w.abs().max()), 1e-8),
                msg=f"{key} {n}")
    err = np.concatenate([(got["params"][n] - w).abs().numpy().ravel()
                          for n, w in want["params"].items()])
    assert err.max() <= 2.0 * lr + 1e-8
    assert (err <= 1e-8).mean() >= 0.999


@pytest.mark.parametrize("name", list(MESHES))
def test_each_position_holds_its_slab_of_lengths(runs, name):
    nd, nm, inst, grid, _ = MESHES[name]
    nl = grid[2]
    slabs = {12: [8, 4], 16: [8, 4, 4]}[nl]
    shapes = runs["local"][name]["voxel_shapes"]
    assert sorted(s[3] for s in shapes) == sorted(slabs * nd)
    assert all(s[:3] == (inst // nd,) + grid[:2] for s in shapes)
    assert {s[3] for s in runs["one"][name]["voxel_shapes"]} == {nl}


@pytest.mark.parametrize("name", list(MESHES))
def test_float64_step_matches_one_device(runs, name):
    got, want = runs["local"][name], runs["one"][name]
    if MESHES[name][4]:
        assert "bbox" in want["metrics"][0]
    _assert_float64_close(got, want, TC["lr"])


def test_float64_step_matches_the_process_group_form(runs):
    """Two gloo ranks on the same 8 / 4 split: each rank's state and the
    one-process state."""
    for r, slab in zip(runs["gloo"], (8, 4)):
        assert [s[3] for s in r["steps"][0]["voxel_shapes"]] == [slab]
        _assert_float64_close(runs["local"]["data1_model2"], r["steps"][0],
                              TC["lr"])


@pytest.mark.parametrize("name", JAX_MESHES)
def test_step_matches_jax_mesh_step(runs, name):
    """tests/test_torch_tensor_parallel_train.py's margins."""
    got, want = runs["local"][name], runs["jax"][name]
    for k in LOSSES:
        rtol = 2e-3 if k == "grad_norm" else 1e-3
        np.testing.assert_allclose(got["metrics"][0][k],
                                   want["metrics"][0][k], rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    for n, g in grads.items():
        w = want["grads"][n]
        err = float((g - w).abs().max())
        assert err <= 0.2 * float(w.abs().max()) + 1e-7, (n, err)
    assert _rel_l2(grads, want["grads"]) <= 0.06
    assert want["stats"]
    for n, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n].float().numpy(),
                                   w.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(w.numpy()).max(),
                                   err_msg=n)
    err = np.concatenate([(got["params"][n].float() - w).abs().numpy()
                          .ravel() for n, w in want["params"].items()])
    assert err.max() <= 2.0 * TC["lr"] + 1e-6
    assert (err <= 1e-5).mean() >= 0.97
