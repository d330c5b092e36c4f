"""The Vernier step on a model axis that GSPMD pads (models/vernier.py:
each head on its slab of lengths, parallel/tensor.py's slab rule), on
the CPU, in both forms of the port, against JAX's ``make_train_step`` on
the same mesh and against the port's one-device step.

The setup of tests/test_torch_tensor_parallel_local.py
(``tiny_vernier_config`` at 384x1280, 4 instances, the seeded
``synthetic_batch_arrays`` batch, one step with ``warmup_steps=0``):

* ``BEV_type3`` on the grid 8 x 20 x 40 (``n_sample_w > 16``: the
  four-level ``HourglassDeep``, units of 16 lengths) over
  make_mesh(1, 4): 3 units, the last short, over four positions, 16 /
  16 / 8 / 0, where GSPMD splits 10 / 10 / 10 / 10 and pads the
  hourglass's levels.
* ``3D`` (``grid_type="3D"``, 3 parts) on the grid 8 x 16 x 8 over
  make_mesh(1, 3): 2 units of 4 over three positions, 4 / 4 / 0.

Against JAX's float32 step on ``make_mesh(n_data=1, n_model=n)``, the
port's float64 one-process step at the margins of
tests/test_torch_tensor_parallel_local.py: losses 1e-3 relative,
``grad_norm`` 2e-3, each gradient within 0.2 of its scale and 0.06
global relative L2, BatchNorm statistics 1e-4 of scale, the parameters
within Adam's sign-flip bound 2 x lr.  On the BEV_type3 grid
``grad_norm`` is held within 1e-2, each gradient within 0.3 of its scale
and the statistics within 1e-3 of scale, the margins
tests/test_torch_tensor_parallel_local_heads.py gives the BEV head:
JAX's jitted float32 step is no witness there
(tests/test_torch_variants_train.py).  Measured on a CPU on this batch:
JAX's float32 step gives ``grad_norm`` 14.96323 on one device and
14.96299 on the padded make_mesh(1, 4) (its padding moves nothing), the
port's float64 step 15.07405 and its float32 step 15.07488; JAX's own
float64 step (tests/test_torch_variants_train.py's ``_jax_step64``,
on one device) lies 1.6e-4 (global relative L2 of the clipped
gradients) from the port's float64 step and 9.1e-4 from the port's
float32 one, and its coordinate loss 0.2500623 is the port's 0.2500643,
where JAX's float32 step gives 0.2500837.  Downstream of that loss the
port's padded step lies 0.204 of scale from JAX's float32 mesh step in
one weight of the 2D hourglass and 1.2e-4 of scale in a running mean of
the ``CoordHead``.

In float64 (the model, GroupNorm's moments; the sampler's projections
and the losses stay float32, alike on every side): the one-process step
against the port's one-device step, and two gloo ranks of the
process-group form on the BEV_type3 grid's 32 / 8 split against the
one-device step:
losses and ``grad_norm`` to 1e-5 relative, gradients and BatchNorm
statistics to 1e-5 (global relative L2; each element within 1e-5 of its
tensor's scale or 1e-8), the parameters after the update to 1e-5
(global relative L2; 99.9 % of the elements within 1e-8, each within the
sign-flip bound).  Each position's head takes its slab of lengths, the
empty one a 0-length voxel.
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
    spawn_ranks,
    tp_vernier,
    vernier_record,
)
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
TC = dict(lr=1e-3, warmup_steps=0, total_steps=50, grad_clip=5.0)
LOSSES = ("ncf", "occupancy", "coordinates", "total", "grad_norm")
# name -> (config overrides, n_model, the slabs of the lengths, the
# margins against JAX: (grad_norm, each gradient of its scale, the
# BatchNorm statistics of scale))
CASES = {
    "BEV_type3": (dict(vernier_type="BEV_type3",
                       grid_resolution=(8, 20, 40)), 4, [16, 16, 8, 0],
                  (1e-2, 0.3, 1e-3)),
    "3D": (dict(vernier_type="3D", grid_type="3D", num_parts=3,
                grid_resolution=(8, 16, 8)), 3, [4, 4, 0], (2e-3, 0.2, 1e-4)),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record(jcfg, v, n_model):
    """JAX's step on make_mesh(1, n_model) as the port's record: metrics,
    the clipped gradients (the first moment holds 0.1 x them), the
    statistics and the parameters after the step."""
    jtc = JTrainConfig(**TC)
    state = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                   batch_stats=v["batch_stats"],
                   opt_state=jmake_optimizer(jtc).init(v["params"]))
    mesh = jmake_mesh(n_data=1, n_model=n_model)
    step = jmake_train_step(JVernier(jcfg), jcfg, jtc, mesh=mesh)
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
    """The gloo ranks run the BEV_type3 split while this process takes
    JAX's mesh steps and then the port's one-process and one-device
    steps."""
    tc = TrainConfig(**TC)
    cases, variables = {}, {}
    for name, (over, *_) in CASES.items():
        jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE, **over)
        tcfg = torch_vernier_config(jcfg)
        H, W = jcfg.resolution
        nh, nw, nl = jcfg.grid_resolution
        x = np.zeros((1, H, W, 3), np.float32)
        p = np.zeros((1, nh * nw * nl, 2), np.float32)
        variables[name] = v = random_variables(JVernier(jcfg), x, x, p, p,
                                               seed=3)
        cases[name] = (jcfg, (tcfg, tc, as_numpy(convert_variables(v)),
                              as_numpy(synthetic_batch_arrays(tcfg,
                                                              seed=0))))
    with spawn_ranks(tp_vernier, 2,
                     str(tmp_path_factory.mktemp("v_padded")), 2,
                     [cases["BEV_type3"][1]], ()) as ranks:
        jax_recs, local, one = {}, {}, {}
        for name, (_, nm, *_) in CASES.items():
            jax_recs[name] = _jax_record(cases[name][0], variables[name], nm)
        with float64_moments(True):
            for name, (_, nm, *_) in CASES.items():
                mesh = make_mesh(1, ["cpu"] * nm, nm)
                local[name] = vernier_record(*cases[name][1], True,
                                             mesh=mesh, steps=1)
                one[name] = vernier_record(*cases[name][1], True, steps=1)
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
    for key in ("grads", "stats", "params"):
        if want[key]:
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


@pytest.mark.parametrize("name", list(CASES))
def test_each_position_holds_its_slab_of_lengths(runs, name):
    over, nm, slabs, _ = CASES[name]
    nh, nw, nl = over["grid_resolution"]
    shapes = runs["local"][name]["voxel_shapes"]
    assert sorted(s[3] for s in shapes) == sorted(slabs)
    assert all(s[:3] == (4, nh, nw) for s in shapes)
    assert {s[3] for s in runs["one"][name]["voxel_shapes"]} == {nl}


@pytest.mark.parametrize("name", list(CASES))
def test_float64_step_matches_one_device(runs, name):
    _assert_float64_close(runs["local"][name], runs["one"][name], TC["lr"])


@pytest.mark.parametrize("rank", range(2))
def test_float64_step_matches_the_process_group_form(runs, rank):
    """Two gloo ranks on the BEV_type3 grid's 32 / 8 split (a short last
    slab): each rank's state and the one-device state."""
    r = runs["gloo"][rank]["steps"][0]
    assert [s[3] for s in r["voxel_shapes"]] == [[32, 8][rank]]
    _assert_float64_close(r, runs["one"]["BEV_type3"], TC["lr"])


@pytest.mark.parametrize("name", list(CASES))
def test_step_matches_jax_padded_mesh_step(runs, name):
    """tests/test_torch_tensor_parallel_local.py's margins (``grad_norm``
    on the BEV_type3 grid: the module docstring)."""
    got, want = runs["local"][name], runs["jax"][name]
    for k in LOSSES:
        if k not in want["metrics"][0]:
            continue
        rtol = CASES[name][3][0] if k == "grad_norm" else 1e-3
        np.testing.assert_allclose(got["metrics"][0][k],
                                   want["metrics"][0][k], rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    for n, g in grads.items():
        w = want["grads"][n]
        err = float((g - w).abs().max())
        assert err <= CASES[name][3][1] * float(w.abs().max()) + 1e-7, \
            (n, err)
    assert _rel_l2(grads, want["grads"]) <= 0.06
    for n, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n].float().numpy(),
                                   w.numpy(), rtol=0,
                                   atol=CASES[name][3][2]
                                   * np.abs(w.numpy()).max(), err_msg=n)
    err = np.concatenate([(got["params"][n].float() - w).abs().numpy()
                          .ravel() for n, w in want["params"].items()])
    assert err.max() <= 2.0 * TC["lr"] + 1e-6
    assert (err <= 1e-5).mean() >= 0.97
