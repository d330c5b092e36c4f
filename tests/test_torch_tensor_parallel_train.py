"""Length-split Vernier training of the port (``make_train_step(mesh=)``
on a mesh of ``initialize_multihost(..., n_model=2)``, models/
vernier.py) on two gloo ranks on the CPU, against the port's
one-process step and against JAX's step on a data1 x model2 mesh
(``make_train_step(mesh=make_mesh(n_data=1, n_model=2))``, the voxel
under ``P("data", None, None, "model", None)``).

The setup of tests/test_torch_parallel_train.py (``tiny_vernier_config``
at 384x1280, the seeded ``synthetic_batch_arrays`` batch) at 4
instances, both on every rank of the one data position; one step with
``warmup_steps=0`` (its rate is the peak: the parameters move).

* Each rank's voxel holds 8 of the 16 lengths (``nl / n_model``).
* With the bbox head (``use_bbox_head``: ``CoordHead`` and ``FCModel``
  after the gather, whose gradients each model rank computes whole), in
  float64 (the model, GroupNorm's moments; the sampler's projections and
  the losses stay float32, alike on both sides) against the port's
  one-process step: losses and ``grad_norm`` to 1e-5 relative;
  gradients and BatchNorm statistics to 1e-5 (global relative L2; each
  element within 1e-5 of its tensor's scale or 1e-8), the CoordHead /
  FCModel gradients among them: a gradient counted ``n_model`` times
  would be twice the one-process one.  The parameters after the update
  to 1e-5 (global relative L2; 99.9 % of the elements within 1e-8, each
  within Adam's sign-flip bound 2 x lr: the first update is
  lr x sign(g), and a gradient of rounding's size, as a BatchNorm's
  input bias has, takes either sign).
* The default head (no bbox head: JAX draws its dropout apart) in
  float64 against JAX's float32 mesh step, at the margins of
  tests/test_torch_parallel_train.py (JAX's own float32 drift).
* The two ranks hold the same state bit for bit.

The ranks import the port only (tests/torch_parallel_ranks.py), and
rank 0 computes the one-process step after its own; JAX runs in this
process meanwhile.
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
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import as_numpy, spawn_ranks, tp_vernier
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
TC = dict(lr=1e-3, warmup_steps=0, total_steps=50, grad_clip=5.0)
LOSSES = ("ncf", "occupancy", "coordinates", "total", "grad_norm")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run while this process takes JAX's mesh step."""
    jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE)
    tcfg = torch_vernier_config(jcfg)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    jmod = JVernier(jcfg)
    v = random_variables(jmod, x, x, p, p, seed=3)
    batch = jbatch(jcfg, seed=0)
    tc = TrainConfig(**TC)
    bbox_cfg = torch_vernier_config(jtiny(max_instances=4,
                                          image_size=IMAGE_SIZE,
                                          use_bbox_head=True))
    bbox_sd = as_numpy(VernierScale(
        bbox_cfg, device="cpu",
        generator=torch.Generator().manual_seed(5)).state_dict())
    cases = [(tcfg, tc, as_numpy(convert_variables(v)),
              as_numpy(synthetic_batch_arrays(tcfg, seed=0))),
             (bbox_cfg, tc, bbox_sd,
              as_numpy(synthetic_batch_arrays(bbox_cfg, seed=0)))]
    with spawn_ranks(tp_vernier, 2, str(tmp_path_factory.mktemp("v_tp")),
                     2, cases, (1,)) as ranks:
        jtc = JTrainConfig(**TC)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=jmake_optimizer(jtc).init(v["params"]))
        mesh = jmake_mesh(n_data=1, n_model=2)
        jstep = jmake_train_step(jmod, jcfg, jtc, mesh=mesh)
        jstate, m = jstep(jstate, jshard(batch, mesh), jax.random.PRNGKey(1))
        jstate = jax.device_get(jstate)
        return dict(jax=jstate, j_metrics={k: float(a) for k, a in m.items()},
                    ranks=ranks())


def _rel_l2(got, want):
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    return np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values()))


def test_each_rank_holds_its_slab_of_lengths(runs):
    for r in runs["ranks"]:
        for rec in r["steps"]:
            shapes = rec["voxel_shapes"]
            assert shapes and all(s[:4] == (4, 8, 16, 8) for s in shapes)
    assert {s[3] for s in runs["ranks"][0]["one"][1]["voxel_shapes"]} == {16}


def test_ranks_hold_the_same_state(runs):
    a, b = runs["ranks"]
    for ca, cb in zip(a["steps"], b["steps"]):
        assert ca["metrics"] == cb["metrics"]
        for key in ("grads", "stats", "params"):
            for n, t in ca[key].items():
                assert torch.equal(t, cb[key][n]), (key, n)


@pytest.mark.parametrize("key", ["metrics", "grads", "stats", "params"])
def test_float64_bbox_step_matches_one_process(runs, key):
    got, one = runs["ranks"][0]["steps"][1], runs["ranks"][0]["one"][1]
    if key == "metrics":
        assert "bbox" in one["metrics"][0]
        for k, want in one["metrics"][0].items():
            np.testing.assert_allclose(got["metrics"][0][k], want,
                                       rtol=1e-5, err_msg=k)
        return
    assert _rel_l2(got[key], one[key]) <= 1e-5
    heads = [n for n in one[key] if "CoordHead" in n or "FCModel" in n]
    assert heads
    if key == "params":
        err = np.concatenate([(got[key][n] - w).abs().numpy().ravel()
                              for n, w in one[key].items()])
        assert err.max() <= 2.0 * TC["lr"] + 1e-8
        assert (err <= 1e-8).mean() >= 0.999
        return
    for n, w in one[key].items():
        assert w.dtype == torch.float64, n
        torch.testing.assert_close(
            got[key][n], w, rtol=0,
            atol=max(1e-5 * float(w.abs().max()), 1e-8), msg=n)


def test_losses_match_jax_mesh_step(runs):
    """tests/test_torch_parallel_train.py's 1e-3, 2e-3 for
    ``grad_norm``."""
    got = runs["ranks"][0]["steps"][0]["metrics"][0]
    for k in LOSSES:
        rtol = 2e-3 if k == "grad_norm" else 1e-3
        np.testing.assert_allclose(got[k], runs["j_metrics"][k], rtol=rtol,
                                   err_msg=k)


def test_grads_match_jax_mesh_step(runs):
    mu = runs["jax"].opt_state[1][0].mu
    want = {n: w / 0.1 for n, w in
            convert_variables({"params": mu}).items()}
    grads = {n: g.float() for n, g in
             runs["ranks"][0]["steps"][0]["grads"].items()}
    assert set(want) == set(grads)
    for name, g in grads.items():
        w = want[name]
        err = float((g - w).abs().max())
        assert err <= 0.2 * float(w.abs().max()) + 1e-7, (name, err)
    assert _rel_l2(grads, want) <= 0.06


def test_batch_stats_match_jax_mesh_step(runs):
    want = convert_variables({"batch_stats": runs["jax"].batch_stats})
    assert want
    got = runs["ranks"][0]["steps"][0]["stats"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name].float().numpy(), w.numpy(),
                                   rtol=0,
                                   atol=1e-4 * np.abs(w.numpy()).max(),
                                   err_msg=name)


def test_params_match_jax_mesh_step(runs):
    """Within test_torch_train.py's sign-flip bound."""
    want = convert_variables({"params": runs["jax"].params})
    got = runs["ranks"][0]["steps"][0]["params"]
    flip = 2.0 * TC["lr"] + 1e-6
    err = np.concatenate([(got[n].float() - w).abs().numpy().ravel()
                          for n, w in want.items()])
    assert err.max() <= flip
    assert (err <= 1e-5).mean() >= 0.97
