"""Rematerialization on the one-process data x model mesh
(``make_train_step(mesh=make_mesh(1, devices, n_model))`` with
``cfg.remat``, parallel/local.py): the 3D hourglass runs under
``torch.utils.checkpoint``, its forward records what each collective
received from the other positions, and its recompute inside the one
backward replays those records without meeting (``layers.remat_contexts``,
``local.collective_log``).

The setup of tests/test_torch_tensor_parallel_local.py
(``tiny_vernier_config`` at 384x1280, the seeded
``synthetic_batch_arrays`` batch, one step with ``warmup_steps=0``) on the
grid 8 x 16 x 12, with ``remat=True`` on both packages:

* the port's float64 one-process step with remat against the same step
  without remat (the same weights; the hourglasses' names differ), on
  make_mesh(1, 2) (8 / 4), on make_mesh(1, 4) (4 / 4 / 4 / 0: an empty
  position, as tests/test_torch_tensor_parallel_padded*.py split) and
  with BatchNorm (``gn=False``) on make_mesh(1, 2): losses,
  ``grad_norm``, every gradient, parameter and BatchNorm statistic
  within 1e-10 of its scale (the two steps differ only in the order
  autograd adds the positions' gradients: ~1e-13 measured);
* that step on make_mesh(1, 2) against JAX's ``make_train_step`` with
  ``remat=True`` on ``make_mesh(n_data=1, n_model=2)``, at that file's
  margins (losses 1e-3 relative, ``grad_norm`` 2e-3, each gradient
  within 0.2 of its scale and 0.06 global relative L2, the parameters
  within Adam's sign-flip bound 2 x lr);
* the rendezvous holds as many meetings with remat as without (none
  during a recompute: the positions' threads have ended by then, and a
  meeting would fail), each replica's 3D hourglass runs its forward on
  its slab twice (the step's and the recompute), once without remat,
  and the BatchNorm statistics move once (equal to the no-remat step's,
  and away from their initial values).
"""

import threading

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
from snvc_tpu_torch.parallel import local
from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    make_train_step,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    float64_moments,
    steps_record,
    vernier_float64,
)
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
GRID = (8, 16, 12)
TC = dict(lr=1e-3, warmup_steps=0, total_steps=50, grad_clip=5.0)
LOSSES = ("ncf", "occupancy", "coordinates", "total", "grad_norm")
# name -> (n_model, gn, the slabs of the 12 lengths)
MESHES = {"model2": (2, True, [8, 4]),
          "model4_empty": (4, True, [4, 4, 4, 0]),
          "model2_batchnorm": (2, False, [8, 4])}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(gn=True, remat=True):
    return jtiny(max_instances=4, image_size=IMAGE_SIZE, grid_resolution=GRID,
                 gn=gn, remat=remat)


def _name(key: str, remat: bool) -> str:
    """The port's name of the converted variable ``key`` (JAX's names
    under remat: ``CheckpointHourglass_0`` the 3D hourglass,
    ``Hourglass_0`` the 2D one) in a model without remat."""
    for a, b in (("head.CheckpointHourglass_0.", "head.Hourglass_0."),
                 ("head.Hourglass_0.", "head.Hourglass_1.")):
        if not remat and key.startswith(a):
            return b + key[len(a):]
    return key


def _record(jcfg, sd, n_model):
    """The port's float64 step on make_mesh(1, n_model CPUs) from the
    converted variables ``sd``, with the meetings the rendezvous held and
    the calls of each replica's 3D hourglass."""
    cfg = torch_vernier_config(jcfg)
    sd = {_name(k, cfg.remat): torch.as_tensor(v) for k, v in sd.items()}
    calls, meetings, lock = [], [0], threading.Lock()
    meet = local.Rendezvous.meet

    def counting(self, *args, **kw):
        with lock:  # the positions' threads meet at once
            meetings[0] += 1
        return meet(self, *args, **kw)

    with vernier_float64(True), float64_moments(True), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(local.Rendezvous, "meet", counting)
        model = VernierScale(cfg, device="cpu")
        model.load_state_dict(sd)
        model.double()
        # the replicas copy the module tree with its hooks
        getattr(model.head, model.head._hg3).register_forward_pre_hook(
            lambda m, args: calls.append((id(m), args[0].shape[3])))
        state = create_train_state(model, cfg, TrainConfig(**TC))
        step = make_train_step(cfg, TrainConfig(**TC), "cpu",
                               mesh=make_mesh(1, ["cpu"] * n_model, n_model))
        rec = steps_record(state, step, batch_to_device(
            synthetic_batch_arrays(cfg, seed=0), "cpu"), steps=1)
    forwards = [sum(c == m for c, _ in calls) for m in dict(calls)]
    return dict(rec, meetings=meetings[0], forwards=forwards,
                lengths=sorted(L for _, L in calls),
                initial=sd)


def _jax_record(jcfg, v):
    """JAX's remat step on make_mesh(1, 2) as the port's record: metrics,
    the clipped gradients (the first moment holds 0.1 x them) and the
    parameters after the step."""
    jtc = JTrainConfig(**TC)
    state = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                   batch_stats=v["batch_stats"],
                   opt_state=jmake_optimizer(jtc).init(v["params"]))
    mesh = jmake_mesh(n_data=1, n_model=2)
    step = jmake_train_step(JVernier(jcfg), jcfg, jtc, mesh=mesh)
    state, m = step(state, jshard(jbatch(jcfg, seed=0), mesh),
                    jax.random.PRNGKey(1))
    state = jax.device_get(state)
    return dict(
        metrics=[{k: float(a) for k, a in m.items()}],
        grads={n: w / 0.1 for n, w in convert_variables(
            {"params": state.opt_state[1][0].mu}).items()},
        params=convert_variables({"params": state.params}))


def _remat_names(tree):
    """A JAX variables tree of the model without remat under the names
    the model with remat gives: ``Hourglass_0`` (3D) ->
    ``CheckpointHourglass_0``, ``Hourglass_1`` (2D) -> ``Hourglass_0``."""
    names = {"Hourglass_0": "CheckpointHourglass_0",
             "Hourglass_1": "Hourglass_0"}
    return {col: dict(t, head={names.get(k, k): w
                               for k, w in t["head"].items()})
            for col, t in tree.items()}


@pytest.fixture(scope="module")
def runs():
    """The variables drawn as tests/test_torch_tensor_parallel_local.py
    draws them (from JAX's model without remat, seed 3), under remat's
    names."""
    out = {}
    H, W = _config().resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, int(np.prod(GRID)), 2), np.float32)
    for name, (n_model, gn, _) in MESHES.items():
        jcfg = _config(gn)
        v = _remat_names(random_variables(JVernier(_config(gn, False)), x,
                                          x, p, p, seed=3))
        sd = {k: t.numpy() for k, t in convert_variables(v).items()}
        out[name] = {remat: _record(_config(gn, remat), sd, n_model)
                     for remat in (False, True)}
        if name == "model2":
            out["jax"] = _jax_record(jcfg, v)
    return out


def _by_order(rec, key):
    return list(rec[key].values())


@pytest.mark.parametrize("name", list(MESHES))
def test_float64_step_with_remat_matches_without(runs, name):
    off, on = runs[name][False], runs[name][True]
    for k, w in off["metrics"][0].items():
        np.testing.assert_allclose(on["metrics"][0][k], w, rtol=1e-10,
                                   atol=0, err_msg=k)
    for key in ("grads", "params", "stats"):
        assert off[key], key
        for (n, w), g in zip(off[key].items(), _by_order(on, key)):
            assert w.shape == g.shape, (key, n)
            torch.testing.assert_close(
                g, w, rtol=0, atol=1e-10 * max(float(w.abs().max()), 1e-30),
                msg=f"{key} {n}")


@pytest.mark.parametrize("name", list(MESHES))
def test_recompute_holds_no_meeting_and_runs_the_hourglass_twice(runs,
                                                                 name):
    off, on = runs[name][False], runs[name][True]
    n_model, _, slabs = MESHES[name]
    assert on["meetings"] == off["meetings"] > 0
    assert off["forwards"] == [1] * n_model
    assert on["forwards"] == [2] * n_model
    assert off["lengths"] == sorted(slabs)
    assert on["lengths"] == sorted(slabs * 2)


def test_batchnorm_statistics_move_once(runs):
    """gn=False: the 3D hourglass's BatchNorms inside the checkpoint; the
    statistics equal the no-remat step's (a second move in the recompute
    would part them) and moved from their initial values."""
    on = runs["model2_batchnorm"][True]
    moved = [n for n, a in on["stats"].items()
             if "Checkpoint" in n and n.endswith("running_mean")
             and not torch.equal(a, on["initial"][n].to(a.dtype))]
    assert moved


def test_remat_step_matches_jax_remat_mesh_step(runs):
    """tests/test_torch_tensor_parallel_local.py's margins, against
    JAX's make_train_step with remat=True on make_mesh(1, 2)."""
    got, want = runs["model2"][True], runs["jax"]
    for k in LOSSES:
        rtol = 2e-3 if k == "grad_norm" else 1e-3
        np.testing.assert_allclose(got["metrics"][0][k],
                                   want["metrics"][0][k], rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    assert any(n.startswith("head.Checkpoint") for n in grads)
    for n, g in grads.items():
        w = want["grads"][n]
        err = float((g - w).abs().max())
        assert err <= 0.2 * float(w.abs().max()) + 1e-7, (n, err)
    num = sum(float(((grads[n].double() - w.double()) ** 2).sum())
              for n, w in want["grads"].items())
    den = sum(float((w.double() ** 2).sum()) for w in want["grads"].values())
    assert np.sqrt(num / den) <= 0.06
    err = np.concatenate([(got["params"][n].float() - w).abs().numpy()
                          .ravel() for n, w in want["params"].items()])
    assert err.max() <= 2.0 * TC["lr"] + 1e-6
    assert (err <= 1e-5).mean() >= 0.97
