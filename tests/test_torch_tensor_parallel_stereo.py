"""Depth-split stereo training and serving of the port
(``make_stereo_train_step(mesh=)`` and ``DetectRunner(mesh=)`` on a
mesh of ``initialize_multihost(..., n_model=2)``, models/stereonet.py)
on gloo ranks on the CPU, against the port's one-process step and
runner and against JAX's split step on a data1 x model2 mesh
(``make_stereo_train_step_split(mesh=make_mesh(n_data=1, n_model=2))``,
the volume under ``P("data", "model")``).

The setup of tests/test_torch_parallel_stereo.py: the JAX test's
``tiny_stereo_config(z_max=38.0, max_depth=40.0)`` (16 planes, BatchNorm
in the stem), numpy-drawn variables converted for the port,
``synthetic_stereo_request(..., boxes_per_frame=2)``; one step with
``warmup_steps=0`` (its rate is the peak: the parameters move).

* data1 x model2 (one frame) and data2 x model2 (two frames, four
  ranks): each rank's volume holds 8 of the 16 planes; in float64 (the
  model's compute dtype and GroupNorm's moments; the plain K3 / K4, the
  depth softmax and the RPN maps stay float32, alike on both sides)
  against the port's one-process step on the same frames: losses to
  1e-5 relative, gradients and BatchNorm statistics to 1e-5 (global
  relative L2; each element within 1e-5 of its tensor's scale or 1e-8),
  the parameters after the AdamW update to 1e-5 (global relative L2;
  each element within Adam's sign-flip bound 2 x lr, where a gradient
  of float32 rounding's size can take either sign); every rank holds
  the same state.
* data1 x model2 against JAX's float32 mesh step, at the margins of
  tests/test_torch_parallel_stereo.py (JAX's own float32 drift).
* ``DetectRunner`` on model2 (float32): both ranks return the same
  proposals bit for bit, and the one-process runner's within 2e-5 m
  (boxes) and 2e-6 (scores): the split sums the depth softmax in another
  order (measured 1.3e-5 m and 7.7e-7 here).

The ranks import the port only (tests/torch_parallel_ranks.py), and
rank 0 of each mesh computes the one-process references after its own
step; JAX runs in this process meanwhile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.models.stereonet import StereoNet as JStereoNet
from snvc_tpu.parallel.api import make_mesh as jmake_mesh
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train_stereo import make_stereo_train_step_split
from snvc_tpu_torch.config import TrainConfig, tiny_stereo_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    as_numpy,
    spawn_ranks,
    tp_stereo,
)
from tests.torch_port_helpers import random_variables

TC = dict(lr=3e-4, warmup_steps=0, total_steps=20, grad_clip=5.0)
LOSSES = ("total", "cls", "reg", "centerness", "depth", "num_pos",
          "grad_norm")
MESHES = ("data1_model2", "data2_model2")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both meshes' ranks (rank 0 of each then takes the port's
    one-process references) run while this process takes JAX's mesh
    step."""
    over = dict(z_max=38.0, max_depth=40.0)
    jcfg, tcfg = jax_tiny(**over), tiny_stereo_config(**over)
    batches = [as_numpy(synthetic_stereo_request(
        tcfg, seed=0, frames=f, boxes_per_frame=2)) for f in (1, 2)]
    request = synthetic_stereo_request(tcfg, seed=4, frames=1)
    jmod = JStereoNet(jcfg)
    b = batches[0]
    v = random_variables(jmod, b["images_left"].astype(np.float32),
                         b["images_right"].astype(np.float32), b["P_left"],
                         b["P_right"], seed=3)
    tc = TrainConfig(**TC)
    sd = as_numpy(convert_variables(v))
    tmp = tmp_path_factory.mktemp("stereo_tp")
    with spawn_ranks(tp_stereo, 2, str(tmp / "m2"), 2, tcfg, tc, sd,
                     batches[0], request) as two, \
            spawn_ranks(tp_stereo, 4, str(tmp / "d2m2"), 2, tcfg, tc, sd,
                        batches[1]) as four:
        jtc = JTrainConfig(**TC)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=jmake_optimizer(jtc).init(v["params"]))
        jstep = make_stereo_train_step_split(
            jmod, jcfg, jtc, mesh=jmake_mesh(n_data=1, n_model=2))
        jstate, m = jstep(jstate, dict(batches[0]))
        ranks = dict(zip(MESHES, (two(), four())))
        return dict(jax=_jax_record(jax.device_get(jstate), m),
                    one={k: r[0]["one"]["step"] for k, r in ranks.items()},
                    ranks=ranks,
                    one_detect=ranks["data1_model2"][0]["one"]["detect"])


def _jax_record(state, metrics):
    """JAX's step as the port's record: metrics, the clipped gradients
    (the first moment holds 0.1 x them), the statistics and the
    parameters after the step."""
    mu = state.opt_state[1][0].mu
    return dict(
        metrics=[{k: float(a) for k, a in metrics.items()}],
        grads={n: w / 0.1 for n, w in
               convert_variables({"params": mu}).items()},
        stats=convert_variables({"batch_stats": state.batch_stats}),
        params=convert_variables({"params": state.params}))


def _rel_l2(got, want):
    num = sum(float(((got[n] - w) ** 2).sum()) for n, w in want.items())
    return np.sqrt(num / sum(float((w ** 2).sum()) for w in want.values()))


@pytest.mark.parametrize("mesh", MESHES)
def test_each_rank_holds_its_slab_of_planes(runs, mesh):
    for r in runs["ranks"][mesh]:
        shapes = r["step"]["volume_shapes"]
        assert shapes and all(s[:2] == (1, 8) for s in shapes)  # a frame
    assert {s[1] for s in runs["one"][mesh]["volume_shapes"]} == {16}
    for r in runs["ranks"]["data1_model2"]:
        assert [s[1] for s in r["detect_volume_shapes"]] == [8]


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_hold_the_same_state(runs, mesh):
    a, *rest = [r["step"] for r in runs["ranks"][mesh]]
    for b in rest:
        assert a["metrics"] == b["metrics"]
        for key in ("grads", "stats", "params"):
            for n, t in a[key].items():
                assert torch.equal(t, b[key][n]), (key, n)


@pytest.mark.parametrize("mesh", MESHES)
def test_float64_step_matches_one_process(runs, mesh):
    got, one = runs["ranks"][mesh][0]["step"], runs["one"][mesh]
    assert one["metrics"][0]["num_pos"] > 0
    for k, want in one["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], want, rtol=1e-5,
                                   err_msg=k)
    assert one["stats"]
    for key in ("grads", "stats", "params"):
        assert _rel_l2(got[key], one[key]) <= 1e-5, key
    for key in ("grads", "stats"):
        for n, w in one[key].items():
            assert key == "stats" or w.dtype == torch.float64, n
            torch.testing.assert_close(
                got[key][n], w, rtol=0,
                atol=max(1e-5 * float(w.abs().max()), 1e-8),
                msg=f"{key} {n}")
    flip = 2.0 * TC["lr"] + 1e-8
    err = np.concatenate([(got["params"][n] - w).abs().numpy().ravel()
                          for n, w in one["params"].items()])
    assert err.max() <= flip
    assert (err <= 1e-8).mean() >= 0.999


def test_step_matches_jax_mesh_step(runs):
    """tests/test_torch_parallel_stereo.py's margins."""
    got, want = runs["ranks"]["data1_model2"][0]["step"], runs["jax"]
    assert got["metrics"][0]["depth"] > 0
    for k in LOSSES:
        rtol = 2e-3 if k == "grad_norm" else 3e-4
        np.testing.assert_allclose(got["metrics"][0][k],
                                   want["metrics"][0][k], rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    for name, g in grads.items():
        w = want["grads"][name]
        err = float((g - w).abs().max())
        assert err <= 0.15 * float(w.abs().max()) + 1e-7, (name, err)
    assert _rel_l2(grads, want["grads"]) <= 1.2e-2
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][name].numpy(), w.numpy(),
                                   rtol=0,
                                   atol=1e-5 * np.abs(w.numpy()).max(),
                                   err_msg=name)
    flip = 2.0 * TC["lr"] + 1e-6
    err = np.concatenate([(got["params"][n].float() - w).abs().numpy()
                          .ravel() for n, w in want["params"].items()])
    assert err.max() <= flip
    assert (err <= 1e-6).mean() >= 0.99


def test_detect_runner_on_the_model_axis(runs):
    a, b = (r["detect"] for r in runs["ranks"]["data1_model2"])
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    boxes, scores, classes, valid = a
    ob, os_, oc, ov = runs["one_detect"]
    np.testing.assert_array_equal(valid, ov)
    assert valid.any()
    np.testing.assert_array_equal(classes, oc)
    np.testing.assert_allclose(boxes[valid], ob[ov], rtol=0, atol=2e-5)
    np.testing.assert_allclose(scores, os_, rtol=0, atol=2e-6)
