"""The one-process data x model mesh of the port on the stereo path
(``make_stereo_train_step`` and ``DetectRunner`` on
``make_mesh(n_data, devices, n_model)``, parallel/local.py) and
``RefineRunner`` on such a mesh, on the CPU.

The setup of tests/test_torch_tensor_parallel_stereo.py
(``tiny_stereo_config(z_max=38.0, max_depth=40.0)``, numpy-drawn
variables converted for the port, ``synthetic_stereo_request(...,
boxes_per_frame=2)``, one step with ``warmup_steps=0``) at 12 planes: at
n_model 2 they split 8 / 4 (units of 4, the hourglass's 2^levels),
where GSPMD splits 6 / 6 and pads the hourglass's 3-plane level.

* JAX's split step on ``make_mesh(n_data=1, n_model=2)``: the port's
  float64 step on the one-process make_mesh(1, 2) at the margins of
  tests/test_torch_parallel_stereo.py (JAX's own float32 drift).
* In float64 (the model's compute dtype and GroupNorm's moments; the
  plain K3 / K4, the depth softmax and the RPN maps stay float32, alike
  on every side) against the port's one-device step: make_mesh(1, 2)
  (8 / 4), make_mesh(2, 2) (2 frames) and make_mesh(1, 3) at 16 planes
  (8 / 4 / 4); and make_mesh(1, 2) against two gloo ranks of the
  process-group form on the same 8 / 4 split: losses to 1e-5 relative,
  gradients and BatchNorm statistics to 1e-5 (global relative L2; each
  element within 1e-5 of its tensor's scale or 1e-8), the parameters
  after the AdamW update to 1e-5 (global relative L2; each element
  within Adam's sign-flip bound 2 x lr).
* ``DetectRunner`` (float32) on make_mesh(1, 2) against the one-device
  runner and the gloo ranks' split runner, and on make_mesh(2, 2) (2
  frames) against the data-only mesh's runner: the same valid slots and
  classes, boxes within 2e-5 m and scores within 2e-6 (the split sums
  the depth softmax in another order; tests/
  test_torch_tensor_parallel_stereo.py measured 1.3e-5 m and 7.7e-7).
* ``RefineRunner`` on make_mesh(2, 4 devices, 2): it serves on one
  device a data position (JAX replicates its model over "model") and
  returns the data-only mesh's outputs bit for bit, the one-device
  runner's within 1e-5.
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
from snvc_tpu_torch.config import (
    TrainConfig,
    tiny_stereo_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    as_numpy,
    input_shapes,
    spawn_ranks,
    stereo_model,
    stereo_record,
    tp_stereo,
)
from tests.torch_port_helpers import random_variables

TC = dict(lr=3e-4, warmup_steps=0, total_steps=20, grad_clip=5.0)
OVER = dict(z_max=38.0, max_depth=40.0)
LOSSES = ("total", "cls", "reg", "centerness", "depth", "num_pos",
          "grad_norm")
# name -> (n_data, n_model, num_depths, the slabs of one data position)
MESHES = {"data1_model2": (1, 2, 12, [8, 4]),
          "data2_model2": (2, 2, 12, [8, 4]),
          "data1_model3": (1, 3, 16, [8, 4, 4])}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_record(state, metrics):
    mu = state.opt_state[1][0].mu
    return dict(
        metrics=[{k: float(a) for k, a in metrics.items()}],
        grads={n: w / 0.1 for n, w in
               convert_variables({"params": mu}).items()},
        stats=convert_variables({"batch_stats": state.batch_stats}),
        params=convert_variables({"params": state.params}))


def _local(mesh_name):
    nd, nm, *_ = MESHES[mesh_name]
    return make_mesh(nd, ["cpu"] * (nd * nm), nm)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks (rank 0 then takes the one-device step and runner)
    run while this process takes JAX's mesh step, then the port's
    one-process steps and runners."""
    tc = TrainConfig(**TC)
    cases = {}
    for name, (nd, nm, D, _) in MESHES.items():
        tcfg = tiny_stereo_config(num_depths=D, **OVER)
        batch = as_numpy(synthetic_stereo_request(
            tcfg, seed=0, frames=nd, boxes_per_frame=2))
        jcfg = jax_tiny(num_depths=D, **OVER)
        v = random_variables(
            JStereoNet(jcfg), batch["images_left"].astype(np.float32),
            batch["images_right"].astype(np.float32), batch["P_left"],
            batch["P_right"], seed=3)
        cases[name] = (tcfg, jcfg, v, as_numpy(convert_variables(v)), batch)
    tcfg, jcfg, v, sd, batch = cases["data1_model2"]
    request = synthetic_stereo_request(tcfg, seed=4, frames=1)
    with spawn_ranks(tp_stereo, 2, str(tmp_path_factory.mktemp("s_loc")),
                     2, tcfg, tc, sd, batch, request) as gloo:
        jtc = JTrainConfig(**TC)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=jmake_optimizer(jtc).init(v["params"]))
        jstep = make_stereo_train_step_split(
            JStereoNet(jcfg), jcfg, jtc,
            mesh=jmake_mesh(n_data=1, n_model=2))
        jstate, m = jstep(jstate, dict(batch))
        jrec = _jax_record(jax.device_get(jstate), m)
        local, one = {}, {}
        for name, (tcfg, _, _, sd, batch) in cases.items():
            local[name] = stereo_record(tcfg, tc, sd, batch,
                                        mesh=_local(name), float64=True,
                                        steps=1)
            if name != "data1_model2":  # rank 0 takes that one
                one[name] = stereo_record(tcfg, tc, sd, batch,
                                          float64=True, steps=1)
        detect = _detect(cases["data1_model2"][0], cases["data1_model2"][3],
                         request)
        ranks = gloo()
    one["data1_model2"] = ranks[0]["one"]["step"]
    return dict(jax=jrec, local=local, one=one, gloo=ranks, detect=detect)


def _detect(cfg, sd, request):
    """The float32 runners: one device, make_mesh(1, 2) (and the slabs
    its positions' stacks take), and on 2 frames the data-only
    make_mesh(2, ...) and make_mesh(2, ..., 2)."""
    def run(mesh, req):
        runner = DetectRunner(stereo_model(cfg, sd), cfg, device="cpu",
                              score_threshold=0.0, mesh=mesh)
        first = (runner.replicas[1].head.ConvNorm3d_0 if runner.positions
                 else runner.model.head.ConvNorm3d_0)
        with input_shapes(first) as shapes:  # position 1's, if any
            out = [t.numpy() for t in runner.forward(req)]
        return out, shapes

    two = synthetic_stereo_request(cfg, seed=5, frames=2)
    local, shapes = run(_local("data1_model2"), request)
    return dict(one=run(None, request)[0], local=local, shapes=shapes,
                data2=run(make_mesh(2, ["cpu"] * 2), two)[0],
                data2_model2=run(_local("data2_model2"), two)[0])


def _rel_l2(got, want):
    num = sum(float(((got[n].double() - w.double()) ** 2).sum())
              for n, w in want.items())
    return np.sqrt(num / sum(float((w.double() ** 2).sum())
                             for w in want.values()))


def _assert_float64_close(got, want):
    """The float64 rule of the module docstring."""
    assert want["metrics"][0]["num_pos"] > 0
    for k, w in want["metrics"][0].items():
        np.testing.assert_allclose(got["metrics"][0][k], w, rtol=1e-5,
                                   err_msg=k)
    assert want["stats"]
    for key in ("grads", "stats", "params"):
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


@pytest.mark.parametrize("name", list(MESHES))
def test_each_position_holds_its_slab_of_planes(runs, name):
    nd, _, D, slabs = MESHES[name]
    shapes = runs["local"][name]["volume_shapes"]
    assert sorted(s[1] for s in shapes) == sorted(slabs * nd)
    assert all(s[0] == 1 for s in shapes)  # a frame a data position
    assert [s[1] for s in runs["detect"]["shapes"]] == [4]


@pytest.mark.parametrize("name", list(MESHES))
def test_float64_step_matches_one_device(runs, name):
    _assert_float64_close(runs["local"][name], runs["one"][name])


def test_float64_step_matches_the_process_group_form(runs):
    for r, slab in zip(runs["gloo"], (8, 4)):
        assert [s[1] for s in r["step"]["volume_shapes"]] == [slab]
        _assert_float64_close(runs["local"]["data1_model2"], r["step"])


def test_step_matches_jax_mesh_step(runs):
    """tests/test_torch_parallel_stereo.py's margins."""
    got, want = runs["local"]["data1_model2"], runs["jax"]
    assert got["metrics"][0]["depth"] > 0
    for k in LOSSES:
        rtol = 2e-3 if k == "grad_norm" else 3e-4
        np.testing.assert_allclose(got["metrics"][0][k],
                                   want["metrics"][0][k], rtol=rtol,
                                   err_msg=k)
    grads = {n: g.float() for n, g in got["grads"].items()}
    assert set(want["grads"]) == set(grads)
    for n, g in grads.items():
        w = want["grads"][n]
        err = float((g - w).abs().max())
        assert err <= 0.15 * float(w.abs().max()) + 1e-7, (n, err)
    assert _rel_l2(grads, want["grads"]) <= 1.2e-2
    for n, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][n].numpy(), w.numpy(),
                                   rtol=0,
                                   atol=1e-5 * np.abs(w.numpy()).max(),
                                   err_msg=n)
    err = np.concatenate([(got["params"][n].float() - w).abs().numpy()
                          .ravel() for n, w in want["params"].items()])
    assert err.max() <= 2.0 * TC["lr"] + 1e-6
    assert (err <= 1e-6).mean() >= 0.99


def _assert_proposals_close(got, want):
    boxes, scores, classes, valid = got
    wb, ws, wc, wv = want
    np.testing.assert_array_equal(valid, wv)
    assert valid.any()
    np.testing.assert_array_equal(classes, wc)
    np.testing.assert_allclose(boxes[valid], wb[wv], rtol=0, atol=2e-5)
    np.testing.assert_allclose(scores, ws, rtol=0, atol=2e-6)


@pytest.mark.parametrize("ref", ["one_device", "gloo", "data2"])
def test_detect_runner_on_the_one_process_mesh(runs, ref):
    d = runs["detect"]
    if ref == "one_device":
        _assert_proposals_close(d["local"], d["one"])
    elif ref == "gloo":
        _assert_proposals_close(d["local"], runs["gloo"][0]["detect"])
    else:
        _assert_proposals_close(d["data2_model2"], d["data2"])


def test_refine_runner_on_a_data_model_mesh():
    cfg = tiny_vernier_config(max_instances=4, image_size=(384, 1280))
    model = VernierScale(cfg, device="cpu")
    arrays = synthetic_batch_arrays(cfg, seed=0)
    runner = RefineRunner(model, cfg, device="cpu",
                          mesh=make_mesh(2, ["cpu"] * 4, 2))
    assert len(runner.replicas) == 2
    got = runner.step(arrays)
    data = RefineRunner(model, cfg, device="cpu",
                        mesh=make_mesh(2, ["cpu"] * 2)).step(arrays)
    one = RefineRunner(model, cfg, device="cpu").step(arrays)
    for k in ("one_part", "all_parts", "confidence"):
        np.testing.assert_array_equal(got[k], data[k], err_msg=k)
        np.testing.assert_allclose(got[k], one[k], rtol=0, atol=1e-5,
                                   err_msg=k)
