"""The model axis at every extent JAX's mesh splits (parallel/tensor.py's
slab rule: ``ceil(extent / 2^levels)`` units, the last one short where
2^levels does not divide the extent, spread as ``np.array_split``
spreads them, positions beyond the units empty), on the CPU: the
collectives and the split layers on short and empty slabs in both forms
(two gloo ranks and the one-process mesh of parallel/local.py), and the
stereo path on a mesh where GSPMD pads.

* ``halo_exchange`` (2 planes below, 3 above) and ``gather`` of each
  slab of an 8-plane axis cut in units of 6 (6 / 2: the short slab is
  narrower than the other's halo) and of 8 (8 / 0: an empty position),
  forward and backward, against the same sums on the whole tensor with
  zeros beyond its ends (float64, exact up to the order of the adds);
  the one-process form also on three positions (6 / 6 / 4 and 8 / 8 /
  0), ``model_sum`` and ``model_max`` (``slab_amax``: -inf from an empty
  slab) among them.
* Each split layer on a short or an empty slab (a stride-2 conv on an
  odd last slab, the large-tap k5 d2 conv whose 4-plane halo reaches
  past a 2-plane slab, the k7 one on an empty slab through the K2
  wrapper, the deconvs, the 2D ConvNorm, GroupNorm, BatchNorm in train
  mode, a two-level ``Hourglass`` with an empty position and a
  four-level ``HourglassDeep`` with a short and with an empty one)
  against the whole module in float64 (GroupNorm's moments too), in
  both forms: the output, the input's gradient, the parameters'
  gradients summed over the positions and BatchNorm's running
  statistics, within 1e-6 of scale, as tests/test_torch_tensor_parallel.py
  holds the even splits.
* ``tiny_stereo_config(num_depths=8, z_max=38.0, max_depth=40.0)`` on
  make_mesh(1, 3): 2 units of 4 planes over three positions, 4 / 4 / 0,
  where GSPMD splits 3 / 3 / 2 and pads.  (JAX's StereoHead refuses a
  ``num_depths`` that 4 does not divide, snvc_tpu/models/stereonet.py:
  128-142, and so does the port's, so no stereo slab is short.)  One
  step with ``warmup_steps=0`` from numpy-drawn variables:
  - against JAX's ``make_stereo_train_step_split`` on ``make_mesh(
    n_data=1, n_model=3)``, the port's float64 one-process step at the
    margins of tests/test_torch_tensor_parallel_local_stereo.py (JAX's
    own float32 drift): losses 3e-4 relative, ``grad_norm`` 2e-3, each
    gradient within 0.15 of its scale and 1.2e-2 global relative L2,
    BatchNorm statistics 1e-5 of scale, the parameters within Adam's
    sign-flip bound 2 x lr;
  - in float64 against the port's one-device step, and three gloo ranks
    of the process-group form against the one-process step: losses to
    1e-5 relative, gradients and BatchNorm statistics to 1e-5 (global
    relative L2; each element within 1e-5 of its tensor's scale or
    1e-8), the parameters after the AdamW update to 1e-5 (global
    relative L2; each element within the sign-flip bound);
  - ``DetectRunner`` (float32) on the one-process make_mesh(1, 3) and on
    the three ranks against the one-device runner: the same valid slots
    and classes, boxes within 2e-5 m and scores within 2e-6 (the rule of
    tests/test_torch_tensor_parallel_local_stereo.py).
* The empty position builds no plane: its 3D stack takes a 0-plane
  volume.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.models.stereonet import StereoNet as JStereoNet
from snvc_tpu.parallel.api import make_mesh as jmake_mesh
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train_stereo import make_stereo_train_step_split
from snvc_tpu_torch.config import TrainConfig, tiny_stereo_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.parallel.local import run_positions
from snvc_tpu_torch.parallel.tensor import (
    gather,
    halo_exchange,
    model_max,
    model_sum,
    shard,
    slab_amax,
    slab_bounds,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    PADDED_LAYER_CASES,
    as_numpy,
    float64_moments,
    input_shapes,
    large_tap_any_dtype,
    one_process_layer_errors,
    spawn_ranks,
    stereo_model,
    stereo_record,
    tp_layers_padded,
    tp_stereo,
)
from tests.torch_port_helpers import random_variables

G = torch.Generator().manual_seed(0)
X = torch.randn((2, 8, 3), generator=G, dtype=torch.float64)
W_HALO = torch.randn((2, 2, 13, 3), generator=G, dtype=torch.float64)
W_GATHER = torch.randn((2, 2, 8, 3), generator=G, dtype=torch.float64)
UNITS = (6, 8)  # 6 / 2 and 8 / 0 of the 8 planes
TC = dict(lr=3e-4, warmup_steps=0, total_steps=20, grad_clip=5.0)
OVER = dict(z_max=38.0, max_depth=40.0)
LOSSES = ("total", "cls", "reg", "centerness", "depth", "num_pos",
          "grad_norm")
D, N_MODEL, SLABS = 8, 3, [4, 4, 0]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_slab_rule_cuts_short_and_empty_slabs():
    """ceil(extent / unit) units, the last short, spread as np.array_split
    spreads them; the splits that worked before keep their slabs."""
    assert slab_bounds(48, 4, 16) == [0, 16, 32, 48, 48]
    assert slab_bounds(40, 4, 16) == [0, 16, 32, 40, 40]
    assert slab_bounds(40, 2, 16) == [0, 32, 40]
    assert slab_bounds(8, 3, 4) == [0, 4, 8, 8]
    assert slab_bounds(66, 3, 4) == [0, 24, 48, 66]
    assert slab_bounds(5, 4, 4) == [0, 4, 5, 5, 5]
    for extent, n, unit in ((64, 3, 4), (12, 2, 4), (192, 5, 16)):
        k = extent // unit
        want = np.cumsum([0] + [len(a) * unit for a in
                                np.array_split(np.arange(k), n)])
        assert slab_bounds(extent, n, unit) == want.tolist()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with spawn_ranks(tp_layers_padded, 2,
                     str(tmp_path_factory.mktemp("tp_padded")), X, W_HALO,
                     W_GATHER, UNITS) as results:
        yield results()


def _halo_reference(x, bounds, weights):
    """Each slab's halo (2 below, 3 above) cut from the whole tensor padded
    with zeros, and the sum of the weighted halos."""
    xpad = F.pad(x, (0, 0, 2, 3))
    halos = [xpad[:, a:b + 5] for a, b in zip(bounds, bounds[1:])]
    total = sum((h * w[:, :h.shape[1]]).sum() for h, w in
                zip(halos, weights))
    return halos, total


@pytest.mark.parametrize("unit", UNITS)
def test_halo_exchange_and_gather_on_short_and_empty_slabs(ranks, unit):
    """Two gloo ranks: a halo that reaches past a short or an empty
    neighbour is zeros; the gradient of both ranks' sums with respect to
    each slab against the same sums on the whole tensor."""
    b = slab_bounds(8, 2, unit)
    x = X.clone().requires_grad_()
    halos, total = _halo_reference(x, b, W_HALO)
    for r in range(2):
        got = ranks[r]["exchanges"][unit]
        torch.testing.assert_close(got["halo"], halos[r].detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["gather"], X, rtol=0, atol=0)
        total = total + (x * W_GATHER[r]).sum()
    total.backward()
    for r in range(2):
        dx = ranks[r]["exchanges"][unit]["dx"]
        assert dx.shape[1] == b[r + 1] - b[r]
        torch.testing.assert_close(dx, x.grad[:, b[r]:b[r + 1]], rtol=1e-12,
                                   atol=0)


def _assert_layer(errs, slabs, name):
    errs = dict(errs)
    slab_in, whole_in, slab_out, whole_out = errs.pop("extents")
    assert slab_in in slabs and whole_in == sum(slabs), name
    assert any(k.startswith("d") and k != "dx" for k in errs), name
    bad = {k: e for k, e in errs.items() if not e <= 1e-6}
    assert not bad, (name, bad)
    return slab_out, whole_out


@pytest.mark.parametrize("name", list(PADDED_LAYER_CASES))
def test_padded_layer_matches_the_whole_module_on_ranks(ranks, name):
    """Each gloo rank computed on its slab (short or empty) of the input
    and of the output."""
    slabs = PADDED_LAYER_CASES[name][3]
    outs = [_assert_layer(r["layers"][name], slabs, name) for r in ranks]
    assert [r["layers"][name]["extents"][0] for r in ranks] == list(slabs)
    assert sum(o for o, _ in outs) == outs[0][1], name
    if 0 in slabs:
        assert outs[slabs.index(0)][0] == 0


@pytest.mark.parametrize("name", list(PADDED_LAYER_CASES))
def test_padded_layer_matches_the_whole_module_in_one_process(name):
    """make_mesh(1, 2 CPUs, 2): each position's replica on its slab, one
    backward of both positions' sums."""
    case_name, shape, unit, slabs = PADDED_LAYER_CASES[name]
    with float64_moments(True), large_tap_any_dtype():
        errs = one_process_layer_errors(
            case_name, make_mesh(1, ["cpu"] * 2, 2), shape, unit)
    assert sum(e["extents"][2] for e in errs) == errs[0]["extents"][3]
    for p, e in enumerate(errs):
        assert e["extents"][0] == slabs[p]
        _assert_layer(e, slabs, name)


@pytest.mark.parametrize("unit", [6, 8])
def test_one_process_collectives_on_short_and_empty_slabs(unit):
    """On make_mesh(1, 3 CPUs, 3) a [2, 16, 3] tensor in units of 6
    (6 / 6 / 4) or 8 (8 / 8 / 0): each position's halo (2 planes below,
    3 above), gather, model_sum and model_max of ``slab_amax`` (-inf
    from the empty slab), and one backward of every position's weighted
    sums, against the same sums on the whole tensor (float64, exact up
    to the order of the adds)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 16, 3), generator=g, dtype=torch.float64)
    b = slab_bounds(16, 3, unit)
    w = [torch.randn((2, b[p + 1] - b[p] + 5, 3), generator=g,
                     dtype=torch.float64) for p in range(3)]
    v = torch.randn((3, 2, 16, 3), generator=g, dtype=torch.float64)
    xl = x.clone().requires_grad_()

    def position(pos):
        xs = shard(xl, 1, pos, unit)
        return (halo_exchange(xs, 1, 2, 3, pos),
                gather(xs, 1, pos, 16, unit), model_sum(xs.sum(), pos),
                model_max(slab_amax(xs, 1), pos))

    outs = run_positions(make_mesh(1, ["cpu"] * 3, 3), position)
    xw = x.clone().requires_grad_()
    halos, want = _halo_reference(xw, b, w)
    total = 0.0
    for p, (halo, whole, total_sum, top) in enumerate(outs):
        torch.testing.assert_close(halo, halos[p].detach(), rtol=0, atol=0)
        torch.testing.assert_close(whole, x, rtol=0, atol=0)
        torch.testing.assert_close(total_sum, x.sum(), rtol=1e-12, atol=0)
        torch.testing.assert_close(top, x.amax(1, keepdim=True), rtol=0,
                                   atol=0)
        total = total + (halo * w[p]).sum() + (whole * v[p]).sum() \
            + (p + 1.0) * total_sum
        want = want + (xw * v[p]).sum() + (p + 1.0) * xw.sum()
    total.backward()
    want.backward()
    torch.testing.assert_close(xl.grad, xw.grad, rtol=1e-12, atol=1e-12)


def test_one_process_halo_refuses_a_halo_past_a_whole_slab():
    """A halo wider than a slab that is not the last to hold planes
    reaches on into the planes of the slab beyond it: 3 planes below
    each of three 2-plane slabs, against the zero-padded whole tensor
    (exact)."""
    x = torch.arange(6, dtype=torch.float64).reshape(1, 6) + 1.0

    def position(pos):
        return halo_exchange(shard(x, 1, pos, 2), 1, 3, 0, pos)

    outs = run_positions(make_mesh(1, ["cpu"] * 3, 3), position)
    xpad = F.pad(x, (3, 0))
    for p, halo in enumerate(outs):
        torch.testing.assert_close(halo, xpad[:, 2 * p:2 * p + 5], rtol=0,
                                   atol=0)


# --- the stereo step and runner on make_mesh(1, 3) --------------------
def _jax_record(state, metrics):
    mu = state.opt_state[1][0].mu
    return dict(
        metrics=[{k: float(a) for k, a in metrics.items()}],
        grads={n: w / 0.1 for n, w in
               convert_variables({"params": mu}).items()},
        stats=convert_variables({"batch_stats": state.batch_stats}),
        params=convert_variables({"params": state.params}))


def _detect(cfg, sd, request, mesh):
    """The float32 runner on ``mesh`` and the planes of the volume its
    last (empty) position's 3D stack takes."""
    runner = DetectRunner(stereo_model(cfg, sd), cfg, device="cpu",
                          score_threshold=0.0, mesh=mesh)
    with input_shapes(runner.replicas[N_MODEL - 1].head.ConvNorm3d_0) \
            as shapes:
        out = [t.numpy() for t in runner.forward(request)]
    return out, [s[1] for s in shapes]


@pytest.fixture(scope="module")
def stereo(tmp_path_factory):
    """Three gloo ranks (rank 0 then takes the one-device step and
    runner) run while this process takes JAX's mesh step, then the
    port's one-process step and runner."""
    tc = TrainConfig(**TC)
    tcfg = tiny_stereo_config(num_depths=D, **OVER)
    jcfg = jax_tiny(num_depths=D, **OVER)
    batch = as_numpy(synthetic_stereo_request(tcfg, seed=0, frames=1,
                                              boxes_per_frame=2))
    v = random_variables(
        JStereoNet(jcfg), batch["images_left"].astype(np.float32),
        batch["images_right"].astype(np.float32), batch["P_left"],
        batch["P_right"], seed=3)
    sd = as_numpy(convert_variables(v))
    request = synthetic_stereo_request(tcfg, seed=4, frames=1)
    with spawn_ranks(tp_stereo, N_MODEL,
                     str(tmp_path_factory.mktemp("s_padded")), N_MODEL,
                     tcfg, tc, sd, batch, request) as gloo:
        jtc = JTrainConfig(**TC)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=jmake_optimizer(jtc).init(v["params"]))
        jstep = make_stereo_train_step_split(
            JStereoNet(jcfg), jcfg, jtc,
            mesh=jmake_mesh(n_data=1, n_model=N_MODEL))
        jstate, m = jstep(jstate, dict(batch))
        jrec = _jax_record(jax.device_get(jstate), m)
        mesh = make_mesh(1, ["cpu"] * N_MODEL, N_MODEL)
        local = stereo_record(tcfg, tc, sd, batch, mesh=mesh, float64=True,
                              steps=1)
        detect = _detect(tcfg, sd, request, mesh)
        ranks = gloo()
    return dict(jax=jrec, local=local, one=ranks[0]["one"], gloo=ranks,
                detect=detect)


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


def test_each_position_holds_its_slab_of_planes(stereo):
    shapes = stereo["local"]["volume_shapes"]
    assert sorted(s[1] for s in shapes) == sorted(SLABS)
    assert [r["step"]["volume_shapes"][0][1] for r in stereo["gloo"]] \
        == SLABS
    assert stereo["detect"][1] == [0]  # the empty position's stack


def test_float64_step_matches_one_device(stereo):
    _assert_float64_close(stereo["local"], stereo["one"]["step"])


@pytest.mark.parametrize("rank", range(N_MODEL))
def test_float64_step_matches_the_process_group_form(stereo, rank):
    _assert_float64_close(stereo["local"], stereo["gloo"][rank]["step"])


def test_step_matches_jax_padded_mesh_step(stereo):
    """tests/test_torch_tensor_parallel_local_stereo.py's margins."""
    got, want = stereo["local"], stereo["jax"]
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


@pytest.mark.parametrize("form", ["one_process", "gloo"])
def test_detect_runner_with_an_empty_position(stereo, form):
    want = stereo["one"]["detect"]
    if form == "one_process":
        _assert_proposals_close(stereo["detect"][0], want)
    else:
        for r in stereo["gloo"]:
            _assert_proposals_close(r["detect"], want)
