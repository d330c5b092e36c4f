"""The port's tensor parallelism (snvc_tpu_torch/parallel/tensor.py, the
"model" axis of parallel/api.py) on two gloo ranks on the CPU.

* ``halo_exchange`` (2 planes below, 1 above) and ``gather`` of each
  rank's slab, forward and backward, against the same sums computed on
  the whole tensor in this process (float64, exact up to the order of
  the adds); ``shard`` is ``narrow``.
* Each layer of the split stacks (a k3 conv, a stride-2 conv, the
  large-tap k5 d2 and k7 convs through the K2 wrapper, the 3D and 2D
  transposed convs, the 2D ConvNorm, GroupNorm, BatchNorm in train mode,
  a two-level 3D ``Hourglass`` and a four-level 2D ``HourglassDeep``
  with BatchNorm) computed on two slabs against the whole module in
  float64 (GroupNorm's moments too): the output, the input's gradient,
  the parameters' gradients summed over the ranks and BatchNorm's
  running statistics, within 1e-6 of scale (the large-tap convs' plain
  version sums its taps in float32: 3.6e-7 and 4.7e-7; the rest agree
  to 3.4e-12 or better, most to ~3e-16).
* The slab rule (``slab_bounds``: units of 2^levels planes, the last
  short, spread as ``np.array_split`` spreads them, positions beyond the
  units empty), splits whose halos reach past a slab (equal to the whole
  layer and model), and what is still refused: a mesh larger than its
  devices, an ``n_model`` that does not divide the world or would cross
  hosts, the runners given the wrong mesh.  The one-process
  ``make_mesh(n_model=2)`` is built.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snvc_tpu_torch.config import tiny_stereo_config, tiny_vernier_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models.layers import tensor_parallel
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.parallel import api
from snvc_tpu_torch.parallel.local import replicas, run_positions
from snvc_tpu_torch.parallel.tensor import (
    gather,
    halo_exchange,
    model_max,
    model_sum,
    shard,
    slab_bounds,
)
from tests.torch_parallel_ranks import (
    LAYER_CASES,
    float64_moments,
    one_process_layer_errors,
    run_ranks,
    tp_layers,
)

# a [2, 8, 3] tensor split on axis 1: slabs of 4
X = torch.arange(48, dtype=torch.float64).reshape(2, 8, 3) / 7.0
G = torch.Generator().manual_seed(0)
W_HALO = torch.randn((2, 2, 7, 3), generator=G, dtype=torch.float64)
W_GATHER = torch.randn((2, 2, 8, 3), generator=G, dtype=torch.float64)
# a process group's mesh of one data position and two model ranks, for
# the checks that run before any collective
TP_MESH = api.Mesh((torch.device("cpu"),) * 2, rank=0, n_model=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tp_layers, 2, str(tmp_path_factory.mktemp("tp")), X,
                     W_HALO, W_GATHER)


def test_initialize_multihost_refuses_the_wrong_model_axis(ranks):
    for r in ranks:
        three, local = r["refusals"]
        assert "n_model=3 does not divide the world of 2 ranks" in three
        assert "cross host boundaries (local ranks: 1)" in local


def test_halo_exchange_and_gather_forward_and_backward(ranks):
    """Each rank's widened slab and the gathered whole, and the gradient
    of both ranks' sums with respect to each slab, against the same sums
    on the whole tensor."""
    x = X.clone().requires_grad_()
    xpad = F.pad(x, (0, 0, 2, 1))  # zeros beyond the outer ranks
    total = 0.0
    for r in range(2):
        halo = xpad[:, 4 * r:4 * r + 7]
        torch.testing.assert_close(ranks[r]["halo"], halo.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(ranks[r]["gather"], X, rtol=0, atol=0)
        total = total + (halo * W_HALO[r]).sum() + (x * W_GATHER[r]).sum()
    total.backward()
    for r in range(2):
        torch.testing.assert_close(ranks[r]["dx"], x.grad[:, 4 * r:4 * r + 4],
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("name", LAYER_CASES)
def test_split_layer_matches_the_whole_module(ranks, name):
    """Each rank computed on its half of the input and of the output."""
    for r in ranks:
        errs = dict(r["layers"][name])
        slab_in, whole_in, slab_out, whole_out = errs.pop("extents")
        assert (2 * slab_in, 2 * slab_out) == (whole_in, whole_out), name
        assert any(k.startswith("d") and k != "dx" for k in errs), name
        bad = {k: e for k, e in errs.items() if not e <= 1e-6}
        assert not bad, (name, bad)


def test_one_process_collectives_forward_and_backward():
    """On make_mesh(1, 3 CPUs, 3) a [2, 16, 3] tensor split 8 / 4 / 4
    (units of 4): each position's halo (2 planes below, 1 above),
    gather, model_sum and model_max, and one backward of every
    position's weighted sums, against the same sums on the whole tensor
    (float64, exact up to the order of the adds)."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((2, 16, 3), generator=g, dtype=torch.float64)
    b = slab_bounds(16, 3, 4)
    w = [torch.randn((2, b[p + 1] - b[p] + 3, 3), generator=g,
                     dtype=torch.float64) for p in range(3)]
    v = torch.randn((3, 2, 16, 3), generator=g, dtype=torch.float64)
    xl = x.clone().requires_grad_()

    def position(pos):
        xs = shard(xl, 1, pos, 4)
        return (halo_exchange(xs, 1, 2, 1, pos), gather(xs, 1, pos, 16, 4),
                model_sum(xs.sum(), pos), model_max(xs.amax(1), pos))

    outs = run_positions(api.make_mesh(1, ["cpu"] * 3, 3), position)
    xw = x.clone().requires_grad_()
    xpad = F.pad(xw, (0, 0, 2, 1))  # zeros beyond the outer positions
    total, want = 0.0, 0.0
    for p, (halo, whole, total_sum, top) in enumerate(outs):
        ref = xpad[:, b[p]:b[p + 1] + 3]
        torch.testing.assert_close(halo, ref.detach(), rtol=0, atol=0)
        torch.testing.assert_close(whole, x, rtol=0, atol=0)
        torch.testing.assert_close(total_sum, x.sum(), rtol=1e-12, atol=0)
        torch.testing.assert_close(top, x.amax(1), rtol=0, atol=0)
        total = total + (halo * w[p]).sum() + (whole * v[p]).sum() \
            + (p + 1.0) * total_sum
        want = want + (ref * w[p]).sum() + (xw * v[p]).sum() \
            + (p + 1.0) * xw.sum()
    total.backward()
    want.backward()
    torch.testing.assert_close(xl.grad, xw.grad, rtol=1e-12, atol=1e-12)


def test_one_process_positions_fail_together():
    """A position that raises frees the others waiting at a collective,
    and its error is raised; one that ends without meeting them fails
    them."""
    mesh = api.make_mesh(1, ["cpu"] * 2, 2)

    def raising(pos):
        if pos.rank == 1:
            raise KeyError("position 1")
        return model_sum(torch.ones(1), pos)

    with pytest.raises(KeyError, match="position 1"):
        run_positions(mesh, raising)

    def leaving(pos):
        return None if pos.rank == 1 else model_sum(torch.ones(1), pos)

    with pytest.raises(RuntimeError, match="finished while position 0 "
                       "waits at a collective"):
        run_positions(mesh, leaving)


def _layer_within(name, mesh, shape, unit, slabs):
    """``name``'s layer case on the one-process ``mesh`` against the
    whole module: every position's output, input gradient and the
    parameters' gradients within 1e-6 of scale, on ``slabs``."""
    with float64_moments(True):
        errs = one_process_layer_errors(name, mesh, shape, unit)
    assert [e["extents"][0] for e in errs] == list(slabs)
    for e in errs:
        bad = {k: v for k, v in e.items() if k != "extents" and v > 1e-6}
        assert not bad, (name, bad)


def test_uneven_slabs_are_refused():
    """Uneven slabs run: ceil(extent / 2^levels) units, the last short,
    spread as np.array_split spreads them, positions beyond the units
    empty; and no split is refused for its halo, as GSPMD refuses none.
    num_depths = 16 over 2 model positions gives slabs of 8 planes: a
    conv with a 9-plane halo on them (a k7 d3 conv: the halo reaches past
    the neighbour's slab) equals the whole conv, and StereoNet on that
    split (DetectRunner on make_mesh(1, 2)) equals the unsplit model:
    the same valid slots and classes, boxes within 2e-5 m and scores
    within 2e-6 (tests/test_torch_tensor_parallel_padded.py's rule)."""
    assert slab_bounds(64, 3, 4) == [0, 24, 44, 64]
    assert slab_bounds(192, 5, 16) == [0, 48, 96, 128, 160, 192]
    assert slab_bounds(12, 2, 4) == [0, 8, 12]
    assert slab_bounds(14, 2, 4) == [0, 8, 14]  # a short last unit
    assert slab_bounds(4, 2, 4) == [0, 4, 4]  # an empty position
    mesh = api.make_mesh(1, ["cpu"] * 2, 2)
    _layer_within("conv3d_k7_d3", mesh, (1, 16, 3, 3, 4), 4, (8, 8))
    cfg = tiny_stereo_config(num_depths=16)
    request = synthetic_stereo_request(cfg, seed=4, frames=1)
    outs = [[t.numpy() for t in DetectRunner(
        StereoNet(cfg, device="cpu"), cfg, device="cpu",
        score_threshold=0.0, mesh=m).forward(request)]
        for m in (None, mesh)]
    (wb, ws, wc, wv), (boxes, scores, classes, valid) = outs
    assert valid.any()
    np.testing.assert_array_equal(valid, wv)
    np.testing.assert_array_equal(classes, wc)
    np.testing.assert_allclose(boxes[valid], wb[wv], rtol=0, atol=2e-5)
    np.testing.assert_allclose(scores, ws, rtol=0, atol=2e-6)


def test_make_mesh_refuses_the_model_axis_naming_initialize_multihost(
        monkeypatch):
    """make_mesh builds the one-process data x model mesh, "model"
    fastest, and refuses a mesh larger than its devices; without a
    launcher initialize_multihost returns that mesh over the visible
    devices, and refuses a model axis wider than them."""
    mesh = api.make_mesh(1, ["cpu", "cpu"], n_model=2)
    assert (mesh.rank, mesh.n_data, mesh.n_model) == (None, 1, 2)
    assert api.make_mesh(-1, ["cpu"] * 5, n_model=2).n_data == 2
    with pytest.raises(ValueError, match="mesh 1x3 needs more than 2"):
        api.make_mesh(1, ["cpu", "cpu"], n_model=3)
    monkeypatch.delenv("RANK", raising=False)
    assert api.initialize_multihost("gloo", "cpu") is None
    with pytest.raises(ValueError, match="model axis 2 would cross host "
                       "boundaries \\(local devices: 1\\)"):
        api.initialize_multihost("gloo", "cpu", n_model=2)


def test_mesh_layout_puts_model_fastest():
    devs = tuple(torch.device("cpu") for _ in range(8))
    got = [(m.data_index, m.model_index) for m in
           (api.Mesh(devs, rank=r, n_model=2) for r in range(8))]
    assert got == [(d, m) for d in range(4) for m in range(2)]
    assert api.Mesh(devs, rank=5, n_model=2).n_data == 4


def test_runners_take_the_model_axis_where_jax_does():
    """DetectRunner serves one data position split over a process group's
    model axis and every position of a one-process mesh; RefineRunner
    splits instances on "data" only (as JAX's), on the first device of
    each data position; every Vernier head splits its lengths and takes
    a split that leaves positions empty, equal to the unsplit head
    (float32, 1e-5 of scale), even where a halo reaches past a slab."""
    scfg = tiny_stereo_config()
    four = api.Mesh((torch.device("cpu"),) * 4, rank=0, n_model=2)
    with pytest.raises(ValueError, match="one data position, not 2"):
        DetectRunner(StereoNet(scfg, device="cpu"), scfg, device="cpu",
                     mesh=four)
    assert DetectRunner(StereoNet(scfg, device="cpu"), scfg, device="cpu",
                        mesh=TP_MESH).split
    assert DetectRunner(StereoNet(scfg, device="cpu"), scfg, device="cpu",
                        mesh=api.make_mesh(1, ["cpu"] * 2, 2)).positions
    cfg = tiny_vernier_config(max_instances=4)
    with pytest.raises(ValueError, match="make_mesh"):
        RefineRunner(VernierScale(cfg, device="cpu"), cfg, mesh=TP_MESH)
    assert len(RefineRunner(VernierScale(cfg, device="cpu"), cfg,
                            mesh=api.make_mesh(2, ["cpu"] * 4, 2)).replicas
               ) == 2
    bev = tiny_vernier_config(vernier_type="BEV")
    model = VernierScale(bev, device="cpu")
    voxel = torch.randn((1, 8, 16, 16, 16),
                        generator=torch.Generator().manual_seed(5))
    with torch.no_grad():
        whole = model.head(voxel)
    # 4 units of 4 lengths over 8 positions, one each on positions 0-3,
    # none on 4-7: the head runs its slabs (ncf gathered whole, the
    # occupancy a slab), and a conv whose 5-plane halo reaches past the
    # 4-length slabs equals the whole conv
    eight = api.make_mesh(1, ["cpu"] * 8, 8)
    reps = replicas(model.head, eight)

    def position(pos):
        with tensor_parallel(reps[pos.rank], pos), torch.no_grad():
            return reps[pos.rank](shard(voxel, 3, pos, 4))

    outs = run_positions(eight, position)
    assert [o["occupancy"].shape[-1] for o in outs] == [4] * 4 + [0] * 4
    scale = float(whole["ncf"].abs().max())
    for o in outs:
        torch.testing.assert_close(o["ncf"], whole["ncf"], rtol=0,
                                   atol=1e-5 * scale)
    torch.testing.assert_close(
        torch.cat([o["occupancy"] for o in outs], -1), whole["occupancy"],
        rtol=0, atol=1e-5)
    _layer_within("conv3d_k11_length", eight, (1, 2, 3, 16, 4), 4,
                  (4, 4, 4, 4, 0, 0, 0, 0))
