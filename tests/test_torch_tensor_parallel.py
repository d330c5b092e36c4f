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
  units empty) and what is still refused: a slab of whole units
  narrower than a halo; a mesh larger than its devices, an ``n_model``
  that does not divide the world or would cross hosts, the runners given
  the wrong mesh.  The one-process ``make_mesh(n_model=2)`` is built.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snvc_tpu_torch.config import tiny_stereo_config, tiny_vernier_config
from snvc_tpu_torch.inference.detect import DetectRunner
from snvc_tpu_torch.inference.refine import RefineRunner
from snvc_tpu_torch.models import stereonet
from snvc_tpu_torch.models import vernier as vernier_module
from snvc_tpu_torch.models.layers import tensor_parallel
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.parallel import api
from snvc_tpu_torch.parallel.local import run_positions
from snvc_tpu_torch.parallel.tensor import (
    check_split,
    gather,
    halo_exchange,
    model_max,
    model_sum,
    shard,
    slab_bounds,
)
from tests.torch_parallel_ranks import LAYER_CASES, run_ranks, tp_layers

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


def test_uneven_slabs_are_refused():
    """Uneven slabs run: ceil(extent / 2^levels) units, the last short,
    spread as np.array_split spreads them, positions beyond the units
    empty.  check_split refuses only a slab of whole units narrower than
    a halo, with its reason, before any collective; a model runs an
    extent that is not a multiple of its units, or with fewer units than
    positions, as GSPMD pads it."""
    assert slab_bounds(64, 3, 4) == [0, 24, 44, 64]
    assert slab_bounds(192, 5, 16) == [0, 48, 96, 128, 160, 192]
    assert slab_bounds(12, 2, 4) == [0, 8, 12]
    assert slab_bounds(14, 2, 4) == [0, 8, 14]  # a short last unit
    assert slab_bounds(4, 2, 4) == [0, 4, 4]  # an empty position
    check_split("num_depths", 12, TP_MESH, 2)  # 8 / 4
    check_split("num_depths", 16, TP_MESH, 2)
    check_split("num_depths", 14, TP_MESH, 2)  # 8 / 6
    check_split("num_depths", 4, TP_MESH, 2)  # 4 / 0
    check_split("nl", 8, TP_MESH, 1, halo=4)  # 4 / 4
    check_split("nl", 9, TP_MESH, 2, halo=4)  # 8 / 1: the last is short
    with pytest.raises(ValueError, match="a slab of 4 planes, narrower "
                       "than the 5-plane halo"):
        check_split("nl", 8, TP_MESH, 1, halo=5)
    # through the model (its check given a 9-plane halo): before any
    # collective
    cfg = tiny_stereo_config(num_depths=16)
    model = StereoNet(cfg, device="cpu")
    x = torch.zeros((1,) + tuple(cfg.input_size) + (3,))
    P = torch.tensor(np.array([[[700.0, 0, 64, 40], [0, 700, 32, 0],
                                [0, 0, 1, 0]]], np.float32))
    Pr = P.clone()
    Pr[0, 0, 3] = -40.0
    with tensor_parallel(model, TP_MESH), torch.no_grad(), \
            pytest.MonkeyPatch.context() as mp:
        mp.setattr(stereonet, "check_split",
                   lambda *a: check_split(*a[:4], halo=9))
        with pytest.raises(ValueError, match="num_depths = 16 over 2 "
                           "model positions gives a slab of 8 planes, "
                           "narrower than the 9-plane halo"):
            model(x, x, P, Pr)


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
    each data position; every Vernier head splits its lengths, takes a
    split that leaves positions empty, and checks its split before any
    collective."""
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
    eight = api.Mesh((torch.device("cpu"),) * 8, rank=0, n_model=8)
    with tensor_parallel(model, eight), pytest.MonkeyPatch.context() as mp:
        # 4 units of 4 lengths over 8 positions, one each on positions
        # 0-3, none on 4-7: with a 5-plane halo (the check's own is 1)
        # the head refuses before its first collective
        mp.setattr(vernier_module, "check_split",
                   lambda *a: check_split(*a[:4], halo=5))
        with pytest.raises(ValueError, match="grid length nl = 16 over 8 "
                           "model positions gives a slab of 4 planes, "
                           "narrower than the 5-plane halo"):
            model.head(torch.zeros(1, 8, 16, 4, 64))
    assert [check_split("grid length nl", 16, dataclasses.replace(
        eight, rank=r), 2) for r in range(8)] == [None] * 8
