"""Halos wider than a neighbour's slab (parallel/tensor.py
``halo_sources``): a slab's halo takes its planes from as many
neighbours as it reaches, and zeros only past the volume's ends, in both
forms of the model axis (four gloo ranks, and the one-process mesh of
parallel/local.py on four positions).  No split is refused for its
halo, as GSPMD refuses none.

* ``halo_exchange`` of a [2, 16, 3] tensor, float64, for halos of
  (9, 9), (5, 3), (7, 2), (6, 6), (3, 0) and (2, 3) planes over slabs of
  4 / 4 / 4 / 4, 6 / 6 / 4 / 0 and 8 / 8 / 0 / 0: each halo equal to the
  zero-padded whole tensor's planes, and the gradient of every
  position's weighted halo against the same sum on the whole tensor
  (exact up to the order of the adds: 1e-12).
* Each layer case of ``torch_parallel_ranks.WIDE_LAYER_CASES`` against
  the whole module in float64 (GroupNorm's moments too), in both forms:
  the large-tap k5 d2 conv (4-plane halo) over slabs of 2 planes (also
  with a short and with an empty last slab) and the k7 one (3 planes)
  over 3 / 2 / 2 / 2, both through the K2 wrapper; a k7 d3 conv whose
  9-plane halo reaches two slabs each way; a 2D ConvNorm k7 over 2-plane
  slabs; both deconvs over 1-plane slabs.  The output, the input's
  gradient, the parameters' gradients summed over the positions within
  1e-6 of scale, as tests/test_torch_tensor_parallel.py holds the even
  splits.
"""

import pytest
import torch
import torch.nn.functional as F

from snvc_tpu_torch.parallel.api import make_mesh
from snvc_tpu_torch.parallel.local import run_positions
from snvc_tpu_torch.parallel.tensor import (
    halo_exchange,
    halo_sources,
    shard,
    slab_bounds,
)
from tests.torch_parallel_ranks import (
    WIDE_LAYER_CASES,
    WIDE_N,
    float64_moments,
    large_tap_any_dtype,
    one_process_layer_errors,
    spawn_ranks,
    tp_layers_wide,
    tp_mesh,
)

G = torch.Generator().manual_seed(0)
X = torch.randn((2, 16, 3), generator=G, dtype=torch.float64)
# (lo, hi, unit): 16 planes over four positions
EXCHANGES = ((9, 9, 4), (5, 3, 2), (7, 2, 6), (6, 6, 4), (3, 0, 1),
             (2, 3, 8))


def _weights(lo, hi, unit):
    g = torch.Generator().manual_seed(100 * lo + 10 * hi + unit)
    b = slab_bounds(16, WIDE_N, unit)
    return [torch.randn((2, b[p + 1] - b[p] + lo + hi, 3), generator=g,
                        dtype=torch.float64) for p in range(WIDE_N)]


def _exchanges(mesh, x):
    """Each halo of EXCHANGES of this position's slab of ``x`` and the
    gradient of its weighted sum."""
    out = []
    for lo, hi, unit in EXCHANGES:
        xs = shard(x, 1, mesh, unit).clone().requires_grad_()
        halo = halo_exchange(xs, 1, lo, hi, mesh)
        (halo * _weights(lo, hi, unit)[mesh.model_index]).sum().backward()
        out.append((halo.detach(), xs.grad))
    return out


def wide_rank(rank) -> dict:
    return dict(exchanges=_exchanges(tp_mesh(rank, WIDE_N), X),
                layers=tp_layers_wide(rank))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    with spawn_ranks(wide_rank, WIDE_N,
                     str(tmp_path_factory.mktemp("wide"))) as results:
        yield results()


def test_halo_sources_reach_past_narrow_slabs():
    # slabs 2 / 2 / 2 / 2, a halo of 4: position 1's lower halo is the
    # volume's edge (2 planes) and slab 0; its upper halo slabs 2 and 3
    assert halo_sources([2, 2, 2, 2], 1, 4, 4) == [
        (0, 0, 0, 2, 2), (1, 2, 0, 0, 2), (1, 3, 0, 2, 2)]
    # past a short last slab and an empty one: zeros
    assert halo_sources([4, 4, 1, 0], 1, 3, 3) == [
        (0, 0, 1, 0, 3), (1, 2, 0, 0, 1)]
    assert halo_sources([4, 4, 1, 0], 3, 2, 2) == [
        (0, 1, 3, 0, 1), (0, 2, 0, 1, 1)]
    assert halo_sources([8, 8], 0, 0, 0) == []


def _check_exchanges(got):
    """Every position's halos and slab gradients against the whole
    tensor's."""
    for (lo, hi, unit), res in zip(EXCHANGES, zip(*got)):
        b = slab_bounds(16, WIDE_N, unit)
        w = _weights(lo, hi, unit)
        x = X.clone().requires_grad_()
        xpad = F.pad(x, (0, 0, lo, hi))
        total = 0.0
        for p, (halo, _) in enumerate(res):
            ref = xpad[:, b[p]:b[p + 1] + lo + hi]
            torch.testing.assert_close(halo, ref.detach(), rtol=0, atol=0,
                                       msg=f"{(lo, hi, unit)} {p}")
            total = total + (ref * w[p]).sum()
        total.backward()
        for p, (_, dx) in enumerate(res):
            torch.testing.assert_close(dx, x.grad[:, b[p]:b[p + 1]],
                                       rtol=1e-12, atol=1e-12,
                                       msg=f"{(lo, hi, unit)} {p}")


def test_halo_exchange_on_ranks(ranks):
    _check_exchanges([r["exchanges"] for r in ranks])


def test_halo_exchange_in_one_process():
    outs = run_positions(make_mesh(1, ["cpu"] * WIDE_N, WIDE_N),
                         lambda pos: _exchanges(pos, X))
    _check_exchanges(outs)


def _assert_layer(errs, slabs, name):
    errs = dict(errs)
    slab_in, whole_in, _, _ = errs.pop("extents")
    assert slab_in in slabs and whole_in == sum(slabs), name
    assert any(k.startswith("d") and k != "dx" for k in errs), name
    bad = {k: e for k, e in errs.items() if not e <= 1e-6}
    assert not bad, (name, bad)


@pytest.mark.parametrize("name", list(WIDE_LAYER_CASES))
def test_wide_halo_layer_matches_the_whole_module_on_ranks(ranks, name):
    slabs = WIDE_LAYER_CASES[name][3]
    assert [r["layers"][name]["extents"][0] for r in ranks] == list(slabs)
    for r in ranks:
        _assert_layer(r["layers"][name], slabs, name)


@pytest.mark.parametrize("name", list(WIDE_LAYER_CASES))
def test_wide_halo_layer_matches_the_whole_module_in_one_process(name):
    case, shape, unit, slabs = WIDE_LAYER_CASES[name]
    with float64_moments(True), large_tap_any_dtype():
        errs = one_process_layer_errors(
            case, make_mesh(1, ["cpu"] * WIDE_N, WIDE_N), shape, unit)
    assert [e["extents"][0] for e in errs] == list(slabs)
    for e in errs:
        _assert_layer(e, slabs, name)
