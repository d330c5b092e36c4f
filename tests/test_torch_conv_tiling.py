"""What surrounds the two conv kernels (csrc/conv3d_large_tap.cu and
csrc/conv3d_weight_grad.cu), on the CPU: the weight packing and channel
padding of their wrappers, against the plain per-tap conv and JAX's
``conv3d_pertap_xla``, and the tile and split helpers whose arithmetic the
kernels take from Python (ops/conv3d_fold.py).

Float32 throughout; 2e-4 absolute against JAX, as tests/test_torch_kernels.py
holds the plain conv.  Packing and padding move values without arithmetic,
so they are held to exact equality.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from snvc_tpu.ops.conv3d_fold_pallas import conv3d_pertap_xla
from snvc_tpu_torch import _build
from snvc_tpu_torch.ops.conv3d_fold import (
    SMEM_LIMIT,
    conv3d_pertap,
    conv3d_weight_grad_plain,
    conv_tile_count,
    conv_tile_origin,
    conv_tiling,
    dw_split_ranges,
    dw_splits,
    dw_tiling,
    feature_block,
    large_tap_eligible,
    pack_conv_weight,
    pad_channels,
    unpack_conv_weight,
)


def _conv(seed, shape, kernel, feats):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (rng.standard_normal(kernel + (shape[-1], feats)) * 0.1).astype(
        np.float32)
    g = rng.standard_normal(shape[:-1] + (feats,)).astype(np.float32)
    return x, w, g


def _round8(v):
    return -(-v // 8) * 8


RAGGED = [  # shape, kernel, dilation, features: C and F off the 8 / 16 grid
    ((1, 7, 6, 9, 12), (5, 5, 5), 1, 10),
    ((1, 6, 5, 11, 40), (5, 3, 7), 2, 24),
    ((1, 5, 6, 7, 32), (3, 3, 3), 1, 64),
]


@pytest.mark.parametrize("kernel,C,Fo,nb", [
    ((7, 7, 7), 64, 32, 32), ((5, 3, 7), 40, 24, 32), ((5, 5, 5), 12, 10, 16),
    ((3, 3, 3), 32, 64, 32), ((1, 1, 1), 8, 40, 32), ((7, 7, 7), 96, 48, 32)])
def test_pack_conv_weight_round_trips(kernel, C, Fo, nb):
    w = torch.from_numpy(_conv(0, (1, 1, 1, 1, C), kernel, Fo)[1])
    wpk = pack_conv_weight(w, nb)
    nfb, nch = -(-Fo // nb), -(-C // 16)
    assert wpk.shape == (nfb, kernel[0], nch, kernel[1], kernel[2], nb // 8,
                         2, 8, 8)
    assert torch.equal(unpack_conv_weight(wpk, C, Fo), w)
    # the padding is zeros: the packed tensor holds w's values and no other
    assert torch.equal(wpk[wpk != 0].sort().values, w[w != 0].sort().values)


def test_packed_weight_is_wgmma_core_matrices():
    """Byte (dy, dx, k, n) of a stage's B tiles lies at ((dy*kw + dx)*nb*16
    + (n//8)*128 + (k//8)*64 + (n%8)*8 + k%8) elements, as the kernel's
    descriptor reads it (LBO 128 B across channel groups, SBO 256 B across
    feature groups)."""
    kernel, C, Fo, nb = (5, 3, 7), 40, 24, 32
    w = torch.from_numpy(_conv(1, (1, 1, 1, 1, C), kernel, Fo)[1])
    wpk = pack_conv_weight(w, nb)
    flat = wpk.reshape(wpk.shape[0], kernel[0], wpk.shape[2], -1)
    rng = np.random.default_rng(2)
    for _ in range(200):
        dz, dy, dx = (int(rng.integers(k)) for k in kernel)
        c, f = int(rng.integers(C)), int(rng.integers(Fo))
        fb, n = divmod(f, nb)
        ch, k = divmod(c, 16)
        off = ((dy * kernel[2] + dx) * nb * 16 + (n // 8) * 128
               + (k // 8) * 64 + (n % 8) * 8 + k % 8)
        assert flat[fb, dz, ch, off] == w[dz, dy, dx, c, f]


@pytest.mark.parametrize("shape,kernel,dil,feats", RAGGED)
def test_padded_packed_conv_matches_jax(shape, kernel, dil, feats):
    """The wrapper's operands -- x padded to a multiple of 8 channels, w
    packed and unpacked at padded C and F -- give the plain conv and JAX's
    per-tap conv on the first F channels."""
    x, w, _ = _conv(3, shape, kernel, feats)
    want = np.asarray(conv3d_pertap_xla(x, w, dilation=dil))
    C, c8, f8 = shape[-1], _round8(shape[-1]), _round8(feats)
    xp = pad_channels(torch.from_numpy(x), c8)
    assert xp.shape[-1] == c8 and torch.equal(xp[..., :C],
                                              torch.from_numpy(x))
    assert not xp[..., C:].any()
    wpk = pack_conv_weight(torch.from_numpy(w), feature_block(f8))
    wp = unpack_conv_weight(wpk, c8, f8)  # zero rows / columns past C, F
    got = conv3d_pertap(xp, wp, dil)[..., :feats].numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(
        got, conv3d_pertap(*map(torch.from_numpy, (x, w)), dil).numpy())


@pytest.mark.parametrize("shape,kernel,dil,feats", RAGGED)
def test_padded_weight_grad_matches_unpadded(shape, kernel, dil, feats):
    """dw of zero-padded x and g, cut back to [C, F], is dw itself."""
    x, _, g = _conv(4, shape, kernel, feats)
    xt, gt = torch.from_numpy(x), torch.from_numpy(g)
    got = conv3d_weight_grad_plain(pad_channels(xt, _round8(shape[-1])),
                                   pad_channels(gt, _round8(feats)), kernel,
                                   dil)[..., :shape[-1], :feats]
    assert torch.equal(got, conv3d_weight_grad_plain(xt, gt, kernel, dil))


FWD_SHAPES = [  # x shape, kernel, dilation, output channels (multiple of 8)
    ((4, 32, 192, 192, 64), (7, 7, 7), 1, 32),   # flagship conv1_k7
    ((8, 16, 96, 96, 32), (5, 5, 5), 2, 32),     # training conv3_k5_d2
    ((8, 16, 96, 96, 32), (7, 7, 7), 1, 64),     # conv1_k7's dx
    ((1, 64, 96, 312, 64), (3, 3, 3), 1, 32),    # K5, stereo stack
    ((2, 9, 10, 70, 40), (5, 3, 7), 2, 24),      # ragged
    ((1, 7, 6, 33, 16), (5, 5, 5), 1, 16),       # ragged_scalar, padded
    ((4, 32, 192, 192, 96), (7, 7, 7), 1, 48),   # hrnet-w48 conv1_k7
    ((4, 32, 192, 192, 48), (5, 5, 5), 2, 48),   # hrnet-w48 conv3_k5_d2
    ((8, 16, 96, 96, 48), (7, 7, 7), 1, 96),     # hrnet-w48 conv1_k7's dx
]


@pytest.mark.parametrize("shape,kernel,dil,feats", FWD_SHAPES)
def test_conv_tiling_fits_the_card(shape, kernel, dil, feats):
    t = conv_tiling(shape[3], kernel, dil, feats)
    assert t.TW * t.TH == 512 and t.TW in (32, 64)
    assert t.slab_rows <= 256 and t.slab_cols <= 256
    assert 2 <= t.stages <= 4 and t.smem <= SMEM_LIMIT
    # the narrower tile never pads W more; at dilation 1 only where it pads
    # W less
    pad = -(-shape[3] // t.TW) * t.TW - shape[3]
    pad64 = -(-shape[3] // 64) * 64 - shape[3]
    assert pad <= pad64 and (t.TW == 64 or pad < pad64 or dil == 2)


@pytest.mark.parametrize("shape,feats", [
    ((2, 3, 17, 70, 8), 24), ((1, 2, 8, 64, 8), 64), ((1, 1, 33, 33, 8), 10),
    ((1, 2, 8, 64, 8), 48)])
def test_conv_tiles_cover_every_output_once(shape, feats):
    N, D, H, W = shape[:4]
    f8 = _round8(feats)
    t = conv_tiling(W, (5, 5, 5), 1, f8)
    hits = np.zeros((N, D, H, W, f8), np.int32)
    for b in range(conv_tile_count(shape, f8, t)):
        n, d, h0, w0, f0 = conv_tile_origin(b, shape, f8, t)
        hits[n, d, h0:h0 + t.TH, w0:w0 + t.TW, f0:f0 + t.nb] += 1
    assert (hits == 1).all()


def test_conv_grid_has_no_plane_limit():
    """N*D past 65535 (the old kernel's blockIdx.y bound): the flat index
    still reaches the last plane."""
    shape, f8 = (3, 30000, 8, 64, 8), 64
    t = conv_tiling(64, (5, 5, 5), 1, f8)
    count = conv_tile_count(shape, f8, t)
    assert shape[0] * shape[1] > 65535 and count < 2 ** 31
    assert conv_tile_origin(count - 1, shape, f8, t) == (2, 29999, 0, 0, 32)


DW_SHAPES = [  # W, channels, features (multiples of 8), kernel, dilation
    (96, 64, 32, (7, 7, 7), 1), (96, 32, 32, (5, 5, 5), 1),
    (96, 32, 32, (5, 5, 5), 2), (96, 32, 64, (7, 7, 7), 1),
    (312, 64, 32, (3, 3, 3), 1), (70, 40, 24, (5, 3, 7), 2),
    (33, 16, 16, (5, 5, 5), 1), (192, 128, 64, (7, 7, 7), 2),
    (96, 96, 48, (7, 7, 7), 1), (96, 48, 48, (5, 5, 5), 2)]  # hrnet-w48


@pytest.mark.parametrize("W,C,Fo,kernel,dil", DW_SHAPES)
def test_dw_tiling_fits_the_card(W, C, Fo, kernel, dil):
    t = dw_tiling(W, C, Fo, kernel, dil)
    lag = (kernel[1] - 1) * dil
    assert t.CB * 2 in (32, 64, 128) and t.CB * t.DXS == 64
    assert t.TWc % 32 == 0 and t.TWc + (2 * t.DXS - 1) * dil <= 256
    assert lag + 3 <= t.stages <= 16 and t.smem <= SMEM_LIMIT
    # every column in exactly one chunk, every tap and channel in one block
    assert (t.chunks - 1) * t.TWc < W <= t.chunks * t.TWc
    assert (t.dx_groups - 1) * 2 * t.DXS < kernel[2] <= t.dx_groups * 2 * t.DXS
    assert (t.channel_blocks - 1) * t.CB < C <= t.channel_blocks * t.CB
    assert (t.feature_blocks - 1) * t.NB < Fo <= t.feature_blocks * t.NB


@pytest.mark.parametrize("planes,blocks", [
    (128, 28), (128, 10), (64, 4), (18, 28), (7, 22), (1, 8), (300, 1),
    (70000, 56)])
def test_dw_splits_partition_the_planes(planes, blocks):
    splits = dw_splits(planes, blocks, 132)
    assert 1 <= splits <= planes
    ranges = dw_split_ranges(planes, splits)
    hits = np.zeros(planes, np.int32)
    for p0, p1 in ranges:
        assert p0 < p1  # no split is empty
        hits[p0:p1] += 1
    assert (hits == 1).all()


def test_dw_splits_fill_the_card():
    """conv1_k7's dw at the training shape (28 blocks a split, 128 planes)
    runs at least one block on every SM and no third wave."""
    splits = dw_splits(128, 28, 132)
    assert 132 <= splits * 28 <= 264


def test_pad_channels_keeps_aligned_tensors():
    x = torch.randn(1, 2, 3, 4, 16)
    assert pad_channels(x, 16) is x
    assert F.pad(x, (0, 8)).equal(pad_channels(x, 24))


def test_conv_kernels_are_the_hopper_pipeline():
    """Both conv sources run wgmma on a TMA / mbarrier ring (csrc/hopper.cuh)
    and keep no WMMA body beside it."""
    header = (_build.CSRC / "hopper.cuh").read_text()
    for op in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait",
               "setmaxnreg"):
        assert op in header
    for name in ("conv3d_large_tap", "conv3d_weight_grad"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "hopper.cuh"' in src
        for use in ("hopper::Wgmma", "hopper::tma_load_5d", "hopper::mbar_wait",
                    "hopper::producer_release_registers"):
            assert use in src, (name, use)
        assert "wmma" not in src.replace("Wgmma", "").replace("wgmma", "")


def test_large_tap_eligibility_follows_the_schedules():
    """Dilations and row taps the kernel has no schedule for go to
    F.conv3d, not to a kernel that would refuse them."""
    bf16 = torch.bfloat16
    assert large_tap_eligible((5, 5, 5), (1, 1, 1), bf16, 2)
    assert not large_tap_eligible((5, 5, 5), (1, 1, 1), bf16, 3)
    assert not large_tap_eligible((5, 9, 5), (1, 1, 1), bf16)
