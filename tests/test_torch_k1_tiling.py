"""The launch arithmetic of the K1 kernels (ops/stereo_sample_cuda.py), on
the CPU: the backward's channel slice and cluster split
(``k1_bwd_tiling``) against every configuration the port has, the card's
SMs and shared memory, and the shapes it refuses.

The ``cuda`` tests hold the redesigned kernels to their plain versions on
the card at the shapes whose launch differs: other channel slices, tiny
maps, many lanes per point, and the wrapper's refusal of a map too large
for shared memory.
"""

import numpy as np
import pytest
import torch

from snvc_tpu_torch.config import (
    VernierConfig,
    flagship_vernier_config,
    tiny_vernier_config,
)
from snvc_tpu_torch.models.hrnet import HRNet
from snvc_tpu_torch.ops.grid_sample import (
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import (
    BWD_THREADS,
    SMEM_LIMIT,
    SMEM_PER_SM,
    channel_stride,
    k1_bwd_tiling,
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)

H100_SMS = 132
CONFIGS = {"default": VernierConfig, "flagship": flagship_vernier_config,
           "tiny": tiny_vernier_config}


def _feature_shape(cfg):
    """[N, Hf, Wf, C] of the sampler's feature maps: HRNet's stride-4
    branch of the ROI."""
    H, W = cfg.resolution
    return (cfg.max_instances, H // 4, W // 4, cfg.backbone.output_channel)


def test_tiny_feature_shape_is_the_hrnet_output():
    cfg = tiny_vernier_config()
    net = HRNet(cfg.backbone).eval()
    with torch.no_grad():
        out = net(torch.zeros((1,) + cfg.resolution + (3,)))
    assert tuple(out.shape[1:]) == _feature_shape(cfg)[1:]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_k1_bwd_tiling_fits_every_config(name):
    N, Hf, Wf, C = _feature_shape(CONFIGS[name]())
    t = k1_bwd_tiling(N, Hf, Wf, C, H100_SMS)
    assert C % t.slice == 0 and t.slice == 8
    assert t.smem == t.slice * channel_stride(Hf * Wf, t.slice) * 4 + 16
    assert t.smem <= SMEM_LIMIT
    assert 1 <= t.splits <= 8
    assert t.blocks == N * 2 * (C // t.slice) * t.splits


def test_k1_bwd_tiling_fills_the_card_at_the_training_shape():
    N, Hf, Wf, C = _feature_shape(VernierConfig())
    assert (N, Hf, Wf, C) == (8, 64, 64, 32)
    t = k1_bwd_tiling(N, Hf, Wf, C, H100_SMS)
    # 128 KB maps: one block per SM, so every block is resident at once
    # and all but 4 of the 132 SMs hold one (a third split would need a
    # second wave of 60 blocks)
    per_sm = min(2048 // BWD_THREADS, SMEM_PER_SM // (t.smem + 1024))
    assert per_sm == 1
    assert (t.slice, t.splits, t.blocks) == (8, 2, 128)
    assert H100_SMS - 4 <= t.blocks <= H100_SMS * per_sm


@pytest.mark.parametrize("C,slice_", [(32, 8), (12, 4), (6, 2), (3, 1)])
def test_k1_bwd_tiling_slices_divide_the_channels(C, slice_):
    t = k1_bwd_tiling(2, 16, 16, C, H100_SMS)
    assert t.slice == slice_
    # small maps: two 1024-thread blocks per SM, splits up to a cluster of 8
    assert t.splits == min(8, 2 * H100_SMS // (2 * 2 * C // slice_))


def test_k1_bwd_tiling_narrows_the_slice_for_large_maps():
    # 100 x 100: 8 channels (320 KB) do not fit, 4 (160 KB) do
    t = k1_bwd_tiling(1, 100, 100, 8, H100_SMS)
    assert (t.slice, t.smem) == (4, 4 * 10024 * 4 + 16)


@pytest.mark.parametrize("HW,cs", [(4096, 8), (10000, 4), (28900, 2),
                                   (256, 8), (58081, 1), (100, 8)])
def test_k1_bwd_channel_stride_puts_a_pixels_channels_on_distinct_banks(
        HW, cs):
    stride = channel_stride(HW, cs)
    assert HW <= stride < HW + 32 and (cs > 1 or stride == HW)
    assert len({k * stride % 32 for k in range(cs)}) == cs


def test_k1_bwd_tiling_raises_on_a_map_too_large():
    with pytest.raises(ValueError, match="exceeds a block's 232448 bytes"):
        k1_bwd_tiling(1, 256, 256, 8, H100_SMS)
    # one float32 channel of 241 x 241 is 232324 bytes: it fits, with the
    # walk order's 16
    assert k1_bwd_tiling(1, 241, 241, 8, H100_SMS).slice == 1


def test_k1_backward_on_cpu_takes_any_map():
    # the plain version has no shared-memory limit: the CPU path runs a map
    # the kernel refuses
    rng = np.random.default_rng(0)
    lf = torch.from_numpy(rng.standard_normal((1, 256, 256, 8),
                                              dtype=np.float32))
    gp = torch.from_numpy(rng.uniform(0, 64, (1, 6, 2)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((1, 1, 2, 3, 16),
                                             dtype=np.float32))
    got = stereo_voxel_sample_bwd(lf, lf, gp, gp, g, (64, 64))
    want = sample_stereo_voxel_bwd(lf, lf, gp, gp, g, (64, 64))
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# ------------------------------------------------------------ on card ----
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", 0)


CARD_SHAPES = [  # N, Hf, Wf, C, dtype: the launch each exercises
    (2, 16, 16, 8, torch.bfloat16),     # tiny: one group a view, 8 splits
    (1, 100, 100, 8, torch.bfloat16),   # slice 4 (8-byte channels, scalar)
    (1, 170, 170, 8, torch.float32),    # slice 2 (8-byte channels, scalar)
    (3, 12, 20, 12, torch.float32),     # C 12: slice 4 (16-byte channels)
    (2, 9, 7, 64, torch.float32),       # 16 groups a view, 32 lanes a point
    (1, 10, 12, 256, torch.bfloat16),   # 64 lanes a point, 4 points a block
]


@pytest.mark.cuda
@pytest.mark.parametrize("N,Hf,Wf,C,dtype", CARD_SHAPES)
def test_k1_kernels_match_plain_on_card_at_other_launches(
        cuda_device, N, Hf, Wf, C, dtype):
    rng = np.random.default_rng(7)
    grid, roi = (3, 5, 7), (4 * Hf, 4 * Wf)
    P = 3 * 5 * 7
    lf, rf = (torch.from_numpy(rng.standard_normal((N, Hf, Wf, C),
                                                   dtype=np.float32))
              .to(cuda_device, dtype) for _ in range(2))
    gl, gr = (torch.from_numpy(rng.uniform(-8, roi[1] + 8, (N, P, 2))
                               .astype(np.float32)).to(cuda_device)
              for _ in range(2))
    g = torch.from_numpy(rng.standard_normal((N,) + grid + (2 * C,),
                                             dtype=np.float32)).to(
        cuda_device, dtype)
    tol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    got = stereo_voxel_sample(lf, rf, gl, gr, roi, grid).float()
    want = sample_stereo_voxel(lf, rf, gl, gr, roi, grid).float()
    assert bool(((got - want).abs() <= tol * want.abs() + 1e-5).all())
    got = stereo_voxel_sample_bwd(lf, rf, gl, gr, g, roi)
    want = sample_stereo_voxel_bwd(lf.float(), rf.float(), gl, gr, g.float(),
                                   roi)
    for name, a, b in zip(("dleft", "dright", "dgrid_l", "dgrid_r"), got,
                          want):
        rel = tol if name[1] != "g" else 1e-5
        err = (a.float() - b).abs()
        assert bool((err <= rel * b.abs() + 1e-4 * b.abs().max()).all()), \
            f"{name}: max err {err.max().item()}"


@pytest.mark.cuda
def test_k1_backward_wrapper_refuses_a_map_too_large_on_card(cuda_device):
    lf = torch.zeros((1, 256, 256, 8), device=cuda_device)
    gp = torch.zeros((1, 6, 2), device=cuda_device)
    g = torch.zeros((1, 1, 2, 3, 16), device=cuda_device)
    before = stereo_voxel_sample_bwd.launches
    with pytest.raises(ValueError, match="exceeds a block's"):
        stereo_voxel_sample_bwd(lf, lf, gp, gp, g, (64, 64))
    assert stereo_voxel_sample_bwd.launches == before
