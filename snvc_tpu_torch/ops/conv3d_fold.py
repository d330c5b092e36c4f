"""Kernel K2: large-tap stride-1 3D convolution, NDHWC.

Replaces the in-VMEM fold_out Pallas kernel of
snvc_tpu/ops/conv3d_fold_pallas.py (``_fold_vmem_fwd_t`` -> ``_kernel``,
``pallas_call`` at :236; public ``conv3d_fold_vmem`` :274 and
``conv3d_fold_vmem_t`` :296).  That kernel folds the kd depth taps into
the output lanes of a per-plane GEMM to fill the TPU's 128-wide matrix
unit and keeps a rolling float32 accumulator in VMEM.  Those are TPU
shapes; the CUDA kernel (csrc/conv3d_large_tap.cu) is an implicit GEMM
on Hopper's wgmma instead.  Each block owns 512 output positions of one
depth plane (8 rows x 64 columns, or 16 x 32 where that pads W less or
at dilation 2: ``conv_tiling``) and 16 or 32 features.  A producer warp brings, per
(depth tap, 16-channel chunk), the zero-padded halo slab by one TMA load
and the [kh, kw, 16, NB] weights by one bulk copy into a 2-4 stage
mbarrier ring; two consumer warpgroups load each shifted A fragment once
with ldmatrix and feed it to every output row it meets (up to 4
``wgmma`` per load), B coming from shared memory.  The weights are
repacked once per call into wgmma's K-major core-matrix layout
(``pack_conv_weight``); channel counts that are not multiples of 8 are
padded with zeros here, since a TMA tensor map needs 16-byte strides.

Bound: operations.  At the flagship size (x [4, 32, 192, 192, 64->32])
conv1_k7 is 6.2 useful TFLOP and conv2_k5 / conv3_k5_d2 1.1 TFLOP each,
so the three together take at least 8.5 ms at 989 TFLOP/s bf16 while
they move only ~1.5 GB.

Backward (``Conv3dTaps``, a ``torch.autograd.Function``; JAX takes the
VJP of ``conv3d_pertap_xla`` through XLA, conv3d_fold_pallas.py:285-292):

  * dx is the same SAME stride-1 conv of the output gradient with the
    weights flipped in all three taps and C <-> F swapped
    (``flip_weight``), exact for odd kernels, so it runs on this kernel
    (``conv3d_input_grad``);
  * dw is, per tap, X_tap^T . G, a GEMM over all N*D*H*W positions, run by
    csrc/conv3d_weight_grad.cu (``conv3d_weight_grad``): blocks own a
    depth tap, a few column taps and all row taps, stream the planes of
    their split row by row through a TMA ring (each g row stays resident
    while the kh input rows it meets pass), keep the kh accumulators in
    registers, and write float32 partials per split, which a second
    kernel adds in a fixed order and rounds once to bf16, as JAX's VJP of
    a bf16 conv is.  ``dw_tiling`` and ``dw_splits`` choose its tile and
    split count.

Each wrapper sends a CPU tensor to its plain version below and a CUDA
tensor to its kernel, or raises.  An input of no element (the slab of a
model position that holds no plane) gives the empty output or a zero
weight gradient without a launch.  Both branches declare ``conv3d_work``
(taps inside the volume only, as ``utils.cost`` counts an aten conv) to
an open ``utils.cost`` counter, as K2, K2_dx or K2_dw.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from snvc_tpu_torch.utils.cost import Work, conv3d_same_flops, declare_kernel

# a block's shared memory on an H100 (sm_90): 227 KB
SMEM_LIMIT = 232448


def large_tap_eligible(kernel, stride, dtype, dilation: int = 1) -> bool:
    """The convs ``Conv3d`` sends to K2: bf16 (the kernel's one type),
    stride 1, odd kernels, kd >= 5, kh <= 7, dilation 1 or 2 (the
    kernel's instantiated tap schedules)."""
    kd, kh, kw = kernel
    return (dtype == torch.bfloat16 and tuple(stride) == (1, 1, 1)
            and kd >= 5 and kd % 2 == 1 and kh % 2 == 1 and kw % 2 == 1
            and kh <= 7 and dilation in (1, 2))


def conv3d_work(x_shape, kernel, F_out: int, dilation: int,
                itemsize: int) -> Work:
    """The work of a stride-1 SAME conv of x [N, D, H, W, C] with a
    ``kernel`` tap and ``F_out`` features, and of its dx and dw: the
    multiply-adds of the taps inside the volume (``conv3d_same_flops``),
    and two of x, w and the output (or its gradient) read and the third
    written, each once."""
    C = x_shape[-1]
    positions = math.prod(x_shape[:-1])
    return Work(conv3d_same_flops(x_shape, kernel, F_out, dilation),
                (positions * (C + F_out) + math.prod(kernel) * C * F_out)
                * itemsize)


def _declare_conv(name, x, w, dilation):
    """The declared region of a conv entry on x with weights ``w``
    [kd, kh, kw, C, F]."""
    return declare_kernel(name, conv3d_work, tuple(x.shape),
                          tuple(w.shape[:3]), w.shape[-1], dilation,
                          x.element_size())


def conv3d_pertap(x, w, dilation: int = 1):
    """Plain version (JAX ``conv3d_pertap_xla``): kd depth-shifted 2D convs
    with torch-symmetric padding, summed in float32.

    x [N, D, H, W, C]; w [kd, kh, kw, C, F].  Returns [N, D, H, W, F] in
    x's dtype."""
    kd, kh, kw, C, Fo = w.shape
    N, D, H, W, _ = x.shape
    pad_d = (kd - 1) // 2 * dilation
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pad_d, pad_d))
    pad = ((kh - 1) // 2 * dilation, (kw - 1) // 2 * dilation)
    out = None
    for dz in range(kd):
        xs = xp[:, dz * dilation: dz * dilation + D].reshape(N * D, H, W, C)
        wk = w[dz].to(x.dtype).permute(3, 2, 0, 1)  # [F, C, kh, kw]
        o = F.conv2d(xs.permute(0, 3, 1, 2), wk, None, 1, pad,
                     dilation).float()
        out = o if out is None else out + o
    return out.permute(0, 2, 3, 1).reshape(N, D, H, W, Fo).to(x.dtype)


def flip_weight(w):
    """[kd, kh, kw, C, F] -> [kd, kh, kw, F, C] flipped in every tap: the
    weights whose SAME conv of the output gradient is the input gradient."""
    return w.flip((0, 1, 2)).transpose(3, 4).contiguous()


def conv3d_weight_grad_plain(x, g, kernel, dilation: int = 1):
    """Plain dw: per tap, the float32 sum over every position of the
    shifted input times the output gradient, rounded once to x's dtype.
    x [N, D, H, W, C]; g [N, D, H, W, F] -> [kd, kh, kw, C, F]."""
    kd, kh, kw = kernel
    N, D, H, W, C = x.shape
    Fo = g.shape[-1]
    p = [(k - 1) // 2 * dilation for k in kernel]
    xp = F.pad(x.float(), (0, 0, p[2], p[2], p[1], p[1], p[0], p[0]))
    gf = g.float().reshape(-1, Fo)
    dw = torch.empty((kd, kh, kw, C, Fo), dtype=torch.float32,
                     device=x.device)
    for a in range(kd):
        for b in range(kh):
            for c in range(kw):
                xs = xp[:, a * dilation: a * dilation + D,
                        b * dilation: b * dilation + H,
                        c * dilation: c * dilation + W]
                dw[a, b, c] = xs.reshape(-1, C).T @ gf
    return dw.to(x.dtype)


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _align1024(v: int) -> int:
    return _round_up(v, 1024)


def pad_channels(t, channels: int):
    """``t`` with its last dim zero-padded to ``channels`` (itself if it
    already has them): a TMA tensor map needs 16-byte row strides, so the
    kernels take channel counts that are multiples of 8."""
    extra = channels - t.shape[-1]
    return t if extra == 0 else F.pad(t, (0, extra)).contiguous()


def feature_block(channels: int) -> int:
    """NB, the wgmma N of the conv kernels: 16 for <= 16 channels, else 32
    (wider outputs take several feature blocks)."""
    return 16 if channels <= 16 else 32


def pack_conv_weight(w, nb: int):
    """[kd, kh, kw, C, F] -> [ceil(F/nb), kd, ceil(C/16), kh, kw, nb/8, 2,
    8, 8]: per (feature block, dz, 16-channel chunk, dy, dx) the [16, nb]
    B tile as wgmma's K-major core matrices (8 features x 8 channels),
    zero-padded past C and F.  csrc/conv3d_large_tap.cu bulk-copies one
    (feature block, dz, chunk) slab per pipeline stage."""
    kd, kh, kw, C, Fo = w.shape
    cp, nfb = _round_up(C, 16), -(-Fo // nb)
    wp = F.pad(w, (0, nfb * nb - Fo, 0, cp - C))
    wp = wp.reshape(kd, kh, kw, cp // 16, 2, 8, nfb, nb // 8, 8)
    return wp.permute(6, 0, 3, 1, 2, 7, 4, 8, 5).contiguous()


def unpack_conv_weight(wpk, channels: int, features: int):
    """The inverse of ``pack_conv_weight``: [kd, kh, kw, C, F]."""
    nfb, kd, nch, kh, kw, ng = wpk.shape[:6]
    w = wpk.permute(1, 3, 4, 2, 6, 8, 0, 5, 7)
    w = w.reshape(kd, kh, kw, nch * 16, nfb * ng * 8)
    return w[..., :channels, :features].contiguous()


class ConvTiling(NamedTuple):
    """The forward kernel's tile: TW columns x TH rows of one plane (512
    positions), its halo slab, the pipeline depth and shared memory."""
    TW: int
    TH: int
    nb: int
    slab_rows: int
    slab_cols: int
    stages: int
    smem: int


def conv_tiling(W: int, kernel, dilation: int, features: int) -> ConvTiling:
    """The tile csrc/conv3d_large_tap.cu runs (its Geom and shared-memory
    sums, in Python): 64 columns x 8 rows, or 32 x 16 where that pads W
    less or the dilation is 2 (then every other slab row feeds the 2-row
    m tiles, and each A fragment meets more of them); as many stages
    (2-4) as fit in a block's shared memory."""
    _, kh, kw = kernel
    narrow = _round_up(W, 32) < _round_up(W, 64) or (
        dilation == 2 and _round_up(W, 32) == _round_up(W, 64))
    tw = 32 if narrow else 64
    th = 8 * (64 // tw)
    rows, cols = th + (kh - 1) * dilation, tw + (kw - 1) * dilation
    if rows > 256 or cols > 256:
        raise ValueError(f"kernel {tuple(kernel)} at dilation {dilation} "
                         f"needs a {rows}x{cols} slab (TMA boxes hold 256)")
    nb = feature_block(features)
    stage = _align1024(rows * cols * 32) + _align1024(kh * kw * nb * 32)
    fixed = 1024 + 8 * 16 * (nb * 2 + 16) + 2 * 4 * 8
    stages = min(4, (SMEM_LIMIT - fixed) // stage)
    if stages < 2:
        raise ValueError(f"kernel {tuple(kernel)} at dilation {dilation}: "
                         f"two {stage}-byte stages exceed shared memory")
    return ConvTiling(tw, th, nb, rows, cols, stages, fixed + stages * stage)


def conv_tile_count(shape, features: int, tiling: ConvTiling) -> int:
    """Blocks of the forward kernel's flat grid for x [N, D, H, W, C] and
    ``features`` output channels (a multiple of 8)."""
    N, D, H, W = shape[:4]
    return (N * D * -(-H // tiling.TH) * -(-W // tiling.TW)
            * -(-features // tiling.nb))


def conv_tile_origin(t: int, shape, features: int, tiling: ConvTiling):
    """Block ``t``'s tile as (n, d, h0, w0, f0): the kernel's decode of its
    flat index, feature block fastest, then columns, rows, depth, batch."""
    D, H, W = shape[1:4]
    nht, nwt = -(-H // tiling.TH), -(-W // tiling.TW)
    nfb = -(-features // tiling.nb)
    fb, t = t % nfb, t // nfb
    wt, t = t % nwt, t // nwt
    ht, t = t % nht, t // nht
    return (t // D, t % D, ht * tiling.TH, wt * tiling.TW, fb * tiling.nb)


class DwTiling(NamedTuple):
    """The weight-gradient kernel's block: CB channels x 2*DXS column taps
    (the wgmma M of its two consumer warpgroups), NB features, TWc columns
    per chunk, and its ring of row stages."""
    CB: int
    DXS: int
    NB: int
    TWc: int
    chunks: int
    dx_groups: int
    channel_blocks: int
    feature_blocks: int
    stages: int
    smem: int


def dw_tiling(W: int, channels: int, features: int, kernel,
              dilation: int) -> DwTiling:
    """The tile csrc/conv3d_weight_grad.cu runs for x [..., W, channels]
    and g [..., W, features] (channels and features multiples of 8): the
    fewest column chunks (multiples of 32 wide: an even count of 16-position
    k-steps) whose ring of row stages, at least (kh-1)*dil + 3 deep, fits in
    shared memory."""
    _, kh, kw = kernel
    cb = 16 if channels <= 16 else 32 if channels <= 32 else 64
    dxs, nb = 64 // cb, feature_block(features)
    lag = (kh - 1) * dilation
    for chunks in range(1, W + 1):
        twc = _round_up(-(-W // chunks), 32)
        xcols = twc + (2 * dxs - 1) * dilation
        if xcols > 256:
            continue
        stage = _align1024(xcols * cb * 2) + _align1024(twc * nb * 2)
        fixed = 1024 + 1024 + 2 * 16 * 8
        stages = min(lag + 4, 16, (SMEM_LIMIT - fixed) // stage)
        if stages >= lag + 3:
            return DwTiling(cb, dxs, nb, twc, -(-W // twc),
                            -(-kw // (2 * dxs)), -(-channels // cb),
                            -(-features // nb), stages,
                            fixed + stages * stage)
    raise ValueError(f"kernel {tuple(kernel)} at dilation {dilation}: no "
                     f"column chunk fits the weight-gradient ring")


def dw_splits(planes: int, blocks_per_split: int, sms: int) -> int:
    """Split-K count of the weight-gradient kernel: the number of plane
    ranges (each ``ceil(planes / splits)`` planes, none empty) whose
    blocks, one per SM, finish in the fewest plane-times (waves x planes
    per block, plus half a plane for each block's start and partial
    write); ties go to fewer splits (a smaller partial buffer)."""
    best = None
    for pps in range(1, planes + 1):
        splits = -(-planes // pps)
        waves = -(-splits * blocks_per_split // sms)
        key = (waves * (pps + 0.5), splits)
        if best is None or key < best:
            best = key
    return best[1]


def dw_split_ranges(planes: int, splits: int):
    """The [p0, p1) plane range of each split, as the kernel computes it."""
    pps = -(-planes // splits)
    return [(s * pps, min(planes, s * pps + pps)) for s in range(splits)]


def _launch_conv3d(x, w, dilation: int):
    """One launch of the csrc/conv3d_large_tap.cu kernel (odd kernels with
    kh <= 7, dilation 1 or 2):
    checks the operands, pads C and F to multiples of 8, packs the weights
    and returns the [N, D, H, W, F] output.  Callers count the launch."""
    kd, kh, kw, C, Fo = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the conv kernel takes bf16, got {x.dtype}/{w.dtype}")
    if x.ndim != 5 or x.shape[-1] != C:
        raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0 or kh > 7:
        raise ValueError(f"kernel {(kd, kh, kw)} is not odd with kh <= 7")
    if dilation not in (1, 2):
        raise ValueError(f"the conv kernel takes dilation 1 or 2, got "
                         f"{dilation}")
    N, D, H, W, _ = x.shape
    c8, f8 = _round_up(C, 8), _round_up(Fo, 8)
    tiling = conv_tiling(W, (kd, kh, kw), dilation, f8)
    xk = pad_channels(x, c8)
    wpk = pack_conv_weight(w, tiling.nb)
    out = torch.empty((N, D, H, W, f8), dtype=x.dtype, device=x.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("conv3d_large_tap")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.snvc_conv3d_large_tap(
        xk.data_ptr(), wpk.data_ptr(), out.data_ptr(), N, D, H, W, c8, f8,
        kd, kh, kw, dilation, tiling.TW, tiling.stages, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_large_tap launch failed: "
                           f"{error_string(lib, err)}")
    return out if f8 == Fo else out[..., :Fo].contiguous()


def _empty_conv(x, w):
    """The output of a SAME conv of ``x`` with no element: no launch."""
    return x.new_zeros(x.shape[:-1] + w.shape[-1:])


def _large_tap_forward(x, w, dilation):
    with _declare_conv("K2", x, w, dilation):
        if not x.is_cuda:
            return conv3d_pertap(x, w, dilation)
        kd, kh, kw = w.shape[:3]
        if kd < 5:
            raise ValueError(f"kernel {(kd, kh, kw)} has kd < 5 "
                             f"(K5 takes k3)")
        if x.numel() == 0:
            return _empty_conv(x, w)
        out = _launch_conv3d(x, w, dilation)
        conv3d_large_tap.launches += 1
        return out


def conv3d_input_grad(g, w, dilation: int = 1):
    """dx of a stride-1 SAME conv: the conv of g with ``flip_weight(w)``,
    on the K2 kernel for a CUDA tensor (K2's and K5's backward)."""
    with declare_kernel("K2_dx", conv3d_work, tuple(g.shape),
                        tuple(w.shape[:3]), w.shape[-2], dilation,
                        g.element_size()):
        wf = flip_weight(w)
        if not g.is_cuda:
            return conv3d_pertap(g, wf, dilation)
        if g.numel() == 0:
            return _empty_conv(g, wf)
        out = _launch_conv3d(g.contiguous(), wf, dilation)
        conv3d_input_grad.launches += 1
        return out


def conv3d_weight_grad(x, g, kernel, dilation: int = 1):
    """dw of a stride-1 SAME conv, [kd, kh, kw, C, F] in x's dtype: the
    plain version for a CPU tensor, csrc/conv3d_weight_grad.cu (bf16, odd
    kernels with kh <= 7) for a CUDA tensor."""
    with declare_kernel("K2_dw", conv3d_work, tuple(x.shape), tuple(kernel),
                        g.shape[-1], dilation, x.element_size()):
        return _weight_grad(x, g, kernel, dilation)


def _weight_grad(x, g, kernel, dilation):
    if not x.is_cuda:
        return conv3d_weight_grad_plain(x, g, kernel, dilation)
    kd, kh, kw = kernel
    if x.dtype != torch.bfloat16 or g.dtype != torch.bfloat16:
        raise TypeError(f"conv3d_weight_grad takes bf16, got "
                        f"{x.dtype}/{g.dtype}")
    if x.ndim != 5 or g.shape[:-1] != x.shape[:-1]:
        raise ValueError(f"x {tuple(x.shape)} and g {tuple(g.shape)} differ")
    if not g.is_cuda or g.device != x.device:
        raise ValueError("x and g must lie on the same CUDA device")
    if kh > 7 or kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel {kernel} is not odd with kh <= 7")
    N, D, H, W, C = x.shape
    Fo = g.shape[-1]
    if x.numel() == 0:  # no output position: a zero gradient, no launch
        return torch.zeros((kd, kh, kw, C, Fo), dtype=torch.bfloat16,
                           device=x.device)
    c8, f8 = _round_up(C, 8), _round_up(Fo, 8)
    xk = pad_channels(x.contiguous(), c8)
    gk = pad_channels(g.contiguous(), f8)
    t = dw_tiling(W, c8, f8, kernel, dilation)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    splits = dw_splits(N * D, kd * t.dx_groups * t.channel_blocks
                       * t.feature_blocks * t.chunks, sms)
    partial = torch.empty(
        (splits * t.chunks, kd * kh * kw, t.channel_blocks * t.CB,
         t.feature_blocks * t.NB), dtype=torch.float32, device=x.device)
    dw = torch.empty((kd, kh, kw, C, Fo), dtype=torch.bfloat16,
                     device=x.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("conv3d_weight_grad")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.snvc_conv3d_weight_grad(
        xk.data_ptr(), gk.data_ptr(), partial.data_ptr(), dw.data_ptr(), N,
        D, H, W, C, Fo, c8, f8, kd, kh, kw, dilation, t.TWc, t.stages,
        splits, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_weight_grad launch failed: "
                           f"{error_string(lib, err)}")
    conv3d_weight_grad.launches += 1
    return dw


class Conv3dTaps(torch.autograd.Function):
    """A stride-1 SAME conv whose forward is ``forward_fn(x, w, dilation)``
    (K2's or K5's wrapper) and whose backward is ``conv3d_input_grad`` and
    ``conv3d_weight_grad``; each input's gradient only where it is
    needed."""

    @staticmethod
    def forward(ctx, x, w, dilation, forward_fn):
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return forward_fn(x, w, dilation)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = conv3d_input_grad(g, w, ctx.dilation)
        if ctx.needs_input_grad[1]:
            dw = conv3d_weight_grad(x, g, tuple(w.shape[:3]), ctx.dilation)
        return dx, dw, None, None


def conv3d_large_tap(x, w, dilation: int = 1):
    """Large-tap stride-1 3D conv: x [N, D, H, W, C], w [kd, kh, kw, C, F]
    (the JAX kernel layout) -> [N, D, H, W, F], differentiable.  See the
    module docstring."""
    return Conv3dTaps.apply(x, w, dilation, _large_tap_forward)


conv3d_large_tap.launches = 0
conv3d_input_grad.launches = 0
conv3d_weight_grad.launches = 0
