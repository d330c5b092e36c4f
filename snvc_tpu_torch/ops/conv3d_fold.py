"""Kernel K2: large-tap stride-1 3D convolution, NDHWC.

Replaces the in-VMEM fold_out Pallas kernel of
snvc_tpu/ops/conv3d_fold_pallas.py (``_fold_vmem_fwd_t`` -> ``_kernel``,
``pallas_call`` at :236; public ``conv3d_fold_vmem`` :274 and
``conv3d_fold_vmem_t`` :296).  That kernel folds the kd depth taps into
the output lanes of a per-plane GEMM to fill the TPU's 128-wide matrix
unit and keeps a rolling float32 accumulator in VMEM.  Those are TPU
shapes; the CUDA kernel (csrc/conv3d_large_tap.cu) is an implicit GEMM
on the tensor cores instead: each block owns 4 output rows x 64 output
columns x 32 output features of one depth plane, stages for every
(dz, dy) tap pair the input rows and the [kw, C, F] weight slice in
shared memory (zero-filled outside the volume), and accumulates all
kd*kh*kw*C products in float32 WMMA fragments.  Any H, W (masked), any
dilation, odd kernels with kd >= 5.

Bound: operations.  At the flagship size (x [4, 32, 192, 192, 64->32])
conv1_k7 is 6.6 TFLOP and conv2_k5 / conv3_k5_d2 1.2 TFLOP each, so the
three together take at least ~9 ms at 989 TFLOP/s bf16 while they move
only ~1.5 GB.  The kernel reads every staged input element kw times from
shared memory per k-step and issues one WMMA per 16x16x16 tile; it is the
simple first version, not yet the TMA / wgmma pipeline the card's peak
needs.

Backward (``Conv3dTaps``, a ``torch.autograd.Function``; JAX takes the
VJP of ``conv3d_pertap_xla`` through XLA, conv3d_fold_pallas.py:285-292):

  * dx is the same SAME stride-1 conv of the output gradient with the
    weights flipped in all three taps and C <-> F swapped
    (``flip_weight``), exact for odd kernels, so it runs on this kernel
    (``conv3d_input_grad``);
  * dw is, per tap, X_tap^T . G, a GEMM over all N*D*H*W positions, run by
    the split-K WMMA kernel csrc/conv3d_weight_grad.cu
    (``conv3d_weight_grad``) and rounded once to bf16, as JAX's VJP of a
    bf16 conv is.

Each wrapper sends a CPU tensor to its plain version below and a CUDA
tensor to its kernel, or raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

# split-K target: enough blocks of the dw kernel to fill 132 SMs 8 deep
_DW_BLOCKS = 1056


def large_tap_eligible(kernel, stride, dtype) -> bool:
    """The convs ``Conv3d`` sends to K2: bf16 (the kernel's one type),
    stride 1, odd kernels, kd >= 5."""
    kd, kh, kw = kernel
    return (dtype == torch.bfloat16 and tuple(stride) == (1, 1, 1)
            and kd >= 5 and kd % 2 == 1 and kh % 2 == 1 and kw % 2 == 1)


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


def _launch_conv3d(x, w, dilation: int):
    """One launch of the csrc/conv3d_large_tap.cu kernel (any odd kernel):
    checks the operands and returns the [N, D, H, W, F] output.  Callers
    count the launch."""
    kd, kh, kw, C, Fo = w.shape
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"the conv kernel takes bf16, got {x.dtype}/{w.dtype}")
    if x.ndim != 5 or x.shape[-1] != C:
        raise ValueError(f"x {tuple(x.shape)} does not match w {tuple(w.shape)}")
    if not w.is_cuda or w.device != x.device:
        raise ValueError("x and w must lie on the same CUDA device")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    if kd % 2 == 0 or kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"kernel {(kd, kh, kw)} is not odd")
    if dilation < 1:
        raise ValueError(f"dilation must be >= 1, got {dilation}")
    N, D, H, W, _ = x.shape
    out = torch.empty((N, D, H, W, Fo), dtype=x.dtype, device=x.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("conv3d_large_tap")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.snvc_conv3d_large_tap(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), N, D, H, W, C, Fo,
        kd, kh, kw, dilation, stream)
    if err != 0:
        raise RuntimeError(f"conv3d_large_tap launch failed: "
                           f"{error_string(lib, err)}")
    return out


def _large_tap_forward(x, w, dilation):
    if not x.is_cuda:
        return conv3d_pertap(x, w, dilation)
    kd, kh, kw = w.shape[:3]
    if kd < 5:
        raise ValueError(f"kernel {(kd, kh, kw)} has kd < 5 (K5 takes k3)")
    out = _launch_conv3d(x, w, dilation)
    conv3d_large_tap.launches += 1
    return out


def conv3d_input_grad(g, w, dilation: int = 1):
    """dx of a stride-1 SAME conv: the conv of g with ``flip_weight(w)``,
    on the K2 kernel for a CUDA tensor (K2's and K5's backward)."""
    wf = flip_weight(w)
    if not g.is_cuda:
        return conv3d_pertap(g, wf, dilation)
    out = _launch_conv3d(g.contiguous(), wf, dilation)
    conv3d_input_grad.launches += 1
    return out


def conv3d_weight_grad(x, g, kernel, dilation: int = 1):
    """dw of a stride-1 SAME conv, [kd, kh, kw, C, F] in x's dtype: the
    plain version for a CPU tensor, csrc/conv3d_weight_grad.cu (bf16,
    kw in {1, 3, 5, 7}) for a CUDA tensor."""
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
    if kw not in (1, 3, 5, 7) or kd % 2 == 0 or kh % 2 == 0:
        raise ValueError(f"kernel {kernel} is not odd with kw <= 7")
    x, g = x.contiguous(), g.contiguous()
    N, D, H, W, C = x.shape
    Fo = g.shape[-1]
    rows = N * D * H
    per_split = kd * kh * math.ceil(C / 64) * math.ceil(Fo / 32)
    splits = max(1, min(rows, math.ceil(_DW_BLOCKS / per_split)))
    partial = torch.empty(
        (splits, kd * kh * kw, math.ceil(C / 16) * 16,
         math.ceil(Fo / 16) * 16), dtype=torch.float32, device=x.device)
    dw = torch.empty((kd, kh, kw, C, Fo), dtype=torch.bfloat16,
                     device=x.device)
    from snvc_tpu_torch._build import error_string, load_library

    lib = load_library("conv3d_weight_grad")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.snvc_conv3d_weight_grad(
        x.data_ptr(), g.data_ptr(), partial.data_ptr(), dw.data_ptr(), N, D,
        H, W, C, Fo, kd, kh, kw, dilation, splits, stream)
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
