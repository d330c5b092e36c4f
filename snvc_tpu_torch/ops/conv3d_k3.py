"""Kernel K5: the k3x3x3 stride-1 SAME 3D convolution, NDHWC.

Replaces the implicit-GEMM Pallas kernel of snvc_tpu/ops/conv3d_pallas.py
(``_conv3d_pallas_fwd`` -> ``_kernel``, ``pallas_call`` at :118; public
``conv3d_k3`` :131, XLA VJP :138-155).  The TPU kernel DMAs a
(3, TH+2, W, C) halo window into VMEM and runs one [TH*W, 27C] x [27C, F]
dot per grid step.  On the card that is the same implicit GEMM as K2's,
at a 3x3x3 tap, so K5 runs the K2 kernel (csrc/conv3d_large_tap.cu) with
kd = 3 through its own entry point and launch count, and takes K2's
backward (``Conv3dTaps``: dx on the same kernel with flipped weights, dw on
csrc/conv3d_weight_grad.cu).  The TPU gate's C % 128 == 0, F <= 128 and
H % TH == 0 are Mosaic tiling limits, not conditions of the function, and
are not carried over.

On no path: ``Conv3d.pallas`` defaults to "never", as in JAX, so neither
serving nor training launches K5.  A CPU tensor goes to the plain per-tap
version; a CUDA tensor goes to the kernel or raises.
"""

from __future__ import annotations

import torch

from snvc_tpu_torch.ops.conv3d_fold import (
    Conv3dTaps,
    _launch_conv3d,
    conv3d_pertap,
)


def k3_eligible(kernel, stride, dilation: int, dtype) -> bool:
    """The convs ``Conv3d(pallas="auto")`` sends to K5: k3x3x3, stride 1,
    dilation 1, bf16."""
    return (tuple(kernel) == (3, 3, 3) and tuple(stride) == (1, 1, 1)
            and dilation == 1 and dtype == torch.bfloat16)


def _k3_forward(x, w, dilation):
    if not x.is_cuda:
        return conv3d_pertap(x, w, dilation)
    if tuple(w.shape[:3]) != (3, 3, 3) or dilation != 1:
        raise ValueError(f"K5 takes a k3 kernel at dilation 1, got "
                         f"{tuple(w.shape[:3])} at {dilation}")
    out = _launch_conv3d(x, w, dilation)
    conv3d_k3.launches += 1
    return out


def conv3d_k3(x, w):
    """x [N, D, H, W, C], w [3, 3, 3, C, F] -> [N, D, H, W, F],
    differentiable.  See the module docstring."""
    return Conv3dTaps.apply(x, w, 1, _k3_forward)


conv3d_k3.launches = 0
