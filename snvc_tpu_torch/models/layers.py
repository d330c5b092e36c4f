"""Shared conv building blocks, channels-last (port of snvc_tpu/models/layers.py).

Public tensors are NHWC / NDHWC as in the JAX package.  Convolutions run
on a permuted (channels-first) view, which PyTorch treats as channels-last
memory, so no copy is made around them.

Child modules carry the names the Flax modules give their children
(``Conv_0``, ``Norm_0``, ``GroupNorm_0``, ...), so a JAX variables dict
maps onto the port's ``state_dict`` path for path
(``utils/convert_jax.py``).  Parameters stay float32 and are cast to the
activation dtype at use, as the JAX modules do.

Padding is copied module by module: torch-symmetric ``(k-1)//2*dilation``
in ``ConvNorm`` and ``Conv3d`` (JAX layers.py:115, :303), torch
``ConvTranspose(k3, s2, p1, output_padding=1)`` alignment for the deconvs
(layers.py:573), explicit ``(1, 1)`` in the HRNet convs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.ops.conv3d_fold import conv3d_large_tap, large_tap_eligible
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3, k3_eligible


def _norm_groups(requested: int, channels: int) -> int:
    g = min(requested, channels)
    while channels % g:
        g -= 1
    return g


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _pair(v) -> Tuple[int, int]:
    return (v,) * 2 if isinstance(v, int) else tuple(v)


def conv2d_nhwc(x, conv: nn.Conv2d):
    """Apply an ``nn.Conv2d`` (weights [O, I, kh, kw]) to an NHWC tensor."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, conv.stride, conv.padding,
                 conv.dilation)
    return y.permute(0, 2, 3, 1)


def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded LeCun-normal init of every conv / linear weight (the JAX
    modules' ``lecun_normal``), zero biases, unit norm scales.

    Convolution and linear weights are drawn from ``generator`` in
    registration order, so one seed gives one model on any device."""
    for name, p in module.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        with torch.no_grad():
            if leaf == "weight" and p.ndim >= 2:
                if "ConvTranspose" in name:  # [I, O, k...]
                    fan_in = p.shape[0] * math.prod(p.shape[2:])
                else:  # [O, I, k...] / [O, I]
                    fan_in = math.prod(p.shape[1:])
                p.copy_(torch.randn(p.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif leaf == "weight":
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()


class FastGroupNorm(nn.Module):
    """GroupNorm from per-(sample, group) float32 moments and one fused
    ``x * a + b`` pass (JAX layers.py:33).  eps = 1e-5 (torch default)."""

    def __init__(self, channels: int, groups: int, eps: float = 1e-5):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        N, C = x.shape[0], x.shape[-1]
        G = self.groups
        red = tuple(range(1, x.ndim - 1))
        n_red = math.prod(x.shape[1:-1]) * (C // G)
        xf = x.float()
        s1 = xf.sum(red).reshape(N, G, C // G).sum(-1)
        s2 = (xf * xf).sum(red).reshape(N, G, C // G).sum(-1)
        mean = s1 / n_red
        var = s2 / n_red - mean * mean
        inv = torch.rsqrt(var + self.eps)  # [N, G]
        a = inv.repeat_interleave(C // G, dim=-1) * self.weight[None]
        b = self.bias[None] - (mean * inv).repeat_interleave(C // G, dim=-1) \
            * self.weight[None]
        shape = (N,) + (1,) * (x.ndim - 2) + (C,)
        return (xf * a.reshape(shape) + b.reshape(shape)).to(x.dtype)


@contextlib.contextmanager
def frozen_batch_stats(module: nn.Module):
    """The BatchNorms inside ``module`` keep their running statistics while
    this is open: the recompute of a rematerialized block must not update
    them twice."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m in norms:
            m.stats_frozen = False


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax semantics
    (``nn.BatchNorm(momentum=0.9)``, JAX hrnet.py:44).

    Eval mode reads the running statistics.  Train mode normalizes with
    the batch's float32 mean and biased variance E[x^2] - E[x]^2 (clamped
    at 0) and moves the running statistics by ``r = 0.9 r + 0.1 batch``,
    the variance biased too (``F.batch_norm`` would store the unbiased
    one)."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.stats_frozen = False  # see frozen_batch_stats
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        if not self.training:
            a = torch.rsqrt(self.running_var + self.eps) * self.weight
            b = self.bias - self.running_mean * a
            return (x.float() * a + b).to(x.dtype)
        red = tuple(range(x.ndim - 1))
        xf = x.float()
        mean = xf.mean(red)
        var = ((xf * xf).mean(red) - mean * mean).clamp_min(0.0)
        if not self.stats_frozen:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1.0 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1.0 - m) * var)
        y = (xf - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class Norm(nn.Module):
    """GroupNorm (gn=True) or BatchNorm (JAX layers.py:72)."""

    def __init__(self, channels: int, gn: bool = True, groups: int = 32):
        super().__init__()
        if gn:
            self.GroupNorm_0 = FastGroupNorm(
                channels, _norm_groups(groups, channels))
        else:
            self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        if hasattr(self, "GroupNorm_0"):
            return self.GroupNorm_0(x)
        return self.BatchNorm_0(x)


class ConvNorm(nn.Module):
    """2D conv + norm with torch-symmetric padding (JAX layers.py:96)."""

    def __init__(self, cin: int, features: int, kernel=3, stride=1,
                 dilation: int = 1, gn: bool = True, groups: int = 32):
        super().__init__()
        k = _pair(kernel)
        pad = tuple((kk - 1) // 2 * dilation for kk in k)
        self.Conv_0 = nn.Conv2d(cin, features, k, _pair(stride), pad,
                                dilation, bias=False)
        self.Norm_0 = Norm(features, gn, groups)

    def forward(self, x):
        return self.Norm_0(conv2d_nhwc(x, self.Conv_0))


class Conv3d(nn.Module):
    """3D convolution on NDHWC (JAX layers.py:131).

    Semantics of the JAX per-tap formulation: torch-symmetric padding
    ``(k-1)//2*dilation`` on every axis, float32 accumulation across taps.
    bf16 stride-1 convs with odd kernels and kd >= 5 (the head's conv1_k7,
    conv2_k5 and conv3_k5_d2) go to ``conv3d_large_tap`` — the hand CUDA
    kernel K2 on a CUDA tensor, its plain per-tap version on the CPU.
    With ``pallas="auto"`` (JAX layers.py:182; default "never"), bf16
    k3x3x3 stride-1 convs go to ``conv3d_k3`` (K5).  Every other conv,
    float32 ones included, is one ``F.conv3d`` with the same padding.
    The weight has torch's layout [O, I, kd, kh, kw]."""

    def __init__(self, cin: int, features: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), dilation: int = 1, use_bias: bool = False,
                 pallas: str = "never"):
        super().__init__()
        if pallas not in ("never", "auto"):
            raise ValueError(f"pallas must be 'never' or 'auto', got {pallas!r}")
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        self.dilation = dilation
        self.pallas = pallas
        self.weight = nn.Parameter(torch.empty(features, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        dt = x.dtype
        w = self.weight.to(dt)
        if self.pallas == "auto" and k3_eligible(self.kernel, self.stride,
                                                 self.dilation, dt):
            out = conv3d_k3(x.contiguous(),
                            w.permute(2, 3, 4, 1, 0).contiguous())
        elif large_tap_eligible(self.kernel, self.stride, dt):
            out = conv3d_large_tap(
                x.contiguous(), w.permute(2, 3, 4, 1, 0).contiguous(),
                self.dilation)
        else:
            pad = tuple((k - 1) // 2 * self.dilation for k in self.kernel)
            out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, self.stride,
                           pad, self.dilation).permute(0, 2, 3, 4, 1)
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out


class ConvNorm3d(nn.Module):
    """3D conv + norm, NDHWC (JAX layers.py:461)."""

    def __init__(self, cin: int, features: int, kernel=3, stride=1,
                 dilation: int = 1, gn: bool = True, groups: int = 32):
        super().__init__()
        self.Conv3d_0 = Conv3d(cin, features, kernel, stride, dilation)
        self.Norm_0 = Norm(features, gn, groups)

    def forward(self, x):
        return self.Norm_0(self.Conv3d_0(x))


class ConvTranspose3dFast(nn.Module):
    """k3 stride-2 2x upsampling 3D transposed conv (JAX layers.py:482).

    The JAX module stores the spatially flipped torch kernel and runs it
    as 8 parity sub-convs; the port stores torch's own ConvTranspose3d
    weight [I, O, 3, 3, 3] (the converter flips it) and calls
    ``F.conv_transpose3d(stride=2, padding=1, output_padding=1)``, which is
    the same alignment."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, features, 3, 3, 3))

    def forward(self, x):
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3),
                               self.weight.to(x.dtype), None, 2, 1, 1)
        return y.permute(0, 2, 3, 4, 1)


class ConvTranspose2d(nn.Module):
    """k3 stride-2 2x upsampling 2D transposed conv: flax ``nn.ConvTranspose``
    with padding (1, 2) on the flipped kernel == torch (p1, op1)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, features, 3, 3))

    def forward(self, x):
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2),
                               self.weight.to(x.dtype), None, 2, 1, 1)
        return y.permute(0, 2, 3, 1)


class DeconvNorm(nn.Module):
    """2x transposed-conv upsample + norm, 2D or 3D (JAX layers.py:550)."""

    def __init__(self, cin: int, features: int, ndim: int = 3, gn: bool = True,
                 groups: int = 32):
        super().__init__()
        cls = ConvTranspose3dFast if ndim == 3 else ConvTranspose2d
        self.ConvTranspose_0 = cls(cin, features)
        self.Norm_0 = Norm(features, gn, groups)

    def forward(self, x):
        return self.Norm_0(self.ConvTranspose_0(x))


class ResBlock2d(nn.Module):
    """Two 3x3 convs with a residual, no final relu (JAX layers.py:589)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, gn: bool = True):
        super().__init__()
        self.ConvNorm_0 = ConvNorm(cin, features, 3, stride, dilation, gn)
        self.ConvNorm_1 = ConvNorm(features, features, 3, 1, dilation, gn)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self.Conv_0 = nn.Conv2d(cin, features, 1, stride, bias=False)
            self.Norm_0 = Norm(features, gn)

    def forward(self, x):
        out = self.ConvNorm_1(F.relu(self.ConvNorm_0(x)))
        if self.shortcut:
            x = self.Norm_0(conv2d_nhwc(x, self.Conv_0))
        return out + x


def _conv_norm_cls(ndim: int):
    return (ConvNorm3d, "ConvNorm3d") if ndim == 3 else (ConvNorm, "ConvNorm")


def _crop_to(t, shape: Sequence[int]):
    """Crop the spatial axes of a channels-last tensor to ``shape``."""
    sl = (slice(None),) + tuple(slice(0, s) for s in shape) + (slice(None),)
    return t[sl]


class Hourglass(nn.Module):
    """Two-level U-Net, 3D or 2D, with pre/post skip state
    (JAX layers.py:611).  forward(x, presqu, postsqu) -> (out, pre, post)."""

    def __init__(self, features: int, ndim: int = 3, gn: bool = True):
        super().__init__()
        f2 = features * 2
        cls, cname = _conv_norm_cls(ndim)
        ins = (features, f2, f2, f2)
        strides = (2, 1, 2, 1)
        for i in range(4):
            self.add_module(f"{cname}_{i}",
                            cls(ins[i], f2, 3, strides[i], gn=gn))
        self.DeconvNorm_0 = DeconvNorm(f2, f2, ndim, gn)
        self.DeconvNorm_1 = DeconvNorm(f2, features, ndim, gn)
        self._convs = [getattr(self, f"{cname}_{i}") for i in range(4)]

    def forward(self, x, presqu=None, postsqu=None):
        c = self._convs
        out = F.relu(c[0](x))
        pre = c[1](out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = F.relu(c[2](pre))
        out = F.relu(c[3](out))
        up = self.DeconvNorm_0(out)
        post = F.relu(up + (presqu if presqu is not None else pre))
        out = self.DeconvNorm_1(post)
        return out, pre, post


class HourglassDeep(nn.Module):
    """Four-level (1/16) encoder-decoder with skip adds (JAX layers.py:641).
    Upsamples are cropped to the skip extent, as in JAX."""

    def __init__(self, features: int, ndim: int = 3, gn: bool = True):
        super().__init__()
        f2 = features * 2
        cls, cname = _conv_norm_cls(ndim)
        for i in range(8):
            cin = features if i == 0 else f2
            self.add_module(f"{cname}_{i}",
                            cls(cin, f2, 3, 2 if i % 2 == 0 else 1, gn=gn))
        for i in range(3):
            self.add_module(f"DeconvNorm_{i}", DeconvNorm(f2, f2, ndim, gn))
        self.DeconvNorm_3 = DeconvNorm(f2, features, ndim, gn)
        self._convs = [getattr(self, f"{cname}_{i}") for i in range(8)]
        self._ups = [getattr(self, f"DeconvNorm_{i}") for i in range(4)]

    def forward(self, x):
        c = self._convs
        d1 = F.relu(c[1](F.relu(c[0](x))))
        d2 = F.relu(c[3](F.relu(c[2](d1))))
        d3 = F.relu(c[5](F.relu(c[4](d2))))
        d4 = F.relu(c[7](F.relu(c[6](d3))))
        u1 = _crop_to(self._ups[0](d4), d3.shape[1:-1]) + d3
        u2 = _crop_to(self._ups[1](u1), d2.shape[1:-1]) + d2
        u3 = _crop_to(self._ups[2](u2), d1.shape[1:-1]) + d1
        return _crop_to(self._ups[3](u3), x.shape[1:-1])


def avg_pool_height(x, factor: int):
    """Average-pool the depth (h) axis of an NDHWC volume (JAX layers.py:677)."""
    N, D, H, W, C = x.shape
    return x.reshape(N, D // factor, factor, H, W, C).mean(dim=2)


def pixel_shuffle_2d(x, factor: int):
    """Depth-to-space on NHWC (JAX layers.py:684)."""
    N, H, W, C = x.shape
    r = factor
    x = x.reshape(N, H, W, C // (r * r), r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)
    return x.reshape(N, H * r, W * r, C // (r * r))
