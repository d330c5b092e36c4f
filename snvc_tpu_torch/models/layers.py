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

Tensor parallelism (parallel/tensor.py): a layer built with
``split_axis`` (the axis of its channels-last input that a mesh's
"model" axis splits: the stereo volume's depth, the Vernier voxel's
length) computes on this rank's slab while ``tensor_parallel`` holds a
mesh, and as before otherwise.  A conv widens its slab by the halo its
outputs read (``conv_halo``) and runs unchanged on it: VALID along the
split axis (``F.conv*``), or SAME with the halo's outputs cropped (K2,
K5).  A deconv (k3, s2, p1, op1) reads one plane from above.  GroupNorm
sums its moments and counts over the model group, BatchNorm over the
whole mesh, so slabs of unequal lengths (parallel/tensor.py) normalize
as the whole volume does.  A short last slab that a stride does not
divide reads zeros past the volume's end (``_widen``); a slab of no
plane exchanges its halos and takes part in every reduction as the
others do, and its convs make 0-plane outputs without running
(``_empty_output``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.ops.conv3d_fold import conv3d_large_tap, large_tap_eligible
from snvc_tpu_torch.ops.conv3d_k3 import conv3d_k3, k3_eligible
from snvc_tpu_torch.parallel.api import global_sum, world_sum
from snvc_tpu_torch.parallel.local import collective_log
from snvc_tpu_torch.parallel.tensor import halo_exchange, model_sum


def _norm_groups(requested: int, channels: int) -> int:
    g = min(requested, channels)
    while channels % g:
        g -= 1
    return g


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def _pair(v) -> Tuple[int, int]:
    return (v,) * 2 if isinstance(v, int) else tuple(v)


def conv2d_nhwc(x, conv: nn.Conv2d, mesh=None, axis: Optional[int] = None):
    """Apply an ``nn.Conv2d`` (weights [O, I, kh, kw]) to an NHWC tensor.
    With ``mesh`` (a model axis) ``x`` is a slab of ``axis`` (1 or 2),
    widened by the halo the conv's outputs read and convolved VALID along
    it."""
    w = conv.weight.to(x.dtype)
    b = None if conv.bias is None else conv.bias.to(x.dtype)
    pad = conv.padding
    empty = x.numel() == 0
    if mesh is not None:
        i = axis - 1
        x, _, _ = _widen(x, axis, conv.kernel_size[i], conv.stride[i],
                         conv.dilation[i], mesh)
        pad = list(pad)
        pad[i] = 0
    if empty:
        return _empty_output(x, conv.kernel_size, conv.stride,
                             conv.dilation, pad, conv.out_channels)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, conv.stride, pad,
                 conv.dilation)
    return y.permute(0, 2, 3, 1)


def _widen(x, axis: int, kernel: int, stride: int, dilation: int, mesh):
    """(``x``'s slab widened by the halo a conv's outputs read, lo, hi).
    On a short last slab of a length that ``stride`` does not divide, the
    last output reads planes past the volume's end: zeros are appended
    for them, so the slab gives ``ceil(L / stride)`` outputs, its share of
    the whole extent's."""
    L = x.shape[axis]
    lo, hi = conv_halo(kernel, stride, dilation)
    x = halo_exchange(x, axis, lo, hi, mesh)
    extra = ((-(-L // stride) - 1) * stride + (kernel - 1) * dilation + 1
             - (lo + L + hi))
    if L and extra > 0:
        shape = list(x.shape)
        shape[axis] = extra
        x = torch.cat([x, x.new_zeros(shape)], dim=axis)
    return x, lo, hi


def _empty_output(x, kernel, stride, dilation, pad, features: int):
    """The output of a conv on a slab of no plane (``x``, widened by its
    halo along a split axis), channels-last, with 0 planes: no conv runs
    and no kernel launches, but the output still depends on ``x``, so the
    halo exchange's backward runs on this position as on the others."""
    dilation = (dilation,) * len(kernel) if isinstance(dilation, int) \
        else dilation
    shape = [x.shape[0]] + [
        max(0, (n + 2 * p - d * (k - 1) - 1) // s + 1) for n, k, s, d, p in
        zip(x.shape[1:-1], kernel, stride, dilation, pad)]
    return x.new_zeros(shape + [features]) + x.flatten()[:0].sum()


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


def conv_halo(kernel: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(lo, hi): the planes below and above a slab that its outputs read,
    for a conv with torch-symmetric padding ``(k-1)//2*dilation`` along
    the split axis.  The slab must start at a multiple of ``stride``
    (``parallel.tensor.slab_bounds``)."""
    pad = (kernel - 1) // 2 * dilation
    return pad, max(0, (kernel - 1) * dilation - pad - stride + 1)


@contextlib.contextmanager
def tensor_parallel(module: nn.Module, mesh):
    """While this is open, the modules inside ``module`` built with a
    ``split_axis`` compute on this rank's slab of it, over ``mesh``'s
    model group (parallel/tensor.py).  Without a mesh, or with one model
    rank, nothing changes.  Under a process group keep it open through
    the backward: a rematerialized block recomputes its exchanges.
    Under a one-process mesh each position opens it on its own replica
    of the module (parallel/local.py), with its position's mesh, and a
    rematerialized block reopens it for its recompute
    (``remat_contexts``)."""
    if mesh is None or mesh.n_model == 1:
        yield
        return
    mods = [m for m in module.modules()
            if getattr(m, "split_axis", None) is not None]
    for m in mods:
        m.tp_mesh = mesh
    try:
        yield
    finally:
        for m in mods:
            m.tp_mesh = None


class FastGroupNorm(nn.Module):
    """GroupNorm from per-(sample, group) float32 moments and one fused
    ``x * a + b`` pass (JAX layers.py:33).  eps = 1e-5 (torch default).
    On a slab (``split_axis``) the moments are summed over the model
    group.  ``moment_dtype``: float32, as JAX's (a float64 parity test
    raises it, so that the moments of a split sum round as those of the
    whole)."""

    moment_dtype = torch.float32

    def __init__(self, channels: int, groups: int, eps: float = 1e-5,
                 split_axis: Optional[int] = None):
        super().__init__()
        self.groups = groups
        self.eps = eps
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        N, C = x.shape[0], x.shape[-1]
        G = self.groups
        red = tuple(range(1, x.ndim - 1))
        n_red = math.prod(x.shape[1:-1]) * (C // G)
        xf = x.to(self.moment_dtype)
        s1 = xf.sum(red).reshape(N, G, C // G).sum(-1)
        s2 = (xf * xf).sum(red).reshape(N, G, C // G).sum(-1)
        if self.tp_mesh is not None:  # slabs may differ in length
            s1, s2, n_red = model_sum(torch.stack(
                [s1, s2, torch.full_like(s1, n_red)]), self.tp_mesh).unbind()
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
    was = [m.stats_frozen for m in norms]
    for m in norms:
        m.stats_frozen = True
    try:
        yield
    finally:
        for m, w in zip(norms, was):
            m.stats_frozen = w


class _EachEntry:
    """A context that opens ``make()``'s contexts anew at each entry
    (``torch.utils.checkpoint`` enters its recompute context at every
    recompute)."""

    def __init__(self, make):
        self.make = make
        self._stacks: list = []

    def __enter__(self):
        stack = contextlib.ExitStack()
        try:
            for c in self.make():
                stack.enter_context(c)
        except BaseException:
            stack.close()
            raise
        self._stacks.append(stack)
        return self

    def __exit__(self, *exc):
        return self._stacks.pop().__exit__(*exc)


def remat_contexts(module: nn.Module, mesh):
    """``torch.utils.checkpoint``'s ``context_fn`` for a rematerialized
    ``module`` run on ``mesh``'s position (None: no mesh): the forward's
    and the recompute's contexts.  The recompute keeps BatchNorm's
    running statistics (``frozen_batch_stats``).  On a position of a
    one-process mesh (parallel/local.py) it also replays what the
    forward's collectives received (``local.collective_log``), with
    ``module`` split on the position's mesh again: it runs after the
    positions' threads have closed their ``data_parallel`` /
    ``tensor_parallel``.  A process group's recompute meets the other
    ranks' recomputes and runs inside the step's contexts."""
    if mesh is None or mesh.local is None:
        return contextlib.nullcontext(), _EachEntry(
            lambda: [frozen_batch_stats(module)])
    record, replay = collective_log()
    return record, _EachEntry(lambda: [
        replay, frozen_batch_stats(module), data_parallel(module, mesh),
        tensor_parallel(module, mesh)])


@contextlib.contextmanager
def data_parallel(module: nn.Module, mesh):
    """While this is open, the modules inside ``module`` that reduce over
    the batch (those with a ``mesh`` attribute: BatchNorm's moments, the
    FC model's dropout draw) do so over ``mesh``'s data axis
    (parallel/api.py).  Without a mesh nothing changes."""
    if mesh is None:
        yield
        return
    mods = [m for m in module.modules() if "mesh" in vars(m)]
    for m in mods:
        m.mesh = mesh
    try:
        yield
    finally:
        for m in mods:
            m.mesh = None


class BatchNorm(nn.Module):
    """BatchNorm over the last (channel) axis with flax semantics
    (``nn.BatchNorm(momentum=0.9)``, JAX hrnet.py:44).

    Eval mode reads the running statistics.  Train mode normalizes with
    the batch's mean and biased variance E[x^2] - E[x]^2, both in float32
    or wider as flax promotes them (float64 stays float64) (clamped
    at 0) and moves the running statistics by ``r = 0.9 r + 0.1 batch``,
    the variance biased too (``F.batch_norm`` would store the unbiased
    one).  Under a data-parallel mesh of more than one rank
    (``data_parallel``) the batch is the global one: the per-channel sums,
    sums of squares and count are summed over the ranks, with the
    gradient through the reduction, as JAX's statistics of a sharded
    batch are.  On a slab (``split_axis``, ``tensor_parallel``) they are
    summed over every position of the mesh: the data and the model
    groups."""

    def __init__(self, channels: int, eps: float = 1e-5,
                 momentum: float = 0.9, split_axis: Optional[int] = None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.stats_frozen = False  # see frozen_batch_stats
        self.mesh = None  # see data_parallel
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):
        wide = torch.promote_types(x.dtype, torch.float32)
        if not self.training:
            a = torch.rsqrt(self.running_var + self.eps) * self.weight
            b = self.bias - self.running_mean * a
            return (x.to(wide) * a + b).to(x.dtype)
        red = tuple(range(x.ndim - 1))
        xf = x.to(wide)
        if self.tp_mesh is None and (self.mesh is None
                                     or self.mesh.n_data == 1):
            mean = xf.mean(red)
            var = ((xf * xf).mean(red) - mean * mean).clamp_min(0.0)
        else:
            C = x.shape[-1]
            sums = torch.cat([xf.sum(red), (xf * xf).sum(red),
                              xf.new_full((1,), x.numel() // C)])
            sums = (global_sum(sums, self.mesh) if self.tp_mesh is None
                    else world_sum(sums, self.tp_mesh))
            mean = sums[:C] / sums[2 * C]
            var = (sums[C:2 * C] / sums[2 * C] - mean * mean).clamp_min(0.0)
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

    def __init__(self, channels: int, gn: bool = True, groups: int = 32,
                 split_axis: Optional[int] = None):
        super().__init__()
        if gn:
            self.GroupNorm_0 = FastGroupNorm(
                channels, _norm_groups(groups, channels),
                split_axis=split_axis)
        else:
            self.BatchNorm_0 = BatchNorm(channels, split_axis=split_axis)

    def forward(self, x):
        if hasattr(self, "GroupNorm_0"):
            return self.GroupNorm_0(x)
        return self.BatchNorm_0(x)


class ConvNorm(nn.Module):
    """2D conv + norm with torch-symmetric padding (JAX layers.py:96)."""

    def __init__(self, cin: int, features: int, kernel=3, stride=1,
                 dilation: int = 1, gn: bool = True, groups: int = 32,
                 split_axis: Optional[int] = None):
        super().__init__()
        k = _pair(kernel)
        pad = tuple((kk - 1) // 2 * dilation for kk in k)
        self.Conv_0 = nn.Conv2d(cin, features, k, _pair(stride), pad,
                                dilation, bias=False)
        self.Norm_0 = Norm(features, gn, groups, split_axis)
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel

    def forward(self, x):
        return self.Norm_0(conv2d_nhwc(x, self.Conv_0, self.tp_mesh,
                                       self.split_axis))


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
    The weight has torch's layout [O, I, kd, kh, kw].  On a slab
    (``split_axis``) the input is widened by its halo: K2 and K5 (SAME)
    run on the widened slab and the halo's outputs are cropped;
    ``F.conv3d`` pads the split axis with the halo alone."""

    def __init__(self, cin: int, features: int, kernel=(3, 3, 3),
                 stride=(1, 1, 1), dilation: int = 1, use_bias: bool = False,
                 pallas: str = "never", split_axis: Optional[int] = None):
        super().__init__()
        if pallas not in ("never", "auto"):
            raise ValueError(f"pallas must be 'never' or 'auto', got {pallas!r}")
        self.kernel = _triple(kernel)
        self.stride = _triple(stride)
        self.dilation = dilation
        self.pallas = pallas
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel
        self.weight = nn.Parameter(torch.empty(features, cin, *self.kernel))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x):
        dt = x.dtype
        w = self.weight.to(dt)
        pad = [(k - 1) // 2 * self.dilation for k in self.kernel]
        lo = hi = 0
        empty = x.numel() == 0
        if self.tp_mesh is not None:
            i = self.split_axis - 1
            x, lo, hi = _widen(x, self.split_axis, self.kernel[i],
                               self.stride[i], self.dilation, self.tp_mesh)
            pad[i] = 0
        if empty:
            return _empty_output(x, self.kernel, self.stride, self.dilation,
                                 pad, w.shape[0])
        if self.pallas == "auto" and k3_eligible(self.kernel, self.stride,
                                                 self.dilation, dt):
            out = conv3d_k3(x.contiguous(),
                            w.permute(2, 3, 4, 1, 0).contiguous())
        elif large_tap_eligible(self.kernel, self.stride, dt,
                                self.dilation):
            out = conv3d_large_tap(
                x.contiguous(), w.permute(2, 3, 4, 1, 0).contiguous(),
                self.dilation)
        else:  # VALID along the split axis: the halo was its padding
            out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, self.stride,
                           tuple(pad), self.dilation).permute(0, 2, 3, 4, 1)
            lo = hi = 0
        if lo or hi:  # SAME on the widened slab: crop the halo's outputs
            ax = self.split_axis
            out = out.narrow(ax, lo, out.shape[ax] - lo - hi)
        if self.bias is not None:
            out = out + self.bias.to(dt)
        return out


class ConvNorm3d(nn.Module):
    """3D conv + norm, NDHWC (JAX layers.py:461)."""

    def __init__(self, cin: int, features: int, kernel=3, stride=1,
                 dilation: int = 1, gn: bool = True, groups: int = 32,
                 split_axis: Optional[int] = None):
        super().__init__()
        self.Conv3d_0 = Conv3d(cin, features, kernel, stride, dilation,
                               split_axis=split_axis)
        self.Norm_0 = Norm(features, gn, groups, split_axis)

    def forward(self, x):
        return self.Norm_0(self.Conv3d_0(x))


class ConvTranspose3dFast(nn.Module):
    """k3 stride-2 2x upsampling 3D transposed conv (JAX layers.py:482).

    The JAX module stores the spatially flipped torch kernel and runs it
    as 8 parity sub-convs; the port stores torch's own ConvTranspose3d
    weight [I, O, 3, 3, 3] (the converter flips it) and calls
    ``F.conv_transpose3d(stride=2, padding=1, output_padding=1)``, which is
    the same alignment."""

    def __init__(self, cin: int, features: int,
                 split_axis: Optional[int] = None):
        super().__init__()
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel
        self.weight = nn.Parameter(torch.empty(cin, features, 3, 3, 3))

    def forward(self, x):
        return _upsample(self, x, F.conv_transpose3d)


class ConvTranspose2d(nn.Module):
    """k3 stride-2 2x upsampling 2D transposed conv: flax ``nn.ConvTranspose``
    with padding (1, 2) on the flipped kernel == torch (p1, op1)."""

    def __init__(self, cin: int, features: int,
                 split_axis: Optional[int] = None):
        super().__init__()
        self.split_axis = split_axis
        self.tp_mesh = None  # see tensor_parallel
        self.weight = nn.Parameter(torch.empty(cin, features, 3, 3))

    def forward(self, x):
        return _upsample(self, x, F.conv_transpose2d)


def _upsample(deconv, x, fn):
    """``fn`` (k3, s2, p1, op1) on channels-last ``x``.  Output ``o`` reads
    inputs (o + 1 - k) / 2, so a slab's outputs [2a, 2b) read one plane
    above it: widened by it, the deconv's first 2 x slab outputs are the
    slab's."""
    mesh, ax = deconv.tp_mesh, deconv.split_axis
    if mesh is not None:
        L = x.shape[ax]
        x = halo_exchange(x, ax, 0, 1, mesh)
    y = fn(x.movedim(-1, 1), deconv.weight.to(x.dtype), None, 2, 1, 1
           ).movedim(1, -1)
    return y if mesh is None else y.narrow(ax, 0, 2 * L)


class DeconvNorm(nn.Module):
    """2x transposed-conv upsample + norm, 2D or 3D (JAX layers.py:550)."""

    def __init__(self, cin: int, features: int, ndim: int = 3, gn: bool = True,
                 groups: int = 32, split_axis: Optional[int] = None):
        super().__init__()
        cls = ConvTranspose3dFast if ndim == 3 else ConvTranspose2d
        self.ConvTranspose_0 = cls(cin, features, split_axis)
        self.Norm_0 = Norm(features, gn, groups, split_axis)

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
    """Crop the spatial axes of a channels-last tensor to ``shape``.  On a
    split axis every slab but the last that holds planes is a whole
    number of units of 2^levels planes (parallel/tensor.py), even at every
    level: only that last slab, short, crops along it, at each level to
    its ``ceil(r / 2^l)`` planes, and the whole volume's crop is the
    same."""
    sl = (slice(None),) + tuple(slice(0, s) for s in shape) + (slice(None),)
    return t[sl]


class Hourglass(nn.Module):
    """Two-level U-Net, 3D or 2D, with pre/post skip state
    (JAX layers.py:611).  forward(x, presqu, postsqu) -> (out, pre, post).
    ``split_axis``: see the module docstring."""

    levels = 2  # stride-2 steps

    def __init__(self, features: int, ndim: int = 3, gn: bool = True,
                 split_axis: Optional[int] = None):
        super().__init__()
        f2 = features * 2
        cls, cname = _conv_norm_cls(ndim)
        ins = (features, f2, f2, f2)
        strides = (2, 1, 2, 1)
        for i in range(4):
            self.add_module(f"{cname}_{i}",
                            cls(ins[i], f2, 3, strides[i], gn=gn,
                                split_axis=split_axis))
        self.DeconvNorm_0 = DeconvNorm(f2, f2, ndim, gn,
                                       split_axis=split_axis)
        self.DeconvNorm_1 = DeconvNorm(f2, features, ndim, gn,
                                       split_axis=split_axis)
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
    Upsamples are cropped to the skip extent, as in JAX.  ``split_axis``:
    see the module docstring."""

    levels = 4  # stride-2 steps

    def __init__(self, features: int, ndim: int = 3, gn: bool = True,
                 split_axis: Optional[int] = None):
        super().__init__()
        f2 = features * 2
        cls, cname = _conv_norm_cls(ndim)
        for i in range(8):
            cin = features if i == 0 else f2
            self.add_module(f"{cname}_{i}",
                            cls(cin, f2, 3, 2 if i % 2 == 0 else 1, gn=gn,
                                split_axis=split_axis))
        for i in range(3):
            self.add_module(f"DeconvNorm_{i}",
                            DeconvNorm(f2, f2, ndim, gn,
                                       split_axis=split_axis))
        self.DeconvNorm_3 = DeconvNorm(f2, features, ndim, gn,
                                       split_axis=split_axis)
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
