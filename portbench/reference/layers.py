"""Plain float32 building blocks of the reference models.

A frozen copy of the serving forward of ``snvc_tpu_torch/models/layers.py``
and ``models/hrnet.py`` (eval mode, one device, no tensor parallelism),
written with library calls only: ``F.conv2d`` / ``F.conv3d`` /
``F.conv_transpose*d`` for every convolution, GroupNorm from two-pass
moments.  Tensors are channels-last (NHWC / NDHWC) as in the program, so
every reshape between 3D volumes and BEV maps orders its axes as the
program's does.  Child modules carry the program's names, so one
``state_dict`` loads into both.

Every convolution passes its input and weight through ``self.quant``
(``set_precision``): the identity in float32, or a rounding to float8
e4m3 with a per-tensor scale for the lower-precision control of the
correctness check, or to bfloat16 for a witness of the program's own
precision (``bf16``; ``bf16_act`` also rounds every module's outputs,
where a bfloat16 program stores its activations).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

FP8_MAX = 448.0  # largest finite float8 e4m3 value


def identity(t):
    return t


def fp8_round(t):
    """``t`` rounded to float8 e4m3 after scaling its largest magnitude to
    the format's largest value, and scaled back (float32 out)."""
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = FP8_MAX / amax
    return (t.float() * scale).to(torch.float8_e4m3fn).float() / scale


def bf16_round(t):
    """``t`` rounded to bfloat16 (float32 out)."""
    return t.to(torch.bfloat16).float()


PRECISIONS = {"float32": identity, "fp8": fp8_round, "bf16": bf16_round,
              "bf16_act": bf16_round}


def _round_outputs(module, args, out):
    if isinstance(out, torch.Tensor):
        return bf16_round(out) if out.is_floating_point() else out
    if isinstance(out, (list, tuple)):
        return type(out)(_round_outputs(module, args, o) for o in out)
    if isinstance(out, dict):
        return {k: _round_outputs(module, args, v) for k, v in out.items()}
    return out


def set_precision(model: nn.Module, name: str) -> None:
    """Route every convolution of ``model`` through the named rounding;
    under ``bf16_act`` round every submodule's outputs to bfloat16 too."""
    fn = PRECISIONS[name]
    for m in model.modules():
        if isinstance(m, _Conv):
            m.quant = fn
        if name == "bf16_act" and m is not model:
            m.register_forward_hook(_round_outputs)


@contextlib.contextmanager
def strict_float32():
    """TF32 off for matmuls and cuDNN while the reference runs."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def norm_groups(requested: int, channels: int) -> int:
    g = min(requested, channels)
    while channels % g:
        g -= 1
    return g


def _tuple(v, n):
    return (v,) * n if isinstance(v, int) else tuple(v)


class _Conv(nn.Module):
    """A convolution's parameters in torch's layout, applied to a
    channels-last tensor."""

    quant = staticmethod(identity)

    def __init__(self, shape, bias: bool):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(shape[0])) if bias else None

    def _wb(self):
        b = None if self.bias is None else self.bias.float()
        return self.quant(self.weight.float()), b


class Conv2d(_Conv):
    """NHWC 2D conv; weight [O, I, kh, kw]."""

    def __init__(self, cin, cout, k, stride=1, pad=0, dilation=1,
                 bias=False):
        k = _tuple(k, 2)
        super().__init__((cout, cin) + k, bias)
        self.stride, self.pad, self.dilation = stride, _tuple(pad, 2), dilation

    def forward(self, x):
        w, b = self._wb()
        y = F.conv2d(self.quant(x.float()).permute(0, 3, 1, 2), w, b,
                     self.stride, self.pad, self.dilation)
        return y.permute(0, 2, 3, 1)


class Conv3d(_Conv):
    """NDHWC 3D conv, padding (k-1)//2*dilation; weight [O, I, kd, kh, kw]."""

    def __init__(self, cin, cout, k=3, stride=1, dilation=1, bias=False):
        k = _tuple(k, 3)
        super().__init__((cout, cin) + k, bias)
        self.stride, self.dilation = _tuple(stride, 3), dilation
        self.pad = tuple((kk - 1) // 2 * dilation for kk in k)

    def forward(self, x):
        w, b = self._wb()
        y = F.conv3d(self.quant(x.float()).permute(0, 4, 1, 2, 3), w, b,
                     self.stride, self.pad, self.dilation)
        return y.permute(0, 2, 3, 4, 1)


class Deconv(_Conv):
    """k3 stride-2 2x upsample (padding 1, output padding 1); weight
    [I, O, 3, 3(, 3)]."""

    def __init__(self, cin, cout, ndim):
        super().__init__((cin, cout) + (3,) * ndim, False)
        self.fn = F.conv_transpose3d if ndim == 3 else F.conv_transpose2d

    def forward(self, x):
        w, _ = self._wb()
        return self.fn(self.quant(x.float()).movedim(-1, 1), w, None, 2, 1,
                       1).movedim(1, -1)


class GroupNorm(nn.Module):
    """GroupNorm over contiguous channel groups of a channels-last tensor,
    two-pass moments, eps 1e-5."""

    def __init__(self, channels, groups):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))

    def forward(self, x):
        N, C, G = x.shape[0], x.shape[-1], self.groups
        xg = x.float().reshape(N, -1, G, C // G)
        mean = xg.mean(dim=(1, 3), keepdim=True)
        var = ((xg - mean) ** 2).mean(dim=(1, 3), keepdim=True)
        y = ((xg - mean) / torch.sqrt(var + 1e-5)).reshape(x.shape)
        return y * self.weight + self.bias


class BatchNorm(nn.Module):
    """Eval-mode BatchNorm over the last axis (running statistics)."""

    def __init__(self, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels))
        self.bias = nn.Parameter(torch.empty(channels))
        self.register_buffer("running_mean", torch.empty(channels))
        self.register_buffer("running_var", torch.empty(channels))

    def forward(self, x):
        return ((x.float() - self.running_mean)
                / torch.sqrt(self.running_var + 1e-5) * self.weight
                + self.bias)


class Norm(nn.Module):
    def __init__(self, channels, gn=True, groups=32):
        super().__init__()
        if gn:
            self.GroupNorm_0 = GroupNorm(channels,
                                         norm_groups(groups, channels))
        else:
            self.BatchNorm_0 = BatchNorm(channels)

    def forward(self, x):
        if hasattr(self, "GroupNorm_0"):
            return self.GroupNorm_0(x)
        return self.BatchNorm_0(x)


class ConvNorm(nn.Module):
    def __init__(self, cin, f, k=3, stride=1, dilation=1, gn=True,
                 groups=32):
        super().__init__()
        k = _tuple(k, 2)
        pad = tuple((kk - 1) // 2 * dilation for kk in k)
        self.Conv_0 = Conv2d(cin, f, k, stride, pad, dilation)
        self.Norm_0 = Norm(f, gn, groups)

    def forward(self, x):
        return self.Norm_0(self.Conv_0(x))


class ConvNorm3d(nn.Module):
    def __init__(self, cin, f, k=3, stride=1, dilation=1, gn=True,
                 groups=32):
        super().__init__()
        self.Conv3d_0 = Conv3d(cin, f, k, stride, dilation)
        self.Norm_0 = Norm(f, gn, groups)

    def forward(self, x):
        return self.Norm_0(self.Conv3d_0(x))


class DeconvNorm(nn.Module):
    def __init__(self, cin, f, ndim=3, gn=True, groups=32):
        super().__init__()
        self.ConvTranspose_0 = Deconv(cin, f, ndim)
        self.Norm_0 = Norm(f, gn, groups)

    def forward(self, x):
        return self.Norm_0(self.ConvTranspose_0(x))


class ResBlock2d(nn.Module):
    def __init__(self, cin, f, stride=1, dilation=1, gn=True):
        super().__init__()
        self.ConvNorm_0 = ConvNorm(cin, f, 3, stride, dilation, gn)
        self.ConvNorm_1 = ConvNorm(f, f, 3, 1, dilation, gn)
        self.shortcut = stride != 1 or cin != f
        if self.shortcut:
            self.Conv_0 = Conv2d(cin, f, 1, stride)
            self.Norm_0 = Norm(f, gn)

    def forward(self, x):
        out = self.ConvNorm_1(F.relu(self.ConvNorm_0(x)))
        if self.shortcut:
            x = self.Norm_0(self.Conv_0(x))
        return out + x


def _cn(ndim):
    return (ConvNorm3d, "ConvNorm3d") if ndim == 3 else (ConvNorm, "ConvNorm")


class Hourglass(nn.Module):
    """Two-level U-Net; forward(x, presqu, postsqu) -> (out, pre, post)."""

    def __init__(self, features, ndim=3, gn=True):
        super().__init__()
        f2 = features * 2
        cls, cname = _cn(ndim)
        for i, (cin, s) in enumerate(((features, 2), (f2, 1), (f2, 2),
                                      (f2, 1))):
            self.add_module(f"{cname}_{i}", cls(cin, f2, 3, s, gn=gn))
        self.DeconvNorm_0 = DeconvNorm(f2, f2, ndim, gn)
        self.DeconvNorm_1 = DeconvNorm(f2, features, ndim, gn)
        self.cname = cname

    def forward(self, x, presqu=None, postsqu=None):
        c = [getattr(self, f"{self.cname}_{i}") for i in range(4)]
        out = F.relu(c[0](x))
        pre = c[1](out)
        pre = F.relu(pre + postsqu) if postsqu is not None else F.relu(pre)
        out = F.relu(c[3](F.relu(c[2](pre))))
        post = F.relu(self.DeconvNorm_0(out)
                      + (presqu if presqu is not None else pre))
        return self.DeconvNorm_1(post), pre, post


def _crop(t, shape):
    return t[(slice(None),) + tuple(slice(0, s) for s in shape)]


class HourglassDeep(nn.Module):
    """Four-level encoder-decoder with skip adds, upsamples cropped to the
    skip's extent."""

    def __init__(self, features, ndim=3, gn=True):
        super().__init__()
        f2 = features * 2
        cls, cname = _cn(ndim)
        for i in range(8):
            self.add_module(f"{cname}_{i}",
                            cls(features if i == 0 else f2, f2, 3,
                                2 if i % 2 == 0 else 1, gn=gn))
        for i in range(3):
            self.add_module(f"DeconvNorm_{i}", DeconvNorm(f2, f2, ndim, gn))
        self.DeconvNorm_3 = DeconvNorm(f2, features, ndim, gn)
        self.cname = cname

    def forward(self, x):
        c = [getattr(self, f"{self.cname}_{i}") for i in range(8)]
        u = [getattr(self, f"DeconvNorm_{i}") for i in range(4)]
        d1 = F.relu(c[1](F.relu(c[0](x))))
        d2 = F.relu(c[3](F.relu(c[2](d1))))
        d3 = F.relu(c[5](F.relu(c[4](d2))))
        d4 = F.relu(c[7](F.relu(c[6](d3))))
        u1 = _crop(u[0](d4), d3.shape[1:-1]) + d3
        u2 = _crop(u[1](u1), d2.shape[1:-1]) + d2
        u3 = _crop(u[2](u2), d1.shape[1:-1]) + d1
        return _crop(u[3](u3), x.shape[1:-1])


def avg_pool_height(x, factor):
    N, D, H, W, C = x.shape
    return x.reshape(N, D // factor, factor, H, W, C).mean(dim=2)


# --- HRNet (default head) ----------------------------------------------


class _Named(nn.Module):
    """Children under per-kind counters in creation order (``Conv_0``,
    ``BatchNorm_0``, ...), as the program names them."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def _add(self, kind, mod):
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", mod)
        return mod

    def _conv(self, cin, cout, k, stride=1, bias=False):
        return self._add("Conv", Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                        bias=bias))

    def _bn(self, c):
        return self._add("BatchNorm", BatchNorm(c))


class BasicBlock(_Named):
    expansion = 1

    def __init__(self, cin, f, stride=1):
        super().__init__()
        self._conv(cin, f, 3, stride), self._bn(f)
        self._conv(f, f, 3), self._bn(f)
        self.shortcut = stride != 1 or cin != f
        if self.shortcut:
            self._conv(cin, f, 1, stride), self._bn(f)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = self.BatchNorm_1(self.Conv_1(out))
        if self.shortcut:
            x = self.BatchNorm_2(self.Conv_2(x))
        return F.relu(out + x)


class Bottleneck(_Named):
    expansion = 4

    def __init__(self, cin, f, stride=1):
        super().__init__()
        self._conv(cin, f, 1), self._bn(f)
        self._conv(f, f, 3, stride), self._bn(f)
        self._conv(f, f * 4, 1), self._bn(f * 4)
        self.shortcut = stride != 1 or cin != f * 4
        if self.shortcut:
            self._conv(cin, f * 4, 1, stride), self._bn(f * 4)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        out = F.relu(self.BatchNorm_1(self.Conv_1(out)))
        out = self.BatchNorm_2(self.Conv_2(out))
        if self.shortcut:
            x = self.BatchNorm_3(self.Conv_3(x))
        return F.relu(out + x)


BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class FuseLayer(_Named):
    def __init__(self, i, j, cin, f):
        super().__init__()
        self.up = 2 ** (j - i) if j > i else 0
        self.steps = []
        if j > i:
            self.steps.append((self._conv(cin, f, 1), self._bn(f), False))
            return
        for k in range(i - j):
            last = k == i - j - 1
            ch = f if last else cin
            self.steps.append((self._conv(cin, ch, 3, 2), self._bn(ch),
                               not last))

    def forward(self, x):
        for conv, bn, relu in self.steps:
            x = bn(conv(x))
            if relu:
                x = F.relu(x)
        if self.up:
            x = x.repeat_interleave(self.up, 1).repeat_interleave(self.up, 2)
        return x


class HRModule(_Named):
    def __init__(self, stage, in_channels):
        super().__init__()
        block = BLOCKS[stage["block"]]
        nb = stage["num_branches"]
        self.branches = []
        for i in range(nb):
            cin, mods = in_channels[i], []
            for _ in range(stage["num_blocks"][i]):
                mods.append(self._add(block.__name__,
                                      block(cin, stage["num_channels"][i])))
                cin = stage["num_channels"][i] * block.expansion
            self.branches.append(mods)
        self.out_channels = tuple(c * block.expansion
                                  for c in stage["num_channels"])
        self.fuse = []
        if nb > 1:
            for i in range(nb):
                self.fuse.append([
                    (j, self._add("FuseLayer", FuseLayer(
                        i, j, self.out_channels[j], self.out_channels[i])))
                    for j in range(nb) if j != i])

    def forward(self, xs):
        outs = []
        for mods, h in zip(self.branches, xs):
            for m in mods:
                h = m(h)
            outs.append(h)
        if not self.fuse:
            return outs
        fused = []
        for i, row in enumerate(self.fuse):
            acc = outs[i]
            for j, layer in row:
                acc = acc + layer(outs[j])
            fused.append(F.relu(acc))
        return fused


class Transition(_Named):
    def __init__(self, out_channels, in_channels):
        super().__init__()
        n_pre = len(in_channels)
        self.paths = []
        for i, co in enumerate(out_channels):
            steps = []
            if i < n_pre:
                if co != in_channels[i]:
                    steps.append((self._conv(in_channels[i], co, 3),
                                  self._bn(co)))
                self.paths.append((i, steps))
            else:
                ch = in_channels[-1]
                for j in range(i + 1 - n_pre):
                    c = co if j == i - n_pre else ch
                    steps.append((self._conv(ch, c, 3, 2), self._bn(c)))
                    ch = c
                self.paths.append((n_pre - 1, steps))

    def forward(self, xs):
        outs = []
        for src, steps in self.paths:
            h = xs[src]
            for conv, bn in steps:
                h = F.relu(bn(conv(h)))
            outs.append(h)
        return outs


class HRNet(_Named):
    """The stride-4 feature extractor (the highest-resolution branch)."""

    def __init__(self, stages, in_channels=3):
        super().__init__()
        self.stem = [(self._conv(in_channels, 64, 3, 2), self._bn(64)),
                     (self._conv(64, 64, 3, 2), self._bn(64))]
        s1 = stages[0]
        block = BLOCKS[s1["block"]]
        cin = 64
        self.stage1 = []
        for _ in range(s1["num_blocks"][0]):
            self.stage1.append(self._add(block.__name__,
                                         block(cin, s1["num_channels"][0])))
            cin = s1["num_channels"][0] * block.expansion
        prev = (cin,)
        self.stages = []
        for st in stages[1:]:
            exp = BLOCKS[st["block"]].expansion
            cur = tuple(c * exp for c in st["num_channels"])
            trans = self._add("Transition", Transition(cur, prev))
            mods = []
            for _ in range(st["num_modules"]):
                m = self._add("HRModule", HRModule(st, cur))
                cur = m.out_channels
                mods.append(m)
            self.stages.append((trans, mods))
            prev = cur

    def forward(self, x):
        for conv, bn in self.stem:
            x = F.relu(bn(conv(x)))
        for b in self.stage1:
            x = b(x)
        xs = [x]
        for trans, mods in self.stages:
            xs = trans(xs)
            for m in mods:
                xs = m(xs)
        return xs[0]

