"""HRNet 2D backbone, NHWC (port of snvc_tpu/models/hrnet.py, head_type
"default": the highest-resolution branch at stride 4).

BatchNorm follows the module's mode: running statistics in eval mode, batch
statistics (and flax's running-average update) in train mode.
All 3x3 convs pad (1, 1) explicitly, as the JAX modules do (hrnet.py:47).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.config import BackboneConfig, HRNetStageConfig
from snvc_tpu_torch.models.layers import BatchNorm, conv2d_nhwc


class _Named(nn.Module):
    """Registers children under Flax's auto names (``Conv_0``, ``Conv_1``,
    ``BatchNorm_0``, ...): a counter per kind, in creation order."""

    def __init__(self):
        super().__init__()
        self._counts = {}

    def _add(self, kind: str, mod: nn.Module) -> nn.Module:
        i = self._counts.get(kind, 0)
        self._counts[kind] = i + 1
        self.add_module(f"{kind}_{i}", mod)
        return mod

    def _conv(self, cin, cout, k, stride=1):
        return self._add("Conv", nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                           bias=False))

    def _bn(self, c):
        return self._add("BatchNorm", BatchNorm(c))


class BasicBlock(_Named):
    """3x3-3x3 residual block with final relu (JAX hrnet.py:35)."""

    expansion = 1

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self._conv(cin, features, 3, stride), self._bn(features)
        self._conv(features, features, 3), self._bn(features)
        self.shortcut = stride != 1 or cin != features
        if self.shortcut:
            self._conv(cin, features, 1, stride), self._bn(features)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(conv2d_nhwc(x, self.Conv_0)))
        out = self.BatchNorm_1(conv2d_nhwc(out, self.Conv_1))
        if self.shortcut:
            x = self.BatchNorm_2(conv2d_nhwc(x, self.Conv_2))
        return F.relu(out + x)


class Bottleneck(_Named):
    """1x1-3x3-1x1 bottleneck, expansion 4 (JAX hrnet.py:64)."""

    expansion = 4

    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        out_ch = features * 4
        self._conv(cin, features, 1), self._bn(features)
        self._conv(features, features, 3, stride), self._bn(features)
        self._conv(features, out_ch, 1), self._bn(out_ch)
        self.shortcut = stride != 1 or cin != out_ch
        if self.shortcut:
            self._conv(cin, out_ch, 1, stride), self._bn(out_ch)

    def forward(self, x):
        out = F.relu(self.BatchNorm_0(conv2d_nhwc(x, self.Conv_0)))
        out = F.relu(self.BatchNorm_1(conv2d_nhwc(out, self.Conv_1)))
        out = self.BatchNorm_2(conv2d_nhwc(out, self.Conv_2))
        if self.shortcut:
            x = self.BatchNorm_3(conv2d_nhwc(x, self.Conv_3))
        return F.relu(out + x)


_BLOCKS = {"basic": BasicBlock, "bottleneck": Bottleneck}


class FuseLayer(_Named):
    """Cross-resolution fusion path j -> i (JAX hrnet.py:101)."""

    def __init__(self, to_branch: int, from_branch: int, cin: int,
                 features: int):
        super().__init__()
        i, j = to_branch, from_branch
        self.up = 2 ** (j - i) if j > i else 0
        self.steps = []
        if j > i:
            self.steps.append((self._conv(cin, features, 1),
                               self._bn(features), False))
            return
        for k in range(i - j):
            last = k == i - j - 1
            ch = features if last else cin
            self.steps.append((self._conv(cin, ch, 3, 2), self._bn(ch),
                               not last))

    def forward(self, x):
        for conv, bn, relu in self.steps:
            x = bn(conv2d_nhwc(x, conv))
            if relu:
                x = F.relu(x)
        if self.up:
            x = x.repeat_interleave(self.up, dim=1).repeat_interleave(
                self.up, dim=2)
        return x


class HRModule(_Named):
    """Per-branch blocks + full fusion (JAX hrnet.py:128)."""

    def __init__(self, stage: HRNetStageConfig, in_channels: Sequence[int]):
        super().__init__()
        block = _BLOCKS[stage.block]
        nb = stage.num_branches
        self.branches = []
        for i in range(nb):
            cin, mods = in_channels[i], []
            for _ in range(stage.num_blocks[i]):
                mods.append(self._add(block.__name__,
                                      block(cin, stage.num_channels[i])))
                cin = stage.num_channels[i] * block.expansion
            self.branches.append(mods)
        self.out_channels = tuple(c * block.expansion
                                  for c in stage.num_channels)
        self.fuse = []
        if nb > 1:
            for i in range(nb):
                row = []
                for j in range(nb):
                    if j != i:
                        row.append((j, self._add("FuseLayer", FuseLayer(
                            i, j, self.out_channels[j], self.out_channels[i]))))
                self.fuse.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
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
    """Branch-count transition between stages (JAX hrnet.py:159)."""

    def __init__(self, out_channels: Tuple[int, ...],
                 in_channels: Tuple[int, ...]):
        super().__init__()
        n_pre = len(in_channels)
        self.paths = []  # per output branch: (source index, [(conv, bn)])
        for i, co in enumerate(out_channels):
            if i < n_pre:
                steps = []
                if co != in_channels[i]:
                    steps.append((self._conv(in_channels[i], co, 3),
                                  self._bn(co)))
                self.paths.append((i, steps))
            else:
                steps, ch = [], in_channels[-1]
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
                h = F.relu(bn(conv2d_nhwc(h, conv)))
            outs.append(h)
        return outs


class HRNet(_Named):
    """HRNet, ``head_type="default"`` (JAX hrnet.py:197): returns the
    highest-resolution feature map [N, H/4, W/4, C]."""

    def __init__(self, cfg: BackboneConfig, in_channels: int = 3):
        super().__init__()
        if cfg.add_xy:
            raise NotImplementedError("add_xy backbone input is not ported")
        stages = cfg.stages()
        self.stem = [(self._conv(in_channels, 64, 3, 2), self._bn(64)),
                     (self._conv(64, 64, 3, 2), self._bn(64))]
        s1 = stages[0]
        block = _BLOCKS[s1.block]
        self.stage1, cin = [], 64
        for _ in range(s1.num_blocks[0]):
            self.stage1.append(self._add(block.__name__,
                                         block(cin, s1.num_channels[0])))
            cin = s1.num_channels[0] * block.expansion
        prev = (cin,)
        self.stages = []
        for st in stages[1:]:
            exp = _BLOCKS[st.block].expansion
            cur = tuple(c * exp for c in st.num_channels)
            trans = self._add("Transition", Transition(cur, prev))
            mods = []
            for _ in range(st.num_modules):
                m = self._add("HRModule", HRModule(st, cur))
                cur = m.out_channels
                mods.append(m)
            self.stages.append((trans, mods))
            prev = cur

    def forward(self, x):
        for conv, bn in self.stem:
            x = F.relu(bn(conv2d_nhwc(x, conv)))
        for b in self.stage1:
            x = b(x)
        xs = [x]
        for trans, mods in self.stages:
            xs = trans(xs)
            for m in mods:
                xs = m(xs)
        return xs[0]
