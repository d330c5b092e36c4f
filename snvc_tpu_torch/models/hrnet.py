"""HRNet 2D backbone, NHWC (port of snvc_tpu/models/hrnet.py): the
stride-4 feature extractor (head_type "default"), the heatmap-regression
head of the ``BEV`` Vernier head, and the classification head.

BatchNorm follows the module's mode: running statistics in eval mode, batch
statistics (and flax's running-average update) in train mode.
All 3x3 convs pad (1, 1) explicitly, as the JAX modules do (hrnet.py:47).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from snvc_tpu_torch.config import BackboneConfig, HRNetStageConfig
from snvc_tpu_torch.models.layers import (
    BatchNorm,
    conv2d_nhwc,
    pixel_shuffle_2d,
)


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

    def _conv(self, cin, cout, k, stride=1, bias=False):
        return self._add("Conv", nn.Conv2d(cin, cout, k, stride, (k - 1) // 2,
                                           bias=bias))

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
    """HRNet (JAX hrnet.py:197).  ``head_type`` (default
    ``cfg.head_type``):

      * "default": the highest-resolution branch, [N, H/4, W/4, C];
      * "heatmap_regression": no stem and no stage 1, the input is a
        feature map of ``in_channels``; a biased 1x1 ``Conv_0`` to
        ``num_heatmaps * 4`` channels, then ``pixel_shuffle_2d`` x2:
        [N, 2 H', 2 W', num_heatmaps] for an [N, H', W', in_channels]
        input;
      * "classification": incremental ``Bottleneck``s over the branches,
        biased stride-2 3x3 convs + BatchNorm + relu between them, a
        2048-wide 1x1 conv, the spatial mean and ``Dense_0``:
        [N, num_classes].

    With ``cfg.add_xy`` the stem takes ``in_channels + 2`` channels: the
    ROIs' coordinate maps (``ops/assemble.roi_xy_maps``), or, for an
    input of ``in_channels`` alone, [-1, 1] ramps over the crop (JAX
    hrnet.py:223-241)."""

    def __init__(self, cfg: BackboneConfig, head_type: Optional[str] = None,
                 num_heatmaps: int = 9, num_classes: int = 1000,
                 in_channels: int = 3):
        super().__init__()
        head = head_type or cfg.head_type
        if head not in ("default", "heatmap_regression", "classification"):
            raise NotImplementedError(head)
        self.head = head
        stages = cfg.stages()
        self.stem, self.stage1 = [], []
        self.add_xy = cfg.add_xy and head != "heatmap_regression"
        self.in_channels = in_channels
        cin = in_channels
        if head != "heatmap_regression":
            stem_in = in_channels + 2 if self.add_xy else in_channels
            self.stem = [(self._conv(stem_in, 64, 3, 2), self._bn(64)),
                         (self._conv(64, 64, 3, 2), self._bn(64))]
            s1 = stages[0]
            block = _BLOCKS[s1.block]
            cin = 64
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
        if head == "heatmap_regression":
            self._conv(prev[0], num_heatmaps * 4, 1, bias=True)
        elif head == "classification":
            hc = (32, 64, 128, 256)
            # lists: an attribute holding a child would register it twice
            self.first = [self._add("Bottleneck", Bottleneck(prev[0], hc[0]))]
            self.steps, ch = [], hc[0] * 4
            for i in range(len(prev) - 1):
                incre = self._add("Bottleneck",
                                  Bottleneck(prev[i + 1], hc[i + 1]))
                down = self._conv(ch, hc[i + 1] * 4, 3, 2, bias=True)
                ch = hc[i + 1] * 4
                self.steps.append((incre, down, self._bn(ch)))
            self.final = (self._conv(ch, 2048, 1, bias=True), self._bn(2048))
            self.Dense_0 = nn.Linear(2048, num_classes)

    def forward(self, x):
        if self.add_xy and x.shape[-1] == self.in_channels:
            N, H, W = x.shape[:3]
            f32 = dict(dtype=torch.float32, device=x.device)
            xm = torch.linspace(-1.0, 1.0, W, **f32).to(x.dtype)
            ym = torch.linspace(-1.0, 1.0, H, **f32).to(x.dtype)
            x = torch.cat([x, xm[None, None, :, None].expand(N, H, W, 1),
                           ym[None, :, None, None].expand(N, H, W, 1)], -1)
        for conv, bn in self.stem:
            x = F.relu(bn(conv2d_nhwc(x, conv)))
        for b in self.stage1:
            x = b(x)
        xs = [x]
        for trans, mods in self.stages:
            xs = trans(xs)
            for m in mods:
                xs = m(xs)
        if self.head == "heatmap_regression":
            return pixel_shuffle_2d(conv2d_nhwc(xs[0], self.Conv_0), 2)
        if self.head == "classification":
            y = self.first[0](xs[0])
            for (incre, down, bn), h in zip(self.steps, xs[1:]):
                y = incre(h) + F.relu(bn(conv2d_nhwc(y, down)))
            conv, bn = self.final
            y = F.relu(bn(conv2d_nhwc(y, conv))).mean(dim=(1, 2))
            w, b = self.Dense_0.weight, self.Dense_0.bias
            return F.linear(y, w.to(y.dtype), b.to(y.dtype))
        return xs[0]
