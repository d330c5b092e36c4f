"""Vernier-scale instance refinement network (port of
snvc_tpu/models/vernier.py:89-314: the ``3D``, ``BEV``, ``BEV_type2`` and
``BEV_type3`` heads, ``concat`` and ``concat-atten`` aggregation).

Voxel volumes are NDHWC [N, nh, nw, nl, C]; heatmaps come out as
[N, P, nl, nw] (the ``3D`` head's fields as [N, P, nh, nw, nl]); outputs
are float32 whatever the compute dtype.  The stereo voxel is sampled by
``stereo_voxel_sample`` (kernel K1 on the card), and the BEV_type2 /
BEV_type3 heads' conv1_k7 / conv2_k5 / conv3_k5_d2 run through
``Conv3d`` -> ``conv3d_large_tap`` (kernel K2 on the card); the ``3D``
and ``BEV`` heads have no large-tap conv.

Child names follow the Flax modules (``ConvNorm3d_0`` ...), see
models/layers.py.

The module's mode is the JAX ``train`` flag: in train mode BatchNorm uses
batch statistics (over both views stacked, as the encoder runs one HRNet
pass over both) and, with ``cfg.remat``, the BEV_type2 / BEV_type3 3D
hourglass is rematerialized in the backward (``torch.utils.checkpoint``),
as JAX's ``nn.remat`` does (vernier.py:188-202).

Under ``layers.tensor_parallel`` with a mesh of ``n_model > 1`` the
object voxel is split on its length axis nl, as JAX's ``voxel_sharding``
(``P("data", None, None, "model", None)``, on the voxel of every head)
splits it: the encoder slices the projected grid before K1, so K1
samples this position's lengths (the HRNet runs whole on every model
position).  The length is cut into ``ceil(nl / 2^levels)`` units,
``levels`` the stride-2 steps of the head's hourglass
(``length_levels``), the last unit short where 2^levels does not divide
nl, and the units are spread as ``np.array_split`` spreads them, so the
slabs may differ by a unit, the last may be short, and the positions
beyond the units hold no length (parallel/tensor.py): the trained
BEV_type3 model's 48 lengths over four positions are 16 / 16 / 16 / 0,
a 40-length grid over three 16 / 16 / 8.  A short slab arises only
under the four-level ``HourglassDeep`` (BEV_type2 / BEV_type3 with
``n_sample_w > 16``), which crops as JAX's does; the two-level
``Hourglass`` does not crop, so there, as in JAX, nl is a multiple of 4.
A position of no length samples no point (K1 is not launched), runs
its convs on nothing (K2 is not launched) and takes part in every
exchange, norm and gather.  Each head runs on the slab up to one
gather:

* ``BEV_type2`` / ``BEV_type3``: the large-tap prelude (K2 on slabs
  widened by 3, 2 and 4 planes), the 3D hourglass, the occupancy and
  offset heads and the 2D hourglass (on [N, nw, L, C]), then the heatmap
  features are gathered before ``Conv_0``: ``Conv_0``, ``CoordHead``
  and ``FCModel`` run whole on every model position;
* ``3D``: both ConvNorm3d, the hourglass and the 1x1x1 ``Conv3d_0`` on
  the slab, then the fields are gathered, so ``ncf`` comes out whole and
  the heatmap loss is the one-device one;
* ``BEV``: the two ConvNorm3d (strided along the height only), the BEV
  map's ``ConvNorm_0``, hourglass, ``ConvNorm_1`` and occupancy conv on
  the [N, nw, L, C] slab, then the BEV map is gathered before the
  stride-2 ``ConvNorm_2``: it and ``HRNet_0`` run whole.

``occupancy`` and ``offset`` come out as slabs (models/losses.py sums
their losses over the model group).  ``cfg.remat`` holds on every mesh,
as in JAX: under a process group the recompute's collectives meet the
other ranks' recomputes; under a one-process mesh (parallel/local.py)
the recompute replays what the forward's collectives received
(``layers.remat_contexts``).
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from snvc_tpu_torch.config import VernierConfig
from snvc_tpu_torch.models.fc_model import FCModel
from snvc_tpu_torch.models.hrnet import BasicBlock, HRNet
from snvc_tpu_torch.models.layers import (
    Conv3d,
    ConvNorm,
    ConvNorm3d,
    Hourglass,
    HourglassDeep,
    avg_pool_height,
    conv2d_nhwc,
    init_weights,
    remat_contexts,
)
from snvc_tpu_torch.ops.grid_sample import cosine_gate
from snvc_tpu_torch.ops.stereo_sample_cuda import stereo_voxel_sample
from snvc_tpu_torch.parallel.tensor import gather, split_range
from snvc_tpu_torch.utils.device import compute_dtype, resolve_device


class CoordHead(nn.Module):
    """Heatmaps (+ coord-conv maps) -> normalized part coordinates
    (JAX vernier.py:44).  Strided BasicBlocks until the length axis is at
    most 6, then a VALID conv over the remaining extent, then sigmoid.
    The extent is computed from the grid at construction (torch needs the
    kernel size up front; JAX reads it from the traced shape)."""

    def __init__(self, num_parts: int, nl: int, nw: int):
        super().__init__()
        ch = num_parts * 2
        self.num_parts = num_parts
        blocks = [BasicBlock(num_parts + 2, ch, stride=2)]
        h, w = (nl + 1) // 2, (nw + 1) // 2
        while h > 6:
            blocks.append(BasicBlock(ch, ch, stride=2))
            h, w = (h + 1) // 2, (w + 1) // 2
        for i, b in enumerate(blocks):
            self.add_module(f"BasicBlock_{i}", b)
        self.blocks = blocks
        self.Conv_0 = nn.Conv2d(ch, ch, (h, w), bias=True)

    def forward(self, x):
        for b in self.blocks:
            x = b(x)
        x = torch.sigmoid(conv2d_nhwc(x, self.Conv_0))
        return x.reshape(x.shape[0], self.num_parts, 2)


def _coord_maps(n: int, nl: int, nw: int, dtype, device):
    """[N, nl, nw, 2]: x in [0, 1] along width, z in [0, 1] along length."""
    xm = torch.linspace(0.0, 1.0, nw, device=device)[None, :].expand(nl, nw)
    zm = torch.linspace(0.0, 1.0, nl, device=device)[:, None].expand(nl, nw)
    m = torch.stack([xm, zm], dim=-1).to(dtype)
    return m[None].expand(n, nl, nw, 2)


def length_levels(cfg: VernierConfig) -> int:
    """The stride-2 steps of the hourglass that runs on the length axis of
    ``cfg``'s head: the slabs of a model axis are whole units of
    2^levels lengths."""
    if cfg.vernier_type in ("BEV_type2", "BEV_type3") and cfg.n_sample_w > 16:
        return HourglassDeep.levels
    return Hourglass.levels


class VernierEncoder(nn.Module):
    """ROIs -> object-centric voxel: a shared HRNet over both views, then
    the stereo voxel sampler (JAX vernier.py:89).  With
    ``feature_aggregation="concat-atten"`` the sampled voxel is gated by
    the clamped cosine similarity of its two halves, in its dtype, outside
    the kernel, as JAX gates the Pallas output (vernier.py:136-148).  Under
    a model axis it samples this rank's slab of the length axis (3)."""

    split_axis = 3

    def __init__(self, cfg: VernierConfig):
        super().__init__()
        if cfg.feature_aggregation not in ("concat", "concat-atten"):
            raise NotImplementedError(cfg.feature_aggregation)
        self.cfg = cfg
        self.tp_mesh = None  # see layers.tensor_parallel
        self.HRNet_0 = HRNet(cfg.backbone, head_type="default")

    def forward(self, left_roi, right_roi, grid_proj_left, grid_proj_right):
        dt = compute_dtype(self.cfg.compute_dtype)
        n = left_roi.shape[0]
        both = torch.cat([left_roi.to(dt), right_roi.to(dt)], dim=0)
        feats = self.HRNet_0(both).contiguous()
        grid = self.cfg.grid_resolution
        gpl, gpr = grid_proj_left.float(), grid_proj_right.float()
        if self.tp_mesh is not None:
            # the points of this position's lengths (h-major ravel of the
            # grid)
            nh, nw, nl = grid
            a, b = split_range(nl, self.tp_mesh, 2 ** length_levels(self.cfg))
            gpl, gpr = (g.reshape(n, nh, nw, nl, 2)[:, :, :, a:b]
                        .reshape(n, nh * nw * (b - a), 2) for g in (gpl, gpr))
            grid = (nh, nw, b - a)
        voxel = stereo_voxel_sample(
            feats[:n], feats[n:], gpl.contiguous(), gpr.contiguous(),
            self.cfg.resolution, grid)
        if self.cfg.feature_aggregation == "concat-atten":
            C = voxel.shape[-1] // 2
            voxel = voxel * cosine_gate(voxel[..., :C], voxel[..., C:])
        return voxel


def _strided_depth(d: int) -> int:
    """Depth after a k3 stride-2 conv with padding 1."""
    return (d - 1) // 2 + 1


class VernierHead(nn.Module):
    """Voxel -> NCF / occupancy / offset / coordinates / bbox, by
    ``cfg.vernier_type`` (JAX vernier.py:149-314):

      * "3D" (``_head_3d``): two ConvNorm3d, a two-level ``Hourglass``
        (whatever the grid width, never rematerialized), a 1x1x1 conv to
        ``num_parts`` fields: ncf [N, P, nh, nw, nl]; nothing else;
      * "BEV" (``_head_bev``): two depth-strided ConvNorm3d, the height
        pooled by 2 into a BEV map, a 2D ``Hourglass``, the occupancy
        conv to nh channels (occupancy [N, nh, nw, nl]), and a stride-2
        ConvNorm into ``HRNet(head_type="heatmap_regression")``: ncf
        [N, P, nl, nw];
      * "BEV_type2" / "BEV_type3" (``_head_bev_type23``): the large-tap
        prelude (K2), the 3D hourglass (rematerialized in training with
        ``cfg.remat``), occupancy, the optional offset head, the BEV 2D
        hourglass and ncf [N, P, nl, nw]; BEV_type3 adds the
        ``CoordHead`` and, with ``use_bbox_head``, the FC bbox head.

    Child names are Flax's automatic names of each head.  Under a model
    axis every head splits the length axis (3 of the voxel, 2 of the BEV
    map) up to its gather (the module docstring)."""

    split_axis = 3

    def __init__(self, cfg: VernierConfig, voxel_channels: int):
        super().__init__()
        self.cfg = cfg
        self.tp_mesh = None  # see layers.tensor_parallel
        vt = cfg.vernier_type
        if vt == "3D":
            self._build_3d(voxel_channels)
        elif vt == "BEV":
            self._build_bev(voxel_channels)
        elif vt in ("BEV_type2", "BEV_type3"):
            self._build_bev_type23(voxel_channels, vt == "BEV_type3")
        else:
            raise NotImplementedError(f"vernier_type {vt!r}")

    # --- '3D' (JAX vernier.py:211) -------------------------------------
    def _build_3d(self, dim: int):
        cfg = self.cfg
        g, gn, L = cfg.gn_groups, cfg.gn, 3
        self.ConvNorm3d_0 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g, L)
        self.ConvNorm3d_1 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g, L)
        self.Hourglass_0 = Hourglass(dim, ndim=3, gn=gn, split_axis=L)
        self.Conv3d_0 = Conv3d(dim, cfg.num_parts, (1, 1, 1))  # no halo

    def _head_3d(self, voxel):
        x = F.relu(self.ConvNorm3d_0(voxel))
        x = F.relu(self.ConvNorm3d_1(x))
        x = x + self.Hourglass_0(x, None, None)[0]
        ncf = self.Conv3d_0(x)
        if self.tp_mesh is not None:  # the whole length from here on
            ncf = gather(ncf, 3, self.tp_mesh, self.cfg.grid_resolution[2],
                         2 ** length_levels(self.cfg))
        return dict(ncf=ncf.movedim(-1, 1),  # [N, P, nh, nw, nl]
                    occupancy=None, offset=None, coordinates=None, bbox=None)

    # --- 'BEV' (JAX vernier.py:230) ------------------------------------
    def _build_bev(self, dim: int):
        cfg = self.cfg
        g, gn = cfg.gn_groups, cfg.gn
        nh = cfg.grid_resolution[0]
        L3, L2 = 3, 2  # the length axis of the voxel, of the BEV map
        self.ConvNorm3d_0 = ConvNorm3d(dim, dim, 3, (2, 1, 1), 1, gn, g, L3)
        self.ConvNorm3d_1 = ConvNorm3d(dim, dim, 3, (2, 1, 1), 1, gn, g, L3)
        h = _strided_depth(_strided_depth(nh)) // 2
        self.ConvNorm_0 = ConvNorm(h * dim, dim * 2, 3, gn=gn, groups=g,
                                   split_axis=L2)
        self.Hourglass_0 = Hourglass(dim * 2, ndim=2, gn=gn, split_axis=L2)
        self.ConvNorm_1 = ConvNorm(dim * 2, dim * 2, 3, gn=gn, groups=g,
                                   split_axis=L2)
        self.Conv_0 = nn.Conv2d(dim * 2, nh, 3, padding=1, bias=False)
        self.ConvNorm_2 = ConvNorm(dim * 2, dim * 4, 3, 2, gn=gn, groups=g)
        self.HRNet_0 = HRNet(cfg.backbone, head_type="heatmap_regression",
                             num_heatmaps=cfg.num_parts, in_channels=dim * 4)

    def _head_bev(self, voxel):
        mesh = self.tp_mesh
        x = F.relu(self.ConvNorm3d_0(voxel))
        x = F.relu(self.ConvNorm3d_1(x))
        x = avg_pool_height(x, 2)
        N, H, W, L, C = x.shape
        bev = x.permute(0, 2, 3, 1, 4).reshape(N, W, L, H * C)
        bev = F.relu(self.ConvNorm_0(bev))
        bev = bev + self.Hourglass_0(bev, None, None)[0]
        occ = F.relu(self.ConvNorm_1(bev))
        occ = conv2d_nhwc(occ, self.Conv_0, mesh, 2)  # [N, W, L, nh]
        occ = torch.sigmoid(occ)
        if mesh is not None:  # the whole length from here on
            bev = gather(bev, 2, mesh, self.cfg.grid_resolution[2],
                         2 ** length_levels(self.cfg))
        hm = F.relu(self.ConvNorm_2(bev))
        hm = self.HRNet_0(hm)  # [N, W, L, P]
        return dict(ncf=hm.permute(0, 3, 2, 1), occupancy=occ.movedim(-1, 1),
                    offset=None, coordinates=None, bbox=None)

    # --- 'BEV_type2' / 'BEV_type3' (JAX vernier.py:261) ----------------
    def _build_bev_type23(self, two_dim: int, with_coords: bool):
        cfg = self.cfg
        nh, nw, nl = cfg.grid_resolution
        dim = two_dim // 2
        g, gn = cfg.gn_groups, cfg.gn
        L3, L2 = 3, 2  # the length axis of the voxel, of the BEV map
        self.with_coords = with_coords
        self.ConvNorm3d_0 = ConvNorm3d(two_dim, dim, 1, 1, 1, gn, g,
                                       L3)  # vimg
        self.ConvNorm3d_1 = ConvNorm3d(two_dim, dim, 7, 1, 1, gn, g,
                                       L3)  # conv1_k7
        self.ConvNorm3d_2 = ConvNorm3d(dim, dim, 5, 1, 1, gn, g,
                                       L3)  # conv2_k5
        self.ConvNorm3d_3 = ConvNorm3d(dim, dim, 5, 1, 2, gn, g,
                                       L3)  # conv3_k5_d2
        # hourglass choice by grid width (JAX _hg3d/_hg2d); the JAX model's
        # nn.remat renames the 3D one "Checkpoint<cls>_0", and the 2D one
        # then takes index 0 of its own class
        deep = cfg.n_sample_w > 16
        cls = HourglassDeep if deep else Hourglass
        hg3 = cls.__name__ + "_0"
        if cfg.remat:
            hg3, hg2 = "Checkpoint" + hg3, cls.__name__ + "_0"
        else:
            hg2 = cls.__name__ + "_1"
        self.add_module(hg3, cls(dim, ndim=3, gn=gn, split_axis=L3))
        self.ConvNorm3d_4 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g,
                                       L3)  # occupancy
        self.Conv3d_0 = Conv3d(dim, 1, (3, 3, 3), split_axis=L3)
        k = 5
        if cfg.use_part_reg_head:
            self.ConvNorm3d_5 = ConvNorm3d(dim, dim, 3, 1, 1, gn, g, L3)
            self.Conv3d_1 = Conv3d(dim, 27, (1, 1, 1), split_axis=L3)
            k = 6
        self.add_module(f"ConvNorm3d_{k}",
                        ConvNorm3d(2 * dim, dim, 3, 1, 1, gn, g, L3))
        self.ConvNorm_0 = ConvNorm((nh // 4) * dim, 64, 3, gn=gn, groups=g,
                                   split_axis=L2)
        self.add_module(hg2, cls(64, ndim=2, gn=gn, split_axis=L2))
        self.Conv_0 = nn.Conv2d(64, cfg.num_parts, 3, padding=1, bias=False)
        if with_coords:
            self.CoordHead_0 = CoordHead(cfg.num_parts, nl, nw)
            if cfg.use_bbox_head:
                self.FCModel_0 = FCModel(cfg.num_parts * 2, num_neurons=128,
                                         num_blocks=1, output_size=5)
        # child names, looked up at call time (an attribute holding the
        # module itself would register it twice)
        self._hg3, self._hg2, self._post = hg3, hg2, f"ConvNorm3d_{k}"

    def _head_bev_type23(self, voxel, dropout_generator):
        cfg = self.cfg
        mesh = self.tp_mesh
        vimg = F.relu(self.ConvNorm3d_0(voxel))
        x = F.relu(self.ConvNorm3d_1(voxel))
        x = F.relu(self.ConvNorm3d_2(x)) + x
        x = F.relu(self.ConvNorm3d_3(x)) + x
        hg3 = getattr(self, self._hg3)
        if isinstance(hg3, HourglassDeep):
            run_hg3 = hg3
        else:
            def run_hg3(t):
                return hg3(t, None, None)[0]
        if cfg.remat and self.training and torch.is_grad_enabled():
            # the hourglass draws no random number, so the recompute need
            # not fork the global generators (a one-process mesh's
            # positions recompute on their devices' autograd threads)
            x = checkpoint(run_hg3, x, use_reentrant=False,
                           preserve_rng_state=False,
                           context_fn=functools.partial(remat_contexts, hg3,
                                                        mesh)) + x
        else:
            x = run_hg3(x) + x

        occ = F.relu(self.ConvNorm3d_4(x))
        occ = torch.sigmoid(self.Conv3d_0(occ))  # [N, nh, nw, nl, 1]
        occupancy = occ[..., 0]
        offset = None
        if cfg.use_part_reg_head:
            off = self.Conv3d_1(F.relu(self.ConvNorm3d_5(x)))
            offset = off.movedim(-1, 1)

        x = torch.cat([x, vimg * occ], dim=-1)
        x = F.relu(getattr(self, self._post)(x))
        x = avg_pool_height(x, 4)
        N, H, W, L, C = x.shape
        bev = x.permute(0, 2, 3, 1, 4).reshape(N, W, L, H * C)
        bev = F.relu(self.ConvNorm_0(bev))
        hg2 = getattr(self, self._hg2)
        if isinstance(hg2, HourglassDeep):
            hm = hg2(bev)
        else:
            hm = hg2(bev, None, None)[0]
        if mesh is not None:  # the whole length from here on
            hm = gather(hm, 2, mesh, cfg.grid_resolution[2],
                        2 ** length_levels(cfg))
        hm = hm.permute(0, 2, 1, 3)  # [N, L, W, 64]
        ncf_maps = conv2d_nhwc(hm, self.Conv_0)  # [N, nl, nw, P]
        ncf = ncf_maps.movedim(-1, 1)

        coordinates, bbox = None, None
        if self.with_coords:
            aug = torch.cat([ncf_maps, _coord_maps(
                N, ncf_maps.shape[1], ncf_maps.shape[2], ncf_maps.dtype,
                x.device)], dim=-1)
            coordinates = self.CoordHead_0(aug)
            if cfg.use_bbox_head:
                bbox = self.FCModel_0(
                    coordinates.reshape(N, cfg.num_parts * 2),
                    dropout_generator)
        return dict(ncf=ncf, occupancy=occupancy, offset=offset,
                    coordinates=coordinates, bbox=bbox)

    @property
    def has_bbox(self) -> bool:
        """Whether the head has the FC bbox head (BEV_type3 with
        ``use_bbox_head``)."""
        return hasattr(self, "FCModel_0")

    def forward(self, voxel,
                dropout_generator: Optional[torch.Generator] = None
                ) -> Dict[str, Optional[torch.Tensor]]:
        """``dropout_generator`` draws the bbox head's dropout masks in
        train mode (models/fc_model.py).  Outputs are float32."""
        vt = self.cfg.vernier_type
        if vt == "3D":
            out = self._head_3d(voxel)
        elif vt == "BEV":
            out = self._head_bev(voxel)
        else:
            out = self._head_bev_type23(voxel, dropout_generator)
        return {k: (v.float() if v is not None else None)
                for k, v in out.items()}


class VernierScale(nn.Module):
    """Encoder + head (JAX VernierScale).  ``device`` defaults to "cuda" and
    raises without a GPU; ``generator`` seeds the weights."""

    def __init__(self, cfg: VernierConfig, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        self.encoder = VernierEncoder(cfg)
        self.head = VernierHead(cfg, 2 * cfg.backbone.output_channel)
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        init_weights(self, generator)
        self.to(dev)
        self.eval()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    def forward(self, left_roi, right_roi, grid_proj_left, grid_proj_right,
                dropout_generator: Optional[torch.Generator] = None):
        voxel = self.encoder(left_roi, right_roi, grid_proj_left,
                             grid_proj_right)
        return self.head(voxel, dropout_generator)
