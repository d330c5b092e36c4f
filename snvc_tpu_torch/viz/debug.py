"""Debug renders of one refinement batch (port of snvc_tpu/viz/debug.py; the
reference inference CLI's --debug plots, tools/inference_agnostic.py:
142-275, 380-428): the predicted NCF part heatmaps, the occupancy volume
and the proposal -> refined-box update in BEV, written as PNGs.

JAX draws matplotlib figures; the port writes numpy panels with
``data/png.encode_png`` (the card's machine has no matplotlib).  A
heatmap cell is a ``CELL_PX``-wide square coloured through a small table
(``colorize``); the row of a map's first axis grows upwards, as
matplotlib's ``origin="lower"`` shows it.  Panels sit ``PAD`` pixels
apart on white, ``cols`` a row (``panel_origin``).  Matching
matplotlib's pixels is not a goal; the brightest pixel of each NCF panel
lies on its map's argmax cell.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from snvc_tpu_torch.data.png import encode_png
from snvc_tpu_torch.viz.points import DASH, DOT, bev_footprints, draw_ring

CELL_PX = 4
PAD = 6
UPDATE_PX = 560  # the update panel's longer side
# five stops of matplotlib's viridis / magma, RGB; each table's channel
# sum grows stop to stop, so a larger value is never drawn darker
VIRIDIS = np.array([(68, 1, 84), (59, 82, 139), (33, 145, 140),
                    (94, 201, 98), (253, 231, 37)], np.float64)
MAGMA = np.array([(0, 0, 4), (81, 18, 124), (183, 55, 121),
                  (252, 137, 97), (252, 253, 191)], np.float64)
# BEV colours of render_update (JAX: tab:orange, tab:blue, tab:green, k)
UPDATE_COLORS = dict(proposal=(255, 127, 14), one_part=(31, 119, 180),
                     all_parts=(44, 160, 44), gt=(0, 0, 0))


def colorize(values: np.ndarray, table: np.ndarray = VIRIDIS,
             vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> np.ndarray:
    """uint8 [..., 3] colours of ``values`` through ``table``'s stops,
    linear between them; the range is [vmin, vmax] (default the values'
    own), clipped."""
    v = np.asarray(values, np.float64)
    lo = float(v.min()) if vmin is None else vmin
    hi = float(v.max()) if vmax is None else vmax
    t = (np.clip((v - lo) / (hi - lo), 0.0, 1.0) if hi > lo
         else np.zeros_like(v))
    x = t * (len(table) - 1)
    i = np.minimum(np.floor(x).astype(np.int64), len(table) - 2)
    f = (x - i)[..., None]
    rgb = table[i] * (1.0 - f) + table[i + 1] * f
    return np.round(rgb).astype(np.uint8)


def heatmap_image(hm: np.ndarray, **kw) -> np.ndarray:
    """A 2-D map [R, C] as a uint8 [R * CELL_PX, C * CELL_PX, 3] image
    (``colorize``'s colours), row 0 at the bottom."""
    rgb = colorize(hm, **kw)[::-1]
    return np.repeat(np.repeat(rgb, CELL_PX, axis=0), CELL_PX, axis=1)


def panel_origin(index: int, cols: int, panel_hw):
    """(y, x) of panel ``index``'s top-left pixel in a grid of ``cols``
    panels a row, each ``panel_hw`` pixels."""
    r, c = divmod(index, cols)
    return PAD + r * (panel_hw[0] + PAD), PAD + c * (panel_hw[1] + PAD)


def panel_grid(panels, cols: int) -> np.ndarray:
    """Same-sized uint8 panels on white, placed by ``panel_origin``."""
    h, w = panels[0].shape[:2]
    rows = -(-len(panels) // cols)
    img = np.full((PAD + rows * (h + PAD), PAD + cols * (w + PAD), 3), 255,
                  np.uint8)
    for i, p in enumerate(panels):
        y, x = panel_origin(i, cols, (h, w))
        img[y:y + h, x:x + w] = p
    return img


def ncf_maps(ncf: np.ndarray, instance: int = 0) -> np.ndarray:
    """[P, R, C] BEV maps of one instance's NCF: [B, P, nl, nw] as it is,
    or the middle-height slice of the 3D variant's [B, P, nh, nw, nl],
    transposed to [P, nl, nw]."""
    hm = np.asarray(ncf[instance], np.float32)
    if hm.ndim == 4:
        hm = np.transpose(hm[:, hm.shape[1] // 2], (0, 2, 1))
    return hm


def render_ncf(ncf: np.ndarray, path: str, instance: int = 0
               ) -> np.ndarray:
    """One instance's part heatmaps, ``min(P, 3)`` panels a row, each on
    its own range; written to ``path``; returns the image."""
    hm = ncf_maps(ncf, instance)
    img = panel_grid([heatmap_image(m) for m in hm], min(len(hm), 3))
    encode_png(path, img)
    return img


def occupancy_slices(nh: int, n_slices: int = 4) -> np.ndarray:
    """The height indices of the ``nh`` that ``render_occupancy`` shows."""
    return np.linspace(0, nh - 1, n_slices).astype(int)


def render_occupancy(occ: np.ndarray, path: str, instance: int = 0,
                     n_slices: int = 4) -> np.ndarray:
    """occupancy [B, nh, nw, nl] -> ``n_slices`` height slices in a row,
    each [nl, nw] on the range [0, 1]; written to ``path``."""
    o = np.asarray(occ[instance], np.float32)
    idx = occupancy_slices(o.shape[0], n_slices)
    img = panel_grid([heatmap_image(o[i].T, table=MAGMA, vmin=0.0, vmax=1.0)
                      for i in idx], len(idx))
    encode_png(path, img)
    return img


def bev_canvas(rings):
    """(to_px, (H, W)): a map of BEV (x, z) metres onto pixels (x right,
    z up, one scale) framing every ring of ``rings`` [..., 2] with a 1 m
    margin, the longer side ``UPDATE_PX`` pixels."""
    pts = np.concatenate([np.asarray(r, np.float64).reshape(-1, 2)
                          for r in rings])
    lo = pts.min(axis=0) - 1.0
    hi = pts.max(axis=0) + 1.0
    scale = (UPDATE_PX - 1) / float((hi - lo).max())
    h = int(np.ceil((hi[1] - lo[1]) * scale)) + 1
    w = int(np.ceil((hi[0] - lo[0]) * scale)) + 1

    def to_px(xz):
        xz = np.asarray(xz, np.float64)
        return np.stack([(xz[..., 0] - lo[0]) * scale,
                         (hi[1] - xz[..., 1]) * scale], axis=-1)

    return to_px, (h, w)


def render_update(samples: np.ndarray, out: Dict, path: str,
                  gt_boxes: Optional[np.ndarray] = None,
                  valid: Optional[np.ndarray] = None) -> np.ndarray:
    """BEV footprints on white: the proposals dashed orange, the one_part /
    all_parts refinements blue / green, the GT dotted black (zero boxes,
    the instances without a label, left out); written to ``path``; returns
    the image."""
    m = (np.asarray(valid, bool) if valid is not None
         else np.ones(len(samples), bool))
    sets = [("proposal", np.asarray(samples)[m], DASH)]
    for key in ("one_part", "all_parts"):
        if out.get(key) is not None:
            sets.append((key, np.asarray(out[key])[m], None))
    if gt_boxes is not None:
        # an instance without a label carries a zero box
        gt = np.asarray(gt_boxes)[m]
        sets.append(("gt", gt[np.abs(gt[:, :3]).prod(axis=1) > 0], DOT))
    rings = [bev_footprints(b) for _, b, _ in sets]
    to_px, hw = bev_canvas(rings)
    img = np.full(hw + (3,), 255, np.uint8)
    for (key, _, pattern), ring in zip(sets, rings):
        for r in ring:
            draw_ring(img, to_px(r), UPDATE_COLORS[key], pattern)
    encode_png(path, img)
    return img


def render_debug_batch(batch, out: Dict, out_dir: str,
                       tag: str = "batch0") -> Dict[str, str]:
    """The debug set of one refinement batch; returns {panel: path}."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    if out.get("ncf") is not None:
        paths["ncf"] = os.path.join(out_dir, f"{tag}_ncf.png")
        render_ncf(np.asarray(out["ncf"]), paths["ncf"])
    if out.get("occupancy") is not None:
        paths["occupancy"] = os.path.join(out_dir, f"{tag}_occupancy.png")
        render_occupancy(np.asarray(out["occupancy"]), paths["occupancy"])
    arrays = batch.arrays() if hasattr(batch, "arrays") else batch
    paths["update"] = os.path.join(out_dir, f"{tag}_update.png")
    render_update(
        np.asarray(arrays["samples"]), out, paths["update"],
        gt_boxes=(np.asarray(arrays["gt_boxes"]) if "gt_boxes" in arrays
                  else None),
        valid=np.asarray(arrays["valid"]).astype(bool))
    return paths
