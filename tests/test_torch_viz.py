"""The port's renders without matplotlib (snvc_tpu_torch/viz, tools/
visualize.py, inference_agnostic --debug) against the JAX package.

* Bit for bit against JAX (``np.testing.assert_array_equal``, no
  tolerance): ``top_coords``, ``lidar_to_top``, ``top_view_image``,
  ``draw_boxes_on_top`` (GT and score-shaded), ``bev_box_corners``,
  ``box3d_to_bev``, ``ray_hits_triangles``, ``vertex_visibility`` and the
  visualize CLI's ``rings_velo``, on seeded inputs.
* ``render_frame`` (drawn with geometry/raster, not matplotlib's pixels):
  every drawn edge has a coloured pixel within 1 px (Chebyshev) of both
  its corners' projections and of 9 points along it for a solid edge;
  each edge between two visible corners is solid (JAX's
  ``vertex_visibility``); pixels off every edge keep the frame's values.
* The debug panels: in each NCF panel the brightest pixel (RGB sum) is
  reached on the part's argmax cell (the colour table grows in brightness,
  a tie elsewhere is allowed), for the BEV maps and the 3D variant's
  middle slice; the occupancy panel has its stated size.
* ``tools/visualize.main`` writes PNGs that ``decode_png`` reads back at
  their stated sizes in both modes, the top views equal to JAX's
  ``top_view_image`` + ``draw_boxes_on_top`` of the same scene;
  ``inference_agnostic --debug`` writes the three panels and one batch
  of predictions.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from snvc_tpu.geometry import boxes as jboxes
from snvc_tpu.viz import lidar as jlidar
from snvc_tpu.viz import tracebox as jtrace
from snvc_tpu_torch.config import TrainConfig, tiny_vernier_config
from snvc_tpu_torch.data.kitti import KittiDataset
from snvc_tpu_torch.data.png import decode_png
from snvc_tpu_torch.geometry import boxes as tboxes
from snvc_tpu_torch.geometry.calib import Calibration, KittiLabel
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.tools import visualize as cli_visualize
from snvc_tpu_torch.training.train import create_train_state, save_checkpoint
from snvc_tpu_torch.viz import debug, lidar, tracebox


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _scan(seed=0, n=20000):
    rng = np.random.default_rng(seed)
    pts = np.stack([rng.uniform(-5, 105, n), rng.uniform(-35, 35, n),
                    rng.uniform(-4, 1, n), rng.uniform(0, 1, n)], axis=1)
    return pts.astype(np.float32)


def _boxes(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(1.3, 1.8, n), rng.uniform(1.5, 1.9, n),
                     rng.uniform(3.4, 4.6, n), rng.uniform(-8, 8, n),
                     rng.uniform(1.5, 1.8, n), rng.uniform(6, 40, n),
                     rng.uniform(-np.pi, np.pi, n)], axis=1)


def _rings(seed=0, n=6):
    rng = np.random.default_rng(seed)
    c = np.stack([rng.uniform(0, 90, n), rng.uniform(-25, 25, n)], axis=1)
    return c[:, None] + rng.uniform(-3, 3, (n, 4, 2))


CASES = {
    "top_coords": lambda m: m.top_coords(*_scan(1)[:, :2].T),
    "lidar_to_top": lambda m: m.lidar_to_top(_scan(2)),
    "lidar_to_top_xyz": lambda m: m.lidar_to_top(_scan(3)[:, :3]),
    "top_view_image": lambda m: m.top_view_image(m.lidar_to_top(_scan(4))),
    "draw_boxes_on_top_gt": lambda m: m.draw_boxes_on_top(
        m.top_view_image(m.lidar_to_top(_scan(5))), _rings(5), is_gt=True),
    "draw_boxes_on_top_scores": lambda m: m.draw_boxes_on_top(
        m.top_view_image(m.lidar_to_top(_scan(6))), _rings(6),
        scores=np.linspace(-0.2, 1.3, 6)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_lidar_views_equal_jax(name):
    got, want = CASES[name](lidar), CASES[name](jlidar)
    pairs = zip(got, want) if isinstance(want, tuple) else [(got, want)]
    for g, w in pairs:
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fn", ["bev_box_corners", "box3d_to_bev"])
def test_bev_helpers_equal_jax(fn):
    boxes = _boxes(7, 9)
    arg = jboxes.box3d_to_bev(boxes) if fn == "bev_box_corners" else boxes
    np.testing.assert_array_equal(getattr(tboxes, fn)(arg),
                                  getattr(jboxes, fn)(arg))


def test_ray_tracing_equals_jax():
    corners = tboxes.box_corners_cam(_boxes(8, 6))
    # boxes behind each other hide corners: two copies pushed back
    far = corners + np.array([0.3, 0.0, 4.0])
    allc = np.concatenate([corners, far])
    vis = tracebox.vertex_visibility(allc)
    np.testing.assert_array_equal(vis, jtrace.vertex_visibility(allc))
    assert (~vis).any() and vis.any()
    tri = allc[:, tracebox.BOX_TRIANGLES].reshape(-1, 3, 3)
    t = allc.reshape(-1, 3)[::3]
    np.testing.assert_array_equal(
        tracebox.ray_hits_triangles(np.zeros(3), t, *tri.transpose(1, 0, 2)),
        jtrace.ray_hits_triangles(np.zeros(3), t, *tri.transpose(1, 0, 2)))


def _near(img, base, xy, r=1):
    """A pixel within r of xy differs from the frame ``base``."""
    x, y = int(round(float(xy[0]))), int(round(float(xy[1])))
    h, w = img.shape[:2]
    ys, xs = slice(max(y - r, 0), min(y + r + 1, h)), \
        slice(max(x - r, 0), min(x + r + 1, w))
    return bool((img[ys, xs] != base[ys, xs]).any())


def test_render_frame_draws_each_edge_through_its_corners(tmp_path):
    calib = Calibration.default()
    boxes = _boxes(9, 4)
    boxes[1] = boxes[0] + np.array([0, 0, 0, 0.6, 0, 6.0, 0.3])  # hidden
    labels = [KittiLabel("Car", 0.0, 0, 0.0, np.zeros(4), b) for b in boxes]
    base = np.full((375, 1242, 3), 128, np.uint8)
    img = tracebox.render_frame(base, labels, calib,
                                str(tmp_path / "frame.png"))
    np.testing.assert_array_equal(decode_png(str(tmp_path / "frame.png")),
                                  img)
    edges = tracebox.box_edges_2d(boxes, calib)
    vis = jtrace.vertex_visibility(jboxes.box_corners_cam(boxes))
    assert len(edges) == 12 * len(boxes) and not vis.all()
    drawn = np.zeros(img.shape[:2], bool)
    for bi, uv0, uv1, solid in edges:
        ys, xs = np.round(np.linspace(uv0[::-1], uv1[::-1], 2000)).T
        ok = (ys >= 0) & (ys < 375) & (xs >= 0) & (xs < 1242)
        drawn[ys[ok].astype(int), xs[ok].astype(int)] = True
        if not all(0 <= p[0] < 1242 and 0 <= p[1] < 375 for p in (uv0, uv1)):
            continue
        assert _near(img, base, uv0) and _near(img, base, uv1), (bi, uv0)
        if solid:
            for f in np.linspace(0.1, 0.9, 9):
                assert _near(img, base, uv0 + f * (uv1 - uv0)), (bi, f)
    # which edges are solid is JAX's visibility
    k = 0
    for bi in range(len(boxes)):
        for e0, e1 in tracebox.BOX_EDGES:
            assert edges[k][3] == bool(vis[bi, e0] and vis[bi, e1])
            k += 1
    # nothing drawn away from the edges
    grow = drawn.copy()
    for dy in (-2, -1, 0, 1, 2):
        for dx in (-2, -1, 0, 1, 2):
            grow |= np.roll(np.roll(drawn, dy, 0), dx, 1)
    assert (img[~grow] == base[~grow]).all()


def test_save_image_grid_tiles_on_white(tmp_path):
    """Two rows of two: each image at its cell's corner, white between."""
    rng = np.random.default_rng(2)
    ims = [rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
           for h, w in ((10, 20), (12, 16), (8, 20))]
    grid = tracebox.save_image_grid(ims, str(tmp_path / "g" / "grid.png"))
    np.testing.assert_array_equal(decode_png(str(tmp_path / "g" / "grid.png")),
                                  grid)
    p = tracebox.GRID_PAD
    assert grid.shape == (p + 2 * (12 + p), p + 2 * (20 + p), 3)
    for i, im in enumerate(ims):
        y, x = p + (i // 2) * (12 + p), p + (i % 2) * (20 + p)
        np.testing.assert_array_equal(
            grid[y:y + im.shape[0], x:x + im.shape[1]], im)
    assert (grid[:p] == 255).all() and (grid[:, :p] == 255).all()


def _brightest_on_argmax(img, maps, cols):
    h, w = maps.shape[1] * debug.CELL_PX, maps.shape[2] * debug.CELL_PX
    for p, m in enumerate(maps):
        y, x = debug.panel_origin(p, cols, (h, w))
        panel = img[y:y + h, x:x + w].astype(int).sum(-1)
        i, j = np.unravel_index(np.argmax(m), m.shape)
        row = (m.shape[0] - 1 - i) * debug.CELL_PX  # row 0 at the bottom
        cell = panel[row:row + debug.CELL_PX,
                     j * debug.CELL_PX:(j + 1) * debug.CELL_PX]
        assert cell.min() == cell.max() == panel.max(), p


@pytest.mark.parametrize("shape", [(2, 9, 12, 10), (2, 9, 4, 10, 12)])
def test_ncf_panel_peaks_sit_on_argmax(tmp_path, shape):
    ncf = np.random.default_rng(len(shape)).standard_normal(shape)
    img = debug.render_ncf(ncf.astype(np.float32), str(tmp_path / "n.png"),
                           instance=1)
    np.testing.assert_array_equal(decode_png(str(tmp_path / "n.png")), img)
    maps = debug.ncf_maps(ncf, 1)
    _brightest_on_argmax(img, maps, 3)
    ph, pw = maps.shape[1] * debug.CELL_PX, maps.shape[2] * debug.CELL_PX
    assert img.shape == (debug.PAD + 3 * (ph + debug.PAD),
                         debug.PAD + 3 * (pw + debug.PAD), 3)


def test_occupancy_and_update_panels(tmp_path):
    rng = np.random.default_rng(3)
    occ = rng.uniform(0, 1, (2, 8, 12, 10)).astype(np.float32)
    img = debug.render_occupancy(occ, str(tmp_path / "o.png"))
    ph, pw = 10 * debug.CELL_PX, 12 * debug.CELL_PX
    assert img.shape == (ph + 2 * debug.PAD, debug.PAD + 4 * (pw + debug.PAD),
                         3)
    np.testing.assert_array_equal(debug.occupancy_slices(8), [0, 2, 4, 7])
    samples = _boxes(4, 3)
    out = dict(one_part=samples + 0.2, all_parts=samples - 0.2)
    gt = samples.copy()
    gt[2] = 0.0  # an instance without a label
    up = debug.render_update(samples, out, str(tmp_path / "u.png"),
                             gt_boxes=gt, valid=np.ones(3, bool))
    assert up.shape[2] == 3 and max(up.shape[:2]) == debug.UPDATE_PX
    for key in ("proposal", "one_part", "all_parts", "gt"):
        assert (up == debug.UPDATE_COLORS[key]).all(-1).any(), key


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """chip_smoke.py's seeded 2-frame tree with its GT as predictions."""
    root = str(tmp_path_factory.mktemp("viz"))
    chip_smoke.write_kitti_tree(root, frames=2)
    chip_smoke.write_gt_as_predictions(
        os.path.join(root, "training", "label_2"), os.path.join(root, "gt"))
    return root


def test_visualize_cli_writes_both_modes(tree, tmp_path):
    pred = os.path.join(tree, "gt", "data")
    assert cli_visualize.main(["--pred_dir", pred, "--data_path", tree,
                               "--out_dir", str(tmp_path / "cam")]) == 2
    assert cli_visualize.main(["--pred_dir", pred, "--data_path", tree,
                               "--out_dir", str(tmp_path / "top"),
                               "--top_view", "--max_frames", "1"]) == 1
    assert sorted(os.listdir(tmp_path / "cam")) == ["000000.png",
                                                    "000001.png"]
    assert os.listdir(tmp_path / "top") == ["000000_top.png"]
    for f in ("000000.png", "000001.png"):
        img = decode_png(str(tmp_path / "cam" / f))
        assert img.shape == (375, 1242, 3)
    # the top view: JAX's lidar tensor, image and drawn footprints
    scene = KittiDataset(tree, "val").scene(0)
    calib = scene.calibration("left")
    spec = jlidar.TopViewSpec()
    want = jlidar.top_view_image(jlidar.lidar_to_top(scene.lidar(), spec))
    labels = [lb for lb in scene.labels()]
    want = jlidar.draw_boxes_on_top(
        want, cli_visualize.rings_velo(labels, calib), spec, is_gt=True)
    want = jlidar.draw_boxes_on_top(
        want, cli_visualize.rings_velo(labels, calib), spec,
        scores=[1.0 - 0.01 * k for k in range(len(labels))])
    got = decode_png(str(tmp_path / "top" / "000000_top.png"))
    assert got.shape == (spec.nx, spec.ny, 3) == (501, 301, 3)
    np.testing.assert_array_equal(got, want)


def test_rings_velo_equal_jax(tree):
    """The visualize CLI's footprints, from the port's box helpers and
    calibration, against JAX's helpers on the same labels."""
    scene = KittiDataset(tree, "val").scene(1)
    calib = scene.calibration("left")
    want = []
    for lb in scene.labels():
        ring = jboxes.bev_box_corners(jboxes.box3d_to_bev(lb.box3d))
        cam = np.stack([ring[:, 0], np.full(4, lb.box3d[4]), ring[:, 1]], 1)
        want.append(calib.rect_to_velo(cam)[:, :2])
    np.testing.assert_array_equal(cli_visualize.rings_velo(
        scene.labels(), calib), np.array(want).reshape(-1, 4, 2))


def test_inference_agnostic_debug_writes_three_panels(tree, tmp_path):
    cfg = tiny_vernier_config(max_instances=4, image_size=(384, 1248))
    model_dir = str(tmp_path / "model")
    model = VernierScale(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    save_checkpoint(model_dir, create_train_state(model, cfg, TrainConfig()),
                    cfg, 0)
    out_dir = str(tmp_path / "out")
    res = cli_refine.main([
        "--model_dir", model_dir, "--data_path", tree, "--pred_dir",
        os.path.join(tree, "gt", "data"), "--output_dir", out_dir,
        "--pred_type", "one_part", "all_parts", "--debug", "--device", "cpu"])
    paths = res["debug"]
    assert sorted(paths) == ["ncf", "occupancy", "update"]
    assert sorted(os.listdir(os.path.join(out_dir, "debug"))) == [
        "batch0_ncf.png", "batch0_occupancy.png", "batch0_update.png"]
    nh, nw, nl = cfg.grid_resolution
    px = debug.CELL_PX
    shapes = dict(
        ncf=(debug.PAD + 3 * (nl * px + debug.PAD),
             debug.PAD + 3 * (nw * px + debug.PAD), 3),
        occupancy=(nl * px + 2 * debug.PAD,
                   debug.PAD + 4 * (nw * px + debug.PAD), 3))
    for k, p in paths.items():
        img = decode_png(p)
        if k in shapes:
            assert img.shape == shapes[k], k
    # one batch refined: the first frame's three proposals, each pred type
    for t in ("one_part", "all_parts"):
        files = sorted(os.listdir(os.path.join(out_dir, t, "data")))
        lines = open(os.path.join(out_dir, t, "data", files[0])).read()
        assert len(lines.strip().splitlines()) == 3, t
