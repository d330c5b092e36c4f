"""The plain reference against the program at tiny sizes on the CPU, the
benchmark's pieces copied from the program against their originals, and
the frozen work formulas against the kernels' declared work at the
cells' shapes."""

import json
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench.lib import kitti
from portbench.reference import stereo as ref_stereo
from portbench.tests.tiny import CELLS, TINY_LIMITS, make_root, run
from portbench.work import kernels as W
from snvc_tpu_torch.config import VernierConfig, load_config
from snvc_tpu_torch.geometry import boxes as gbox
from snvc_tpu_torch.geometry import imgproc
from snvc_tpu_torch.ops import conv3d_fold, cost_volume, frustum
from snvc_tpu_torch.ops import stereo_sample_cuda as k1
from snvc_tpu_torch.ops.nms import rotated_nms_bev
from snvc_tpu_torch.ops.rotated_iou import bev_from_box3d

REPO = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_tiny_cell_correct_on_cpu(tmp_path, cell):
    """A whole run of the tiny cell: the program (float32) within the
    tiny limits of the reference, the numbers printed beside them."""
    res = run(make_root(tmp_path), cell)
    assert res["correct"], res["checks"]
    assert set(res["checks"]) == set(TINY_LIMITS[cell])
    assert res["attempted"] > 0 and res["failed"] == 0


def test_crop_transforms_match_the_program():
    rng = np.random.default_rng(3)
    cfg = load_config(str(REPO / "portbench/configs/vernier_release_w48.json"),
                      VernierConfig)
    samples = kitti.car_proposals(rng, 16)
    tl, tr = kitti.crop_transforms(samples, cfg.grid_range, cfg.resolution,
                                   cfg.roi_enlarge)
    for i, s in enumerate(samples):
        box = s.copy()
        c_y = box[4] - 0.5 * box[0]
        box[:3] = cfg.grid_range
        box[4] = c_y + 0.5 * box[0]
        pts = gbox.box_parts_cam(box)
        for P, got in ((kitti.P_LEFT, tl[i]), (kitti.P_RIGHT, tr[i])):
            uvw = np.c_[pts, np.ones(9)] @ P.astype(np.float64).T
            want = imgproc.roi_crop_transform(uvw[:, :2] / uvw[:, 2:],
                                              cfg.resolution, cfg.roi_enlarge)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_reference_nms_matches_the_program():
    rng = np.random.default_rng(5)
    n = 96
    boxes = torch.tensor(np.c_[rng.normal(1.5, 0.1, n), rng.normal(1.6, 0.1, n),
                               rng.normal(3.9, 0.3, n),
                               rng.uniform(-6, 6, n), np.full(n, 1.6),
                               rng.uniform(10, 22, n),
                               rng.uniform(-3, 3, n)], dtype=torch.float32)
    scores = torch.sort(torch.rand(n, generator=torch.Generator()
                                   .manual_seed(1)), descending=True).values
    bev = bev_from_box3d(boxes)
    keep = rotated_nms_bev(bev, scores, scores > 0.1, 0.25)
    kept = ref_stereo.nms(bev, (scores > 0.1).numpy(), 0.25, n)
    assert kept == torch.nonzero(keep)[:, 0].tolist()


def _release():
    return json.loads((REPO / "portbench/configs/vernier_release_w48.json")
                      .read_text())["vernier"]


def _stereo():
    return json.loads((REPO / "portbench/configs/stereo_full.json")
                      .read_text())["stereo"]


@pytest.mark.parametrize("itemsize", [2, 4])
def test_refine_work_equals_the_kernels_declared(itemsize):
    cfg = _release()
    N = cfg["max_instances"]
    nh, nw, nl = cfg["grid_resolution"]
    vox = (N, nh, nw, nl)
    got = W.refine_work(cfg, 48, itemsize)
    want1 = k1.k1_work(N, nh * nw * nl, 64, 64, 48, itemsize)
    assert got["K1"]["flops"] == want1.flops
    assert got["K1"]["bytes"] == want1.bytes_accessed
    want2 = [conv3d_fold.conv3d_work(vox + (96,), (7, 7, 7), 48, 1, itemsize),
             conv3d_fold.conv3d_work(vox + (48,), (5, 5, 5), 48, 1, itemsize),
             conv3d_fold.conv3d_work(vox + (48,), (5, 5, 5), 48, 2, itemsize)]
    assert got["K2"]["flops"] == sum(w.flops for w in want2)
    assert got["K2"]["bytes"] == sum(w.bytes_accessed for w in want2)
    assert got["K2"]["launches"] == 3


def test_detect_work_equals_the_kernels_declared():
    cfg = _stereo()
    depths, d0, fd = ref_stereo.depth_rows(cfg)
    want_d0, want_fd = frustum.frustum_tables(depths,
                                              ref_stereo.bev_axes(cfg)[0])
    np.testing.assert_array_equal(d0, want_d0)
    np.testing.assert_allclose(fd, want_fd, rtol=0, atol=1e-7)
    got = W.detect_work(cfg, 4, 2, d0)
    want3 = cost_volume.k3_work(4, 64, 96, 312, 32, 2, 4 * 64)
    want4 = frustum.k4_work((4, 64, 96, 312, 32), d0, (4, 288, 300, 20, 32),
                            2)
    assert (got["K3"]["flops"], got["K3"]["bytes"]) == tuple(want3)
    assert (got["K4"]["flops"], got["K4"]["bytes"]) == tuple(want4)


def test_flop_counts_of_the_cells():
    from portbench.work import flops

    inst = flops.refine_flops_per_instance(_release())
    pair = flops.detect_flops_per_pair(_stereo())
    assert math.isclose(inst, 5829962316288, rel_tol=1e-12)
    assert math.isclose(pair, 1549236756480, rel_tol=1e-12)
