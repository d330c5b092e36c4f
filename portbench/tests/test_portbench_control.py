"""The correctness check fails what it must: the control (the reference
rounded to float8 in the program's place) and the faults a serving cell
can have, planted under a whole run: an answer altered where it is
produced, half of the batch left out, and the answers lost."""

import pytest
import torch

from portbench.tests.tiny import CELLS, make_root, run


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails(tmp_path, cell, monkeypatch):
    from portbench.lib import compare
    from portbench.lib.cells import Cell

    root = make_root(tmp_path)
    seen = {}

    def check(self):
        nums = self.numbers("fp8")
        seen.update(nums)
        return compare.with_limits(nums, self.cell.workload["limits"])

    drv = Cell(cell, root).driver().Driver
    monkeypatch.setattr(drv, "check", check)
    res = run(root, cell)
    assert not res["correct"], seen


def _alter_answer(monkeypatch):
    """The refined boxes moved by 0.2 m where finalize produces them."""
    from snvc_tpu_torch.inference import refine

    orig = refine.finalize

    def finalize(*a, **k):
        out = orig(*a, **k)
        out["all_parts"] = out["all_parts"].clone()
        out["all_parts"][:, 3] += 0.2
        return out

    monkeypatch.setattr(refine, "finalize", finalize)


def _half_batch(monkeypatch):
    """The head run on the first half of the instances, the second half's
    outputs left as the first half's."""
    from snvc_tpu_torch.inference.refine import RefineRunner

    orig = RefineRunner.heads

    def heads(self, voxel):
        h = voxel.shape[0] // 2 or 1
        out = orig(self, voxel[:h])
        return {k: None if v is None else torch.cat(
            [v] * (voxel.shape[0] // h))[:voxel.shape[0]]
            for k, v in out.items()}

    monkeypatch.setattr(RefineRunner, "heads", heads)


def _alter_maps(monkeypatch):
    """One RPN map altered where the BEV head produces it."""
    from snvc_tpu_torch.models.stereonet import StereoHead

    orig = StereoHead.bev_head

    def bev_head(self, *a):
        out = orig(self, *a)
        out["reg"] = out["reg"] * 1.05
        return out

    monkeypatch.setattr(StereoHead, "bev_head", bev_head)


def _half_pairs(monkeypatch):
    """The model run on the first half of a request's pairs, the second
    half's maps left as the first half's."""
    from snvc_tpu_torch.models.stereonet import StereoNet

    orig = StereoNet.forward

    def forward(self, left, right, P_left, P_right):
        n = left.shape[0]
        h = n // 2 or 1
        out = orig(self, left[:h], right[:h], P_left[:h], P_right[:h])
        return {k: torch.cat([v] * (n // h))[:n] if isinstance(v, torch.Tensor)
                and v.ndim and v.shape[0] == h else v
                for k, v in out.items()}

    monkeypatch.setattr(StereoNet, "forward", forward)


def _lose_answers(monkeypatch):
    """The window's answers lost: no sampled request is there to judge."""
    from portbench.drivers import detect, refine

    for drv in (refine.Driver, detect.Driver):
        def window(self, *a, _orig=drv.window, **k):
            out = _orig(self, *a, **k)
            self.sampled.clear()
            return out

        monkeypatch.setattr(drv, "window", window)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_v.offline8", _alter_answer), ("tiny_v.offline8", _half_batch),
    ("tiny_v.online_var", _alter_answer), ("tiny_v.online_var", _half_batch),
    ("tiny_s.offline4", _alter_maps), ("tiny_s.offline4", _half_pairs),
    ("tiny_v.offline8", _lose_answers), ("tiny_s.offline4", _lose_answers)])
def test_fault_fails(tmp_path, monkeypatch, cell, fault):
    fault(monkeypatch)
    res = run(make_root(tmp_path), cell)
    assert not res["correct"], res["checks"]
