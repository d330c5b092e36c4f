"""The port's profiling module and per-stage profilers
(snvc_tpu_torch/utils/profiling.py, tools/profile_vernier.py,
tools/profile_stereo.py) against the JAX package's
(snvc_tpu/utils/profiling.py, tools/profile_vernier.py,
tools/profile_stereo.py) on the CPU.

* ``StepTimer`` writes JAX's JSONL records: the same keys and steps from
  the same calls (the times are the host clock's, not compared).
* ``device_memory_stats`` is a dict (empty on a host with no card).
* ``trace`` writes a Chrome trace of the block into its directory.
* Both profilers at their tiny configs on the CPU print one JSON object
  whose keys are JAX's stage keys, in JAX's order (listed below with
  their source lines), with finite times.  The JAX tools are not run:
  their jit would cost seconds a stage.
"""

import json
import math
import os

import torch

from snvc_tpu.utils import profiling as jprofiling
from snvc_tpu_torch.tools import profile_stereo, profile_vernier
from snvc_tpu_torch.utils import profiling

# tools/profile_vernier.py:102-153 (the n_sample_w <= 16 branch names the
# hourglasses alike, :115-118)
VERNIER_KEYS = [
    "head.conv1_k7 (2C->C)", "head.conv2_k5", "head.conv3_k5_d2",
    "head.hourglass3d", "head.hourglass2d", "head.occ_conv_k3",
    "head.conv4_k3 (2C->C)", "head.bev_conv", "enc.hrnet_2views",
    "encoder_full", "sum_of_stages_ms", "batch"]
# tools/profile_stereo.py:90-219
STEREO_KEYS = [
    "backbone_ms", "cost_volume_ms", "stack3d_ms", "depth_head_ms",
    "frustum_ms", "bev_head_ms", "full_model_ms", "accounted_ms"]


def _records(timer_cls, path):
    t = timer_cls(str(path), window=2)
    for step in range(4):
        t.tick()
        t.log(step, {"loss": float(step)})
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def test_step_timer_writes_jax_records(tmp_path):
    got = _records(profiling.StepTimer, tmp_path / "port.jsonl")
    want = _records(jprofiling.StepTimer, tmp_path / "jax.jsonl")
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert list(g) == list(w) == ["step", "step_seconds", "loss"]
        assert g["step"] == w["step"] and g["loss"] == w["loss"]
    assert got[0]["step_seconds"] == 0.0  # one tick: no interval yet
    assert profiling.StepTimer(None).log(0) is None  # no path: no file


def test_device_memory_stats_is_a_dict():
    stats = profiling.device_memory_stats()
    assert isinstance(stats, dict)
    if not torch.cuda.is_available():
        assert stats == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir) as d:
        assert d == log_dir
        torch.mm(x, x)
    files = os.listdir(log_dir)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(log_dir, files[0])) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _finite(report):
    assert all(math.isfinite(v) and v >= 0 for v in report.values())


def test_profile_vernier_tiny_prints_jax_keys(capsys):
    report = profile_vernier.main(["--config", "tiny", "--device", "cpu",
                                   "--iters", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report and list(report) == VERNIER_KEYS
    assert report["batch"] == 1
    _finite(report)
    head = sum(v for k, v in report.items() if k.startswith("head."))
    assert abs(report["sum_of_stages_ms"]
               - (head + report["encoder_full"])) < 0.05


def test_profile_stereo_tiny_prints_jax_keys(capsys):
    report = profile_stereo.main(["--config", "tiny", "--dtype", "float32",
                                  "--device", "cpu", "--iters", "1"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report and list(report) == STEREO_KEYS
    _finite(report)
