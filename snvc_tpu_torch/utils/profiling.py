"""Profiling and observability (port of snvc_tpu/utils/profiling.py, with
its names): a device trace, per-device memory statistics and step timing
to JSONL.

``trace`` wraps ``torch.profiler.profile`` (CPU and, where there is a
card, CUDA activity) and writes a Chrome / Perfetto trace file into its
directory; ``device_memory_stats`` reads the caching allocator's byte
counters of every visible CUDA device; ``StepTimer`` is JAX's.
``median_seconds`` times the stages of the profilers
(``tools/profile_vernier.py``, ``tools/profile_stereo.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Callable, Dict, Optional

import torch

WARMUP = 2  # calls of a stage before the timed ones (tools/profile_*.py)


@contextlib.contextmanager
def trace(log_dir: str = "profiles"):
    """Profile the block with ``torch.profiler`` and write its trace as
    ``trace_<pid>_<ns>.json`` (Chrome / Perfetto format) into ``log_dir``,
    which is yielded.  CUDA activity is recorded where a card is
    visible."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per-device memory statistics in MiB: every byte counter of
    ``torch.cuda.memory_stats`` (``allocated_bytes.all.peak``, ...) for
    each visible CUDA device, keyed ``cuda:<i>``; an empty dict on a host
    with none."""
    if not torch.cuda.is_available():
        return {}
    out = {}
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[str(torch.device("cuda", i))] = {
            k: v / (1 << 20) for k, v in s.items()
            if isinstance(v, (int, float)) and "bytes" in k}
    return out


class StepTimer:
    """Rolling step timing + JSONL emission (tensorboard-free)."""

    def __init__(self, path: Optional[str] = None, window: int = 50):
        self.path = path
        self.window = window
        self._times = []
        self._last = None

    def tick(self):
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            if len(self._times) > self.window:
                self._times.pop(0)
        self._last = now

    @property
    def mean_step_seconds(self) -> float:
        return sum(self._times) / len(self._times) if self._times else 0.0

    def log(self, step: int, extra: Optional[Dict] = None):
        if not self.path:
            return
        rec = {"step": step, "step_seconds": self.mean_step_seconds}
        if extra:
            rec.update(extra)
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")


def median_seconds(fn: Callable, make_args: Callable, n: int,
                   device: torch.device) -> float:
    """Median seconds of ``fn(*make_args(i))`` over the calls i = WARMUP
    .. n - 1, after WARMUP calls, under inference mode.  Each call's
    arguments are made before it, outside its time.  On a CUDA device a
    call is timed with CUDA events and waited for; on the CPU with the
    host clock."""
    ts = []
    with torch.inference_mode():
        for i in range(n):
            args = make_args(i)
            if device.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                fn(*args)
                end.record()
                end.synchronize()
                t = start.elapsed_time(end) / 1e3
            else:
                t0 = time.perf_counter()
                fn(*args)
                t = time.perf_counter() - t0
            if i >= WARMUP:
                ts.append(t)
    ts.sort()
    return ts[len(ts) // 2]
