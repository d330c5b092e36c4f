"""The traced slice of a ``--trace 1`` run.

``torch.profiler`` records a few consecutive requests in the middle of
the window (its schedule: ``skip`` requests waited, ``warmup`` warmed,
``active`` recorded).  It records the device's activity and the CUDA
runtime calls alone: recording every host operation as well would slow
the host's dispatch by a fifth and more, and the slice would measure the
profiler.  The step boundaries of the recorded requests are marked on
the host's side of the same timeline by a runtime call of their own
(``cudaStreamQuery``, ``mark``).  The Chrome trace is written to a
temporary file, reduced in the process and deleted; only the summary is
kept:

* ``window_s``: from the first recorded step's start to the last one's
  end (the first and the last mark);
* ``busy_s``: the union of the device's kernels, copies and sets within
  the window;
* ``kernels``: {name: [launches, seconds]} over the kernels that start
  within the window;
* ``marks``: the marks found (two a recorded request);
* ``period_s``: the device's seconds a request at the pace of the
  untraced window: CUDA events recorded at every step boundary, over the
  requests before the profiler first starts (from the third request to
  the last but one of the ``skip`` requests).  Even with the host's
  operations left out, the profiler's work on each launch slows the
  host's dispatch within the slice, and after it too (the CUDA runtime
  stays hooked once the profiler has run), so the readers of the idle
  share and of ``mfu`` take the device's busy seconds a request from the
  slice and the time a request takes from this pace;
* ``idle_gaps``: the longest stretches of the window with nothing on the
  device, each named by the runtime call the host was in at its middle,
  or else by the device operation that ends it.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Optional

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
MARK = "cudaStreamQuery"


def mark():
    """A runtime call that marks a step boundary in the trace."""
    torch.cuda.current_stream().query()


class Tracer:
    """Profiles requests ``[skip + warmup, skip + warmup + active)``; call
    ``step()`` once after each request is dispatched."""

    def __init__(self, skip: int, warmup: int, active: int):
        self.skip = skip
        self.first = skip + warmup
        self.active = active
        self.summary: Optional[Dict] = None
        self.bounds: List[torch.cuda.Event] = []
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=skip, warmup=warmup,
                                             active=active, repeat=1),
            on_trace_ready=self._ready)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def step(self):
        # the mark before closes a recorded step, the one after opens one
        mark()
        self.prof.step()
        mark()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.bounds.append(e)

    def period_s(self) -> Optional[float]:
        """Device seconds a request before the profiler starts (None
        without two step boundaries there)."""
        ev = self.bounds[2:self.skip - 1]
        if len(ev) < 2:
            return None
        ev[-1].synchronize()
        return ev[0].elapsed_time(ev[-1]) * 1e-3 / (len(ev) - 1)

    def requests(self) -> range:
        """The indices of the recorded requests."""
        return range(self.first, self.first + self.active)

    def _ready(self, prof):
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = reduce(events)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: List[Dict]) -> Dict:
    """The summary of a Chrome trace's events (times in microseconds)."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    marks = [e["ts"] for e in spans
             if e.get("cat") in RUNTIME_CATS and e["name"] == MARK]
    dev = sorted((e for e in spans if e.get("cat") in DEVICE_CATS),
                 key=lambda e: e["ts"])
    if len(marks) < 2 or not dev:
        return {}
    t0, t1 = min(marks), max(marks)
    busy = _merge([(max(e["ts"], t0), min(e["ts"] + e["dur"], t1))
                   for e in dev if e["ts"] < t1 and e["ts"] + e["dur"] > t0])
    if not busy:
        return {}
    kernels: Dict[str, List[float]] = {}
    for e in dev:
        if e["cat"] == "kernel" and t0 <= e["ts"] < t1:
            k = kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] * 1e-6
    gaps, prev = [], t0
    for a, b in busy + [[t1, t1]]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    host = [e for e in spans if e.get("cat") in RUNTIME_CATS
            and e["name"] != MARK]
    starts = [e["ts"] for e in dev]
    idle = []
    for dur, a, b in gaps[:10]:
        mid = 0.5 * (a + b)
        over = [e for e in host if e["ts"] <= mid <= e["ts"] + e["dur"]]
        if over:
            name = min(over, key=lambda e: e["dur"])["name"]
        else:
            nxt = next((e for e, s in zip(dev, starts) if s >= b), None)
            name = ("host, before " + nxt["name"] if nxt is not None
                    else "host, to the window's end")
        idle.append([name[:160], dur * 1e-6])
    return dict(window_s=(t1 - t0) * 1e-6,
                busy_s=sum(b - a for a, b in busy) * 1e-6,
                kernels=kernels, idle_gaps=idle, marks=len(marks))


class StageTimer:
    """Device milliseconds of every call of each named module, between
    CUDA events recorded by its forward pre- and post-hooks."""

    def __init__(self, modules: Dict[str, torch.nn.Module]):
        self.events: Dict[str, list] = {k: [] for k in modules}
        self.handles = []
        for name, m in modules.items():
            self.handles.append(m.register_forward_pre_hook(
                self._start(name)))
            self.handles.append(m.register_forward_hook(self._end(name)))

    def _start(self, name):
        def hook(module, args):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name].append([e, None])
        return hook

    def _end(self, name):
        def hook(module, args, out):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            self.events[name][-1][1] = e
        return hook

    def close(self) -> Dict[str, List[float]]:
        """{name: [ms of each call]} (synchronizes)."""
        for h in self.handles:
            h.remove()
        torch.cuda.synchronize()
        return {k: [a.elapsed_time(b) for a, b in v]
                for k, v in self.events.items()}
