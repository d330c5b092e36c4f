"""What the per-layer metric readers (``portbench/metrics/<name>.py``)
compute from a traced run's record.

The record (``Driver.record``) holds the traced slice's summary
(``lib/trace.reduce``), the number of requests it recorded and the
useful units (valid instances or pairs) they carried, the model's FLOPs
per unit (``work/flops.py``), each of the program's kernels' declared
work per request at the cell's shapes (``work/kernels.py``), the stage
times of the whole window, and the card's peaks.  A reader that finds
nothing to read returns None, and the metric is left out of the line.
"""

from __future__ import annotations

from statistics import mean
from typing import Dict, Optional

# Published dense peaks (NVIDIA's data sheet, SXM part, 700 W)
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(bf16_flops=989e12, fp32_flops=67e12,
                                  bytes=3.35e12),
}


def peaks(kind: str) -> Optional[Dict[str, float]]:
    return PEAKS.get(kind)


def launches_per_request(rec) -> Optional[float]:
    s = rec["trace"]
    if not s or not rec["requests"]:
        return None
    return sum(n for n, _ in s["kernels"].values()) / rec["requests"]


def _period(rec) -> Optional[float]:
    s = rec["trace"]
    if not s or not rec["requests"] or not s.get("period_s"):
        return None
    return s["period_s"]


def device_idle_pct(rec) -> Optional[float]:
    """The share of a request's time, at the untraced window's pace, in
    which nothing runs on the device (busy seconds a request from the
    traced slice)."""
    period = _period(rec)
    if period is None:
        return None
    return 100.0 * (1.0 - rec["trace"]["busy_s"] / rec["requests"] / period)


def mfu_pct(rec) -> Optional[float]:
    """The useful model FLOPs of a traced request over a request's time at
    the untraced window's pace, as a share of the card's bf16 peak."""
    period, pk = _period(rec), rec["peaks"]
    if period is None or not pk or not rec["units"]:
        return None
    flops = rec["units"] * rec["flops_per_unit"] / rec["requests"]
    return 100.0 * flops / period / pk["bf16_flops"]


def stage_ms(rec, stage: str) -> Optional[float]:
    ms = rec["stage_ms"].get(stage)
    return mean(ms) if ms else None


def roofline_pct(rec, kernel: str) -> Optional[float]:
    """The least time the card could take for the recorded launches of
    ``kernel`` (the larger of its declared operations over the peak of
    its arithmetic and its bytes over the memory bandwidth) over the
    launches' device time."""
    s, pk = rec["trace"], rec["peaks"]
    work = rec["kernel_work"].get(kernel)
    if not s or not pk or work is None:
        return None
    hits = [v for k, v in s["kernels"].items() if work["symbol"] in k]
    launches = sum(n for n, _ in hits)
    seconds = sum(t for _, t in hits)
    if not launches or seconds <= 0:
        return None
    peak = pk["bf16_flops" if work["tensor_cores"] else "fp32_flops"]
    per_launch = max(work["flops"] / peak, work["bytes"] / pk["bytes"]) \
        / work["launches"]
    return 100.0 * launches * per_launch / seconds
