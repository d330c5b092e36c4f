"""The traced slice's reduction (``lib/trace.reduce``) and the readers
over it, on a made-up trace, and the bfloat16 witnesses' rounding."""

import pytest
import torch

from portbench.lib import readers, trace


def _x(name, cat, ts, dur):
    return dict(ph="X", name=name, cat=cat, ts=ts, dur=dur)


def _events():
    # marks at 100 (opens the slice), 300 / 300 (a step boundary), 500
    ev = [_x(trace.MARK, "cuda_runtime", t, 1) for t in (100, 300, 301, 500)]
    ev += [
        _x("before_k", "kernel", 40, 100),       # runs into the window
        _x("k_a", "kernel", 150, 50),
        _x("cudaMalloc", "cuda_runtime", 210, 30),
        _x("k_b", "kernel", 250, 100),
        _x("copy", "gpu_memcpy", 340, 20),
        _x("k_a", "kernel", 420, 40),
        _x("after_k", "kernel", 480, 100),       # starts in, ends after
        _x("late_k", "kernel", 600, 10),         # after the window
    ]
    return ev


def test_window_and_busy_from_the_marks():
    s = trace.reduce(_events())
    assert s["marks"] == 4
    assert s["window_s"] == pytest.approx(400e-6)
    # [100,140] + [150,200] + [250,360] + [420,460] + [480,500]
    assert s["busy_s"] == pytest.approx(260e-6)
    assert s["kernels"] == {"k_a": [2, pytest.approx(90e-6)],
                            "k_b": [1, pytest.approx(100e-6)],
                            "after_k": [1, pytest.approx(100e-6)]}


def test_idle_gaps_named_by_the_host_call_or_the_next_op():
    gaps = dict((round(d * 1e6), n) for n, d in trace.reduce(_events())
                ["idle_gaps"])
    assert gaps == {60: "host, before k_a", 50: "cudaMalloc",
                    10: "host, before k_a", 20: "host, before after_k"}


def test_no_marks_reads_nothing():
    ev = [e for e in _events() if e["name"] != trace.MARK]
    s = trace.reduce(ev)
    assert s == {}
    rec = dict(trace=s, requests=2, units=16, flops_per_unit=1e9,
               peaks=readers.peaks("NVIDIA H100 80GB HBM3"), kernel_work={})
    assert readers.device_idle_pct(rec) is None
    assert readers.mfu_pct(rec) is None
    assert readers.launches_per_request(rec) is None


def test_readers_on_the_slice():
    s = trace.reduce(_events())
    rec = dict(trace=s, requests=2, units=16, flops_per_unit=1e9,
               peaks=readers.peaks("NVIDIA H100 80GB HBM3"),
               kernel_work=dict(K=dict(symbol="k_a", flops=4e6, bytes=0.0,
                                       launches=1, tensor_cores=True)))
    # no pace of the untraced window: no idle share, no mfu
    assert readers.device_idle_pct(rec) is None
    assert readers.mfu_pct(rec) is None
    # 130 us busy a request; a request takes 200 us untraced
    s["period_s"] = 200e-6
    assert readers.device_idle_pct(rec) == pytest.approx(35.0)
    assert readers.mfu_pct(rec) == pytest.approx(
        100 * 8e9 / 200e-6 / 989e12)
    s["period_s"] = 260e-6
    assert readers.device_idle_pct(rec) == pytest.approx(50.0)
    assert readers.launches_per_request(rec) == pytest.approx(2.0)
    assert readers.roofline_pct(rec, "K") == pytest.approx(
        100 * 2 * (4e6 / 989e12) / 90e-6)


@pytest.mark.parametrize("precision", ["bf16", "bf16_act"])
def test_witness_rounds_where_it_says(precision):
    from portbench.reference import layers

    torch.manual_seed(0)
    m = layers.ConvNorm(8, 32, 3)
    for p in m.parameters():
        torch.nn.init.normal_(p)
    layers.set_precision(m, precision)
    x = torch.randn(1, 6, 6, 8)
    inner = {}
    m.Conv_0.register_forward_hook(
        lambda mod, a, out: inner.update(conv=out))
    y = m(x)
    rounded = [bool((t == t.bfloat16().float()).all())
               for t in (inner["conv"], y)]
    assert rounded == ([True, True] if precision == "bf16_act"
                       else [False, False])


class _Event:
    def __init__(self, t):
        self.t = t

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return other.t - self.t


def test_pace_is_taken_before_the_profiler_starts():
    tr = trace.Tracer.__new__(trace.Tracer)
    tr.skip, tr.first, tr.active = 8, 10, 8
    # 100 ms a request before the warm-up starts, 150 ms from then on
    ts = [100.0 * k for k in range(8)]
    ts += [ts[-1] + 150.0 * k for k in range(1, 30)]
    tr.bounds = [_Event(t) for t in ts]
    assert tr.period_s() == pytest.approx(0.1)
    tr.skip = 3
    assert tr.period_s() is None
