"""Runs one cell of the port's benchmark and prints its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (imports, kernel build, seeded weights and inputs, warm-up of the
cell's shapes) is timed from the process's start to the window's start
(``setup_s``).  The window serves the cell's traffic through the
program's entry for ``--seconds`` and ends when the last request
dispatched is done.  With ``--trace 0`` the result carries the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, read from
a profiled slice of the window and from CUDA events around the model's
stages.  Once the window has closed, the peak device memory is read, the
program is freed and the plain float32 reference (``portbench/
reference``) recomputes the sampled requests: ``correct`` says whether
every compared number is within its limit.  The numbers and limits are
printed last on standard error and last in the result line.

Exits non-zero, printing no result, without enough CUDA devices, or when
``jax``, ``jaxlib``, ``flax``, ``optax``, ``orbax`` or ``snvc_tpu`` is
loaded in the process after the window: looked for when the window
closes, after the correctness check and right before the result is
printed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "snvc_tpu")


def forbidden_modules():
    """The loaded modules whose top-level name is a forbidden one."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def refuse_forbidden(when: str) -> None:
    """Exits with code 3, naming them, if forbidden modules are loaded."""
    found = forbidden_modules()
    if found:
        sys.stderr.write(f"forbidden modules loaded {when}: {found}\n")
        sys.stderr.flush()
        sys.exit(3)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card_state() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def run_cell(args, device, root: Path = ROOT, t_start: float = T_START):
    """One run of the cell on ``device``: the result line's dict, the
    compared numbers and their limits last (``checks``)."""
    import torch

    from portbench.lib import compare, readers
    from portbench.lib.cells import Cell
    from portbench.lib.trace import StageTimer, Tracer

    cell = Cell(args.workload, root)
    driver = cell.driver().Driver(cell, args.seed, device)
    driver.setup()
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start

    tracer = stages = None
    if args.trace:
        prof = cell.workload["profile"]
        tracer = Tracer(prof["skip"], prof["warmup"], prof["active"])
        stages = StageTimer(driver.stages())
        with tracer:
            stats = driver.window(args.seconds, tracer)
    else:
        stats = driver.window(args.seconds, None)

    refuse_forbidden("after the window")
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    sys.stderr.write(f"card: {card_state() if cuda else 'cpu'}\n")
    sys.stderr.write(f"memory_peak_bytes {peak}\n")
    sys.stderr.write(f"window: attempted {stats['attempted']} failed "
                     f"{stats['failed']} {json.dumps(stats['metrics'])} "
                     f"host ms a request {json.dumps(stats.get('host_ms'))}\n")

    dev_info = dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name(device) if cuda
                    else "cpu", count=1, memory_peak_bytes=int(peak))
    metrics, breakdown = {}, None
    if args.trace:
        summary = tracer.summary or {}
        if summary:
            summary["period_s"] = tracer.period_s()
        record = driver.record(tracer, stages.close(), summary,
                               readers.peaks(dev_info["kind"]))
        for m in cell.per_layer():
            v = cell.reader(m["name"])(record)
            if v is not None:
                metrics[m["name"]] = dict(value=v, unit=m["unit"])
        sys.stderr.write("trace: " + json.dumps(
            {k: v for k, v in summary.items() if k != "kernels"}) + "\n")
        if summary:
            dev_info.update(busy_s=summary["busy_s"],
                            window_s=summary["window_s"])
            top = sorted(summary["kernels"].items(),
                         key=lambda kv: -kv[1][1])[:10]
            breakdown = dict(device_ops=[[k[:160], v[1]] for k, v in top],
                             idle_gaps=summary["idle_gaps"])
    else:
        for m in cell.end_to_end():
            v = (setup_s if m["name"] == "setup_s"
                 else stats["metrics"][m["name"]])
            metrics[m["name"]] = dict(value=v, unit=m["unit"])

    checks = driver.check()
    refuse_forbidden("after the correctness check")
    result = dict(correct=compare.passed(checks),
                  attempted=stats["attempted"], failed=stats["failed"],
                  metrics=metrics, device=dev_info)
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = compare.printable(checks)
    return result


def main(argv=None):
    args = parse_args(argv)
    import torch

    # one intra-op thread: the host's work is the dispatch of one Python
    # thread, and idle pool threads only add to the host's noise
    torch.set_num_threads(1)

    from portbench.lib.cells import Cell

    chips = Cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        sys.stderr.write(f"the cell needs {chips} CUDA device(s), and this "
                         "benchmark measures only the card\n")
        sys.exit(2)
    result = run_cell(args, torch.device("cuda", 0))
    for name, c in result["checks"].items():
        sys.stderr.write(f"check {name} {c['value']!r} limit {c['limit']!r}"
                         "\n")
    sys.stderr.flush()
    refuse_forbidden("before the result")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
