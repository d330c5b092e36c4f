"""Run the port's end-metric demos at their recipes on one NVIDIA GPU and
print each one's wall seconds and result beside the card.

    python3 scripts/demo_runs.py --out build/demo_runs [--steps 600]

Runs ``demo_ap_lift --steps N`` and ``demo_tracking --steps N`` (their
other flags at the defaults: 48 train frames of 3 cars, 8 val frames /
a 10-frame sequence), each in its own work directory under ``--out``,
one after the other in this process.  Prints nvidia-smi's name and power
limit, then one JSON line a demo: {"demo", "steps", "wall_s", the demo's
result}.  Needs a GPU (the demos' ``--device cuda``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from snvc_tpu_torch.tools import demo_ap_lift, demo_tracking  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default="build/demo_runs")
    p.add_argument("--steps", type=int, default=600)
    args = p.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    for name, mod in (("demo_ap_lift", demo_ap_lift),
                      ("demo_tracking", demo_tracking)):
        t = time.perf_counter()
        result = mod.main(["--steps", str(args.steps), "--work_dir",
                           os.path.join(args.out, name)])
        wall = time.perf_counter() - t
        print(json.dumps({"demo": name, "steps": args.steps,
                          "wall_s": round(wall, 2), **result}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
