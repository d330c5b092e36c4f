"""Readings that the correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n,n,...> [--precision float32|fp8|bf16|bf16_act]

In one process (the kernels built once), for each seed: the cell's
set-up, a window of ``--seconds`` at the cell's own load, and the
compared numbers of the sampled requests: the program against the
float32 reference, or the reference rounded to float8 (the control,
``reference/layers.fp8_round``) or to bfloat16 (a witness: ``bf16`` at
the convolutions' inputs and weights, ``bf16_act`` at every module's
outputs as well) in the program's place.  One
JSON line a seed, then the largest reading of each number.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", required=True)
    p.add_argument("--precision", default="float32",
                   choices=("float32", "fp8", "bf16", "bf16_act"),
                   help="float32: the program; fp8: the control; bf16, "
                   "bf16_act: the reference rounded to bfloat16 at the "
                   "convolutions, and at every module's outputs too, "
                   "witnesses of what the program's own precision gives")
    args = p.parse_args(argv)
    import torch

    from portbench.lib.cells import Cell

    device = torch.device("cuda", 0)
    cell = Cell(args.workload)
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        driver = cell.driver().Driver(cell, seed, device)
        driver.setup()
        stats = driver.window(args.seconds, None)
        t_ref = time.perf_counter()
        nums = driver.numbers(args.precision)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, v), v)
        print(json.dumps(dict(seed=seed, precision=args.precision,
                              attempted=stats["attempted"],
                              reference_s=time.perf_counter() - t_ref,
                              run_s=time.perf_counter() - t, numbers=nums)),
              flush=True)
        del driver
        torch.cuda.empty_cache()
    print(json.dumps(dict(worst=worst)), flush=True)


if __name__ == "__main__":
    main()
