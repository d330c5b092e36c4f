"""Offline KITTI AP evaluation (port of tools/evaluate.py).

  python -m snvc_tpu_torch.tools.evaluate GT_DIR RESULT_DIR

where RESULT_DIR holds data/XXXXXX.txt prediction files.  Prints the
AP11 / AP40 summary per class and metric, or with ``--json`` one JSON
object.
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> dict:
    """Returns the evaluator's dict."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("gt_dir")
    p.add_argument("result_dir")
    p.add_argument("--json", action="store_true", help="print JSON only")
    args = p.parse_args(argv)

    from snvc_tpu_torch.eval.kitti_ap import run_kitti_eval

    res = run_kitti_eval(args.gt_dir, args.result_dir)
    if args.json:
        print(json.dumps(res))
        return res
    for cls, metrics in res.items():
        for metric, vals in metrics.items():
            a11 = " ".join(f"{v:6.2f}" for v in vals["ap11"])
            a40 = " ".join(f"{v:6.2f}" for v in vals["ap40"])
            print(f"{cls:10s} {metric:18s} AP11 [{a11}]  AP40 [{a40}]")
    return res


if __name__ == "__main__":
    main()
