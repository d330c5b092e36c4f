"""The numbers that decide ``correct``: which requests are judged, what is
compared, and each number beside its limit.  A number decides only
where the cell's workload file gives it a limit; the others are readings
(``calibrate.py`` prints them).

Refinement, over every valid slot of the judged requests:

* ``ncf_rel``, ``occupancy_rel``: the largest relative L2 error of an
  instance's NCF maps / occupancy volume, ||got - ref|| / ||ref||;
* ``coord_err``: the largest absolute error of a normalized part
  coordinate (the coordinate head's sigmoid outputs);
* ``box_xz_m``: the largest error of a refined box's x or z (one_part
  and all_parts), in metres; ``box_ry_rad``: of all_parts' heading;
* ``keep_flips``: instances whose Filter gate (``keep``) differs;
* ``finalize_flips``: instances whose refined boxes, confidence or gate
  differ from the reference's ``finalize`` of the program's own NCF and
  coordinates (a box by more than 1 mm or 1 mrad, a confidence by more
  than 1e-5 of its size).

Every cell: ``unanswered``, the sampled requests that the window never
answered (none dispatched, or no output kept), so that a run cannot
pass by judging nothing.

Detection, over every pair of the judged requests:

* ``cls_rel``, ``reg_rel``, ``ctr_rel``, ``depth_rel``: the largest
  relative L2 error of a pair's RPN maps and depth map;
* ``proposal_flips``: the proposal slots where the program's decoded
  proposals differ from the reference's decode of the program's own RPN
  maps (validity, or a box off by more than 1 mm, or a score by more
  than 1e-5).
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np


def sample_indices(spec: Dict, requests: List[Dict], seed: int) -> set:
    """``spec["count"]`` request indices drawn from the seed among the
    first ``spec["from"]``, and with ``spec["longest"]`` the first of them
    with the most valid slots."""
    rng = np.random.default_rng([seed, 17])
    first = min(spec["from"], len(requests))
    out = set(int(i) for i in rng.choice(first, spec["count"],
                                         replace=False))
    if spec.get("longest"):
        sizes = [requests[i]["n_valid"] for i in range(first)]
        out.add(int(np.argmax(sizes)))
    return out


def _worst(a: float, b: float) -> float:
    """The larger of two errors; a NaN or infinite one is infinite."""
    return max(a, b) if math.isfinite(b) else math.inf


def _rel(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel())
                 / max(np.linalg.norm(b.ravel()), 1e-30))


def refine_numbers(items: Iterable) -> Dict[str, float]:
    """``items``: (valid mask, got outputs, reference outputs) a request,
    numpy dicts with the keys of ``finalize`` and the head."""
    n = dict(ncf_rel=0.0, occupancy_rel=0.0, coord_err=0.0, box_xz_m=0.0,
             box_ry_rad=0.0, keep_flips=0.0)
    for valid, got, ref in items:
        if any(np.shape(got[k]) != np.shape(ref[k]) for k in ref):
            return {k: math.inf for k in n}  # an output of another shape
        for j in np.flatnonzero(valid):
            n["ncf_rel"] = _worst(n["ncf_rel"], _rel(got["ncf"][j],
                                                     ref["ncf"][j]))
            n["occupancy_rel"] = _worst(n["occupancy_rel"], _rel(
                got["occupancy"][j], ref["occupancy"][j]))
            n["coord_err"] = _worst(n["coord_err"], float(np.abs(
                got["coordinates"][j] - ref["coordinates"][j]).max()))
            for k in ("one_part", "all_parts"):
                n["box_xz_m"] = _worst(n["box_xz_m"], float(np.abs(
                    got[k][j, [3, 5]] - ref[k][j, [3, 5]]).max()))
            d = got["all_parts"][j, 6] - ref["all_parts"][j, 6]
            n["box_ry_rad"] = _worst(n["box_ry_rad"], float(
                abs((d + np.pi) % (2 * np.pi) - np.pi)))
            n["keep_flips"] += float(bool(got["keep"][j])
                                     != bool(ref["keep"][j]))
    return n


def box_flips(valid, got: Dict, ref: Dict) -> float:
    """Valid slots where ``got``'s finalize outputs differ from ``ref``'s."""
    flips = 0
    for j in np.flatnonzero(valid):
        d = np.concatenate([got[k][j] - ref[k][j] for k in
                            ("one_part", "all_parts")])
        d[[6, 13]] = (d[[6, 13]] + np.pi) % (2 * np.pi) - np.pi
        conf = np.abs(got["confidence"][j] - ref["confidence"][j]) \
            > 1e-5 * np.maximum(1.0, np.abs(ref["confidence"][j]))
        flips += bool(np.abs(d).max() > 1e-3 or conf.any()
                      or bool(got["keep"][j]) != bool(ref["keep"][j]))
    return float(flips)


def detect_numbers(maps: Iterable, proposals: Iterable) -> Dict[str, float]:
    """``maps``: (got, reference) RPN map dicts a request, [pairs, ...]
    numpy; ``proposals``: (got, decoded) (boxes, scores, valid) a pair."""
    n = dict(cls_rel=0.0, reg_rel=0.0, ctr_rel=0.0, depth_rel=0.0,
             proposal_flips=0.0)
    for got, ref in maps:
        for key, k in (("cls_rel", "cls"), ("reg_rel", "reg"),
                       ("ctr_rel", "centerness"), ("depth_rel", "depth")):
            if got[k].shape != ref[k].shape:  # a pair missing or extra
                n[key] = math.inf
                continue
            for p in range(ref[k].shape[0]):
                n[key] = _worst(n[key], _rel(got[k][p], ref[k][p]))
    for (gb, gs, gv), (rb, rs, rv) in proposals:
        same_valid = gv == rv
        both = gv & rv
        close = (np.abs(gb - rb).max(-1) <= 1e-3) & (np.abs(
            np.where(both, gs - rs, 0.0)) <= 1e-5)
        n["proposal_flips"] += float((~same_valid | (both & ~close)).sum())
    return n


def passed(checks: Dict[str, Dict]) -> bool:
    """Every number finite and within its limit."""
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())


def printable(checks: Dict[str, Dict]) -> Dict[str, Dict]:
    """``checks`` with a value that is not finite as its string."""
    return {k: dict(c, value=c["value"] if math.isfinite(c["value"])
                    else str(c["value"])) for k, c in checks.items()}


def with_limits(numbers: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, Dict]:
    """{name: {"value", "limit"}} for every limited number."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"limits of numbers not compared: {missing}")
    return {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
