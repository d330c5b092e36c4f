"""JAX (Flax) variables -> the port's ``state_dict``.

Takes the plain nested dict of numpy arrays that a Flax model's
``variables`` hold (``{"params": ..., "batch_stats": ...}``) and returns a
flat ``{name: torch.Tensor}`` that ``VernierScale.load_state_dict`` takes
with ``strict=True``.  No JAX import: the caller converts its arrays with
``np.asarray`` first.

The port's modules are named after the Flax modules, so a Flax path
``head/ConvNorm3d_1/Conv3d_0/kernel`` becomes
``head.ConvNorm3d_1.Conv3d_0.weight``.  Leaves:

  * conv kernels [kh, kw, I, O] / [kd, kh, kw, I, O] -> [O, I, k...];
  * transposed-conv kernels (any path through ``ConvTranspose``): Flax
    stores the spatially flipped torch kernel, so flip, then [I, O, k...];
  * Dense kernels [I, O] -> [O, I];
  * norm ``scale`` -> ``weight``; ``bias`` -> ``bias``;
  * ``batch_stats`` ``mean`` / ``var`` -> ``running_mean`` / ``running_var``.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch


def _walk(tree: Mapping, path=()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _kernel(path, w: np.ndarray) -> np.ndarray:
    nd = w.ndim
    if nd == 2:  # Dense [I, O]
        return w.T
    spatial = tuple(range(nd - 2))
    if any("ConvTranspose" in p for p in path):
        w = np.flip(w, axis=spatial)
        return np.transpose(w, (nd - 2, nd - 1) + spatial)
    return np.transpose(w, (nd - 1, nd - 2) + spatial)


_PARAM_LEAF = {"scale": "weight", "bias": "bias", "kernel": "weight"}
_STAT_LEAF = {"mean": "running_mean", "var": "running_var"}


def convert_variables(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ``{"params", "batch_stats"}`` -> port ``state_dict``."""
    out = {}
    for col, leaves in (("params", _PARAM_LEAF), ("batch_stats", _STAT_LEAF)):
        for path, w in _walk(variables.get(col, {})):
            leaf = path[-1]
            if leaf not in leaves:
                raise KeyError(f"unexpected {col} leaf {'/'.join(path)}")
            if leaf == "kernel":
                w = _kernel(path, w)
            name = ".".join(path[:-1] + (leaves[leaf],))
            # np.array copies: a float32 leaf that is already contiguous
            # (a read-only checkpoint buffer) is not shared with the result
            out[name] = torch.from_numpy(np.array(w, np.float32))
    return out
