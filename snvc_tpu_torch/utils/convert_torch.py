"""The reference's PyTorch checkpoints -> the port's ``state_dict`` (port of
snvc_tpu/utils/convert_torch.py).

The reference distributes a trained VernierScale as a torch ``.tar`` with a
``state_dict`` (docs/INFERENCE.md:9-12, ``epoch_80.tar``: hrnet-w48,
BEV_type3).  Its modules group by attribute (``feat_net``, ``vimg_feat``,
``conv1`` ... ``hm2``, ``coord_head``, ``bbox_head``) and are numbered
inside a group by ``nn.Sequential``; the port names its modules after
Flax's (``encoder.HRNet_0``, ``head.ConvNorm3d_1`` ...).  So, as in JAX,
each reference group is routed onto its own children of the port's model
(``vernier_group_map``), and inside a group the tensors are aligned
greedily with a shape check: each target leaf, in module-creation order,
takes the first unused reference tensor of its kind (``.weight`` of a
conv or linear layer, ``.weight`` of a norm, ``.bias``, ``.running_mean``,
``.running_var``) whose shape matches, parameters first, then statistics.

The targets' order is the port's ``state_dict()`` order, split into
parameters and statistics: the port registers each module's children in
the order Flax creates them (``tests/test_torch_convert_torch.py`` holds it
to JAX's ``abstract_init`` order at the tiny, the deep-hourglass and the
multi-module HRNet configs, with GroupNorm and with BatchNorm).  Under ``cfg.remat`` JAX's
lifted 3D hourglass lists a GroupNorm's bias before its scale, which
changes no pairing: the two take tensors of different kinds.

JAX's layout converters (``conv2d_kernel`` ... ``dense_kernel``, the
deconvolution flips), ``abstract_init`` and ``torchify_shape`` exist to
reach Flax's layouts and have no counterpart: both sides here are torch.
A 2-D weight whose shape is the target's transposed is taken transposed,
as JAX's converter, which tries both orientations, ends up taking it.
What stays is the ``conv5`` input-channel permutation: the reference packs
the pooled BEV voxel as ``f * H + h`` (vernier.py:434-436), the port as
``h * C + c``, as JAX does.  ``num_batches_tracked`` is dropped.

Host code on numpy and torch CPU tensors: the result is loaded into a model
on any device with ``load_state_dict(strict=True)``.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

# the reference's groups, in the order JAX converts them
# (snvc/models/vernier.py:26-56, 249-313)
_GROUPS = (
    "vimg_feat",
    "conv1",
    "conv2",
    "conv3",
    "conv4",
    "hg_conv3d",
    "fg_cls_head",
    "part_reg_head",
    "conv5",
    "hm1",
    "hm2",
    "coord_head",
    "bbox_head",
    "feat_net",
)
_PARAM_LEAVES = ("weight", "bias")
_STAT_LEAVES = ("running_mean", "running_var")


def _sort_key(name: str):
    """Auto-names numerically (Conv_2 < Conv_10), as JAX sorts them."""
    head, _, tail = name.rpartition("_")
    if head and tail.isdigit():
        return (head, int(tail))
    return (name, -1)


def _children(target: Mapping, root: str) -> List[str]:
    """The child module names under ``root`` of a port ``state_dict``,
    sorted as JAX sorts a Flax tree's keys."""
    names = {k.split(".")[1] for k in target if k.split(".")[0] == root}
    return sorted(names, key=_sort_key)


def vernier_group_map(target: Mapping, use_part_reg_head: bool,
                      use_bbox_head: bool) -> Dict[str, List[Tuple[str, str]]]:
    """Reference prefix -> the port's (root, child) modules of the BEV_type3
    VernierScale whose ``state_dict`` is ``target`` (JAX
    convert_torch.py:294).  The 3D hourglass sorts first: a rematerialized
    one is named ``Checkpoint...``, and otherwise it is created before the
    2D one."""
    head = _children(target, "head")
    cn3 = [k for k in head if k.startswith("ConvNorm3d_")]
    c3 = [k for k in head if k.startswith("Conv3d_")]
    hgs = [k for k in head if "Hourglass" in k]
    n_expected = 6 + (1 if use_part_reg_head else 0)
    if len(cn3) != n_expected or len(hgs) != 2:
        raise ValueError(
            f"not a BEV_type3 head with part_reg={use_part_reg_head}: "
            f"ConvNorm3d {cn3}, hourglasses {hgs}")

    def first(prefix):
        return [k for k in head if k.startswith(prefix)][0]

    m = {
        "feat_net": [("encoder", [k for k in _children(target, "encoder")
                                  if k.startswith("HRNet")][0])],
        "vimg_feat": [("head", cn3[0])],
        "conv1": [("head", cn3[1])],
        "conv2": [("head", cn3[2])],
        "conv3": [("head", cn3[3])],
        "hg_conv3d": [("head", hgs[0])],
        "fg_cls_head": [("head", cn3[4]), ("head", c3[0])],
        "conv4": [("head", cn3[-1])],
        "conv5": [("head", first("ConvNorm_"))],
        "hm1": [("head", hgs[1])],
        "hm2": [("head", first("Conv_"))],
    }
    if use_part_reg_head:
        m["part_reg_head"] = [("head", cn3[5]), ("head", c3[1])]
    if any(k.startswith("CoordHead") for k in head):
        m["coord_head"] = [("head", first("CoordHead"))]
    if use_bbox_head:
        m["bbox_head"] = [("head", first("FCModel"))]
    return m


def leaf_keys(target: Mapping, prefixes) -> Tuple[list, list]:
    """(parameter keys, statistic keys) of a port ``state_dict`` under the
    module prefixes ``prefixes`` (``"head.Conv_0."``; ``""`` for all), in
    ``state_dict`` order, parameters of every module before statistics:
    the targets of ``convert_module``."""
    params, stats = [], []
    for pre in prefixes:
        for k in target:
            if not k.startswith(pre):
                continue
            leaf = k.rpartition(".")[2]
            if leaf in _PARAM_LEAVES:
                params.append(k)
            elif leaf in _STAT_LEAVES:
                stats.append(k)
            elif leaf != "num_batches_tracked":
                raise KeyError(f"unexpected leaf {k}")
    return params, stats


def _kind(key: str, ndim: int) -> str:
    """A leaf's kind: which reference tensors it may take."""
    leaf = key.rpartition(".")[2]
    if leaf == "weight":
        return "kernel" if ndim > 1 else "scale"
    return leaf


def _accepts(kind: str, name: str, w: np.ndarray) -> bool:
    if kind in ("kernel", "scale"):
        ok = name.endswith(".weight") or name == "weight"
        return ok and (kind == "kernel" or w.ndim == 1)
    if kind == "bias":
        return name.endswith(".bias") or name == "bias"
    return name.endswith("." + kind)


def _fit(w: np.ndarray, shape) -> Optional[np.ndarray]:
    """``w`` in the target's ``shape``, or None: as it is, or a 2-D weight
    transposed."""
    if w.shape == shape:
        return w
    if w.ndim == 2 and w.T.shape == shape:
        return w.T
    return None


def convert_module(state_dict: Mapping[str, np.ndarray], target: Mapping,
                   keys: List[str]) -> Dict[str, np.ndarray]:
    """Greedy in-order alignment of reference tensors onto the target leaves
    ``keys`` (JAX ``convert_module``): each leaf takes the first unused
    tensor of its kind and shape.  Raises if a leaf finds none."""
    items = list(state_dict.items())
    used = [False] * len(items)
    out = {}
    for key in keys:
        shape = tuple(target[key].shape)
        kind = _kind(key, len(shape))
        for i, (name, w) in enumerate(items):
            if used[i] or not _accepts(kind, name, w):
                continue
            got = _fit(w, shape)
            if got is not None:
                used[i] = True
                out[key] = got
                break
        else:
            raise ValueError(f"no reference tensor for {key} {shape}")
    return out


def _permute_conv5_inputs(conv5: Dict[str, np.ndarray],
                          target: Mapping, gm) -> None:
    """Reorder the converted conv5 kernel's input channels from the
    reference's BEV packing (f * H + h) to the port's (h * C + c)."""
    (root, child), = gm["vimg_feat"]
    vimg = [k for k in target if k.startswith(f"{root}.{child}.")
            and target[k].ndim == 5][0]
    dim = target[vimg].shape[0]
    for k, w in conv5.items():
        if w.ndim != 4:
            continue
        cout, cin, kh, kw = w.shape
        H = cin // dim
        if H * dim != cin:
            raise ValueError(f"conv5 input width {cin} is not a multiple "
                             f"of the voxel width {dim}")
        conv5[k] = np.ascontiguousarray(
            w.reshape(cout, dim, H, kh, kw).transpose(0, 2, 1, 3, 4)
        ).reshape(cout, cin, kh, kw)


def convert_vernier_checkpoint(state_dict: Mapping[str, np.ndarray],
                               target: Mapping,
                               use_part_reg_head: bool = False,
                               use_bbox_head: bool = False
                               ) -> Dict[str, torch.Tensor]:
    """A reference VernierScale checkpoint (epoch_80-style ``state_dict`` of
    numpy arrays) -> the port's ``state_dict`` for the model whose
    ``state_dict()`` is ``target`` (only its shapes are read).  Raises on a
    group with no tensors, on a group whose tensor count differs from its
    targets', on a target no tensor fits and on a tensor no group takes:
    nothing is left unmatched on either side."""
    gm = vernier_group_map(target, use_part_reg_head, use_bbox_head)
    got: Dict[str, np.ndarray] = {}
    for prefix in _GROUPS:
        if prefix not in gm:
            continue
        sub = {k[len(prefix) + 1:]: np.asarray(v)
               for k, v in state_dict.items()
               if k.startswith(prefix + ".")
               and not k.endswith("num_batches_tracked")}
        if not sub:
            raise ValueError(f"checkpoint has no tensors under '{prefix}.'")
        params, stats = leaf_keys(
            target, [f"{root}.{child}." for root, child in gm[prefix]])
        conv = convert_module(sub, target, params + stats)
        if prefix == "conv5":
            _permute_conv5_inputs(conv, target, gm)
        if len(conv) != len(sub):
            raise ValueError(
                f"group '{prefix}': {len(sub)} reference tensors but "
                f"{len(conv)} targets: unconsumed tensors in the group")
        got.update(conv)
    extra = [k for k in state_dict
             if not any(k.startswith(p + ".") for p in gm)]
    if extra:
        raise ValueError(f"unrouted reference tensors: {extra[:8]} "
                         f"({len(extra)} in all)")
    missing = [k for k in target if k not in got
               and not k.endswith("num_batches_tracked")]
    if missing:
        raise ValueError(f"no reference group fills {missing[:8]}")
    # np.array copies: the result shares nothing with the checkpoint
    return {k: torch.from_numpy(np.array(got[k], np.float32))
            for k in target if k in got}


def fabricate_vernier_state_dict(target: Mapping,
                                 use_part_reg_head: bool = False,
                                 use_bbox_head: bool = False,
                                 rng: Optional[np.random.Generator] = None
                                 ) -> Dict[str, np.ndarray]:
    """A random state_dict shaped like a release checkpoint for the port
    model whose ``state_dict()`` is ``target`` (JAX
    convert_torch.py:510): the reference's grouping and key suffixes,
    torch layouts, each group's parameters then its statistics module by
    module, the same draws as JAX's for the same ``rng``.  Exercises the
    convert -> refine -> evaluate harness (``tools/validate_epoch80
    --selftest``) without the real epoch_80.tar."""
    rng = rng or np.random.default_rng(0)
    gm = vernier_group_map(target, use_part_reg_head, use_bbox_head)
    suffix = {"kernel": "weight", "scale": "weight", "bias": "bias",
              "running_mean": "running_mean", "running_var": "running_var"}
    sd: Dict[str, np.ndarray] = {}
    for prefix, paths in gm.items():
        j = 0
        for root, child in paths:
            params, stats = leaf_keys(target, [f"{root}.{child}."])
            for k in params:
                shape = tuple(target[k].shape)
                sd[f"{prefix}.{j}.{suffix[_kind(k, len(shape))]}"] = (
                    rng.standard_normal(shape).astype(np.float32) * 0.05)
                j += 1
            for k in stats:
                base = 1.0 if k.endswith("running_var") else 0.0
                sd[f"{prefix}.{j}.{suffix[_kind(k, 1)]}"] = (
                    base + rng.standard_normal(tuple(target[k].shape))
                    .astype(np.float32) * 0.01)
                j += 1
    return sd


def load_torch_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """A reference-style torch ``.tar`` checkpoint's ``state_dict`` (or the
    file's top-level dict) as numpy.  Read with ``weights_only=True``:
    tensors, numbers, strings and containers load, and a file that
    pickles anything else is refused rather than unpickled (JAX's reader
    unpickles it all)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("state_dict", ckpt)
    return {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
