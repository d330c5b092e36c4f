"""The benchmark's seeded weights, made on the device in one draw.

One standard-normal draw covers every floating leaf of a model's
``state_dict`` (in the order of their names), from a ``torch.Generator`` on the device
seeded with the run's seed.  Each leaf takes its slice as:

* a conv / linear weight (2 or more axes): LeCun normal, ``z /
  sqrt(fan_in)``, times the configuration's ``weights.scale`` entry for
  that leaf (default 1);
* a norm's scale (a 1-axis ``weight``): ``1 + 0.1 z``;
* a bias or a running mean: ``0.1 z``;
* a running variance: ``exp(0.2 z)``.

The same seed gives the same values to the program's model and to the
reference, whose leaves carry the same names.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping

import torch


def fan_in(name: str, shape) -> int:
    """Inputs feeding one output of a weight of ``shape`` (a transposed
    conv stores [I, O, k...])."""
    if "ConvTranspose" in name:
        return shape[0] * math.prod(shape[2:])
    return math.prod(shape[1:])


def make_weights(shapes: Mapping[str, torch.Size], seed: int, device,
                 scale: Mapping[str, float] = None) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor on ``device``} for the floating leaves
    ``shapes`` (a ``state_dict``'s names and shapes, in order)."""
    scale = scale or {}
    gen = torch.Generator(device=device).manual_seed(seed % (2 ** 63))
    total = sum(math.prod(s) for s in shapes.values())
    z = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in sorted(shapes.items()):
        n = math.prod(shape)
        v = z[at:at + n].view(shape)
        at += n
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "weight" and len(shape) >= 2:
            v = v * (scale.get(name, 1.0) / math.sqrt(fan_in(name, shape)))
        elif leaf == "weight":
            v = 1.0 + 0.1 * v
        elif leaf == "running_var":
            v = torch.exp(0.2 * v)
        elif leaf in ("bias", "running_mean"):
            v = 0.1 * v
        else:
            raise ValueError(f"no rule for leaf {name}")
        out[name] = v
    return out


def float_shapes(model: torch.nn.Module) -> Dict[str, torch.Size]:
    return {k: v.shape for k, v in model.state_dict().items()
            if v.is_floating_point()}


def load(model: torch.nn.Module, weights: Mapping[str, torch.Tensor]):
    """Copy ``weights`` into ``model``'s leaves (every floating leaf must
    be given)."""
    sd = model.state_dict()
    missing = [k for k, v in sd.items()
               if v.is_floating_point() and k not in weights]
    if missing:
        raise KeyError(f"no weights for {missing[:4]}")
    with torch.no_grad():
        for k, v in weights.items():
            sd[k].copy_(v)
