"""Photometric augmentation (port of snvc_tpu/ops/augment.py; reference
snvc/utils/preprocess.py:21-179): ImageNet normalization, PCA lighting
noise and brightness / contrast / saturation jitter over NHWC float
images in [0, 1].

The transforms take their random draws as arguments, and
``draw_jitter`` makes them from a ``torch.Generator`` with JAX's
distributions: each factor 1 + U(-var, var), the order a uniform
permutation of the three, the lighting alphas N(0, 1) x ``lighting_std``.
JAX draws them from a ``jax.random`` key (``color_jitter(key, img)``),
which the port cannot reproduce, so the two packages' draw streams
differ; at equal draws the transforms agree.  They are elementwise
passes and reductions that JAX also runs outside any Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from snvc_tpu_torch.utils.device import constant

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# ImageNet PCA eigen decomposition (preprocess.py's lighting constants)
_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
_EIGVEC = np.array([[-0.5675, 0.7192, 0.4009],
                    [-0.5808, -0.0045, -0.8140],
                    [-0.5836, -0.6948, 0.4203]], np.float32)


@dataclass(frozen=True)
class Jitter:
    """One draw of ``color_jitter``: the brightness, contrast and
    saturation factors, the order their ops run in (a permutation of
    0 = brightness, 1 = contrast, 2 = saturation) and the three lighting
    alphas (already scaled by the lighting std)."""

    factors: Tuple[float, float, float]
    order: Tuple[int, int, int]
    alpha: Tuple[float, float, float]


def draw_jitter(generator: torch.Generator, brightness_var: float = 0.4,
                contrast_var: float = 0.4, saturation_var: float = 0.4,
                lighting_std: float = 0.1) -> Jitter:
    """A ``Jitter`` drawn from ``generator`` (a CPU generator: the draws
    are host numbers, so applying them needs nothing from the card)."""
    u = torch.rand(3, generator=generator, dtype=torch.float64)
    var = torch.tensor([brightness_var, contrast_var, saturation_var],
                       dtype=torch.float64)
    factors = 1.0 + (2.0 * u - 1.0) * var
    order = torch.randperm(3, generator=generator)
    alpha = torch.randn(3, generator=generator,
                        dtype=torch.float64) * lighting_std
    return Jitter(tuple(factors.tolist()), tuple(order.tolist()),
                  tuple(alpha.tolist()))


def normalize(img, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    return (img - constant(mean, img.device)) / constant(std, img.device)


def pca_lighting(img, alpha):
    """AlexNet-style PCA lighting noise: adds EIGVEC @ (alpha * EIGVAL)
    to every pixel (reference Lighting transform)."""
    shift = _EIGVEC @ (np.asarray(alpha, np.float32) * _EIGVAL)
    return img + constant(shift, img.device, img.dtype)


def brightness(img, factor: float):
    return img * factor


def contrast(img, factor: float):
    """Blends each image with its mean gray level."""
    gray = img.mean(dim=-1, keepdim=True)
    return img * factor + gray.mean(dim=(-3, -2), keepdim=True) * (1 - factor)


def saturation(img, factor: float):
    """Blends each pixel with its own gray level."""
    gray = img.mean(dim=-1, keepdim=True)
    return img * factor + gray * (1 - factor)


_OPS = (brightness, contrast, saturation)


def color_jitter(img, jitter: Jitter):
    """The three jitters in ``jitter.order``, then the lighting noise,
    clipped to [0, 1] (reference ColorJitter + Lighting; JAX fixes one
    random order per call, as here)."""
    for i in jitter.order:
        img = _OPS[i](img, jitter.factors[i])
    img = pca_lighting(img, jitter.alpha)
    return img.clamp(0.0, 1.0)
