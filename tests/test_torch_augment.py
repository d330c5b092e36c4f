"""The photometric augmentation of the port (snvc_tpu_torch/ops/augment.py,
training/train_stereo.augment_normalize) against JAX's
(snvc_tpu/ops/augment.py), float32 on the CPU.

JAX draws the jitter from a ``jax.random`` key; the port takes the draws
as arguments.  So each case computes JAX's draws from ``PRNGKey(k)`` in
JAX's own split order (``color_jitter``: k1..k5 = split(key, 5), the
order from k5) and hands them to the port; the images then agree to
1e-6 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.ops import augment as jaug
from snvc_tpu_torch.config import tiny_stereo_config
from snvc_tpu_torch.ops import augment as taug
from snvc_tpu_torch.training.train_stereo import augment_normalize

ATOL = 1e-6


def _image(seed, shape=(2, 24, 40, 3)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


def _jax_draws(k: int) -> taug.Jitter:
    """The draws of JAX's ``color_jitter(PRNGKey(k), img)``."""
    k1, k2, k3, k4, k5 = jax.random.split(jax.random.PRNGKey(k), 5)
    factors = [1.0 + jax.random.uniform(kk, (), minval=-0.4, maxval=0.4)
               for kk in (k1, k2, k3)]
    order = jax.random.permutation(k5, 3)
    alpha = jax.random.normal(k4, (3,)) * 0.1
    return taug.Jitter(tuple(float(f) for f in factors),
                       tuple(int(i) for i in order),
                       tuple(float(a) for a in alpha))


@pytest.mark.parametrize("k", [0, 1, 7])
def test_each_transform_matches_jax(k):
    img = _image(k)
    x = torch.from_numpy(img)
    d = _jax_draws(k)
    k1, k2, k3, k4, _ = jax.random.split(jax.random.PRNGKey(k), 5)
    ji = jnp.asarray(img)
    cases = {
        "normalize": (jaug.normalize(ji), taug.normalize(x)),
        "brightness": (jaug.brightness(k1, ji),
                       taug.brightness(x, d.factors[0])),
        "contrast": (jaug.contrast(k2, ji), taug.contrast(x, d.factors[1])),
        "saturation": (jaug.saturation(k3, ji),
                       taug.saturation(x, d.factors[2])),
        "pca_lighting": (jaug.pca_lighting(k4, ji),
                         taug.pca_lighting(x, d.alpha)),
    }
    for name, (want, got) in cases.items():
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize("k", [0, 1, 2, 3, 11])
def test_color_jitter_matches_jax(k):
    img = _image(100 + k)
    want = jaug.color_jitter(jax.random.PRNGKey(k), jnp.asarray(img))
    got = taug.color_jitter(torch.from_numpy(img), _jax_draws(k))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0


def test_augment_normalize_draws_once_for_both_views():
    """With ``photometric_aug`` both views get the step's one draw (equal
    views stay equal); the draw is ``draw_jitter`` of a generator seeded
    by the step; without it the views are only normalized."""
    rng = np.random.default_rng(5)
    u8 = torch.from_numpy(rng.integers(0, 256, (1, 16, 24, 3), np.uint8))
    other = torch.from_numpy(rng.integers(0, 256, (1, 16, 24, 3), np.uint8))
    on = tiny_stereo_config(photometric_aug=True)
    for step in (0, 3):
        left, right = augment_normalize(u8, u8.clone(), on, step)
        assert torch.equal(left, right)
        jit = taug.draw_jitter(torch.Generator().manual_seed(step))
        want = taug.normalize(taug.color_jitter(other.float() / 255.0, jit))
        _, got = augment_normalize(u8, other, on, step)
        assert torch.equal(got, want)
    a, _ = augment_normalize(u8, u8, on, 0)
    b, _ = augment_normalize(u8, u8, on, 1)
    assert not torch.equal(a, b)  # a new draw each step
    plain, _ = augment_normalize(u8, u8, tiny_stereo_config(), 0)
    assert torch.equal(plain, taug.normalize(u8.float() / 255.0))


def test_draw_jitter_is_seeded_and_in_range():
    a = taug.draw_jitter(torch.Generator().manual_seed(4))
    b = taug.draw_jitter(torch.Generator().manual_seed(4))
    assert a == b
    assert a != taug.draw_jitter(torch.Generator().manual_seed(5))
    draws = [taug.draw_jitter(torch.Generator().manual_seed(s))
             for s in range(400)]
    f = np.array([d.factors for d in draws])
    alpha = np.array([d.alpha for d in draws])
    assert ((f >= 0.6) & (f <= 1.4)).all()
    # U(0.6, 1.4): mean 1, std 0.8 / sqrt(12) = 0.231; alphas N(0, 0.1)
    np.testing.assert_allclose(f.mean(0), 1.0, atol=0.04)
    np.testing.assert_allclose(f.std(0), 0.231, atol=0.03)
    np.testing.assert_allclose(alpha.std(0), 0.1, atol=0.015)
    assert all(sorted(d.order) == [0, 1, 2] for d in draws)
    assert len({d.order for d in draws}) == 6  # every order occurs
