"""One training step of ``BEV_type3`` with ``add_xy`` and
``concat-atten`` (the w48 combination at test size), the port against
JAX on the CPU, under the rules of tests/test_torch_variants_train.py
(its helpers)."""

import pytest

from tests.test_torch_variants_train import (
    _check_grads,
    _check_losses,
    _check_stats,
    _run_step,
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs the train steps several times slower."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=["xy_atten"])
def step(request):
    return _run_step(request.param)


def test_variant_step_losses_match_jax(step):
    _check_losses(step)


def test_variant_step_grads_match_jax(step):
    _check_grads(step)


def test_variant_step_batch_stats_match_jax(step):
    _check_stats(step)
