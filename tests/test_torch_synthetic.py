"""The port's synthetic instance batches equal the JAX package's, bit for
bit: the same keys, dtypes and values for the same seed and config
(snvc_tpu_torch/data/synthetic.py against snvc_tpu/data/synthetic.py)."""

import numpy as np
import pytest

from snvc_tpu.config import tiny_vernier_config
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jax_batch
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from tests.torch_port_helpers import torch_vernier_config


@pytest.mark.parametrize("instances", [2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_synthetic_batch_equals_jax(seed, instances):
    jcfg = tiny_vernier_config(max_instances=instances, image_size=(128, 256))
    want = jax_batch(jcfg, seed=seed)
    got = synthetic_batch_arrays(torch_vernier_config(jcfg), seed=seed)
    assert set(got) == set(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype, k
        np.testing.assert_array_equal(got[k], w, err_msg=k)
    assert got["points_valid"].any()
