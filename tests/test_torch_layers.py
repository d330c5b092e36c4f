"""Layer-by-layer parity of the PyTorch port (snvc_tpu_torch/models/layers.py)
against the Flax modules of snvc_tpu/models/layers.py.

Inputs and parameters come from numpy with a fixed seed; the JAX side runs
on the CPU.  Both sides compute in float32, so the tolerance is float32
summation-order noise (atol 1e-4 on outputs of order 1-10).
"""

import jax
import numpy as np
import pytest
import torch

from snvc_tpu.models import layers as jl
from snvc_tpu_torch.models import layers as tl
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables

ATOL = 1e-4


def _run_both(jmod, tmod, *inputs, seed=0):
    """Apply the Flax module (jitted) and the torch module (after loading
    the converted variables, strict) to the same numpy inputs."""
    v = random_variables(jmod, *inputs, seed=seed)
    want = jax.jit(jmod.apply)(v, *inputs)
    tmod.load_state_dict(convert_variables(v), strict=True)
    tmod.eval()
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in inputs))
    return want, got


def _close(want, got, atol=ATOL):
    w = np.asarray(want)
    g = got.numpy()
    assert g.shape == w.shape, (g.shape, w.shape)
    np.testing.assert_allclose(g, w, atol=atol, rtol=1e-4)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("shape,groups", [((2, 5, 6, 7, 16), 4),
                                          ((2, 9, 8, 12), 32)])
def test_fast_group_norm(shape, groups):
    C = shape[-1]
    g = jl._norm_groups(groups, C)
    x = _x(shape) * 3.0 + 1.0
    want, got = _run_both(jl.FastGroupNorm(groups=g),
                          tl.FastGroupNorm(C, g), x)
    _close(want, got)


@pytest.mark.parametrize("hw,stride,kernel,dil,gn", [
    ((9, 11), 1, 3, 1, True),
    ((8, 10), 2, 3, 1, True),   # even input, stride 2: torch-symmetric pad
    ((9, 7), 2, 3, 1, False),   # odd input, stride 2, BatchNorm
    ((8, 8), 1, 3, 2, True),    # dilation
])
def test_conv_norm(hw, stride, kernel, dil, gn):
    x = _x((2,) + hw + (8,))
    want, got = _run_both(
        jl.ConvNorm(16, kernel, stride, dil, gn=gn, groups=4),
        tl.ConvNorm(8, 16, kernel, stride, dil, gn=gn, groups=4), x)
    _close(want, got)


@pytest.mark.parametrize("dhw,stride,kernel,dil", [
    ((6, 9, 7), 1, 3, 1),
    ((8, 8, 10), 2, 3, 1),      # even, stride 2
    ((7, 9, 5), 2, 3, 1),       # odd, stride 2
    ((5, 6, 7), (2, 1, 1), 3, 1),
    ((9, 8, 8), 1, 5, 2),       # large-tap shape: goes through K2's plain path
    ((7, 6, 6), 1, 7, 1),
])
def test_conv_norm_3d(dhw, stride, kernel, dil):
    x = _x((2,) + dhw + (8,))
    want, got = _run_both(
        jl.ConvNorm3d(16, kernel, stride, dil, groups=4),
        tl.ConvNorm3d(8, 16, kernel, stride, dil, groups=4), x)
    _close(want, got)


def test_conv3d_bias():
    x = _x((1, 5, 6, 7, 8))
    want, got = _run_both(jl.Conv3d(4, (3, 3, 3), use_bias=True),
                          tl.Conv3d(8, 4, (3, 3, 3), use_bias=True), x)
    _close(want, got)


@pytest.mark.parametrize("dhw", [(3, 4, 5), (4, 4, 4)])
def test_conv_transpose_3d_fast(dhw):
    """The port stores torch's ConvTranspose3d weight; the converter flips
    the Flax kernel.  Same output as the 8 parity sub-convs."""
    x = _x((2,) + dhw + (8,))
    j = jl.ConvTranspose3dFast(6)
    v = random_variables(j, x)
    want = jax.jit(j.apply)(v, x)
    # the converter recognises a deconv kernel by its ConvTranspose path
    sd = convert_variables({"params": {"ConvTranspose_0": v["params"]}})
    t = tl.ConvTranspose3dFast(8, 6)
    t.load_state_dict({"weight": sd["ConvTranspose_0.weight"]}, strict=True)
    with torch.no_grad():
        got = t(torch.from_numpy(x))
    _close(want, got)


@pytest.mark.parametrize("ndim", [2, 3])
def test_deconv_norm(ndim):
    x = _x((2, 5, 6, 8) if ndim == 2 else (2, 3, 5, 4, 8))
    want, got = _run_both(jl.DeconvNorm(16, ndim=ndim),
                          tl.DeconvNorm(8, 16, ndim=ndim), x)
    _close(want, got)


@pytest.mark.parametrize("stride,cin", [(1, 8), (2, 8), (1, 16)])
def test_res_block_2d(stride, cin):
    x = _x((2, 8, 8, cin))
    want, got = _run_both(jl.ResBlock2d(16, stride), tl.ResBlock2d(cin, 16, stride), x)
    _close(want, got)


@pytest.mark.parametrize("ndim", [2, 3])
def test_hourglass(ndim):
    shape = (2, 8, 8, 8, 8) if ndim == 3 else (2, 8, 12, 16)
    x = _x(shape)
    j = jl.Hourglass(shape[-1], ndim=ndim)
    v = random_variables(j, x)
    want = jax.jit(j.apply)(v, x)[0]
    t = tl.Hourglass(shape[-1], ndim=ndim)
    t.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = t(torch.from_numpy(x))[0]
    _close(want, got)


@pytest.mark.parametrize("ndim,spatial", [(3, (16, 16, 16)), (3, (9, 16, 12)),
                                          (2, (32, 32)), (2, (20, 18))])
def test_hourglass_deep(ndim, spatial):
    """Includes sizes that are not multiples of 16: the upsample is cropped
    to the skip extent, as in JAX."""
    x = _x((1,) + spatial + (8,))
    want, got = _run_both(jl.HourglassDeep(8, ndim=ndim),
                          tl.HourglassDeep(8, ndim=ndim), x)
    _close(want, got, atol=2e-4)


def test_avg_pool_height_and_pixel_shuffle():
    x = _x((2, 8, 3, 4, 5))
    np.testing.assert_allclose(
        tl.avg_pool_height(torch.from_numpy(x), 4).numpy(),
        np.asarray(jl.avg_pool_height(x, 4)), atol=1e-6)
    y = _x((2, 3, 4, 16))
    np.testing.assert_allclose(
        tl.pixel_shuffle_2d(torch.from_numpy(y), 2).numpy(),
        np.asarray(jl.pixel_shuffle_2d(y, 2)), atol=0)


def test_fc_model():
    from snvc_tpu.models.fc_model import FCModel as JFC
    from snvc_tpu_torch.models.fc_model import FCModel as TFC

    x = _x((4, 18))
    want, got = _run_both(JFC(num_blocks=1, num_neurons=32, output_size=5),
                          TFC(18, num_neurons=32, num_blocks=1, output_size=5), x)
    _close(want, got)


def _run_both_bf16(jmod, tmod, x):
    """As ``_run_both`` with bfloat16 activations on both sides (float32
    parameters, as the models keep them)."""
    import jax.numpy as jnp

    xb = jnp.asarray(x, jnp.bfloat16)
    v = random_variables(jmod, xb)
    want = np.asarray(jax.jit(jmod.apply)(v, xb).astype(jnp.float32))
    tmod.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).bfloat16()).float()
    return want, got


@pytest.mark.parametrize("kind", ["group_norm", "conv_norm_2d",
                                  "conv_norm_3d_s2", "conv_norm_3d_k5_d2"])
def test_layers_bf16(kind):
    """bf16 activations: the JAX per-tap conv rounds each depth tap to bf16
    before its float32 sum and the port's convs round once, so outputs of
    order 1-4 may differ by one or two bf16 ulps (an ulp is 0.03 between
    4 and 8): atol 6e-2."""
    import jax.numpy as jnp

    bf = jnp.bfloat16
    if kind == "group_norm":
        x = _x((2, 5, 6, 7, 16)) * 3.0 + 1.0
        j, t = jl.FastGroupNorm(groups=4, dtype=bf), tl.FastGroupNorm(16, 4)
    elif kind == "conv_norm_2d":
        x = _x((2, 9, 10, 8))
        j = jl.ConvNorm(16, 3, 2, groups=4, dtype=bf)
        t = tl.ConvNorm(8, 16, 3, 2, groups=4)
    elif kind == "conv_norm_3d_s2":
        x = _x((2, 8, 7, 9, 8))
        j = jl.ConvNorm3d(16, 3, 2, groups=4, dtype=bf)
        t = tl.ConvNorm3d(8, 16, 3, 2, groups=4)
    else:  # the large-tap shape: K2's plain version in bf16
        x = _x((1, 9, 8, 8, 8))
        j = jl.ConvNorm3d(16, 5, 1, 2, groups=4, dtype=bf)
        t = tl.ConvNorm3d(8, 16, 5, 1, 2, groups=4)
    want, got = _run_both_bf16(j, t, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=6e-2, rtol=0)


def test_convert_variables_copies_read_only_arrays():
    """A checkpoint's arrays may be read-only buffers (Orbax restores them
    so): the converted tensors own their memory, so no "not writable"
    warning is raised and a write into a tensor leaves the input alone.
    Covers a conv kernel (transposed), a Dense kernel, 1-D leaves that are
    already contiguous float32, and a float64 leaf (cast)."""
    import warnings

    rng = np.random.default_rng(0)
    tree = {
        "params": {
            "Conv_0": {"kernel": rng.standard_normal((3, 3, 4, 8)).astype(
                np.float32), "bias": rng.standard_normal(8).astype(np.float32)},
            "Dense_0": {"kernel": rng.standard_normal((8, 5)).astype(
                np.float32)},
            "GroupNorm_0": {"scale": rng.standard_normal(8),
                            "bias": rng.standard_normal(8).astype(np.float32)},
        },
        "batch_stats": {"BatchNorm_0": {
            "mean": rng.standard_normal(8).astype(np.float32),
            "var": rng.random(8).astype(np.float32)}},
    }
    leaves = [a for col in tree.values() for m in col.values()
              for a in m.values()]
    for a in leaves:
        a.setflags(write=False)
    before = [a.copy() for a in leaves]
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        out = convert_variables(tree)
    assert len(out) == len(leaves)
    for t in out.values():
        assert not any(np.shares_memory(t.numpy(), a) for a in leaves)
        t.add_(1.0)
    for a, b in zip(leaves, before):
        np.testing.assert_array_equal(a, b)
