"""Serving parity: the port's RefineRunner.step against the JAX
RefineRunner (snvc_tpu/inference/refine.py:187-224) on a tiny synthetic
batch: ROI warps + grid projection, encoder, BEV_type3 head and the
NCF -> pose update.  Float32 on both sides; boxes agree to 1e-4 m / rad,
per-part confidences to 1e-4 of their scale."""

import numpy as np
import pytest
import torch

import __graft_entry__
from snvc_tpu.data.pipeline import InstanceBatch as JBatch
from snvc_tpu.inference.refine import RefineRunner as JRunner
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.inference.refine import RefineRunner as TRunner
from snvc_tpu_torch.models.vernier import VernierScale as TVernier
from snvc_tpu_torch.ops.assemble import assemble_instances, make_grid_local
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config


def _jax_batch(a):
    I = a["samples"].shape[0]
    return JBatch(
        images_left=a["images_left"], images_right=a["images_right"],
        P_left=a["P_left"], P_right=a["P_right"], image_idx=a["image_idx"],
        trans_l=a["trans_l"], trans_r=a["trans_r"], samples=a["samples"],
        valid=a["valid"], gt_boxes=np.zeros((I, 7), np.float32),
        points=np.zeros((I, 8, 3), np.float32),
        points_valid=np.zeros((I, 8), bool))


@pytest.fixture(scope="module")
def runners():
    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    tcfg = torch_vernier_config(jcfg)
    jmod = JVernier(jcfg)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((2, H, W, 3), np.float32)
    p = np.zeros((2, nh * nw * nl, 2), np.float32)
    v = random_variables(jmod, x, x, p, p, seed=21)
    tmod = TVernier(tcfg, device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    return (JRunner(jmod, v, jcfg), TRunner(tmod, tcfg, device="cpu"),
            tcfg)


@pytest.mark.parametrize("seed", [0, 1])
def test_refine_step_matches_jax(runners, seed):
    jrun, trun, cfg = runners
    arrays = synthetic_batch_arrays(cfg, seed=seed)
    want = jrun.step(_jax_batch(arrays))
    got = trun.step(arrays)
    for k in ("one_part", "all_parts"):
        assert got[k].shape == (2, 7)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    scale = np.abs(want["confidence"]).max()
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    # the dense outputs stay on the device (here: CPU tensors)
    assert isinstance(got["ncf"], torch.Tensor)
    np.testing.assert_allclose(got["ncf"].numpy(), np.asarray(want["ncf"]),
                               atol=1e-4 * np.abs(want["ncf"]).max(), rtol=0)


def test_assemble_matches_jax():
    import jax.numpy as jnp

    from snvc_tpu.ops.assemble import assemble_instances as jassemble
    from snvc_tpu.ops.assemble import make_grid_local as jgrid

    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    tcfg = torch_vernier_config(jcfg)
    a = synthetic_batch_arrays(tcfg, seed=5)
    keys = ("images_left", "images_right", "image_idx", "trans_l", "trans_r",
            "samples", "P_left", "P_right")
    grid = make_grid_local(tcfg)
    np.testing.assert_array_equal(grid, jgrid(jcfg))
    want = jassemble(*(jnp.asarray(a[k]) for k in keys), jnp.asarray(grid),
                     jcfg)
    got = assemble_instances(*(torch.as_tensor(a[k]) for k in keys),
                             torch.from_numpy(grid), tcfg)
    names = ("left_rois", "right_rois", "grid_proj_l", "grid_proj_r")
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-5,
                                   atol=1e-4 * np.abs(w).max(), err_msg=name)


def test_runner_default_device_needs_cuda(runners):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    _, trun, cfg = runners
    with pytest.raises(RuntimeError, match="cuda"):
        TRunner(trun.model, cfg)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("values", [(0.485, 0.456, 0.406),
                                    np.array([[0.0, 0.5], [-0.5, 1.65]])])
def test_constant_equals_torch_tensor(values, dtype):
    """The serving path's sync-free constants hold the bits that
    ``torch.tensor(values, dtype=dtype)`` gives."""
    from snvc_tpu_torch.utils.device import constant

    got = constant(values, torch.device("cpu"), dtype)
    want = torch.tensor(values, dtype=dtype)
    assert got.dtype == dtype and got.shape == want.shape
    assert torch.equal(got, want)
