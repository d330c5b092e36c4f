"""Whole-model parity: the port's VernierScale (BEV_type3, concat) against
the Flax VernierScale, parameters converted by utils/convert_jax.py.

Grids: ``__graft_entry__._tiny_cfg()`` (nw = 16: the two-level Hourglass)
and one with nw = 32 (HourglassDeep).  W < 128, so the JAX model takes its
per-tap conv path on the CPU (models/layers.py:278) and the port its
plain K1/K2 versions.  Float32 on both sides: tolerance 1e-4 of each
output's scale (float32 noise through ~60 layers).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu_torch.models.vernier import VernierScale as TVernier
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config


@pytest.mark.parametrize("grid,extra_heads", [(None, False),
                                               ((8, 32, 32), False),
                                               (None, True)])
def test_vernier_scale_matches_jax(grid, extra_heads):
    jcfg = __graft_entry__._tiny_cfg(max_instances=2)
    if grid is not None:
        jcfg = jcfg.replace(grid_resolution=grid)
    if extra_heads:  # the optional part-offset and FC bbox heads
        jcfg = jcfg.replace(use_part_reg_head=True, use_bbox_head=True)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    P = nh * nw * nl
    rng = np.random.default_rng(11)
    left = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((2, H, W, 3)).astype(np.float32)
    # projections inside and around the ROI
    gpl = rng.uniform(-8, W + 8, (2, P, 2)).astype(np.float32)
    gpr = rng.uniform(-8, W + 8, (2, P, 2)).astype(np.float32)
    jmod = JVernier(jcfg)
    v = random_variables(jmod, left, right, gpl, gpr, seed=12)
    want = jax.jit(jmod.apply)(v, left, right, gpl, gpr)

    tmod = TVernier(torch_vernier_config(jcfg), device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in (left, right, gpl, gpr)))
    shapes = dict(ncf=(2, 9, nl, nw), occupancy=(2, nh, nw, nl),
                  coordinates=(2, 9, 2))
    if extra_heads:
        shapes.update(offset=(2, 27, nh, nw, nl), bbox=(2, 5))
    else:
        assert got["offset"] is None and got["bbox"] is None
    for k, shape in shapes.items():
        w_k = np.asarray(want[k])
        g_k = got[k].numpy()
        assert g_k.shape == w_k.shape == shape, k
        np.testing.assert_allclose(g_k, w_k, rtol=0,
                                   atol=1e-4 * np.abs(w_k).max(), err_msg=k)


@pytest.mark.parametrize("vt", ["3D", "BEV", "BEV_type2"])
def test_other_heads_build_and_run(vt):
    """The heads the port once refused build and run on the CPU (their
    parity with JAX: tests/test_torch_variants.py)."""
    cfg = torch_vernier_config(__graft_entry__._tiny_cfg())
    cfg = cfg.replace(vernier_type=vt)
    model = TVernier(cfg, device="cpu")
    H, W = cfg.resolution
    nh, nw, nl = cfg.grid_resolution
    rois = torch.zeros((1, H, W, 3))
    proj = torch.full((1, nh * nw * nl, 2), W / 2.0)
    with torch.no_grad():
        out = model(rois, rois, proj, proj)
    ncf = (1, 9, nh, nw, nl) if vt == "3D" else (1, 9, nl, nw)
    assert tuple(out["ncf"].shape) == ncf
    assert torch.isfinite(out["ncf"]).all()
    assert out["coordinates"] is None and out["bbox"] is None


def test_default_device_needs_cuda():
    """The port runs on the card unless asked for the CPU: without a GPU the
    default device raises instead of falling back."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is valid")
    cfg = torch_vernier_config(__graft_entry__._tiny_cfg())
    with pytest.raises(RuntimeError, match="cuda"):
        TVernier(cfg)
