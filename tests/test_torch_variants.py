"""The Vernier model variants, the port against the Flax model on the CPU,
parameters converted by utils/convert_jax.py (the setup of
tests/test_torch_vernier.py):

* whole-model forwards of the ``BEV_type2``, ``BEV`` and ``3D`` heads
  (``3D`` with 1 and 3 parts), float32, within 1e-4 of each output's
  largest value (float32 noise through ~60 layers);
* the plain sampler's ``aggregate="concat-atten"``;
* conversion at ``hrnet-test-multi`` (repeated modules) with the
  5-channel ``add_xy`` stem, in the encoder with ``concat-atten``;
* ``RefineRunner`` serving ``BEV_type2`` and ``BEV`` against JAX's
  runner (boxes 1e-4 m / rad; neither head has ``coordinates``, so both
  decode by argmax under ``ncf_decode="coordinates"``), and its refusal
  of the ``3D`` head's 5-D fields.
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__
from snvc_tpu.config import BackboneConfig as JBackbone
from snvc_tpu.models.vernier import VernierEncoder as JEncoder
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.ops.grid_sample import sample_stereo_voxel as jsample
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.models.vernier import VernierEncoder, VernierScale
from snvc_tpu_torch.ops.grid_sample import sample_stereo_voxel
from snvc_tpu_torch.ops.registration import ncf_to_update
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.test_torch_refine import _jax_batch, _runners
from tests.torch_port_helpers import random_variables, torch_vernier_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(jcfg, seed=11):
    """Seeded ROIs and projections inside and around the ROI."""
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    P = nh * nw * nl
    rng = np.random.default_rng(seed)
    rois = [rng.standard_normal((2, H, W, 3)).astype(np.float32)
            for _ in range(2)]
    proj = [rng.uniform(-8, W + 8, (2, P, 2)).astype(np.float32)
            for _ in range(2)]
    return rois + proj


def _assert_model_matches(jcfg, shapes, seed=12):
    args = _inputs(jcfg)
    jmod = JVernier(jcfg)
    v = random_variables(jmod, *args, seed=seed)
    want = jax.jit(jmod.apply)(v, *args)
    tmod = VernierScale(torch_vernier_config(jcfg), device="cpu")
    tmod.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(a) for a in args))
    assert set(got) == set(want)
    for k, w in want.items():
        if k not in shapes:
            assert w is None and got[k] is None, k
            continue
        w_k = np.asarray(w)
        g_k = got[k].numpy()
        assert g_k.shape == w_k.shape == shapes[k], k
        np.testing.assert_allclose(g_k, w_k, rtol=0,
                                   atol=1e-4 * np.abs(w_k).max(), err_msg=k)


@pytest.mark.parametrize("vt,parts,heads", [("BEV_type2", 9, True),
                                            ("BEV", 9, False),
                                            ("3D", 1, False),
                                            ("3D", 3, False)])
def test_head_matches_jax(vt, parts, heads):
    """BEV_type2 with the offset head and the bbox head asked for, which
    BEV_type2 does not have (no CoordHead to feed it)."""
    jcfg = __graft_entry__._tiny_cfg(max_instances=2).replace(
        vernier_type=vt, num_parts=parts, use_part_reg_head=heads,
        use_bbox_head=heads)
    nh, nw, nl = jcfg.grid_resolution
    if vt == "3D":
        shapes = dict(ncf=(2, parts, nh, nw, nl))
    else:
        shapes = dict(ncf=(2, parts, nl, nw), occupancy=(2, nh, nw, nl))
    if heads:
        shapes["offset"] = (2, 27, nh, nw, nl)
    _assert_model_matches(jcfg, shapes)


def test_multi_add_xy_concat_atten_encoder_matches_jax():
    """The encoder of the w48 serving combination at test size:
    hrnet-test-multi (2 / 3 / 2 repeated modules: the converter's
    ordering) with the 5-channel add_xy stem and concat-atten.  The
    converted variables load strictly, the gated voxel matches JAX's
    within 1e-5 of scale, and the gate bites (distinct views
    attenuate)."""
    jcfg = __graft_entry__._tiny_cfg(max_instances=2).replace(
        backbone=JBackbone(name="hrnet-test-multi", add_xy=True),
        feature_aggregation="concat-atten")
    args = _inputs(jcfg, seed=5)
    jmod = JEncoder(jcfg)
    v = random_variables(jmod, *args, seed=6)
    want = np.asarray(jax.jit(jmod.apply)(v, *args))
    cfg = torch_vernier_config(jcfg)
    enc = VernierEncoder(cfg).eval()
    assert enc.HRNet_0.Conv_0.weight.shape[1] == 5
    assert "HRNet_0.HRModule_6.FuseLayer_11.Conv_0.weight" in enc.state_dict()
    enc.load_state_dict(convert_variables(v), strict=True)
    plain = VernierEncoder(cfg.replace(feature_aggregation="concat")).eval()
    plain.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        t = [torch.from_numpy(a) for a in args]
        got, ungated = enc(*t).numpy(), plain(*t).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    assert np.abs(got).sum() < 0.99 * np.abs(ungated).sum()


def test_plain_sampler_concat_atten_matches_jax():
    rng = np.random.default_rng(9)
    lf, rf = (rng.standard_normal((2, 8, 8, 16)).astype(np.float32)
              for _ in range(2))
    pl, pr = (rng.uniform(-4, 36, (2, 4 * 6 * 5, 2)).astype(np.float32)
              for _ in range(2))
    args = (lf, rf, pl, pr)
    want = np.asarray(jsample(*args, (32, 32), (4, 6, 5),
                              aggregate="concat-atten"))
    got = sample_stereo_voxel(*(torch.from_numpy(a) for a in args), (32, 32),
                              (4, 6, 5), aggregate="concat-atten").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        sample_stereo_voxel(*(torch.from_numpy(a) for a in args), (32, 32),
                            (4, 6, 5), aggregate="sum")


@pytest.fixture(scope="module", params=["BEV_type2", "BEV"])
def bev_runners(request):
    return _runners(__graft_entry__._tiny_cfg(max_instances=2).replace(
        vernier_type=request.param), 31)


def test_refine_serves_bev_heads_as_jax(bev_runners):
    jrun, trun, cfg = bev_runners
    assert cfg.ncf_decode == "coordinates"
    arrays = synthetic_batch_arrays(cfg, seed=4)
    want = jrun.step(_jax_batch(arrays))
    got = trun.step(arrays)
    assert got["coordinates"] is None and want["coordinates"] is None
    for k in ("one_part", "all_parts"):
        assert got[k].shape == (2, 7)
        np.testing.assert_allclose(got[k], want[k], atol=1e-4, rtol=0,
                                   err_msg=k)
    scale = np.abs(want["confidence"]).max()
    np.testing.assert_allclose(got["confidence"], want["confidence"],
                               atol=1e-4 * scale, rtol=0)
    np.testing.assert_array_equal(got["keep"], want["keep"])
    for k in ("ncf", "occupancy"):
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max(), err_msg=k)


def test_refine_refuses_the_3d_head():
    """JAX's _finalize fails on the 3D head's fields in hard_argmax_2d's
    4-D unpack; the port refuses them with a ValueError, in step before
    any work and in ncf_to_update."""
    cfg = torch_vernier_config(__graft_entry__._tiny_cfg(max_instances=2)
                               .replace(vernier_type="3D"))
    from snvc_tpu_torch.inference.refine import RefineRunner

    runner = RefineRunner(VernierScale(cfg, device="cpu"), cfg, device="cpu")
    with pytest.raises(ValueError, match="3D"):
        runner.step(synthetic_batch_arrays(cfg, seed=0))
    nh, nw, nl = cfg.grid_resolution
    with pytest.raises(ValueError, match="BEV"):
        ncf_to_update(torch.zeros((2, 9, nh, nw, nl)), torch.zeros((2, 7)),
                      cfg.x_range, cfg.z_range)
