"""The port's global stereo model (snvc_tpu_torch/models/{stereo_backbone,
stereonet}.py) against the JAX package at ``tiny_stereo_config``, float32
on the CPU, with JAX variables from ``random_variables`` loaded through
``convert_variables`` (strict: BatchNorm statistics of the tiny backbone
and the 2D ConvTranspose of the BEV hourglass included).

Tolerances, relative to each output's largest magnitude:

* trunk without the SPP branches, and the head on the JAX encoder's
  features: 1e-4, float32 summation-order noise through a few dozen
  random-weight layers (the head runs the plain versions of K3 and K4,
  whose contracts round the sample coordinates slightly differently
  from the JAX CPU path's gather forms);
* the encoder with the SPP branches, and the whole model: 2e-3.  At the
  tiny 64 x 128 input the pooled SPP maps are 1 x 2 pixels, so each
  GroupNorm group of a branch holds 2 values and its variance cancels:
  float32 rounding of the inputs grows ~1e3x there (4e-3 measured inside
  one branch, ~1e-4 at the outputs).  The JAX side has the same
  sensitivity; it is a property of the tiny shape, not of the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.geometry.calib import Calibration
from snvc_tpu.models import stereonet as jnet
from snvc_tpu.models.stereo_backbone import StereoFeatureNet as JFeat
from snvc_tpu.models.vernier import scope_variables
from snvc_tpu_torch.config import StereoConfig, tiny_stereo_config
from snvc_tpu_torch.models import stereonet as tnet
from snvc_tpu_torch.models.stereo_backbone import StereoFeatureNet
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables

KEYS = ("depth", "depth_prob", "cls", "reg", "centerness")


def _close(got, want, rel, name=""):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max(), err_msg=name)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def stereo():
    """JAX encoder and head outputs of one tiny request, and the port
    model with the same weights."""
    jcfg = jax_tiny()
    H, W = jcfg.input_size
    rng = np.random.default_rng(0)
    left = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    right = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    Pl = Calibration.default().as_array()[None]
    Pr = Calibration.default_right().as_array()[None]
    variables = random_variables(jnet.StereoNet(jcfg), left, right, Pl, Pr,
                                 seed=3)
    feats = jnet.StereoEncoder(jcfg).apply(
        scope_variables(variables, "encoder"), left, right)
    out = jnet.StereoHead(jcfg).apply(
        scope_variables(variables, "head"), *feats, Pl, Pr)
    model = tnet.StereoNet(tiny_stereo_config(), device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    return dict(inputs=(left, right, Pl, Pr), feats=feats, out=out,
                model=model, jcfg=jcfg)


def test_config_matches_jax():
    from snvc_tpu.config import StereoConfig as JStereoConfig

    for jc, tc in ((JStereoConfig(), StereoConfig()),
                   (jax_tiny(), tiny_stereo_config())):
        for f in tc.__dataclass_fields__:  # the fields the port reads
            assert getattr(tc, f) == getattr(jc, f), f
        assert tc.bev_size == jc.bev_size and tc.ny == jc.ny
    assert StereoConfig().bev_size == (288, 300) and StereoConfig().ny == 20


@pytest.mark.parametrize("fn", ["depth_hypotheses", "voxel_grid_centers",
                                "bev_locations"])
def test_grids_match_jax(fn):
    for jc, tc in ((jax_tiny(), tiny_stereo_config()),
                   (jax_tiny(z_max=38.0), tiny_stereo_config(z_max=38.0))):
        np.testing.assert_array_equal(getattr(tnet, fn)(tc),
                                      getattr(jnet, fn)(jc))


def test_feature_trunk_matches_jax():
    """reslike50-det-tiny without the SPP branches (BatchNorm in the stem
    and the first layer, GroupNorm after): tolerance 1e-4."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 64, 128, 3)).astype(np.float32)
    kw = dict(backbone="reslike50-det-tiny", branch=False)
    jm = JFeat(**kw)
    v = random_variables(jm, x, seed=4)
    want = jm.apply(v, x)
    tm = StereoFeatureNet(**kw)
    tm.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = tm.eval()(_t(x))
    for g, w, name in zip(got, want, ("cost-volume feature", "rpn feature")):
        _close(g, w, 1e-4, name)


def test_encoder_matches_jax(stereo):
    left, right = stereo["inputs"][:2]
    with torch.no_grad():
        got = stereo["model"].encoder(_t(left), _t(right))
    for g, w, name in zip(got, stereo["feats"], ("lf", "rf", "rpn_img")):
        _close(g, w, 2e-3, name)


def test_head_matches_jax(stereo):
    """The head on the JAX encoder's features: cost volume (plain K3),
    3D stack, depth expectation, frustum resample (plain K4), BEV head."""
    Pl, Pr = stereo["inputs"][2:]
    with torch.no_grad():
        got = stereo["model"].head(*(_t(f) for f in stereo["feats"]),
                                   _t(Pl), _t(Pr))
    for k in KEYS:
        _close(got[k], stereo["out"][k], 1e-4, k)
    np.testing.assert_array_equal(got["depth_levels"].numpy(),
                                  np.asarray(stereo["out"]["depth_levels"]))


def test_stereonet_matches_jax(stereo):
    with torch.no_grad():
        got = stereo["model"](*(_t(a) for a in stereo["inputs"]))
    for k in KEYS:
        _close(got[k], stereo["out"][k], 2e-3, k)
    assert len(got["depth_preds"]) == 1


def test_img_to_bev_matches_jax():
    cfg, jcfg = tiny_stereo_config(), jax_tiny()
    rng = np.random.default_rng(2)
    f = rng.standard_normal((2, 12, 40, 6)).astype(np.float32)
    P = np.stack([Calibration.default().as_array(),
                  Calibration.default_right().as_array()])
    want = jnet.frustum_img_to_bev(jnp.asarray(f), jnp.asarray(P), jcfg)
    got = tnet.frustum_img_to_bev(_t(f), _t(P), cfg)
    _close(got, want, 1e-5, "img_bev")


@pytest.mark.parametrize("overrides,field", [
    (dict(num_depths=18), "num_depths"),
    (dict(input_size=(72, 128)), "feature height"),
    (dict(x_min=-9.0), "BEV nx"),
])
def test_divisibility_value_error(overrides, field):
    """Sizes the two-level hourglasses cannot round-trip raise, in JAX and
    in the port (config sizes at construction, feature sizes at call)."""
    jcfg = jax_tiny(**overrides)
    H, W = jcfg.input_size
    x = np.zeros((1, H, W, 3), np.float32)
    P = Calibration.default().as_array()[None]
    with pytest.raises(ValueError, match=field):
        jax.eval_shape(jnet.StereoNet(jcfg).init, jax.random.PRNGKey(0),
                       x, x, P, P)
    with pytest.raises(ValueError, match=field):
        model = tnet.StereoNet(tiny_stereo_config(**overrides), device="cpu")
        with torch.no_grad():
            model(_t(x), _t(x), _t(P), _t(P))


def test_head_stacked_with_offset_matches_jax():
    """Two stacked hourglasses threading the first one's skip state, and
    the per-plane depth offset: the head on random features."""
    over = dict(num_hourglasses=2, depth_offset=True)
    jcfg = jax_tiny(**over)
    rng = np.random.default_rng(5)
    lf, rf = (rng.standard_normal((1, 16, 32, 32)).astype(np.float32)
              for _ in range(2))
    rpn = rng.standard_normal((1, 16, 32, 64)).astype(np.float32)
    Pl = Calibration.default().as_array()[None]
    Pr = Calibration.default_right().as_array()[None]
    jhead = jnet.StereoHead(jcfg)
    v = random_variables(jhead, lf, rf, rpn, Pl, Pr, seed=6)
    want = jhead.apply(v, lf, rf, rpn, Pl, Pr)
    head = tnet.StereoHead(tiny_stereo_config(**over))
    head.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = head.eval()(*(_t(a) for a in (lf, rf, rpn, Pl, Pr)))
    for k in KEYS + ("depth_offset",):
        _close(got[k], want[k], 1e-4, k)
    assert len(got["depth_preds"]) == 2
    for g, w in zip(got["depth_preds"], want["depth_preds"]):
        _close(g, w, 1e-4, "depth_preds")
