"""The modules under the Vernier variants, the port against the JAX
package on the CPU, float32:

* ``HRNet`` with ``head_type="heatmap_regression"`` (no stem, a feature
  map in, pixel shuffle out) and ``"classification"``, and with
  ``add_xy`` (a 5-channel input, and the [-1, 1] ramps appended to a
  bare 3-channel one), within 1e-5 of scale (tests/test_torch_hrnet.py's
  rule);
* ``assemble.roi_xy_maps`` and the 5-channel ROIs of
  ``assemble_instances`` (1e-5 absolute: ROIs and maps are O(1));
* ``heatmaps.heatmaps_3d`` and ``make_targets(grid_type="3D")`` (1e-6);
* ``ConvNorm3d`` with stride (2, 1, 1) at an even and an odd depth (both
  pad (k - 1) // 2 on each side), within 1e-5 of scale;
* the stages of ``hrnet-w48`` and ``hrnet-test-multi``, field for field;
* validation losses of the ``BEV`` head over a KITTI tree:
  ``RefineRunner.run(with_targets=True)`` against JAX's to 1e-4
  relative, and ``inference_agnostic --report_loss`` on a saved model
  directory of that head (the setup of tests/test_torch_refine.py).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu import config as jconfig
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.models.hrnet import HRNet as JHRNet
from snvc_tpu.models.layers import ConvNorm3d as JConvNorm3d
from snvc_tpu.ops.assemble import assemble_instances as jassemble
from snvc_tpu.ops.assemble import make_grid_local as jgrid
from snvc_tpu.ops.assemble import make_targets as jmake_targets
from snvc_tpu.ops.assemble import roi_xy_maps as jroi_xy_maps
from snvc_tpu.ops.heatmaps import heatmaps_3d as jheatmaps_3d
from snvc_tpu_torch import config as tconfig
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.models.hrnet import HRNet
from snvc_tpu_torch.models.layers import ConvNorm3d
from snvc_tpu_torch.ops.assemble import (
    assemble_instances,
    make_grid_local,
    make_targets,
    roi_xy_maps,
)
from snvc_tpu_torch.ops.heatmaps import heatmaps_3d
from snvc_tpu_torch.tools import inference_agnostic as cli_refine
from snvc_tpu_torch.training.train import create_train_state, save_checkpoint
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.test_torch_refine import (  # noqa: F401  (loss_tree: a fixture)
    _assert_losses_close,
    _pipelines,
    _runners,
    loss_tree,
)
from tests.torch_port_helpers import random_variables, torch_vernier_config

ASSEMBLE_KEYS = ("images_left", "images_right", "image_idx", "trans_l",
                 "trans_r", "samples", "P_left", "P_right")
TARGET_KEYS = ("samples", "gt_boxes", "points", "points_valid")


def _hrnet_pair(head, x, add_xy=False, in_channels=3, **kw):
    """JAX's HRNet output for ``x`` and the port's HRNet with the same
    (converted) variables, in eval mode."""
    name = "hrnet-tiny"
    j = JHRNet(jconfig.BackboneConfig(name=name, add_xy=add_xy),
               head_type=head, **kw)
    v = random_variables(j, x, seed=4)
    want = np.asarray(jax.jit(j.apply)(v, x))
    t = HRNet(tconfig.BackboneConfig(name=name, add_xy=add_xy),
              head_type=head, in_channels=in_channels, **kw)
    t.load_state_dict(convert_variables(v), strict=True)
    return want, t.eval()


def _assert_scaled(got, want, rel=1e-5):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * np.abs(want).max())


@pytest.mark.parametrize("head,shape,out", [
    ("heatmap_regression", (2, 16, 16, 48), (2, 32, 32, 9)),
    ("classification", (2, 64, 64, 3), (2, 10)),
])
def test_hrnet_heads_match_jax(head, shape, out):
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    kw = (dict(num_heatmaps=9) if head == "heatmap_regression"
          else dict(num_classes=10))
    want, t = _hrnet_pair(head, x, in_channels=shape[-1], **kw)
    if head == "heatmap_regression":  # no stem: Conv_0 is the biased head
        assert t.Conv_0.bias is not None and not t.stem
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == out
    _assert_scaled(got, want)


@pytest.mark.parametrize("channels", [3, 5])
def test_hrnet_add_xy_matches_jax(channels):
    """5 channels: the ROIs with their maps, as assemble_instances gives
    them; 3 channels: JAX's fallback ramps appended before the stem."""
    x = np.random.default_rng(5).standard_normal(
        (2, 64, 64, channels)).astype(np.float32)
    want, t = _hrnet_pair("default", x, add_xy=True)
    assert t.Conv_0.weight.shape[1] == 5
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    _assert_scaled(got, want)


def test_roi_xy_maps_and_assemble_match_jax():
    jcfg = jtiny(backbone=jconfig.BackboneConfig(name="hrnet-tiny",
                                                 add_xy=True),
                 image_size=(128, 256))
    cfg = torch_vernier_config(jcfg)
    a = jbatch(jcfg, seed=0)
    want = np.asarray(jroi_xy_maps(jnp.asarray(a["trans_l"]),
                                   jcfg.resolution, jcfg.image_size))
    got = roi_xy_maps(torch.from_numpy(a["trans_l"]), cfg.resolution,
                      cfg.image_size).numpy()
    assert got.shape == (2,) + cfg.resolution + (2,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    jout = jassemble(*(jnp.asarray(a[k]) for k in ASSEMBLE_KEYS),
                     jnp.asarray(jgrid(jcfg)), jcfg)
    tout = assemble_instances(*(torch.as_tensor(a[k]) for k in ASSEMBLE_KEYS),
                              torch.from_numpy(make_grid_local(cfg)), cfg)
    for name, g, w in zip(("left", "right"), tout[:2], jout[:2]):
        assert g.shape[-1] == 5, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(tout[0][..., 3:].numpy(), got, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("quantize", [True, False])
def test_heatmaps_3d_match_jax(quantize):
    rng = np.random.default_rng(8)
    c = rng.uniform(-3, 13, (3, 4, 3)).astype(np.float32)
    want = np.asarray(jheatmaps_3d(jnp.asarray(c), (6, 10, 9), 2,
                                   quantize=quantize))
    got = heatmaps_3d(torch.from_numpy(c), (6, 10, 9), 2,
                      quantize=quantize).numpy()
    assert got.shape == (3, 4, 6, 10, 9)
    assert (want > 0).any() and (want == 0).any()  # the 3 sigma box bites
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_make_targets_3d_match_jax():
    jcfg = jtiny(max_instances=4, image_size=(384, 1280), grid_type="3D",
                 num_parts=3)
    cfg = torch_vernier_config(jcfg)
    a = jbatch(jcfg, seed=2)
    want = jmake_targets(*(jnp.asarray(a[k]) for k in TARGET_KEYS),
                         jnp.asarray(jgrid(jcfg)), jcfg)
    got = make_targets(*(torch.as_tensor(a[k]) for k in TARGET_KEYS),
                       torch.from_numpy(make_grid_local(cfg)), cfg)
    assert got["ncf"].shape == (4, 3) + cfg.grid_resolution
    assert float(got["ncf"].max()) > 0.5
    for k in ("ncf", "occupancy", "gt_corners_local"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("depth", [8, 7])
def test_convnorm3d_depth_stride_matches_jax(depth):
    x = np.random.default_rng(depth).standard_normal(
        (2, depth, 6, 5, 16)).astype(np.float32)
    j = JConvNorm3d(16, 3, (2, 1, 1), gn=True, groups=4)
    v = random_variables(j, x, seed=1)
    want = np.asarray(j.apply(v, x))
    t = ConvNorm3d(16, 16, 3, (2, 1, 1), 1, True, 4)
    t.load_state_dict(convert_variables(v), strict=True)
    with torch.no_grad():
        got = t(torch.from_numpy(x)).numpy()
    assert got.shape == (2, (depth - 1) // 2 + 1, 6, 5, 16)
    _assert_scaled(got, want)


@pytest.mark.parametrize("name", ["hrnet-w48", "hrnet-test-multi"])
def test_stages_match_jax(name):
    want = jconfig.BackboneConfig(name=name).stages()
    got = tconfig.BackboneConfig(name=name).stages()
    fields = [f.name for f in dataclasses.fields(tconfig.HRNetStageConfig)]
    assert [[getattr(s, f) for f in fields] for s in got] == \
        [[getattr(s, f) for f in fields] for s in want]
    assert tconfig.BackboneConfig(name=name).output_channel == \
        jconfig.BackboneConfig(name=name).output_channel


def test_bev_report_loss_matches_jax(loss_tree, capsys):
    jrun, trun, cfg = _runners(jtiny(max_instances=4, image_size=(384, 1248),
                                     vernier_type="BEV"), 23)
    root, props = loss_tree, os.path.join(loss_tree, "gt", "data")
    jpipe, pipe = _pipelines(jrun.cfg, cfg, root)
    want = jrun.run(jpipe, with_targets=True, progress=False)
    got = trun.run(pipe, with_targets=True, progress=False)
    assert len(got) == len(want) == 2  # a frame a batch
    for g, w in zip(got, want):
        assert set(g) == {"ncf", "occupancy", "total"}
        _assert_losses_close(g, w)
    model_dir = os.path.join(root, "model_bev")
    save_checkpoint(model_dir, create_train_state(trun.model, cfg,
                                                  TrainConfig()), cfg, 1)
    trun.model.eval()
    res = cli_refine.main([
        "--model_dir", model_dir, "--data_path", root, "--pred_dir", props,
        "--output_dir", os.path.join(root, "out_bev"), "--device", "cpu",
        "--report_loss", "--prefetch", "0"])
    capsys.readouterr()
    assert res["losses"] == got
