"""The port's reference-checkpoint converter (snvc_tpu_torch/utils/
convert_torch.py) against JAX's (snvc_tpu/utils/convert_torch.py) on the
CPU:

* a live reference-structured torch model (tests/torch_vernier.TVernier,
  hrnet-tiny, BEV_type3, BatchNorm stacks) converted by the port reproduces
  its own forward at JAX's tolerances (NCF 2e-3, occupancy and
  coordinates 1e-3), and the same state_dict through JAX's conversion and
  then ``convert_variables`` equals the port's direct conversion key for
  key and bit for bit;
* fabricated release-shaped state_dicts: the port's equals JAX's for the
  same ``default_rng(0)`` (keys in order, bits), and both conversions agree
  bit for bit, with the part-offset and bbox heads, GroupNorm and
  BatchNorm;
* the port's ``state_dict`` order equals Flax's creation order;
* tests/torch_hrnet.THRNet converts onto the port's HRNet with forward
  parity at JAX's 2e-4;
* a missing group, an unrouted tensor and a short group raise; a tar
  round-trips through ``load_torch_checkpoint``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu import config as jconfig
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.utils import convert_torch as jct
from snvc_tpu_torch import config as tconfig
from snvc_tpu_torch.models.hrnet import HRNet
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.utils import convert_torch as tct
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import torch_vernier_config


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: the tier-1 command runs this file beside five other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_template(cfg):
    """JAX's creation-order shape template of a VernierScale."""
    H, W = cfg.resolution
    P = int(np.prod(cfg.grid_resolution))
    return jct.abstract_init(
        JVernier(cfg), jnp.zeros((1, H, W, 3)), jnp.zeros((1, H, W, 3)),
        jnp.zeros((1, P, 2)), jnp.zeros((1, P, 2)))


def _via_jax(sd, template, part_reg, bbox):
    """JAX's conversion, then the port's Flax -> torch conversion."""
    params, stats = jct.convert_vernier_checkpoint(
        sd, template["params"], template.get("batch_stats", {}),
        use_part_reg_head=part_reg, use_bbox_head=bbox)
    return convert_variables({"params": params, "batch_stats": stats})


def _assert_same_state(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype == torch.float32, k
        assert torch.equal(a[k], b[k]), k


def _flax_paths(template):
    """Port-style keys of a Flax tree, in creation order, parameters then
    statistics."""
    leaf = {"kernel": "weight", "scale": "weight", "bias": "bias",
            "mean": "running_mean", "var": "running_var"}
    return [".".join(p[:-1] + (leaf[p[-1]],))
            for col in ("params", "batch_stats")
            for p, _ in jct._flatten(template.get(col, {}))]


@pytest.mark.parametrize("kw", [
    dict(gn=False),
    dict(gn=True, grid_resolution=(8, 32, 32)),  # HourglassDeep, GroupNorm
    dict(gn=False, backbone="hrnet-test-multi"),
], ids=["tiny", "deep_gn", "multi"])
def test_state_dict_order_is_flax_creation_order(kw):
    kw = dict(kw, use_part_reg_head=True, use_bbox_head=True)
    bb = kw.pop("backbone", "hrnet-tiny")
    jcfg = jconfig.tiny_vernier_config(
        backbone=jconfig.BackboneConfig(name=bb), **kw)
    model = VernierScale(torch_vernier_config(jcfg), device="cpu")
    params, stats = tct.leaf_keys(model.state_dict(), [""])
    assert params + stats == _flax_paths(_jax_template(jcfg))


@pytest.mark.parametrize("gn", [False, True])
def test_fabricated_checkpoint_converts_as_jax(gn):
    jcfg = jconfig.tiny_vernier_config(use_part_reg_head=True,
                                       use_bbox_head=True, gn=gn)
    template = _jax_template(jcfg)
    want_sd = jct.fabricate_vernier_state_dict(
        template["params"], template.get("batch_stats", {}), True, True,
        np.random.default_rng(0))
    model = VernierScale(torch_vernier_config(jcfg), device="cpu")
    target = model.state_dict()
    sd = tct.fabricate_vernier_state_dict(target, True, True,
                                          np.random.default_rng(0))
    assert list(sd) == list(want_sd)
    for k in sd:
        assert sd[k].dtype == want_sd[k].dtype and np.array_equal(
            sd[k], want_sd[k]), k
    got = tct.convert_vernier_checkpoint(sd, target, True, True)
    _assert_same_state(got, _via_jax(sd, template, True, True))
    model.load_state_dict(got, strict=True)
    # the heads read from the keys, as validate_epoch80 detects them
    from snvc_tpu_torch.tools.validate_epoch80 import detect_heads

    assert detect_heads(sd) == (True, True)


def test_live_reference_model_converts_with_forward_parity():
    """TVernier (the reference's registration order and forward) ->
    the port, held to TVernier's forward; and to JAX's conversion bit for
    bit."""
    from tests.torch_vernier import TVernier

    grid, res = (16, 32, 48), (64, 64)
    bcfg = jconfig.BackboneConfig(name="hrnet-tiny")
    feat_dim = bcfg.stages()[1].num_channels[0]
    jcfg = jconfig.VernierConfig(backbone=bcfg, vernier_type="BEV_type3",
                                 gn=False, grid_resolution=grid,
                                 resolution=res, num_parts=9,
                                 compute_dtype="float32")
    torch.manual_seed(0)
    tmodel = TVernier(bcfg.stages(), feat_dim, grid, res, gn=False).eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm3d)):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.8, 1.3)
                m.weight.uniform_(0.7, 1.3)
                m.bias.uniform_(-0.1, 0.1)
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()}

    model = VernierScale(torch_vernier_config(jcfg), device="cpu")
    got = tct.convert_vernier_checkpoint(sd, model.state_dict())
    _assert_same_state(got, _via_jax(sd, _jax_template(jcfg), False, False))
    model.load_state_dict(got, strict=True)

    rng = np.random.default_rng(0)
    H, W = res
    P = int(np.prod(grid))
    x_l = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    x_r = rng.standard_normal((1, H, W, 3)).astype(np.float32)
    # projections over the ROI with some points out of range
    gl = rng.uniform(-10, max(H, W) + 10, (1, P, 2)).astype(np.float32)
    gr = gl + rng.normal(0, 3, (1, P, 2)).astype(np.float32)
    with torch.no_grad():
        out = model(*(torch.from_numpy(a) for a in (x_l, x_r, gl, gr)))
        t_hm, t_occ, t_coord = tmodel(
            torch.from_numpy(x_l.transpose(0, 3, 1, 2)),
            torch.from_numpy(x_r.transpose(0, 3, 1, 2)),
            torch.from_numpy(gl), torch.from_numpy(gr))
    for k, want, tol in (("ncf", t_hm, 2e-3), ("occupancy", t_occ, 1e-3),
                         ("coordinates", t_coord, 1e-3)):
        assert out[k].shape == want.shape, k
        np.testing.assert_allclose(out[k].numpy(), want.numpy(), atol=tol,
                                   err_msg=k)


@pytest.mark.parametrize("backbone", ["hrnet-tiny", "hrnet-test-multi"])
def test_reference_hrnet_converts_with_forward_parity(backbone):
    """THRNet (the reference's order: conv1, bn1, conv2, bn2, layer1,
    transition1, stage2, ...) onto the port's HRNet by greedy alignment."""
    from tests.torch_hrnet import THRNet

    cfg = jconfig.BackboneConfig(name=backbone)
    torch.manual_seed(0)
    tmodel = THRNet(cfg.stages()).eval()
    with torch.no_grad():
        for m in tmodel.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.3, 0.3)
                m.running_var.uniform_(0.7, 1.4)
                m.weight.uniform_(0.6, 1.4)
                m.bias.uniform_(-0.2, 0.2)
    sd = {k: v.detach().numpy() for k, v in tmodel.state_dict().items()
          if not k.endswith("num_batches_tracked")}

    model = HRNet(tconfig.BackboneConfig(name=backbone),
                  head_type="default").eval()
    target = model.state_dict()
    params, stats = tct.leaf_keys(target, [""])
    got = tct.convert_module(sd, target, params + stats)
    assert len(got) == len(sd) == len(target)
    model.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                           for k, v in got.items()}, strict=True)
    x = np.random.default_rng(0).standard_normal(
        (1, 64, 96, 3)).astype(np.float32)
    with torch.no_grad():
        out = model(torch.from_numpy(x)).permute(0, 3, 1, 2).numpy()
        want = tmodel(torch.from_numpy(x.transpose(0, 3, 1, 2))).numpy()
    assert out.shape == want.shape
    np.testing.assert_allclose(out, want, atol=2e-4)


def test_refusals_and_tar_round_trip(tmp_path):
    cfg = tconfig.tiny_vernier_config()
    target = VernierScale(cfg, device="cpu").state_dict()
    sd = tct.fabricate_vernier_state_dict(target)
    tct.convert_vernier_checkpoint(sd, target)  # the whole dict converts
    with pytest.raises(ValueError, match="no tensors under 'conv1.'"):
        tct.convert_vernier_checkpoint(
            {k: v for k, v in sd.items() if not k.startswith("conv1.")},
            target)
    with pytest.raises(ValueError, match="unrouted"):
        tct.convert_vernier_checkpoint(
            dict(sd, **{"pool_3d.0.weight": np.zeros(3, np.float32)}), target)
    with pytest.raises(ValueError, match="unrouted"):  # a head not asked for
        tct.convert_vernier_checkpoint(
            dict(sd, **{"bbox_head.0.weight": np.zeros(3, np.float32)}),
            target)
    short = dict(sd)
    del short[[k for k in sd if k.startswith("hg_conv3d.")][-1]]
    with pytest.raises(ValueError, match="no reference tensor"):
        tct.convert_vernier_checkpoint(short, target)
    extra = dict(sd, **{"conv2.99.bias": np.zeros(7, np.float32)})
    with pytest.raises(ValueError, match="unconsumed"):
        tct.convert_vernier_checkpoint(extra, target)
    # a reference BatchNorm counter is dropped, not refused
    tct.convert_vernier_checkpoint(
        dict(sd, **{"conv1.1.num_batches_tracked": np.zeros((), np.int64)}),
        target)

    path = str(tmp_path / "epoch_80.tar")
    torch.save({"epoch": 80, "state_dict": {
        k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    back = tct.load_torch_checkpoint(path)
    assert list(back) == list(sd)
    assert all(np.array_equal(back[k], sd[k]) for k in sd)
    # JAX's loader reads the same tensors
    want = jct.load_torch_checkpoint(path)
    assert all(np.array_equal(back[k], want[k]) for k in want)
