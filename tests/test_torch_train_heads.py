"""Training of the Vernier model's optional heads, the port against JAX on
the CPU: the part-offset head (``use_part_reg_head``) and the FC bbox
head (``use_bbox_head``).

* ``make_targets``' ``gt_box_local`` and ``offset`` against JAX's, to
  1e-6 (absolute, the targets are O(1)).
* The five losses JAX has beside ``vernier_losses`` (``offset_loss``,
  ``bbox_loss_2d``, ``bbox_loss_3d``, ``approximated_iou3d``,
  ``disentangled_corner_loss``) to 1e-5 relative.
* Two whole float32 train steps with the offset head against JAX's, from
  the same variables (the setup of tests/test_torch_train.py): step-0
  losses to 1e-4 relative and clipped gradients to 5e-3 global relative
  L2 (see the test for why not 3e-3) against JAX's evaluation apart
  from its jitted step; BatchNorm statistics and the updated parameters
  against the jitted step, at test_torch_train.py's margin.
* The bbox head's ``FCModel`` in train mode against JAX's: JAX draws its
  dropout masks from its own rng stream, which the port cannot draw, so
  both run with ``p_dropout=0`` (batch statistics, outputs, running
  statistics); the port's mask is then checked alone: its keep rate,
  its 1 / (1 - p) scale, its seeding, and the identity in eval mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.models import losses as jl
from snvc_tpu.models.fc_model import FCModel as JFCModel
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.ops.assemble import make_grid_local as jgrid
from snvc_tpu.ops.assemble import make_targets as jmake_targets
from snvc_tpu.ops.assemble import assemble_instances as jassemble
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train import make_train_step as jmake_train_step
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.models import losses as tl
from snvc_tpu_torch.models.fc_model import FCModel, dropout
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.ops.assemble import make_grid_local, make_targets
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    learning_rate,
    make_train_step,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)  # see tests/test_torch_train.py
TC = dict(lr=1e-3, warmup_steps=2, total_steps=50, grad_clip=5.0)
HEADS = dict(use_bbox_head=True, use_part_reg_head=True)
TARGET_KEYS = ("samples", "gt_boxes", "points", "points_valid")
ASSEMBLE_KEYS = ("images_left", "images_right", "image_idx", "trans_l",
                 "trans_r", "samples", "P_left", "P_right")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs the train steps several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    return abs(got - want) / max(abs(want), 1e-12)


def test_targets_of_both_heads_match_jax():
    jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE, **HEADS)
    tcfg = torch_vernier_config(jcfg)
    a = jbatch(jcfg, seed=2)
    want = jmake_targets(*(jnp.asarray(a[k]) for k in TARGET_KEYS),
                         jnp.asarray(jgrid(jcfg)), jcfg)
    got = make_targets(*(torch.as_tensor(a[k]) for k in TARGET_KEYS),
                       torch.from_numpy(make_grid_local(tcfg)), tcfg)
    nh, nw, nl = jcfg.grid_resolution
    assert got["gt_box_local"].shape == (4, 5)
    assert got["offset"].shape == (4, 3, jcfg.num_parts, nh, nw, nl)
    for k in ("gt_box_local", "offset", "gt_corners_local", "ncf",
              "occupancy"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    # off by default: neither key
    plain = make_targets(*(torch.as_tensor(a[k]) for k in TARGET_KEYS),
                         torch.from_numpy(make_grid_local(tcfg)),
                         tcfg.replace(use_bbox_head=False,
                                      use_part_reg_head=False))
    assert "gt_box_local" not in plain and "offset" not in plain


def _boxes(rng, n):
    """[n, 7] plausible boxes (h, w, l, x, y, z, ry)."""
    return np.concatenate([
        rng.uniform([1.4, 1.5, 3.5], [1.7, 1.9, 4.5], (n, 3)),
        rng.uniform([-5, 1.5, 10], [5, 1.8, 30], (n, 3)),
        rng.uniform(-np.pi, np.pi, (n, 1))], axis=1).astype(np.float32)


def test_five_losses_match_jax():
    rng = np.random.default_rng(3)
    B, P, nh, nw, nl = 3, 9, 4, 6, 5
    valid = np.array([True, True, False])
    off_pred = rng.normal(size=(B, 3 * P, nh, nw, nl)).astype(np.float32)
    off_tgt = rng.normal(size=(B, 3, P, nh, nw, nl)).astype(np.float32)
    occ = rng.choice([-1.0, 0.0, 1.0], size=(B, nh, nw, nl)).astype(
        np.float32)
    gt = _boxes(rng, 6)
    # predictions near the GT, so the boxes overlap (and one does not)
    pred = gt + rng.normal(0, 0.2, gt.shape).astype(np.float32)
    pred[5, 3] += 10.0
    v6 = np.array([True] * 5 + [False])
    bev_p = rng.normal(size=(B, 5)).astype(np.float32)
    bev_g = rng.normal(size=(B, 5)).astype(np.float32)
    p7 = rng.normal(size=(6, 7)).astype(np.float32)
    t7 = rng.normal(size=(6, 7)).astype(np.float32)
    w = rng.uniform(0, 1, 6).astype(np.float32)
    t = torch.from_numpy
    j = jnp.asarray
    cases = {
        "offset": (jl.offset_loss(j(off_pred), j(off_tgt), j(occ), j(valid)),
                   tl.offset_loss(t(off_pred), t(off_tgt), t(occ), t(valid))),
        "bbox_2d": (jl.bbox_loss_2d(j(bev_p), j(bev_g), j(valid))["l1"],
                    tl.bbox_loss_2d(t(bev_p), t(bev_g), t(valid))["l1"]),
        "corner": (jl.disentangled_corner_loss(j(p7), j(t7), j(w)),
                   tl.disentangled_corner_loss(t(p7), t(t7), t(w))),
    }
    want3 = jl.bbox_loss_3d(j(pred), j(gt), j(v6))
    got3 = tl.bbox_loss_3d(t(pred), t(gt), t(v6))
    for k in ("sl1", "IoU3D"):
        cases[f"bbox_3d {k}"] = (want3[k], got3[k])
    for name, (want, got) in cases.items():
        assert _rel(float(got), float(want)) <= 1e-5, (name, float(got),
                                                       float(want))
    iou_w = np.asarray(jl.approximated_iou3d(j(pred), j(gt)))
    iou_g = tl.approximated_iou3d(t(pred), t(gt)).numpy()
    assert iou_w[5] == 0.0 and (iou_w[:5] > 0.1).all()  # the cases bite
    np.testing.assert_allclose(iou_g, iou_w, rtol=1e-5, atol=1e-7)


def test_vernier_losses_add_both_heads_as_jax():
    """Given the same outputs and targets, the composite loss has JAX's
    keys in JAX's order and JAX's values."""
    rng = np.random.default_rng(4)
    B, P, nh, nw, nl = 2, 9, 4, 6, 5
    outs = dict(ncf=rng.uniform(size=(B, P, nl, nw)),
                occupancy=rng.uniform(0.01, 0.99, (B, nh, nw, nl)),
                offset=rng.normal(size=(B, 3 * P, nh, nw, nl)),
                coordinates=rng.uniform(size=(B, P, 2)),
                bbox=rng.normal(size=(B, 5)))
    tgts = dict(ncf=rng.uniform(size=(B, P, nl, nw)),
                occupancy=rng.choice([-1.0, 0.0, 1.0], (B, nh, nw, nl)),
                offset=rng.normal(size=(B, 3, P, nh, nw, nl)),
                gt_corners_local=rng.normal(size=(B, P, 3)),
                gt_box_local=rng.normal(size=(B, 5)))
    f32 = lambda d, f: {k: f(v.astype(np.float32)) for k, v in d.items()}
    valid = np.array([True, True])
    cfg = jtiny(**HEADS)
    want = jl.vernier_losses(f32(outs, jnp.asarray), f32(tgts, jnp.asarray),
                             jnp.asarray(valid), cfg)
    got = tl.vernier_losses(f32(outs, torch.from_numpy),
                            f32(tgts, torch.from_numpy),
                            torch.from_numpy(valid), torch_vernier_config(cfg))
    assert list(got) == list(want)
    assert {"offset", "bbox"} <= set(got)
    for k in want:
        assert _rel(float(got[k]), float(want[k])) <= 1e-5, k


def _clip(grads, max_norm):
    """optax.clip_by_global_norm of a {name: array} dict."""
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads.values()))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {n: g * scale for n, g in grads.items()}


def _rel_l2(got, want):
    num = sum(((got[n] - w) ** 2).sum() for n, w in want.items())
    return np.sqrt(num / sum((w ** 2).sum() for w in want.values()))


@pytest.fixture(scope="module")
def offset_step():
    """Two whole train steps with the offset head in each package (the
    port's ``train_step`` assembles its own inputs and targets from the
    seeded batch), from the same variables: the setup of
    tests/test_torch_train.py with ``use_part_reg_head=True``.  Beside
    them, JAX's loss and gradient of step 0 evaluated apart from its
    jitted step: ``assemble_instances`` and ``make_targets`` first, then
    the train-mode forward, ``vernier_losses`` and the backward."""
    jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE,
                 use_part_reg_head=True)
    tcfg = torch_vernier_config(jcfg)
    jtc = JTrainConfig(**TC)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    jmod = JVernier(jcfg)
    v = random_variables(jmod, x, x, p, p, seed=3)
    a = jbatch(jcfg, seed=0)

    jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v["batch_stats"],
                    opt_state=jmake_optimizer(jtc).init(v["params"]))
    jstep = jmake_train_step(jmod, jcfg, jtc)
    j_after = []
    for _ in range(2):
        jstate, _ = jstep(jstate, a, jax.random.PRNGKey(1))
        j_after.append(jax.device_get(jstate))

    grid = jnp.asarray(jgrid(jcfg))
    inputs = jassemble(*(jnp.asarray(a[k]) for k in ASSEMBLE_KEYS), grid,
                       jcfg)
    targets = jmake_targets(*(jnp.asarray(a[k]) for k in TARGET_KEYS), grid,
                            jcfg)

    def jloss(params):
        out, _ = jmod.apply({"params": params,
                             "batch_stats": v["batch_stats"]}, *inputs,
                            train=True, mutable=["batch_stats"])
        losses = jl.vernier_losses(out, targets, jnp.asarray(a["valid"]),
                                   jcfg)
        return losses["total"], losses

    (_, jm), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        v["params"])

    model = VernierScale(tcfg, device="cpu")
    model.load_state_dict(convert_variables(v), strict=True)
    state = create_train_state(model, tcfg, TrainConfig(**TC))
    step = make_train_step(tcfg, TrainConfig(**TC), "cpu")
    batch = batch_to_device(synthetic_batch_arrays(tcfg, seed=0), "cpu")
    t_after = []
    for i in range(2):
        m = step(state, batch)
        if i == 0:
            tm = {k: float(t) for k, t in m.items()}
            grads = {n: q.grad.numpy().copy()
                     for n, q in model.named_parameters()}
        t_after.append({k: t.clone() for k, t in model.state_dict().items()})
    want = {n: t.numpy() for n, t in convert_variables(
        {"params": jgrads}).items()}
    jit_grads = {n: t.numpy() / 0.1 for n, t in convert_variables(
        {"params": j_after[0].opt_state[1][0].mu}).items()}
    return dict(jm={k: float(t) for k, t in jm.items()}, tm=tm,
                want=_clip(want, TC["grad_clip"]), jit_grads=jit_grads,
                grads=grads, j_after=j_after, t_after=t_after)


def test_offset_head_step_losses_match_jax(offset_step):
    """The port's step-0 losses against JAX's, to 1e-4 relative.  JAX's
    jitted step is not the reference here: its offset loss lies 2.2e-3
    from JAX's own evaluation of the same function apart (XLA fuses the
    assembly into the model there), while the port's lies 2e-6 from it."""
    jm, tm = offset_step["jm"], offset_step["tm"]
    assert set(tm) - {"grad_norm"} == set(jm) and "offset" in tm
    for k in jm:
        assert np.isfinite(tm[k]), k
        assert _rel(tm[k], jm[k]) <= 1e-4, (k, tm[k], jm[k])


def test_offset_head_step_grads_match_jax(offset_step):
    """The port's clipped step-0 gradients against JAX's (clipped by the
    same rule), global relative L2 within 5e-3 (measured 3.5e-3; with
    the offset head off the same comparison reads 6.7e-3, so the gap is
    the two float32 backwards through the tiny encoder's train-mode
    BatchNorm, not the head's).  JAX's jitted step lies 17x further
    from that reference than the port does; the test holds it so."""
    want, grads = offset_step["want"], offset_step["grads"]
    assert set(want) == set(grads)
    head = [n for n in grads if "Conv3d_1" in n or "ConvNorm3d_5" in n]
    assert head and all(np.abs(grads[n]).sum() > 0 for n in head)
    port = _rel_l2(grads, want)
    assert port <= 5e-3
    assert port <= _rel_l2(offset_step["jit_grads"], want)


def test_offset_head_step_batch_stats_match_jax(offset_step):
    """After step 0, at tests/test_torch_train.py's margin."""
    want = convert_variables(
        {"batch_stats": offset_step["j_after"][0].batch_stats})
    assert want
    for name, w in want.items():
        got = offset_step["t_after"][0][name]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(w.numpy()).max(),
                                   err_msg=name)


def test_offset_head_step_params_match_jax(offset_step):
    """After steps 0-1, at tests/test_torch_train.py's margin: every
    parameter within the sign-flip bound 2 x (sum of the rates) of JAX's
    jitted step's, and 97 % within 1e-5."""
    want = convert_variables({"params": offset_step["j_after"][1].params})
    got = offset_step["t_after"][1]
    flip = 2.0 * sum(learning_rate(TrainConfig(**TC), c)
                     for c in range(2)) + 1e-6
    err = np.concatenate([np.abs(got[n].numpy() - w.numpy()).ravel()
                          for n, w in want.items()])
    assert err.max() <= flip
    assert (err <= 1e-5).mean() >= 0.97


def test_bbox_head_fc_model_train_mode_matches_jax():
    """JAX's FCModel as the bbox head builds it, with p_dropout=0, against
    the port's in train mode: outputs and the moved running statistics."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (6, 18)).astype(np.float32)
    jmod = JFCModel(num_blocks=1, num_neurons=128, output_size=5,
                    p_dropout=0.0)
    v = random_variables(jmod, jnp.asarray(x), seed=7)
    want, upd = jmod.apply(v, jnp.asarray(x), train=True,
                           mutable=["batch_stats"])
    model = FCModel(18, num_neurons=128, num_blocks=1, output_size=5,
                    p_dropout=0.0)
    model.load_state_dict(convert_variables(v), strict=True)
    model.train()
    got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    stats = convert_variables({"batch_stats": upd["batch_stats"]})
    sd = model.state_dict()
    for name, w in stats.items():
        np.testing.assert_allclose(sd[name].numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def test_dropout_mask_rate_scale_and_seeding():
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(3)
    y = dropout(x, 0.5, True, gen)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.005
    assert torch.equal(y[kept], torch.full_like(y[kept], 2.0))
    y2 = dropout(x, 0.5, True, torch.Generator().manual_seed(3))
    assert torch.equal(y, y2)
    assert not torch.equal(y, dropout(x, 0.5, True,
                                      torch.Generator().manual_seed(4)))
    y = dropout(x, 0.25, True, gen)
    assert abs((y != 0).float().mean().item() - 0.75) < 0.005
    assert torch.allclose(y[y != 0], torch.tensor(1 / 0.75))
    assert dropout(x, 0.5, False, None) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.5, True, None)
    # the bbox head: train mode draws, eval mode does not
    model = FCModel(18, num_neurons=16, num_blocks=1, output_size=5)
    inp = torch.randn(8, 18, generator=torch.Generator().manual_seed(0))
    a = model(inp, torch.Generator().manual_seed(1))
    b = model(inp, torch.Generator().manual_seed(2))
    assert not torch.equal(a, b)
    model.eval()
    assert torch.equal(model(inp), model(inp, torch.Generator()))


def test_bbox_head_trains():
    """A step with both heads: the bbox and offset losses and the bbox
    head's gradients are finite, and its dropout draws from the step's
    generator (two runs from the same state give the same step)."""
    cfg = torch_vernier_config(jtiny(max_instances=4, image_size=IMAGE_SIZE,
                                     **HEADS))
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=1), "cpu")
    out = []
    for _ in range(2):
        model = VernierScale(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(8))
        state = create_train_state(model, cfg, TrainConfig(**TC))
        m = make_train_step(cfg, TrainConfig(**TC), "cpu")(state, batch)
        fc = [q.grad for n, q in model.named_parameters() if "FCModel" in n]
        assert fc and all(torch.isfinite(g).all() for g in fc)
        assert any(g.abs().sum() > 0 for g in fc)
        out.append({k: float(v) for k, v in m.items()})
    assert out[0] == out[1]
    assert np.isfinite(out[0]["bbox"]) and np.isfinite(out[0]["offset"])
