"""The pieces of the port's Vernier training step against the JAX
package, on the CPU in float32:

* ``make_targets`` (ops/assemble.py, ops/points_in_boxes.py,
  ops/heatmaps.py): ncf, occupancy and gt_corners_local;
* each loss term of models/losses.py, and ``vernier_losses``' gradient
  with respect to the outputs;
* train-mode ``BatchNorm`` (models/layers.py) against flax
  ``nn.BatchNorm(momentum=0.9)``: output, running statistics, gradients;
* the rate schedule, the clip and the AdamW update of
  training/train.py against optax.

Tolerances: exact where both sides compute the same float32 operations
in the same order (targets), else float32 noise (1e-6 relative for
scalars, 1e-5 for reductions over ~1e4 elements); bf16 BatchNorm within
one bf16 ulp.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as nn

from snvc_tpu.config import tiny_vernier_config
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jax_batch
from snvc_tpu.models import losses as jl
from snvc_tpu.ops.assemble import make_grid_local as jgrid
from snvc_tpu.ops.assemble import make_targets as jtargets
from snvc_tpu.ops.heatmaps import bev_part_heatmaps as jheatmaps
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.models import losses as tl
from snvc_tpu_torch.models.layers import BatchNorm
from snvc_tpu_torch.ops.assemble import make_grid_local, make_targets
from snvc_tpu_torch.ops.heatmaps import bev_part_heatmaps
from snvc_tpu_torch.training.train import (
    clip_by_global_norm,
    learning_rate,
    make_optimizer,
)
from tests.torch_port_helpers import torch_vernier_config

TARGET_KEYS = ("samples", "gt_boxes", "points", "points_valid")


# ----------------------------------------------------------- targets ----
@pytest.mark.parametrize("seed,grid,subvoxel", [
    (0, (8, 16, 16), False),
    (1, (8, 24, 32), True),    # fractional part centers
])
def test_make_targets_match_jax(seed, grid, subvoxel):
    jcfg = tiny_vernier_config(max_instances=6, image_size=(128, 256),
                               grid_resolution=grid, sigma=2,
                               ncf_subvoxel=subvoxel)
    tcfg = torch_vernier_config(jcfg)
    b = jax_batch(jcfg, seed=seed)
    grid_local = make_grid_local(tcfg)
    want = jtargets(*(jnp.asarray(b[k]) for k in TARGET_KEYS),
                    jnp.asarray(jgrid(jcfg)), jcfg)
    got = make_targets(*(torch.as_tensor(b[k]) for k in TARGET_KEYS),
                       torch.from_numpy(grid_local), tcfg)
    assert set(got) == {"ncf", "occupancy", "gt_corners_local"}
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
    occ = got["occupancy"].numpy()
    # all three labels occur: the test reaches every branch
    assert {-1.0, 0.0, 1.0} <= set(np.unique(occ).tolist())


def test_bev_heatmaps_match_jax():
    rng = np.random.default_rng(3)
    centers = rng.uniform(-4, 20, (3, 9, 2)).astype(np.float32)
    for quantize in (True, False):
        want = jheatmaps(jnp.asarray(centers), (16, 12), 2, quantize)
        got = bev_part_heatmaps(torch.from_numpy(centers), (16, 12), 2,
                                quantize)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)


# ------------------------------------------------------------ losses ----
def _outputs_targets(seed, B=4, P=9, grid=(6, 8, 10)):
    rng = np.random.default_rng(seed)
    nh, nw, nl = grid
    out = dict(
        ncf=rng.standard_normal((B, P, nl, nw)).astype(np.float32),
        occupancy=rng.uniform(0, 1, (B, nh, nw, nl)).astype(np.float32),
        coordinates=rng.uniform(0, 1, (B, P, 2)).astype(np.float32))
    out["occupancy"][0, 0, 0, :3] = [0.0, 1.0, 1e-9]  # clipped ends
    tgt = dict(
        ncf=np.where(rng.uniform(size=(B, P, nl, nw)) < 0.3,
                     rng.uniform(0, 1, (B, P, nl, nw)), 0.0).astype(
                         np.float32),
        occupancy=rng.choice([-1.0, 0.0, 1.0], (B, nh, nw, nl)).astype(
            np.float32),
        gt_corners_local=rng.uniform(-2.5, 2.5, (B, P, 3)).astype(
            np.float32))
    valid = np.array([True, True, False, True][:B])
    return out, tgt, valid


def _t(d):
    return {k: torch.from_numpy(v) for k, v in d.items()}


def test_loss_terms_match_jax():
    out, tgt, valid = _outputs_targets(0)
    to, tt, tv = _t(out), _t(tgt), torch.from_numpy(valid)
    xr, zr = (-2.4, 2.4), (-2.4, 2.4)
    pairs = [
        (jl.voxel_mse_loss(out["ncf"], tgt["ncf"], valid),
         tl.voxel_mse_loss(to["ncf"], tt["ncf"], tv)),
        (jl.voxel_mse_loss_weighted(out["ncf"], tgt["ncf"], valid),
         tl.voxel_mse_loss_weighted(to["ncf"], tt["ncf"], tv)),
        (jl.occupancy_loss(out["occupancy"], tgt["occupancy"], valid),
         tl.occupancy_loss(to["occupancy"], tt["occupancy"], tv)),
        (jl.coordinate_loss(out["coordinates"], tgt["gt_corners_local"],
                            valid, xr, zr),
         tl.coordinate_loss(to["coordinates"], tt["gt_corners_local"], tv,
                            xr, zr)),
        (jl._masked_mean(out["ncf"], out["ncf"] > 0),
         tl._masked_mean(to["ncf"], to["ncf"] > 0)),
    ]
    for want, got in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    # nothing valid: the masked mean divides by max(count, 1)
    none = np.zeros(4, bool)
    assert float(tl.voxel_mse_loss(to["ncf"], tt["ncf"],
                                   torch.from_numpy(none))) == 0.0


@pytest.mark.parametrize("ncf_loss", ["mse", "mse_weighted"])
def test_vernier_losses_and_output_grads_match_jax(ncf_loss):
    out, tgt, valid = _outputs_targets(1)
    jcfg = tiny_vernier_config(ncf_loss=ncf_loss)
    tcfg = torch_vernier_config(jcfg)

    def jtotal(o):
        return jl.vernier_losses(o, tgt, valid, jcfg, occupancy_weight=0.7,
                                 coordinate_weight=0.1)["total"]

    want = jl.vernier_losses(out, tgt, valid, jcfg, occupancy_weight=0.7)
    wgrad = jax.grad(jtotal)(out)
    to = {k: v.requires_grad_() for k, v in _t(out).items()}
    got = tl.vernier_losses(to, _t(tgt), torch.from_numpy(valid), tcfg,
                            occupancy_weight=0.7)
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]),
                                   rtol=1e-5, err_msg=k)
    got["total"].backward()
    for k, t in to.items():
        w = np.asarray(wgrad[k])
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


# -------------------------------------------------------- BatchNorm ----
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_batchnorm_matches_flax(dtype):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((3, 6, 5, 8)) * 2.0 + 1.5).astype(np.float32)
    gy = rng.standard_normal(x.shape).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x = np.array(jnp.asarray(x).astype(jdt).astype(jnp.float32))
    params = {"scale": (1.0 + 0.1 * rng.standard_normal(8)).astype(np.float32),
              "bias": (0.1 * rng.standard_normal(8)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.standard_normal(8)).astype(np.float32),
             "var": rng.uniform(0.5, 1.5, 8).astype(np.float32)}
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, dtype=jdt)

    def f(p, xx):
        y, new = bn.apply({"params": p, "batch_stats": stats},
                          xx.astype(jdt), mutable=["batch_stats"])
        return (y.astype(jnp.float32) * gy).sum(), (y, new)

    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        f, (0, 1), has_aux=True)(params, jnp.asarray(x))
    t = BatchNorm(8)
    with torch.no_grad():
        t.weight.copy_(torch.from_numpy(params["scale"]))
        t.bias.copy_(torch.from_numpy(params["bias"]))
        t.running_mean.copy_(torch.from_numpy(stats["mean"]))
        t.running_var.copy_(torch.from_numpy(stats["var"]))
    t.train()
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    yt = t(xt)
    assert yt.dtype == tdt
    (yt.float() * torch.from_numpy(gy)).sum().backward()
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 1e-6
    want_y = np.asarray(y.astype(jnp.float32))
    np.testing.assert_allclose(yt.float().detach().numpy(), want_y, rtol=ulp,
                               atol=ulp * np.abs(want_y).max())
    for name, w in (("running_mean", new["batch_stats"]["mean"]),
                    ("running_var", new["batch_stats"]["var"])):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    for got, w in ((t.weight.grad, gp["scale"]), (t.bias.grad, gp["bias"]),
                   (xt.grad.float(), gx)):
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(got.numpy(), w, rtol=0,
                                   atol=10 * ulp * np.abs(w).max())
    # eval mode reads the running statistics and leaves them alone
    t.eval()
    before = t.running_mean.clone()
    t(xt.detach())
    assert torch.equal(t.running_mean, before)


# -------------------------------------------------------- optimizer ----
@pytest.mark.parametrize("warmup,total", [(50, 500), (0, 300), (500, 80000)])
def test_learning_rate_matches_optax(warmup, total):
    tc = TrainConfig(lr=2e-3, warmup_steps=warmup, total_steps=total)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=tc.lr, warmup_steps=warmup,
        decay_steps=max(total, warmup + 1))
    counts = np.arange(0, 600)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts)))
    got = np.array([learning_rate(tc, int(c)) for c in counts])
    # optax evaluates in float32: within its rounding of the peak rate
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * tc.lr)
    if warmup:  # read before the update: the first step moves nothing
        assert learning_rate(tc, 0) == 0.0


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_by_global_norm_matches_optax(scale):
    rng = np.random.default_rng(5)
    grads = [(rng.standard_normal(s) * scale).astype(np.float32)
             for s in ((3, 4), (7,), (2, 2, 5))]
    clip = optax.clip_by_global_norm(5.0)
    want, _ = clip.update([jnp.asarray(g) for g in grads], clip.init(None))
    tg = [torch.from_numpy(g.copy()) for g in grads]
    norm = clip_by_global_norm(tg, 5.0)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)),
                               rtol=1e-6)
    for a, b in zip(tg, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-7)


def test_adamw_steps_match_optax():
    """Clip, then AdamW at the scheduled rate with decoupled decay of every
    parameter: three steps of the port's optimizer on fixed gradients
    against the JAX package's optax chain."""
    from snvc_tpu.config import TrainConfig as JTrainConfig

    tc = TrainConfig(lr=1e-2, weight_decay=0.05, warmup_steps=1,
                     total_steps=10, grad_clip=1.0)
    rng = np.random.default_rng(6)
    params = [rng.standard_normal(s).astype(np.float32)
              for s in ((4, 3), (5,))]
    grads = [[rng.standard_normal(p.shape).astype(np.float32) * 0.7
              for p in params] for _ in range(3)]
    jopt = jmake_optimizer(JTrainConfig(**{f: getattr(tc, f) for f in (
        "lr", "weight_decay", "warmup_steps", "total_steps", "grad_clip")}))
    jp = [jnp.asarray(p) for p in params]
    state = jopt.init(jp)
    for g in grads:
        upd, state = jopt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)

    module = torch.nn.Module()
    module.p = torch.nn.ParameterList(
        [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params])
    opt = make_optimizer(module, tc)
    for step, g in enumerate(grads):
        for p, x in zip(module.parameters(), g):
            p.grad = torch.from_numpy(x.copy())
        clip_by_global_norm([p.grad for p in module.parameters()],
                            tc.grad_clip)
        for group in opt.param_groups:
            group["lr"] = learning_rate(tc, step)
        opt.step()
    for p, w in zip(module.parameters(), jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-6)
