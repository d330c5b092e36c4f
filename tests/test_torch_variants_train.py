"""One training step of each Vernier variant, the port against JAX on the
CPU: ``BEV_type2`` here; ``3D`` (with ``grid_type="3D"``), ``BEV``, and
``BEV_type3`` with ``add_xy`` and ``concat-atten`` (the w48 combination
at test size) in tests/test_torch_variants_train_{3d,bev,xy}.py, which
share the helpers below.  One head a file: each head's JAX step is a
compile of its own, and a file of two would pass a minute.

Setup of tests/test_torch_train_heads.py: ``tiny_vernier_config(
max_instances=4)`` at 384x1280 (the default calibration's frame), both
sides from the same numpy-drawn variables.  The port's ``train_step``
assembles its own inputs and targets from the seeded batch.  JAX's
witness is its own step in float64: ``assemble_instances`` and
``make_targets`` (float32, eager: JAX's jitted targets differ from its
eager ones where a point falls on a voxel edge, and the port follows the
eager ones), then, jitted under ``jax.enable_x64``, the train-mode
forward with the variables and the ROIs in float64, ``vernier_losses``
and the backward.  The float32 islands JAX writes into its layers
(FastGroupNorm's moments and the losses among them) stay float32 on both
sides.  The optimizer after the backward is shared by every head and
held to optax in tests/test_torch_train.py.

Held to JAX's float64 step, the port's float32 step at the port's
training rule: losses 1e-4 relative, clipped gradients 3e-3 global
relative L2, BatchNorm statistics after the step 1e-4 of scale.  The port's float64 step is held to it tightly (``TIGHT``, losses
1e-5), so that a difference in meaning shows above the rounding.
Measured on a CPU, global relative L2 of the clipped gradients from
JAX's float64 step, the port in float32 / in float64: BEV_type2 5.6e-6 /
4.3e-6, 3D 1.5e-3 / 5.9e-6, BEV 2.3e-4 / 1.4e-4, add_xy + concat-atten
6.4e-4 / 5.3e-6; BatchNorm statistics, of scale, at most 2.7e-5 /
2.1e-5 (BEV), elsewhere 1.9e-6 / 1.5e-6; losses at most 2.7e-6 / 2.2e-6
relative.  BEV is the ill-conditioned head: perturbing its variables by
6e-8 relative (float32's rounding) moves its float64 gradients by
5.5e-5, against 1.1e-6 to 2.5e-6 for the others, so the float32 islands
alone put the two float64 steps 1.4e-4 apart.  JAX's own jitted float32
step is no witness: it lies further from its float64 step than the
port's does (BEV_type2 1.0e-3, 3D 5.1e-3, BEV 3.3e-2, add_xy +
concat-atten 1.6e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import BackboneConfig as JBackbone
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.models import losses as jl
from snvc_tpu.models.vernier import VernierEncoder as JEncoder
from snvc_tpu.models.vernier import VernierHead as JHead
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.ops.assemble import assemble_instances as jassemble
from snvc_tpu.ops.assemble import make_grid_local as jgrid
from snvc_tpu.ops.assemble import make_targets as jmake_targets
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.models import vernier as vernier_module
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    make_train_step,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)  # see tests/test_torch_train.py
TC = dict(lr=1e-3, warmup_steps=2, total_steps=50, grad_clip=5.0)
TARGET_KEYS = ("samples", "gt_boxes", "points", "points_valid")
ASSEMBLE_KEYS = ("images_left", "images_right", "image_idx", "trans_l",
                 "trans_r", "samples", "P_left", "P_right")
VARIANTS = {
    "BEV_type2": dict(vernier_type="BEV_type2"),
    "BEV": dict(vernier_type="BEV"),
    "3D": dict(vernier_type="3D", grid_type="3D", num_parts=3),
    "xy_atten": dict(backbone=JBackbone(name="hrnet-tiny", add_xy=True),
                     feature_aggregation="concat-atten"),
}
# the port's float64 step against JAX's: (gradients, global relative L2;
# BatchNorm statistics, of scale); BEV's conditioning, see the docstring
TIGHT = {"BEV": (5e-4, 1e-4)}
TIGHT_DEFAULT = (2e-5, 1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: under the tier-1 command's six workers torch's per-core
    pool runs the train steps several times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clip(grads, max_norm):
    """optax.clip_by_global_norm of a {name: array} dict."""
    norm = np.sqrt(sum((g.astype(np.float64) ** 2).sum()
                       for g in grads.values()))
    scale = 1.0 if norm < max_norm else max_norm / norm
    return {n: g * scale for n, g in grads.items()}


def _rel_l2(got, want):
    num = sum(((got[n] - w) ** 2).sum() for n, w in want.items())
    return np.sqrt(num / sum((w ** 2).sum() for w in want.values()))


def _port_step(jcfg, variables, float64=False):
    """The port's step 0 from ``variables``: (metrics, clipped gradients,
    state dict); with ``float64``, the model runs in float64 (the
    sampler's weights, the GroupNorm moments and the losses stay float32,
    as in JAX's)."""
    tcfg = torch_vernier_config(jcfg)
    with pytest.MonkeyPatch.context() as mp:
        if float64:
            mp.setattr(vernier_module, "compute_dtype",
                       lambda name: torch.float64)
        model = VernierScale(tcfg, device="cpu")
        model.load_state_dict(convert_variables(variables), strict=True)
        if float64:
            model.double()
        state = create_train_state(model, tcfg, TrainConfig(**TC))
        step = make_train_step(tcfg, TrainConfig(**TC), "cpu")
        m = step(state, batch_to_device(
            synthetic_batch_arrays(tcfg, seed=0), "cpu"))
    return ({k: float(t) for k, t in m.items()},
            {n: q.grad.double().numpy() for n, q in model.named_parameters()},
            {k: t.double() for k, t in model.state_dict().items()})


def _jax_step64(jcfg, variables, a):
    """JAX's step 0 in float64 (the module docstring): (losses, clipped
    gradients, BatchNorm statistics after the step)."""
    jmod = JVernier(jcfg)
    grid = jnp.asarray(jgrid(jcfg))
    inputs = [np.asarray(t) for t in jassemble(
        *(jnp.asarray(a[k]) for k in ASSEMBLE_KEYS), grid, jcfg)]
    targets = {k: np.asarray(t) for k, t in jmake_targets(
        *(jnp.asarray(a[k]) for k in TARGET_KEYS), grid, jcfg).items()}

    def step(params, stats, inputs, targets, valid):
        def loss(params):
            out, upd = jmod.apply(
                {"params": params, "batch_stats": stats},
                *(t.astype(jnp.float64) for t in inputs), train=True,
                mutable=["batch_stats"])
            losses = jl.vernier_losses(out, targets, valid, jcfg)
            return losses["total"], (losses, upd["batch_stats"])

        return jax.value_and_grad(loss, has_aux=True)(params)

    def f64(tree):
        return jax.tree_util.tree_map(lambda t: np.asarray(t, np.float64),
                                      tree)

    with jax.enable_x64(True), pytest.MonkeyPatch.context() as mp:
        for cls in (JEncoder, JHead):
            mp.setattr(cls, "dtype", property(lambda self: jnp.float64))
        (_, (losses, stats)), grads = jax.jit(step)(
            f64(variables["params"]), f64(variables["batch_stats"]),
            inputs, targets, a["valid"])
        grads = {n: t.double().numpy() for n, t in convert_variables(
            {"params": jax.tree_util.tree_map(np.asarray, grads)}).items()}
        stats = {n: t.double() for n, t in convert_variables(
            {"batch_stats": jax.tree_util.tree_map(np.asarray,
                                                   stats)}).items()}
    return ({k: float(t) for k, t in losses.items()},
            _clip(grads, TC["grad_clip"]), stats)


def _run_step(name):
    """Step 0 of JAX in float64 and of the port in float32 and in
    float64, from the same variables and the same seeded batch."""
    jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE, **VARIANTS[name])
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    v = random_variables(JVernier(jcfg), x, x, p, p, seed=3)
    jm, want, want_stats = _jax_step64(jcfg, v, jbatch(jcfg, seed=0))
    return dict(name=name, vernier_type=jcfg.vernier_type, jm=jm, want=want,
                want_stats=want_stats,
                port=_port_step(jcfg, v),
                port64=_port_step(jcfg, v, float64=True))


def _check_losses(res):
    """Step-0 losses: float32 within 1e-4 relative of JAX's float64 step,
    float64 within 1e-5 (both sides' losses are float32)."""
    jm = res["jm"]
    heads = {"ncf"} if res["vernier_type"] == "3D" else {"ncf", "occupancy"}
    assert heads <= set(jm)
    for port, rel in ((res["port"], 1e-4), (res["port64"], 1e-5)):
        tm = port[0]
        assert set(tm) - {"grad_norm"} == set(jm)
        for k in jm:
            assert np.isfinite(tm[k]), k
            assert abs(tm[k] - jm[k]) <= rel * abs(jm[k]), (k, tm[k], jm[k])


def _check_grads(res):
    """Clipped gradients against JAX's float64 step, global relative L2:
    float32 within 3e-3, float64 within ``TIGHT``."""
    want = res["want"]
    tight = TIGHT.get(res["name"], TIGHT_DEFAULT)[0]
    for port, tol in ((res["port"], 3e-3), (res["port64"], tight)):
        assert set(port[1]) == set(want)
        assert _rel_l2(port[1], want) <= tol


def _check_stats(res):
    """BatchNorm statistics after the step against JAX's float64 step:
    float32 within 1e-4 of each one's scale, float64 within ``TIGHT``."""
    want = res["want_stats"]
    assert want
    tight = TIGHT.get(res["name"], TIGHT_DEFAULT)[1]
    for port, rel in ((res["port"], 1e-4), (res["port64"], tight)):
        for name, w in want.items():
            err = float((port[2][name] - w).abs().max())
            assert err <= rel * float(w.abs().max()), name


@pytest.fixture(scope="module", params=["BEV_type2"])
def step(request):
    return _run_step(request.param)


def test_variant_step_losses_match_jax(step):
    _check_losses(step)


def test_variant_step_grads_match_jax(step):
    _check_grads(step)


def test_variant_step_batch_stats_match_jax(step):
    _check_stats(step)
