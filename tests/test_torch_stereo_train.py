"""Stereo training of the port (snvc_tpu_torch/training/train_stereo.py)
against the JAX step (snvc_tpu/training/train_stereo.py), both on the CPU.

The JAX test's config, ``tiny_stereo_config(z_max=38.0, max_depth=40.0)``
(reslike50-det-tiny: BatchNorm in the stem and the first layer), float32,
``TrainConfig(lr=3e-4, warmup_steps=1, total_steps=20, grad_clip=5.0)``,
once with the 'sl1' depth loss and once with 'w1' and the per-plane depth
offset.  One seeded training frame (``synthetic_stereo_request(...,
boxes_per_frame=2)``: two cars, their surface points rasterized into
``depth_gt``) goes to both sides as numpy arrays; both start from the
same numpy-drawn variables (the port's through utils/convert_jax.py).
JAX runs its gather forms of K3 and K4 on the CPU, the port their plain
versions and plain backwards through ``PlaneSweepK3`` / ``FrustumK4``.

Step 0 has rate 0, so after it the parameters are unchanged and the
optimizer's first moment holds 0.1 x the clipped gradient: JAX's
gradients are read from there.  The tolerances are JAX's own float32
drift, measured as JAX's jitted step against the same step run eagerly
(``jax.disable_jit``) on this frame: losses 2.4e-4 relative (grad_norm),
clipped gradients 1.2e-2 global relative L2 and 13 % of the worst
tensor's scale (a 3D hourglass conv).  The tiny input's SPP branches,
whose GroupNorm groups hold 2 values (ROADMAP Queue 3), amplify rounding
in both frameworks.  The port against JAX measured 9.6e-5, 5.7e-3 and
4.8 % (sl1; w1 9.5e-6, 4.1e-3, 4.4 %), BatchNorm statistics 1e-6 of their
scale.  Step 1 is Adam's first nonzero update, lr x sign(g): a gradient
element within rounding of zero may flip its update, so every parameter
is held within 2 x lr, and 99 % within 1e-6 (measured 99.6 %).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.models.stereonet import StereoNet as JStereoNet
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train_stereo import make_stereo_train_step as jmake
from snvc_tpu_torch.config import TrainConfig, tiny_stereo_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.training.train import learning_rate
from snvc_tpu_torch.training.train_stereo import (
    create_stereo_state,
    make_stereo_train_step,
    stereo_batch_to_device,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables

TC = dict(lr=3e-4, warmup_steps=1, total_steps=20, grad_clip=5.0)
CONFIGS = {"sl1": {}, "w1": dict(depth_loss="w1", depth_offset=True)}
LOSSES = ("total", "cls", "reg", "centerness", "depth", "num_pos",
          "grad_norm")


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def runs(request):
    """Two JAX steps and two port steps from the same variables."""
    over = dict(z_max=38.0, max_depth=40.0, **CONFIGS[request.param])
    jcfg, tcfg = jax_tiny(**over), tiny_stereo_config(**over)
    batch = synthetic_stereo_request(tcfg, seed=0, boxes_per_frame=2)
    jmod = JStereoNet(jcfg)
    v = random_variables(jmod, batch["images_left"].astype(np.float32),
                         batch["images_right"].astype(np.float32),
                         batch["P_left"], batch["P_right"], seed=3)
    jtc = JTrainConfig(**TC)
    jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v["batch_stats"],
                    opt_state=jmake_optimizer(jtc).init(v["params"]))
    jstep = jmake(jmod, jcfg, jtc)
    j_after, j_metrics = [], []
    for _ in range(2):
        jstate, m = jstep(jstate, dict(batch))
        j_after.append(jax.device_get(jstate))
        j_metrics.append({k: float(a) for k, a in m.items()})

    model = StereoNet(tcfg, device="cpu")
    model.load_state_dict(convert_variables(v), strict=True)
    state = create_stereo_state(model, TrainConfig(**TC))
    step = make_stereo_train_step(tcfg, TrainConfig(**TC), "cpu")
    tb = stereo_batch_to_device(batch, "cpu")
    t_after, t_metrics = [], []
    for i in range(2):
        t_metrics.append({k: float(a) for k, a in step(state, tb).items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        t_after.append({k: a.clone() for k, a in model.state_dict().items()})
    return dict(j_after=j_after, j_metrics=j_metrics, t_after=t_after,
                t_metrics=t_metrics, grads=grads, name=request.param)


def test_losses_match_jax(runs):
    """Both steps see the same parameters (step 0's rate is 0); the frame
    has positives and depth pixels, so every term takes part."""
    for i, (jm, tm) in enumerate(zip(runs["j_metrics"], runs["t_metrics"])):
        assert tm["num_pos"] > 0 and tm["depth"] > 0
        for k in LOSSES:
            np.testing.assert_allclose(tm[k], jm[k], rtol=3e-4,
                                       err_msg=f"step {i} {k}")


def test_grads_match_jax(runs):
    mu = runs["j_after"][0].opt_state[1][0].mu
    want = convert_variables({"params": mu})
    assert set(want) == set(runs["grads"])
    num = den = 0.0
    for name, g in runs["grads"].items():
        w = want[name].numpy() / 0.1
        err = np.abs(g.numpy() - w).max()
        assert err <= 0.15 * np.abs(w).max() + 1e-7, (name, err)
        num += ((g.numpy() - w) ** 2).sum()
        den += (w ** 2).sum()
    assert np.sqrt(num / den) <= 1.2e-2
    if runs["name"] == "w1":  # the offset branch is trained
        assert float(runs["grads"]["head.Conv3d_1.weight"].abs().max()) > 0


def test_batch_stats_match_jax(runs):
    want = convert_variables({"batch_stats": runs["j_after"][0].batch_stats})
    assert want
    for name, w in want.items():
        got = runs["t_after"][0][name]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(w.numpy()).max(),
                                   err_msg=name)


def test_params_match_jax(runs):
    """After steps 0-1: every parameter within the sign-flip bound 2 x lr
    of JAX's, and nearly all within 1e-6."""
    want = convert_variables({"params": runs["j_after"][1].params})
    got = runs["t_after"][1]
    flip = 2.0 * sum(learning_rate(TrainConfig(**TC), c)
                     for c in range(2)) + 1e-6
    err = np.concatenate([np.abs(got[n].numpy() - w.numpy()).ravel()
                          for n, w in want.items()])
    assert err.max() <= flip
    assert (err <= 1e-6).mean() >= 0.99
