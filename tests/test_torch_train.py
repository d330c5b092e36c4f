"""Vernier training of the port (snvc_tpu_torch/training/train.py) against
the JAX train step (snvc_tpu/training/train.py), both on the CPU.

Setup of JAX tests/test_training.py:22-29 (``tiny_vernier_config(
max_instances=4)`` in float32, ``TrainConfig(lr=1e-3, warmup_steps=2,
total_steps=50, grad_clip=5.0)``, the seeded ``synthetic_batch_arrays``
batch), with one change: the images are 384x1280, the default KITTI
calibration's frame.  At JAX's 128x256 every ROI of that calibration
lies outside the image, so the ROIs are constant, the first BatchNorm
sees channels with |mean| ~8 and variance ~3e-4, and the float32 batch
statistics are ill-conditioned: JAX's own mean was 5.6e-4 and variance
7e-3 off a float64 evaluation there, while the port's were 7e-7 and
1.4e-5.  Both sides start from the same numpy-drawn variables (the
port's through utils/convert_jax.py).

Step 0 has rate 0, so after it the parameters are unchanged and the
optimizer's first moment holds 0.1 x the clipped gradient: JAX's
gradients are read from there.  The tolerances are JAX's own float32
error.  Measured against the port run in float64 on the same inputs: the
losses of JAX are off by up to 3e-4 relative (the port's by 1e-7); its
clipped gradients by 2.8 % (global relative L2) and 10.7 % (worst tensor,
relative to the tensor's largest element), the port's by 0.06 % and
0.5 %.  Adam's first nonzero update is lr x sign(g) (the step-0 and step-1
gradients are equal), so a gradient element within that noise of zero
flips its update: ~1 % of the parameters differ by 2 x lr after two
steps, and the rest agree within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_vernier_config as jtiny
from snvc_tpu.data.synthetic import synthetic_batch_arrays as jbatch
from snvc_tpu.models.vernier import VernierScale as JVernier
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train import make_train_step as jmake_train_step
from snvc_tpu_torch.config import TrainConfig
from snvc_tpu_torch.data.synthetic import synthetic_batch_arrays
from snvc_tpu_torch.models.vernier import VernierScale
from snvc_tpu_torch.training.train import (
    batch_to_device,
    create_train_state,
    load_checkpoint,
    make_train_step,
    save_checkpoint,
)
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables, torch_vernier_config

IMAGE_SIZE = (384, 1280)
TC = dict(lr=1e-3, warmup_steps=2, total_steps=50, grad_clip=5.0)


def _port_state(tcfg, variables):
    model = VernierScale(tcfg, device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    return create_train_state(model, tcfg, TrainConfig(**TC))


@pytest.fixture(scope="module")
def runs():
    """Three JAX steps and three port steps from the same variables; the
    states after step 0 and after step 2, and each side's metrics."""
    jcfg = jtiny(max_instances=4, image_size=IMAGE_SIZE)
    tcfg = torch_vernier_config(jcfg)
    jtc = JTrainConfig(**TC)
    H, W = jcfg.resolution
    nh, nw, nl = jcfg.grid_resolution
    x = np.zeros((1, H, W, 3), np.float32)
    p = np.zeros((1, nh * nw * nl, 2), np.float32)
    jmod = JVernier(jcfg)
    v = random_variables(jmod, x, x, p, p, seed=3)
    batch = jbatch(jcfg, seed=0)

    jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                    batch_stats=v["batch_stats"],
                    opt_state=jmake_optimizer(jtc).init(v["params"]))
    jstep = jmake_train_step(jmod, jcfg, jtc)
    j_after, j_metrics = [], []
    for _ in range(3):
        jstate, m = jstep(jstate, batch, jax.random.PRNGKey(1))
        j_after.append(jax.device_get(jstate))
        j_metrics.append({k: float(a) for k, a in m.items()})

    state = _port_state(tcfg, v)
    step = make_train_step(tcfg, TrainConfig(**TC), "cpu")
    tb = batch_to_device(synthetic_batch_arrays(tcfg, seed=0), "cpu")
    t_after, t_metrics = [], []
    for i in range(3):
        t_metrics.append({k: float(a) for k, a in step(state, tb).items()})
        if i == 0:
            grads = {n: p.grad.clone()
                     for n, p in state.model.named_parameters()}
        t_after.append({k: a.clone() for k, a in
                        state.model.state_dict().items()})
    return dict(j_after=j_after, j_metrics=j_metrics, t_after=t_after,
                t_metrics=t_metrics, grads=grads, tcfg=tcfg, batch=tb,
                variables=v)


def _lr(count):
    from snvc_tpu_torch.training.train import learning_rate

    return learning_rate(TrainConfig(**TC), count)


def test_losses_match_jax(runs):
    """Steps 0 and 1 see the same parameters on both sides; step 2 sees
    the sign-flipped updates of step 1, which moved its losses by up to
    1.2 % (coordinates)."""
    for i, (jm, tm) in enumerate(zip(runs["j_metrics"], runs["t_metrics"])):
        for k in ("ncf", "occupancy", "coordinates", "total", "grad_norm"):
            np.testing.assert_allclose(tm[k], jm[k],
                                       rtol=1e-3 if i < 2 else 3e-2,
                                       err_msg=f"step {i} {k}")


def test_grads_match_jax(runs):
    mu = runs["j_after"][0].opt_state[1][0].mu
    want = convert_variables({"params": mu})
    assert set(want) == set(runs["grads"])
    num = den = 0.0
    for name, g in runs["grads"].items():
        w = want[name].numpy() / 0.1
        err = np.abs(g.numpy() - w).max()
        assert err <= 0.2 * np.abs(w).max() + 1e-7, (name, err)
        num += ((g.numpy() - w) ** 2).sum()
        den += (w ** 2).sum()
    assert np.sqrt(num / den) <= 0.06


def test_batch_stats_match_jax(runs):
    want = convert_variables({"batch_stats": runs["j_after"][0].batch_stats})
    assert want
    for name, w in want.items():
        got = runs["t_after"][0][name]
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(w.numpy()).max(),
                                   err_msg=name)


@pytest.mark.parametrize("after", [1, 2])
def test_params_match_jax(runs, after):
    """After steps 0-1 and 0-2: every parameter within the sign-flip bound
    2 x (sum of the rates) of JAX's, and most far closer."""
    want = convert_variables({"params": runs["j_after"][after].params})
    got = runs["t_after"][after]
    flip = 2.0 * sum(_lr(c) for c in range(after + 1)) + 1e-6
    err = np.concatenate([np.abs(got[n].numpy() - w.numpy()).ravel()
                          for n, w in want.items()])
    assert err.max() <= flip
    if after == 1:
        assert (err <= 1e-5).mean() >= 0.97
    else:
        assert np.median(err) <= 1e-4


def test_loss_decreases_over_ten_steps():
    cfg = torch_vernier_config(jtiny(max_instances=4,
                                     image_size=IMAGE_SIZE))
    model = VernierScale(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(model, cfg, TrainConfig(**TC))
    step = make_train_step(cfg, TrainConfig(**TC), "cpu")
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=0), "cpu")
    losses = [float(step(state, batch)["total"]) for _ in range(10)]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 10


def test_checkpoint_round_trip(runs, tmp_path):
    cfg = runs["tcfg"]
    state = _port_state(cfg, runs["variables"])
    step = make_train_step(cfg, TrainConfig(**TC), "cpu")
    for _ in range(2):
        step(state, runs["batch"])
    path = save_checkpoint(str(tmp_path), state, cfg, state.step)
    assert path.endswith("2.pt") and (tmp_path / "config.json").exists()
    fresh = _port_state(cfg, runs["variables"])
    tree, at = load_checkpoint(str(tmp_path), fresh)
    assert at == 2 and fresh.step == 2
    for name, t in state.model.state_dict().items():
        assert torch.equal(fresh.model.state_dict()[name], t), name
    # the restored state takes the same next step
    a = step(state, runs["batch"])
    b = step(fresh, runs["batch"])
    assert float(a["total"]) == float(b["total"])
    for (n, p), q in zip(state.model.named_parameters(),
                         fresh.model.parameters()):
        assert torch.equal(p, q), n


def test_remat_updates_batch_stats_once():
    """With BatchNorm inside the rematerialized 3D hourglass (gn=False),
    its recompute in the backward leaves the running statistics as one
    forward leaves them, and the gradients are those without remat."""
    cfg = torch_vernier_config(jtiny(max_instances=4, image_size=IMAGE_SIZE,
                                     gn=False))
    batch = batch_to_device(synthetic_batch_arrays(cfg, seed=1), "cpu")
    runs = []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        model = VernierScale(c, device="cpu",
                             generator=torch.Generator().manual_seed(2))
        state = create_train_state(model, c, TrainConfig(**TC))
        make_train_step(c, TrainConfig(**TC), "cpu")(state, batch)
        runs.append((dict(model.named_buffers()),
                     [p.grad for p in model.parameters()]))
    (stats, grads), (stats_r, grads_r) = runs
    # the hourglass's buffers carry another name under remat
    for (n, a), b in zip(stats.items(), stats_r.values()):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-6, msg=n)
    for a, b in zip(grads, grads_r):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-6)
