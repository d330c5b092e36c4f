"""Data-parallel stereo training of the port
(``training/train_stereo.make_stereo_train_step(mesh=)``,
parallel/api.py) on two gloo ranks of one frame each, against the port's
one-process step on the batch of 2 and against JAX's step on a 2-way
"data" mesh (``make_stereo_train_step(mesh=make_mesh(n_data=2,
n_model=1))``), on the CPU.

The setup of tests/test_torch_stereo_train.py ('sl1'): the JAX test's
``tiny_stereo_config(z_max=38.0, max_depth=40.0)`` (BatchNorm in the stem
and the first layer, whose moments the ranks sum), float32, the same
``TrainConfig``, numpy-drawn variables converted for the port; the batch
is ``synthetic_stereo_request(..., frames=2, boxes_per_frame=2)``.  Both
comparisons take that file's tolerances (JAX's own float32 drift; the
tiny input's SPP GroupNorm groups of 2 values amplify rounding, ROADMAP
Queue 3), but ``grad_norm`` is held to 2e-3, not 3e-4: at two frames
float32 reordering alone moves it further.  The port's one-process step
on the same two frames swapped gives a ``grad_norm`` 3.9e-4 from the
unswapped one (677.0254 against 676.7622); the ranks' 677.2315 and
JAX's mesh step's 676.9562 lie within 7e-4 of both (measured here; the
port's plain frustum resample takes no float64, so there is no float64
witness).  The ranks import the port only (tests/torch_parallel_ranks.py);
JAX runs in this process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from snvc_tpu.config import TrainConfig as JTrainConfig
from snvc_tpu.config import tiny_stereo_config as jax_tiny
from snvc_tpu.models.stereonet import StereoNet as JStereoNet
from snvc_tpu.parallel.api import make_mesh as jmake_mesh
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train_stereo import make_stereo_train_step as jmake
from snvc_tpu_torch.config import TrainConfig, tiny_stereo_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.training.train import learning_rate
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_parallel_ranks import (
    as_numpy,
    spawn_ranks,
    stereo_record,
    stereo_steps,
)
from tests.torch_port_helpers import random_variables

TC = dict(lr=3e-4, warmup_steps=1, total_steps=20, grad_clip=5.0)
LOSSES = ("total", "cls", "reg", "centerness", "depth", "num_pos",
          "grad_norm")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks run while this process takes JAX's mesh steps and the
    port's one-process steps."""
    over = dict(z_max=38.0, max_depth=40.0)
    jcfg, tcfg = jax_tiny(**over), tiny_stereo_config(**over)
    batch = synthetic_stereo_request(tcfg, seed=0, frames=2,
                                     boxes_per_frame=2)
    jmod = JStereoNet(jcfg)
    v = random_variables(jmod, batch["images_left"].astype(np.float32),
                         batch["images_right"].astype(np.float32),
                         batch["P_left"], batch["P_right"], seed=3)
    tc = TrainConfig(**TC)
    sd = as_numpy(convert_variables(v))
    with spawn_ranks(stereo_steps, 2,
                     str(tmp_path_factory.mktemp("stereo_dp")), tcfg, tc,
                     sd, as_numpy(batch)) as ranks:
        jtc = JTrainConfig(**TC)
        jstate = JState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"],
                        opt_state=jmake_optimizer(jtc).init(v["params"]))
        jstep = jmake(jmod, jcfg, jtc, mesh=jmake_mesh(n_data=2, n_model=1))
        j_after, j_metrics = [], []
        for _ in range(2):
            jstate, m = jstep(jstate, dict(batch))
            j_after.append(jax.device_get(jstate))
            j_metrics.append({k: float(a) for k, a in m.items()})
        one = stereo_record(tcfg, tc, sd, as_numpy(batch))
        return dict(j_after=j_after, j_metrics=j_metrics, ranks=ranks(),
                    one=one)


def _jax_record(runs):
    """JAX's steps as the port's record: metrics, the clipped gradients
    (step 0 has rate 0: the first moment holds 0.1 x them), the
    statistics after step 0 and the parameters after step 1."""
    mu = runs["j_after"][0].opt_state[1][0].mu
    return dict(
        metrics=runs["j_metrics"],
        grads={n: w / 0.1 for n, w in
               convert_variables({"params": mu}).items()},
        stats=convert_variables({"batch_stats":
                                 runs["j_after"][0].batch_stats}),
        params=convert_variables({"params": runs["j_after"][1].params}))


@pytest.fixture(scope="module", params=["jax_mesh", "one_process"])
def want(request, runs):
    return (_jax_record(runs) if request.param == "jax_mesh"
            else runs["one"])


def test_ranks_hold_the_same_state(runs):
    a, b = runs["ranks"]
    assert a["metrics"] == b["metrics"]
    for key in ("grads", "stats", "params"):
        for n, t in a[key].items():
            assert torch.equal(t, b[key][n]), (key, n)


def test_losses_match(runs, want):
    dp = runs["ranks"][0]
    for i in range(2):
        assert dp["metrics"][i]["num_pos"] > 0
        assert dp["metrics"][i]["depth"] > 0
        for k in LOSSES:
            rtol = 2e-3 if k == "grad_norm" else 3e-4
            np.testing.assert_allclose(dp["metrics"][i][k],
                                       want["metrics"][i][k], rtol=rtol,
                                       err_msg=f"step {i} {k}")


def test_grads_match(runs, want):
    grads = runs["ranks"][0]["grads"]
    assert set(want["grads"]) == set(grads)
    num = den = 0.0
    for name, g in grads.items():
        w = want["grads"][name]
        err = float((g - w).abs().max())
        assert err <= 0.15 * float(w.abs().max()) + 1e-7, (name, err)
        num += float(((g - w) ** 2).sum())
        den += float((w ** 2).sum())
    assert np.sqrt(num / den) <= 1.2e-2


def test_batch_stats_match(runs, want):
    assert want["stats"]
    got = runs["ranks"][0]["stats"]
    for name, w in want["stats"].items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * np.abs(w.numpy()).max(),
                                   err_msg=name)


def test_params_match(runs, want):
    """After steps 0-1: within the sign-flip bound 2 x lr, nearly all
    within 1e-6."""
    got = runs["ranks"][0]["params"]
    flip = 2.0 * sum(learning_rate(TrainConfig(**TC), c)
                     for c in range(2)) + 1e-6
    err = np.concatenate([(got[n] - w).abs().numpy().ravel()
                          for n, w in want["params"].items()])
    assert err.max() <= flip
    assert (err <= 1e-6).mean() >= 0.99
