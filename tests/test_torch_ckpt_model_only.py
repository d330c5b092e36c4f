"""A model-only checkpoint: the ``<step>.pt`` holding ``{"step", "model"}``
that scripts/convert_jax_checkpoint.py writes from JAX weights.

``training/train.load_checkpoint(dir, state)`` restores its model and
step count and leaves the optimizer fresh; ``demo_two_stage``'s
``--reuse_stereo`` path takes it as stage 1.  The file is written by the
converter's own ``convert`` from an Orbax checkpoint of tiny JAX
variables (numpy-drawn, saved with JAX's ``save_checkpoint``) at the
stereo config that ``demo_two_stage --smoke`` builds.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scripts.convert_jax_checkpoint import convert
from snvc_tpu import config as jconfig
from snvc_tpu.models.stereonet import StereoNet as JStereoNet
from snvc_tpu.training.train import TrainState as JState
from snvc_tpu.training.train import make_optimizer as jmake_optimizer
from snvc_tpu.training.train import save_checkpoint as jsave_checkpoint
from snvc_tpu_torch.config import TrainConfig, save_config
from snvc_tpu_torch.data.stereo import synthetic_stereo_request
from snvc_tpu_torch.data.synthetic import make_synthetic_kitti
from snvc_tpu_torch.models.stereonet import StereoNet
from snvc_tpu_torch.tools import demo_two_stage
from snvc_tpu_torch.training.train import load_checkpoint
from snvc_tpu_torch.training.train_stereo import create_stereo_state
from snvc_tpu_torch.utils.convert_jax import convert_variables
from tests.torch_port_helpers import random_variables

STEP = 7


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(demo args, the converted directory, the JAX variables)."""
    root = tmp_path_factory.mktemp("model_only")
    args = demo_two_stage.parse_args([
        "--smoke", "--reuse_stereo", "--dtype", "float32", "--device", "cpu",
        "--work_dir", str(root / "work")])
    tcfg = demo_two_stage.stereo_config(args)
    cfg_path = str(root / "stereo.json")
    save_config(tcfg, cfg_path)
    jcfg = jconfig.load_config(cfg_path, jconfig.StereoConfig)
    req = synthetic_stereo_request(tcfg, seed=0)
    v = random_variables(JStereoNet(jcfg),
                         req["images_left"].astype(np.float32),
                         req["images_right"].astype(np.float32),
                         req["P_left"], req["P_right"], seed=4)
    opt = jmake_optimizer(jconfig.TrainConfig()).init(v["params"])
    jsave_checkpoint(str(root / "orbax"),
                     JState(step=jnp.asarray(STEP, jnp.int32),
                            params=v["params"],
                            batch_stats=v["batch_stats"], opt_state=opt),
                     jcfg, STEP)
    out = os.path.join(args.work_dir, "stereo_ckpt")
    assert convert(str(root / "orbax"), out).endswith(f"{STEP}.pt")
    return args, out, v


def _assert_converted_weights(model, variables):
    want = convert_variables(variables)
    got = model.state_dict()
    assert set(want) <= set(got)
    for k, w in want.items():
        assert torch.equal(got[k].cpu(), w), k


def test_converted_file_holds_the_model_only(converted):
    _, out, _ = converted
    tree = torch.load(os.path.join(out, f"{STEP}.pt"), weights_only=True)
    assert set(tree) == {"step", "model"}


def test_load_checkpoint_restores_a_model_only_file(converted):
    args, out, v = converted
    cfg = demo_two_stage.stereo_config(args)
    state = create_stereo_state(StereoNet(cfg, device="cpu"),
                                TrainConfig())
    tree, step = load_checkpoint(out, state)
    assert step == STEP and state.step == STEP
    assert "optimizer" not in tree
    assert state.optimizer.state_dict()["state"] == {}
    _assert_converted_weights(state.model, v)


def test_demo_two_stage_reuses_the_converted_stage1(converted, tmp_path):
    args, _, v = converted
    train_root = str(tmp_path / "train")
    make_synthetic_kitti(train_root, 1, 1, seed=0, split="train")
    logs = []
    model, state, _ = demo_two_stage.train_stereo_stage(
        args, train_root, logs.append, "cpu")
    assert state.step == STEP
    assert any("reusing stage-1 checkpoint at step 7" in m for m in logs)
    _assert_converted_weights(model, v)
