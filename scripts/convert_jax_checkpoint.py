"""Convert a JAX (Orbax) checkpoint of snvc_tpu into the PyTorch port's
format: ``<step>.pt`` (``{"step", "model"}``, the ``state_dict`` that
``VernierScale`` / ``StereoNet`` load with ``strict=True``) beside the
original ``config.json``, the layout the port's CLIs read as
``--model_dir``.

It runs on a CPU host that has JAX, Flax and Orbax: it restores the
checkpoint with the JAX package's own template state
(``create_train_state`` / ``create_stereo_state``, traced with
``jax.eval_shape`` and placed on the CPU, then
``snvc_tpu/training/train.py:load_checkpoint``) and converts the
variables with ``snvc_tpu_torch/utils/convert_jax.convert_variables``.
It imports JAX, so it is not part of the port (the port's import guard,
tests/test_torch_imports.py, leaves it out by name).

    python scripts/convert_jax_checkpoint.py \
        artifacts/two_stage_r4/vernier_ckpt build/converted/vernier
    python scripts/convert_jax_checkpoint.py \
        artifacts/two_stage_r4/stereo_ckpt build/converted/stereo

The kind of model (Vernier or stereo) is read from ``config.json``.  The
output goes under ``build/`` (gitignored) unless told otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
from typing import Dict, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def checkpoint_kind(ckpt_dir: str) -> str:
    """"vernier" or "stereo", from the checkpoint's config.json."""
    with open(os.path.join(ckpt_dir, "config.json")) as fh:
        d = json.load(fh)
    return "vernier" if "vernier_type" in d else "stereo"


def restore_jax_variables(ckpt_dir: str) -> Tuple[object, Dict, int]:
    """(JAX config, {"params", ["batch_stats"]} as numpy, step) of the
    latest checkpoint under ``ckpt_dir``."""
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from snvc_tpu import config as jconfig
    from snvc_tpu.training.train import load_checkpoint

    kind = checkpoint_kind(ckpt_dir)
    path = os.path.join(ckpt_dir, "config.json")
    rng = jax.random.PRNGKey(0)
    tc = jconfig.TrainConfig()
    if kind == "vernier":
        from snvc_tpu.models.vernier import VernierScale
        from snvc_tpu.training.train import create_train_state

        cfg = jconfig.load_config(path, jconfig.VernierConfig)
        make = lambda: create_train_state(VernierScale(cfg), cfg, tc, rng)
    else:
        from snvc_tpu.models.stereonet import StereoNet
        from snvc_tpu.training.train_stereo import create_stereo_state

        cfg = jconfig.load_config(path, jconfig.StereoConfig)
        make = lambda: create_stereo_state(StereoNet(cfg), cfg, tc, rng)
    # the template's shapes without running the init; placed on the CPU,
    # whatever devices the checkpoint was written from
    cpu = jax.sharding.SingleDeviceSharding(jax.devices("cpu")[0])
    template = jax.tree.map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=cpu),
        jax.eval_shape(make))
    tree, step = load_checkpoint(ckpt_dir, template)
    variables = {"params": jax.tree.map(np.asarray, tree["params"])}
    if tree.get("batch_stats"):
        variables["batch_stats"] = jax.tree.map(np.asarray,
                                                tree["batch_stats"])
    return cfg, variables, int(step)


def convert(ckpt_dir: str, out_dir: str) -> str:
    """Write ``out_dir/<step>.pt`` and ``out_dir/config.json``; returns
    the .pt path.  The weights load into the port's model strictly."""
    import torch

    from snvc_tpu_torch.config import StereoConfig, VernierConfig, load_config
    from snvc_tpu_torch.utils.convert_jax import convert_variables

    _, variables, step = restore_jax_variables(ckpt_dir)
    path = os.path.join(ckpt_dir, "config.json")
    if checkpoint_kind(ckpt_dir) == "vernier":
        from snvc_tpu_torch.models.vernier import VernierScale

        model = VernierScale(load_config(path, VernierConfig), device="cpu")
    else:
        from snvc_tpu_torch.models.stereonet import StereoNet

        model = StereoNet(load_config(path, StereoConfig), device="cpu")
    model.load_state_dict(convert_variables(variables), strict=True)
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, f"{step}.pt")
    torch.save(dict(step=step, model=model.state_dict()), out)
    shutil.copy(path, os.path.join(out_dir, "config.json"))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir", help="Orbax checkpoint dir with config.json")
    p.add_argument("out_dir", nargs="?", default=None,
                   help="default: build/converted/<basename of ckpt_dir>")
    args = p.parse_args(argv)
    out_dir = args.out_dir or os.path.join(
        ROOT, "build", "converted",
        os.path.basename(os.path.normpath(args.ckpt_dir)))
    print(convert(args.ckpt_dir, out_dir))


if __name__ == "__main__":
    main()
