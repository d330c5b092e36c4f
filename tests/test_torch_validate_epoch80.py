"""The port's release-checkpoint harness (snvc_tpu_torch/tools/
validate_epoch80.py) against JAX's (tools/validate_epoch80.py) on the CPU.

The port's ``--selftest`` (tiny config, float32, 2 frames x 2 cars)
fabricates a release-shaped tar, a synthetic val tree and noisy-GT
proposals, converts, refines and scores; JAX's ``convert`` / ``run`` /
``evaluate`` then take the same tar, tree and proposals.  The refined
files match line for line (boxes within 1e-2, the files' printed
precision; scores within 1e-3), the AP dicts have the same keys, and the
values are equal where the two packages printed the same boxes.
``release_config`` equals JAX's, and ``main`` refuses a run without its
inputs.
"""

import argparse
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from snvc_tpu.config import tiny_vernier_config as j_tiny
from snvc_tpu_torch.tools import validate_epoch80

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One thread: the tier-1 command runs this file beside five other
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _read(d):
    return {f: open(os.path.join(d, f)).read().splitlines()
            for f in sorted(os.listdir(d))}


def test_release_config_matches_jax():
    jv = _jax_tool("validate_epoch80")
    for argv in ([], ["--no-gn", "--backbone", "hrnet-w32", "--dtype",
                      "float32"]):
        args = validate_epoch80.parse_args(argv)
        got = validate_epoch80.release_config(args)
        want = jv.release_config(args)
        for f in ("vernier_type", "grid_resolution", "x_range", "y_range",
                  "z_range", "resolution", "gn", "usage", "sup_type",
                  "max_instances", "image_size", "pred_type",
                  "compute_dtype"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.backbone.name == want.backbone.name == args.backbone
    with pytest.raises(SystemExit):
        validate_epoch80.main(["--device", "cpu"])


def test_selftest_matches_jax(tmp_path):
    work = str(tmp_path / "port")
    got = validate_epoch80.main(["--selftest", "--work_dir", work,
                                 "--device", "cpu"])
    assert got["selftest"] == "ok"
    refined = os.path.join(work, "refined")
    with open(os.path.join(refined, "validation.json")) as f:
        written = json.load(f)
    assert written == {k: v for k, v in got.items() if k != "selftest"}
    assert set(written) == {"proposals", "one_part", "all_parts"}

    # JAX's steps 1-4 on the same tar, tree and proposals
    jv = _jax_tool("validate_epoch80")
    from snvc_tpu.utils.convert_torch import load_torch_checkpoint

    args = argparse.Namespace()
    cfg = j_tiny(usage="inference", sup_type="real", max_instances=4,
                 image_size=(384, 1248), pred_type=("one_part", "all_parts"))
    sd = load_torch_checkpoint(os.path.join(work, "fake_epoch_80.tar"))
    model, variables, cfg = jv.convert(args, cfg, sd, print)
    jout = str(tmp_path / "jax_refined")
    pred_dir = os.path.join(work, "proposals")
    ds = jv.run(args, cfg, model, variables, os.path.join(work, "kitti_val"),
                "val", pred_dir, jout, print)
    want = jv.evaluate(args, ds, pred_dir, jout, print)

    assert set(written) == set(want)
    for k in want:
        assert set(written[k]) == set(want[k]), k
    for t in ("one_part", "all_parts"):
        same = True
        a = _read(os.path.join(refined, t, "data"))
        b = _read(os.path.join(jout, t, "data"))
        assert list(a) == list(b), t
        for f in a:
            assert len(a[f]) == len(b[f]) > 0, (t, f)
            for la, lb in zip(a[f], b[f]):
                pa, pb = la.split(), lb.split()
                assert pa[0] == pb[0] and len(pa) == len(pb) == 16
                va = np.array(pa[1:], np.float64)
                vb = np.array(pb[1:], np.float64)
                np.testing.assert_allclose(va[:-1], vb[:-1], rtol=0,
                                           atol=1e-2 + 1e-9)
                assert abs(va[-1] - vb[-1]) <= 1e-3 + 1e-9
                same &= pa[:-1] == pb[:-1]
        if same:
            assert written[t] == want[t], t
    assert written["proposals"] == want["proposals"]
