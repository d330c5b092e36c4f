"""The port imports nothing of JAX or of the JAX package.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``flax``, ``optax``, ``orbax`` and ``snvc_tpu``, then imports every module
of ``snvc_tpu_torch``, ``chip_smoke`` and the scripts that time its
kernels (without running them).  Two more
cases run ``chip_smoke.py`` where it must fail: with CUDA hidden, and
alone in a directory that holds nothing else of the repo.
"""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import snvc_tpu_torch

ROOT = Path(__file__).resolve().parents[1]

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "snvc_tpu")


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
import snvc_tpu_torch

mods = ["snvc_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                          "snvc_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke  # noqa: F401  (imported, not run)
sys.path.insert(0, "scripts")
import k1_variants, k34_variants, kernel_ab  # noqa: E401,F401  (not run)
import k4_bwd_losses, k4_bwd_variants  # noqa: E401,F401  (not run)
import stereo_reference_drift  # noqa: F401  (not run)
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("imported", len(mods))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_imports_no_jax():
    res = subprocess.run([sys.executable, "-c", _GUARD], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n = len(list(pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                       "snvc_tpu_torch.")))
    assert f"imported {n + 1}" in res.stdout, res.stdout


def test_walk_covers_stereo_training():
    """The walk above imports the stereo training modules."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.models.stereo_losses",
            "snvc_tpu_torch.training.train_stereo"} <= names


def _no_ok_line(stdout: str) -> bool:
    return '"ok": true' not in stdout


def test_chip_smoke_fails_without_cuda():
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0
    assert _no_ok_line(res.stdout)
