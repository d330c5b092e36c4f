"""The port imports nothing of JAX or of the JAX package, and nothing the
card's machine lacks.

A subprocess installs a ``sys.meta_path`` finder that refuses ``jax``,
``flax``, ``optax``, ``orbax``, ``snvc_tpu``, ``cv2``, ``PIL`` and
``torchvision``, then imports every module of ``snvc_tpu_torch`` (the
CLIs included: importing one must not run it), ``chip_smoke`` and every
script under ``scripts/`` but the two that convert and compare JAX
checkpoints on a host with JAX (``SCRIPTS_WITH_JAX``).  Two more cases run
``chip_smoke.py`` where it must fail: with CUDA hidden, and alone in a
directory that holds nothing else of the repo.
"""

import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import snvc_tpu_torch

ROOT = Path(__file__).resolve().parents[1]
# scripts that run on a CPU host with JAX, beside the port, not in it
SCRIPTS_WITH_JAX = ("convert_jax_checkpoint", "two_stage_parity")

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "orbax", "snvc_tpu", "cv2",
           "PIL", "torchvision")
SCRIPTS = sys.argv[1:]


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
for name in SCRIPTS:
    importlib.import_module(name)  # imported, not run
bad = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
assert not bad, bad
print("imported", len(mods), "and scripts", len(SCRIPTS))
"""


def _port_scripts():
    return sorted(p.stem for p in (ROOT / "scripts").glob("*.py")
                  if p.stem not in SCRIPTS_WITH_JAX)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.update(extra)
    return env


def test_port_imports_no_jax():
    scripts = _port_scripts()
    res = subprocess.run([sys.executable, "-c", _GUARD, *scripts], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    n = len(list(pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                       "snvc_tpu_torch.")))
    assert f"imported {n + 1} and scripts {len(scripts)}" in res.stdout, \
        res.stdout
    assert "usage:" not in res.stdout + res.stderr  # no CLI ran


def test_scripts_with_jax_exist():
    """The scripts the guard leaves out are there, and every other script
    is in its list."""
    names = {p.stem for p in (ROOT / "scripts").glob("*.py")}
    assert set(SCRIPTS_WITH_JAX) <= names
    assert {"kernel_ab", "k1_variants"} <= set(_port_scripts())


def test_walk_covers_the_serving_slice():
    """The walk above imports the KITTI host layer, the pipelines, the
    evaluator wrapper and the three CLIs."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.data.png", "snvc_tpu_torch.data.kitti",
            "snvc_tpu_torch.data.instance_db",
            "snvc_tpu_torch.data.stereo_pipeline",
            "snvc_tpu_torch.inference.kitti_writer",
            "snvc_tpu_torch.eval.kitti_ap", "snvc_tpu_torch.utils.logging",
            "snvc_tpu_torch.tools.detect",
            "snvc_tpu_torch.tools.inference_agnostic",
            "snvc_tpu_torch.tools.evaluate"} <= names


def test_walk_covers_stereo_training():
    """The walk above imports the stereo training modules."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.models.stereo_losses",
            "snvc_tpu_torch.training.train_stereo"} <= names


def test_walk_covers_the_training_clis():
    """The walk above imports the training CLIs and what they added."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.tools.train_vernier",
            "snvc_tpu_torch.tools.train_stereo",
            "snvc_tpu_torch.tools._train_loop",
            "snvc_tpu_torch.ops.augment",
            "snvc_tpu_torch.utils.seeding"} <= names


def test_walk_covers_the_variants():
    """The walk above imports the modules the Vernier variants run
    through: the heads, the HRNet heads, the 3D targets, the gated
    sampler."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.models.vernier", "snvc_tpu_torch.models.hrnet",
            "snvc_tpu_torch.ops.heatmaps", "snvc_tpu_torch.ops.assemble",
            "snvc_tpu_torch.ops.grid_sample",
            "snvc_tpu_torch.inference.refine"} <= names


def test_walk_covers_the_world_tracker_and_demos():
    """The walk above imports the renderer and its rasterizer, the
    tracker and the four CLIs of the slice, and ``scripts/demo_runs``."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.geometry.raster",
            "snvc_tpu_torch.data.synthetic",
            "snvc_tpu_torch.inference.track",
            "snvc_tpu_torch.tools.track", "snvc_tpu_torch.tools._demo",
            "snvc_tpu_torch.tools.demo_ap_lift",
            "snvc_tpu_torch.tools.demo_tracking",
            "snvc_tpu_torch.tools.demo_two_stage"} <= names
    assert "demo_runs" in _port_scripts()


def test_walk_covers_the_release_checkpoint_slice():
    """The walk above imports the checkpoint converter, the two CLIs of
    the slice and the helpers they brought; importing a CLI runs
    nothing."""
    names = {m.name for m in pkgutil.walk_packages(snvc_tpu_torch.__path__,
                                                   "snvc_tpu_torch.")}
    assert {"snvc_tpu_torch.utils.convert_torch",
            "snvc_tpu_torch.tools.validate_epoch80",
            "snvc_tpu_torch.tools.diagnose_proposals",
            "snvc_tpu_torch.eval.coverage",
            "snvc_tpu_torch.geometry.boxes2d",
            "snvc_tpu_torch.geometry.transforms"} <= names
    res = subprocess.run(
        [sys.executable, "-c",
         "import snvc_tpu_torch.tools.validate_epoch80, "
         "snvc_tpu_torch.tools.diagnose_proposals; print('imported')"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "imported"


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
