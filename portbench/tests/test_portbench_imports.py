"""Nothing the benchmark's runner loads imports JAX or the JAX package
(top-level names compared whole: ``snvc_tpu_torch`` passes), and the
reference imports nothing of the program."""

import importlib
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

_GUARD = r"""
import importlib, importlib.abc, pkgutil, sys
BLOCKED = tuple(sys.argv[1].split(","))


class Blocker(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Blocker())
for m in sys.argv[2:]:
    importlib.import_module(m)
bad = sorted({m.split(".")[0] for m in sys.modules} & set(BLOCKED))
assert not bad, bad
print("ok", len(sys.argv) - 2)
"""

RUNNER = ["portbench.run", "portbench.calibrate", "portbench.lib.cells",
          "portbench.lib.readers", "portbench.lib.trace",
          "portbench.drivers.refine", "portbench.drivers.detect",
          # what the drivers load of the program
          "snvc_tpu_torch.inference.refine", "snvc_tpu_torch.inference.detect",
          "snvc_tpu_torch.models.vernier", "snvc_tpu_torch.models.stereonet",
          "snvc_tpu_torch.config"]
REFERENCE = ["portbench.reference.layers", "portbench.reference.vernier",
             "portbench.reference.stereo", "portbench.work.flops",
             "portbench.work.kernels"]


def _guard(blocked, modules):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.run([sys.executable, "-c", _GUARD, ",".join(blocked),
                           *modules], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)


def test_runner_imports_no_jax():
    res = _guard(("jax", "jaxlib", "flax", "optax", "orbax", "snvc_tpu"),
                 RUNNER)
    assert res.returncode == 0, res.stderr
    assert f"ok {len(RUNNER)}" in res.stdout


def test_reference_imports_nothing_of_the_program():
    res = _guard(("jax", "jaxlib", "flax", "optax", "orbax", "snvc_tpu",
                  "snvc_tpu_torch"), REFERENCE)
    assert res.returncode == 0, res.stderr


def test_metric_readers_import_no_program():
    mods = [f"portbench/metrics/{p.name}" for p in
            (REPO / "portbench" / "metrics").glob("*.py")]
    code = ("import runpy, sys\n" + "\n".join(
        f"runpy.run_path({m!r})" for m in mods) + "\nprint('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", _GUARD.replace(
        "for m in sys.argv[2:]:\n    importlib.import_module(m)", code),
        "jax,jaxlib,flax,optax,orbax,snvc_tpu,snvc_tpu_torch"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_runner_refuses_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "refine_w48.offline8", "--seed", "1", "--seconds",
                          "1", "--trace", "0"], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("name", ["jax", "snvc_tpu"])
def test_a_forbidden_import_in_the_check_refuses_the_run(tmp_path,
                                                         monkeypatch, name):
    """The correctness check runs after the window; a module it loads
    lazily still stops the run before a result comes out."""
    from portbench.lib.cells import Cell
    from portbench.tests.tiny import make_root, run

    fake = tmp_path / "fake" / name
    fake.mkdir(parents=True)
    (fake / "__init__.py").write_text("")
    root = make_root(tmp_path)
    drv = Cell("tiny_v.offline8", root).driver().Driver
    orig = drv.check

    def check(self):
        # registered so that teardown takes the module out again
        monkeypatch.setitem(sys.modules, name, None)
        del sys.modules[name]
        monkeypatch.syspath_prepend(str(fake.parent))
        importlib.import_module(name)
        return orig(self)

    assert name not in sys.modules
    monkeypatch.setattr(drv, "check", check)
    with pytest.raises(SystemExit) as exc:
        run(root, "tiny_v.offline8")
    assert exc.value.code not in (0, None)
