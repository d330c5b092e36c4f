"""Builds the port's CUDA kernels into shared libraries and loads them.

Each ``csrc/*.cu`` source has a plain C interface and is compiled by its
own ``nvcc`` process (all started together) into
``build/snvc_tpu_torch/lib<name>_<hash>.so`` beside the package, where the
hash covers the source, the shared headers (``csrc/*.cuh``) and the flags;
``ctypes`` loads the result.  No
PyTorch headers are included, so a build takes seconds.  Nothing here runs
at import time: the first kernel call builds what is missing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "snvc_tpu_torch"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> (library, argtypes).  Every pointer and the
# stream are c_void_p, so no address is cut to 32 bits.
ENTRY_POINTS = {
    "snvc_stereo_voxel_sample": (
        "stereo_voxel_sample",
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F, _I, _P]),
    "snvc_stereo_voxel_sample_bwd": (
        "stereo_voxel_sample",
        [_P] * 9 + [_I] * 9 + [_F, _F, _I, _P]),
    "snvc_conv3d_large_tap": (
        "conv3d_large_tap",
        [_P, _P, _P] + [_I] * 12 + [_P]),
    "snvc_conv3d_weight_grad": (
        "conv3d_weight_grad",
        [_P] * 4 + [_I] * 15 + [_P]),
    "snvc_plane_sweep_volume": (
        "plane_sweep_volume",
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]),
    "snvc_frustum_to_voxel": (
        "frustum_to_voxel",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F,
         _I, _P]),
}
LIBRARIES = tuple(dict.fromkeys(lib for lib, _ in ENTRY_POINTS.values()))

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so"


def build(names=LIBRARIES) -> float:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all in parallel.  Returns the wall seconds.
    Raises RuntimeError with nvcc's output if any compile fails."""
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f".{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        cmd = [nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        fh = open(log, "w")
        procs.append((name, out, tmp, log, fh,
                      subprocess.Popen(cmd, stdout=fh, stderr=subprocess.STDOUT)))
    errors = []
    for name, out, tmp, log, fh, proc in procs:
        rc = proc.wait()
        fh.close()
        if rc != 0:
            errors.append(f"nvcc failed for {name} (rc {rc}):\n"
                          f"{log.read_text()}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc/ptxas output of the last build of ``name`` ('' if none)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed, with argtypes
    and restype of its entry points declared."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build((name,))
    lib = ctypes.CDLL(str(path))
    for fn, (owner, argtypes) in ENTRY_POINTS.items():
        if owner == name:
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    lib.snvc_error_string.argtypes = [ctypes.c_int]
    lib.snvc_error_string.restype = ctypes.c_char_p
    _loaded[name] = lib
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return f"{err}: {lib.snvc_error_string(err).decode()}"
