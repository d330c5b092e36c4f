"""Frozen copies of the work the program's kernels declare (the formulas
beside each kernel in ``snvc_tpu_torch/ops``: ``k1_work``,
``conv3d_work``, ``k3_work``, ``k4_work``), and each cell's per-request
work from them.  Operations and bytes follow from shapes alone: every
input read once, every output written once."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import numpy as np


class Work(NamedTuple):
    flops: float
    bytes_accessed: float


def k1_work(N, P, Hf, Wf, C, itemsize) -> Work:
    """Stereo voxel sampling: both [N, Hf, Wf, C] maps and both [N, P, 2]
    float32 grids read, the [N, P, 2C] voxel written; 4 taps x (multiply +
    add) per voxel element."""
    out = N * P * 2 * C
    return Work(8.0 * out, (2 * N * Hf * Wf * C + out) * itemsize
                + 2 * N * P * 2 * 4)


def conv_taps(n_in, n_out, k, stride=1, pad=0, dil=1) -> int:
    """(output, tap) pairs along one axis whose input lies inside it."""
    total = 0
    for t in range(k):
        off = t * dil - pad
        lo = max(0, -(off // stride))
        hi = min(n_out - 1, (n_in - 1 - off) // stride)
        total += max(0, hi - lo + 1)
    return total


def conv3d_work(x_shape, kernel, F_out, dilation, itemsize) -> Work:
    """A stride-1 SAME 3D conv of x [N, D, H, W, C]: 2 x the multiply-adds
    of the taps inside the volume; x, the weights and the output once."""
    N, D, H, W, C = x_shape
    taps = math.prod(conv_taps(n, n, k, 1, (k - 1) // 2 * dilation, dilation)
                     for n, k in zip((D, H, W), kernel))
    return Work(2.0 * N * F_out * C * taps,
                (N * D * H * W * (C + F_out) + math.prod(kernel) * C * F_out)
                * itemsize)


def k3_work(N, D, H, W, C, itemsize, n_shifts) -> Work:
    """Plane-sweep volume: both maps and the shifts read, the
    [N, D, H, W, 2C] volume written; 1.5 operations per element."""
    out = N * D * H * W * 2 * C
    return Work(1.5 * out, (2 * N * H * W * C + out) * itemsize
                + 4 * n_shifts)


def k4_planes(d0) -> int:
    lo = set(int(i) for i in np.asarray(d0).ravel())
    return len(lo | {i + 1 for i in lo})


def k4_work(volume_shape, d0, out_shape, itemsize) -> Work:
    """Frustum resample: the planes the depth table uses read, the
    [N, nz, nx, ny, C] voxels written; 24 operations per element."""
    N, _, Hf, Wf, C = volume_shape
    out = math.prod(out_shape)
    return Work(24.0 * out, (N * k4_planes(d0) * Hf * Wf * C + out)
                * itemsize)


def entry(symbol: str, works, tensor_cores: bool) -> Dict:
    """A kernel's per-request record for the roofline readers: the device
    symbol that names it in a trace, its launches a request, and their
    summed operations and bytes."""
    return dict(symbol=symbol, launches=len(works), tensor_cores=tensor_cores,
                flops=sum(w.flops for w in works),
                bytes=sum(w.bytes_accessed for w in works))


def refine_work(cfg: Dict, C: int, itemsize: int) -> Dict[str, Dict]:
    """K1 and K2 of one refinement request (``max_instances`` slots) for
    an encoder of ``C`` channels a view: K2 runs the head's conv1_k7
    (2C -> C), conv2_k5 and conv3_k5_d2 (C -> C)."""
    N = cfg["max_instances"]
    nh, nw, nl = cfg["grid_resolution"]
    H, W = cfg["resolution"]
    vox = (N, nh, nw, nl)
    return {
        "K1": entry("stereo_voxel_sample_kernel",
                    [k1_work(N, nh * nw * nl, H // 4, W // 4, C, itemsize)],
                    False),
        "K2": entry("conv3d_large_tap_kernel",
                    [conv3d_work(vox + (2 * C,), (7, 7, 7), C, 1, itemsize),
                     conv3d_work(vox + (C,), (5, 5, 5), C, 1, itemsize),
                     conv3d_work(vox + (C,), (5, 5, 5), C, 2, itemsize)],
                    True),
    }


def detect_work(cfg: Dict, pairs: int, itemsize: int, d0) -> Dict[str, Dict]:
    """K3 and K4 of one detection request of ``pairs`` pairs; ``d0`` is
    the depth table of the BEV rows."""
    H, W = cfg["input_size"][0] // 4, cfg["input_size"][1] // 4
    D, C = cfg["num_depths"], 32
    nz = int(round((cfg["z_max"] - cfg["z_min"]) / cfg["voxel_z"]))
    nx = int(round((cfg["x_max"] - cfg["x_min"]) / cfg["voxel_x"]))
    ny = int(round((cfg["y_max"] - cfg["y_min"]) / cfg["voxel_y"]))
    return {
        "K3": entry("plane_sweep_volume_kernel",
                    [k3_work(pairs, D, H, W, C, itemsize, pairs * D)], False),
        "K4": entry("frustum_to_voxel_kernel",
                    [k4_work((pairs, D, H, W, 32), d0,
                             (pairs, nz, nx, ny, 32), itemsize)], False),
    }
