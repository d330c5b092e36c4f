"""Where the float32 stereo training step on the card drifts from the CPU's,
on one NVIDIA GPU.

    python3 scripts/stereo_reference_drift.py

Runs steps 0 and 1 of chip_smoke.py's phase stereo_train_reference (the
tiny StereoNet without SPP branches, TF32 off, matmul precision
"highest") on the CPU, then on the card four ways, and prints for each
the gradients' global relative L2 distance from the CPU's and the three
worst tensors (their largest error over their largest value):

  cudnn         the port as it runs: K3, K4 and their backward kernels
  cudnn_plain   K3, K4 and their backwards replaced by their plain
                versions on the card (everything else unchanged)
  no_cudnn      the kernels, cuDNN off (PyTorch's own convolutions)
  branches_*    the same tiny model with its SPP branches, with and
                without cuDNN

Then the backward kernels alone in float32 against their plain versions
on the card (largest error over the largest value, and the counts of
nonzero outputs) at the tiny model's shapes and at StereoConfig()'s.
"""

from __future__ import annotations

import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402
import snvc_tpu_torch.ops.cost_volume as cv  # noqa: E402
import snvc_tpu_torch.ops.frustum as fr  # noqa: E402
from snvc_tpu_torch.config import StereoConfig, tiny_stereo_config  # noqa: E402
from snvc_tpu_torch.data.stereo import synthetic_stereo_request  # noqa: E402
from snvc_tpu_torch.geometry.calib import Calibration  # noqa: E402
from snvc_tpu_torch.models.stereonet import (  # noqa: E402
    _bev_axes,
    depth_hypotheses,
)


def drift(ref: dict, got: dict) -> str:
    worst = sorted(((float((got["grads"][n] - g).abs().max())
                     / max(float(g.abs().max()), 1e-12), n)
                    for n, g in ref["grads"].items()), reverse=True)[:3]
    return f"{cs.rel_l2(got['grads'], ref['grads']):.3e} " + ", ".join(
        f"{n} {e:.2e}" for e, n in worst)


def plain_kernels():
    """Swaps K3, K4 and their backwards for their plain versions; returns
    a function that swaps them back."""
    saved = (cv._psv_forward, cv.plane_sweep_volume_k3_bwd,
             fr._f2v_forward, fr.frustum_to_voxel_k4_bwd)
    cv._psv_forward = cv.plane_sweep_shifted
    cv.plane_sweep_volume_k3_bwd = cv.plane_sweep_shifted_bwd
    fr._f2v_forward = fr.frustum_to_voxel_separable
    fr.frustum_to_voxel_k4_bwd = fr.frustum_to_voxel_separable_bwd

    def restore():
        (cv._psv_forward, cv.plane_sweep_volume_k3_bwd, fr._f2v_forward,
         fr.frustum_to_voxel_k4_bwd) = saved
    return restore


def step_on_card(cfg, dev, cudnn: bool = True) -> dict:
    torch.backends.cudnn.enabled = cudnn
    try:
        return cs.stereo_two_steps(cfg, dev)
    finally:
        torch.backends.cudnn.enabled = True


def kernel_vs_plain(label, cfg, Pl, Pr, dev, C=32) -> None:
    """K3's and K4's backward kernels against their plain versions in
    float32 on ``cfg``'s shapes and the projections Pl / Pr [1, 3, 4]."""
    D = cfg.num_depths
    H, W = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    gen = torch.Generator().manual_seed(0)
    shifts = cs.plane_shifts(Pl, Pr, torch.from_numpy(
        depth_hypotheses(cfg)).to(dev))
    g = torch.randn((1, D, H, W, 2 * C), generator=gen).to(dev)
    for name, a, b in zip(("dleft", "dright"),
                          cv.plane_sweep_volume_k3_bwd(g, shifts, W),
                          cv.plane_sweep_shifted_bwd(g, shifts, W)):
        print(f"{label} K3_bwd {name} f32: "
              f"{float((a - b).abs().max() / b.abs().max()):.2e} of the "
              f"largest")
    tabs = cs.k4_tables(depth_hypotheses(cfg), *_bev_axes(cfg), dev)
    nz, nx, ny = (len(t) for t in tabs[2:])
    g = torch.randn((1, nz, nx, ny, C), generator=gen).to(dev)
    a = fr.frustum_to_voxel_k4_bwd(g, Pl, *tabs, (D, H, W), 4)
    b = fr.frustum_to_voxel_separable_bwd(g, Pl, *tabs, (D, H, W), 4)
    print(f"{label} K4_bwd f32: "
          f"{float((a - b).abs().max() / b.abs().max()):.2e} of the "
          f"largest, nonzero {int((a != 0).sum())} / {int((b != 0).sum())}")


def main() -> int:
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(cs.nvidia_smi())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    small = tiny_stereo_config(z_max=38.0, max_depth=40.0, branch=False)
    ref = cs.stereo_two_steps(small, "cpu")
    print("cudnn       ", drift(ref, step_on_card(small, dev)))
    restore = plain_kernels()
    try:
        print("cudnn_plain ", drift(ref, step_on_card(small, dev)))
    finally:
        restore()
    print("no_cudnn    ", drift(ref, step_on_card(small, dev, cudnn=False)))
    branches = small.replace(branch=True)
    ref = cs.stereo_two_steps(branches, "cpu")
    print("branches_cudnn    ", drift(ref, step_on_card(branches, dev)))
    print("branches_no_cudnn ", drift(ref, step_on_card(branches, dev,
                                                         cudnn=False)))
    req = synthetic_stereo_request(small, seed=7, boxes_per_frame=2)
    kernel_vs_plain("tiny", small,
                    *(torch.from_numpy(req[k]).to(dev)
                      for k in ("P_left", "P_right")), dev)
    kernel_vs_plain("StereoConfig()", StereoConfig(),
                    *(torch.from_numpy(c.as_array()[None]).to(dev)
                      for c in (Calibration.default(),
                                Calibration.default_right())), dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
