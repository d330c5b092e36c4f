"""Timed launch choices of K4's backward (the frustum -> voxel resample's
gradient with respect to the volume), on one NVIDIA GPU, at the stereo
training step's shape.

    python3 scripts/k4_bwd_variants.py

Builds the package's ``csrc/frustum_to_voxel.cu`` and, on a seeded bf16
gradient [1, 288, 300, 20, 32] at ``StereoConfig()``'s planes and the
default KITTI calibration (the [1, 64, 96, 312, 32] volume's gradient),
prints one line per variant with its CUDA-event mean (ms), then one JSON
line with all of them:

  shipped           the wrapper: the plan kernel and the main kernel at
                    k4_bwd_tiling's choice (with the wrapper's host work)
  plan              the plan kernel alone into a new scratch
                    (projections, plane ranges, feature rows with work;
                    the caching allocator's and the ctypes call's host
                    time included)
  xcap{X}           the main kernel alone with the v-hat sums of X x
                    cells staged at once
  rows {part}       the shipped main kernel with the plan's work list cut to
                    the near, middle or far third of the planes, or to none
                    (zeros: its store stream alone)
  zero_             torch's zero_ of the 122.7 MB output (a memset), the
                    store stream's yardstick

Every variant of the main kernel sums each output's terms in the same
order, so each is held to the shipped output bit for bit, and the shipped
output to the plain version within 2 bf16 ulp of the largest value.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import (  # noqa: E402
    assert_within_ulps,
    cuda_ms,
    k4_tables,
    nvidia_smi,
)
from snvc_tpu_torch import _build  # noqa: E402
from snvc_tpu_torch.config import StereoConfig  # noqa: E402
from snvc_tpu_torch.geometry.calib import Calibration  # noqa: E402
from snvc_tpu_torch.models.stereonet import (  # noqa: E402
    _bev_axes,
    depth_hypotheses,
)
from snvc_tpu_torch.ops.frustum import (  # noqa: E402
    _k4_bwd_plan_scratch,
    _k4_bwd_scratch_views,
    frustum_to_voxel_k4_bwd,
    frustum_to_voxel_separable_bwd,
    k4_bwd_tiling,
)


# staged x cells timed beside the shipped choice (120)
XCAPS = (32, 64, 120, 240)


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    print(nvidia_smi(), flush=True)
    _build.build(("frustum_to_voxel",))
    lib = _build.load_library("frustum_to_voxel")
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    cfg = StereoConfig()
    D, C = cfg.num_depths, 32
    Hf, Wf = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    hw = (D, Hf, Wf)
    tabs = k4_tables(depth_hypotheses(cfg), *_bev_axes(cfg), dev)
    nz, nx, ny = (len(a) for a in tabs[2:])
    P = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    g = torch.randn((1, nz, nx, ny, C), generator=gen).to(dev, torch.bfloat16)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}

    def record(label, ms):
        res[label] = ms
        print(f"{label:24s} {ms:.4f} ms", flush=True)

    want = frustum_to_voxel_k4_bwd(g, P, *tabs, hw, 4)
    assert_within_ulps("shipped", want,
                       frustum_to_voxel_separable_bwd(g, P, *tabs, hw, 4))
    record("shipped", cuda_ms(
        lambda: frustum_to_voxel_k4_bwd(g, P, *tabs, hw, 4), 20))
    record("plan", cuda_ms(lambda: _k4_bwd_plan_scratch(
        lib, P, *tabs, hw, 4, stream), 20))
    scratch = _k4_bwd_plan_scratch(lib, P, *tabs, hw, 4, stream)
    work = _k4_bwd_scratch_views(scratch, 1, D, Hf, nz, nx, ny)[3]
    planned = work.clone()
    out = torch.empty_like(want)

    def main_kernel(xcap):
        err = lib.snvc_frustum_to_voxel_bwd(
            g.data_ptr(), tabs[0].data_ptr(), tabs[1].data_ptr(),
            scratch.data_ptr(), out.data_ptr(), 1, D, Hf, Wf, C, nz, nx, ny,
            xcap, 0, stream)
        assert err == 0, err

    shipped = k4_bwd_tiling(1, D, Hf, Wf, C, nz, ny)
    for xcap in XCAPS:
        label = f"xcap{xcap}"
        out.fill_(float("nan"))
        main_kernel(xcap)
        assert torch.equal(out, want), label
        record(label, cuda_ms(lambda: main_kernel(xcap), 20))
    thirds = {"near": slice(0, D // 3), "middle": slice(D // 3, 2 * D // 3),
              "far": slice(2 * D // 3, D), "none": slice(0, 0)}
    for part, planes in thirds.items():
        work.zero_()
        work[:, planes] = planned[:, planes]
        record(f"rows {part}", cuda_ms(lambda: main_kernel(shipped.xcap),
                                       20))
    work.copy_(planned)
    record("zero_", cuda_ms(out.zero_, 20))
    res["work_rows"] = int(planned.sum())
    print(json.dumps({"k4_bwd_variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
