"""Timed alternatives of the K3 and K4 kernels (the plane-sweep cost volume
and the frustum -> voxel resample), on one NVIDIA GPU, at the detect path's
shapes.

    python3 scripts/k34_variants.py

Builds ``scripts/k34_variants.cu`` (alternatives that include the shipped
``csrc/plane_sweep_volume.cu`` and ``csrc/frustum_to_voxel.cu``) beside the
package's own libraries, holds every variant to the shipped kernel bit for
bit (and the shipped kernel to the plain version within 2 bf16 ulp), and
prints one line per variant with its CUDA-event mean (ms), then one JSON
line with all of them.  Inputs: seeded random bf16 features / volume at
``StereoConfig()``'s shapes, the request's own shift table and the default
KITTI calibration.

  K3 ([1, 96, 312, 32] features x2, 64 planes -> 245.4 MB):
    shipped            the package's kernel at k3_tiling's choice
    planes{P}_by{BY}   the package's kernel at other tilings
    flat               the previous kernel: flat grid, 64-bit index division
    direct             the shipped block layout without the staged rows (taps
                       and left groups read through L1/L2), streaming stores
    direct_plain       the same with plain stores
    tma                staged rows, each plane's slab built in a double-
                       buffered shared slab and written by a TMA bulk store
    write_only         the shipped layout's store stream alone (zeros)
    fill / fill_plain  245.4 MB of zeros, grid-stride 16-byte stores, with
                       and without the streaming hint
  K4 ([1, 64, 96, 312, 32] volume -> [1, 288, 300, 20, 32], 110.6 MB):
    shipped            the package's kernel at k4_tiling's choice
    tile{T}_lanes{L}_ncol{K}  the package's kernel at other tilings; ncol 0
                       gathers every output's taps directly (the no-division
                       layout with u and v projected once, no shared taps)
    flat               the previous kernel: flat grid, 64-bit index division,
                       u and v per thread
    loads_first        the shipped kernel with all of a column's tap loads
                       (on the direct path: both columns') issued before
                       any sum, two columns a stage-1 step; _direct: ncol 0
    shipped / direct {part}  the shipped tiling and ncol 0 on the near,
                       middle and far thirds of the z rows, and with every
                       tap outside the image (no_taps: set-up and stores)
    fill / fill_plain  110.6 MB of zeros, as for K3
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import assert_within_ulps, cuda_ms, k4_tables, nvidia_smi  # noqa: E402
from snvc_tpu_torch import _build  # noqa: E402
from snvc_tpu_torch.config import StereoConfig  # noqa: E402
from snvc_tpu_torch.geometry.calib import Calibration  # noqa: E402
from snvc_tpu_torch.models.stereonet import (  # noqa: E402
    _bev_axes,
    depth_hypotheses,
    plane_shifts,
)
from snvc_tpu_torch.ops.cost_volume import (  # noqa: E402
    k3_tiling,
    plane_sweep_shifted,
    plane_sweep_volume_k3,
)
from snvc_tpu_torch.ops.frustum import (  # noqa: E402
    _project_uv,
    frustum_to_voxel_k4,
    frustum_to_voxel_separable,
    k4_table_bytes,
    k4_tiling,
)

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong

K3_VARIANTS = ("flat", "direct", "direct_plain", "write_only", "tma")


def load_variants() -> ctypes.CDLL:
    src = ROOT / "scripts" / "k34_variants.cu"
    out = _build.BUILD_DIR / "libk34_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                          "-o", str(out), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    print(res.stdout + res.stderr, file=sys.stderr)
    lib = ctypes.CDLL(str(out))
    lib.k34v_k3.argtypes = [_I] + [_P] * 4 + [_I] * 7 + [_P]
    lib.k34v_k4_flat.argtypes = [_P] * 8 + [_I] * 8 + [_F, _P]
    lib.k34v_k4_loads_first.argtypes = [_P] * 8 + [_I] * 8 + [_F] + [_I] * 3 + [_P]
    lib.k34v_fill.argtypes = [_P, _L, _I, _I, _P]
    for fn in (lib.k34v_k3, lib.k34v_k4_flat, lib.k34v_k4_loads_first,
               lib.k34v_fill):
        fn.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("k34_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    lib = load_variants()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    res = {"card": nvidia_smi()}

    def record(key, ms):
        res[key] = ms
        print(f"{key:40s} {ms:9.4f} ms", flush=True)

    def ok(err):
        assert err == 0, err

    def fill(label, nbytes):
        buf = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        for hint, name in ((1, "fill"), (0, "fill_plain")):
            record(f"{label} {name}", cuda_ms(lambda: ok(lib.k34v_fill(
                buf.data_ptr(), nbytes, hint, sms * 8, stream())), 20))
        del buf

    cfg = StereoConfig()
    D, C = cfg.num_depths, 32
    H, W = cfg.input_size[0] // 4, cfg.input_size[1] // 4
    Pl = torch.from_numpy(Calibration.default().as_array()[None]).to(dev)
    Pr = torch.from_numpy(Calibration.default_right().as_array()[None]).to(dev)
    with torch.inference_mode():
        # ---------------------------------------------------------- K3 ----
        lf = torch.randn((1, H, W, C), generator=gen).to(dev, torch.bfloat16)
        rf = torch.randn((1, H, W, C), generator=gen).to(dev, torch.bfloat16)
        shifts = plane_shifts(Pl, Pr, torch.from_numpy(
            depth_hypotheses(cfg)).to(dev))
        want = plane_sweep_volume_k3(lf, rf, shifts)
        assert_within_ulps("K3 shipped", want,
                           plane_sweep_shifted(lf, rf, shifts))
        t = k3_tiling(1, D, H, W, C, torch.bfloat16, sms)
        res["K3 tiling"] = t._asdict()
        print(f"K3 tiling {t}")
        record("K3 shipped", cuda_ms(
            lambda: plane_sweep_volume_k3(lf, rf, shifts), 20))
        k3 = _build.load_library("plane_sweep_volume")
        out = torch.empty_like(want)
        for planes in (1, 2, 4, 8, 11, 16, 64):
            for by in (32, 64, 128):

                def run():
                    ok(k3.snvc_plane_sweep_volume(
                        lf.data_ptr(), rf.data_ptr(), shifts.data_ptr(),
                        out.data_ptr(), 1, D, H, W, C, D, by, planes, 0,
                        stream()))

                out.zero_()
                run()
                assert torch.equal(out, want), f"K3 planes{planes}_by{by}"
                record(f"K3 planes{planes}_by{by}", cuda_ms(run, 20))
        for v, name in enumerate(K3_VARIANTS):
            for planes in ((8,) if name == "flat" else (4, 8, 16)):

                def run():
                    ok(lib.k34v_k3(v, lf.data_ptr(), rf.data_ptr(),
                                   shifts.data_ptr(), out.data_ptr(), 1, D, H,
                                   W, C, 64, planes, stream()))

                out.zero_()
                run()
                if name != "write_only":
                    assert torch.equal(out, want), f"K3 {name}"
                label = name if name == "flat" else f"{name}_planes{planes}"
                record(f"K3 {label}", cuda_ms(run, 20))
        fill("K3", want.numel() * want.element_size())
        del lf, rf, want, out

        # ---------------------------------------------------------- K4 ----
        tabs = k4_tables(depth_hypotheses(cfg), *_bev_axes(cfg), dev)
        vol = torch.randn((1, D, H, W, C), generator=gen).to(dev,
                                                             torch.bfloat16)
        nz, nx, ny = (a.shape[0] for a in tabs[2:])
        want = frustum_to_voxel_k4(vol, Pl, *tabs, 4)
        assert_within_ulps("K4 shipped", want,
                           frustum_to_voxel_separable(vol, Pl, *tabs, 4))
        t = k4_tiling(1, nz, nx, ny, C, torch.bfloat16, sms)
        res["K4 tiling"] = t._asdict()
        print(f"K4 tiling {t}")
        record("K4 shipped", cuda_ms(
            lambda: frustum_to_voxel_k4(vol, Pl, *tabs, 4), 20))
        k4 = _build.load_library("frustum_to_voxel")
        out = torch.empty_like(want)
        ptrs = [a.data_ptr() for a in (vol, Pl, *tabs)]
        for tile in (8, 16, 32):
            for lanes in (2, 3, 4, 6):
                for ncol in sorted({0, tile + 2, 2 * tile + 2}):
                    if k4_table_bytes(tile, ny) + ncol * ny * C * 4 > 232448:
                        continue

                    def run():
                        ok(k4.snvc_frustum_to_voxel(
                            *ptrs, out.data_ptr(), 1, D, H, W, C, nz, nx, ny,
                            4.0, tile, lanes, ncol, 0, stream()))

                    out.zero_()
                    run()
                    key = f"K4 tile{tile}_lanes{lanes}_ncol{ncol}"
                    assert torch.equal(out, want), key
                    record(key, cuda_ms(run, 20))

        # where the time goes, at the shipped tiling and with direct gathers
        # only: the z rows in thirds (near, middle, far), and every tap
        # outside the image (P's column offset moved out: block set-up and
        # stores alone)
        p_out = Pl.clone()
        p_out[:, 0, 3] += 1e9
        thirds = [nz * k // 3 for k in range(4)]
        for ncol, label in ((t.ncol, "shipped"), (0, "direct")):
            for P, z0, z1, part in ([(p_out, 0, nz, "no_taps")] + [
                    (Pl, thirds[k], thirds[k + 1],
                     f"z{thirds[k]}-{thirds[k + 1]}") for k in range(3)]):
                rows = [a[z0:z1].contiguous() for a in tabs[:3]]
                part_ptrs = [vol.data_ptr(), P.data_ptr()] + [
                    a.data_ptr() for a in rows + tabs[3:]]

                def run():
                    ok(k4.snvc_frustum_to_voxel(
                        *part_ptrs, out.data_ptr(), 1, D, H, W, C, z1 - z0,
                        nx, ny, 4.0, t.tile_x, t.block[2], ncol, 0, stream()))

                record(f"K4 {label} {part}", cuda_ms(run, 20))

        for ncol, label in ((t.ncol, "loads_first"),
                            (0, "loads_first_direct")):

            def run():
                ok(lib.k34v_k4_loads_first(
                    *ptrs, out.data_ptr(), 1, D, H, W, C, nz, nx, ny, 4.0,
                    t.tile_x, t.block[2], ncol, stream()))

            out.zero_()
            run()
            assert torch.equal(out, want), f"K4 {label}"
            record(f"K4 {label}", cuda_ms(run, 20))

        def flat():
            ok(lib.k34v_k4_flat(*ptrs, out.data_ptr(), 1, D, H, W, C, nz, nx,
                                ny, 4.0, stream()))

        out.zero_()
        flat()
        assert torch.equal(out, want), "K4 flat"
        record("K4 flat", cuda_ms(flat, 20))
        fill("K4", want.numel() * want.element_size())
        res["K4 staged_blocks"] = staged_share(Pl, tabs, W, t.tile_x, t.ncol)
        print(f"K4 staged blocks {res['K4 staged_blocks']:.3f}")
    print(json.dumps({"k34_variants": res}))
    return 0


def staged_share(P, tabs, Wf, tile_x, ncol) -> float:
    """Share of the (z, x-tile) blocks whose column window fits ``ncol``
    columns, at the request's projection (u as the kernel computes it)."""
    u, _ = _project_uv(P, tabs[2], tabs[3], tabs[4], 4)
    u0 = np.clip(np.floor(u[0].cpu().numpy()), -2, Wf + 1).astype(np.int64)
    nz, nx = u0.shape
    staged = total = 0
    for z in range(nz):
        for xb in range(0, nx, tile_x):
            uu = u0[z, xb:xb + tile_x]
            ncols = min(uu.max() + 1, Wf - 1) - max(uu.min(), 0) + 1
            staged += ncols <= ncol
            total += 1
    return staged / total


if __name__ == "__main__":
    sys.exit(main())
