"""Timed alternatives of the K1 kernels (the stereo voxel sampler's
forward and backward), on one NVIDIA GPU, at the paths' shapes.

    python3 scripts/k1_variants.py

Builds ``scripts/k1_variants.cu`` (alternatives that include the shipped
``csrc/stereo_voxel_sample.cu``) beside the package's own libraries, holds
every variant to the plain version, and prints one line per variant with
its CUDA-event mean (ms), then one JSON line with all of them:

  forward, the flagship shape ([4, 64, 64, 32] bf16 features, 32x192x192
  grid) at the path's projections (a seeded flagship batch through
  assemble_instances) and at uniform random ones:
    shipped        the package's kernel (no division, 2G threads a point,
                   4 points a thread, their projections loaded first)
    decode64       the first version: flat grid, 64-bit index division
    decode32       the same order within an instance, 32-bit division
    point          one thread per (point, view), coordinates once, G stores
    multi{K}       the shipped layout at K = 1, 2, 8 points a thread
    write_only     the shipped layout's store stream alone (zeros, no loads)
  backward, the training shape ([8, 64, 64, 32], 16x96x96 grid, a seeded
  VernierConfig() batch's projections), no grid gradient:
    shipped        the package's kernel at k1_bwd_tiling's choice
    slice{CS}_split{S}  the package's kernel at other tilings
    lanes{K}       the package's kernel at K channels a lane (walkers of
                   8 / K lanes)
    memory_order   the package's kernel walking the points in memory order
                   (l fastest) instead of the slower-moving axis
    one_patch      the package's kernel, every point of an instance in one
                   2x2 tap patch
    per_point      one thread per point adding its four taps to shared
                   memory at once, 32 neighbouring points a warp
    strided        the same, each thread walking its own run of points
    pixmajor       per_point on a [Hf*Wf][8] map
    global         float32 global atomics (with the zeroing and the casts)
  and F.grid_sample's forward / backward beside them.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from chip_smoke import batch_projections, cuda_ms, k1_case, nvidia_smi  # noqa: E402
from snvc_tpu_torch import _build  # noqa: E402
from snvc_tpu_torch.config import VernierConfig, flagship_vernier_config  # noqa: E402
from snvc_tpu_torch.ops.grid_sample import (  # noqa: E402
    sample_stereo_voxel,
    sample_stereo_voxel_bwd,
)
from snvc_tpu_torch.ops.stereo_sample_cuda import (  # noqa: E402
    k1_bwd_tiling,
    stereo_voxel_sample,
    stereo_voxel_sample_bwd,
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def load_variants() -> ctypes.CDLL:
    src = ROOT / "scripts" / "k1_variants.cu"
    out = _build.BUILD_DIR / "libk1_variants.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build.nvcc(), *_build.FLAGS, "-I", str(_build.CSRC),
                          "-o", str(out), str(src)], capture_output=True,
                         text=True)
    if res.returncode != 0:
        raise RuntimeError(res.stdout + res.stderr)
    print(res.stdout + res.stderr, file=sys.stderr)
    lib = ctypes.CDLL(str(out))
    lib.k1v_fwd.argtypes = [_I] + [_P] * 5 + [_I] * 5 + [_F, _F, _P]
    lib.k1v_bwd.argtypes = [_I] + [_P] * 5 + [_I] * 6 + [_F, _F, _P]
    lib.k1v_bwd_lanes.argtypes = [_I] + [_P] * 7 + [_I] * 8 + [_F, _F, _P]
    lib.k1v_fwd.restype = lib.k1v_bwd.restype = ctypes.c_int
    lib.k1v_bwd_lanes.restype = ctypes.c_int
    return lib


def close(label, got, want, rel):
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ok = bool((err <= rel * want.abs() + 1e-4 * want.abs().max()).all())
    if not ok:
        raise AssertionError(f"{label}: max err {err.max().item()}")


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    lib = load_variants()
    stream = lambda: torch.cuda.current_stream(dev).cuda_stream  # noqa: E731
    gen = torch.Generator().manual_seed(0)
    res = {"card": nvidia_smi()}

    def record(key, ms):
        res[key] = ms
        print(f"{key:40s} {ms:9.4f} ms", flush=True)

    with torch.inference_mode():
        cfg = flagship_vernier_config()
        grid, roi = cfg.grid_resolution, cfg.resolution
        N, P = cfg.max_instances, grid[0] * grid[1] * grid[2]
        lf, rf, rgl, rgr = k1_case(gen, N, 64, 64, 32, grid, roi,
                                   torch.bfloat16, dev)
        gl, gr = batch_projections(cfg, 0, dev)
        sx, sy = _F(2.0 / roi[1]), _F(2.0 / roi[0])
        for label, pl, pr in (("path", gl, gr), ("random", rgl, rgr)):
            want = sample_stereo_voxel(lf, rf, pl, pr, roi, grid)
            record(f"fwd {label} shipped", cuda_ms(
                lambda: stereo_voxel_sample(lf, rf, pl, pr, roi, grid), 20))
            for v, name in enumerate(("decode64", "decode32", "point",
                                      "multi1", "multi2", "multi8",
                                      "write_only")):
                out = torch.empty_like(want)

                def run():
                    err = lib.k1v_fwd(v, lf.data_ptr(), rf.data_ptr(),
                                      pl.data_ptr(), pr.data_ptr(),
                                      out.data_ptr(), N, P, 64, 64, 32, sx,
                                      sy, stream())
                    assert err == 0, err

                run()
                if name != "write_only":
                    close(f"fwd {label} {name}", out, want, 2.0 ** -7)
                record(f"fwd {label} {name}", cuda_ms(run, 20))
            lft, rft = lf.permute(0, 3, 1, 2), rf.permute(0, 3, 1, 2)
            scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=dev)
            ngl = (pl * scale - 1.0)[:, None].to(torch.bfloat16)
            ngr = (pr * scale - 1.0)[:, None].to(torch.bfloat16)
            record(f"fwd {label} library", cuda_ms(lambda: torch.cat(
                [F.grid_sample(lft, ngl, align_corners=False),
                 F.grid_sample(rft, ngr, align_corners=False)], 1), 5))
            del want
        del lf, rf, rgl, rgr, gl, gr

    # the backward outside inference mode: the library call builds a graph
    with torch.no_grad():
        cfg = VernierConfig()
        grid, roi = cfg.grid_resolution, cfg.resolution
        N, P = cfg.max_instances, grid[0] * grid[1] * grid[2]
        lf, rf, _, _ = k1_case(gen, N, 64, 64, 32, (1, 1, 1), roi,
                               torch.bfloat16, dev)
        gl, gr = batch_projections(cfg, 0, dev)
        g = torch.randn((N,) + grid + (64,), generator=gen).to(
            dev, torch.bfloat16)
        want = sample_stereo_voxel_bwd(lf.float(), rf.float(), gl, gr,
                                       g.float(), roi, need_grid=False)
        t = k1_bwd_tiling(N, 64, 64, 32,
                          torch.cuda.get_device_properties(dev)
                          .multi_processor_count)
        res["bwd tiling"] = t._asdict()
        print(f"bwd tiling {t}")
        record("bwd shipped", cuda_ms(lambda: stereo_voxel_sample_bwd(
            lf, rf, gl, gr, g, roi, need_grid=False), 20))
        fn = _build.load_library("stereo_voxel_sample")
        dl, dr = torch.empty_like(lf), torch.empty_like(rf)
        for cs, s in ((8, 1), (8, 2), (8, 4), (8, 8), (4, 1), (4, 2), (4, 4)):

            def run():
                err = fn.snvc_stereo_voxel_sample_bwd(
                    lf.data_ptr(), rf.data_ptr(), gl.data_ptr(),
                    gr.data_ptr(), g.data_ptr(), dl.data_ptr(), dr.data_ptr(),
                    None, None, N, P, grid[1], grid[2], 64, 64, 32, cs, s, sx,
                    sy, 0, stream())
                assert err == 0, err

            run()
            close(f"bwd slice{cs}_split{s}", dl, want[0], 2.0 ** -7)
            close(f"bwd slice{cs}_split{s}", dr, want[1], 2.0 ** -7)
            record(f"bwd slice{cs}_split{s}", cuda_ms(run, 10))
        for k, nw, nl, name in ((1, grid[1], grid[2], "lanes1"),
                                (2, grid[1], grid[2], "lanes2"),
                                (4, grid[1], grid[2], "lanes4"),
                                (8, grid[1], grid[2], "lanes8"),
                                (1, 1, P, "memory_order")):

            def run():
                err = lib.k1v_bwd_lanes(
                    k, lf.data_ptr(), rf.data_ptr(), gl.data_ptr(),
                    gr.data_ptr(), g.data_ptr(), dl.data_ptr(), dr.data_ptr(),
                    N, P, nw, nl, 64, 64, 32, t.splits, sx, sy, stream())
                assert err == 0, err

            run()
            close(f"bwd {name}", dl, want[0], 2.0 ** -7)
            close(f"bwd {name}", dr, want[1], 2.0 ** -7)
            record(f"bwd {name}", cuda_ms(run, 10))
        cells = torch.randint(0, 63, (N, 1, 2), generator=gen).float()
        patch = ((cells + torch.rand((N, P, 2), generator=gen) * 0.9 + 0.55)
                 * (roi[1] / 64)).to(dev)
        want_patch = sample_stereo_voxel_bwd(lf.float(), rf.float(), patch,
                                             patch, g.float(), roi,
                                             need_grid=False)
        got = stereo_voxel_sample_bwd(lf, rf, patch, patch, g, roi,
                                      need_grid=False)
        close("bwd one_patch", got[0], want_patch[0], 2.0 ** -7)
        record("bwd one_patch", cuda_ms(lambda: stereo_voxel_sample_bwd(
            lf, rf, patch, patch, g, roi, need_grid=False), 10))
        del want_patch, got
        for v, name in enumerate(("per_point", "strided", "pixmajor",
                                  "global")):
            f32 = name == "global"

            def run():
                a = torch.zeros(lf.shape, dtype=torch.float32, device=dev) \
                    if f32 else dl
                b = torch.zeros_like(a) if f32 else dr
                err = lib.k1v_bwd(v, gl.data_ptr(), gr.data_ptr(),
                                  g.data_ptr(), a.data_ptr(), b.data_ptr(), N,
                                  P, 64, 64, 32, t.splits, sx, sy, stream())
                assert err == 0, err
                return (a.bfloat16(), b.bfloat16()) if f32 else (a, b)

            a, b = run()
            close(f"bwd {name}", a, want[0], 2.0 ** -7)
            close(f"bwd {name}", b, want[1], 2.0 ** -7)
            record(f"bwd {name}", cuda_ms(run, 10))
    leaves = [f.detach().requires_grad_() for f in (lf, rf)]
    scale = torch.tensor([2.0 / roi[1], 2.0 / roi[0]], device=dev)
    outs, gouts = [], []
    for leaf, gp, half in ((leaves[0], gl, g[..., :32]),
                           (leaves[1], gr, g[..., 32:])):
        ng = (gp * scale - 1.0)[:, None].to(torch.bfloat16)
        outs.append(F.grid_sample(leaf.permute(0, 3, 1, 2), ng,
                                  align_corners=False))
        gouts.append(half.reshape(N, 1, -1, 32).permute(0, 3, 1, 2))
    record("bwd library", cuda_ms(lambda: torch.autograd.grad(
        outs, leaves, gouts, retain_graph=True), 5))
    print(json.dumps({"k1_variants": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
