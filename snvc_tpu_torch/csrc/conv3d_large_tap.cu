// Kernel K2 (and K5): stride-1 SAME 3D convolution, NDHWC bf16 in and out,
// float32 accumulation.  Odd kernels, dilation 1 or 2, torch-symmetric
// padding (k-1)/2*dil on every axis, any D, H, W; C and F multiples of 8
// (the wrapper pads other channel counts with zeros).
//
// Replaces the Pallas kernel snvc_tpu/ops/conv3d_fold_pallas.py
// (_fold_vmem_fwd_t -> _kernel, pallas_call at :236) and, at a 3x3x3 tap,
// snvc_tpu/ops/conv3d_pallas.py (_conv3d_pallas_fwd, pallas_call at :118);
// it also runs K2's and K5's input gradient (the conv of the output
// gradient with flipped weights).  Bound: operations (conv1_k7 at the
// flagship size is 6.2 useful TFLOP against ~0.9 GB moved).
//
// An implicit GEMM on Hopper's wgmma: M = output positions, N = F, K =
// taps x C.
//
//   block  = 3 warpgroups (384 threads), one tile of 512 output positions
//            of one (n, d) plane: TH = 8R rows x TW = 64/R columns (R = 1
//            or 2, chosen by the wrapper: ops/conv3d_fold.py:conv_tiling),
//            and NB = 16 or 32 output features (F > NB: more tiles).  The
//            tile index is flat (no N*D <= 65535 limit);
//   warpgroup 0 = producer: it drops to 40 registers (setmaxnreg), and one
//            thread keeps up to `stages` (2-4) stages in flight on full /
//            empty mbarriers.  A stage is one (dz, 16-channel chunk) pair:
//            the halo slab [TH + (kh-1)dil, TW + (kw-1)dil, 16] of input
//            plane d + dz*dil - pd by one 5-D TMA load (signed start
//            coordinates, zeros outside the volume: the SAME padding; 32-byte
//            swizzle) and the [kh, kw, 16, NB] weights of that (dz, chunk) by
//            one bulk copy.  Depth taps outside the volume are skipped;
//   warpgroups 1, 2 = consumers, each 4 m64 tiles (R rows x TW columns
//            each).  Per stage and tap dx, each warp loads one A fragment
//            (16 positions x 16 channels) per slab row offset s with
//            ldmatrix at the shifted, swizzled address, and that fragment
//            feeds every m tile j whose rows meet slab row s (s = R*j +
//            dil*dy): up to min(4, kh) wgmma.m64nNBk16 per ldmatrix (for
//            conv1_k7 28 wgmma per 10 loads).  The schedule is compile-time
//            (template <NB, R, dil, kh>): no branch surrounds a wgmma, since
//            ptxas serializes every wgmma of a kernel with a divergent one.
//            B, the tap's [16, NB] weights, comes from shared memory through
//            a no-swizzle K-major descriptor.  A fragments alternate between
//            two register buffers; wait_group 1 keeps one wgmma group in
//            flight behind the next ldmatrix;
//   output = per warp, float32 accumulators -> bf16 in a padded shared tile
//            -> 16-byte stores, masked at ragged H, W and F.
//
// Weights come packed by the wrapper (ops/conv3d_fold.py:pack_conv_weight):
// [F/NB, kd, C/16, kh, kw, NB/8, 2, 8, 8] bf16, i.e. per (dz, chunk, dy, dx)
// the [16 x NB] B tile as wgmma's K-major core matrices (8 features x 8
// channels, 128 bytes; channel groups 128 bytes apart (LBO), feature groups
// 256 bytes apart (SBO)).
//
// Budget (ptxas, sm_90a, CUDA 12.9): every instantiation 168 registers (the
// cap for 384 threads at one block per SM), 0 bytes spilled; the consumers
// fit in it (64 accumulators), so they take no registers back with
// setmaxnreg.inc.  Shared memory: stages x (slab + weights) + 10 KB of
// epilogue tiles, e.g. 175 KB (2 stages) for conv1_k7 at W = 192 and 134 KB
// (4 stages) for the 3x3x3 K5.  Dilation 1 or 2 and kh <= 7 (the
// instantiated schedules); any kd, kw.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MT = 4;         // m64 tiles per consumer warpgroup
constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int MAX_STAGES = 4;
constexpr int SMEM_LIMIT = 232448;

struct Geom {
  int N, D, H, W, C, F;  // C, F: channel counts of x and out (multiples of 8)
  int kd, kh, kw, dil, pd, ph, pw;
  int TW, R, TH, THs, TWs;  // tile and slab
  int nchunk, nht, nwt, nfb, stages;
  uint32_t slab_bytes, slab_stride, w_bytes, w_stride;
};

__host__ __device__ inline uint32_t align1024(uint32_t v) {
  return (v + 1023u) & ~1023u;
}

// The compile-time schedule of one (stage, dx): slab row offset s feeds m
// tile j at row tap dy when s = R*j + DIL*dy.  Every s that feeds some tile
// gets one ldmatrix and the wgmmas of all the tiles it feeds, with no
// branch around any wgmma (a divergent path makes ptxas serialize them).
template <int R, int DIL, int KH>
struct Schedule {
  static constexpr int SMAX = R * (MT - 1) + DIL * (KH - 1);
  __host__ __device__ static constexpr bool hit(int s, int j) {
    return s - R * j >= 0 && (s - R * j) % DIL == 0 && (s - R * j) / DIL < KH;
  }
  __host__ __device__ static constexpr bool live(int s) {
    bool any = false;
    for (int j = 0; j < MT; ++j) any = any || hit(s, j);
    return any;
  }
  __host__ __device__ static constexpr int ordinal(int s) {  // live rows before s
    int n = 0;
    for (int u = 0; u < s; ++u) n += live(u) ? 1 : 0;
    return n;
  }
  static constexpr int rows = ordinal(SMAX + 1);
};

template <int NB>
struct Frag {
  float acc[MT][NB / 2];
  uint32_t a[2][4];
};

template <int NB, int R, int DIL, int KH, int S, int J, int B>
__device__ __forceinline__ void mma_if_hit(Frag<NB>& f, uint64_t desc_dx,
                                           int kw) {
  if constexpr (Schedule<R, DIL, KH>::hit(S, J)) {
    constexpr int dy = (S - R * J) / DIL;
    // B tile (dy, dx) lies (dy*kw + dx) * NB*32 bytes into the stage
    hopper::Wgmma<NB, 0>::run(f.acc[J], f.a[B],
                              desc_dx + (uint64_t)(dy * kw * NB * 2));
  }
}

// Slab rows S.. of one dx: one ldmatrix per live row into register buffer
// (ordinal + P) % 2, then its wgmmas; wait_group 1 keeps the previous
// row's group in flight while the next row's fragment loads.
template <int NB, int R, int DIL, int KH, int P, int S>
__device__ __forceinline__ void rows_from(Frag<NB>& f, uint32_t slab,
                                          uint32_t lane_off, int row_bytes,
                                          uint64_t desc_dx, int kw) {
  using Sch = Schedule<R, DIL, KH>;
  if constexpr (S <= Sch::SMAX) {
    if constexpr (Sch::live(S)) {
      constexpr int B = (Sch::ordinal(S) + P) & 1;
      hopper::ldmatrix_x4(f.a[B],
                          slab + hopper::swizzle(lane_off + S * row_bytes, 32));
      hopper::wgmma_fence();
      mma_if_hit<NB, R, DIL, KH, S, 0, B>(f, desc_dx, kw);
      mma_if_hit<NB, R, DIL, KH, S, 1, B>(f, desc_dx, kw);
      mma_if_hit<NB, R, DIL, KH, S, 2, B>(f, desc_dx, kw);
      mma_if_hit<NB, R, DIL, KH, S, 3, B>(f, desc_dx, kw);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
    }
    rows_from<NB, R, DIL, KH, P, S + 1>(f, slab, lane_off, row_bytes, desc_dx,
                                        kw);
  }
}

template <int NB, int R, int DIL, int KH>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_large_tap_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __nv_bfloat16* __restrict__ wpk,
                        __nv_bfloat16* __restrict__ out, const Geom g) {
  constexpr int EPS = NB * 2 + 16;  // epilogue row stride (bytes)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* slab0 = smem;
  unsigned char* wsm0 = smem + g.stages * g.slab_stride;
  unsigned char* epi = wsm0 + g.stages * g.w_stride;
  uint64_t* full = reinterpret_cast<uint64_t*>(epi + 8 * 16 * EPS);
  uint64_t* empty = full + MAX_STAGES;

  // flat tile index: f block fastest, then columns, rows, depth, batch
  long long t = blockIdx.x;
  const int fb = (int)(t % g.nfb); t /= g.nfb;
  const int wt = (int)(t % g.nwt); t /= g.nwt;
  const int ht = (int)(t % g.nht); t /= g.nht;
  const int d = (int)(t % g.D);
  const int n = (int)(t / g.D);
  const int h0 = ht * g.TH, w0 = wt * g.TW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ------------------------------------------------------- producer ----
    hopper::producer_release_registers();
    if (threadIdx.x == 0) {
      int i = 0;
      for (int dz = 0; dz < g.kd; ++dz) {
        const int zd = d + dz * g.dil - g.pd;
        if (zd < 0 || zd >= g.D) continue;
        for (int ch = 0; ch < g.nchunk; ++ch, ++i) {
          const int slot = i % g.stages, use = i / g.stages;
          if (use > 0) hopper::mbar_wait(&empty[slot], (use - 1) & 1);
          hopper::mbar_arrive_expect_tx(&full[slot], g.slab_bytes + g.w_bytes);
          hopper::tma_load_5d(slab0 + slot * g.slab_stride, &xmap, &full[slot],
                              ch * 16, w0 - g.pw, h0 - g.ph, zd, n);
          const size_t wofs =
              (((size_t)fb * g.kd + dz) * g.nchunk + ch) * (g.w_bytes / 2);
          hopper::bulk_load(wsm0 + slot * g.w_stride, wpk + wofs, g.w_bytes,
                            &full[slot]);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers ----
  using Sch = Schedule<R, DIL, KH>;
  static_assert(MT == 4, "mma_if_hit covers four m tiles");
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int row0 = cw * MT * R;  // this warpgroup's first tile row

  Frag<NB> f;
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) f.acc[j][e] = 0.0f;

  // ldmatrix.x4 lane address: matrices (m 0-7 | 8-15) x (k 0-7 | 8-15)
  const int m = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const uint32_t lane_off =
      (uint32_t)(((row0 + m / g.TW) * g.TWs + m % g.TW) * 32 + (lane >> 4) * 16);
  const int row_bytes = g.TWs * 32;
  constexpr int P1 = Sch::rows & 1;  // buffer parity of the second dx

  int i = 0;
  for (int dz = 0; dz < g.kd; ++dz) {
    const int zd = d + dz * g.dil - g.pd;
    if (zd < 0 || zd >= g.D) continue;
    for (int ch = 0; ch < g.nchunk; ++ch, ++i) {
      const int slot = i % g.stages, use = i / g.stages;
      hopper::mbar_wait(&full[slot], use & 1);
      const uint32_t slab = hopper::smem_addr(slab0 + slot * g.slab_stride);
      const uint64_t desc0 = hopper::make_desc(
          hopper::smem_addr(wsm0 + slot * g.w_stride), 128, 256, 0);
      // dx pairs, then the last dx (kw is odd): buffer parities alternate
      int dx = 0;
      for (; dx + 1 < g.kw; dx += 2) {
        rows_from<NB, R, DIL, KH, 0, 0>(f, slab, lane_off + dx * DIL * 32,
                                        row_bytes, desc0 + dx * NB * 2, g.kw);
        rows_from<NB, R, DIL, KH, P1, 0>(
            f, slab, lane_off + (dx + 1) * DIL * 32, row_bytes,
            desc0 + (dx + 1) * NB * 2, g.kw);
      }
      rows_from<NB, R, DIL, KH, 0, 0>(f, slab, lane_off + dx * DIL * 32,
                                      row_bytes, desc0 + dx * NB * 2, g.kw);
      hopper::wgmma_wait<0>();
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(&empty[slot]);
    }
  }
  hopper::wgmma_wait<0>();

  // --------------------------------------------------------- epilogue ----
  unsigned char* ep = epi + (cw * 4 + warp) * 16 * EPS;
  const int r0 = lane / 4, c0 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < MT; ++j) {
#pragma unroll
    for (int q = 0; q < NB / 8; ++q) {
      *reinterpret_cast<__nv_bfloat162*>(ep + r0 * EPS + (8 * q + c0) * 2) =
          __floats2bfloat162_rn(f.acc[j][4 * q], f.acc[j][4 * q + 1]);
      *reinterpret_cast<__nv_bfloat162*>(ep + (r0 + 8) * EPS + (8 * q + c0) * 2) =
          __floats2bfloat162_rn(f.acc[j][4 * q + 2], f.acc[j][4 * q + 3]);
    }
    __syncwarp();
    for (int c = lane; c < 16 * (NB / 8); c += 32) {
      const int row = c / (NB / 8), q = c % (NB / 8);
      const int mm = warp * 16 + row;
      const int h = h0 + row0 + R * j + mm / g.TW;
      const int w = w0 + mm % g.TW;
      const int f = fb * NB + 8 * q;
      if (h < g.H && w < g.W && f < g.F) {
        const int64_t o = ((((int64_t)n * g.D + d) * g.H + h) * g.W + w) * g.F + f;
        *reinterpret_cast<uint4*>(out + o) =
            *reinterpret_cast<const uint4*>(ep + row * EPS + q * 16);
      }
    }
    __syncwarp();
  }
}

template <int NB, int R, int DIL, int KH>
cudaError_t launch(const CUtensorMap& xmap, const void* wpk, void* out,
                   const Geom& g, size_t smem, long long tiles,
                   cudaStream_t stream) {
  auto kernel = conv3d_large_tap_kernel<NB, R, DIL, KH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)tiles, THREADS, smem, stream>>>(
      xmap, static_cast<const __nv_bfloat16*>(wpk),
      static_cast<__nv_bfloat16*>(out), g);
  return cudaGetLastError();
}

template <int NB, int R, int DIL>
cudaError_t launch_kh(const CUtensorMap& xmap, const void* wpk, void* out,
                      const Geom& g, size_t smem, long long tiles,
                      cudaStream_t s) {
  switch (g.kh) {
    case 1: return launch<NB, R, DIL, 1>(xmap, wpk, out, g, smem, tiles, s);
    case 3: return launch<NB, R, DIL, 3>(xmap, wpk, out, g, smem, tiles, s);
    case 5: return launch<NB, R, DIL, 5>(xmap, wpk, out, g, smem, tiles, s);
    case 7: return launch<NB, R, DIL, 7>(xmap, wpk, out, g, smem, tiles, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int NB>
cudaError_t launch_nb(const CUtensorMap& xmap, const void* wpk, void* out,
                      const Geom& g, size_t smem, long long tiles,
                      cudaStream_t s) {
  if (g.R == 1)
    return g.dil == 1 ? launch_kh<NB, 1, 1>(xmap, wpk, out, g, smem, tiles, s)
                      : launch_kh<NB, 1, 2>(xmap, wpk, out, g, smem, tiles, s);
  return g.dil == 1 ? launch_kh<NB, 2, 1>(xmap, wpk, out, g, smem, tiles, s)
                    : launch_kh<NB, 2, 2>(xmap, wpk, out, g, smem, tiles, s);
}

}  // namespace

extern "C" {

// x [N, D, H, W, C] bf16 (C a multiple of 8); wpk the packed weights (see
// the note above; NB = 16 if F <= 16 else 32, channels padded to 16);
// out [N, D, H, W, F] bf16 (F a multiple of 8); all contiguous, 16-byte
// aligned.  TW (64 or 32) and stages (2-4) come from the wrapper's tiling
// helper (ops/conv3d_fold.py:conv_tiling).  Returns a cudaError_t.
int snvc_conv3d_large_tap(const void* x, const void* wpk, void* out, int N,
                          int D, int H, int W, int C, int F, int kd, int kh,
                          int kw, int dil, int TW, int stages, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 ||
      (dil != 1 && dil != 2) || C % 8 != 0 || F % 8 != 0 || kd % 2 == 0 ||
      kh % 2 == 0 || kh > 7 || kw % 2 == 0 ||
      (TW != 64 && TW != 32) || stages < 2 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N; g.D = D; g.H = H; g.W = W; g.C = C; g.F = F;
  g.kd = kd; g.kh = kh; g.kw = kw; g.dil = dil;
  g.pd = (kd - 1) / 2 * dil;
  g.ph = (kh - 1) / 2 * dil;
  g.pw = (kw - 1) / 2 * dil;
  g.TW = TW;
  g.R = 64 / TW;
  g.TH = 2 * MT * g.R;
  g.THs = g.TH + (kh - 1) * dil;
  g.TWs = TW + (kw - 1) * dil;
  if (g.THs > 256 || g.TWs > 256) return (int)cudaErrorInvalidConfiguration;
  const int NB = F <= 16 ? 16 : 32;
  g.nchunk = (C + 15) / 16;
  g.nht = (H + g.TH - 1) / g.TH;
  g.nwt = (W + TW - 1) / TW;
  g.nfb = (F + NB - 1) / NB;
  g.stages = stages;
  g.slab_bytes = (uint32_t)g.THs * g.TWs * 32;
  g.slab_stride = align1024(g.slab_bytes);
  g.w_bytes = (uint32_t)kh * kw * NB * 32;
  g.w_stride = align1024(g.w_bytes);
  const size_t smem = 1024 + (size_t)stages * (g.slab_stride + g.w_stride) +
                      8 * 16 * (NB * 2 + 16) + 2 * MAX_STAGES * 8;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  const long long tiles = (long long)N * D * g.nht * g.nwt * g.nfb;
  if (tiles > 2147483647LL) return (int)cudaErrorInvalidConfiguration;

  CUtensorMap xmap;
  const uint64_t dims[5] = {(uint64_t)C, (uint64_t)W, (uint64_t)H,
                            (uint64_t)D, (uint64_t)N};
  cudaError_t err = hopper::encode_5d(&xmap, x, dims, 16, (uint32_t)g.TWs,
                                      (uint32_t)g.THs);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = NB == 16 ? launch_nb<16>(xmap, wpk, out, g, smem, tiles, s)
                 : launch_nb<32>(xmap, wpk, out, g, smem, tiles, s);
  return (int)err;
}

}  // extern "C"
