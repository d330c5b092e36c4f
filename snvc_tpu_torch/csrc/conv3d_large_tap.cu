// Kernel K2: large-tap stride-1 3D convolution, NDHWC bf16 in and out,
// float32 accumulation.  Odd kernels with kd >= 5, any dilation,
// torch-symmetric padding (k-1)/2*dil on every axis, any D, H, W, C, F.
//
// Replaces the Pallas kernel snvc_tpu/ops/conv3d_fold_pallas.py
// (_fold_vmem_fwd_t -> _kernel, pallas_call at :236).  That kernel folds
// the kd depth taps into the output lanes of one per-plane GEMM to fill the
// TPU's 128-wide matrix unit and carries a rolling f32 accumulator in VMEM
// across a sequential grid; both are TPU shapes.  Here the conv is an
// implicit GEMM on the tensor cores (WMMA bf16 16x16x16, f32 accumulate):
//
//   block  = 4 warps; owns output rows h0..h0+3 (one warp per row),
//            columns w0..w0+63 and features f0..f0+31 of one (n, d) plane;
//   loop   = over (dz, dy, channel chunk of <= 64): stage the 4 input rows
//            (64 + (kw-1)*dil columns, zero outside the volume) and the
//            [kw, C, 32] weight slice in shared memory, then every warp runs
//            kw x C/16 k-steps of 4 x 2 WMMA tiles;
//   output = fragments -> shared memory -> masked bf16 stores, so ragged H,
//            W and F need no divisibility (the TPU gate's W >= 128 and
//            H % 4 == 0 are not conditions here).
//
// Bound: operations (conv1_k7 at the flagship size is 6.6 TFLOP against
// ~0.9 GB of input and output).  This first version stages with plain
// loads and __syncthreads (no cp.async / TMA pipeline, no wgmma), so it
// runs well below the card's bf16 peak; that is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TH = 4;   // output rows per block, one warp each
constexpr int TW = 64;  // output columns per block
constexpr int FB = 32;  // output features per block
constexpr int CC = 64;  // input channels staged per step
constexpr int MT = TW / 16;
constexpr int NT = FB / 16;
constexpr int WS = FB + 16;  // weight smem row stride (elements)
constexpr int THREADS = TH * 32;

struct Geom {
  int N, D, H, W, C, F, kd, kh, kw, dil;
  int pd, ph, pw;   // paddings
  int cols;         // staged input columns = TW + (kw-1)*dil
  int ccp;          // staged channels per step, rounded up to 16
  int sc;           // input smem row stride = ccp + 16 (keeps 32 B alignment)
  int nwt;          // column tiles
};

__device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

__global__ void __launch_bounds__(THREADS)
conv3d_large_tap_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w,
                        __nv_bfloat16* __restrict__ out, Geom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_w = s_in + TH * g.cols * g.sc;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wt = blockIdx.x % g.nwt;
  const int ht = blockIdx.x / g.nwt;
  const int n = blockIdx.y / g.D;
  const int d = blockIdx.y % g.D;
  const int w0 = wt * TW;
  const int h0 = ht * TH;
  const int f0 = blockIdx.z * FB;
  const bool cvec = (g.C % 8) == 0;
  const bool fvec = (g.F % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][NT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int dz = 0; dz < g.kd; ++dz) {
    const int zd = d + dz * g.dil - g.pd;
    if (zd < 0 || zd >= g.D) continue;  // block-uniform: a zero tap plane
    for (int dy = 0; dy < g.kh; ++dy) {
      const int zh0 = h0 + dy * g.dil - g.ph;
      if (zh0 + TH <= 0 || zh0 >= g.H) continue;  // all four rows outside
      for (int c0 = 0; c0 < g.C; c0 += CC) {
        const int clen = min(CC, g.C - c0);
        const int ccp = round16(clen);
        __syncthreads();  // the previous step's reads are done
        // ---- stage input rows: [TH][cols][ccp] (+ pad), zero outside
        const int ngrp = ccp / 8;
        for (int i = threadIdx.x; i < TH * g.cols * ngrp; i += THREADS) {
          const int grp = i % ngrp;
          const int col = (i / ngrp) % g.cols;
          const int r = i / (ngrp * g.cols);
          const int zh = zh0 + r;
          const int zw = w0 + col - g.pw;
          const int c = c0 + grp * 8;
          __nv_bfloat16* dst = s_in + (r * g.cols + col) * g.sc + grp * 8;
          const bool inside = zh >= 0 && zh < g.H && zw >= 0 && zw < g.W;
          const int64_t base =
              ((((int64_t)n * g.D + zd) * g.H + zh) * g.W + zw) * g.C;
          if (cvec) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (inside && c < g.C) v = *reinterpret_cast<const uint4*>(x + base + c);
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = (inside && c + e < g.C) ? x[base + c + e]
                                               : __float2bfloat16(0.0f);
          }
        }
        // ---- stage weights: [kw][ccp][FB] (row stride WS), zero outside
        const int64_t wbase = ((int64_t)(dz * g.kh + dy) * g.kw) * g.C;
        for (int i = threadIdx.x; i < g.kw * ccp * (FB / 8); i += THREADS) {
          const int fg = i % (FB / 8);
          const int c = (i / (FB / 8)) % ccp;
          const int dx = i / ((FB / 8) * ccp);
          const int f = f0 + fg * 8;
          __nv_bfloat16* dst = s_w + (dx * ccp + c) * WS + fg * 8;
          const int64_t src = (wbase + (int64_t)dx * g.C + c0 + c) * g.F + f;
          const bool cin = c < clen;
          if (fvec) {
            uint4 v = make_uint4(0, 0, 0, 0);
            if (cin && f < g.F) v = *reinterpret_cast<const uint4*>(w + src);
            *reinterpret_cast<uint4*>(dst) = v;
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e)
              dst[e] = (cin && f + e < g.F) ? w[src + e]
                                            : __float2bfloat16(0.0f);
          }
        }
        __syncthreads();
        // ---- tensor-core k-steps: warp computes its row x 64 cols x 32 f
        for (int dx = 0; dx < g.kw; ++dx) {
          for (int k = 0; k < ccp; k += 16) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> b[NT];
#pragma unroll
            for (int j = 0; j < NT; ++j)
              wmma::load_matrix_sync(b[j], s_w + (dx * ccp + k) * WS + j * 16,
                                     WS);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major> a;
              wmma::load_matrix_sync(
                  a, s_in + (warp * g.cols + i * 16 + dx * g.dil) * g.sc + k,
                  g.sc);
#pragma unroll
              for (int j = 0; j < NT; ++j)
                wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
            }
          }
        }
      }
    }
  }

  // ---- epilogue: fragments -> smem (f32) -> masked bf16 stores
  __syncthreads();
  float* stage = reinterpret_cast<float*>(smem) + warp * TW * FB;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
      wmma::store_matrix_sync(stage + i * 16 * FB + j * 16, acc[i][j], FB,
                              wmma::mem_row_major);
  __syncwarp();
  const int h = h0 + warp;
  if (h >= g.H) return;
  const int64_t obase = (((int64_t)n * g.D + d) * g.H + h) * g.W;
  for (int i = lane; i < TW * FB; i += 32) {
    const int col = i / FB;
    const int f = f0 + i % FB;
    const int ww = w0 + col;
    if (ww < g.W && f < g.F)
      out[(obase + ww) * g.F + f] = __float2bfloat16(stage[i]);
  }
}

}  // namespace

extern "C" {

// x [N, D, H, W, C], w [kd, kh, kw, C, F], out [N, D, H, W, F], all bf16 and
// contiguous.  Returns a cudaError_t (0 = success).
int snvc_conv3d_large_tap(const void* x, const void* w, void* out, int N,
                          int D, int H, int W, int C, int F, int kd, int kh,
                          int kw, int dil, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || dil <= 0 ||
      kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N; g.D = D; g.H = H; g.W = W; g.C = C; g.F = F;
  g.kd = kd; g.kh = kh; g.kw = kw; g.dil = dil;
  g.pd = (kd - 1) / 2 * dil;
  g.ph = (kh - 1) / 2 * dil;
  g.pw = (kw - 1) / 2 * dil;
  g.cols = TW + (kw - 1) * dil;
  g.ccp = ((C < CC ? C : CC) + 15) / 16 * 16;
  g.sc = g.ccp + 16;
  g.nwt = (W + TW - 1) / TW;
  const int nht = (H + TH - 1) / TH;
  const size_t staged = (size_t)TH * g.cols * g.sc * 2 +
                        (size_t)kw * g.ccp * WS * 2;
  const size_t epilogue = (size_t)TH * TW * FB * 4;
  const size_t smem = staged > epilogue ? staged : epilogue;
  if (smem > 232448) return (int)cudaErrorInvalidConfiguration;
  if ((long long)N * D > 65535) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_large_tap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)(g.nwt * nht), (unsigned)(N * D),
            (unsigned)((F + FB - 1) / FB));
  conv3d_large_tap_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w),
      static_cast<__nv_bfloat16*>(out), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
