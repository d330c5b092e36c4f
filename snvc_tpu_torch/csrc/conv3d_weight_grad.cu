// Weight gradient of the stride-1 3D convs of kernels K2 and K5, NDHWC bf16
// in, float32 accumulation:
//
//   dw[a, b, c, ci, f] = sum over (n, d, h, w) of
//       x[n, d + a*dil - pd, h + b*dil - ph, w + c*dil - pw, ci] * g[n, d, h, w, f]
//
// with zeros outside the volume (torch-symmetric padding (k-1)/2*dil).
// It replaces the weight half of the VJP the JAX package takes through XLA
// for its Pallas convs (conv3d_fold_pallas.py:285-292, conv3d_pallas.py:
// 138-155), which re-runs the per-tap convolution.  Per tap this is a GEMM
// X_tap^T . G with M = C, N = F and K = N*D*H*W positions (1.18 M at the
// training shape), so the work is split over K:
//
//   block  = 4 warps; owns one (dz, dy) tap pair, all kw taps of that pair,
//            64 input channels x 32 output features, and a contiguous range
//            of output rows (n, d, h) (its split of K);
//   loop   = over its rows and 64-column strips: stage the strip of g
//            ([64, 32]) and the input row it meets ([64 + (kw-1)*dil, 64],
//            zero outside) in shared memory; every warp then runs WMMA bf16
//            16x16x16 k-steps for its (channel tile, feature tile) pairs and
//            all kw taps (the staged g is reused kw times);
//   output = each block writes its float32 sums to its own slice of a
//            [splits, taps, C16, F16] partial buffer; a second kernel adds
//            the splits in a fixed order and rounds once to bf16 (the JAX
//            VJP of a bf16 conv gives dw in bf16 too).
//
// Rows whose input row lies outside the volume are skipped (they add
// nothing).  Bound: operations (conv1_k7 at the training shape is 1.66
// TFLOP of useful multiply-adds against ~0.23 GB of x and g).  Like the K2
// forward, this first version stages with plain loads and __syncthreads;
// no cp.async / TMA pipeline, no wgmma.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int TW = 64;   // output columns per staged strip
constexpr int CB = 64;   // input channels per block
constexpr int FB = 32;   // output features per block
constexpr int SX = CB + 16;  // x smem row stride (elements, 32 B multiple)
constexpr int SG = FB + 16;  // g smem row stride
constexpr int THREADS = 128;
constexpr int FT = FB / 16;               // feature tiles per block
constexpr int PAIRS = (CB / 16) * FT;     // (channel tile, feature tile)
constexpr int PPW = PAIRS / (THREADS / 32);  // pairs per warp

struct Geom {
  int N, D, H, W, C, F, kd, kh, kw, dil;
  int pd, ph, pw;
  int cols;    // staged input columns = TW + (kw-1)*dil
  int rows;    // N*D*H output rows
  int rps;     // rows per split
  int Cp, Fp;  // C and F rounded up to 16 (partial buffer layout)
  int ctiles;  // channel blocks
};

template <int KW>
__global__ void __launch_bounds__(THREADS)
conv3d_weight_grad_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          float* __restrict__ partial, Geom geo) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* s_x = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_g = s_x + geo.cols * SX;

  const int warp = threadIdx.x / 32;
  const int split = blockIdx.x;
  const int tap2 = blockIdx.y;  // dz * kh + dy
  const int dz = tap2 / geo.kh;
  const int dy = tap2 % geo.kh;
  const int c0 = (blockIdx.z % geo.ctiles) * CB;
  const int f0 = (blockIdx.z / geo.ctiles) * FB;
  const bool cvec = (geo.C % 8) == 0;
  const bool fvec = (geo.F % 8) == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PPW][KW];
#pragma unroll
  for (int p = 0; p < PPW; ++p)
#pragma unroll
    for (int t = 0; t < KW; ++t) wmma::fill_fragment(acc[p][t], 0.0f);

  bool live[PPW];  // warp-uniform: the pair's tiles overlap C and F
#pragma unroll
  for (int p = 0; p < PPW; ++p) {
    const int pair = warp + p * (THREADS / 32);
    live[p] = c0 + (pair / FT) * 16 < geo.C && f0 + (pair % FT) * 16 < geo.F;
  }

  const int r0 = split * geo.rps;
  const int r1 = min(geo.rows, r0 + geo.rps);
  for (int r = r0; r < r1; ++r) {
    const int h = r % geo.H;
    const int d = (r / geo.H) % geo.D;
    const int n = r / (geo.H * geo.D);
    const int zd = d + dz * geo.dil - geo.pd;
    const int zh = h + dy * geo.dil - geo.ph;
    if (zd < 0 || zd >= geo.D || zh < 0 || zh >= geo.H) continue;  // uniform
    const int64_t xrow = (((int64_t)n * geo.D + zd) * geo.H + zh) * geo.W;
    const int64_t grow = (int64_t)r * geo.W;
    for (int w0 = 0; w0 < geo.W; w0 += TW) {
      __syncthreads();  // the previous strip's reads are done
      // ---- stage g: [TW][FB], zero past W or F
      for (int i = threadIdx.x; i < TW * (FB / 8); i += THREADS) {
        const int fg = i % (FB / 8);
        const int col = i / (FB / 8);
        const int ww = w0 + col;
        const int f = f0 + fg * 8;
        __nv_bfloat16* dst = s_g + col * SG + fg * 8;
        const int64_t src = (grow + ww) * geo.F + f;
        if (fvec) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (ww < geo.W && f < geo.F)
            v = *reinterpret_cast<const uint4*>(g + src);
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (ww < geo.W && f + e < geo.F) ? g[src + e]
                                                   : __float2bfloat16(0.0f);
        }
      }
      // ---- stage x: [cols][CB], zero outside the volume or past C
      for (int i = threadIdx.x; i < geo.cols * (CB / 8); i += THREADS) {
        const int grp = i % (CB / 8);
        const int col = i / (CB / 8);
        const int zw = w0 + col - geo.pw;
        const int c = c0 + grp * 8;
        __nv_bfloat16* dst = s_x + col * SX + grp * 8;
        const int64_t src = (xrow + zw) * geo.C + c;
        const bool inside = zw >= 0 && zw < geo.W;
        if (cvec) {
          uint4 v = make_uint4(0, 0, 0, 0);
          if (inside && c < geo.C) v = *reinterpret_cast<const uint4*>(x + src);
          *reinterpret_cast<uint4*>(dst) = v;
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dst[e] = (inside && c + e < geo.C) ? x[src + e]
                                               : __float2bfloat16(0.0f);
        }
      }
      __syncthreads();
      // ---- k-steps over the strip's 64 columns
#pragma unroll
      for (int k = 0; k < TW; k += 16) {
#pragma unroll
        for (int p = 0; p < PPW; ++p) {
          if (!live[p]) continue;
          const int pair = warp + p * (THREADS / 32);
          const int ct = pair / FT, ft = pair % FT;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major> b;
          wmma::load_matrix_sync(b, s_g + k * SG + ft * 16, SG);
#pragma unroll
          for (int t = 0; t < KW; ++t) {
            // A = X^T: element (ci, col) at s_x[(col + t*dil) * SX + ci]
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> a;
            wmma::load_matrix_sync(a, s_x + (k + t * geo.dil) * SX + ct * 16,
                                   SX);
            wmma::mma_sync(acc[p][t], a, b, acc[p][t]);
          }
        }
      }
    }
  }

  // ---- epilogue: this split's sums -> partial[split, tap, Cp, Fp]
  const int taps = geo.kd * geo.kh * KW;
#pragma unroll
  for (int p = 0; p < PPW; ++p) {
    if (!live[p]) continue;
    const int pair = warp + p * (THREADS / 32);
    const int ct = pair / FT, ft = pair % FT;
#pragma unroll
    for (int t = 0; t < KW; ++t) {
      const int64_t tap = (int64_t)split * taps + tap2 * KW + t;
      float* dst = partial + (tap * geo.Cp + c0 + ct * 16) * geo.Fp + f0 +
                   ft * 16;
      wmma::store_matrix_sync(dst, acc[p][t], geo.Fp, wmma::mem_row_major);
    }
  }
}

// dw[tap, ci, f] = bf16(sum over splits, in order, of partial[s, tap, ci, f])
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ dw,
                                     int splits, int taps, int C, int F,
                                     int Cp, int Fp) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)taps * C * F;
  if (idx >= total) return;
  const int f = (int)(idx % F);
  const int ci = (int)((idx / F) % C);
  const int64_t tap = idx / ((int64_t)C * F);
  float s = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    s += partial[(((int64_t)sp * taps + tap) * Cp + ci) * Fp + f];
  dw[idx] = __float2bfloat16(s);
}

template <int KW>
cudaError_t launch(const void* x, const void* g, void* partial, const Geom& geo,
                   int splits, cudaStream_t stream) {
  const size_t smem = (size_t)(geo.cols * SX + TW * SG) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_weight_grad_kernel<KW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int ftiles = (geo.F + FB - 1) / FB;
  dim3 grid((unsigned)splits, (unsigned)(geo.kd * geo.kh),
            (unsigned)(geo.ctiles * ftiles));
  conv3d_weight_grad_kernel<KW><<<grid, THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial), geo);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// x [N, D, H, W, C] and g [N, D, H, W, F] bf16, contiguous; partial float32
// [splits, kd*kh*kw, C16, F16] (C16, F16: C and F rounded up to 16), scratch
// the caller allocates; dw [kd, kh, kw, C, F] bf16.  Odd kernels with
// kw in {1, 3, 5, 7}; kd*kh <= 65535.  Returns a cudaError_t.
int snvc_conv3d_weight_grad(const void* x, const void* g, void* partial,
                            void* dw, int N, int D, int H, int W, int C, int F,
                            int kd, int kh, int kw, int dil, int splits,
                            void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || dil <= 0 ||
      splits <= 0 || kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 ||
      kd * kh > 65535)
    return (int)cudaErrorInvalidValue;
  Geom geo;
  geo.N = N; geo.D = D; geo.H = H; geo.W = W; geo.C = C; geo.F = F;
  geo.kd = kd; geo.kh = kh; geo.kw = kw; geo.dil = dil;
  geo.pd = (kd - 1) / 2 * dil;
  geo.ph = (kh - 1) / 2 * dil;
  geo.pw = (kw - 1) / 2 * dil;
  geo.cols = TW + (kw - 1) * dil;
  const int64_t rows = (int64_t)N * D * H;
  if (rows > 2147483647LL) return (int)cudaErrorInvalidValue;
  geo.rows = (int)rows;
  geo.rps = (int)((rows + splits - 1) / splits);
  geo.Cp = (C + 15) / 16 * 16;
  geo.Fp = (F + 15) / 16 * 16;
  geo.ctiles = (C + CB - 1) / CB;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kw) {
    case 1: err = launch<1>(x, g, partial, geo, splits, s); break;
    case 3: err = launch<3>(x, g, partial, geo, splits, s); break;
    case 5: err = launch<5>(x, g, partial, geo, splits, s); break;
    case 7: err = launch<7>(x, g, partial, geo, splits, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  const int taps = kd * kh * kw;
  const int64_t total = (int64_t)taps * C * F;
  const int threads = 256;
  reduce_splits_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(static_cast<const float*>(partial),
                                 static_cast<__nv_bfloat16*>(dw), splits, taps,
                                 C, F, geo.Cp, geo.Fp);
  return (int)cudaGetLastError();
}

}  // extern "C"
