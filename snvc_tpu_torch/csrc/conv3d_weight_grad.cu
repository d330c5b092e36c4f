// Weight gradient of the stride-1 3D convs of kernels K2 and K5, NDHWC bf16
// in, float32 accumulation:
//
//   dw[a, b, c, ci, f] = sum over (n, d, h, w) of
//       x[n, d + a*dil - pd, h + b*dil - ph, w + c*dil - pw, ci] * g[n, d, h, w, f]
//
// with zeros outside the volume (torch-symmetric padding (k-1)/2*dil).
// It replaces the weight half of the VJP the JAX package takes through XLA
// for its Pallas convs (conv3d_fold_pallas.py:285-292, conv3d_pallas.py:
// 138-155).  Per tap this is a GEMM X_tap^T . G with M = C, N = F and K =
// N*D*H*W positions (1.18 M at the training shape).  Bound: operations
// (conv1_k7 at the training shape is 1.43 useful TFLOP against ~0.23 GB of
// x and g).
//
//   block  = 3 warpgroups (384 threads) owning one depth tap dz, 2*DXS
//            consecutive column taps dx (DXS = 64 / CB per consumer
//            warpgroup), all kh row taps dy, a channel block of CB = 16, 32
//            or 64, a feature block of NB = 16 or 32, a column chunk of TWc
//            (a multiple of 32) and a contiguous range of (n, d) planes: its
//            split of K.  The wrapper (ops/conv3d_fold.py:dw_tiling,
//            dw_splits) chooses TWc, the stages and the splits;
//   pipeline = per plane, row steps j = 0 .. H-1+ph; step j brings g row j
//            ([TWc, NB], 64- or 32-byte swizzle) and input row j - ph of plane
//            d + dz*dil - pd ([TWc + (2*DXS-1)*dil, CB], the swizzle of CB*2-
//            byte rows, zeros outside the volume) by 5-D TMA loads into one
//            slot of a ring of `stages` >= (kh-1)*dil + 3 slots.  A g row
//            stays resident for the (kh-1)*dil steps after its own: the
//            consumers release step q's slot after step q + (kh-1)*dil + 1
//            (by then its last wgmma group has completed, so no step ends
//            in a wgmma drain), so
//            each x row and each g row crosses L2 once per block;
//   consumers = 2 warpgroups; the 64 rows of each one's wgmma M are (dx
//            slot, channel).  Per step and 16-position k-step every warp
//            loads one A = X^T fragment with ldmatrix.trans from the staged
//            input row at its tap's column shift, and it feeds the kh
//            wgmma.m64nNBk16 of the row taps dy whose g row j - dy*dil is in
//            the ring: B is that g row's [16, NB] slice through an MN-major
//            (transposed) descriptor.  The accumulators of all kh row taps
//            stay in registers for the whole split.  Rows outside the volume
//            are neither loaded nor multiplied; the ragged column edge is
//            zero-filled by the TMA at 16-position granularity.  Row taps whose g
//            row lies outside the plane multiply a zeroed tile instead (no
//            branch may surround a wgmma: ptxas would serialize them all);
//   output = each block writes its float32 sums to its own slice of a
//            [splits * column chunks, taps, C', F'] partial buffer; a second
//            kernel adds the slices in a fixed order and rounds once to bf16
//            (the JAX VJP of a bf16 conv gives dw in bf16 too), so dw does
//            not depend on the order in which blocks run.
//
// Budget (ptxas, sm_90a, CUDA 12.9): every instantiation (template <kh, NB>)
// 168 registers (the cap for 384 threads at one block per SM), 0 bytes
// spilled: kh x NB/2 accumulators, at most 112; the producer drops to 40
// registers (setmaxnreg) and the consumers need no more than the cap.
// Shared memory: stages x (x row + g row) + a 1 KB zero tile, e.g. 196 KB
// (10 stages) for conv1_k7 at the training shape.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int THREADS = 384;  // producer + 2 consumer warpgroups
constexpr int MAX_STAGES = 16;
constexpr int SMEM_LIMIT = 232448;

struct Geom {
  int N, D, H, W, C, F;  // dw is [kd, kh, kw, C, F]
  int Cx, Fg;            // channel counts of x and g (multiples of 8)
  int kd, kh, kw, dil, pd, ph, pw;
  int CB, DXS, NB, TWc, nk, xcols;
  int ncb, nfb, ndxg, nwc, pps, stages;
  uint32_t x_bytes, x_stride, g_bytes, g_stride;
  int Cp, Fp;  // partial buffer's channel and feature extents
};

__host__ __device__ inline uint32_t align1024(uint32_t v) {
  return (v + 1023u) & ~1023u;
}

template <int KH, int NB>
__global__ void __launch_bounds__(THREADS, 1)
conv3d_weight_grad_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap gmap,
                          float* __restrict__ partial, const Geom g) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xs0 = smem;
  unsigned char* gs0 = smem + g.stages * g.x_stride;
  unsigned char* zero = gs0 + g.stages * g.g_stride;  // [16, NB] zeros
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + 1024);
  uint64_t* empty = full + MAX_STAGES;

  long long t = blockIdx.x;
  const int wc = (int)(t % g.nwc); t /= g.nwc;
  const int fb = (int)(t % g.nfb); t /= g.nfb;
  const int cb = (int)(t % g.ncb); t /= g.ncb;
  const int dxg = (int)(t % g.ndxg); t /= g.ndxg;
  const int dz = (int)(t % g.kd);
  const int split = (int)(t / g.kd);
  const int planes = g.N * g.D;
  const int p0 = split * g.pps;
  const int p1 = min(planes, p0 + g.pps);
  const int w0 = wc * g.TWc;
  const int dx0 = dxg * 2 * g.DXS;
  const int lag = (g.kh - 1) * g.dil;  // steps a g row stays in use
  const int steps = g.H + g.ph;        // row steps per plane

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
      int q = 0;
      for (int p = p0; p < p1; ++p) {
        const int n = p / g.D, d = p % g.D;
        const int zd = d + dz * g.dil - g.pd;
        if (zd < 0 || zd >= g.D) continue;
        for (int j = 0; j < steps; ++j, ++q) {
          const int slot = q % g.stages, use = q / g.stages;
          if (use > 0) hopper::mbar_wait(&empty[slot], (use - 1) & 1);
          const bool gin = j < g.H;
          const int r = j - g.ph;
          const bool xin = r >= 0 && r < g.H;
          hopper::mbar_arrive_expect_tx(
              &full[slot], (gin ? g.g_bytes : 0u) + (xin ? g.x_bytes : 0u));
          if (gin)
            hopper::tma_load_5d(gs0 + slot * g.g_stride, &gmap, &full[slot],
                                fb * NB, w0, j, d, n);
          if (xin)
            hopper::tma_load_5d(xs0 + slot * g.x_stride, &xmap, &full[slot],
                                cb * g.CB, w0 - g.pw + dx0 * g.dil, r, zd, n);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers ----
  const int cw = wg - 1;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int xrow = g.CB * 2;  // bytes per staged input position
  const int sl = warp * 16 / g.CB;       // this warp's dx slot
  const int cofs = warp * 16 % g.CB;     // and first channel in the block

  // Row taps whose g row lies outside the plane multiply a zero tile, so no
  // branch surrounds a wgmma (a divergent path makes ptxas serialize them).
  reinterpret_cast<uint32_t*>(zero)[threadIdx.x - 128] = 0u;
  hopper::fence_proxy_async();
  hopper::named_barrier_sync(1, 256);

  float acc[KH][NB / 2];
#pragma unroll
  for (int b = 0; b < KH; ++b)
#pragma unroll
    for (int e = 0; e < NB / 2; ++e) acc[b][e] = 0.0f;

  // ldmatrix.x4.trans lane address: matrices (ch 0-7 | 8-15) x (pos 0-7 |
  // 8-15) of the [position, channel] row, at this warp's column shift
  const int pos = (lane & 7) + ((lane >> 4) & 1) * 8;
  const uint32_t lane_off =
      (uint32_t)((pos + (cw * g.DXS + sl) * g.dil) * xrow +
                 (cofs + ((lane >> 3) & 1) * 8) * 2);
  const uint32_t glayout = hopper::desc_layout(NB * 2);
  const uint32_t zaddr = hopper::smem_addr(zero);

  uint32_t a[2][4];
  int q = 0;
  for (int p = p0; p < p1; ++p) {
    const int d = p % g.D;
    const int zd = d + dz * g.dil - g.pd;
    if (zd < 0 || zd >= g.D) continue;
    for (int j = 0; j < steps; ++j, ++q) {
      const int slot = q % g.stages;
      hopper::mbar_wait(&full[slot], (q / g.stages) & 1);
      const int r = j - g.ph;
      if (r >= 0 && r < g.H) {
        const uint32_t xs = hopper::smem_addr(xs0 + slot * g.x_stride);
        uint64_t desc[KH];  // B of each row tap at k-step 0
        uint32_t step[KH];  // and its advance per k-step (16-byte units)
#pragma unroll
        for (int b = 0; b < KH; ++b) {
          const int h = j - b * g.dil;
          const bool in = h >= 0 && h < g.H;
          const uint32_t gaddr = hopper::smem_addr(
              gs0 + ((q + g.stages * 8 - b * g.dil) % g.stages) * g.g_stride);
          desc[b] = hopper::make_desc(in ? gaddr : zaddr, 16, 8 * NB * 2,
                                      glayout);
          step[b] = in ? 2 * NB : 0u;
        }
        auto kstep = [&](auto bc, int k) {
          constexpr int B = decltype(bc)::value;
          hopper::ldmatrix_x4_trans(
              a[B], xs + hopper::swizzle(lane_off + k * 16 * xrow, xrow));
          hopper::wgmma_fence();
#pragma unroll
          for (int b = 0; b < KH; ++b)
            hopper::Wgmma<NB, 1>::run(acc[b], a[B],
                                      desc[b] + (uint64_t)(k * step[b]));
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();
        };
        for (int k = 0; k < g.nk; k += 2) {  // nk is even
          kstep(std::integral_constant<int, 0>{}, k);
          kstep(std::integral_constant<int, 1>{}, k + 1);
        }
      }
      // Step q - lag - 1's g row met its last x row in step q - 1, whose
      // wgmmas are complete (at most step q's last group is in flight).
      if (q > lag) {
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&empty[(q - lag - 1) % g.stages]);
      }
    }
  }
  hopper::wgmma_wait<0>();

  // --------------------------------------------------------- epilogue ----
  const int dx = dx0 + cw * g.DXS + sl;
  if (dx >= g.kw) return;  // a slot past the last column tap
  const int taps = g.kd * g.kh * g.kw;
  const int c = cb * g.CB + cofs + lane / 4;
  const int slice = split * g.nwc + wc;
#pragma unroll
  for (int b = 0; b < KH; ++b) {
    const int64_t tap = (int64_t)slice * taps + (dz * g.kh + b) * g.kw + dx;
    float* row0 = partial + (tap * g.Cp + c) * g.Fp + fb * NB + 2 * (lane % 4);
    float* row1 = row0 + 8 * g.Fp;
#pragma unroll
    for (int qq = 0; qq < NB / 8; ++qq) {
      *reinterpret_cast<float2*>(row0 + 8 * qq) =
          make_float2(acc[b][4 * qq], acc[b][4 * qq + 1]);
      *reinterpret_cast<float2*>(row1 + 8 * qq) =
          make_float2(acc[b][4 * qq + 2], acc[b][4 * qq + 3]);
    }
  }
}

// dw[tap, ci, f] = bf16(sum over slices, in order, of partial[s, tap, ci, f])
__global__ void reduce_splits_kernel(const float* __restrict__ partial,
                                     __nv_bfloat16* __restrict__ dw,
                                     int slices, int taps, int C, int F,
                                     int Cp, int Fp) {
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t total = (int64_t)taps * C * F;
  if (idx >= total) return;
  const int f = (int)(idx % F);
  const int ci = (int)((idx / F) % C);
  const int64_t tap = idx / ((int64_t)C * F);
  float s = 0.0f;
  for (int sp = 0; sp < slices; ++sp)
    s += partial[(((int64_t)sp * taps + tap) * Cp + ci) * Fp + f];
  dw[idx] = __float2bfloat16(s);
}

template <int KH, int NB>
cudaError_t launch(const CUtensorMap& xmap, const CUtensorMap& gmap,
                   void* partial, const Geom& g, size_t smem, long long blocks,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      conv3d_weight_grad_kernel<KH, NB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  conv3d_weight_grad_kernel<KH, NB><<<(unsigned)blocks, THREADS, smem, stream>>>(
      xmap, gmap, static_cast<float*>(partial), g);
  return cudaGetLastError();
}

template <int NB>
cudaError_t launch_kh(const CUtensorMap& xmap, const CUtensorMap& gmap,
                      void* partial, const Geom& g, size_t smem,
                      long long blocks, cudaStream_t s) {
  switch (g.kh) {
    case 1: return launch<1, NB>(xmap, gmap, partial, g, smem, blocks, s);
    case 3: return launch<3, NB>(xmap, gmap, partial, g, smem, blocks, s);
    case 5: return launch<5, NB>(xmap, gmap, partial, g, smem, blocks, s);
    case 7: return launch<7, NB>(xmap, gmap, partial, g, smem, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// x [N, D, H, W, Cx] and g [N, D, H, W, Fg] bf16, contiguous, Cx and Fg
// multiples of 8 (>= the C and F of dw; the extra channels are zeros);
// partial float32 [splits * column chunks, kd*kh*kw, C', F'] scratch the
// caller allocates (C', F': Cx and Fg rounded up to the channel block CB
// and the feature block NB); dw [kd, kh, kw, C, F] bf16.  Odd kernels with
// kh <= 7.  TWc, stages and splits come from ops/conv3d_fold.py:dw_tiling
// and dw_splits.  Returns a cudaError_t.
int snvc_conv3d_weight_grad(const void* x, const void* gr, void* partial,
                            void* dw, int N, int D, int H, int W, int C, int F,
                            int Cx, int Fg, int kd, int kh, int kw, int dil,
                            int TWc, int stages, int splits, void* stream) {
  if (N <= 0 || D <= 0 || H <= 0 || W <= 0 || C <= 0 || F <= 0 || dil <= 0 ||
      Cx < C || Fg < F || Cx % 8 != 0 || Fg % 8 != 0 || splits <= 0 ||
      kd % 2 == 0 || kh % 2 == 0 || kw % 2 == 0 || kh > 7 || TWc <= 0 ||
      TWc % 32 != 0 || stages > MAX_STAGES)
    return (int)cudaErrorInvalidValue;
  Geom g;
  g.N = N; g.D = D; g.H = H; g.W = W; g.C = C; g.F = F; g.Cx = Cx; g.Fg = Fg;
  g.kd = kd; g.kh = kh; g.kw = kw; g.dil = dil;
  g.pd = (kd - 1) / 2 * dil;
  g.ph = (kh - 1) / 2 * dil;
  g.pw = (kw - 1) / 2 * dil;
  g.CB = Cx <= 16 ? 16 : Cx <= 32 ? 32 : 64;
  g.DXS = 64 / g.CB;
  g.NB = Fg <= 16 ? 16 : 32;
  g.TWc = TWc;
  g.nk = TWc / 16;
  g.xcols = TWc + (2 * g.DXS - 1) * dil;
  if (g.xcols > 256 || TWc > 256) return (int)cudaErrorInvalidConfiguration;
  g.ncb = (Cx + g.CB - 1) / g.CB;
  g.nfb = (Fg + g.NB - 1) / g.NB;
  g.ndxg = (kw + 2 * g.DXS - 1) / (2 * g.DXS);
  g.nwc = (W + TWc - 1) / TWc;
  const int planes = N * D;
  g.pps = (planes + splits - 1) / splits;
  g.stages = stages;
  if (stages < (kh - 1) * dil + 3) return (int)cudaErrorInvalidConfiguration;
  g.x_bytes = (uint32_t)g.xcols * g.CB * 2;
  g.x_stride = align1024(g.x_bytes);
  g.g_bytes = (uint32_t)TWc * g.NB * 2;
  g.g_stride = align1024(g.g_bytes);
  g.Cp = g.ncb * g.CB;
  g.Fp = g.nfb * g.NB;
  const size_t smem = 1024 + (size_t)stages * (g.x_stride + g.g_stride) +
                      1024 + 2 * MAX_STAGES * 8;
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidConfiguration;
  const long long blocks =
      (long long)splits * kd * g.ndxg * g.ncb * g.nfb * g.nwc;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;

  CUtensorMap xmap, gmap;
  const uint64_t xdims[5] = {(uint64_t)Cx, (uint64_t)W, (uint64_t)H,
                             (uint64_t)D, (uint64_t)N};
  const uint64_t gdims[5] = {(uint64_t)Fg, (uint64_t)W, (uint64_t)H,
                             (uint64_t)D, (uint64_t)N};
  cudaError_t err = hopper::encode_5d(&xmap, x, xdims, (uint32_t)g.CB,
                                      (uint32_t)g.xcols, 1);
  if (err != cudaSuccess) return (int)err;
  err = hopper::encode_5d(&gmap, gr, gdims, (uint32_t)g.NB, (uint32_t)TWc, 1);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = g.NB == 16 ? launch_kh<16>(xmap, gmap, partial, g, smem, blocks, s)
                   : launch_kh<32>(xmap, gmap, partial, g, smem, blocks, s);
  if (err != cudaSuccess) return (int)err;
  const int taps = kd * kh * kw;
  const int64_t total = (int64_t)taps * C * F;
  const int threads = 256;
  reduce_splits_kernel<<<(unsigned)((total + threads - 1) / threads), threads,
                         0, s>>>(static_cast<const float*>(partial),
                                 static_cast<__nv_bfloat16*>(dw),
                                 splits * g.nwc, taps, C, F, g.Cp, g.Fp);
  return (int)cudaGetLastError();
}

}  // extern "C"
