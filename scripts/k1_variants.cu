// Alternatives to the K1 kernels, timed against the shipped ones by
// scripts/k1_variants.py to find what bounds each; not part of the package.
// Compiled with -I snvc_tpu_torch/csrc: it includes the shipped source for
// its helpers (project, store_channels), bf16 only.

#include "stereo_voxel_sample.cu"

namespace {

using bf16 = __nv_bfloat16;

template <typename T, int K>
__device__ __forceinline__ void load_channels(const T* p, float* v) {
#pragma unroll
  for (int i = 0; i < K; i += Vec<T>::N) Vec<T>::load(p + i, v + i);
}

// The forward's tap sum for one (point, view, 16-byte group), as shipped.
__device__ __forceinline__ void sample_group(const bf16* feat,
                                             const float* gp, bf16* out,
                                             int Hf, int Wf, int C, float sx,
                                             float sy) {
  const Taps tp = project(gp[0], gp[1], Hf, Wf, sx, sy);
  const float fx = tp.fx, fy = tp.fy;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                        fy * (1.0f - fx), fy * fx};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int yy = tp.y0 + (t >> 1);
    const int xx = tp.x0 + (t & 1);
    if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
    float v[8];
    Vec<bf16>::load(feat + (yy * Wf + xx) * C, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] += wts[t] * v[i];
  }
  Vec<bf16>::store(out, acc);
}

// Forward variant 0, the first version's decode: one thread per (point,
// view, group) on a flat 1-D grid, the index split by 64-bit division by
// runtime values.  Variant 1: the same flat order within an instance
// (blockIdx.y), split by 32-bit division.
template <bool k64>
__global__ void fwd_decode_kernel(const bf16* lf, const bf16* rf,
                                  const float* gl, const float* gr, bf16* out,
                                  int N, int P, int Hf, int Wf, int C,
                                  float sx, float sy) {
  const int G = C / 8;
  int64_t np;
  int n, g, view;
  if (k64) {
    const int64_t total = (int64_t)N * P * 2 * G;
    const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= total) return;
    g = (int)(idx % G);
    view = (int)((idx / G) % 2);
    np = idx / (2 * G);
    n = (int)(np / P);
  } else {
    const int idx = blockIdx.x * blockDim.x + threadIdx.x;
    if (idx >= P * 2 * G) return;
    g = idx % G;
    view = (idx / G) % 2;
    n = blockIdx.y;
    np = (int64_t)n * P + idx / (2 * G);
  }
  sample_group((view == 0 ? lf : rf) + (int64_t)n * Hf * Wf * C + g * 8,
               (view == 0 ? gl : gr) + np * 2,
               out + np * 2 * C + view * C + g * 8, Hf, Wf, C, sx, sy);
}

// Forward variant 2: one thread per (point, view) computes the coordinates
// once and writes all G groups of the view (G 16-byte stores, 64 bytes
// apart between neighbouring threads).
__global__ void fwd_point_kernel(const bf16* lf, const bf16* rf,
                                 const float* gl, const float* gr, bf16* out,
                                 int P, int Hf, int Wf, int C, float sx,
                                 float sy) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * P) return;
  const int view = idx & 1, n = blockIdx.y;
  const int64_t np = (int64_t)n * P + (idx >> 1);
  const float* gp = (view == 0 ? gl : gr) + np * 2;
  const Taps tp = project(gp[0], gp[1], Hf, Wf, sx, sy);
  const float fx = tp.fx, fy = tp.fy;
  const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                        fy * (1.0f - fx), fy * fx};
  const bf16* feat = (view == 0 ? lf : rf) + (int64_t)n * Hf * Wf * C;
  for (int g = 0; g < C / 8; ++g) {
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yy = tp.y0 + (t >> 1);
      const int xx = tp.x0 + (t & 1);
      if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
      float v[8];
      Vec<bf16>::load(feat + (yy * Wf + xx) * C + g * 8, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += wts[t] * v[i];
    }
    Vec<bf16>::store(out + np * 2 * C + view * C + g * 8, acc);
  }
}

// Forward variants 3-6: the shipped thread layout at K points a thread
// (blockDim.y * K consecutive points a block, a warp's stores contiguous
// in each of its K steps), all K projections loaded first; kWriteOnly
// stores zeros and loads nothing (the store stream alone).
template <int K, bool kWriteOnly>
__global__ void fwd_multi_kernel(const bf16* lf, const bf16* rf,
                                 const float* gl, const float* gr, bf16* out,
                                 int P, int Hf, int Wf, int C, float sx,
                                 float sy) {
  const int G = C / 8;
  const int view = threadIdx.x >= G;
  const int g = threadIdx.x - view * G;
  const int n = blockIdx.y;
  const int first = blockIdx.x * blockDim.y * K + threadIdx.y;
  const float2* proj =
      reinterpret_cast<const float2*>((view == 0 ? gl : gr) + (int64_t)n * P * 2);
  const bf16* feat = (view == 0 ? lf : rf) + (int64_t)n * Hf * Wf * C + g * 8;
  bf16* dst = out + (int64_t)n * P * 2 * C + view * C + g * 8;
  float2 pxy[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = min(first + k * (int)blockDim.y, P - 1);
    pxy[k] = kWriteOnly ? make_float2(0.0f, 0.0f) : proj[p];
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = first + k * blockDim.y;
    if (p >= P) break;
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
    if (!kWriteOnly) {
      const Taps tp = project(pxy[k].x, pxy[k].y, Hf, Wf, sx, sy);
      const float fx = tp.fx, fy = tp.fy;
      const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                            fy * (1.0f - fx), fy * fx};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int yy = tp.y0 + (t >> 1);
        const int xx = tp.x0 + (t & 1);
        if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
        float v[8];
        Vec<bf16>::load(feat + (yy * Wf + xx) * C, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += wts[t] * v[i];
      }
    }
    Vec<bf16>::store(dst + (int64_t)p * 2 * C, acc);
  }
}

// Backward variants: the first shared-memory scatter (8-channel slices,
// no grid gradient, one thread per point, each point's four taps added to
// shared memory at once); kStrided = each thread walks its own contiguous run of
// points (a warp's 32 lanes sit far apart in the point list) instead of 32
// neighbouring points; kPixMajor = the map as [Hf*Wf][8] instead of
// channel-major [8][Hf*Wf] (one instruction's 32 lanes then meet 4 banks).
template <bool kStrided, bool kPixMajor>
__global__ void __launch_bounds__(kBwdThreads)
    bwd_smem_kernel(const float* gl, const float* gr, const bf16* gout,
                    bf16* dlf, bf16* drf, int P, int Hf, int Wf, int C,
                    float sx, float sy) {
  constexpr int CS = 8;
  extern __shared__ float acc[];
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, split = blockIdx.x;
  const int view = blockIdx.y & 1, slice = blockIdx.y >> 1;
  const int n = blockIdx.z, HW = Hf * Wf, c0 = slice * CS;
  for (int i = threadIdx.x; i < CS * HW; i += kBwdThreads) acc[i] = 0.0f;
  __syncthreads();
  const int per = (P + S - 1) / S;
  const int p0 = split * per, p1 = min(P, p0 + per);
  const int64_t np0 = (int64_t)n * P;
  const float2* proj =
      reinterpret_cast<const float2*>((view == 0 ? gl : gr) + np0 * 2);
  const bf16* go_base = gout + np0 * 2 * C + view * C + c0;
  const int run = (p1 - p0 + kBwdThreads - 1) / kBwdThreads;
  for (int it = 0; it < run; ++it) {
    const int p = kStrided ? p0 + threadIdx.x * run + it
                           : p0 + threadIdx.x + it * kBwdThreads;
    if (p >= p1) break;
    const float2 pxy = proj[p];
    const Taps tp = project(pxy.x, pxy.y, Hf, Wf, sx, sy);
    const float fx = tp.fx, fy = tp.fy;
    float go[CS];
    load_channels<bf16, CS>(go_base + (int64_t)p * 2 * C, go);
    const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                          fy * (1.0f - fx), fy * fx};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yy = tp.y0 + (t >> 1);
      const int xx = tp.x0 + (t & 1);
      if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
      const int pix = yy * Wf + xx;
#pragma unroll
      for (int c = 0; c < CS; ++c)
        atomicAdd(acc + (kPixMajor ? pix * CS + c : c * HW + pix),
                  wts[t] * go[c]);
    }
  }
  cluster.sync();
  bf16* dfeat = (view == 0 ? dlf : drf) + (int64_t)n * HW * C + c0;
  const int share = (HW + S - 1) / S;
  const int q0 = split * share, q1 = min(HW, q0 + share);
  for (int pix = q0 + threadIdx.x; pix < q1; pix += kBwdThreads) {
    float v[CS];
#pragma unroll
    for (int c = 0; c < CS; ++c) v[c] = 0.0f;
    for (int r = 0; r < S; ++r) {
      const float* part = cluster.map_shared_rank(acc, r);
#pragma unroll
      for (int c = 0; c < CS; ++c)
        v[c] += part[kPixMajor ? pix * CS + c : c * HW + pix];
    }
    store_channels<bf16, CS>(dfeat + (int64_t)pix * C, v);
  }
  cluster.sync();
}

// Backward variant: the first version, one float32 global atomicAdd per
// (point, view, channel, tap) into maps the caller zeroes (and casts).
__global__ void bwd_global_kernel(const float* gl, const float* gr,
                                  const bf16* gout, float* dlf, float* drf,
                                  int N, int P, int Hf, int Wf, int C,
                                  float sx, float sy) {
  const int G = C / 8;
  const int64_t total = (int64_t)N * P * 2 * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % G);
  const int view = (int)((idx / G) % 2);
  const int64_t np = idx / (2 * G);
  const int n = (int)(np / P);
  const float* gp = (view == 0 ? gl : gr) + np * 2;
  float* dfeat = (view == 0 ? dlf : drf) + (int64_t)n * Hf * Wf * C + g * 8;
  const Taps tp = project(gp[0], gp[1], Hf, Wf, sx, sy);
  const float fx = tp.fx, fy = tp.fy;
  float go[8];
  Vec<bf16>::load(gout + np * 2 * C + view * C + g * 8, go);
  const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                        fy * (1.0f - fx), fy * fx};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int yy = tp.y0 + (t >> 1);
    const int xx = tp.x0 + (t & 1);
    if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
    const int64_t off = ((int64_t)yy * Wf + xx) * C;
#pragma unroll
    for (int i = 0; i < 8; ++i) atomicAdd(dfeat + off + i, wts[t] * go[i]);
  }
}

template <bool kStrided, bool kPixMajor>
cudaError_t launch_bwd_smem(const void* gl, const void* gr, const void* gout,
                            void* dlf, void* drf, int N, int P, int Hf,
                            int Wf, int C, int S, float sx, float sy,
                            cudaStream_t stream) {
  auto kernel = bwd_smem_kernel<kStrided, kPixMajor>;
  const int smem = 8 * Hf * Wf * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 2 * (C / 8), N);
  cfg.blockDim = dim3(kBwdThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = S;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(gl),
                           static_cast<const float*>(gr),
                           static_cast<const bf16*>(gout),
                           static_cast<bf16*>(dlf), static_cast<bf16*>(drf),
                           P, Hf, Wf, C, sx, sy);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// variant: 0 = 64-bit decode, 1 = 32-bit decode, 2 = thread per (point,
// view), 3 / 4 / 5 = 1 / 2 / 8 points a thread (the shipped kernel takes
// 4), 6 = the store stream alone (zeros).  bf16 features, C a multiple of 8
// with 2C / 8 dividing 256.
int k1v_fwd(int variant, const void* lf, const void* rf, const void* gl,
            const void* gr, void* out, int N, int P, int Hf, int Wf, int C,
            float sx, float sy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto lfp = static_cast<const bf16*>(lf), rfp = static_cast<const bf16*>(rf);
  auto glp = static_cast<const float*>(gl), grp = static_cast<const float*>(gr);
  auto op = static_cast<bf16*>(out);
  const int G = C / 8;
  const dim3 block(2 * G, 256 / (2 * G));
  auto grid_of = [&](int k) {
    return dim3((P + block.y * k - 1) / (block.y * k), N);
  };
  if (variant == 0) {
    const int64_t total = (int64_t)N * P * 2 * G;
    fwd_decode_kernel<true><<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        lfp, rfp, glp, grp, op, N, P, Hf, Wf, C, sx, sy);
  } else if (variant == 1) {
    fwd_decode_kernel<false><<<dim3((P * 2 * G + 255) / 256, N), 256, 0, s>>>(
        lfp, rfp, glp, grp, op, N, P, Hf, Wf, C, sx, sy);
  } else if (variant == 2) {
    fwd_point_kernel<<<dim3((2 * P + 255) / 256, N), 256, 0, s>>>(
        lfp, rfp, glp, grp, op, P, Hf, Wf, C, sx, sy);
  } else if (variant == 3) {
    fwd_multi_kernel<1, false><<<grid_of(1), block, 0, s>>>(
        lfp, rfp, glp, grp, op, P, Hf, Wf, C, sx, sy);
  } else if (variant == 4) {
    fwd_multi_kernel<2, false><<<grid_of(2), block, 0, s>>>(
        lfp, rfp, glp, grp, op, P, Hf, Wf, C, sx, sy);
  } else if (variant == 5) {
    fwd_multi_kernel<8, false><<<grid_of(8), block, 0, s>>>(
        lfp, rfp, glp, grp, op, P, Hf, Wf, C, sx, sy);
  } else if (variant == 6) {
    fwd_multi_kernel<4, true><<<grid_of(4), block, 0, s>>>(
        lfp, rfp, glp, grp, op, P, Hf, Wf, C, sx, sy);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// variant: 0 = one thread per point, 32 neighbouring points a warp; 1 = the
// same, each thread walking its own run of points; 2 = the same as 0 on a
// pixel-major map; 3 = global float32 atomics into zeroed float32 maps
// (dlf / drf float32 then).  bf16 gradient, 8-channel slices, S splits
// (ignored by variant 3).
int k1v_bwd(int variant, const void* gl, const void* gr, const void* gout,
            void* dlf, void* drf, int N, int P, int Hf, int Wf, int C, int S,
            float sx, float sy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return (int)launch_bwd_smem<false, false>(gl, gr, gout, dlf, drf, N, P,
                                              Hf, Wf, C, S, sx, sy, s);
  if (variant == 1)
    return (int)launch_bwd_smem<true, false>(gl, gr, gout, dlf, drf, N, P, Hf,
                                             Wf, C, S, sx, sy, s);
  if (variant == 2)
    return (int)launch_bwd_smem<false, true>(gl, gr, gout, dlf, drf, N, P, Hf,
                                             Wf, C, S, sx, sy, s);
  if (variant == 3) {
    const int64_t total = (int64_t)N * P * 2 * (C / 8);
    bwd_global_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
        static_cast<const float*>(gl), static_cast<const float*>(gr),
        static_cast<const bf16*>(gout), static_cast<float*>(dlf),
        static_cast<float*>(drf), N, P, Hf, Wf, C, sx, sy);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

// The shipped backward kernel at K = 1, 2, 4 or 8 channels a lane (8-channel
// slices, S splits, no grid gradient) on an [nh, nw, nl] grid; nw = 1 walks
// the points in memory order.
int k1v_bwd_lanes(int K, const void* lf, const void* rf, const void* gl,
                  const void* gr, const void* gout, void* dlf, void* drf,
                  int N, int P, int nw, int nl, int Hf, int Wf, int C, int S,
                  float sx, float sy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
#define K1V_LANES(k)                                                          \
  case k:                                                                     \
    return (int)launch_bwd_cs<bf16, 8, k>(lf, rf, gl, gr, gout, dlf, drf,     \
                                          nullptr, nullptr, N, P, nw, nl, Hf, \
                                          Wf, C, S, sx, sy, s);
    K1V_LANES(1)
    K1V_LANES(2)
    K1V_LANES(4)
    K1V_LANES(8)
#undef K1V_LANES
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
