// Kernel K1: stereo voxel sampler (bilinear gather, zeros padding,
// align_corners=False), NHWC features -> [N, P, 2C] voxel, left view first.
//
// Replaces the Pallas kernel snvc_tpu/ops/grid_sample_pallas.py
// (_sample_stereo_voxel_impl -> full_call :217 / banded_call :281), which
// forms a hat-weighted interpolation matrix per 1024-point block and runs it
// on the TPU matrix unit because the TPU has no gather.  Points are in the
// h-major ravel order of the grid, as in ops/grid_sample.py.  Coordinates and
// weights are float32 in the plain version's order of operations (no fused
// multiply-add); the four taps are summed in float32 and rounded once; each
// tap outside the image contributes zero (the plain version's _gather_hw).
//
// Forward (snvc_stereo_voxel_sample).  Bound: bytes, ~0.68 GB per flagship
// request, of which the [4, 1.18M, 64] bf16 voxel write is 0.60 GB.  A block
// is 2G x PB threads (G = 16-byte channel groups per view): threadIdx.x picks
// the view and the group, threadIdx.y the point, blockIdx.y the instance, so
// no thread divides to find its work.  Each thread samples kFwdPoints points
// PB apart and loads their projections first, so their latencies overlap;
// in each step the 2G threads of a point write its 2C channels as
// neighbouring 16-byte stores, whole 128-byte lines per warp.  The taps'
// 16-byte gathers come from the instance's feature maps (256 KB per view),
// which stay in L1/L2.
//
// Backward (snvc_stereo_voxel_sample_bwd) replaces the VJP the JAX package
// takes through XLA (grid_sample_pallas.py:329-342): d feature = the scatter
// of each point's four weighted taps of the output gradient.  Bound: bytes,
// the 151 MB gradient at the training shape, read once; but 302M adds land
// there on 2.1M addresses (~144 each), and neighbouring points share taps.
// Each block owns one (instance, view, slice of CS channels) of the float32
// map gradient in shared memory, channel-major with each channel's row
// padded so that a pixel's CS channels lie on CS banks (128 KB at 64x64x8).
// Its threads form walkers of CS / K lanes, K channels a lane; each walker
// takes a contiguous run of the points, computes each point's coordinates
// once for its CS channels, and keeps the four tap sums of the current tap
// cell in registers until a point falls in another cell.  A float atomicAdd
// to shared memory is a compare-and-swap loop on sm_90 (ATOMS.CAST.SPIN), so
// the adds fall by the run length, and the lanes of a flush never share an
// address.  Each block walks the grid with its l or its w axis fastest,
// whichever moves the projection less, so the runs are longer.  Real
// projections change cell every ~2-20 points; K = 2 times best there
// (scripts/k1_variants.py).  The point range is split over the S blocks of
// a thread-block cluster; after a cluster barrier each block sums its share
// of the map over the S partials through distributed shared memory, in rank
// order, and writes it in the feature dtype, so no float32 map lives in
// global memory and no cast follows.  The adds' order varies from run to run.  When
// asked, it also gives the gradient of both projection grids: per point,
// the weights' derivatives in x and y times the dot of the gradient with
// the tap's features, summed over the walker's lanes by shuffles and added
// atomically to the zeroed grid gradient once per channel slice.  The
// caller (ops/stereo_sample_cuda.py: k1_bwd_tiling) picks CS and S.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using snvc::Vec;

// points a forward thread samples, their projections loaded first
constexpr int kFwdPoints = 4;
// threads of a backward block; one block per SM at 128 KB of map
constexpr int kBwdThreads = 1024;
// channels a backward lane accumulates (a walker has CS / K lanes)
constexpr int kLaneChannels = 2;
constexpr int min_int(int a, int b) { return a < b ? a : b; }
// a block's dynamic shared memory on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// K consecutive channels from float32: 16-byte stores where K fills them
// (the offsets are then 16-byte aligned), else one element at a time.
template <typename T, int K>
__device__ __forceinline__ void store_channels(T* p, const float* v) {
  if constexpr (K * sizeof(T) % 16 == 0) {
#pragma unroll
    for (int i = 0; i < K; i += Vec<T>::N) Vec<T>::store(p + i, v + i);
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) p[i] = from_f32<T>(v[i]);
  }
}

// ROI pixels -> normalized -> feature pixels, the plain version's order of
// operations with no fused multiply-add: the top-left tap (x0, y0) and the
// fractions (fx, fy).
struct Taps {
  int x0, y0;
  float fx, fy;
};

__device__ __forceinline__ Taps project(float px, float py, int Hf, int Wf,
                                        float sx, float sy) {
  const float gx = __fadd_rn(__fmul_rn(px, sx), -1.0f);
  const float gy = __fadd_rn(__fmul_rn(py, sy), -1.0f);
  float x = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)Wf), -1.0f), 0.5f);
  float y = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)Hf), -1.0f), 0.5f);
  // clamping far outside the image changes no tap (all stay outside) and
  // keeps the float -> int conversion in range
  x = fminf(fmaxf(x, -2.0f), (float)Wf + 2.0f);
  y = fminf(fmaxf(y, -2.0f), (float)Hf + 2.0f);
  const float x0f = floorf(x), y0f = floorf(y);
  return {(int)x0f, (int)y0f, x - x0f, y - y0f};
}

template <typename T>
__global__ void stereo_voxel_sample_kernel(
    const T* __restrict__ lf, const T* __restrict__ rf,
    const float* __restrict__ gl, const float* __restrict__ gr,
    T* __restrict__ out, int P, int Hf, int Wf, int C, float sx, float sy) {
  constexpr int V = Vec<T>::N;
  const int G = C / V;
  const int view = threadIdx.x >= G;
  const int g = threadIdx.x - view * G;
  const int n = blockIdx.y;
  const int PB = blockDim.y;
  const int first = blockIdx.x * PB * kFwdPoints + threadIdx.y;
  const float2* proj = reinterpret_cast<const float2*>(
      (view == 0 ? gl : gr) + (int64_t)n * P * 2);
  const T* feat = (view == 0 ? lf : rf) + (int64_t)n * Hf * Wf * C + g * V;
  T* dst = out + (int64_t)n * P * 2 * C + view * C + g * V;

  float2 pxy[kFwdPoints];
#pragma unroll
  for (int k = 0; k < kFwdPoints; ++k)
    pxy[k] = proj[min(first + k * PB, P - 1)];
#pragma unroll
  for (int k = 0; k < kFwdPoints; ++k) {
    const int p = first + k * PB;
    if (p >= P) break;  // masked tail
    const Taps tp = project(pxy[k].x, pxy[k].y, Hf, Wf, sx, sy);
    const float fx = tp.fx, fy = tp.fy;
    float acc[V];
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = 0.0f;
    const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                          fy * (1.0f - fx), fy * fx};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yy = tp.y0 + (t >> 1);
      const int xx = tp.x0 + (t & 1);
      if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
      float v[V];
      Vec<T>::load(feat + (yy * Wf + xx) * C, v);
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] += wts[t] * v[i];
    }
    Vec<T>::store(dst + (int64_t)p * 2 * C, acc);
  }
}

template <typename T>
cudaError_t launch(const void* lf, const void* rf, const void* gl,
                   const void* gr, void* out, int N, int P, int Hf, int Wf,
                   int C, float sx, float sy, cudaStream_t stream) {
  if (N == 0 || P == 0) return cudaSuccess;
  const int lanes = 2 * (C / Vec<T>::N);  // both views' channel groups
  if (lanes > 1024 || N > 65535) return cudaErrorInvalidConfiguration;
  const int points = lanes >= 256 ? 1 : 256 / lanes;  // blockDim.y
  const dim3 block(lanes, points);
  const int per_block = points * kFwdPoints;
  const dim3 grid((P + per_block - 1) / per_block, N);
  stereo_voxel_sample_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(lf), static_cast<const T*>(rf),
      static_cast<const float*>(gl), static_cast<const float*>(gr),
      static_cast<T*>(out), P, Hf, Wf, C, sx, sy);
  return cudaGetLastError();
}

// Float32 words between two channels of a block's shared map: Hf * Wf
// rounded up to 32 / CS (mod 32), so that the CS channels of one pixel lie
// on CS different banks.
__host__ __device__ __forceinline__ int channel_stride(int HW, int CS) {
  return CS == 1 ? HW : HW + ((32 / CS - HW % 32) % 32 + 32) % 32;
}

// Dynamic shared memory of a backward block: the [CS][HWp] float32 map and
// 16 bytes for the walk order.
__host__ __device__ __forceinline__ int bwd_smem(int HW, int CS) {
  return CS * channel_stride(HW, CS) * (int)sizeof(float) + 16;
}

// K consecutive channels of T as loaded (one access of K * sizeof(T)
// bytes, aligned to it), unpacked to float32 on use.
template <typename T, int K>
struct Channels {
  static constexpr int kBytes = K * (int)sizeof(T);
  static constexpr int kWords = kBytes >= 4 ? kBytes / 4 : 1;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const T* p) {
    if constexpr (kBytes >= 16) {
#pragma unroll
      for (int i = 0; i < kWords / 4; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(p)[i];
        w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z,
        w[4 * i + 3] = v.w;
      }
    } else if constexpr (kBytes == 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x, w[1] = v.y;
    } else if constexpr (kBytes == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {  // one bf16
      w[0] = *reinterpret_cast<const unsigned short*>(p);
    }
  }
  __device__ __forceinline__ float operator[](int k) const {
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(w[k]);
    } else {  // bf16: the high 16 bits of a float32
      const uint32_t x = w[k / 2];
      return __uint_as_float(k % 2 ? (x & 0xffff0000u) : (x << 16));
    }
  }
};

// grid (S, 2 * C / CS, N), clusters of (S, 1, 1): blockIdx.x is the split
// (and the cluster rank), blockIdx.y the view (low bit) and channel slice,
// blockIdx.z the instance.  The block's threads form walkers of CS / K
// lanes, K channels a lane; each walker scatters its own contiguous run of
// the split's points.
template <typename T, int CS, int K>
__global__ void __launch_bounds__(kBwdThreads)
    stereo_voxel_sample_bwd_kernel(
        const T* __restrict__ lf, const T* __restrict__ rf,
        const float* __restrict__ gl, const float* __restrict__ gr,
        const T* __restrict__ gout, T* __restrict__ dlf,
        T* __restrict__ drf, float* __restrict__ dgl,
        float* __restrict__ dgr, int P, int nw, int nl, int Hf, int Wf,
        int C, float sx, float sy) {
  constexpr int L = CS / K;  // lanes a walker
  constexpr int kWalkers = kBwdThreads / L;
  constexpr int U = K >= 8 ? 2 : 4;  // points whose loads are issued together
  extern __shared__ float acc[];  // [CS][HWp] float32, channel-major; 1 int
  cg::cluster_group cluster = cg::this_cluster();
  const int S = gridDim.x, split = blockIdx.x;
  const int view = blockIdx.y & 1, slice = blockIdx.y >> 1;
  const int n = blockIdx.z;
  const int HW = Hf * Wf, HWp = channel_stride(HW, CS);
  const int lane = threadIdx.x % L, walker = threadIdx.x / L;
  const int c0 = slice * CS, cb = lane * K;

  const int64_t np0 = (int64_t)n * P;
  const float2* proj =
      reinterpret_cast<const float2*>((view == 0 ? gl : gr) + np0 * 2);
  // Walk the grid with its l or its w axis fastest, whichever moves the
  // projection less (summed over 32 sampled steps): runs in one tap cell
  // are then longer.  (The grid is [nh, nw, nl], l fastest in memory.)  The
  // choice lives in the word after the map.
  int* order = reinterpret_cast<int*>(acc + CS * HWp);
  if (threadIdx.x < 32) {
    float dl = 0.0f, dw = 0.0f;
    if (nl > 1 && nw > 1 && P > 0) {
      const int q = (int)((int64_t)threadIdx.x * P / 32);
      const int h = q / (nw * nl), w = min(q / nl % nw, nw - 2);
      const int l = min(q % nl, nl - 2);
      const int p = (h * nw + w) * nl + l;
      const float2 a = proj[p], b = proj[p + 1], c = proj[p + nl];
      dl = fabsf(b.x - a.x) + fabsf(b.y - a.y);
      dw = fabsf(c.x - a.x) + fabsf(c.y - a.y);
    }
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      dl += __shfl_xor_sync(0xffffffffu, dl, off);
      dw += __shfl_xor_sync(0xffffffffu, dw, off);
    }
    if (threadIdx.x == 0) *order = dw < dl;
  }
  for (int i = threadIdx.x; i < CS * HWp; i += kBwdThreads) acc[i] = 0.0f;
  __syncthreads();
  const bool w_fastest = *order;

  // the split's and the walker's ranges of the walk order
  const int per = (P + S - 1) / S;
  const int p0 = split * per, p1 = min(P, p0 + per);
  const int run = (max(p1 - p0, 0) + kWalkers - 1) / kWalkers;
  const int begin = p0 + walker * run, end = min(p1, begin + run);
  const int fast_n = w_fastest ? nw : nl, fast_s = w_fastest ? nl : 1;
  const int mid_n = w_fastest ? nl : nw, mid_s = w_fastest ? 1 : nl;
  const int plane = nw * nl;
  int h = begin / plane, mi = begin % plane / fast_n, fi = begin % fast_n;
  int next = h * plane + mi * mid_s + fi * fast_s;  // the next point
  const T* go_base = gout + np0 * 2 * C + view * C + c0 + cb;
  const bool want_grid = dgl != nullptr;
  const T* feat = (view == 0 ? lf : rf) + (int64_t)n * HW * C + c0 + cb;
  float* map = acc + cb * HWp;
  // the walker's lanes, for the grid gradient's sum over channels
  const unsigned lanes = ((1u << L) - 1u) << (threadIdx.x % 32 / L * L);

  // The tap sums of the current cell stay in registers until a point of
  // the run falls in another cell (neighbouring points often share one),
  // so the shared-memory adds -- a compare-and-swap loop on this card --
  // fall by the run length, and the lanes of a flush never share an
  // address.
  int cx = 0, cy = 0;
  bool open = false;
  float a[4][K];
#pragma unroll
  for (int t = 0; t < 4; ++t)
#pragma unroll
    for (int k = 0; k < K; ++k) a[t][k] = 0.0f;
  auto flush = [&]() {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yy = cy + (t >> 1);
      const int xx = cx + (t & 1);
      if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
#pragma unroll
      for (int k = 0; k < K; ++k)
        atomicAdd(map + k * HWp + yy * Wf + xx, a[t][k]);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int k = 0; k < K; ++k) a[t][k] = 0.0f;
  };
  for (int base = begin; base < end; base += U) {
    int pu[U];
    float2 pxy[U];
    Channels<T, K> go[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      pu[u] = u == 0 || base + u < end ? next : pu[u - 1];
      if (base + u < end) {
        if (++fi == fast_n) {
          fi = 0;
          if (++mi == mid_n) mi = 0, ++h;
        }
        next = h * plane + mi * mid_s + fi * fast_s;
      }
      pxy[u] = proj[pu[u]];
      go[u].load(go_base + (int64_t)pu[u] * 2 * C);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (base + u >= end) break;
      const Taps tp = project(pxy[u].x, pxy[u].y, Hf, Wf, sx, sy);
      const float fx = tp.fx, fy = tp.fy;
      if (!open || tp.x0 != cx || tp.y0 != cy) {
        if (open) flush();
        cx = tp.x0, cy = tp.y0, open = true;
      }
      const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                            fy * (1.0f - fx), fy * fx};
#pragma unroll
      for (int t = 0; t < 4; ++t)
#pragma unroll
        for (int k = 0; k < K; ++k) a[t][k] += wts[t] * go[u][k];
      if (want_grid) {
        // d(weight)/dx and d(weight)/dy of each tap, times the tap's
        // features and the gradient, summed over the slice's channels
        const float wx[4] = {-(1.0f - fy), 1.0f - fy, -fy, fy};
        const float wy[4] = {-(1.0f - fx), -fx, 1.0f - fx, fx};
        float ddx = 0.0f, ddy = 0.0f;
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int yy = tp.y0 + (t >> 1);
          const int xx = tp.x0 + (t & 1);
          if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
          Channels<T, K> f;
          f.load(feat + (yy * Wf + xx) * C);
          float dot = 0.0f;
#pragma unroll
          for (int k = 0; k < K; ++k) dot += go[u][k] * f[k];
          ddx += wx[t] * dot;
          ddy += wy[t] * dot;
        }
#pragma unroll
        for (int off = L / 2; off > 0; off /= 2) {
          ddx += __shfl_xor_sync(lanes, ddx, off);
          ddy += __shfl_xor_sync(lanes, ddy, off);
        }
        if (lane == 0) {
          // x = ((p * sx - 1 + 1) * Wf - 1) / 2: dx/dp = Wf * sx / 2
          float* dg = (view == 0 ? dgl : dgr) + (np0 + pu[u]) * 2;
          atomicAdd(dg, ddx * 0.5f * (float)Wf * sx);
          atomicAdd(dg + 1, ddy * 0.5f * (float)Hf * sy);
        }
      }
    }
  }
  if (open) flush();

  // every partial map of the cluster is complete and visible
  cluster.sync();
  T* dfeat = (view == 0 ? dlf : drf) + (int64_t)n * HW * C + c0;
  const int share = (HW + S - 1) / S;
  const int q0 = split * share, q1 = min(HW, q0 + share);
  for (int pix = q0 + threadIdx.x; pix < q1; pix += kBwdThreads) {
    float v[CS];
#pragma unroll
    for (int k = 0; k < CS; ++k) v[k] = 0.0f;
    for (int r = 0; r < S; ++r) {  // rank order: the same sum every run
      const float* part = cluster.map_shared_rank(acc, r);
#pragma unroll
      for (int k = 0; k < CS; ++k) v[k] += part[k * HWp + pix];
    }
    store_channels<T, CS>(dfeat + (int64_t)pix * C, v);
  }
  // the peers' shared memory stays alive until every block has read it
  cluster.sync();
}

template <typename T, int CS, int K>
cudaError_t launch_bwd_cs(const void* lf, const void* rf, const void* gl,
                          const void* gr, const void* gout, void* dlf,
                          void* drf, void* dgl, void* dgr, int N, int P,
                          int nw, int nl, int Hf, int Wf, int C, int S,
                          float sx, float sy, cudaStream_t stream) {
  auto kernel = stereo_voxel_sample_bwd_kernel<T, CS, K>;
  const int smem = bwd_smem(Hf * Wf, CS);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(S, 2 * (C / CS), N);
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
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(lf), static_cast<const T*>(rf),
      static_cast<const float*>(gl), static_cast<const float*>(gr),
      static_cast<const T*>(gout), static_cast<T*>(dlf), static_cast<T*>(drf),
      static_cast<float*>(dgl), static_cast<float*>(dgr), P, nw, nl, Hf, Wf,
      C, sx, sy);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* lf, const void* rf, const void* gl,
                       const void* gr, const void* gout, void* dlf, void* drf,
                       void* dgl, void* dgr, int N, int P, int nw, int nl,
                       int Hf, int Wf, int C, int CS, int S, float sx,
                       float sy, cudaStream_t stream) {
  if (N == 0 || Hf * Wf == 0 || C == 0) return cudaSuccess;
  if (CS <= 0 || C % CS != 0 || S < 1 || S > 8 || N > 65535 ||
      2 * (C / CS) > 65535 || nw < 1 || nl < 1 || P % (nw * nl) != 0 ||
      (int64_t)bwd_smem(Hf * Wf, CS) > kSmemLimit)
    return cudaErrorInvalidConfiguration;
  switch (CS) {
#define SNVC_BWD_SLICE(cs)                                                  \
  case cs:                                                                  \
    return launch_bwd_cs<T, cs, min_int(cs, kLaneChannels)>(                \
        lf, rf, gl, gr, gout, dlf, drf, dgl, dgr, N, P, nw, nl, Hf, Wf, C,  \
        S, sx, sy, stream);
    SNVC_BWD_SLICE(8)
    SNVC_BWD_SLICE(4)
    SNVC_BWD_SLICE(2)
    SNVC_BWD_SLICE(1)
#undef SNVC_BWD_SLICE
    default:
      return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  Returns a cudaError_t (0 = success).
int snvc_stereo_voxel_sample(const void* lf, const void* rf, const void* gl,
                             const void* gr, void* out, int N, int P, int Hf,
                             int Wf, int C, float sx, float sy, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<__nv_bfloat16>(lf, rf, gl, gr, out, N, P, Hf, Wf, C,
                                      sx, sy, s);
  if (dtype == 1)
    return (int)launch<float>(lf, rf, gl, gr, out, N, P, Hf, Wf, C, sx, sy, s);
  return (int)cudaErrorInvalidValue;
}

// Backward.  gout [N, P, 2C] in the feature dtype, P = nh * nw * nl points
// of an [nh, nw, nl] grid (l fastest); dlf / drf [N, Hf, Wf, C] in the
// feature dtype, written whole; dgl / dgr [N, P, 2] float32, zeroed, or both
// null to skip the grid gradient.  CS channels per block (8, 4, 2 or 1,
// dividing C; CS * Hf * Wf float32 in shared memory), S point splits per
// cluster (1-8).  Returns a cudaError_t.
int snvc_stereo_voxel_sample_bwd(const void* lf, const void* rf,
                                 const void* gl, const void* gr,
                                 const void* gout, void* dlf, void* drf,
                                 void* dgl, void* dgr, int N, int P, int nw,
                                 int nl, int Hf, int Wf, int C, int CS, int S,
                                 float sx, float sy, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dgl == nullptr) != (dgr == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_bwd<__nv_bfloat16>(lf, rf, gl, gr, gout, dlf, drf, dgl,
                                          dgr, N, P, nw, nl, Hf, Wf, C, CS, S,
                                          sx, sy, s);
  if (dtype == 1)
    return (int)launch_bwd<float>(lf, rf, gl, gr, gout, dlf, drf, dgl, dgr, N,
                                  P, nw, nl, Hf, Wf, C, CS, S, sx, sy, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
