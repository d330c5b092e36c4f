// Kernel K1: stereo voxel sampler (bilinear gather, zeros padding,
// align_corners=False), NHWC features -> [N, P, 2C] voxel, left view first.
//
// Replaces the Pallas kernel snvc_tpu/ops/grid_sample_pallas.py
// (_sample_stereo_voxel_impl -> full_call :217 / banded_call :281), which
// forms a hat-weighted interpolation matrix per 1024-point block and runs it
// on the TPU matrix unit because the TPU has no gather.  Here each thread
// gathers directly: one thread per (point, view, group of 16 bytes of
// channels).  Points are in the h-major ravel order of the grid, as in
// ops/grid_sample.py.  Coordinates and weights are float32; the four taps are
// summed in float32 and rounded once.  Each of the four taps outside the
// image contributes zero (the plain version's _gather_hw).  The tail of the
// last block is masked by the thread-index bound (the TPU kernel padded the
// point list with -1e4 coordinates instead).
//
// Bound: memory (~0.68 GB per flagship request: the voxel write dominates).
// Neighbouring threads write neighbouring 16-byte groups of the same point,
// so the output stream is coalesced; the feature maps (256 KB per view and
// instance) stay in L1/L2 for the gathers.
//
// Backward (snvc_stereo_voxel_sample_bwd) replaces the VJP the JAX package
// takes through XLA (grid_sample_pallas.py:329-342): the same thread layout
// reads its 16 bytes of the output gradient and scatters the four weighted
// taps into a float32 copy of each feature map with atomicAdd (the caller
// zeroes it and casts it to the feature dtype once).  At the training shape
// ~147k points land on 4096 pixels per view and instance, so the adds
// contend; their order varies from run to run.  When asked, it also gives
// the gradient of both projection grids (the weights' derivatives in x and
// y times the tap values, summed over the thread's channels and added
// atomically over its channel groups).

#include "common.cuh"

namespace {

using snvc::Vec;

template <typename T>
__global__ void stereo_voxel_sample_kernel(
    const T* __restrict__ lf, const T* __restrict__ rf,
    const float* __restrict__ gl, const float* __restrict__ gr,
    T* __restrict__ out, int N, int P, int Hf, int Wf, int C,
    float sx, float sy) {
  constexpr int V = Vec<T>::N;
  const int G = C / V;  // channel groups per view
  const int64_t total = (int64_t)N * P * 2 * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;  // masked tail
  const int g = (int)(idx % G);
  const int view = (int)((idx / G) % 2);
  const int64_t np = idx / (2 * G);  // n * P + p
  const int n = (int)(np / P);

  const float* gp = (view == 0 ? gl : gr) + np * 2;
  const T* feat = (view == 0 ? lf : rf) + (int64_t)n * Hf * Wf * C + g * V;

  // ROI pixels -> normalized -> feature pixels, the plain version's order
  // of operations with no fused multiply-add.
  const float gx = __fadd_rn(__fmul_rn(gp[0], sx), -1.0f);
  const float gy = __fadd_rn(__fmul_rn(gp[1], sy), -1.0f);
  float x = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)Wf), -1.0f), 0.5f);
  float y = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)Hf), -1.0f), 0.5f);
  // clamping far outside the image changes no tap (all stay outside) and
  // keeps the float -> int conversion in range
  x = fminf(fmaxf(x, -2.0f), (float)Wf + 2.0f);
  y = fminf(fmaxf(y, -2.0f), (float)Hf + 2.0f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
  const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                        fy * (1.0f - fx), fy * fx};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int yy = y0 + (t >> 1);
    const int xx = x0 + (t & 1);
    if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
    float v[V];
    Vec<T>::load(feat + ((int64_t)yy * Wf + xx) * C, v);
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] += wts[t] * v[i];
  }
  Vec<T>::store(out + np * 2 * C + view * C + g * V, acc);
}

template <typename T>
cudaError_t launch(const void* lf, const void* rf, const void* gl,
                   const void* gr, void* out, int N, int P, int Hf, int Wf,
                   int C, float sx, float sy, cudaStream_t stream) {
  const int64_t total = (int64_t)N * P * 2 * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  stereo_voxel_sample_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(lf), static_cast<const T*>(rf),
      static_cast<const float*>(gl), static_cast<const float*>(gr),
      static_cast<T*>(out), N, P, Hf, Wf, C, sx, sy);
  return cudaGetLastError();
}

template <typename T>
__global__ void stereo_voxel_sample_bwd_kernel(
    const T* __restrict__ lf, const T* __restrict__ rf,
    const float* __restrict__ gl, const float* __restrict__ gr,
    const T* __restrict__ gout, float* __restrict__ dlf,
    float* __restrict__ drf, float* __restrict__ dgl,
    float* __restrict__ dgr, int N, int P, int Hf, int Wf, int C, float sx,
    float sy) {
  constexpr int V = Vec<T>::N;
  const int G = C / V;
  const int64_t total = (int64_t)N * P * 2 * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % G);
  const int view = (int)((idx / G) % 2);
  const int64_t np = idx / (2 * G);
  const int n = (int)(np / P);

  const float* gp = (view == 0 ? gl : gr) + np * 2;
  const int64_t fbase = (int64_t)n * Hf * Wf * C + g * V;
  float* dfeat = (view == 0 ? dlf : drf) + fbase;

  // the forward's coordinates, operation for operation
  const float gx = __fadd_rn(__fmul_rn(gp[0], sx), -1.0f);
  const float gy = __fadd_rn(__fmul_rn(gp[1], sy), -1.0f);
  float x = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gx, 1.0f), (float)Wf), -1.0f), 0.5f);
  float y = __fmul_rn(__fadd_rn(__fmul_rn(__fadd_rn(gy, 1.0f), (float)Hf), -1.0f), 0.5f);
  x = fminf(fmaxf(x, -2.0f), (float)Wf + 2.0f);
  y = fminf(fmaxf(y, -2.0f), (float)Hf + 2.0f);
  const float x0f = floorf(x), y0f = floorf(y);
  const float fx = x - x0f, fy = y - y0f;
  const int x0 = (int)x0f, y0 = (int)y0f;

  float go[V];
  Vec<T>::load(gout + np * 2 * C + view * C + g * V, go);
  const float wts[4] = {(1.0f - fy) * (1.0f - fx), (1.0f - fy) * fx,
                        fy * (1.0f - fx), fy * fx};
  // d(weight)/dx and d(weight)/dy of each tap
  const float wx[4] = {-(1.0f - fy), 1.0f - fy, -fy, fy};
  const float wy[4] = {-(1.0f - fx), -fx, 1.0f - fx, fx};
  const bool want_grid = dgl != nullptr;
  const T* feat = (view == 0 ? lf : rf) + fbase;
  float ddx = 0.0f, ddy = 0.0f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int yy = y0 + (t >> 1);
    const int xx = x0 + (t & 1);
    if (yy < 0 || yy >= Hf || xx < 0 || xx >= Wf) continue;
    const int64_t off = ((int64_t)yy * Wf + xx) * C;
#pragma unroll
    for (int i = 0; i < V; ++i) atomicAdd(dfeat + off + i, wts[t] * go[i]);
    if (want_grid) {
      float v[V];
      Vec<T>::load(feat + off, v);
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < V; ++i) dot += go[i] * v[i];
      ddx += wx[t] * dot;
      ddy += wy[t] * dot;
    }
  }
  if (want_grid) {
    // x = ((p * sx - 1 + 1) * Wf - 1) / 2: dx/dp = Wf * sx / 2
    float* dg = (view == 0 ? dgl : dgr) + np * 2;
    atomicAdd(dg, ddx * 0.5f * (float)Wf * sx);
    atomicAdd(dg + 1, ddy * 0.5f * (float)Hf * sy);
  }
}

template <typename T>
cudaError_t launch_bwd(const void* lf, const void* rf, const void* gl,
                       const void* gr, const void* gout, void* dlf, void* drf,
                       void* dgl, void* dgr, int N, int P, int Hf, int Wf,
                       int C, float sx, float sy, cudaStream_t stream) {
  const int64_t total = (int64_t)N * P * 2 * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  stereo_voxel_sample_bwd_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(lf), static_cast<const T*>(rf),
      static_cast<const float*>(gl), static_cast<const float*>(gr),
      static_cast<const T*>(gout), static_cast<float*>(dlf),
      static_cast<float*>(drf), static_cast<float*>(dgl),
      static_cast<float*>(dgr), N, P, Hf, Wf, C, sx, sy);
  return cudaGetLastError();
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

// Backward.  gout [N, P, 2C] in the feature dtype; dlf / drf [N, Hf, Wf, C]
// float32, zeroed by the caller; dgl / dgr [N, P, 2] float32, zeroed, or
// both null to skip the grid gradient.  Returns a cudaError_t.
int snvc_stereo_voxel_sample_bwd(const void* lf, const void* rf,
                                 const void* gl, const void* gr,
                                 const void* gout, void* dlf, void* drf,
                                 void* dgl, void* dgr, int N, int P, int Hf,
                                 int Wf, int C, float sx, float sy, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((dgl == nullptr) != (dgr == nullptr)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)launch_bwd<__nv_bfloat16>(lf, rf, gl, gr, gout, dlf, drf, dgl,
                                          dgr, N, P, Hf, Wf, C, sx, sy, s);
  if (dtype == 1)
    return (int)launch_bwd<float>(lf, rf, gl, gr, gout, dlf, drf, dgl, dgr, N,
                                  P, Hf, Wf, C, sx, sy, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
