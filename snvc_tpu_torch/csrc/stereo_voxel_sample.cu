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

}  // extern "C"
