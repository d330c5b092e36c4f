// Kernel K3: plane-sweep stereo cost volume, downsample 1, NHWC features ->
// [N, D, H, W, 2C] (left half first), depth-major.
//
//   out[n,d,h,x, :C] = left[n,h,x]
//   out[n,d,h,x, C:] = fs * right[n,h,x-ks-1] + (1-fs) * right[n,h,x-ks]
//   ks = floor(s), fs = s - ks, s = shifts[n*shift_n_stride + d] >= 0,
//   taps left of column 0 are zero.
//
// Replaces the Pallas kernel snvc_tpu/ops/cost_volume.py (_psv_kernel,
// pallas_call at :119 in _psv_pallas_fwd), which streams a left-zero-padded,
// column-major float32 copy of the right features through VMEM as two dynamic
// W-row slices per (sample, plane, 128 lanes) and leaves the concat with the
// left half to a separate XLA pass.  Here one thread owns one 16-byte group of
// the 2C output channels of one voxel (n, d, h, x): groups below C copy the
// left features bit for bit, groups above lerp the right taps in float32 and
// round once, as the Pallas kernel does.  Both halves leave in one pass, and
// neighbouring threads store neighbouring 16-byte groups of the same voxel.
// The multiply and add are the round-to-nearest intrinsics, in the plain
// version's order (a * fs + b * (1 - fs)), so no fused multiply-add changes
// the float32 sum.
//
// Bound: memory (the 2C-wide output is ~65x the size of the inputs at the
// serving shape).  The right row (n, h) read by every plane is W*C elements
// (20 KB at W = 312, C = 32 bf16) and stays in L1/L2.

#include "common.cuh"

namespace {

using snvc::Vec;

template <typename T>
__global__ void plane_sweep_volume_kernel(
    const T* __restrict__ left, const T* __restrict__ right,
    const float* __restrict__ shifts, T* __restrict__ out, int N, int D,
    int H, int W, int C, int shift_n_stride) {
  constexpr int V = Vec<T>::N;
  const int G = C / V;  // 16-byte groups per half
  const int64_t total = (int64_t)N * D * H * W * 2 * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;  // masked tail
  const int g2 = (int)(idx % (2 * G));
  int64_t r = idx / (2 * G);
  const int x = (int)(r % W);
  r /= W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int n = (int)(r / D);

  T* dst = out + idx * V;  // the output is dense in (voxel, group) order
  const int64_t row = ((int64_t)n * H + h) * W;  // (n, h, 0) in features
  if (g2 < G) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(left + (row + x) * C + g2 * V);
    return;
  }
  const int g = g2 - G;
  const float s = shifts[(int64_t)n * shift_n_stride + d];
  const float ksf = floorf(s);
  const float fs = __fsub_rn(s, ksf);
  const float gs = __fsub_rn(1.0f, fs);
  // a shift past the row puts both taps outside it; clamping it keeps the
  // float -> int conversion in range and changes no tap.  The contract takes
  // shifts >= 0, which the host checks; a negative one is not read back here,
  // so taps right of the row are zeroed too and nothing is read out of bounds
  const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
  const int x0 = x - ks - 1, x1 = x - ks;
  float a[V], b[V], o[V];
#pragma unroll
  for (int i = 0; i < V; ++i) a[i] = b[i] = 0.0f;
  const T* base = right + row * C + g * V;
  if (x0 >= 0 && x0 < W) Vec<T>::load(base + (int64_t)x0 * C, a);
  if (x1 >= 0 && x1 < W) Vec<T>::load(base + (int64_t)x1 * C, b);
#pragma unroll
  for (int i = 0; i < V; ++i) o[i] = __fadd_rn(__fmul_rn(a[i], fs), __fmul_rn(b[i], gs));
  Vec<T>::store(dst, o);
}

template <typename T>
cudaError_t launch(const void* left, const void* right, const void* shifts,
                   void* out, int N, int D, int H, int W, int C,
                   int shift_n_stride, cudaStream_t stream) {
  const int64_t total = (int64_t)N * D * H * W * 2 * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  plane_sweep_volume_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(shifts), static_cast<T*>(out), N, D, H, W, C,
      shift_n_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  shift_n_stride: 0 for a shared [D]
// table, D for a per-sample [N, D] table.  Returns a cudaError_t (0 = ok).
int snvc_plane_sweep_volume(const void* left, const void* right,
                            const void* shifts, void* out, int N, int D,
                            int H, int W, int C, int shift_n_stride,
                            int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<__nv_bfloat16>(left, right, shifts, out, N, D, H, W, C,
                                      shift_n_stride, s);
  if (dtype == 1)
    return (int)launch<float>(left, right, shifts, out, N, D, H, W, C,
                              shift_n_stride, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
