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
// left half to a separate XLA pass.
//
// Bound: bytes.  The 2C-wide output is ~65x the inputs (245.4 MB against
// 3.8 MB at the serving shape), so the kernel is a store stream.  A block
// owns one feature row (n, h) -- h from blockIdx.x, n from blockIdx.y -- and
// a group of `planes` consecutive planes (blockIdx.z).  It copies the left
// and right rows (W*C each, 19.5 KB bf16 at the serving shape) into shared
// memory once, then builds each plane's [W, 2C] slab, which is contiguous in
// the output.  A block is G x BY threads (G = 16-byte channel groups of one
// half): threadIdx.x is the group, threadIdx.y the first column, and each
// thread walks the columns BY apart, so no thread divides to find its work.
// Per column a thread writes its left group (copied bit for bit) and its
// right group (the two taps lerped in float32 and rounded once), both with
// the streaming store hint: the volume does not fit the 50 MB L2.  The shift
// and its split are uniform across the block and computed once per plane.
// The multiply and add are the round-to-nearest intrinsics, in the plain
// version's order (a * fs + b * (1 - fs)), so no fused multiply-add changes
// the float32 sum.  ops/cost_volume.py: k3_tiling picks BY and `planes`.
//
// The backward (snvc_plane_sweep_volume_bwd) is the transpose, which JAX
// leaves to XLA (the VJP of the gather form, cost_volume.py:160-169):
//
//   dleft[n,h,x]  = sum_d g[n,d,h,x, :C]
//   dright[n,h,x] = sum_d (1-fs) g[n,d,h,x+ks, C:] + fs g[n,d,h,x+ks+1, C:]
//
// over in-range columns.  Bound: bytes, the gradient read once (245.4 MB
// at the training shape) and both outputs written once.  The shift is
// uniform per plane, so each output column gathers exactly two gradient
// columns at one weight pair and nothing is scattered: a block owns BX
// columns of one feature row (blockIdx.x the column tile, y the row, z the
// sample) and is G x BX threads (threadIdx.x the 16-byte channel group of
// one half, threadIdx.y the column).  A thread loops over the D planes and
// sums its two outputs in float32 registers, in plane order, the right
// half as (b * (1-fs)) + (a * fs) with the round-to-nearest intrinsics,
// and writes each once, rounded once.  The right half's two taps of
// neighbouring columns overlap, so a warp's second load mostly hits L1.
// No atomics and no index division.  ops/cost_volume.py: k3_bwd_tiling
// picks BX.

#include "common.cuh"

namespace {

using snvc::kSmemLimit;
using snvc::Vec;

template <typename T>
__global__ void __launch_bounds__(1024) plane_sweep_volume_kernel(
    const T* __restrict__ left, const T* __restrict__ right,
    const float* __restrict__ shifts, T* __restrict__ out, int D, int H,
    int W, int C, int shift_n_stride, int planes) {
  constexpr int V = Vec<T>::N;
  extern __shared__ uint4 rows[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int d_begin = blockIdx.z * planes;
  const int d_end = min(D, d_begin + planes);
  const int G = blockDim.x;  // C / V
  const int g = threadIdx.x;

  // both rows into shared memory, 16 bytes a copy
  const int64_t row = ((int64_t)n * H + h) * W * C;
  const uint4* gl = reinterpret_cast<const uint4*>(left + row);
  const uint4* gr = reinterpret_cast<const uint4*>(right + row);
  uint4* sl = rows;
  uint4* sr = rows + W * G;
  const int tid = threadIdx.y * G + g;
  const int nthreads = G * blockDim.y;
  for (int i = tid; i < W * G; i += nthreads) {
    sl[i] = gl[i];
    sr[i] = gr[i];
  }
  __syncthreads();

  const T* sright = reinterpret_cast<const T*>(sr);
  const float* srow = shifts + (int64_t)n * shift_n_stride;
  for (int d = d_begin; d < d_end; ++d) {
    const float s = srow[d];
    const float ksf = floorf(s);
    const float fs = __fsub_rn(s, ksf);
    const float gs = __fsub_rn(1.0f, fs);
    // a shift past the row puts both taps outside it; clamping it keeps the
    // float -> int conversion in range and changes no tap.  The contract
    // takes shifts >= 0, which the host checks; a negative one is not read
    // back here, so taps right of the row are zeroed too and nothing is
    // read out of bounds
    const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
    T* slab = out + (((int64_t)n * D + d) * H + h) * W * 2 * C + g * V;
    for (int x = threadIdx.y; x < W; x += blockDim.y) {
      const int x0 = x - ks - 1, x1 = x - ks;
      float a[V], b[V], o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) a[i] = b[i] = 0.0f;
      if ((unsigned)x0 < (unsigned)W) Vec<T>::load(sright + (x0 * G + g) * V, a);
      if ((unsigned)x1 < (unsigned)W) Vec<T>::load(sright + (x1 * G + g) * V, b);
#pragma unroll
      for (int i = 0; i < V; ++i)
        o[i] = __fadd_rn(__fmul_rn(a[i], fs), __fmul_rn(b[i], gs));
      T* dst = slab + (int64_t)x * 2 * C;
      __stcs(reinterpret_cast<uint4*>(dst), sl[x * G + g]);
      Vec<T>::store_cs(dst + C, o);
    }
  }
}

template <typename T>
cudaError_t launch_psv(const void* left, const void* right, const void* shifts,
                       void* out, int N, int D, int H, int W, int C,
                       int shift_n_stride, int block_y, int planes,
                       cudaStream_t stream) {
  if ((int64_t)N * D * H * W * C == 0) return cudaSuccess;
  const int G = C / Vec<T>::N;
  const int64_t smem = (int64_t)2 * W * G * 16;
  if (G * Vec<T>::N != C || planes < 1 || block_y < 1 ||
      (int64_t)G * block_y > 1024 || smem > kSmemLimit || N > 65535 ||
      (D + planes - 1) / planes > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = plane_sweep_volume_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, N, (D + planes - 1) / planes);
  kernel<<<grid, dim3(G, block_y), (size_t)smem, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right),
      static_cast<const float*>(shifts), static_cast<T*>(out), D, H, W, C,
      shift_n_stride, planes);
  return cudaGetLastError();
}

template <typename T>
__global__ void __launch_bounds__(1024) plane_sweep_volume_bwd_kernel(
    const T* __restrict__ grad, const float* __restrict__ shifts,
    T* __restrict__ dleft, T* __restrict__ dright, int D, int H, int W, int C,
    int shift_n_stride) {
  constexpr int V = Vec<T>::N;
  const int h = blockIdx.y, n = blockIdx.z;
  const int g = threadIdx.x;
  const int x = blockIdx.x * blockDim.y + threadIdx.y;
  if (x >= W) return;
  const int64_t row = (int64_t)W * 2 * C;  // one (plane, feature row)
  const int64_t plane = (int64_t)H * row;
  const T* gp = grad + ((int64_t)n * D * H + h) * row + g * V;
  const float* srow = shifts + (int64_t)n * shift_n_stride;
  float sl[V], sr[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sl[i] = sr[i] = 0.0f;
  for (int d = 0; d < D; ++d, gp += plane) {
    const float s = srow[d];
    const float ksf = floorf(s);
    const float fs = __fsub_rn(s, ksf);
    const float gs = __fsub_rn(1.0f, fs);
    // the forward's clamp: a shift past the row keeps every tap outside it
    const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
    const int x1 = x + ks, x0 = x + ks + 1;
    float l[V], b[V], a[V];
#pragma unroll
    for (int i = 0; i < V; ++i) b[i] = a[i] = 0.0f;
    Vec<T>::load(gp + (int64_t)x * 2 * C, l);
    if ((unsigned)x1 < (unsigned)W) Vec<T>::load(gp + (int64_t)x1 * 2 * C + C, b);
    if ((unsigned)x0 < (unsigned)W) Vec<T>::load(gp + (int64_t)x0 * 2 * C + C, a);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sl[i] = __fadd_rn(sl[i], l[i]);
      sr[i] = __fadd_rn(sr[i], __fadd_rn(__fmul_rn(b[i], gs), __fmul_rn(a[i], fs)));
    }
  }
  const int64_t o = (((int64_t)n * H + h) * W + x) * C + g * V;
  Vec<T>::store(dleft + o, sl);
  Vec<T>::store(dright + o, sr);
}

template <typename T>
cudaError_t launch_psv_bwd(const void* grad, const void* shifts, void* dleft,
                           void* dright, int N, int D, int H, int W, int C,
                           int shift_n_stride, int block_x,
                           cudaStream_t stream) {
  if ((int64_t)N * H * W * C == 0) return cudaSuccess;
  const int G = C / Vec<T>::N;
  if (G * Vec<T>::N != C || block_x < 1 || (int64_t)G * block_x > 1024 ||
      N > 65535 || H > 65535)
    return cudaErrorInvalidConfiguration;
  const dim3 grid((W + block_x - 1) / block_x, H, N);
  plane_sweep_volume_bwd_kernel<T><<<grid, dim3(G, block_x), 0, stream>>>(
      static_cast<const T*>(grad), static_cast<const float*>(shifts),
      static_cast<T*>(dleft), static_cast<T*>(dright), D, H, W, C,
      shift_n_stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  shift_n_stride: 0 for a shared [D]
// table, D for a per-sample [N, D] table.  block_y: threads per block along
// the row; planes: planes per block (k3_tiling).  Returns a cudaError_t
// (0 = ok).
int snvc_plane_sweep_volume(const void* left, const void* right,
                            const void* shifts, void* out, int N, int D,
                            int H, int W, int C, int shift_n_stride,
                            int block_y, int planes, int dtype,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_psv<__nv_bfloat16>(left, right, shifts, out, N, D, H,
                                          W, C, shift_n_stride, block_y,
                                          planes, s);
  if (dtype == 1)
    return (int)launch_psv<float>(left, right, shifts, out, N, D, H, W, C,
                                  shift_n_stride, block_y, planes, s);
  return (int)cudaErrorInvalidValue;
}

// Backward: grad [N, D, H, W, 2C] -> dleft, dright [N, H, W, C].  dtype and
// shift_n_stride as above; block_x: columns per block (k3_bwd_tiling).
// Returns a cudaError_t (0 = ok).
int snvc_plane_sweep_volume_bwd(const void* grad, const void* shifts,
                                void* dleft, void* dright, int N, int D,
                                int H, int W, int C, int shift_n_stride,
                                int block_x, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_psv_bwd<__nv_bfloat16>(grad, shifts, dleft, dright, N,
                                              D, H, W, C, shift_n_stride,
                                              block_x, s);
  if (dtype == 1)
    return (int)launch_psv_bwd<float>(grad, shifts, dleft, dright, N, D, H, W,
                                      C, shift_n_stride, block_x, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
