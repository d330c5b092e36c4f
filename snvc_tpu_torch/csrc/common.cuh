// Helpers shared by the port's CUDA sources.  Each source builds into its own
// shared library (snvc_tpu_torch/_build.py), so it includes this header once
// and each library exports its own snvc_error_string.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace snvc {

// a block's dynamic shared memory on sm_90 (227 KB)
constexpr int kSmemLimit = 232448;

// 16 bytes of channels, loaded to and stored from float32.
template <typename T>
struct Vec;

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
  // store with the streaming hint (st.global.cs), for an output larger
  // than L2 that the kernel does not read back
  __device__ static void store_cs(__nv_bfloat16* p, const float* v) {
    uint4 raw;
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    __stcs(reinterpret_cast<uint4*>(p), raw);
  }
};

template <>
struct Vec<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* v) {
    float4 f = *reinterpret_cast<const float4*>(p);
    v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
  }
  __device__ static void store(float* p, const float* v) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
  __device__ static void store_cs(float* p, const float* v) {
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  }
};

}  // namespace snvc

// The message of an error code returned by a library's entry point.
extern "C" const char* snvc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
