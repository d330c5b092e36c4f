// Kernel K4: frustum volume [N, D, Hf, Wf, C] -> rect-frame BEV voxels
// [N, nz, nx, ny, C] for a rectified projection (P[2,0] == P[2,1] == 0).
//
// For each output (n, z, x, y, c):
//   w = zs[z] + P[2,3]
//   u = (P00*xs[x] + P02*zs[z] + P03) / w / stride
//   v = (P11*ys[y] + P12*zs[z] + P13) / w / stride
//   planes d0[z], d0[z]+1 blended with fd[z] (static host tables: depth
//   clamps at the edge planes), then the hat taps floor(v), floor(v)+1 and
//   floor(u), floor(u)+1; taps outside the image are zero.
//
// Replaces the Pallas kernels snvc_tpu/ops/frustum_pallas.py (_kernel,
// pallas_call at :125, and _kernel_v2, :230, the same contract), which lerp
// the z row's two planes in VMEM and then run the u hats as a dense
// [nx, Wf] matmul and the v hats plus a mod-C channel select as a second
// matmul per y: matrix-unit shapes for a chip without a gather.  Here one
// thread owns 16 bytes of channels of one voxel and gathers its 8 taps
// (2 planes x 2 rows x 2 columns) directly, sums them in float32 in the plain
// version's order (depth lerp, then over v, then over u) and rounds once.
// One launch covers the batch.  u and v use the round-to-nearest intrinsics
// in the plain version's order of operations, so floor() falls on the same
// side as there.
//
// Bound: memory.  The output (110.6 MB at the serving shape) is written once
// by coalesced 16-byte stores from neighbouring threads (channel groups, then
// y); the tap loads are 16-byte gathers that hit L2 for the planes of nearby
// z rows (each plane is 1.9 MB at the serving shape).

#include "common.cuh"

namespace {

using snvc::Vec;

// (a + b) + c with a = p0 * q, b = p1 * zv, divided by w, then by stride:
// the plain version's (P_i0 * q + P_i2 * z + P_i3) / w / stride.
__device__ __forceinline__ float project(float pq, float q, float pz, float z,
                                         float p3, float w, float stride) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(pq, q), __fmul_rn(pz, z)), p3);
  return __fdiv_rn(__fdiv_rn(s, w), stride);
}

template <typename T>
__global__ void frustum_to_voxel_kernel(
    const T* __restrict__ vol, const float* __restrict__ P,
    const int* __restrict__ d0, const float* __restrict__ fd,
    const float* __restrict__ zs, const float* __restrict__ xs,
    const float* __restrict__ ys, T* __restrict__ out, int N, int D, int Hf,
    int Wf, int C, int nz, int nx, int ny, float stride) {
  constexpr int V = Vec<T>::N;
  const int G = C / V;
  const int64_t total = (int64_t)N * nz * nx * ny * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;  // masked tail
  const int g = (int)(idx % G);
  int64_t r = idx / G;
  const int y = (int)(r % ny);
  r /= ny;
  const int x = (int)(r % nx);
  r /= nx;
  const int z = (int)(r % nz);
  const int n = (int)(r / nz);

  const float* p = P + (int64_t)n * 12;  // row-major [3, 4]
  const float zz = zs[z];
  const float w = __fadd_rn(zz, p[11]);
  const float u = project(p[0], xs[x], p[2], zz, p[3], w, stride);
  const float v = project(p[5], ys[y], p[6], zz, p[7], w, stride);
  const float uf = floorf(u), vf = floorf(v);
  const float fu = __fsub_rn(u, uf), fv = __fsub_rn(v, vf);
  // far outside the image both taps stay outside; clamping keeps the
  // float -> int conversion in range
  const int u0 = (int)fminf(fmaxf(uf, -2.0f), (float)Wf + 1.0f);
  const int v0 = (int)fminf(fmaxf(vf, -2.0f), (float)Hf + 1.0f);
  const float wu[2] = {__fsub_rn(1.0f, fu), fu};
  const float wv[2] = {__fsub_rn(1.0f, fv), fv};

  const int dz = min(max(d0[z], 0), D - 2);
  const float f1 = fd[z];
  const float f0 = __fsub_rn(1.0f, f1);
  const int64_t plane = (int64_t)Hf * Wf * C;
  const T* p0 = vol + ((int64_t)n * D + dz) * plane + g * V;
  const T* p1 = p0 + plane;

  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int du = 0; du < 2; ++du) {
    const int uu = u0 + du;
    if (uu < 0 || uu >= Wf) continue;
    float t[V];
#pragma unroll
    for (int i = 0; i < V; ++i) t[i] = 0.0f;
#pragma unroll
    for (int dv = 0; dv < 2; ++dv) {
      const int vv = v0 + dv;
      if (vv < 0 || vv >= Hf) continue;
      const int64_t off = ((int64_t)vv * Wf + uu) * C;
      float a[V], b[V];
      Vec<T>::load(p0 + off, a);
      Vec<T>::load(p1 + off, b);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float lerp = __fadd_rn(__fmul_rn(a[i], f0), __fmul_rn(b[i], f1));
        t[i] = __fadd_rn(t[i], __fmul_rn(wv[dv], lerp));
      }
    }
#pragma unroll
    for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wu[du], t[i]));
  }
  Vec<T>::store(out + idx * V, acc);
}

template <typename T>
cudaError_t launch(const void* vol, const void* P, const void* d0,
                   const void* fd, const void* zs, const void* xs,
                   const void* ys, void* out, int N, int D, int Hf, int Wf,
                   int C, int nz, int nx, int ny, float stride,
                   cudaStream_t stream) {
  const int64_t total = (int64_t)N * nz * nx * ny * (C / Vec<T>::N);
  if (total == 0) return cudaSuccess;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647LL) return cudaErrorInvalidConfiguration;
  frustum_to_voxel_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(vol), static_cast<const float*>(P),
      static_cast<const int*>(d0), static_cast<const float*>(fd),
      static_cast<const float*>(zs), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<T*>(out), N, D, Hf, Wf, C,
      nz, nx, ny, stride);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  Returns a cudaError_t (0 = success).
int snvc_frustum_to_voxel(const void* vol, const void* P, const void* d0,
                          const void* fd, const void* zs, const void* xs,
                          const void* ys, void* out, int N, int D, int Hf,
                          int Wf, int C, int nz, int nx, int ny, float stride,
                          int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<__nv_bfloat16>(vol, P, d0, fd, zs, xs, ys, out, N, D,
                                      Hf, Wf, C, nz, nx, ny, stride, s);
  if (dtype == 1)
    return (int)launch<float>(vol, P, d0, fd, zs, xs, ys, out, N, D, Hf, Wf,
                              C, nz, nx, ny, stride, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
