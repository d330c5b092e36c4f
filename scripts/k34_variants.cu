// Alternatives to the K3 and K4 kernels, timed against the shipped ones by
// scripts/k34_variants.py to find what bounds each; not part of the package.
// Compiled with -I snvc_tpu_torch/csrc: it includes the shipped sources (the
// shipped kernels at other tilings go through their own entry points), bf16
// only.

#include "frustum_to_voxel.cu"
#include "hopper.cuh"
#include "plane_sweep_volume.cu"

namespace {

using bf16 = __nv_bfloat16;

// ------------------------------------------------------------------ K3 ----
// The previous kernel: one thread per 16-byte group of the flat output,
// placed by 64-bit division.
__global__ void k3_flat_kernel(const bf16* __restrict__ left,
                               const bf16* __restrict__ right,
                               const float* __restrict__ shifts,
                               bf16* __restrict__ out, int N, int D, int H,
                               int W, int C) {
  const int G = C / 8;
  const int64_t total = (int64_t)N * D * H * W * 2 * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g2 = (int)(idx % (2 * G));
  int64_t r = idx / (2 * G);
  const int x = (int)(r % W);
  r /= W;
  const int h = (int)(r % H);
  r /= H;
  const int d = (int)(r % D);
  const int n = (int)(r / D);
  bf16* dst = out + idx * 8;
  const int64_t row = ((int64_t)n * H + h) * W;
  if (g2 < G) {
    *reinterpret_cast<uint4*>(dst) =
        *reinterpret_cast<const uint4*>(left + (row + x) * C + g2 * 8);
    return;
  }
  const int g = g2 - G;
  const float s = shifts[d];
  const float ksf = floorf(s);
  const float fs = __fsub_rn(s, ksf);
  const float gs = __fsub_rn(1.0f, fs);
  const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
  const int x0 = x - ks - 1, x1 = x - ks;
  float a[8], b[8], o[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.0f;
  const bf16* base = right + row * C + g * 8;
  if (x0 >= 0 && x0 < W) Vec<bf16>::load(base + (int64_t)x0 * C, a);
  if (x1 >= 0 && x1 < W) Vec<bf16>::load(base + (int64_t)x1 * C, b);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __fadd_rn(__fmul_rn(a[i], fs), __fmul_rn(b[i], gs));
  Vec<bf16>::store(dst, o);
}

// The shipped block layout without the staging: taps and left groups read
// from global memory (L1/L2); kStream picks the store hint.  kWriteOnly
// stores zeros and reads nothing (the layout's store stream alone).
template <bool kStream, bool kWriteOnly>
__global__ void k3_direct_kernel(const bf16* __restrict__ left,
                                 const bf16* __restrict__ right,
                                 const float* __restrict__ shifts,
                                 bf16* __restrict__ out, int D, int H, int W,
                                 int C, int planes) {
  const int h = blockIdx.x, n = blockIdx.y;
  const int d_begin = blockIdx.z * planes;
  const int d_end = min(D, d_begin + planes);
  const int G = blockDim.x, g = threadIdx.x;
  const int64_t row = ((int64_t)n * H + h) * W * C;
  const uint4* gl = reinterpret_cast<const uint4*>(left + row);
  const bf16* gr = right + row;
  for (int d = d_begin; d < d_end; ++d) {
    const float s = shifts[d];
    const float ksf = floorf(s);
    const float fs = __fsub_rn(s, ksf);
    const float gs = __fsub_rn(1.0f, fs);
    const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
    bf16* slab = out + (((int64_t)n * D + d) * H + h) * W * 2 * C + g * 8;
    for (int x = threadIdx.y; x < W; x += blockDim.y) {
      bf16* dst = slab + (int64_t)x * 2 * C;
      if (kWriteOnly) {
        __stcs(reinterpret_cast<uint4*>(dst), make_uint4(0, 0, 0, 0));
        __stcs(reinterpret_cast<uint4*>(dst + C), make_uint4(0, 0, 0, 0));
        continue;
      }
      const int x0 = x - ks - 1, x1 = x - ks;
      float a[8], b[8], o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.0f;
      if ((unsigned)x0 < (unsigned)W) Vec<bf16>::load(gr + (x0 * G + g) * 8, a);
      if ((unsigned)x1 < (unsigned)W) Vec<bf16>::load(gr + (x1 * G + g) * 8, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __fadd_rn(__fmul_rn(a[i], fs), __fmul_rn(b[i], gs));
      if (kStream) {
        __stcs(reinterpret_cast<uint4*>(dst), gl[x * G + g]);
        Vec<bf16>::store_cs(dst + C, o);
      } else {
        *reinterpret_cast<uint4*>(dst) = gl[x * G + g];
        Vec<bf16>::store(dst + C, o);
      }
    }
  }
}

__device__ __forceinline__ void bulk_store(void* dst, const void* src,
                                           uint32_t bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
      "r"(hopper::smem_addr(src)), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// The staged rows with a TMA bulk store of each plane's [W, 2C] slab from a
// double-buffered slab in shared memory, whose left halves are written once.
__global__ void k3_tma_kernel(const bf16* __restrict__ left,
                              const bf16* __restrict__ right,
                              const float* __restrict__ shifts,
                              bf16* __restrict__ out, int D, int H, int W,
                              int C, int planes) {
  extern __shared__ uint4 tma_shared[];
  const int h = blockIdx.x, n = blockIdx.y;
  const int d_begin = blockIdx.z * planes;
  const int d_end = min(D, d_begin + planes);
  const int G = blockDim.x, g = threadIdx.x;
  const int tid = threadIdx.y * G + g;
  uint4* sr = tma_shared;
  uint4* slab0 = tma_shared + W * G;  // two [W, 2G] slabs follow the right row
  const int64_t row = ((int64_t)n * H + h) * W * C;
  const uint4* gl = reinterpret_cast<const uint4*>(left + row);
  const uint4* gr = reinterpret_cast<const uint4*>(right + row);
  for (int x = threadIdx.y; x < W; x += blockDim.y) {
    const uint4 lv = gl[x * G + g];
    slab0[x * 2 * G + g] = lv;
    slab0[(W + x) * 2 * G + g] = lv;
    sr[x * G + g] = gr[x * G + g];
  }
  __syncthreads();
  const bf16* sright = reinterpret_cast<const bf16*>(sr);
  const uint32_t bytes = (uint32_t)W * 2 * C * 2;
  for (int d = d_begin; d < d_end; ++d) {
    const int k = d - d_begin;
    uint4* sb = slab0 + (k & 1) * W * 2 * G;
    if (tid == 0 && k >= 2) bulk_wait_read<1>();
    __syncthreads();
    const float s = shifts[d];
    const float ksf = floorf(s);
    const float fs = __fsub_rn(s, ksf);
    const float gs = __fsub_rn(1.0f, fs);
    const int ks = (int)fmaxf(fminf(ksf, (float)(W + 1)), (float)(-W - 1));
    for (int x = threadIdx.y; x < W; x += blockDim.y) {
      const int x0 = x - ks - 1, x1 = x - ks;
      float a[8], b[8], o[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = b[i] = 0.0f;
      if ((unsigned)x0 < (unsigned)W) Vec<bf16>::load(sright + (x0 * G + g) * 8, a);
      if ((unsigned)x1 < (unsigned)W) Vec<bf16>::load(sright + (x1 * G + g) * 8, b);
#pragma unroll
      for (int i = 0; i < 8; ++i)
        o[i] = __fadd_rn(__fmul_rn(a[i], fs), __fmul_rn(b[i], gs));
      Vec<bf16>::store(reinterpret_cast<bf16*>(sb + x * 2 * G + G + g), o);
    }
    hopper::fence_proxy_async();
    __syncthreads();
    if (tid == 0)
      bulk_store(out + (((int64_t)n * D + d) * H + h) * W * 2 * C, sb, bytes);
  }
  if (tid == 0) bulk_wait_read<0>();
}

// ------------------------------------------------------------------ K4 ----
// The previous kernel: one thread per 16-byte group of the flat output,
// placed by 64-bit division, u and v projected per thread, 8 direct taps.
__global__ void k4_flat_kernel(const bf16* __restrict__ vol,
                               const float* __restrict__ P,
                               const int* __restrict__ d0,
                               const float* __restrict__ fd,
                               const float* __restrict__ zs,
                               const float* __restrict__ xs,
                               const float* __restrict__ ys,
                               bf16* __restrict__ out, int N, int D, int Hf,
                               int Wf, int C, int nz, int nx, int ny,
                               float stride) {
  const int G = C / 8;
  const int64_t total = (int64_t)N * nz * nx * ny * G;
  const int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int g = (int)(idx % G);
  int64_t r = idx / G;
  const int y = (int)(r % ny);
  r /= ny;
  const int x = (int)(r % nx);
  r /= nx;
  const int z = (int)(r % nz);
  const int n = (int)(r / nz);
  const float* p = P + (int64_t)n * 12;
  const float zz = zs[z];
  const float w = __fadd_rn(zz, p[11]);
  const Hat hu = hat(project(p[0], xs[x], p[2], zz, p[3], w, stride), Wf);
  const Hat hv = hat(project(p[5], ys[y], p[6], zz, p[7], w, stride), Hf);
  const int dz = min(max(d0[z], 0), D - 2);
  const float f1 = fd[z];
  const float f0 = __fsub_rn(1.0f, f1);
  const int64_t plane = (int64_t)Hf * Wf * C;
  const bf16* p0 = vol + ((int64_t)n * D + dz) * plane + g * 8;
  const bf16* p1 = p0 + plane;
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int du = 0; du < 2; ++du) {
    const int uu = hu.i0 + du;
    if (uu < 0 || uu >= Wf) continue;
    float t[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) t[i] = 0.0f;
#pragma unroll
    for (int dv = 0; dv < 2; ++dv) {
      const int vv = hv.i0 + dv;
      if (vv < 0 || vv >= Hf) continue;
      const int64_t off = ((int64_t)vv * Wf + uu) * C;
      const float wv = dv ? hv.w1 : hv.w0;
      float a[8], b[8];
      Vec<bf16>::load(p0 + off, a);
      Vec<bf16>::load(p1 + off, b);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float lerp = __fadd_rn(__fmul_rn(a[i], f0), __fmul_rn(b[i], f1));
        t[i] = __fadd_rn(t[i], __fmul_rn(wv, lerp));
      }
    }
    const float wu = du ? hu.w1 : hu.w0;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wu, t[i]));
  }
  Vec<bf16>::store(out + idx * 8, acc);
}

// The shipped kernel with every tap load of a column (and, on the direct
// path, of both columns of an output) issued before any sum, and two
// columns a stage-1 step.
struct ColumnTaps {
  uint4 raw[2][2];  // [dv][plane]
  bool ok[2];       // [dv]
};

__device__ __forceinline__ ColumnTaps load_column(const bf16* p0,
                                                  const bf16* p1, int col,
                                                  int Wf, int C, const Hat& hv,
                                                  int Hf) {
  ColumnTaps c;
  const bool col_ok = (unsigned)col < (unsigned)Wf;
#pragma unroll
  for (int dv = 0; dv < 2; ++dv) {
    const int vv = hv.i0 + dv;
    c.ok[dv] = col_ok && (unsigned)vv < (unsigned)Hf;
    const int64_t off = c.ok[dv] ? ((int64_t)vv * Wf + col) * C : 0;
    const uint4 zero = make_uint4(0, 0, 0, 0);
    c.raw[dv][0] = c.ok[dv] ? *reinterpret_cast<const uint4*>(p0 + off) : zero;
    c.raw[dv][1] = c.ok[dv] ? *reinterpret_cast<const uint4*>(p1 + off) : zero;
  }
  return c;
}

__device__ __forceinline__ void taps_sum(const ColumnTaps& c, const Hat& hv,
                                         float f0, float f1, float* t) {
#pragma unroll
  for (int i = 0; i < 8; ++i) t[i] = 0.0f;
#pragma unroll
  for (int dv = 0; dv < 2; ++dv) {
    if (!c.ok[dv]) continue;
    const float wv = dv ? hv.w1 : hv.w0;
    float a[8], b[8];
    Vec<bf16>::load(reinterpret_cast<const bf16*>(&c.raw[dv][0]), a);
    Vec<bf16>::load(reinterpret_cast<const bf16*>(&c.raw[dv][1]), b);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float lerp = __fadd_rn(__fmul_rn(a[i], f0), __fmul_rn(b[i], f1));
      t[i] = __fadd_rn(t[i], __fmul_rn(wv, lerp));
    }
  }
}

__device__ __forceinline__ void stage_sum(float* st, int c, int ny, int y,
                                          int C, int g, const float* t) {
  float4* s4 = reinterpret_cast<float4*>(st + ((c * ny + y) * C + g * 8));
  s4[0] = make_float4(t[0], t[1], t[2], t[3]);
  s4[1] = make_float4(t[4], t[5], t[6], t[7]);
}

__global__ void __launch_bounds__(1024) k4_loads_first_kernel(
    const bf16* __restrict__ vol, const float* __restrict__ P,
    const int* __restrict__ d0, const float* __restrict__ fd,
    const float* __restrict__ zs, const float* __restrict__ xs,
    const float* __restrict__ ys, bf16* __restrict__ out, int D, int Hf,
    int Wf, int C, int nz, int nx, int ny, float stride, int tile_x,
    int ncol) {
  extern __shared__ float4 lf_smem[];
  Hat* hu = reinterpret_cast<Hat*>(lf_smem);
  Hat* hv = hu + tile_x;
  int* window = reinterpret_cast<int*>(hv + ny);
  float* st = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(lf_smem) + table_bytes(tile_x, ny));
  const int g = threadIdx.x, y = threadIdx.y, lane = threadIdx.z;
  const int G = blockDim.x, lanes = blockDim.z;
  const int tid = (lane * ny + y) * G + g;
  const int nthreads = G * ny * lanes;
  const int n = blockIdx.z, z = blockIdx.y;
  const int x_begin = blockIdx.x * tile_x;
  const int ntx = min(tile_x, nx - x_begin);
  const float* p = P + (int64_t)n * 12;
  const float zz = zs[z];
  const float w = __fadd_rn(zz, p[11]);
  if (tid == 0) {
    window[0] = INT_MAX;
    window[1] = INT_MIN;
  }
  __syncthreads();
  for (int i = tid; i < ntx; i += nthreads) {
    const Hat h = hat(project(p[0], xs[x_begin + i], p[2], zz, p[3], w,
                              stride), Wf);
    hu[i] = h;
    atomicMin(&window[0], h.i0);
    atomicMax(&window[1], h.i0 + 1);
  }
  for (int i = tid; i < ny; i += nthreads)
    hv[i] = hat(project(p[5], ys[i], p[6], zz, p[7], w, stride), Hf);
  __syncthreads();
  const Hat my_v = hv[y];
  const int dz = min(max(d0[z], 0), D - 2);
  const float f1 = fd[z];
  const float f0 = __fsub_rn(1.0f, f1);
  const int64_t plane = (int64_t)Hf * Wf * C;
  const bf16* p0 = vol + ((int64_t)n * D + dz) * plane + g * 8;
  const bf16* p1 = p0 + plane;
  const int lo = max(window[0], 0), hi = min(window[1], Wf - 1);
  const int ncols = hi - lo + 1;
  bf16* dst = out + ((((int64_t)n * nz + z) * nx + x_begin) * ny + y) * C + g * 8;
  const int64_t x_step = (int64_t)ny * C;
  if (ncols <= ncol) {
    for (int c = lane; c < ncols; c += 2 * lanes) {
      const int c2 = c + lanes;
      const ColumnTaps ta = load_column(p0, p1, lo + c, Wf, C, my_v, Hf);
      const ColumnTaps tb =
          load_column(p0, p1, c2 < ncols ? lo + c2 : -1, Wf, C, my_v, Hf);
      float t[8];
      taps_sum(ta, my_v, f0, f1, t);
      stage_sum(st, c, ny, y, C, g, t);
      if (c2 < ncols) {
        taps_sum(tb, my_v, f0, f1, t);
        stage_sum(st, c2, ny, y, C, g, t);
      }
    }
    __syncthreads();
    for (int xi = lane; xi < ntx; xi += lanes) {
      const Hat h = hu[xi];
      float acc[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int du = 0; du < 2; ++du) {
        const int uu = h.i0 + du;
        if ((unsigned)uu >= (unsigned)Wf) continue;
        const float wu = du ? h.w1 : h.w0;
        const float4* s4 = reinterpret_cast<const float4*>(
            st + (((uu - lo) * ny + y) * C + g * 8));
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float4 q = s4[i];
          acc[4 * i] = __fadd_rn(acc[4 * i], __fmul_rn(wu, q.x));
          acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], __fmul_rn(wu, q.y));
          acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], __fmul_rn(wu, q.z));
          acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], __fmul_rn(wu, q.w));
        }
      }
      Vec<bf16>::store_cs(dst + xi * x_step, acc);
    }
  } else {
    for (int xi = lane; xi < ntx; xi += lanes) {
      const Hat h = hu[xi];
      const ColumnTaps ta = load_column(p0, p1, h.i0, Wf, C, my_v, Hf);
      const ColumnTaps tb = load_column(p0, p1, h.i0 + 1, Wf, C, my_v, Hf);
      float acc[8], t[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
      if ((unsigned)h.i0 < (unsigned)Wf) {
        taps_sum(ta, my_v, f0, f1, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(h.w0, t[i]));
      }
      if ((unsigned)(h.i0 + 1) < (unsigned)Wf) {
        taps_sum(tb, my_v, f0, f1, t);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(h.w1, t[i]));
      }
      Vec<bf16>::store_cs(dst + xi * x_step, acc);
    }
  }
}

// ---------------------------------------------------------------- stores ----
// `bytes` of zeros, 16 bytes a thread, grid-stride, with or without the
// streaming hint: the store stream alone.
template <bool kStream>
__global__ void fill_kernel(uint4* __restrict__ out, int64_t n16) {
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < n16;
       i += step) {
    if (kStream)
      __stcs(out + i, make_uint4(0, 0, 0, 0));
    else
      out[i] = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace

extern "C" {

// K3 variants, bf16, a shared [D] table: 0 flat (the previous kernel),
// 1 direct (the block layout without staging, streaming stores), 2 direct
// with plain stores, 3 the layout's store stream alone, 4 staged rows and a
// TMA bulk store per slab.
int k34v_k3(int variant, const void* left, const void* right,
            const void* shifts, void* out, int N, int D, int H, int W, int C,
            int block_y, int planes, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* l = static_cast<const bf16*>(left);
  const bf16* r = static_cast<const bf16*>(right);
  const float* sh = static_cast<const float*>(shifts);
  bf16* o = static_cast<bf16*>(out);
  const int G = C / 8;
  const dim3 grid(H, N, (D + planes - 1) / planes), block(G, block_y);
  switch (variant) {
    case 0: {
      const int64_t total = (int64_t)N * D * H * W * 2 * G;
      k3_flat_kernel<<<(unsigned)((total + 255) / 256), 256, 0, s>>>(
          l, r, sh, o, N, D, H, W, C);
      break;
    }
    case 1:
      k3_direct_kernel<true, false><<<grid, block, 0, s>>>(l, r, sh, o, D, H, W, C, planes);
      break;
    case 2:
      k3_direct_kernel<false, false><<<grid, block, 0, s>>>(l, r, sh, o, D, H, W, C, planes);
      break;
    case 3:
      k3_direct_kernel<true, true><<<grid, block, 0, s>>>(l, r, sh, o, D, H, W, C, planes);
      break;
    case 4: {
      const int smem = 5 * W * G * 16;
      cudaError_t err = cudaFuncSetAttribute(
          k3_tma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
      k3_tma_kernel<<<grid, block, smem, s>>>(l, r, sh, o, D, H, W, C, planes);
      break;
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K4's previous kernel, bf16.
int k34v_k4_flat(const void* vol, const void* P, const void* d0,
                 const void* fd, const void* zs, const void* xs,
                 const void* ys, void* out, int N, int D, int Hf, int Wf,
                 int C, int nz, int nx, int ny, float stride, void* stream) {
  const int64_t total = (int64_t)N * nz * nx * ny * (C / 8);
  k4_flat_kernel<<<(unsigned)((total + 255) / 256), 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(vol), static_cast<const float*>(P),
      static_cast<const int*>(d0), static_cast<const float*>(fd),
      static_cast<const float*>(zs), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<bf16*>(out), N, D, Hf, Wf, C,
      nz, nx, ny, stride);
  return (int)cudaGetLastError();
}

// K4 with its loads issued first (k4_loads_first_kernel), bf16, at a tiling.
int k34v_k4_loads_first(const void* vol, const void* P, const void* d0,
                        const void* fd, const void* zs, const void* xs,
                        const void* ys, void* out, int N, int D, int Hf,
                        int Wf, int C, int nz, int nx, int ny, float stride,
                        int tile_x, int lanes, int ncol, void* stream) {
  const int smem = table_bytes(tile_x, ny) + ncol * ny * C * 4;
  cudaError_t err = cudaFuncSetAttribute(
      k4_loads_first_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((nx + tile_x - 1) / tile_x, nz, N);
  k4_loads_first_kernel<<<grid, dim3(C / 8, ny, lanes), smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(vol), static_cast<const float*>(P),
      static_cast<const int*>(d0), static_cast<const float*>(fd),
      static_cast<const float*>(zs), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<bf16*>(out), D, Hf, Wf, C,
      nz, nx, ny, stride, tile_x, ncol);
  return (int)cudaGetLastError();
}

// `bytes` (a multiple of 16) of zeros; stream_hint 1 = st.global.cs.
int k34v_fill(void* out, long long bytes, int stream_hint, int blocks,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint4* o = static_cast<uint4*>(out);
  if (stream_hint)
    fill_kernel<true><<<blocks, 256, 0, s>>>(o, bytes / 16);
  else
    fill_kernel<false><<<blocks, 256, 0, s>>>(o, bytes / 16);
  return (int)cudaGetLastError();
}

}  // extern "C"
