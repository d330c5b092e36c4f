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
// matmul per y: matrix-unit shapes for a chip without a gather.
//
// Bound: bytes, the output (110.6 MB at the serving shape) and the depth
// planes the z rows use, each read once.  u depends on (z, x) only and v on
// (z, y) only, and in far rows neighbouring x and y fall on the same
// columns and rows, so a direct 8-tap gather per output fetches each tap
// several times (648 MB of 64-byte gathers at the serving shape).  A block
// owns one BEV row (n, z) -- blockIdx.z, blockIdx.y -- and a tile of
// tile_x x cells (blockIdx.x).  It is G x ny x L threads: threadIdx.x is
// the 16-byte channel group, threadIdx.y the BEV y, threadIdx.z one of L
// lanes that walk the tile's x cells L apart; no thread divides to find its
// work.  The block projects u for its x cells and v for the ny cells once,
// into shared memory, with the plain version's round-to-nearest order, so
// floor() falls on the same side.  Then, in the plain version's separable
// order (depth lerp, the hat over v, then the hat over u, in float32):
//
//   stage 1: t[col][y] = sum over dv of wv * lerp(planes)[v0 + dv][col],
//            for every image column in the tile's window [lo, hi], into
//            shared memory;
//   stage 2: out[x][y] = sum over du of wu * t[u0(x) + du][y].
//
// Each tap is fetched once per (column, y) and shared by every x of the
// tile that reads the column.  In near rows a cell spans many columns
// (16.8 px at 2.1 m) and no x shares one: when the window is wider than the
// `ncol` columns that shared memory holds, the block gathers each output's
// taps directly instead, in the same order.  Both paths add a tap outside
// the image as nothing (the old kernel skipped it: adding +0 to a sum that
// is never -0 gives the same bits) and round once.  An output tile is a
// contiguous [tile_x, ny, C] slab, written by neighbouring threads with the
// streaming store hint.  ops/frustum.py: k4_tiling picks tile_x, L and
// ncol.
//
// The backward with respect to the volume (snvc_frustum_to_voxel_bwd)
// replaces the XLA VJP of JAX's gather form (frustum_pallas.py:271-289,
// whose gradient for P no path uses).  It is the transpose:
//
//   dvol[n,d,h,w] = sum over rows z with d0[z] = d of (1-fd[z]) T[z,h,w]
//                 + sum over rows z with d0[z] + 1 = d of fd[z] T[z,h,w],
//   T[z,h,w] = sum over x whose u hat reaches w of wu(x) *
//              sum over y whose v hat reaches h of wv(y) * g[n,z,x,y].
//
// Bound: bytes, the gradient read once and the volume's gradient written
// once (110.6 + 122.7 MB at the training shape).  A scatter from each g
// element into its 8 taps would collide on the planes the z rows share;
// this kernel gathers instead, deterministically: a block owns BW image
// columns of one (n, d, h) row of the output (blockIdx.x the column tile,
// y the row h, z = n * D + d: one division per block) and is
// ceil(C / 16) x BW threads, a thread 16 channels (threadIdx.x) of one
// column w (threadIdx.y), so its sums stay in registers.  The wrapper
// projects u [N, nz, nx] and v [N, nz, ny] once, on the device, in the
// plain version's round-to-nearest order (the forward kernel's own), so
// the kernel takes no correctly rounded division: its slow path is a
// subroutine call, and ptxas spilled live registers around it.  First the
// block fills tables per BEV row z in shared memory: the row's weight on
// plane d (0 unless d0[z] or d0[z] + 1 is d: the tables are static, so
// which rows reach a plane is known there), the v hat's weight of each y
// at row h and the first and last y it reaches, and u's origin and
// inverse slope along x.  Then each thread walks the rows that reach (d, h): u is
// affine in x for a fixed z, so inverting it gives the x cells whose hat
// can reach w; the range is widened by one cell on each side and each
// candidate's hat is taken from its projected u exactly as the forward
// takes it, so boundary taps are the forward's own.  Each tap adds
// (wz * wu * wv) * g to a float32 sum (the plain version sums over x, then
// y, then z: the same terms, another rounding order); each output is
// written once, rounded once.  Neighbouring columns read
// neighbouring or the same g cells, which L1 and L2 serve.

#include <climits>

#include "common.cuh"

namespace {

using snvc::kSmemLimit;
using snvc::Vec;

// (a + b) + c with a = p0 * q, b = p1 * zv, divided by w, then by stride:
// the plain version's (P_i0 * q + P_i2 * z + P_i3) / w / stride.
__device__ __forceinline__ float project(float pq, float q, float pz, float z,
                                         float p3, float w, float stride) {
  const float s = __fadd_rn(__fadd_rn(__fmul_rn(pq, q), __fmul_rn(pz, z)), p3);
  return __fdiv_rn(__fdiv_rn(s, w), stride);
}

// A hat's lower tap, clamped so far outside the image both taps stay
// outside and the float -> int conversion stays in range, and its weights.
struct Hat {
  int i0;
  float w0, w1;
};

__device__ __forceinline__ Hat hat(float p, int size) {
  const float pf = floorf(p);
  const float f = __fsub_rn(p, pf);
  return {(int)fminf(fmaxf(pf, -2.0f), (float)size + 1.0f),
          __fsub_rn(1.0f, f), f};
}

// Shared-memory bytes of the tables that precede the stage-1 sums.
__host__ __device__ constexpr int table_bytes(int tile_x, int ny) {
  return ((tile_x + ny) * (int)sizeof(Hat) + 2 * (int)sizeof(int) + 15) / 16 *
         16;
}

// Stage 1 for one image column of one (y, channel group): the depth lerp of
// rows v0 and v0 + 1, weighted by the v hat and summed in float32 in the
// plain version's order; a row outside the image adds nothing.  (Issuing
// all of an output's loads before its sums measured no faster, and slower
// on the direct path: scripts/k34_variants.py.)
template <typename T>
__device__ __forceinline__ void column_sum(const T* p0, const T* p1, int col,
                                           int Wf, int C, const Hat& hv,
                                           int Hf, float f0, float f1,
                                           float* t) {
  constexpr int V = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < V; ++i) t[i] = 0.0f;
#pragma unroll
  for (int dv = 0; dv < 2; ++dv) {
    const int vv = hv.i0 + dv;
    if ((unsigned)vv >= (unsigned)Hf) continue;
    const int64_t off = ((int64_t)vv * Wf + col) * C;
    const float wv = dv ? hv.w1 : hv.w0;
    float a[V], b[V];
    Vec<T>::load(p0 + off, a);
    Vec<T>::load(p1 + off, b);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float lerp = __fadd_rn(__fmul_rn(a[i], f0), __fmul_rn(b[i], f1));
      t[i] = __fadd_rn(t[i], __fmul_rn(wv, lerp));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(1024) frustum_to_voxel_kernel(
    const T* __restrict__ vol, const float* __restrict__ P,
    const int* __restrict__ d0, const float* __restrict__ fd,
    const float* __restrict__ zs, const float* __restrict__ xs,
    const float* __restrict__ ys, T* __restrict__ out, int D, int Hf, int Wf,
    int C, int nz, int nx, int ny, float stride, int tile_x, int ncol) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 block_smem[];
  Hat* hu = reinterpret_cast<Hat*>(block_smem);  // [tile_x]
  Hat* hv = hu + tile_x;                          // [ny]
  int* window = reinterpret_cast<int*>(hv + ny);  // lowest, highest column
  float* st = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(block_smem) + table_bytes(tile_x, ny));

  const int g = threadIdx.x, y = threadIdx.y, lane = threadIdx.z;
  const int G = blockDim.x, lanes = blockDim.z;
  const int tid = (lane * ny + y) * G + g;
  const int nthreads = G * ny * lanes;
  const int n = blockIdx.z, z = blockIdx.y;
  const int x_begin = blockIdx.x * tile_x;
  const int ntx = min(tile_x, nx - x_begin);

  // project once: u of the tile's x cells, v of the ny cells
  const float* p = P + (int64_t)n * 12;  // row-major [3, 4]
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
  const T* p0 = vol + ((int64_t)n * D + dz) * plane + g * V;
  const T* p1 = p0 + plane;
  const int lo = max(window[0], 0), hi = min(window[1], Wf - 1);
  const int ncols = hi - lo + 1;  // <= 0: no column of the tile is inside
  T* dst = out + ((((int64_t)n * nz + z) * nx + x_begin) * ny + y) * C + g * V;
  const int64_t x_step = (int64_t)ny * C;

  if (ncols <= ncol) {
    // stage 1: each window column once per (y, group)
    for (int c = lane; c < ncols; c += lanes) {
      float t[V];
      column_sum<T>(p0, p1, lo + c, Wf, C, my_v, Hf, f0, f1, t);
      float4* s4 = reinterpret_cast<float4*>(st + ((c * ny + y) * C + g * V));
#pragma unroll
      for (int i = 0; i < V / 4; ++i)
        s4[i] = make_float4(t[4 * i], t[4 * i + 1], t[4 * i + 2], t[4 * i + 3]);
    }
    __syncthreads();
    // stage 2: the u hat over the staged columns
    for (int xi = lane; xi < ntx; xi += lanes) {
      const Hat h = hu[xi];
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int du = 0; du < 2; ++du) {
        const int uu = h.i0 + du;
        if ((unsigned)uu >= (unsigned)Wf) continue;
        const float wu = du ? h.w1 : h.w0;
        const float4* s4 = reinterpret_cast<const float4*>(
            st + (((uu - lo) * ny + y) * C + g * V));
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          const float4 q = s4[i];
          acc[4 * i] = __fadd_rn(acc[4 * i], __fmul_rn(wu, q.x));
          acc[4 * i + 1] = __fadd_rn(acc[4 * i + 1], __fmul_rn(wu, q.y));
          acc[4 * i + 2] = __fadd_rn(acc[4 * i + 2], __fmul_rn(wu, q.z));
          acc[4 * i + 3] = __fadd_rn(acc[4 * i + 3], __fmul_rn(wu, q.w));
        }
      }
      Vec<T>::store_cs(dst + xi * x_step, acc);
    }
  } else {
    // a wide window (near rows): each output gathers its own taps
    for (int xi = lane; xi < ntx; xi += lanes) {
      const Hat h = hu[xi];
      float acc[V];
#pragma unroll
      for (int i = 0; i < V; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int du = 0; du < 2; ++du) {
        const int uu = h.i0 + du;
        if ((unsigned)uu >= (unsigned)Wf) continue;
        const float wu = du ? h.w1 : h.w0;
        float t[V];
        column_sum<T>(p0, p1, uu, Wf, C, my_v, Hf, f0, f1, t);
#pragma unroll
        for (int i = 0; i < V; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(wu, t[i]));
      }
      Vec<T>::store_cs(dst + xi * x_step, acc);
    }
  }
}

template <typename T>
cudaError_t launch_f2v(const void* vol, const void* P, const void* d0,
                       const void* fd, const void* zs, const void* xs,
                       const void* ys, void* out, int N, int D, int Hf, int Wf,
                       int C, int nz, int nx, int ny, float stride, int tile_x,
                       int lanes, int ncol, cudaStream_t stream) {
  if ((int64_t)N * nz * nx * ny * C == 0) return cudaSuccess;
  const int G = C / Vec<T>::N;
  const int64_t smem =
      table_bytes(tile_x, ny) + (int64_t)ncol * ny * C * sizeof(float);
  if (G * Vec<T>::N != C || tile_x < 1 || lanes < 1 || ncol < 0 ||
      (int64_t)G * ny * lanes > 1024 || smem > kSmemLimit || N > 65535 ||
      nz > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = frustum_to_voxel_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nx + tile_x - 1) / tile_x, nz, N);
  kernel<<<grid, dim3(G, ny, lanes), (size_t)smem, stream>>>(
      static_cast<const T*>(vol), static_cast<const float*>(P),
      static_cast<const int*>(d0), static_cast<const float*>(fd),
      static_cast<const float*>(zs), static_cast<const float*>(xs),
      static_cast<const float*>(ys), static_cast<T*>(out), D, Hf, Wf, C, nz,
      nx, ny, stride, tile_x, ncol);
  return cudaGetLastError();
}

// Shared-memory bytes of the backward's per-row tables (k4_bwd_smem).
__host__ __device__ constexpr int bwd_table_bytes(int nz, int ny) {
  return (nz * (5 + ny) * 4 + 15) / 16 * 16;
}

constexpr int kBwdFloats = 16;    // channels a thread sums
constexpr int kBwdThreads = 128;  // threads of a block, at most

// (kBwdThreads, 1): with the thread count alone ptxas held the kernel to 56
// registers and spilled two loop invariants to local memory.

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 1) frustum_to_voxel_bwd_kernel(
    const T* __restrict__ g, const float* __restrict__ u,
    const float* __restrict__ v, const int* __restrict__ d0,
    const float* __restrict__ fd, T* __restrict__ dvol, int D, int Hf, int Wf,
    int C, int nz, int nx, int ny) {
  constexpr int V = Vec<T>::N;
  extern __shared__ float4 bwd_smem[];
  float* zw = reinterpret_cast<float*>(bwd_smem);  // [nz] weight on plane d
  float* u0 = zw + nz;                             // [nz] u of x cell 0
  float* inv_du = u0 + nz;                         // [nz] cells per pixel
  int* yr = reinterpret_cast<int*>(inv_du + nz);   // [nz][2] first, last y
  float* vw = reinterpret_cast<float*>(yr + 2 * nz);  // [nz][ny] v hat at h

  __shared__ int zrange[2];  // first, last row that reaches (d, h)

  const int h = blockIdx.y;
  const int n = blockIdx.z / D;
  const int d = blockIdx.z - n * D;
  const float* un = u + (int64_t)n * nz * nx;  // [nz, nx]
  const float* vn = v + (int64_t)n * nz * ny;  // [nz, ny]

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  if (tid == 0) {
    zrange[0] = INT_MAX;
    zrange[1] = INT_MIN;
  }
  __syncthreads();
  // the tables of every BEV row, rows spread over the threads
  for (int z = tid; z < nz; z += blockDim.x * blockDim.y) {
    const int dz = min(max(d0[z], 0), D - 2);
    const float f1 = fd[z];
    const float wz = dz == d ? __fsub_rn(1.0f, f1) : dz + 1 == d ? f1 : 0.0f;
    int ylo = ny, yhi = -1;
    if (wz != 0.0f) {
      for (int y = 0; y < ny; ++y) {
        const Hat hv = hat(vn[z * ny + y], Hf);
        const float wv = hv.i0 == h ? hv.w0 : hv.i0 + 1 == h ? hv.w1 : 0.0f;
        vw[z * ny + y] = wv;
        if (wv != 0.0f) {
          ylo = min(ylo, y);
          yhi = max(yhi, y);
        }
      }
      // the slope only bounds the candidates, which are widened and tested:
      // the fast division (no slow-path call) is exact enough
      const float ua = un[z * nx], ub = un[z * nx + nx - 1];
      u0[z] = ua;
      inv_du[z] = nx > 1 ? __fdividef((float)(nx - 1), ub - ua) : 0.0f;
      if (ylo <= yhi) {
        atomicMin(&zrange[0], z);
        atomicMax(&zrange[1], z);
      }
    }
    zw[z] = wz;
    yr[2 * z] = ylo;
    yr[2 * z + 1] = yhi;
  }
  __syncthreads();

  const int w = blockIdx.x * blockDim.y + threadIdx.y;
  if (w >= Wf) return;
  constexpr int CV = kBwdFloats / V;  // vectors a thread sums
  const int c0 = threadIdx.x * CV;    // its first vector
  const int nv = min(CV, C / V - c0);
  float acc[kBwdFloats];
#pragma unroll
  for (int i = 0; i < kBwdFloats; ++i) acc[i] = 0.0f;
  const T* gn = g + (int64_t)n * nz * nx * ny * C + c0 * V;
  for (int z = zrange[0]; z <= zrange[1]; ++z) {
    const float wz = zw[z];
    const int ylo = yr[2 * z], yhi = yr[2 * z + 1];
    if (wz == 0.0f || ylo > yhi) continue;
    // the x cells whose u lies in [w - 1, w + 1), from the inverse of the
    // affine map, widened by a cell each side; a zero or non-finite slope
    // keeps every cell
    int xlo = 0, xhi = nx - 1;
    const float inv = inv_du[z];
    if (isfinite(inv) && inv != 0.0f) {
      const float xa = ((float)(w - 1) - u0[z]) * inv;
      const float xb = ((float)(w + 1) - u0[z]) * inv;
      const float lo = fmaxf(floorf(fminf(xa, xb)) - 1.0f, 0.0f);
      const float hi = fminf(ceilf(fmaxf(xa, xb)) + 1.0f, (float)(nx - 1));
      if (!(lo <= hi)) continue;
      xlo = (int)lo;
      xhi = (int)hi;
    }
    const T* gz = gn + (int64_t)z * nx * ny * C;
    for (int x = xlo; x <= xhi; ++x) {
      const Hat hu = hat(un[z * nx + x], Wf);
      const float wu = hu.i0 == w ? hu.w0 : hu.i0 + 1 == w ? hu.w1 : 0.0f;
      if (wu == 0.0f) continue;
      const float wzu = __fmul_rn(wz, wu);
      const T* gx = gz + (int64_t)x * ny * C;
      for (int y = ylo; y <= yhi; ++y) {
        const float wv = vw[z * ny + y];
        if (wv == 0.0f) continue;
        const float wt = __fmul_rn(wzu, wv);
#pragma unroll
        for (int k = 0; k < CV; ++k) {
          if (k < nv) {
            float a[V];
            Vec<T>::load(gx + (int64_t)y * C + k * V, a);
#pragma unroll
            for (int i = 0; i < V; ++i)
              acc[k * V + i] = __fadd_rn(acc[k * V + i], __fmul_rn(wt, a[i]));
          }
        }
      }
    }
  }
  T* out = dvol + ((((int64_t)n * D + d) * Hf + h) * Wf + w) * C + c0 * V;
#pragma unroll
  for (int k = 0; k < CV; ++k)
    if (k < nv) Vec<T>::store_cs(out + k * V, acc + k * V);
}

template <typename T>
cudaError_t launch_f2v_bwd(const void* g, const void* u, const void* v,
                           const void* d0, const void* fd, void* dvol, int N,
                           int D, int Hf, int Wf, int C, int nz, int nx,
                           int ny, int block, cudaStream_t stream) {
  if ((int64_t)N * D * Hf * Wf * C == 0) return cudaSuccess;
  const int smem = bwd_table_bytes(nz, ny);
  const int chunks = (C + kBwdFloats - 1) / kBwdFloats;
  if (C % Vec<T>::N != 0 || D < 2 || nx < 1 || block < 1 ||
      chunks * block > kBwdThreads || smem > kSmemLimit ||
      (int64_t)N * D > 65535 || Hf > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = frustum_to_voxel_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wf + block - 1) / block, Hf, N * D);
  kernel<<<grid, dim3(chunks, block), (size_t)smem, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(u),
      static_cast<const float*>(v), static_cast<const int*>(d0),
      static_cast<const float*>(fd), static_cast<T*>(dvol), D, Hf, Wf, C, nz,
      nx, ny);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  tile_x: x cells per block; lanes:
// threads per (y, channel group); ncol: image columns a block stages
// (k4_tiling).  Returns a cudaError_t (0 = success).
int snvc_frustum_to_voxel(const void* vol, const void* P, const void* d0,
                          const void* fd, const void* zs, const void* xs,
                          const void* ys, void* out, int N, int D, int Hf,
                          int Wf, int C, int nz, int nx, int ny, float stride,
                          int tile_x, int lanes, int ncol, int dtype,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f2v<__nv_bfloat16>(vol, P, d0, fd, zs, xs, ys, out, N,
                                          D, Hf, Wf, C, nz, nx, ny, stride,
                                          tile_x, lanes, ncol, s);
  if (dtype == 1)
    return (int)launch_f2v<float>(vol, P, d0, fd, zs, xs, ys, out, N, D, Hf,
                                  Wf, C, nz, nx, ny, stride, tile_x, lanes,
                                  ncol, s);
  return (int)cudaErrorInvalidValue;
}

// Backward with respect to the volume: g [N, nz, nx, ny, C] -> dvol
// [N, D, Hf, Wf, C], given u [N, nz, nx] and v [N, nz, ny] in feature
// pixels.  dtype as above; block: image columns per block, each taken by
// ceil(C / 16) threads (k4_bwd_tiling).  Returns a cudaError_t (0 =
// success).
int snvc_frustum_to_voxel_bwd(const void* g, const void* u, const void* v,
                              const void* d0, const void* fd, void* dvol,
                              int N, int D, int Hf, int Wf, int C, int nz,
                              int nx, int ny, int block, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f2v_bwd<__nv_bfloat16>(g, u, v, d0, fd, dvol, N, D, Hf,
                                              Wf, C, nz, nx, ny, block, s);
  if (dtype == 1)
    return (int)launch_f2v_bwd<float>(g, u, v, d0, fd, dvol, N, D, Hf, Wf, C,
                                      nz, nx, ny, block, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
