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
//   dvol[n,d,h,w] = sum over rows z of wz(z, d) *
//                   sum over x of wu(x, w) * S[z, h, x],
//   S[z, h, x]    = sum over y of wv(y, h) * g[n, z, x, y],
//
// wz the depth lerp's weight of BEV row z on plane d (nonzero for d0[z]
// and d0[z] + 1 only), wu and wv the hats of u(z, x) and v(z, y).
//
// Bound: bytes, the gradient read once and the volume's gradient written
// once (110.6 + 122.7 MB at the training shape).  A scatter from each g
// element into its 8 taps would collide on the planes the z rows share;
// this backward gathers instead, deterministically, in two launches.
//
// The plan (frustum_to_voxel_bwd_plan_kernel), a block per (n, d): finds
// plane d's BEV rows (the static tables: a contiguous range, ~9 rows of
// 288 at the training shape), projects u [N, nz, nx] and v [N, nz, ny] of
// those rows with the forward's round-to-nearest order (project() above;
// the two planes a row reaches write the same bits), and marks the feature
// rows h any of them reaches with a nonzero weight (2,112 of the 6,144
// (d, h) rows there: far planes project onto rows 42-54 only, near rows
// sample the 96 rows sparsely).  So the main kernel takes no correctly
// rounded division.
//
// The main kernel (frustum_to_voxel_bwd_kernel): a block owns 2 feature
// rows h0, h0 + 1 (blockIdx.y) and a tile of tw image columns (blockIdx.x)
// of one (n, d) plane (blockIdx.z, far planes first: their blocks carry
// the most gradient, and the light ones fill the tail; planes d, d + 1,
// which share BEV rows, follow each other, so L2 serves the second read).
// A block whose rows the plan marked empty writes its zeros and nothing
// else.  The others fill, a warp a BEV row of the plane, the v hat's
// weights of each y at h0 and h0 + 1, the y cells with one and the x
// cells whose u hat can reach the tile (the affine map x -> u inverted
// and widened by a cell each side).  Then, per piece of up to ``xcap`` x
// cells (near rows, whose tile holds a few cells, packed several to a
// piece; a far row's ~112 cells of a 64-column tile whole; longer rows
// split), three phases with a barrier after each:
//
//   stage 1: S[x][k] = sum over the row's y cells of wv(y, h0 + k) * g,
//            a thread a (staged cell, 16 bytes of channels), both rows at
//            once, in float32 shared memory, with the cell's u hat; a y
//            whose weight on a row is 0 adds nothing to it.  Right after
//            it each thread issues the loads of its first cell of the
//            next piece (up to 6 y cells, 16 bytes a thread, neighbouring
//            threads on neighbouring bytes), which fly while this piece's
//            last two phases run;
//   runs:    the staged cells whose u hat reaches column w are those with
//            a lower tap in {w - 1, w}, a contiguous run (u is monotone
//            in x); a thread a cell records where the runs of its two
//            columns begin and end;
//   stage 2: a thread a (column, 4 channels) adds (wz * wu) * S of both
//            rows over its run of each row (each hat taken from the
//            cell's projected u exactly as the forward takes it) to its
//            float32 sums in shared memory.
//
// Each output is written once, rounded once, with the streaming store
// hint.  The sums are float32 (the plain version sums over x, then y,
// then the rows: the same terms, another rounding order).  A gradient
// element is read once per plane its row reaches and per row pair its v
// hat reaches (2 x 1.5 on average), mostly from L2.  What holds it above
// its byte bound is not bytes: each block walks its ~9 BEV rows as a
// chain of barrier-separated phases, 3 blocks of 256 threads share an SM
// (80 registers), and the SM issues ~1-1.5 warp instructions a cycle
// (PERF.md §6).  A thread owns 2 float4 slots (4 channels of a column,
// both rows) of the tile, so tw = 2 * 256 / (C / 4) columns (64 at C =
// 32); ops/frustum.py's k4_bwd_tiling picks xcap.

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

// ---------------------------------------------------------- backward ----

constexpr int kBwdThreads = 256;  // threads of a backward block
constexpr int kBwdSlots = 2;      // float4 slots of the tile a thread owns
constexpr int kBwdRows = 2;       // feature rows a block owns
constexpr int kBwdZ = 16;         // BEV rows whose tables a block holds at once

// One BEV row's tables in a backward block.
struct BwdRow {
  float wz;       // the row's weight on the block's plane
  int ylo, yhi;   // the y cells whose v hat reaches row h0 or h0 + 1
  int xlo, xhi;   // the x cells whose u hat may reach the block's tile
  int z;          // the BEV row
};

// A staged x cell's u hat (its two weights times its row's plane weight
// once the column runs are found): one 16-byte shared-memory load.
struct alignas(16) XHat {
  int i0;
  float w0, w1;
  int pad;
};

// Shared-memory bytes of a backward block (ops/frustum.py k4_bwd_smem):
// for each of ``xcap`` staged x cells the v-hat sums of the 2 rows
// (float32, C channels) and its u hat; the sums of the
// block's 2 x tw outputs (float32); then for each of kBwdZ BEV rows its
// piece entry (int4), its tables (BwdRow, ny (wv at h0, h0 + 1) pairs)
// and the run of staged cells of each of the tw columns (two int16).
__host__ __device__ constexpr int bwd_smem_bytes(int xcap, int C, int ny,
                                                 int tw) {
  return xcap * (kBwdRows * C * 4 + (int)sizeof(XHat)) +
         kBwdRows * tw * C * 4 +
         kBwdZ * (16 + (int)sizeof(BwdRow) + ny * 8 + tw * 4);
}

// The weight of BEV row z (lower plane d0z, blend f1) on plane d.
__device__ __forceinline__ float plane_weight(int d0z, float f1, int d, int D) {
  const int dz = min(max(d0z, 0), D - 2);
  return dz == d ? __fsub_rn(1.0f, f1) : dz + 1 == d ? f1 : 0.0f;
}

// The weight of a hat at tap i.
__device__ __forceinline__ float hat_at(const Hat& h, int i) {
  return h.i0 == i ? h.w0 : h.i0 + 1 == i ? h.w1 : 0.0f;
}

// Whether a hat puts a nonzero weight on a tap in [0, size).
__device__ __forceinline__ bool hat_inside(const Hat& h, int size) {
  return (h.w0 != 0.0f && (unsigned)h.i0 < (unsigned)size) ||
         (h.w1 != 0.0f && (unsigned)(h.i0 + 1) < (unsigned)size);
}

// The x cells whose u may lie in [a, b): the inverse of the affine map
// x -> u (origin u0, inv cells per pixel), widened by a cell each side,
// within [lo, hi] (empty: .x > .y).  A zero or non-finite slope keeps
// [lo, hi]; every candidate is tested with its own hat.
__device__ __forceinline__ int2 x_cells(float a, float b, float u0, float inv,
                                        int lo, int hi) {
  if (!isfinite(inv) || inv == 0.0f) return make_int2(lo, hi);
  const float xa = (a - u0) * inv, xb = (b - u0) * inv;
  const float first = fmaxf(floorf(fminf(xa, xb)) - 1.0f, (float)lo);
  const float last = fminf(ceilf(fmaxf(xa, xb)) + 1.0f, (float)hi);
  if (!(first <= last)) return make_int2(lo, lo - 1);
  return make_int2((int)first, (int)last);
}

// 4 float32 sums to 4 channels of T, with the streaming hint.
template <typename T>
__device__ __forceinline__ void store4_cs(T* p, const float* v);

template <>
__device__ __forceinline__ void store4_cs<float>(float* p, const float* v) {
  __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

template <>
__device__ __forceinline__ void store4_cs<__nv_bfloat16>(__nv_bfloat16* p,
                                                         const float* v) {
  uint2 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
  h[0] = __floats2bfloat162_rn(v[0], v[1]);
  h[1] = __floats2bfloat162_rn(v[2], v[3]);
  __stcs(reinterpret_cast<uint2*>(p), raw);
}

// The plan's scratch: u [N, nz, nx], v [N, nz, ny] float32, the BEV row
// range [N, D, 2] int32 of each plane, the feature rows with work
// [N, D, Hf] uint8 (ops/frustum.py k4_bwd_scratch_bytes).
struct BwdScratch {
  float* u;
  float* v;
  int* zr;
  unsigned char* work;
};

__host__ __device__ inline BwdScratch carve(void* base, int N, int D, int nz,
                                            int nx, int ny) {
  BwdScratch s;
  s.u = static_cast<float*>(base);
  s.v = s.u + (int64_t)N * nz * nx;
  s.zr = reinterpret_cast<int*>(s.v + (int64_t)N * nz * ny);
  s.work = reinterpret_cast<unsigned char*>(s.zr + (int64_t)N * D * 2);
  return s;
}

// A block per (d, n).  A feature row receives gradient when a BEV row
// with a weight on the plane has some x whose u hat reaches a column of
// the image and some y whose v hat reaches the row.  The block projects
// its rows first and reads the projections back after a barrier, so the
// divisions' slow path is called with nothing else live.
__global__ void __launch_bounds__(kBwdThreads) frustum_to_voxel_bwd_plan_kernel(
    const float* __restrict__ P, const int* __restrict__ d0,
    const float* __restrict__ fd, const float* __restrict__ zs,
    const float* __restrict__ xs, const float* __restrict__ ys,
    BwdScratch out, int D, int Hf, int Wf, int nz, int nx, int ny,
    float stride) {
  extern __shared__ int hit[];  // [Hf]
  __shared__ int range[2];
  __shared__ unsigned inside;  // bit zi: row zc + zi reaches the image
  const int tid = threadIdx.x;
  const int d = blockIdx.x, n = blockIdx.y;
  const float* p = P + (int64_t)n * 12;  // row-major [3, 4]
  float* un = out.u + (int64_t)n * nz * nx;
  float* vn = out.v + (int64_t)n * nz * ny;
  if (tid == 0) {
    range[0] = INT_MAX;
    range[1] = INT_MIN;
  }
  for (int h = tid; h < Hf; h += kBwdThreads) hit[h] = 0;
  __syncthreads();
  for (int z = tid; z < nz; z += kBwdThreads)
    if (plane_weight(d0[z], fd[z], d, D) != 0.0f) {
      atomicMin(&range[0], z);
      atomicMax(&range[1], z);
    }
  __syncthreads();
  const int zfirst = range[0], zlast = range[1];
  for (int zc = zfirst; zc <= zlast; zc += 32) {  // none when empty
    const int nzc = min(32, zlast - zc + 1);
    for (int it = tid; it < nzc * nx; it += kBwdThreads) {
      const int zi = it / nx, x = it - zi * nx;
      const float zz = zs[zc + zi];
      un[(int64_t)zc * nx + it] =
          project(p[0], xs[x], p[2], zz, p[3], __fadd_rn(zz, p[11]), stride);
    }
    for (int it = tid; it < nzc * ny; it += kBwdThreads) {
      const int zi = it / ny, y = it - zi * ny;
      const float zz = zs[zc + zi];
      vn[(int64_t)zc * ny + it] =
          project(p[5], ys[y], p[6], zz, p[7], __fadd_rn(zz, p[11]), stride);
    }
    if (tid == 0) inside = 0u;
    __syncthreads();  // the projections are visible to the block
    for (int it = tid; it < nzc * nx; it += kBwdThreads)
      if (hat_inside(hat(un[(int64_t)zc * nx + it], Wf), Wf))
        atomicOr(&inside, 1u << (it / nx));
    __syncthreads();
    for (int it = tid; it < nzc * ny; it += kBwdThreads) {
      const int zi = it / ny, z = zc + zi;
      if ((inside >> zi & 1u) && plane_weight(d0[z], fd[z], d, D) != 0.0f) {
        const Hat hv = hat(vn[(int64_t)zc * ny + it], Hf);
        if (hv.w0 != 0.0f && (unsigned)hv.i0 < (unsigned)Hf) hit[hv.i0] = 1;
        if (hv.w1 != 0.0f && (unsigned)(hv.i0 + 1) < (unsigned)Hf)
          hit[hv.i0 + 1] = 1;
      }
    }
    __syncthreads();  // the next chunk resets ``inside``
  }
  const int64_t nd = (int64_t)n * D + d;
  for (int h = tid; h < Hf; h += kBwdThreads)
    out.work[nd * Hf + h] = (unsigned char)hit[h];
  if (tid == 0) {
    const bool any = zfirst <= zlast;
    out.zr[2 * nd] = any ? zfirst : 0;
    out.zr[2 * nd + 1] = any ? zlast : -1;
  }
}

// The staged x cells of one step: the active BEV rows [z0, z1) of the
// table chunk whole (xc < 0), or x cells [xc, xc + ncx) of row z0 alone;
// ``cells`` of them in all, of ``nact`` active rows.
struct Piece {
  int z0, z1, xc, ncx, cells, nact;
};

__device__ __forceinline__ bool active(const BwdRow& r) {
  return r.wz != 0.0f && r.ylo <= r.yhi && r.xlo <= r.xhi;
}

// The piece that starts at table row zi (x cell xc of it, or its first
// when xc < 0): as many whole rows as ``xcap`` x cells hold, or the next
// x chunk of a row that does not fit.  z0 == nzc: no piece is left.
__device__ Piece make_piece(const BwdRow* rows, int nzc, int zi, int xc,
                            int xcap) {
  while (zi < nzc && !active(rows[zi])) {
    ++zi;
    xc = -1;
  }
  if (zi >= nzc) return {nzc, nzc, -1, 0, 0, 0};
  const BwdRow r = rows[zi];
  const int used = r.xhi - r.xlo + 1;
  if (xc < 0 && used <= xcap) {
    int z1 = zi + 1, cells = used, nact = 1;
    for (; z1 < nzc; ++z1) {
      if (!active(rows[z1])) continue;
      const int c = rows[z1].xhi - rows[z1].xlo + 1;
      if (cells + c > xcap) break;
      cells += c;
      ++nact;
    }
    return {zi, z1, -1, 0, cells, nact};
  }
  if (xc < 0) xc = r.xlo;
  const int ncx = min(xcap, r.xhi - xc + 1);
  return {zi, zi + 1, xc, ncx, ncx, 1};
}

__device__ __forceinline__ Piece next_piece(const BwdRow* rows, int nzc,
                                            const Piece& p, int xcap) {
  if (p.xc >= 0 && p.xc + p.ncx <= rows[p.z0].xhi)
    return make_piece(rows, nzc, p.z0, p.xc + p.ncx, xcap);
  return make_piece(rows, nzc, p.z1, -1, xcap);
}

// The x cells of row r that a piece holds.
__device__ __forceinline__ int2 piece_x(const Piece& p, const BwdRow& r) {
  return p.xc < 0 ? make_int2(r.xlo, r.xhi)
                  : make_int2(p.xc, p.xc + p.ncx - 1);
}

// The next active row of a piece after row zi (z1 when none is left).
__device__ __forceinline__ int next_active(const BwdRow* rows, int zi,
                                           int z1) {
  do ++zi;
  while (zi < z1 && !active(rows[zi]));
  return zi;
}

// 16 bytes of channels of T to float32.
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& raw, float* v);

template <>
__device__ __forceinline__ void unpack16<float>(const uint4& raw, float* v) {
  v[0] = __uint_as_float(raw.x);
  v[1] = __uint_as_float(raw.y);
  v[2] = __uint_as_float(raw.z);
  v[3] = __uint_as_float(raw.w);
}

template <>
__device__ __forceinline__ void unpack16<__nv_bfloat16>(const uint4& raw,
                                                        float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// A thread's stage-1 cell of a piece with its first YB y cells' loads in
// flight: its v weights' offset wv, its y cells nyr, its gradient src and
// its u.
template <typename T, int YB>
struct Prefetch {
  int wv, nyr;
  const T* src;
  float u;
  uint4 raw[YB];

  __device__ __forceinline__ void load(int y0, int C) {
#pragma unroll
    for (int i = 0; i < YB; ++i)
      if (y0 + i < nyr)
        raw[i] = *reinterpret_cast<const uint4*>(src + (int64_t)(y0 + i) * C);
  }

  // cell s of piece p (none: p is empty or s past its cells)
  __device__ __forceinline__ void start_at(const Piece& p, const BwdRow* rows,
                                           int s, const T* gn, const float* un,
                                           int nx, int ny, int C, int c0) {
    int zi = p.z0, base = 0;
    int2 xr = piece_x(p, rows[zi]);
    while (s - base > xr.y - xr.x) {
      base += xr.y - xr.x + 1;
      zi = next_active(rows, zi, p.z1);
      xr = piece_x(p, rows[zi]);
    }
    const BwdRow r = rows[zi];
    const int x = xr.x + s - base;
    wv = zi * ny + r.ylo;
    nyr = r.yhi - r.ylo + 1;
    src = gn + (((int64_t)r.z * nx + x) * ny + r.ylo) * C + c0;
    u = c0 == 0 ? un[(int64_t)r.z * nx + x] : 0.0f;
    load(0, C);
  }

  __device__ __forceinline__ void start(const Piece& p, const BwdRow* rows,
                                        int s, const T* gn, const float* un,
                                        int nx, int ny, int C, int c0) {
    if (p.z0 < p.z1 && s < p.cells) start_at(p, rows, s, gn, un, nx, ny, C, c0);
  }
};

template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 3) frustum_to_voxel_bwd_kernel(
    const T* __restrict__ g, const int* __restrict__ d0,
    const float* __restrict__ fd, BwdScratch pl, T* __restrict__ dvol, int D,
    int Hf, int Wf, int C, int nz, int nx, int ny, int tw, int xcap) {
  constexpr int V = 16 / (int)sizeof(T);  // channels of a 16-byte vector
  constexpr int YB = 6;  // y cells of a staged cell whose loads fly at once
  extern __shared__ float4 bwd_smem[];
  float* S = reinterpret_cast<float*>(bwd_smem);            // [xcap][2][C]
  float* A = S + xcap * kBwdRows * C;                       // [2][tw][C]
  XHat* xt = reinterpret_cast<XHat*>(A + kBwdRows * tw * C);  // [xcap]
  int4* act = reinterpret_cast<int4*>(xt + xcap);           // [kBwdZ]
  BwdRow* rows = reinterpret_cast<BwdRow*>(act + kBwdZ);    // [kBwdZ]
  float2* wv = reinterpret_cast<float2*>(rows + kBwdZ);     // [kBwdZ][ny]
  int* runs = reinterpret_cast<int*>(wv + kBwdZ * ny);      // [kBwdZ][tw]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = blockIdx.x * tw;
  const int wend = min(w0 + tw, Wf);
  const int h0 = blockIdx.y * kBwdRows;
  // planes far to near: the far planes' blocks, which carry the most BEV
  // rows' gradient, start first and the light ones fill the tail
  const int n = blockIdx.z / D, d = D - 1 - (blockIdx.z - n * D);
  const int nd = n * D + d;
  const int L = C / 4;  // float4 slots of a column
  T* out = dvol + (int64_t)nd * Hf * Wf * C;

  const unsigned char* wk = pl.work + (int64_t)nd * Hf + h0;
  if (!(wk[0] || (h0 + 1 < Hf && wk[1]))) {
    // a row pair with no work: its zeros, and nothing else
    const float zero[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < kBwdSlots; ++k) {
      const int slot = tid + k * kBwdThreads, col = slot / L;
      const int w = w0 + col;
      if (col >= tw || w >= Wf) continue;
      const int c4 = slot - col * L;
      for (int r = 0; r < kBwdRows && h0 + r < Hf; ++r)
        store4_cs<T>(out + ((int64_t)(h0 + r) * Wf + w) * C + 4 * c4, zero);
    }
    return;
  }

  for (int i = tid; i < kBwdRows * tw * L; i += kBwdThreads)
    reinterpret_cast<float4*>(A)[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  const int G = C / V;  // 16-byte vectors of a gradient cell
  // stage 1: vector cg of staged cells s0, s0 + step, ...
  const int step = kBwdThreads / G;
  const int cg = tid % G, s0 = tid < step * G ? tid / G : INT_MAX;
  const int zfirst = pl.zr[2 * nd], zlast = pl.zr[2 * nd + 1];
  const float* un = pl.u + (int64_t)n * nz * nx;
  const float* vn = pl.v + (int64_t)n * nz * ny;
  const T* gn = g + (int64_t)n * nz * nx * ny * C;
  for (int zc = zfirst; zc <= zlast; zc += kBwdZ) {
    const int nzc = min(kBwdZ, zlast - zc + 1);
    __syncthreads();  // the last chunk's pieces are done with the tables
    // a warp a BEV row: its plane weight, the v hat's weights of each y at
    // h0 and h0 + 1 and the y cells with one, the x cells that may reach
    // the tile
    for (int zi = warp; zi < nzc; zi += kBwdThreads / 32) {
      const int z = zc + zi;
      const float* vz = vn + (int64_t)z * ny;
      const float* uz = un + (int64_t)z * nx;
      // lane 0's loads fly with the v's
      float ua = 0.0f, ub = 0.0f, f1 = 0.0f;
      int d0z = 0;
      if (lane == 0) {
        ua = uz[0];
        ub = uz[nx - 1];
        d0z = d0[z];
        f1 = fd[z];
      }
      int ylo = INT_MAX, yhi = -1;
      for (int y0 = 0; y0 < ny; y0 += 32) {
        const int y = y0 + lane;
        float a = 0.0f, b = 0.0f;
        if (y < ny) {
          const Hat hv = hat(vz[y], Hf);
          a = hat_at(hv, h0);
          b = h0 + 1 < Hf ? hat_at(hv, h0 + 1) : 0.0f;
          wv[zi * ny + y] = make_float2(a, b);
        }
        const unsigned m = __ballot_sync(0xffffffffu, a != 0.0f || b != 0.0f);
        if (m) {
          ylo = min(ylo, y0 + __ffs(m) - 1);
          yhi = y0 + 31 - __clz(m);
        }
      }
      if (lane == 0) {
        BwdRow r;
        r.wz = plane_weight(d0z, f1, d, D);
        // the slope only bounds the x cells, which are widened and whose
        // hats are tested: the fast division is exact enough
        const float inv = nx > 1 ? __fdividef((float)(nx - 1), ub - ua) : 0.0f;
        const int2 xr = x_cells((float)(w0 - 1), (float)wend, ua, inv, 0,
                                nx - 1);
        r.ylo = ylo;
        r.yhi = yhi;
        r.xlo = xr.x;
        r.xhi = xr.y;
        r.z = z;
        rows[zi] = r;
      }
    }
    __syncthreads();
    Piece cur = make_piece(rows, nzc, 0, -1, xcap);
    Prefetch<T, YB> pf;
    pf.start(cur, rows, s0, gn, un, nx, ny, C, cg * V);
    while (cur.z0 < nzc) {
      if (tid == 0) {
        // the piece's active rows: first staged cell, cells, plane weight
        int base = 0, j = 0;
        for (int zi = cur.z0; zi < cur.z1; ++zi) {
          const BwdRow r = rows[zi];
          if (!active(r)) continue;
          const int2 xr = piece_x(cur, r);
          act[j++] = make_int4(base, xr.y - xr.x + 1, __float_as_int(r.wz), 0);
          base += xr.y - xr.x + 1;
        }
      }
      // every column of every row starts with no staged cell (first > last)
      for (int i = tid; i < cur.nact * tw; i += kBwdThreads) runs[i] = 1;
      // stage 1: S[s][k] = sum over y of wv(y, h0 + k) * g[z, x, y] for
      // each staged cell s (row zi, x cell x), in float32, y ascending (a
      // y whose weight on a row is 0 adds nothing to it); the cell's u hat
      // and row beside it.  The thread's first cell was loaded while the
      // last piece was summed (``pf``); any further ones load now.
      for (int s = s0; s < cur.cells; s += step) {
        if (s != s0) pf.start_at(cur, rows, s, gn, un, nx, ny, C, cg * V);
        float a0[V], a1[V];
#pragma unroll
        for (int i = 0; i < V; ++i) a0[i] = a1[i] = 0.0f;
        const float2* wy = wv + pf.wv;
        for (int y0 = 0; y0 < pf.nyr; y0 += YB) {
          if (y0 > 0) pf.load(y0, C);  // a y range past YB
#pragma unroll
          for (int i = 0; i < YB; ++i) {
            if (y0 + i >= pf.nyr) break;
            float t[V];
            unpack16<T>(pf.raw[i], t);
            const float2 w = wy[y0 + i];
            if (w.x != 0.0f) {
#pragma unroll
              for (int c = 0; c < V; ++c) a0[c] = __fmaf_rn(w.x, t[c], a0[c]);
            }
            if (w.y != 0.0f) {
#pragma unroll
              for (int c = 0; c < V; ++c) a1[c] = __fmaf_rn(w.y, t[c], a1[c]);
            }
          }
        }
        float4* s4 = reinterpret_cast<float4*>(S + s * kBwdRows * C + cg * V);
#pragma unroll
        for (int i = 0; i < V / 4; ++i) {
          s4[i] = make_float4(a0[4 * i], a0[4 * i + 1], a0[4 * i + 2],
                              a0[4 * i + 3]);
          s4[C / 4 + i] = make_float4(a1[4 * i], a1[4 * i + 1], a1[4 * i + 2],
                                      a1[4 * i + 3]);
        }
        if (cg == 0) {
          const Hat h = hat(pf.u, Wf);
          xt[s] = {h.i0, h.w0, h.w1, 0};
        }
      }
      __syncthreads();
      // the next piece's first cells start loading, to land while this
      // one's column ranges and sums are formed
      const Piece nxt = next_piece(rows, nzc, cur, xcap);
      pf.start(nxt, rows, s0, gn, un, nx, ny, C, cg * V);
      // each column's staged cells of each row: the cells whose lower tap
      // is w - 1 or w reach column w, a contiguous run (u is monotone in
      // x), so cell s is the first of its columns {i0, i0 + 1} that the
      // cell before it does not reach and the last of those the cell
      // after it does not reach.  A cell a thread; the runs land as
      // (first, last) int16 pairs over the empty ones written above, and
      // the cell's two weights take its row's plane weight.
      for (int c = tid; c < cur.cells; c += kBwdThreads) {
        int j = 0;
        while (c >= act[j].x + act[j].y) ++j;
        const int4 a = act[j];
        const float wz = __int_as_float(a.z);
        xt[c].w0 = __fmul_rn(wz, xt[c].w0);
        xt[c].w1 = __fmul_rn(wz, xt[c].w1);
        const int rs = c - a.x;
        const int i0 = xt[c].i0;
        const int ip = rs == 0 ? INT_MIN / 2 : xt[c - 1].i0;
        const int in = rs == a.y - 1 ? INT_MIN / 2 : xt[c + 1].i0;
        short* f = reinterpret_cast<short*>(runs + j * tw - w0);
#pragma unroll
        for (int w = i0; w <= i0 + 1; ++w) {
          if (w < w0 || w >= wend) continue;
          if (w != ip && w != ip + 1) f[2 * w] = (short)rs;
          if (w != in && w != in + 1) f[2 * w + 1] = (short)rs;
        }
      }
      __syncthreads();
      // stage 2: each column adds wz * wu(x, w) * S over its staged cells
      // of each row, in float32, rows and x ascending, to its sums in
      // shared memory
#pragma unroll 1  // one slot's sums live at a time (no spill)
      for (int k = 0; k < kBwdSlots; ++k) {
        const int slot = tid + k * kBwdThreads, col = slot / L;
        const int w = w0 + col;
        if (col >= tw || w >= Wf) continue;
        float4* a4 = reinterpret_cast<float4*>(A + col * C) + (slot - col * L);
        float4 p0 = a4[0], p1 = a4[tw * L];
        for (int j = 0; j < cur.nact; ++j) {
          const int e = runs[j * tw + col];
          const int f = (short)(e & 0xffff), l = e >> 16;
          if (f > l) continue;
          const int base = act[j].x;
          for (int s = base + f; s <= base + l; ++s) {
            // in the run the lower tap is w (weight w0) or w - 1 (w1)
            const float wt = xt[s].i0 == w ? xt[s].w0 : xt[s].w1;
            const float4* s4 = reinterpret_cast<const float4*>(
                                   S + s * kBwdRows * C) + (slot - col * L);
            const float4 q0 = s4[0], q1 = s4[L];
            p0.x = __fmaf_rn(wt, q0.x, p0.x);
            p0.y = __fmaf_rn(wt, q0.y, p0.y);
            p0.z = __fmaf_rn(wt, q0.z, p0.z);
            p0.w = __fmaf_rn(wt, q0.w, p0.w);
            p1.x = __fmaf_rn(wt, q1.x, p1.x);
            p1.y = __fmaf_rn(wt, q1.y, p1.y);
            p1.z = __fmaf_rn(wt, q1.z, p1.z);
            p1.w = __fmaf_rn(wt, q1.w, p1.w);
          }
        }
        a4[0] = p0;
        a4[tw * L] = p1;
      }
      __syncthreads();  // the next piece overwrites S and the ranges
      cur = nxt;
    }
  }
  // each output once, rounded once
#pragma unroll
  for (int k = 0; k < kBwdSlots; ++k) {
    const int slot = tid + k * kBwdThreads, col = slot / L;
    const int w = w0 + col;
    if (col >= tw || w >= Wf) continue;
    const int c4 = slot - col * L;
    const float4* a4 = reinterpret_cast<const float4*>(A + col * C) + c4;
    for (int r = 0; r < kBwdRows && h0 + r < Hf; ++r) {
      const float4 p = a4[r * tw * L];
      const float v[4] = {p.x, p.y, p.z, p.w};
      store4_cs<T>(out + ((int64_t)(h0 + r) * Wf + w) * C + 4 * c4, v);
    }
  }
}

// Columns of a backward block: kBwdSlots float4 slots of 256 threads over
// C / 4 slots a column (ops/frustum.py k4_bwd_tiling).
__host__ __device__ constexpr int bwd_tile(int C) {
  return kBwdSlots * kBwdThreads / (C / 4);
}

cudaError_t launch_bwd_plan(const void* P, const void* d0, const void* fd,
                            const void* zs, const void* xs, const void* ys,
                            void* scratch, int N, int D, int Hf, int Wf,
                            int nz, int nx, int ny, float stride,
                            cudaStream_t stream) {
  if (N == 0) return cudaSuccess;
  const int smem = Hf * (int)sizeof(int);
  if (D < 2 || Hf < 1 || D > 65535 || N > 65535 || smem > kSmemLimit)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      frustum_to_voxel_bwd_plan_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  frustum_to_voxel_bwd_plan_kernel<<<dim3(D, N), kBwdThreads, smem,
                                     stream>>>(
      static_cast<const float*>(P), static_cast<const int*>(d0),
      static_cast<const float*>(fd), static_cast<const float*>(zs),
      static_cast<const float*>(xs), static_cast<const float*>(ys),
      carve(scratch, N, D, nz, nx, ny), D, Hf, Wf, nz, nx, ny, stride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_f2v_bwd(const void* g, const void* d0, const void* fd,
                           void* scratch, void* dvol, int N, int D, int Hf,
                           int Wf, int C, int nz, int nx, int ny, int xcap,
                           cudaStream_t stream) {
  if ((int64_t)N * D * Hf * Wf * C == 0) return cudaSuccess;
  const int tw = bwd_tile(C);
  const int smem = bwd_smem_bytes(xcap, C, ny, tw);
  // C <= 1024: a staged cell's 16-byte vectors fit a block's threads
  if (C % 8 != 0 || C / 4 > kBwdThreads || D < 2 || nx < 1 ||
      xcap < 1 || xcap > 32767 || smem > kSmemLimit ||
      (int64_t)N * D > 65535 || (Hf + kBwdRows - 1) / kBwdRows > 65535)
    return cudaErrorInvalidConfiguration;
  auto kernel = frustum_to_voxel_bwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Wf + tw - 1) / tw, (Hf + kBwdRows - 1) / kBwdRows, N * D);
  kernel<<<grid, kBwdThreads, (size_t)smem, stream>>>(
      static_cast<const T*>(g), static_cast<const int*>(d0),
      static_cast<const float*>(fd), carve(scratch, N, D, nz, nx, ny),
      static_cast<T*>(dvol), D, Hf, Wf, C, nz, nx, ny, tw, xcap);
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

// The backward's plan: projects u and v and finds each plane's BEV rows
// and the feature rows with work into ``scratch`` (BwdScratch) for the
// volume's (D, Hf, Wf), given the tables of snvc_frustum_to_voxel.
// Returns a cudaError_t (0 = success).
int snvc_frustum_to_voxel_bwd_plan(const void* P, const void* d0,
                                   const void* fd, const void* zs,
                                   const void* xs, const void* ys,
                                   void* scratch, int N, int D, int Hf, int Wf,
                                   int nz, int nx, int ny, float stride,
                                   void* stream) {
  return (int)launch_bwd_plan(P, d0, fd, zs, xs, ys, scratch, N, D, Hf, Wf,
                              nz, nx, ny, stride,
                              static_cast<cudaStream_t>(stream));
}

// Backward with respect to the volume: g [N, nz, nx, ny, C] -> dvol
// [N, D, Hf, Wf, C], given the plan in ``scratch``.  dtype as above; xcap:
// the x cells whose v-hat sums a block stages at once (k4_bwd_tiling).  C
// must be a multiple of 8.
// Returns a cudaError_t (0 = success).
int snvc_frustum_to_voxel_bwd(const void* g, const void* d0, const void* fd,
                              void* scratch, void* dvol, int N, int D, int Hf,
                              int Wf, int C, int nz, int nx, int ny, int xcap,
                              int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_f2v_bwd<__nv_bfloat16>(g, d0, fd, scratch, dvol, N, D,
                                              Hf, Wf, C, nz, nx, ny, xcap, s);
  if (dtype == 1)
    return (int)launch_f2v_bwd<float>(g, d0, fd, scratch, dvol, N, D, Hf, Wf,
                                      C, nz, nx, ny, xcap, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
