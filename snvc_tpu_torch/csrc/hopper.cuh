// Hopper (sm_90a) building blocks shared by the conv kernels: mbarriers,
// TMA tensor and bulk copies, swizzled shared-memory addressing, ldmatrix,
// wgmma with A from registers and B from a shared-memory descriptor, and
// the host-side tensor-map encoder.
//
// cuTensorMapEncodeTiled lives in libcuda; it is fetched once through
// cudaGetDriverEntryPoint, so the libraries link against the runtime only
// (no -lcuda).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ mbarrier ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the async (TMA) proxy.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Spins until the barrier's phase of the given parity has completed.  A
// wait that outlives 2^25 polls (seconds; no stage takes a millisecond)
// traps: a wrong phase parity then fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  for (uint32_t polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 25)) __trap();
  }
}

// ------------------------------------------------------------- copies ----
// 5-D TMA tile load (coordinates innermost first, signed: elements outside
// the tensor arrive as zeros), completing on `bar`.
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

// 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The TMA swizzle of a byte offset inside a 1024-byte-aligned buffer whose
// rows are `row_bytes` = 32, 64 or 128 wide (CUTLASS's Swizzle<1|2|3,4,3>):
// the 16-byte chunk bits [4, 4+b) are XORed with the bits [7, 7+b).
__device__ __forceinline__ uint32_t swizzle(uint32_t off, uint32_t row_bytes) {
  const uint32_t mask = row_bytes / 16 - 1;  // 1, 3 or 7
  return off ^ (((off >> 7) & mask) << 4);
}

// The CU_TENSOR_MAP_SWIZZLE_* mode and the wgmma descriptor layout type of
// rows `row_bytes` wide.
inline CUtensorMapSwizzle tma_swizzle(int row_bytes) {
  return row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}
__host__ __device__ inline uint32_t desc_layout(int row_bytes) {
  return row_bytes == 128 ? 1u : row_bytes == 64 ? 2u : row_bytes == 32 ? 3u : 0u;
}

// ------------------------------------------------------------ ldmatrix ----
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// --------------------------------------------------------------- wgmma ----
// Shared-memory matrix descriptor: start address, leading / stride byte
// offsets (16-byte units) and the layout type (0 none, 1 128B, 2 64B, 3 32B).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)layout << 62);
}

// Orders this thread's generic-proxy shared-memory writes before later
// async-proxy (TMA, wgmma) accesses.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bar.sync on barrier `id` for `threads` threads (a multiple of 32).
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D[64 x NB] += A[64 x 16] (registers, bf16) * B[16 x NB] (descriptor, bf16),
// float32 accumulators; TB = 1 when B is stored MN-major.
template <int NB, int TB>
struct Wgmma;

template <int TB>
struct Wgmma<32, TB> {
  __device__ __forceinline__ static void run(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %21, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16"
        " {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15},"
        " {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
  }
};

template <int TB>
struct Wgmma<16, TB> {
  __device__ __forceinline__ static void run(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
    asm volatile(
        "{\n .reg .pred p;\n setp.ne.b32 p, %13, 0;\n"
        " wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16"
        " {%0, %1, %2, %3, %4, %5, %6, %7},"
        " {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
          "n"(TB));
  }
};

// Gives the producer warpgroup's registers back to the SM.
__device__ __forceinline__ void producer_release_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
}

// ---------------------------------------------------------- host side ----
// A 5-D bf16 tensor map over a contiguous [n4, n3, n2, n1, n0] array (n0
// innermost, n0 * 2 bytes a multiple of 16) with the box {b0, b1, b2, 1, 1}
// and the swizzle of b0 * 2-byte rows; out-of-range elements read as zero.
inline cudaError_t encode_5d(CUtensorMap* map, const void* base,
                             const uint64_t (&dims)[5], uint32_t b0,
                             uint32_t b1, uint32_t b2) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &q);
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorSymbolNotFound;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  cuuint64_t gdim[5], gstride[4];
  uint64_t stride = 2;
  for (int i = 0; i < 5; ++i) {
    gdim[i] = dims[i];
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t box[5] = {b0, b1, b2, 1, 1};
  const cuuint32_t estride[5] = {1, 1, 1, 1, 1};
  CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                        const_cast<void*>(base), gdim, gstride, box, estride,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, tma_swizzle(b0 * 2),
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace hopper
