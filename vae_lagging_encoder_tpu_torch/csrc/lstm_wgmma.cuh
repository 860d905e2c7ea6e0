// Hopper building blocks of the wide-row LSTM kernels (lstm_infer.cu's and
// lstm_bwd.cu's *_wide_kernel), also used by the CE kernels (ce_fwd.cu,
// ce_bwd.cu, with ce_wgmma.cuh): wgmma on 128-byte-swizzled K-major operands,
// mbarriers, TMA tile loads (also multicast to the blocks of a cluster),
// distributed shared memory, and the host side: tensor maps encoded through
// cuTensorMapEncodeTiled as cudaGetDriverEntryPoint returns it (no -lcuda)
// and a cooperative cluster launch whose co-residency is checked before it
// is made.
//
// Operand layout: a [rows][64] bf16 slab, 128 bytes a row, with the 128-byte
// swizzle: 16-byte chunk c of row r at r * 128 + ((c ^ (r & 7)) << 4). TMA's
// SWIZZLE_128B writes it, the wgmma descriptor below reads it, and a thread
// filling a slab by hand writes it with swz_elem. A slab is 1024-byte
// aligned (the swizzle repeats every 8 rows); the k16 steps inside it start
// 32 bytes apart.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing is linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_wgmma {

constexpr int kSlab = 64;            // bf16 k elements of one 128-byte slab row
constexpr int kTileRows = 64;        // rows of one wgmma A tile (a warpgroup's m64)
constexpr int kTileBytes = kTileRows * 128;
constexpr int kAlign = 1024;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of bf16 element (r, k) of a swizzled [rows][64] slab.
__host__ __device__ __forceinline__ uint32_t swz_elem(int r, int k) {
  return (uint32_t)(r * 128 + ((((k >> 3) ^ (r & 7)) & 7) << 4) + (k & 7) * 2);
}

// ------------------------------------------------------------------ wgmma
// Descriptor of a K-major operand with the 128-byte swizzle: start address
// >> 4 (bits 0-13), leading byte offset 1 (unused by swizzled K-major
// layouts), stride byte offset 1024 >> 4 between 8-row groups (bits 32-45),
// base offset 0 (slabs are 1024-byte aligned), layout SWIZZLE_128B (bits
// 62-63). ce_fwd.cu's and ce_bwd.cu's K-major operands too.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
         | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
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
// Keeps the compiler from moving accumulator accesses across the
// asynchronous products.
template <int M>
__device__ __forceinline__ void fence_acc(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A B, A 64 x 16 and B 16 x N bf16, both K-major in shared memory,
// f32 accumulators; scale_d = 0 overwrites d. Accumulator layout (PTX ISA,
// wgmma .m64nNk16 D fragments): warp w of the warpgroup, lane l, register
// 4i + 2h + e holds row 16w + l/4 + 8h, column 8i + 2(l%4) + e.
template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], uint64_t da, uint64_t db,
                                             int scale_d) {
  static_assert(N == 32 || N == 64, "wgmma widths this file spells out");
  if constexpr (N == 32) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// A 64-row slab product over one 64-wide k slab: four k16 steps.
template <int N>
__device__ __forceinline__ void wgmma_slab(float (&d)[N / 2], uint32_t a, uint32_t b,
                                           bool first) {
#pragma unroll
  for (int k16 = 0; k16 < kSlab / 16; ++k16)
    wgmma_m64k16<N>(d, sw128_desc(a + k16 * 32), sw128_desc(b + k16 * 32),
                    (!first || k16) ? 1 : 0);
}

// ------------------------------------------------------------------ fences
// This thread's generic-proxy accesses before the fence are ordered with
// later async-proxy ones (TMA, wgmma): shared memory of this block, or every
// state space (a TMA load in another block reading what this thread stored).
__device__ __forceinline__ void fence_proxy_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async;\n" ::: "memory");
}
// The same for global memory only: the writes this thread has seen (a
// block barrier before it covers the block's), before async-proxy reads.
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}
// Named barrier of `threads` threads (a warpgroup: 128), id 1..15.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// The inits are visible to the whole cluster (before its first cluster sync).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// One arrival that also expects `bytes` of asynchronous (TMA) writes.
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// Spin until the phase with parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// The same, acquiring at cluster scope what other blocks of the cluster
// released with their arrivals (their distributed-shared-memory stores).
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ------------------------------------------------------- cluster, DSMEM
// The address of this block's shared-memory location `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Arrive on the barrier at this block's offset `bar` in block `rank`,
// releasing this thread's earlier writes at cluster scope (what a
// distributed-shared-memory store needs before its reader's wait).
__device__ __forceinline__ void mbar_arrive_rank(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(
                   map_rank(bar, rank))
               : "memory");
}
// The same with CTA-scope release: for a barrier that orders no data of
// this thread (a ring slot whose wgmma reads have completed), without the
// cluster-scope release's wait on this thread's outstanding memory accesses.
__device__ __forceinline__ void mbar_arrive_rank_relaxed(uint32_t bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(map_rank(bar, rank))
               : "memory");
}
__device__ __forceinline__ void st_cluster(uint32_t addr, float4 v) {
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// ------------------------------------------------------------------ TMA
// 2-D tile load: box (c0 innermost, c1) of `tmap` into `dst`, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* tmap, int c0,
                                            int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}
// The same tile written at offset `dst` of every block in `mask` (cluster
// ranks), each completing on its own barrier at offset `bar`.
__device__ __forceinline__ void tma_load_2d_mc(uint32_t dst, const CUtensorMap* tmap, int c0,
                                               int c1, uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(bar), "h"(mask)
      : "memory");
}

// ------------------------------------------------------------------ host
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q)
            == cudaSuccess
        && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A row-major 2-D tensor map: `outer` rows of `inner` elements of `dtype`,
// rows `row_bytes` apart; boxes of box_outer x box_inner; elements outside
// the tensor read as zeros.
inline cudaError_t encode_2d(CUtensorMap* m, CUtensorMapDataType dtype, const void* base,
                             uint64_t inner, uint64_t outer,
                             uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
                             CUtensorMapSwizzle swizzle) {
  EncodeTiledFn fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = fn(m, dtype, 2, const_cast<void*>(base), dims, strides, box, estr,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Blocks of `threads` with `smem` bytes of dynamic shared memory a block
// that the card holds at once in clusters of `cluster` consecutive blocks
// (cudaOccupancyMaxActiveClusters), into *blocks; sets the kernel's
// dynamic shared memory to `smem`.
template <typename... Exp>
inline cudaError_t cluster_blocks(void (*kern)(Exp...), int threads, size_t smem, int cluster,
                                  int* blocks) {
  cudaError_t err = cudaFuncSetAttribute((const void*)kern,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kern, &cfg);
  *blocks = clusters * cluster;
  return err;
}

// Launch `kern` on `grid` blocks of `threads` in clusters of `cluster`
// consecutive blocks, cooperatively (every block resident at once, as the
// kernels' grid.sync() needs): refused (cudaErrorCooperativeLaunchTooLarge)
// unless the card can hold the whole grid in clusters at once.
template <typename... Exp, typename... Act>
inline cudaError_t launch_cluster_cooperative(void (*kern)(Exp...), int grid, int threads,
                                              size_t smem, int cluster, cudaStream_t stream,
                                              Act&&... args) {
  int dev, coop, smem_max, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if (!coop || smem > (size_t)smem_max || grid % cluster) return cudaErrorInvalidValue;
  if ((err = cluster_blocks(kern, threads, smem, cluster, &blocks))) return err;
  if (blocks < grid) return cudaErrorCooperativeLaunchTooLarge;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  if ((err = cudaLaunchKernelEx(&cfg, kern, static_cast<Act&&>(args)...))) return err;
  return cudaGetLastError();
}

}  // namespace lstm_wgmma
