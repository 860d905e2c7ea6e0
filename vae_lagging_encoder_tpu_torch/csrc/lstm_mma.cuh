// Tensor-core and asynchronous-copy building blocks shared by the bf16 LSTM
// kernels below ops/lstm_cuda.py::WIDE_MIN_ROWS rows (lstm_infer.cu, the
// bf16 path of lstm_bwd.cu: the narrow-row kernels and the mma.sync
// kernels; the wide-row path is built from lstm_wgmma.cuh), and the two
// operand layouts they use.
//
// Product tiles are mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32
// (one warp: a 16x16 bf16 A tile times a 16x8 bf16 B tile into 16x8 f32).
// wgmma needs a 64-row A tile; the backward's product has B = 32 rows (and
// fewer on a short last batch), and each forward warp owns its own 16-row
// tiles, so mma.sync wastes nothing at these shapes where wgmma would. The
// narrow-row kernels bring the operand in by cp.async.bulk (bulk_load,
// bulk_load_mc: one instruction for a contiguous run of tiles, multicast
// to a cluster), the mma.sync kernels by cp.async.
//
// A operand in fragment order ("frag layout"): a [Mpad, Kpad] bf16 matrix
// stored as 16x16 tiles, tile (mt, ks) at index mt * KS + ks, each tile
// lane-major: lane l's 8 values are its registers a0..a3 of m16n8k16 (PTX
// ISA, "Matrix Fragments for mma.m16n8k16 with floating point type"). So a
// lane fetches its whole fragment of a tile with one 16-byte copy, a warp
// reads 512 contiguous bytes, and the shared-memory read back is one
// conflict-free 16-byte load, with no transposition, no swizzle and no
// ldmatrix. Rows and columns beyond the matrix are zeros (the caller
// allocates the ring with torch.zeros and never writes them).
//
// B operand in fragment order: [ks][n-tile][lane][4 bf16], the lane's b0, b1
// registers for that k-step and n-tile; one conflict-free 8-byte load.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_mma {

constexpr int kTileElems = 256;  // one 16x16 bf16 tile: 32 lanes x 8 values
constexpr int kMaxWarps = 16;    // warps per block the kernels are written for

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Index (in bf16 elements) of A[row, k] in the frag layout with KS k-steps.
__device__ __forceinline__ size_t a_frag_index(int row, int k, int KS) {
  const int r = row & 15, c = k & 15;
  const int lane = (r & 7) * 4 + ((c & 7) >> 1);
  const int reg = (r >> 3) + 2 * (c >> 3);
  return ((size_t)(row >> 4) * KS + (k >> 4)) * kTileElems + lane * 8 + reg * 2 + (c & 1);
}

// Index (in bf16 elements) of B[k, n] in the B fragment layout with NTILES
// n-tiles of 8 columns.
__device__ __forceinline__ int b_frag_index(int k, int n, int NTILES) {
  const int kk = k & 15;
  const int lane = (n & 7) * 4 + ((kk & 7) >> 1);
  const int e = (kk & 1) + 2 * (kk >> 3);
  return (((k >> 4) * NTILES + (n >> 3)) * 32 + lane) * 4 + e;
}

// c += a * b on the tensor cores, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float c[4], const uint4& a, const uint2& b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

// 16-byte asynchronous copy global -> shared through L2 only (.cg): never a
// stale L1 line of data that other blocks wrote during the kernel.
__device__ __forceinline__ void cp_async16(void* smem_dst, const void* gmem_src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem_src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 1-D bulk copy (the TMA unit, no tensor map) of `bytes` (a multiple of 16,
// both ends 16-byte aligned) from global memory to shared memory at `dst`,
// completing its bytes on the mbarrier at `bar`; with a mask, the same
// bytes into offset `dst` of every cluster block in it, each completing on
// its own mbarrier at offset `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_load_mc(uint32_t dst, const void* src, uint32_t bytes,
                                             uint32_t bar, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1], %2, [%3], %4;\n" ::"r"(dst), "l"(src), "r"(bytes), "r"(bar), "h"(mask)
      : "memory");
}

// A read-only global load issued where it stands: asm volatile keeps the
// compiler from sinking it past the waits that follow to its first use.
__device__ __forceinline__ float ld_nc(const float* p) {
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];\n" : "=f"(v) : "l"(p));
  return v;
}

// Bring the 128-byte line holding *p into L2 (no register, no wait).
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// Cooperative-launch checks shared by the two bf16 kernels: the device can
// run a cooperative grid of `grid` blocks of `threads` threads with `smem`
// bytes of dynamic shared memory, one resident block per SM at most.
inline cudaError_t check_cooperative(const void* kern, int grid, int threads, size_t smem) {
  int dev, nsm, coop, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if (!coop || smem > (size_t)smem_max) return cudaErrorInvalidValue;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem)))
    return err;
  if (per_sm * nsm < grid) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace lstm_mma
