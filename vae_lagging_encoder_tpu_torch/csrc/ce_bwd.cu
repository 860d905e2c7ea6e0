// Backward of the fused vocab projection + cross-entropy, for Hopper (sm_90a).
//
// Replaces the VJP of the JAX package's Pallas kernel ops/ce_pallas.py::_ce_kernel,
// _fused_ce_bwd (ops/ce_pallas.py:217), which XLA runs as two dots. From the
// grad-mode forward's residuals (ce_fwd.cu with save_logits = 1: the logits
// rounded to bf16, the spill; lse, the logsumexp of those rounded logits; tgt)
// and the gradient g [N] of logp:
//   d[n, v] = bf16_rn((1[v == tgt[n]] - exp(spill[n, v] - lse[n])) * g[n])  (v < V; 0 past V)
//   dh = d W^T [N, nh],   dW = h^T d [nh, V]
// with h and W rounded to bf16 and f32 accumulation and output, the function
// JAX's dots with preferred_element_type=float32 compute.
//
// What bounds it on the H100: 4 N nh V operations, 0.252 ms at the training
// shape (N 3040, nh 1024, V 20004) and 5.04 ms at --nsamples 40's N 60800 at
// the dense bf16 rate. The function's own bytes (the spill, h and W in, dh
// and dW out) take at most a third of that at 3.35 TB/s. This design adds
// the d pass (the spill in, d out: 0.25 GB at N 3040, 4.9 GB at N 60800,
// ~0.07 and ~1.5 ms on their own) and the products' reads of d, which run
// under their own tensor-core time.
//
// Design:
// - ce_bwd_d_kernel, one elementwise pass, writes d [N, Vp] bf16 once (Vp = V
//   rounded up to 256), zeros past V: the forward's zero-padded W^T columns
//   make those logits 0, and exp(0 - lse) must not leak into d (the [:, :V]
//   slice of _fused_ce_bwd). d is formed by the f32 operations of
//   ops/ce_cuda.py::ce_backward_plain in the same order (expf, not __expf),
//   so both products read the plain version's operands bit for bit.
// - ce_bwd_gemm_kernel computes one 128 x 256 f32 tile of C = A B over a
//   range of 64-deep K slabs: two consumer warpgroups of 64 rows issue
//   wgmma m64n256k16 (bf16 in, f32 accumulate, 128 registers a thread) on a
//   4-stage ring of 128-byte-swizzled tiles that one producer warp fills by
//   TMA (a full and an empty mbarrier per stage). TMA zero-fills past N, nh
//   and Vp, so ragged edges need no masks until the stores.
//     dh (kAMN = false): A = d, K-major (one box of 64 v x 128 rows); B = the
//       forward's packed W^T [Vp, Kp] (ce_fwd.cu's B operand), MN-major:
//       four boxes of 64 nh-columns x 64 v, read with the transpose bit.
//     dW (kAMN = true): A = h^T, MN-major from bf16 h [N, ldh] (a box of 64
//       nh-columns x 64 rows for each warpgroup); B = d, MN-major (four boxes
//       of 64 v x 64 rows).
// - Filling the card: dh has cdiv(N, 128) x cdiv(nh, 256) tiles (96 at
//   N 3040, on 132 SMs) against K = Vp (316 slabs), so its K is split over
//   `splits` blocks (ops/ce_cuda.py::ce_bwd_plan, checked here) that write
//   f32 partials part [splits, N, nh]; ce_bwd_merge_kernel sums them in split
//   order. dW has cdiv(nh, 128) x Vp / 256 tiles (632) against K = N: no
//   split. Blocks are numbered so that the blocks resident together share d:
//   dh's nh tiles of one row tile, dW's nh tiles of one vocab tile.
// - Deterministic: no atomics, and every sum runs in one fixed order.

#include <math.h>

#include "ce_wgmma.cuh"

namespace {
namespace wg = lstm_wgmma;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kWarpgroups = 2;                          // consumer warpgroups of 64 rows
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;               // + one producer warp
constexpr int kBM = 64 * kWarpgroups, kBN = 256, kBK = 64;
constexpr int kStages = 4;                              // ring depth
constexpr int kBox = 64 * kBK * 2;                      // one 64 x 64 bf16 TMA box: 8 KB
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAlign = 1024;                            // the 128-byte swizzle's period
constexpr int kSmemBytes = kAlign + kStages * kStageBytes + 2 * kStages * 8;
constexpr int kDThreads = 256;                          // the d pass: a row a block
static_assert(kABytes == kWarpgroups * kBox && kBBytes == (kBN / 64) * kBox, "whole boxes");

// d [N, Vp] from the spill (16-byte-aligned rows lds >= V apart), lse, tgt
// and g, as ce_backward_plain forms it.
__global__ void __launch_bounds__(kDThreads)
ce_bwd_d_kernel(const __nv_bfloat16* __restrict__ spill, int lds, const float* __restrict__ lse,
                const int* __restrict__ tgt, const float* __restrict__ g,
                __nv_bfloat16* __restrict__ d, int V, int Vp) {
  const int n = blockIdx.x;
  const __nv_bfloat16* src = spill + (size_t)n * lds;
  __nv_bfloat16* dst = d + (size_t)n * Vp;
  const float l = lse[n], gn = g[n];
  const int t = tgt[n];
  for (int c = threadIdx.x * 8; c < Vp; c += kDThreads * 8) {
    float x[8];
    if (c >= V) {
#pragma unroll
      for (int e = 0; e < 8; ++e) x[e] = 0.f;
    } else {  // within the row: lds is a multiple of 8 and >= V > c
      const uint4 u = *reinterpret_cast<const uint4*>(src + c);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        x[2 * e] = f.x;
        x[2 * e + 1] = f.y;
      }
    }
    __align__(16) __nv_bfloat16 out[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float r = 0.f;
      if (c + e < V) {
        const float p = expf(x[e] - l);
        r = c + e == t ? (1.f - p) * gn : -(p * gn);
      }
      out[e] = __float2bfloat16_rn(r);
    }
    *reinterpret_cast<uint4*>(dst + c) = *reinterpret_cast<const uint4*>(out);
  }
}

// out[i] = sum over s = 0, 1, ..., splits - 1 of part[s][i], in that order.
__global__ void ce_bwd_merge_kernel(const float* __restrict__ part, int splits, size_t plane,
                                    float* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < plane;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s += part[(size_t)k * plane + i];
    out[i] = s;
  }
}

// C [M, Nc] (row stride ldo) = A [M, K] B [K, Nc] over the K slabs of this
// block's split; split s writes its plane out + s M ldo. Block b: split
// b / tiles; tile b % tiles, the m tiles of one n tile consecutive (kAMN,
// dW) or the n tiles of one m tile (dh).
template <bool kAMN>
__global__ void __launch_bounds__(kThreads, 1)
ce_bwd_gemm_kernel(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_b, float* __restrict__ out, int M,
                   int Nc, int ldo, int KS, int tiles_m, int tiles_n, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };

  const int tiles = tiles_m * tiles_n, b = blockIdx.x % tiles, split = blockIdx.x / tiles;
  const int mt = kAMN ? b % tiles_m : b / tiles_n, nt = kAMN ? b / tiles_m : b % tiles_n;
  const int m0 = mt * kBM, n0 = nt * kBN;
  const int k0 = (int)((long long)split * KS / splits);
  const int nk = (int)((long long)(split + 1) * KS / splits) - k0;
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full_bar(s), 1);
      wg::mbar_init(empty_bar(s), kWarpgroups);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: slab i into slot i % kStages once both warpgroups have
    // released that slot's previous slab
    if (tid == kConsumers) {
      for (int i = 0; i < nk; ++i) {
        const int s = i % kStages, use = i / kStages, kc = (k0 + i) * kBK;
        if (use > 0) wg::mbar_wait(empty_bar(s), (use - 1) & 1);
        const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
        wg::mbar_arrive_tx(full_bar(s), kStageBytes);
        if (kAMN) {
#pragma unroll
          for (int w = 0; w < kWarpgroups; ++w)
            wg::tma_load_2d(sa + w * kBox, &tm_a, m0 + 64 * w, kc, full_bar(s));
        } else {
          wg::tma_load_2d(sa, &tm_a, kc, m0, full_bar(s));
        }
#pragma unroll
        for (int q = 0; q < kBN / 64; ++q)
          wg::tma_load_2d(sb + q * kBox, &tm_b, n0 + 64 * q, kc, full_bar(s));
      }
    }
    return;  // no block-wide barrier follows
  }

  const int w = tid >> 7, lt = tid & 127, warp = lt >> 5, lane = tid & 31;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  // K loop: only wgmma touches the accumulators, so one group stays in
  // flight while the next slab's wait runs
  for (int i = 0; i < nk; ++i) {
    const int s = i % kStages;
    wg::mbar_wait(full_bar(s), (i / kStages) & 1);
    // this warpgroup's 64 rows of A: a K-major box half or its own MN-major box
    const uint32_t sa = ring + s * kStageBytes + w * (kABytes / kWarpgroups);
    const uint32_t sb = ring + s * kStageBytes + kABytes;
    wg::wgmma_fence();
#pragma unroll
    for (int k16 = 0; k16 < kBK / 16; ++k16) {
      const uint64_t da = kAMN ? ce_wgmma::sw128_mn_desc(sa + k16 * ce_wgmma::kMnK16Bytes, kBox)
                               : wg::sw128_desc(sa + k16 * 32);
      ce_wgmma::wgmma_m64n256k16<kAMN ? 1 : 0, 1>(
          acc, da, ce_wgmma::sw128_mn_desc(sb + k16 * ce_wgmma::kMnK16Bytes, kBox), 1);
    }
    wg::wgmma_commit();
    wg::wgmma_wait<1>();  // slab i - 1 has been read
    if (i > 0 && lt == 0) wg::mbar_arrive(empty_bar((i - 1) % kStages));
    __syncwarp();
  }
  wg::wgmma_wait<0>();
  wg::fence_acc(acc);

  // this thread's pairs: rows m0 + 64 w + 16 warp + lane / 4 + 8 hh, columns
  // n0 + 8 i + 2 (lane % 4) + {0, 1}
  float* o = out + (size_t)split * M * ldo;
  const bool vec = ldo % 2 == 0 && reinterpret_cast<uintptr_t>(o) % 8 == 0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = m0 + 64 * w + 16 * warp + (lane >> 2) + 8 * hh;
    if (row >= M) continue;
    float* orow = o + (size_t)row * ldo;
#pragma unroll
    for (int i = 0; i < kBN / 8; ++i) {
      const int col = n0 + 8 * i + 2 * (lane & 3);
      const float x0 = acc[4 * i + 2 * hh], x1 = acc[4 * i + 2 * hh + 1];
      if (vec && col + 1 < Nc) {
        *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < Nc) orow[col] = x0;
        if (col + 1 < Nc) orow[col + 1] = x1;
      }
    }
  }
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// spill: the grad-mode logits, bf16, 16-byte-aligned rows lds >= V elements
// apart (the forward's [N, Vp] buffer); lse, g [N] f32, tgt [N] int32 in [0, V); hb
// [N, ldh] bf16 (h rounded, ldh >= nh, ldh % 8 == 0) and wt [Vp, Kp] bf16
// (W^T rounded, zero past nh and V): the forward's operands. Writes d [N, Vp]
// bf16 (scratch), dh [N, nh] and dw [nh, V] f32; part [splits, N, nh] f32 is
// scratch when splits > 1. The launch plan (ops/ce_cuda.py::ce_bwd_plan):
// block_m, block_n, block_k, stages (the tile and ring this kernel was built
// for), splits (of dh's K), dh_blocks, dw_blocks, smem_bytes; it is checked
// here and refused with cudaErrorInvalidValue when it does not fit. Returns
// a cudaError_t.
int ce_bwd_bf16(const void* spill, int lds, const float* lse, const int* tgt, const float* g,
                const void* hb, const void* wt, void* d, float* part, float* dh, float* dw,
                int N, int nh, int V, int ldh, int Vp, int Kp, int block_m, int block_n,
                int block_k, int stages, int splits, int dh_blocks, int dw_blocks,
                int smem_bytes, void* stream) {
  const int KS = Vp / kBK, dh_tm = cdiv(N, kBM), dh_tn = cdiv(nh, kBN);
  const int dw_tm = cdiv(nh, kBM), dw_tn = Vp / kBN;
  if (N < 1 || nh < 1 || V < 1 || block_m != kBM || block_n != kBN || block_k != kBK
      || stages != kStages || smem_bytes != kSmemBytes || Vp != cdiv(V, kBN) * kBN
      || Kp != cdiv(nh, kBK) * kBK || ldh < nh || ldh % 8 || lds < V || lds % 8 || splits < 1
      || splits > KS || dh_blocks != dh_tm * dh_tn * splits || dw_blocks != dw_tm * dw_tn
      || (splits > 1 && !part) || !spill || !lse || !tgt || !g || !dh || !dw
      || !aligned16(spill) || !aligned16(hb) || !aligned16(wt) || !aligned16(d))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ce_bwd_d_kernel<<<N, kDThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(spill), lds, lse,
                                          tgt, g, static_cast<__nv_bfloat16*>(d), V, Vp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_d_rows, tm_wt, tm_h, tm_d_cols;
  // dh's A: d, K-major (64 v x 128 rows); dh's B: W^T, MN-major (64 nh x 64 v)
  if ((err = wg::encode_2d(&tm_d_rows, bf, d, Vp, N, 2 * (uint64_t)Vp, kBK, kBM, sw))
      || (err = wg::encode_2d(&tm_wt, bf, wt, Kp, Vp, 2 * (uint64_t)Kp, 64, kBK, sw))
      // dW's A: h, MN-major (64 nh x 64 rows); dW's B: d, MN-major (64 v x 64 rows)
      || (err = wg::encode_2d(&tm_h, bf, hb, nh, N, 2 * (uint64_t)ldh, 64, kBK, sw))
      || (err = wg::encode_2d(&tm_d_cols, bf, d, Vp, N, 2 * (uint64_t)Vp, 64, kBK, sw)))
    return err;
  if ((err = cudaFuncSetAttribute(ce_bwd_gemm_kernel<false>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes))
      || (err = cudaFuncSetAttribute(ce_bwd_gemm_kernel<true>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes)))
    return err;
  ce_bwd_gemm_kernel<false><<<dh_blocks, kThreads, kSmemBytes, s>>>(
      tm_d_rows, tm_wt, splits > 1 ? part : dh, N, nh, nh, KS, dh_tm, dh_tn, splits);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (splits > 1) {
    const size_t plane = (size_t)N * nh;
    const int grid = plane / 256 + 1 < 4096 ? (int)(plane / 256 + 1) : 4096;
    ce_bwd_merge_kernel<<<grid, 256, 0, s>>>(part, splits, plane, dh);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  ce_bwd_gemm_kernel<true><<<dw_blocks, kThreads, kSmemBytes, s>>>(
      tm_h, tm_d_cols, dw, nh, V, V, cdiv(N, kBK), dw_tm, dw_tn, 1);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
