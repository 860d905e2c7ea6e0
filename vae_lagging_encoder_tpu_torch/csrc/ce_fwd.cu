// Fused vocab projection + cross-entropy forward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/ce_pallas.py::_ce_kernel
// in both its forms: for h [N, nh], W [nh, V], tgt [N]
//   logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v],   lse[n] = logsumexp
// as an online (max, sum of exp, target logit) over vocab tiles, with the
// ragged last tile masked out (the TPU kernel's -1e30).
//   - forward form (ce_fwd, save_logits = 0): no [N, V] array ever reaches
//     device memory;
//   - grad mode (ce_fwd_train, save_logits = 1; the TPU kernel with
//     save_logits=True): each logits tile is also written, rounded to the
//     operand type (bf16), into the residual spill, and a second running sum s2 of exp(rounded - running max) over
//     the real columns gives lse[n] = m + log(s2), the logsumexp of the
//     ROUNDED logits, so that the backward's exp(spill - lse) rows sum to
//     exactly 1; logp keeps the unrounded m + log(s).
//
// What bounds it on the H100: 2*N*nh*V operations (2.5 TFLOP per call at the
// IW decoder's N = 640*95, nh = 1024, V = 20004: 2.5 ms at the dense bf16
// rate), against which the inputs are small (h 124 MB, W 41 MB in bf16);
// grad mode also writes the bf16 spill (2.5 GB at that N, 0.73 ms at
// 3.35 TB/s, under the products). Feeding the tensor cores from L2 is the
// design's problem: a 128 x 256 tile needs 48 KB of operands for each
// 64-deep slab of products (1024 SM clocks at the dense rate), 11 TB/s over
// 132 SMs, more than the L2 delivers. The design:
//
// - Units and the persistent schedule (ops/ce_cuda.py::CEPlan, checked
//   here): a unit is a row group (256 rows: two 128-row tiles) x one vocab
//   tile of BN = 256 columns; the grid is the clusters of 2 blocks the card
//   holds at once (cudaOccupancyMaxActiveClusters), and cluster c walks the
//   contiguous units [c U / G, (c + 1) U / G), numbered row group major, so
//   a row group's vocab range may be split between clusters at any tile.
//   Within a row group the vocab tiles are visited from the tile that the
//   cluster holding the group's last unit reaches first, so the clusters
//   resident together walk the same few W^T tiles at each step (W^T, 41 MB,
//   stays in L2).
// - The cluster's two blocks take the two row tiles of the group and every
//   vocab tile together: each block brings one half (128 vocab rows, two
//   boxes) of each 64-deep W^T slab by TMA and multicasts it to both
//   (tma_load_2d_mc), so W^T is read from L2 once for 256 rows: 32 KB a
//   slab from L2 into each SM where a block alone reads 48.
// - One producer warp issues every copy into a 4-stage ring of 48 KB slabs
//   (the block's 128 rows of h, 16 KB, zero-filled past N and nh by TMA;
//   the 256-row W^T slab): a full and an empty mbarrier per stage, the
//   empty one counting a release from each of the cluster's four consumer
//   warpgroups. Three slabs (3000 SM clocks of products) are in flight
//   while one is multiplied. Shared memory 197,696 bytes, one block an SM.
// - Two consumer warpgroups of 64 rows each issue wgmma.mma_async
//   m64n256k16 (bf16 in, f32 accumulate in 128 registers a thread; A and B
//   both K-major through 128-byte-swizzle descriptors) on every slab, then
//   both run the tile's epilogue while the producer refills the ring, so
//   the next unit's products start from a full ring. Designs that kept a
//   64-row tile of h resident in shared memory (128 KB) and streamed only
//   W^T through the 96 KB left were slower on an H100 at N 60800: one
//   warpgroup 6.34 / 7.54 ms, two taking units in turns ("ping-pong", one's
//   epilogue under the other's products) 5.05 / 5.84 ms, against 4.17 /
//   5.54 for this one (forward / grad mode, ce_ablation.py): the copies'
//   round trip through the cluster's handshake needs more bytes in flight
//   than that ring held. Four consumer warpgroups of 64 x 128 shortened the
//   epilogue but spilled registers and came out even.
// - The epilogue is kept short: no mask on a tile below V, the max as a
//   tree, the sums in four parts, and in grad mode the sum of the rounded
//   logits' exponentials from the unrounded ones' times a Taylor series of
//   exp(rounded - unrounded) on the FMA pipe, not a second pass through the
//   exponential unit.
// - Epilogue from registers: the accumulator layout gives the 4 lanes of a
//   quad a whole row of the tile (lane t: columns 8i + 2t, 8i + 2t + 1), so
//   each lane keeps its own running (max, sum, sum of the rounded, target
//   logit) per row and the quad merges them at the end of the row group's
//   segment. In grad mode the spill [N, Vp] (returned as the [:, :V] view;
//   Vp = V rounded up to 256 columns, ce_bwd.cu's tile, which reads it)
//   leaves as 16-byte stores of 8 columns, after a 4 x 4 transpose of bf16
//   pairs within the quad (two rounds of shuffles).
// - Each (cluster, row group) segment writes its partial (m, s, s2, t) per
//   row to part [4, slots, 256] at slot c + rg (one slot per segment: c + rg
//   differs for every pair that meets); ce_merge_kernel sums them per row
//   in segment order: no atomics, the same bits every call.
// - B is W made K-major, rounded to bf16 and zero-padded, W^T [Vp, Kp] (Kp
//   = nh rounded up to 64), packed by a first small kernel
//   (ce_pack_wt_kernel, ~41 MB written) in the same call, because a bf16 row
//   of W itself (V = 20004: 40,008 bytes) is not 16-byte aligned for TMA;
//   ce_bwd.cu reads the same W^T as its B operand.
//
// f32 operands (mxu_dtype=None, the full-precision mode) take ce_f32.cu's
// kernel: exact f32 products on the FMA pipes (tensor cores have no exact
// f32 product), persistent over the card's blocks, a TMA ring, and the
// same per-segment partials merged in a fixed order.

#include <cooperative_groups.h>
#include <math.h>

#include <type_traits>

#include "ce_wgmma.cuh"

namespace {
namespace cg = cooperative_groups;
namespace wg = lstm_wgmma;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------- bf16 path
constexpr int kWarpgroups = 2;                 // consumer warpgroups of 64 rows
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32;      // + one producer warp
constexpr int kBM = 64 * kWarpgroups, kBN = 256, kBK = 64;  // a block's tile; K slab
constexpr int kStages = 4;                     // ring depth
constexpr int kCluster = 2;                    // blocks of a cluster: the row tiles of a row group
constexpr int kGroupRows = kBM * kCluster;
constexpr int kBox = 64 * kBK * 2;             // one 64 x 64 bf16 TMA box: 8 KB
constexpr int kABytes = kBM * kBK * 2;         // the block's rows of h: 16 KB, two boxes
constexpr int kBBytes = kBN * kBK * 2;         // a W^T slab: 32 KB, two boxes from each block
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAlign = 1024;                   // the 128-byte swizzle repeats every 8 rows
constexpr int kSmemBytes = kAlign + kStages * kStageBytes + 8 * 2 * kStages;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kABytes == 2 * kBox && kBBytes == 2 * kCluster * kBox, "whole boxes");

// The persistent schedule of ops/ce_cuda.py::CEPlan: U units (row group
// major, nv vocab tiles each) over G clusters.
struct Schedule {
  int U, G, nv;
  // first unit of cluster c (c = G: U)
  __host__ __device__ int first(int c) const { return (int)((long long)c * U / G); }
  // the cluster whose range holds unit u
  __host__ __device__ int cluster_of(int u) const {
    return (int)(((long long)(u + 1) * G - 1) / U);
  }
  // the unit from which row group rg's vocab tiles are counted: the first of
  // the cluster that holds the group's last unit
  __host__ __device__ int origin(int rg) const { return first(cluster_of((rg + 1) * nv - 1)); }
  __host__ __device__ int vocab_tile(int u, int origin_u) const {
    return ((u - origin_u) % nv + nv) % nv;
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
// exp(d) for a small d: 1 + d + d^2 / 2 + d^3 / 6 + d^4 / 24
__device__ __forceinline__ float taylor_exp(float d) {
  return fmaf(d, fmaf(d, fmaf(d, fmaf(d, 1.f / 24.f, 1.f / 6.f), 0.5f), 1.f), 1.f);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Lane tq of a quad holds w[k], the bf16 pair of columns 8 (4a + k) + 2 tq,
// + 1 of its row (k < 4); returns lane q's w[tq] for q = 0..3: columns
// 8 (4a + tq) .. + 7 in order. A 4 x 4 transpose in two rounds: the 2 x 2
// blocks across lanes tq ^ 2, then the pairs within them across tq ^ 1.
__device__ __forceinline__ uint4 quad_transpose(uint32_t w0, uint32_t w1, uint32_t w2,
                                                uint32_t w3, int tq) {
  const bool b1 = tq & 2, b0 = tq & 1;
  uint32_t x0 = b1 ? w0 : w2, x1 = b1 ? w1 : w3;
  x0 = __shfl_xor_sync(0xffffffffu, x0, 2);
  x1 = __shfl_xor_sync(0xffffffffu, x1, 2);
  if (b1) w0 = x0, w1 = x1;
  else w2 = x0, w3 = x1;
  uint32_t y0 = b0 ? w0 : w1, y1 = b0 ? w2 : w3;
  y0 = __shfl_xor_sync(0xffffffffu, y0, 1);
  y1 = __shfl_xor_sync(0xffffffffu, y1, 1);
  if (b0) w0 = y0, w2 = y1;
  else w1 = y0, w3 = y1;
  return make_uint4(w0, w1, w2, w3);
}

// h [N, ldh] and W^T [Vp, Kp] bf16 through their tensor maps (64 x 64
// boxes, SWIZZLE_128B), tgt [N]; spill [N, Vp] bf16 (grad mode); part
// [4, slots, 256] f32: the segments' partials (m, s, s2, t).
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
ce_bf16_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_wt,
               const int* __restrict__ tgt, __nv_bfloat16* __restrict__ spill,
               float* __restrict__ part, int N, int V, int Vp, int KS, int nv, int units,
               int clusters, int slots) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring = (wg::smem_u32(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const uint32_t bars = ring + kStages * kStageBytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };

  const Schedule sch{units, clusters, nv};
  const int c = blockIdx.x / kCluster, rank = (int)cluster.block_rank();
  const int u0 = sch.first(c), u1 = sch.first(c + 1);
  const int rg0 = u0 / nv, rg1 = (u1 - 1) / nv;  // the row groups of this cluster's range
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full_bar(s), 1);
      wg::mbar_init(empty_bar(s), kWarpgroups * kCluster);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();
  cluster.sync();  // both blocks' barriers, before the other block's copies and arrivals

  if (tid >= kConsumers) {
    // the producer: slab g of the range into slot g % kStages once all four
    // warpgroups of the cluster have released its previous slab: this
    // block's 128 rows of h (two boxes) and its half of the W^T slab (two
    // boxes of 64 vocab rows), multicast to both blocks
    if (tid == kConsumers) {
      int g = 0;
      for (int rg = rg0; rg <= rg1; ++rg) {
        const int lo = max(u0, rg * nv), hi = min(u1, (rg + 1) * nv), b = sch.origin(rg);
        const int row = rg * kGroupRows + rank * kBM;
        for (int u = lo; u < hi; ++u) {
          const int col = sch.vocab_tile(u, b) * kBN + rank * (kBN / kCluster);
          for (int ks = 0; ks < KS; ++ks, ++g) {
            const int s = g % kStages;
            if (g >= kStages) wg::mbar_wait(empty_bar(s), (g / kStages - 1) & 1);
            const uint32_t sa = ring + s * kStageBytes, sb = sa + kABytes;
            wg::mbar_arrive_tx(full_bar(s), kStageBytes);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              wg::tma_load_2d(sa + q * kBox, &tm_h, ks * kBK, row + 64 * q, full_bar(s));
              wg::tma_load_2d_mc(sb + (2 * rank + q) * kBox, &tm_wt, ks * kBK, col + 64 * q,
                                 full_bar(s), (uint16_t)((1 << kCluster) - 1));
            }
          }
        }
      }
    }
    __syncwarp();
  } else {
    const int w = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31, tq = lane & 3;
    const bool leader = (tid & 127) == 0;
    // a slab is free once all four warpgroups of the cluster are done with it
    auto release = [&](int s) {
      wg::mbar_arrive(empty_bar(s));
      wg::mbar_arrive_rank_relaxed(empty_bar(s), (uint32_t)(rank ^ 1));
    };
    // this thread's rows within the group: rl + 8 hh
    const int rl = rank * kBM + w * 64 + warp * 16 + (lane >> 2);
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

    for (int rg = rg0; rg <= rg1; ++rg) {
      const int lo = max(u0, rg * nv), hi = min(u1, (rg + 1) * nv), b = sch.origin(rg);
      int row[2], trg[2];
      float m_run[2], s_run[2], s2_run[2], t_run[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        row[hh] = rg * kGroupRows + rl + 8 * hh;
        trg[hh] = row[hh] < N ? tgt[row[hh]] : -1;
        m_run[hh] = -INFINITY;
        s_run[hh] = s2_run[hh] = t_run[hh] = 0.f;
      }

      // the finished logits tile at column col0: this lane's columns of its
      // two rows (register 4 i + 2 hh + e: column 8 i + 2 tq + e of row hh);
      // the max and the sums as trees and four partial sums, so that no long
      // chain of dependent instructions holds the tensor cores idle
      auto epilogue = [&](int col0) {
        if (kSave) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int a = 0; a < kBN / 32; ++a) {
              const uint4 v = quad_transpose(
                  pack_bf16(acc[16 * a + 2 * hh], acc[16 * a + 2 * hh + 1]),
                  pack_bf16(acc[16 * a + 4 + 2 * hh], acc[16 * a + 4 + 2 * hh + 1]),
                  pack_bf16(acc[16 * a + 8 + 2 * hh], acc[16 * a + 8 + 2 * hh + 1]),
                  pack_bf16(acc[16 * a + 12 + 2 * hh], acc[16 * a + 12 + 2 * hh + 1]), tq);
              if (row[hh] < N)
                *reinterpret_cast<uint4*>(spill + (size_t)row[hh] * Vp + col0 + 32 * a + 8 * tq) =
                    v;
            }
        }
        // the last tile: its columns past V to -inf (the accumulators are
        // overwritten by the next unit's first product); the others have none
        if (col0 + kBN > V) {
#pragma unroll
          for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (col0 + 8 * i + 2 * tq + e >= V) acc[4 * i + e] = acc[4 * i + 2 + e] = -INFINITY;
        }
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float t[kBN / 16];
#pragma unroll
          for (int k = 0; k < kBN / 16; ++k)
            t[k] = fmaxf(fmaxf(acc[8 * k + 2 * hh], acc[8 * k + 2 * hh + 1]),
                         fmaxf(acc[8 * k + 4 + 2 * hh], acc[8 * k + 4 + 2 * hh + 1]));
#pragma unroll
          for (int n = kBN / 32; n >= 1; n /= 2)
#pragma unroll
            for (int k = 0; k < n; ++k) t[k] = fmaxf(t[k], t[k + n]);
          const float lm = t[0];
          if ((unsigned)(trg[hh] - col0) < (unsigned)kBN) {
#pragma unroll
            for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                if (col0 + 8 * i + 2 * tq + e == trg[hh]) t_run[hh] += acc[4 * i + 2 * hh + e];
          }
          if (lm == -INFINITY) continue;  // no real column of this tile in this lane
          const float mn = fmaxf(m_run[hh], lm), ml = mn * kLog2e;
          float ss[4] = {0.f, 0.f, 0.f, 0.f}, ss2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float x = acc[4 * i + 2 * hh + e];
              const float p = ex2(fmaf(x, kLog2e, -ml));  // 0 past V
              ss[(2 * i + e) & 3] += p;
              // exp(bf16(x) - mn) = p exp(d), d = bf16(x) - x (exact, |d| <= 2^-8 |x|)
              // by its Taylor series to d^4 (d^5 / 120 < 1e-8 at |x| <= 16): on
              // the FMA pipe, not the exponential unit's, which p keeps busy;
              // past V (x = -inf, d = NaN, p = 0) the max makes d finite
              if (kSave) ss2[(2 * i + e) & 3] += p * taylor_exp(fmaxf(round_bf16(x) - x, -1.f));
            }
          const float sc = ex2((m_run[hh] - mn) * kLog2e);  // 0 while m_run is -inf
          s_run[hh] = s_run[hh] * sc + ((ss[0] + ss[1]) + (ss[2] + ss[3]));
          if (kSave) s2_run[hh] = s2_run[hh] * sc + ((ss2[0] + ss2[1]) + (ss2[2] + ss2[3]));
          m_run[hh] = mn;
        }
      };

      for (int u = lo; u < hi; ++u) {
        const int g0 = (u - u0) * KS;
        // K loop: only wgmma touches the accumulators here, so one group
        // stays in flight while the next slab's wait runs
        for (int ks = 0; ks < KS; ++ks) {
          const int g = g0 + ks, s = g % kStages;
          wg::mbar_wait(full_bar(s), (g / kStages) & 1);
          const uint32_t a = ring + s * kStageBytes + w * kBox, bw = ring + s * kStageBytes + kABytes;
          wg::wgmma_fence();
#pragma unroll
          for (int k16 = 0; k16 < kBK / 16; ++k16)
            ce_wgmma::wgmma_m64n256k16<0, 0>(acc, wg::sw128_desc(a + k16 * 32),
                                             wg::sw128_desc(bw + k16 * 32), (ks | k16) != 0);
          wg::wgmma_commit();
          wg::wgmma_wait<1>();  // slab g - 1 has been read
          if (ks > 0 && leader) release((g - 1) % kStages);
          __syncwarp();
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(acc);
        if (leader) release((g0 + KS - 1) % kStages);
        __syncwarp();
        epilogue(sch.vocab_tile(u, b) * kBN);
      }

      // merge the quad's four lanes of each row; one lane writes the partial
      const int slot = c + rg;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float M = m_run[hh];
        M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 1));
        M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
        const float sc = m_run[hh] == -INFINITY ? 0.f : __expf(m_run[hh] - M);
        float s = s_run[hh] * sc, s2 = s2_run[hh] * sc, t = t_run[hh];
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, o);
          s2 += __shfl_xor_sync(0xffffffffu, s2, o);
          t += __shfl_xor_sync(0xffffffffu, t, o);
        }
        if (tq != 0 || row[hh] >= N) continue;
        const size_t plane = (size_t)slots * kGroupRows;
        const size_t o = (size_t)slot * kGroupRows + rl + 8 * hh;
        part[o] = M;
        part[plane + o] = s;
        part[2 * plane + o] = s2;
        part[3 * plane + o] = t;
      }
    }
  }
  cluster.sync();  // neither block leaves while the other may still arrive on its barriers
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// W [nh, V] (f32 or bf16) -> W^T [Vp, Kp] bf16, rounded to nearest even as
// torch's .to(bfloat16), zero past nh and V; 32 x 32 tiles through shared
// memory so that the reads and the writes are both row-contiguous.
template <typename Tin>
__global__ void __launch_bounds__(256)
ce_pack_wt_kernel(const Tin* __restrict__ w, __nv_bfloat16* __restrict__ wt, int nh, int V,
                  int Kp) {
  __shared__ float tile[32][33];
  const int v0 = blockIdx.x * 32, k0 = blockIdx.y * 32, tx = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < 32; r += 8) {
    const int k = k0 + r, v = v0 + tx;
    tile[r][tx] = (k < nh && v < V) ? to_float(w[(size_t)k * V + v]) : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < 32; r += 8)
    wt[(size_t)(v0 + r) * Kp + k0 + tx] = __float2bfloat16_rn(tile[tx][r]);
}

// The segments' partials part [4, slots, 256] (m, s, s2, t) -> logp, lse:
// row n of row group rg sums the partials of the clusters that hold a unit
// of rg, in cluster order: M = max m_i, s = sum s_i exp(m_i - M).
__global__ void ce_merge_kernel(const float* __restrict__ part, int N, int nv, int units,
                                int clusters, int slots, float* __restrict__ logp,
                                float* __restrict__ lse, int save) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const Schedule sch{units, clusters, nv};
  const int rg = n / kGroupRows, r = n % kGroupRows;
  const int c0 = sch.cluster_of(rg * nv), c1 = sch.cluster_of((rg + 1) * nv - 1);
  const size_t plane = (size_t)slots * kGroupRows;
  auto at = [&](int c) { return (size_t)(c + rg) * kGroupRows + r; };
  float M = -INFINITY;
  for (int c = c0; c <= c1; ++c) M = fmaxf(M, part[at(c)]);
  float sum = 0.f, sum2 = 0.f, t = 0.f;
  for (int c = c0; c <= c1; ++c) {
    const size_t o = at(c);
    const float sc = expf(part[o] - M);
    sum += part[plane + o] * sc;
    sum2 += part[2 * plane + o] * sc;
    t += part[3 * plane + o];
  }
  const float l = M + logf(sum);
  lse[n] = save ? M + logf(sum2) : l;
  logp[n] = t - l;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Clusters of the bf16 kernel (both modes) that the card holds at once with
// smem bytes of dynamic shared memory a block.
cudaError_t bf16_clusters(size_t smem, int* clusters) {
  int a = 0, b = 0;
  cudaError_t err = wg::cluster_blocks(ce_bf16_kernel<true>, kThreads, smem, kCluster, &a);
  if (err == cudaSuccess)
    err = wg::cluster_blocks(ce_bf16_kernel<false>, kThreads, smem, kCluster, &b);
  *clusters = (a < b ? a : b) / kCluster;
  return err;
}

}  // namespace

extern "C" {

// bf16 operands, both modes. h [N, ldh] bf16 (ldh >= nh, ldh % 8 == 0,
// 16-byte aligned), w [nh, V] f32 (w_f32 = 1) or bf16, tgt [N] int32 in
// [0, V). Writes wt [Vp, Kp] bf16 (W^T rounded to bf16, zero-padded: the
// products' B operand, and ce_bwd.cu's), logp [N] and lse [N] (f32) and,
// when save_logits, spill [N, Vp] bf16 (the rounded logits, zero past V;
// lse of the rounded ones); part [4, slots, 256] f32 is scratch. The
// launch plan (ops/ce_cuda.py::CEPlan): block_m, block_n, block_k, stages,
// cluster (the tiles, ring and cluster this kernel was built for), clusters
// (the persistent grid, at most what the card holds at once: more are
// refused), slots, smem_bytes; it is checked here and refused with
// cudaErrorInvalidValue when it does not fit. Returns a cudaError_t.
int ce_fwd_bf16(const void* h, const void* w, void* wt, const int* tgt, float* logp,
                float* lse, void* spill, float* part, int N, int nh, int V, int ldh, int Vp,
                int Kp, int w_f32, int save_logits, int block_m, int block_n, int block_k,
                int stages, int cluster, int clusters, int slots, int smem_bytes, void* stream) {
  const int nv = cdiv(V, kBN), groups = cdiv(N, kGroupRows);
  const long long units = (long long)groups * nv;
  if (N < 1 || nh < 1 || V < 1 || block_m != kBM || block_n != kBN || block_k != kBK
      || stages != kStages || cluster != kCluster || units > 0x7fffffff || ldh < nh || ldh % 8
      || Vp != nv * kBN || Kp != cdiv(nh, kBK) * kBK || clusters < 1
      || clusters > units || slots != clusters + groups - 1 || smem_bytes != kSmemBytes
      || !aligned16(h) || !aligned16(wt) || !w
      || !tgt || !logp || !lse || !part || (save_logits && (!spill || !aligned16(spill))))
    return cudaErrorInvalidValue;
  int capacity = 0;
  cudaError_t err = bf16_clusters(smem_bytes, &capacity);
  if (err != cudaSuccess) return err;
  if (clusters > capacity) return cudaErrorInvalidValue;  // not resident at once: not this card's plan
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wb = static_cast<__nv_bfloat16*>(wt);
  const dim3 pack_grid(Vp / 32, Kp / 32);
  if (w_f32)
    ce_pack_wt_kernel<float><<<pack_grid, 256, 0, s>>>(static_cast<const float*>(w), wb, nh, V, Kp);
  else
    ce_pack_wt_kernel<__nv_bfloat16>
        <<<pack_grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(w), wb, nh, V, Kp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const CUtensorMapDataType bf = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapSwizzle sw = CU_TENSOR_MAP_SWIZZLE_128B;
  CUtensorMap tm_h, tm_wt;  // 64 k x 64 rows boxes; zeros past nh and N
  if ((err = wg::encode_2d(&tm_h, bf, h, nh, N, 2 * (uint64_t)ldh, kBK, 64, sw))
      || (err = wg::encode_2d(&tm_wt, bf, wb, Kp, Vp, 2 * (uint64_t)Kp, kBK, 64, sw)))
    return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  auto* sp = static_cast<__nv_bfloat16*>(spill);
  const int KS = Kp / kBK, U = (int)units;
  err = save_logits ? cudaLaunchKernelEx(&cfg, ce_bf16_kernel<true>, tm_h, tm_wt, tgt, sp, part,
                                         N, V, Vp, KS, nv, U, clusters, slots)
                    : cudaLaunchKernelEx(&cfg, ce_bf16_kernel<false>, tm_h, tm_wt, tgt, sp, part,
                                         N, V, Vp, KS, nv, U, clusters, slots);
  if (err != cudaSuccess || (err = cudaGetLastError()) != cudaSuccess) return err;
  ce_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(part, N, nv, U, clusters, slots, logp, lse,
                                              save_logits);
  return cudaGetLastError();
}

// Clusters of two blocks of the bf16 kernel (either mode) that the card
// holds at once with smem_bytes of dynamic shared memory a block (a plan's
// smem_bytes), into *clusters.
int ce_fwd_clusters(int smem_bytes, int* clusters) {
  return bf16_clusters(smem_bytes, clusters);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
