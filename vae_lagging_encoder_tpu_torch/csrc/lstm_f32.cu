// Masked-carry LSTM forward and backward sweep with f32 wh, for Hopper
// (sm_90a): exact f32 products on the FMA pipes.
//
// Replaces the JAX package's Pallas TPU kernels where wh stays in f32 (H <=
// 512 with f32 compute; models/lstm_core.py):
//   ops/lstm_pallas.py::_fwd_kernel   (pallas_call at line 126): lstm_fwd_f32_kernel<J, true>
//   ops/lstm_pallas.py::_infer_kernel (pallas_call at line 238): lstm_fwd_f32_kernel<J, false>
//   ops/lstm_pallas.py::_bwd_kernel   (pallas_call at line 341): lstm_bwd_f32_kernel<J>
// The forward, per step t, for gates (i, f, g, o) = (sigmoid, sigmoid, tanh,
// sigmoid) of a = xw[t] + h_{t-1} @ wh (f32 products):
//   c_raw = f * c + i * g;  h_raw = o * tanh(c_raw)
//   h = m * h_raw + (1 - m) * h;  c = m * c_raw + (1 - m) * c   (m = mask[t, row])
// writes hs[t] (the KEPT h), hT, cT and, with residuals, cs[t] and the gate
// activations. The backward is lstm_bwd.cu's sweep (see there) with dh <-
// da @ wh^T + (1 - m) dhk in f32 products. The bf16-wh kernels are
// lstm_infer.cu and lstm_bwd.cu: tensor cores have no exact f32 product
// (TF32 keeps 10 bits of mantissa), and the f32 route is defined by f32
// products.
//
// What bounds them on the H100: each step is a skinny product, [rows, H] x
// [H, 4H] (forward) or [rows, 4H] x [4H, H] (backward), that cannot start
// before the last step's h (or da) is complete in every block. At the
// training step's 32 rows (H 512: 0.13 GFLOP a step, 2 us at the card's 67
// TFLOP/s f32 rate) the serial chain of a step bounds it: the grid
// barrier, the operand's copy into each SM, the products of one SM's share,
// the sum of the K slices, the cell. At 640 rows the FMAs bound it: 2.7
// GFLOP a step at H 512, 40 us at the f32 rate. Measured (lstm_ablation.py,
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md): at 32 rows a step of the
// residual forward is ~13,400 SM clocks, of which the chunks' arrival and
// the products 7,100, the cell 2,500 and the grid barrier 2,900; the empty
// step (barrier, copies, sums) takes half the call. A TMA tile load costs
// its issuing thread ~500-1,000 SM clocks whatever its size (the first
// design, one 16-k box a chunk, 32 to 160 loads a step, spent 14-60 us a
// step in the producer alone), so a chunk is a few wide boxes.
//
// Design (a launch plan from ops/lstm_cuda.py::f32_plan, an F32Plan, which
// the kernels check):
// - A persistent cooperative grid in clusters of two blocks (kCluster), one
//   grid barrier a step. wh stays resident in shared memory: the forward's
//   block owns J units (J = 4 or 8) and keeps their 4J gate columns ([K][4J],
//   column 4 j + q for gate q of unit j); the backward's cluster owns 2J
//   units, each block the J it runs the cell for, and each block keeps the
//   rows of all 2J for its half of K = 4H ([2H][2J]).
// - The operand lives in an f32 ring in global memory that the cell writes
//   (h_t in the forward; da_t, its two K halves apart, in the backward),
//   its k padded to whole 16-k blocks with zeros, viewed as a 4-D tensor
//   (k in the block, the block, the row, the ring slot) so that one TMA
//   box brings KB blocks of 16 k for half a row tile.
// - The grid is row groups x unit blocks. A block's row group (MP rows) is
//   taken in passes of RT rows; in each pass its operand arrives in chunks
//   of KB 16-k blocks (64-byte lines, the 64-byte swizzle; KB odd, so the 8
//   row groups of a warp read 8 distinct bank groups) through a ring of S
//   slots in shared memory, filled by TMA from a producer warp: the
//   forward's two blocks (the same rows, neighbouring units) each load half
//   of a chunk's rows into both (.multicast::cluster), and a slot is
//   refilled once every warp of both blocks has released it; the
//   backward's block loads both halves of its own K half.
// - Consumer warp w takes the 32-row tile w % MW of the pass and the 16-k
//   blocks b = w / MW (mod KS) of K: each lane holds a register tile of 4
//   rows (rg, rg + 8, rg + 16, rg + 24) x the 4 gates of UPL units
//   (forward) or NU units (backward), reads a float4 of 4 k of each row and
//   a float4 of its columns for each k, and runs 16 FMAs for every float4
//   of the operand. Every warp waits for and releases every chunk, in
//   order, so no parity wait meets a slot two uses behind.
// - The K slices' partial tiles go to shared memory and are summed in slice
//   order (no atomics: equal inputs give equal bits); the backward's block
//   sends its sums for the other block's units to that block
//   (st.shared::cluster, a receive buffer per pass parity) and, after the
//   cluster barrier, each block adds the two halves in rank order. Then the
//   pairs' cell: the state lives in cT (forward) and dh0, dc0 (backward),
//   each element read and written by its one owning thread.
// - The ring's generic stores reach the next step's TMA through a proxy
//   fence of every storing thread before the grid barrier, and another by
//   the producer after it.

#include <cooperative_groups.h>

#include "lstm_mma.cuh"
#include "lstm_wgmma.cuh"

namespace cg = cooperative_groups;
namespace wg = lstm_wgmma;
using lstm_mma::cdiv;
using lstm_mma::ld_nc;
using lstm_mma::sigmoid;

namespace {

constexpr int kKC = 16;                        // k of a block of the operand
constexpr int kLineBytes = kKC * 4;            // a row's block: 64 bytes
constexpr int kTileRows = 32;                  // rows of a warp's tile: 8 row groups x 4
constexpr int kMaxWarps = 16;                  // consumer warps
constexpr int kThreads = (kMaxWarps + 1) * 32;  // + the producer warp
constexpr int kCluster = 2;
constexpr int kPad = 4;                        // floats after each row of the partial tiles
constexpr int kSumBatch = 8;                   // partial tiles loaded before they are added

// Byte offsets in shared memory (after aligning the base to 1024 bytes):
// the ring [S][RT rows][KB blocks][16] f32, wh's slice [NC *
// 16][ncol], the partial tiles [KS][RT][ncol + kPad], the backward's
// receive buffers [2][RT][J], the full and empty mbarriers [S] each. NC:
// 16-k blocks of a block's K (H, or the backward's half 2H); ncol: 4J gate
// columns (forward), the cluster's 2J units (backward).
struct Smem {
  size_t ring, w, red, recv, bar, total;
};
__host__ __device__ inline Smem smem_layout(bool bwd, int H, int J, int RT, int KS, int KB,
                                            int S) {
  const size_t NC = cdiv(bwd ? 2 * H : H, kKC), ncol = bwd ? 2 * J : 4 * J;
  Smem s;
  s.ring = 0;
  s.w = s.ring + (size_t)S * RT * KB * kLineBytes;
  s.red = s.w + NC * kKC * ncol * 4;
  s.recv = s.red + (size_t)KS * RT * (ncol + kPad) * 4;
  s.bar = s.recv + (bwd ? (size_t)2 * RT * J * 4 : 0);
  s.total = (size_t)wg::kAlign + s.bar + 16 * (size_t)S;
  return s;
}

// Unit blocks of a row group: the forward's ceil(H / J) in whole clusters,
// the backward's clusters of 2J units.
__host__ __device__ inline int unit_blocks(bool bwd, int H, int J) {
  return bwd ? kCluster * cdiv(H, kCluster * J) : kCluster * cdiv(cdiv(H, J), kCluster);
}

// Rows of one TMA box of a chunk: the forward's half of the tile (each
// block of the pair loads one half for both), the backward's whole tile
// where one box holds it (256 rows), else half.
__host__ __device__ inline int box_rows(bool bwd, int RT) {
  return bwd && RT <= 256 ? RT : RT / 2;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// 4-D tile load (box c0 innermost .. c3) into `dst`, completing on `bar`;
// the multicast form writes offset `dst` of every block in `mask`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* tmap, int c0, int c1,
                                            int c2, int c3, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d_mc(uint32_t dst, const CUtensorMap* tmap, int c0,
                                               int c1, int c2, int c3, uint32_t bar,
                                               uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3, %4, %5}], [%6], %7;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar),
      "h"(mask)
      : "memory");
}

// The cluster barrier of every thread of both blocks, releasing this
// thread's writes (its distributed-shared-memory stores) to the other's
// reads after it; threads of a warp may reach it apart.
__device__ __forceinline__ void cluster_sync_all() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}

// The producer warp (lane 0 issues): the P passes x NCH chunks of one step
// in order, chunk i of the step the (g0 + i)-th of the sequence, into ring
// slot g % S once that slot's last use has been released. A chunk is KB
// 16-k blocks of the pass's RT rows in boxes of `box_rows`: the forward
// loads its half into both blocks of the cluster; the backward the whole
// tile into its own block, and takes the cluster barrier of each pass (the
// exchange of partial sums) where its consumers do: before a chunk whose
// slot was last used in the pass it belongs to, and at the end. `plane`:
// the ring slot of the operand (the backward's with its K half).
template <bool kBwd>
__device__ __forceinline__ void produce(const CUtensorMap* tmap, uint32_t ring, uint32_t bar,
                                        uint32_t g0, int P, int NCH, int KB, int S, int RT,
                                        int row0, int plane, uint32_t crank, int lane) {
  const int half = box_rows(kBwd, RT);
  const uint32_t half_bytes = (uint32_t)half * KB * kLineBytes;
  int synced = 0;
  if (lane == 0) wg::fence_proxy_async_global();  // the ring's stores, before this TMA reads
  for (int i = 0; i < P * NCH; ++i) {
    const int q = i / NCH, c = i % NCH;
    const uint32_t g = g0 + i, use = g / S;
    const int s = g % S;
    if (kBwd)
      while (synced < q && use > 0 && g - S >= g0 + (uint32_t)(q * NCH)) {
        cluster_sync_all();
        ++synced;
      }
    if (lane == 0) {
      const uint32_t full = bar + 8u * s, empty = bar + 8u * (S + s);
      if (use > 0) wg::mbar_wait(empty, (use - 1) & 1);
      const uint32_t slot_bytes = (uint32_t)RT * KB * kLineBytes;
      wg::mbar_arrive_tx(full, slot_bytes);
      const uint32_t dst = ring + (uint32_t)s * slot_bytes;
      const int r = row0 + q * RT;
      if (kBwd) {
        for (int h = 0; h * half < RT; ++h)
          tma_load_4d(dst + h * half_bytes, tmap, 0, c * KB, r + h * half, plane, full);
      } else {
        tma_load_4d_mc(dst + crank * half_bytes, tmap, 0, c * KB, r + crank * half, plane, full,
                       (uint16_t)((1u << kCluster) - 1));
      }
    }
    __syncwarp();
  }
  if (kBwd)
    for (; synced < P; ++synced) cluster_sync_all();
}

// One consumer warp's products over a pass's NCH chunks (the g0-th of the
// sequence first): acc[i][n] += sum_k A[row_i, k] B[k, n0 + n] over the
// 16-k blocks b = ks (mod KS) of K, A the rows trow + rg + 8 i of the pass's
// tile and B the resident slice (ncol columns a k, this lane's N from n0
// at `wsl`); every chunk released to the blocks that load it, once the
// warp has read it (the other block too in the forward).
template <int N>
__device__ __forceinline__ void products(float (&acc)[4][N], const unsigned char* ring,
                                         const float* wsl, int ncol, uint32_t g0, int NCH,
                                         int KB, int NC, int ks, int KS, int S, int RT, int trow,
                                         int rg, bool to_peer, uint32_t peer, int lane,
                                         uint32_t bar) {
  // the line (row, block 0) of each of this lane's rows in a slot [RT][KB]
  // (its boxes of rows one after the other)
  int line[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) line[i] = (trow + rg + 8 * i) * KB;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[i][n] = 0.f;
  for (int c = 0; c < NCH; ++c) {
    const uint32_t g = g0 + c;
    const int s = g % S;
    wg::mbar_wait(bar + 8u * s, (g / S) & 1);
    const unsigned char* slot = ring + (size_t)s * RT * KB * kLineBytes;
    for (int kb = (ks - (c * KB) % KS + KS) % KS; kb < KB && c * KB + kb < NC; kb += KS) {
      const float* wk = wsl + (size_t)(c * KB + kb) * kKC * ncol;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float4 hv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          // TMA's 64-byte swizzle: address bits 4-5 XOR bits 7-8
          const int l = line[i] + kb;
          hv[i] = *reinterpret_cast<const float4*>(slot + l * kLineBytes
                                                   + ((j ^ ((l >> 1) & 3)) << 4));
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          float wv[N];
          const float* wp = wk + (size_t)(4 * j + kk) * ncol;
          if constexpr (N % 4 == 0) {
#pragma unroll
            for (int v = 0; v < N / 4; ++v) {
              const float4 x = *reinterpret_cast<const float4*>(wp + 4 * v);
              wv[4 * v] = x.x;
              wv[4 * v + 1] = x.y;
              wv[4 * v + 2] = x.z;
              wv[4 * v + 3] = x.w;
            }
          } else {
            static_assert(N == 2, "lane widths this file spells out");
            const float2 x = *reinterpret_cast<const float2*>(wp);
            wv[0] = x.x;
            wv[1] = x.y;
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float a = comp(hv[i], kk);
#pragma unroll
            for (int n = 0; n < N; ++n) acc[i][n] = fmaf(a, wv[n], acc[i][n]);
          }
        }
      }
    }
    __syncwarp();
    if (lane == 0) {
      const uint32_t empty = bar + 8u * (S + s);
      wg::mbar_arrive(empty);
      if (to_peer) wg::mbar_arrive_rank_relaxed(empty, peer);
    }
  }
}

// The partial tile of a warp into red[ks][row][n0 ..]: rows trow + rg + 8 i.
template <int N>
__device__ __forceinline__ void store_partial(float* red, const float (&acc)[4][N], int ks,
                                              int RT, int ld, int trow, int rg, int n0) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float* p = red + ((size_t)ks * RT + trow + rg + 8 * i) * ld + n0;
#pragma unroll
    for (int v = 0; v < N / 4; ++v)
      *reinterpret_cast<float4*>(p + 4 * v) =
          make_float4(acc[i][4 * v], acc[i][4 * v + 1], acc[i][4 * v + 2], acc[i][4 * v + 3]);
    if constexpr (N % 4 != 0) *reinterpret_cast<float2*>(p) = make_float2(acc[i][0], acc[i][1]);
  }
}

// The KS partial values at red[k][e] (k = 0 .. KS-1, `stride` floats apart)
// summed in slice order.
__device__ __forceinline__ float sum_slices(const float* red, size_t e, size_t stride, int KS) {
  float v = 0.f;
  for (int k0 = 0; k0 < KS; k0 += kSumBatch) {
    float part[kSumBatch];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (k0 + u < KS) part[u] = red[(k0 + u) * stride + e];
#pragma unroll
    for (int u = 0; u < kSumBatch; ++u)
      if (k0 + u < KS) v += part[u];
  }
  return v;
}

// ------------------------------------------------------------------ forward
// A forward pair's cell inputs: xw[t] of its four gates, the mask, c and h
// of the step before.
struct FwdIn {
  float x[4], m, cp, hp;
};

// Block b = rg UGb + ug: rows [rg MP, rg MP + MP) x units [J ug, J ug + J);
// the two blocks of a cluster are ug = 2c, 2c + 1 of one row group. ring:
// [2][rows][Hp] f32, Hp = the 16-k blocks of H, zeros past H.
template <int J, bool kSaveResiduals>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_f32_kernel(const __grid_constant__ CUtensorMap tm_h, const float* __restrict__ xw,
                    const float* __restrict__ mask, const float* __restrict__ wh,
                    const float* __restrict__ h0, const float* __restrict__ c0,
                    float* __restrict__ hs, float* __restrict__ cs, float* __restrict__ gates,
                    float* __restrict__ hT, float* __restrict__ cT, float* __restrict__ ring,
                    int T_, int rows, int H, int UGb, int MP, int RT, int KS, int KB, int S) {
  constexpr int UPL = J / 4;     // units a lane: 4 column groups x UPL = J
  constexpr int NCOL = 4 * J;    // gate column 4 j + q
  constexpr int LD = NCOL + kPad;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sbase = (raw + wg::kAlign - 1) & ~(uint32_t)(wg::kAlign - 1);
  unsigned char* smem = smem_raw + (sbase - raw);
  const Smem L = smem_layout(false, H, J, RT, KS, KB, S);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const uint32_t bar = sbase + (uint32_t)L.bar;

  const int NC = cdiv(H, kKC), NCH = cdiv(NC, KB), P = MP / RT, MW = RT / kTileRows,
            W = MW * KS, Hp = NC * kKC;
  const int rg = blockIdx.x / UGb, ug = blockIdx.x % UGb, u0 = ug * J, row0 = rg * MP;
  const uint32_t crank = cluster.block_rank(), peer = crank ^ 1;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nthr = W * 32;
  const bool producer = warp == W;
  const int mw = warp % MW, ks = warp / MW, rgl = lane >> 2, cg4 = lane & 3;
  const size_t H4 = 4 * (size_t)H, slot_elems = (size_t)rows * Hp;

  // wh's gate columns of this block's units, zero past H: ws[k][4 j + q] =
  // wh[k, q H + u0 + j]; consecutive threads read consecutive units
  for (int idx = tid; idx < NC * kKC * NCOL; idx += blockDim.x) {
    const int k = idx / NCOL, q = (idx % NCOL) / J, j = idx % J;
    ws[k * NCOL + 4 * j + q] = (k < H && u0 + j < H) ? wh[(size_t)k * H4 + (size_t)q * H + u0 + j]
                                                     : 0.f;
  }
  // h0 into ring slot 1, for this block's pairs
  for (int p = tid; p < MP * J; p += blockDim.x) {
    const int row = row0 + p / J, unit = u0 + p % J;
    if (row < rows && unit < H)
      ring[slot_elems + (size_t)row * Hp + unit] = h0[(size_t)row * H + unit];
  }
  wg::fence_proxy_async_global();  // the ring's h0, before TMA reads it
  if (producer && lane == 0)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_h)) : "memory");
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(bar + 8u * s, 1);
      wg::mbar_init(bar + 8u * (S + s), kCluster * W);
    }
    wg::fence_mbar_init();
  }
  cluster.sync();  // the barriers, before the other block's copies and arrivals reach them
  grid.sync();

  for (int t = 0; t < T_; ++t) {
    // chunks of the steps before (the same sequence in both blocks)
    const uint32_t g0 = (uint32_t)t * P * NCH;
    if (producer) {
      produce<false>(&tm_h, sbase + (uint32_t)L.ring, bar, g0, P, NCH, KB, S, RT, row0,
                     (t + 1) & 1, crank, lane);
    } else {
      // the cell's inputs of pair pp = (row pp / J, unit pp % J) of pass p
      auto load_in = [&](int p, int pp, FwdIn& in) {
        const int row = row0 + p * RT + pp / J, unit = u0 + pp % J;
        if (row >= rows || unit >= H) return;
        const size_t xo = ((size_t)t * rows + row) * H4 + unit, so = (size_t)row * H + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) in.x[q] = ld_nc(xw + xo + (size_t)q * H);
        in.m = ld_nc(mask + (size_t)t * rows + row);
        in.cp = t == 0 ? c0[so] : __ldcg(cT + so);
        in.hp = __ldcg(ring + (size_t)((t + 1) & 1) * slot_elems + (size_t)row * Hp + unit);
      };
      for (int p = 0; p < P; ++p) {
        FwdIn first;  // this thread's first pair's, requested before the products
        if (tid < RT * J) load_in(p, tid, first);
        float acc[4][4 * UPL];
        products<4 * UPL>(acc, smem + L.ring, ws + 4 * UPL * cg4, NCOL, g0 + p * NCH, NCH, KB,
                          NC, ks, KS, S, RT, mw * kTileRows, rgl, true, peer, lane, bar);
        store_partial<4 * UPL>(red, acc, ks, RT, LD, mw * kTileRows, rgl, 4 * UPL * cg4);
        wg::bar_sync(1, nthr);
        // the cell of the pass's pairs
        for (int pp = tid; pp < RT * J; pp += nthr) {
          const int rl = pp / J, j = pp % J, row = row0 + p * RT + rl, unit = u0 + j;
          if (row >= rows || unit >= H) continue;
          const size_t xo = ((size_t)t * rows + row) * H4 + unit, so = (size_t)row * H + unit;
          FwdIn in = first;
          if (pp != tid) load_in(p, pp, in);
          const float* x = in.x;
          const float m = in.m, cp = in.cp, hp = in.hp;
          float act[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            act[q] = x[q] + sum_slices(red, (size_t)rl * LD + 4 * j + q, (size_t)RT * LD, KS);
          act[0] = sigmoid(act[0]);
          act[1] = sigmoid(act[1]);
          act[2] = tanhf(act[2]);
          act[3] = sigmoid(act[3]);
          const float c_raw = act[1] * cp + act[0] * act[2];
          const float h_raw = act[3] * tanhf(c_raw);
          const float hk = m * h_raw + (1.f - m) * hp;
          const float ck = m * c_raw + (1.f - m) * cp;
          ring[(size_t)(t & 1) * slot_elems + (size_t)row * Hp + unit] = hk;
          hs[(size_t)t * rows * H + so] = hk;
          cT[so] = ck;
          if (t == T_ - 1) hT[so] = hk;
          if (kSaveResiduals) {
            cs[(size_t)t * rows * H + so] = ck;
#pragma unroll
            for (int q = 0; q < 4; ++q) gates[xo + (size_t)q * H] = act[q];
          }
        }
        wg::bar_sync(1, nthr);  // the partial tiles are rewritten by the next pass
      }
      wg::fence_proxy_async_global();  // this thread's ring stores, before the next step's TMA
    }
    if (t + 1 < T_) grid.sync();
  }
  cluster.sync();  // no block leaves while the other may still write to it or arrive on it
}

// ----------------------------------------------------------------- backward
// A backward pair's cell inputs of step t: the gate activations, c_{t-1},
// dhs[t], the mask.
struct BwdIn {
  float g[4], cp, dsv, m;
};
__device__ __forceinline__ void load_bwd_in(int t, int row, int unit, int B, int H,
                                            const float* __restrict__ gates,
                                            const float* __restrict__ mask,
                                            const float* __restrict__ cprev,
                                            const float* __restrict__ dhs, BwdIn& in) {
  const size_t go = ((size_t)t * B + row) * 4 * (size_t)H + unit;
  const size_t to = ((size_t)t * B + row) * H + unit;
#pragma unroll
  for (int q = 0; q < 4; ++q) in.g[q] = ld_nc(gates + go + (size_t)q * H);
  in.cp = ld_nc(cprev + to);
  in.dsv = ld_nc(dhs + to);
  in.m = ld_nc(mask + (size_t)t * B + row);
}

// The cell backward of step t for (row, unit) from its inputs, dh_in and
// the carry dc (dc0): da[t] (also into ring slot t % 2, each value in its K
// half), the carries (1 - m) dhk -> dh0 and dc_{t-1} -> dc0.
__device__ __forceinline__ void cell_bwd(int t, int row, int unit, int B, int H, const BwdIn& in,
                                         float dh_in, float dc_in, float* da, float* ring, int Kp,
                                         float* dh0, float* dc0) {
  const size_t H4 = 4 * (size_t)H;
  const size_t go = ((size_t)t * B + row) * H4 + unit, so = (size_t)row * H + unit;
  const float ig = in.g[0], fg = in.g[1], gg = in.g[2], og = in.g[3];
  const float cp = in.cp, dsv = in.dsv, m = in.m;
  const float tanh_c = tanhf(fg * cp + ig * gg);
  const float dhk = dh_in + dsv, dck = dc_in;
  const float dh_raw = m * dhk, dc_raw = m * dck;
  const float do_ = dh_raw * tanh_c;
  const float dc_tot = dc_raw + dh_raw * og * (1.f - tanh_c * tanh_c);
  float a[4];
  a[0] = dc_tot * gg * ig * (1.f - ig);
  a[1] = dc_tot * cp * fg * (1.f - fg);
  a[2] = dc_tot * ig * (1.f - gg * gg);
  a[3] = do_ * og * (1.f - og);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int k = q * H + unit, kh = k >= 2 * H;
    da[go + (size_t)q * H] = a[q];
    ring[(((size_t)(t & 1) * 2 + kh) * B + row) * Kp + (k - kh * 2 * H)] = a[q];
  }
  dh0[so] = (1.f - m) * dhk;
  dc0[so] = dc_tot * fg + (1.f - m) * dck;
}

// Block b = rg UGb + 2 pr + r (cluster pr of row group rg, rank r): the
// product of rows [rg MP, rg MP + MP) x the cluster's units [2J pr, 2J pr +
// 2J) over K half r of 4H; the cell of its own units [2J pr + J r, + J).
// ring: [2 slots][2 K halves][B][Kp] f32, Kp = the 16-k blocks of 2H, zeros
// past 2H.
template <int J>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_f32_kernel(const __grid_constant__ CUtensorMap tm_da, const float* __restrict__ gates,
                    const float* __restrict__ mask, const float* __restrict__ wh,
                    const float* __restrict__ cprev, const float* __restrict__ dhs,
                    const float* __restrict__ dhT, const float* __restrict__ dcT,
                    float* __restrict__ da, float* __restrict__ ring, float* __restrict__ dh0,
                    float* __restrict__ dc0, int T_, int B, int H, int UGb, int MP, int RT,
                    int KS, int KB, int S) {
  constexpr int NU = J / 2;      // units a lane: 4 column groups x NU = the cluster's 2J
  constexpr int NCOL = 2 * J;
  constexpr int LD = NCOL + kPad;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sbase = (raw + wg::kAlign - 1) & ~(uint32_t)(wg::kAlign - 1);
  unsigned char* smem = smem_raw + (sbase - raw);
  const Smem L = smem_layout(true, H, J, RT, KS, KB, S);
  float* ws = reinterpret_cast<float*>(smem + L.w);
  float* red = reinterpret_cast<float*>(smem + L.red);
  const float* recv = reinterpret_cast<const float*>(smem + L.recv);
  const uint32_t bar = sbase + (uint32_t)L.bar, s_recv = sbase + (uint32_t)L.recv;

  const int Kh = 2 * H, NC = cdiv(Kh, kKC), NCH = cdiv(NC, KB), P = MP / RT,
            MW = RT / kTileRows, W = MW * KS, Kp = NC * kKC;
  const uint32_t crank = cluster.block_rank(), peer = crank ^ 1;
  const int rg = blockIdx.x / UGb, uc = (blockIdx.x % UGb - (int)crank) * J;
  const int u0 = uc + (int)crank * J, row0 = rg * MP, kbase = (int)crank * Kh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nthr = W * 32;
  const bool producer = warp == W;
  const int mw = warp % MW, ks = warp / MW, rgl = lane >> 2, cg4 = lane & 3;
  const size_t H4 = 4 * (size_t)H;

  // wh's rows of the cluster's units over this block's K half, zero past H
  // and 4H: ws[k][n] = wh[uc + n, kbase + k]; consecutive threads read
  // consecutive k of one wh row
  for (int idx = tid; idx < NC * kKC * NCOL; idx += blockDim.x) {
    const int n = idx / (NC * kKC), k = idx % (NC * kKC);
    ws[k * NCOL + n] = (k < Kh && uc + n < H) ? wh[(size_t)(uc + n) * H4 + kbase + k] : 0.f;
  }
  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      wg::mbar_init(bar + 8u * s, 1);
      wg::mbar_init(bar + 8u * (S + s), W);
    }
    wg::fence_mbar_init();
  }
  // step T-1: the cell backward of this block's pairs from dhT, dcT
  for (int p = tid; p < MP * J; p += blockDim.x) {
    const int row = row0 + p / J, unit = u0 + p % J;
    if (row < B && unit < H) {
      const size_t so = (size_t)row * H + unit;
      BwdIn in;
      load_bwd_in(T_ - 1, row, unit, B, H, gates, mask, cprev, dhs, in);
      cell_bwd(T_ - 1, row, unit, B, H, in, dhT[so], dcT[so], da, ring, Kp, dh0, dc0);
    }
  }
  wg::fence_proxy_async_global();  // the ring's da[T-1], before TMA reads it
  if (producer && lane == 0)
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_da)) : "memory");
  cluster.sync();
  grid.sync();

  for (int t = T_ - 1; t >= 0; --t) {
    const uint32_t pbase = (uint32_t)(T_ - 1 - t) * P;  // passes of the steps before
    const uint32_t g0 = pbase * NCH;                    // their chunks
    if (producer) {
      produce<true>(&tm_da, sbase + (uint32_t)L.ring, bar, g0, P, NCH, KB, S, RT, row0,
                    (t & 1) * 2 + (int)crank, crank, lane);
    } else {
      for (int p = 0; p < P; ++p) {
        // this thread's first pair's cell inputs and carries, requested
        // before the products
        BwdIn first;
        float first_dh = 0.f, first_dc = 0.f;
        {
          const int row = row0 + p * RT + tid / J, unit = u0 + tid % J;
          if (tid < RT * J && row < B && unit < H) {
            if (t > 0) load_bwd_in(t - 1, row, unit, B, H, gates, mask, cprev, dhs, first);
            first_dh = dh0[(size_t)row * H + unit];
            first_dc = dc0[(size_t)row * H + unit];
          }
        }
        float acc[4][NU];
        products<NU>(acc, smem + L.ring, ws + NU * cg4, NCOL, g0 + p * NCH, NCH, KB, NC, ks, KS,
                     S, RT, mw * kTileRows, rgl, false, peer, lane, bar);
        store_partial<NU>(red, acc, ks, RT, LD, mw * kTileRows, rgl, NU * cg4);
        wg::bar_sync(1, nthr);
        // the sum of each unit's slices, in slice order: this block's units'
        // stay (red slice 0), the other block's go to its receive buffer
        const int buf = (pbase + p) & 1;
        for (int e = tid; e < RT * NCOL; e += nthr) {
          const int rl = e / NCOL, n = e % NCOL;
          const size_t o = (size_t)rl * LD + n;
          const float v = sum_slices(red, o, (size_t)RT * LD, KS);
          if (n / J == (int)crank) {
            red[o] = v;
          } else {
            const uint32_t dst = s_recv + (uint32_t)(((size_t)buf * RT + rl) * J + n % J) * 4;
            asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(wg::map_rank(dst, peer)),
                         "f"(v)
                         : "memory");
          }
        }
        cluster_sync_all();  // every sum is in its owner's receive buffer
        // the two halves in rank order, then the cell backward of step t-1
        for (int pp = tid; pp < RT * J; pp += nthr) {
          const int rl = pp / J, j = pp % J, row = row0 + p * RT + rl, unit = u0 + j;
          if (row >= B || unit >= H) continue;
          const float own = red[(size_t)rl * LD + (int)crank * J + j];
          const float other = recv[((size_t)buf * RT + rl) * J + j];
          const size_t so = (size_t)row * H + unit;
          BwdIn in = first;
          float dh = first_dh, dc = first_dc;
          if (pp != tid) {
            if (t > 0) load_bwd_in(t - 1, row, unit, B, H, gates, mask, cprev, dhs, in);
            dh = dh0[so];
            dc = dc0[so];
          }
          const float dh_in = (crank == 0 ? own + other : other + own) + dh;
          if (t > 0)
            cell_bwd(t - 1, row, unit, B, H, in, dh_in, dc, da, ring, Kp, dh0, dc0);
          else
            dh0[so] = dh_in;
        }
        wg::bar_sync(1, nthr);  // red is rewritten by the next pass
      }
      wg::fence_proxy_async_global();  // this thread's ring stores, before the next step's TMA
    }
    if (t > 0) grid.sync();
  }
  cluster.sync();  // no block leaves while the other may still write to it
}

// -------------------------------------------------------------------- host
// The f32 ring as a 4-D tensor: 16 k of a block (innermost), NC blocks 64
// bytes apart, `rows` rows `row_bytes` apart, `planes` planes (ring slots;
// the backward's slot x K half) `plane_bytes` apart; boxes of 16 x KB x
// brows x 1 with the 64-byte swizzle; elements outside the tensor read as
// zeros.
cudaError_t encode_ring(CUtensorMap* m, const void* base, int NC, int rows, int planes,
                        uint64_t row_bytes, uint64_t plane_bytes, int KB, int brows) {
  wg::EncodeTiledFn fn = wg::encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)kKC, (cuuint64_t)NC, (cuuint64_t)rows,
                              (cuuint64_t)planes};
  const cuuint64_t strides[3] = {(cuuint64_t)kLineBytes, row_bytes, plane_bytes};
  const cuuint32_t box[4] = {(cuuint32_t)kKC, (cuuint32_t)KB, (cuuint32_t)brows, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = fn(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The plan's shape checks shared by both entry points: 32-row tiles, at
// most kMaxWarps consumer warps, an odd number of 16-k blocks a chunk (the
// conflict-free reads) within one box, the layout's shared memory.
bool plan_ok(bool bwd, int rows, int H, int units, int cluster, int row_groups, int MP, int RT,
             int KS, int KB, int S, int smem_bytes) {
  const int NC = cdiv(bwd ? 2 * H : H, kKC);
  return rows >= 1 && H >= 1 && (units == 4 || units == 8) && cluster == kCluster && RT >= 1
         && RT % kTileRows == 0 && RT / 2 <= 256 && MP % RT == 0
         && row_groups == cdiv(rows, MP) && KS >= 1 && (RT / kTileRows) * KS <= kMaxWarps
         && KB >= 1 && KB % 2 == 1 && KB <= 256 && KB <= NC && S >= 1 && smem_bytes >= 0
         && (size_t)smem_bytes == smem_layout(bwd, H, units, RT, KS, KB, S).total;
}

template <int J, bool kSaveResiduals>
cudaError_t launch_fwd(const CUtensorMap& tm, const float* xw, const float* mask, const float* wh,
                       const float* h0, const float* c0, float* hs, float* cs, float* gates,
                       float* hT, float* cT, float* ring, int T_, int rows, int H, int RG,
                       int MP, int RT, int KS, int KB, int S, size_t smem, cudaStream_t stream) {
  const int UGb = unit_blocks(false, H, J), threads = ((RT / kTileRows) * KS + 1) * 32;
  return wg::launch_cluster_cooperative(lstm_fwd_f32_kernel<J, kSaveResiduals>, RG * UGb,
                                        threads, smem, kCluster, stream, tm, xw, mask, wh, h0, c0,
                                        hs, cs, gates, hT, cT, ring, T_, rows, H, UGb, MP, RT, KS,
                                        KB, S);
}

template <int J>
cudaError_t launch_bwd(const CUtensorMap& tm, const float* gates, const float* mask,
                       const float* wh, const float* cprev, const float* dhs, const float* dhT,
                       const float* dcT, float* da, float* ring, float* dh0, float* dc0, int T_,
                       int B, int H, int RG, int MP, int RT, int KS, int KB, int S, size_t smem,
                       cudaStream_t stream) {
  const int UGb = unit_blocks(true, H, J), threads = ((RT / kTileRows) * KS + 1) * 32;
  return wg::launch_cluster_cooperative(lstm_bwd_f32_kernel<J>, RG * UGb, threads, smem, kCluster,
                                        stream, tm, gates, mask, wh, cprev, dhs, dhT, dcT, da,
                                        ring, dh0, dc0, T_, B, H, UGb, MP, RT, KS, KB, S);
}

}  // namespace

extern "C" {

// The forward: xw [T, rows, 4H], mask [T, rows], wh [H, 4H], h0, c0 [rows,
// H], all f32. Writes hs [T, rows, H], hT, cT [rows, H] and, when
// save_residuals, cs [T, rows, H] and gates [T, rows, 4H] (activations i, f,
// g, o; null otherwise); ring is an f32 scratch [2, rows, Hp], Hp = H
// rounded up to 16, zeros on entry. The launch plan
// (ops/lstm_cuda.py::F32Plan): units J, cluster, row_groups, rows_per_group
// MP, row_tile RT, k_slices KS, k_blocks KB (16-k blocks a chunk), stages S
// (ring slots), smem_bytes; it is checked here and refused with
// cudaErrorInvalidValue when it is not one this kernel was built for.
// Returns a cudaError_t.
int lstm_fwd_f32(const float* xw, const float* mask, const float* wh, const float* h0,
                 const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
                 float* ring, int T, int rows, int H, int save_residuals, int units, int cluster,
                 int row_groups, int rows_per_group, int row_tile, int k_slices, int k_blocks,
                 int stages, int smem_bytes, void* stream) {
  const int MP = rows_per_group, RT = row_tile, KS = k_slices, KB = k_blocks, S = stages;
  if (T < 1
      || !plan_ok(false, rows, H, units, cluster, row_groups, MP, RT, KS, KB, S, smem_bytes)
      || (save_residuals && (!cs || !gates)))
    return cudaErrorInvalidValue;
  const int NC = cdiv(H, kKC);
  CUtensorMap tm;
  cudaError_t err = encode_ring(&tm, ring, NC, rows, 2, (uint64_t)NC * kLineBytes,
                                (uint64_t)NC * kLineBytes * rows, KB, box_rows(false, RT));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t sm = smem_bytes;
#define LSTM_F32_CASE(j, res)                                                                   \
  if (units == j && !save_residuals == !res)                                                    \
    return launch_fwd<j, res>(tm, xw, mask, wh, h0, c0, hs, cs, gates, hT, cT, ring, T, rows,  \
                              H, row_groups, MP, RT, KS, KB, S, sm, s);
  LSTM_F32_CASE(4, false)
  LSTM_F32_CASE(4, true)
  LSTM_F32_CASE(8, false)
  LSTM_F32_CASE(8, true)
#undef LSTM_F32_CASE
  return cudaErrorInvalidValue;
}

// The backward: gates [T, B, 4H] (activations i, f, g, o), mask [T, B],
// wh [H, 4H], c_prev [T, B, H] (c_{t-1}, c_0 first), dhs [T, B, H], dhT,
// dcT [B, H], all f32. Writes da [T, B, 4H], dh0, dc0 [B, H] (the carries
// after step 0); ring is an f32 scratch [2, 2, B, Kp], Kp = 2H rounded up
// to 16, zeros on entry. The same plan as the forward's, checked here.
int lstm_bwd_f32(const float* gates, const float* mask, const float* wh, const float* cprev,
                 const float* dhs, const float* dhT, const float* dcT, float* da, float* ring,
                 float* dh0, float* dc0, int T, int B, int H, int units, int cluster,
                 int row_groups, int rows_per_group, int row_tile, int k_slices, int k_blocks,
                 int stages, int smem_bytes, void* stream) {
  const int MP = rows_per_group, RT = row_tile, KS = k_slices, KB = k_blocks, S = stages;
  if (T < 1 || !plan_ok(true, B, H, units, cluster, row_groups, MP, RT, KS, KB, S, smem_bytes))
    return cudaErrorInvalidValue;
  const int NC = cdiv(2 * H, kKC);
  CUtensorMap tm;
  cudaError_t err = encode_ring(&tm, ring, NC, B, 4, (uint64_t)NC * kLineBytes,
                                (uint64_t)NC * kLineBytes * B, KB, box_rows(true, RT));
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (units == 4)
    return launch_bwd<4>(tm, gates, mask, wh, cprev, dhs, dhT, dcT, da, ring, dh0, dc0, T, B, H,
                         row_groups, MP, RT, KS, KB, S, smem_bytes, s);
  return launch_bwd<8>(tm, gates, mask, wh, cprev, dhs, dhT, dcT, da, ring, dh0, dc0, T, B, H,
                       row_groups, MP, RT, KS, KB, S, smem_bytes, s);
}

// Blocks of the f32 kernel (bwd: the backward, else the forward with
// residuals) of `units` units a block that the card holds at once in its
// clusters of 2, at the most shared memory and threads a block may take
// (any plan's blocks fit at least as densely), into *blocks.
int lstm_f32_blocks(int bwd, int units, int* blocks) {
  int dev, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if (units != 4 && units != 8) return cudaErrorInvalidValue;
  if (bwd)
    return units == 4 ? wg::cluster_blocks(lstm_bwd_f32_kernel<4>, kThreads, smem_max, kCluster,
                                           blocks)
                      : wg::cluster_blocks(lstm_bwd_f32_kernel<8>, kThreads, smem_max, kCluster,
                                           blocks);
  return units == 4 ? wg::cluster_blocks(lstm_fwd_f32_kernel<4, true>, kThreads, smem_max,
                                         kCluster, blocks)
                    : wg::cluster_blocks(lstm_fwd_f32_kernel<8, true>, kThreads, smem_max,
                                         kCluster, blocks);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
