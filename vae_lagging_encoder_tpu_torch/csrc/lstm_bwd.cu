// Masked-carry LSTM backward (reverse-time sweep) over a whole sequence, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   ops/lstm_pallas.py::_bwd_kernel  (with _bwd_call; pallas_call at line 341)
// For t = T-1 .. 0, from the forward's gate activations (i, f, g, o), the
// previous kept cell state c_prev = c_{t-1} and the incoming grads:
//   tanh_c = tanh(f * c_prev + i * g)          (recomputed, not read from cs)
//   dhk = dh + dhs[t];  dck = dc;  m = mask[t, row]
//   dh_raw = m * dhk;  dc_raw = m * dck
//   dc_tot = dc_raw + dh_raw * o * (1 - tanh_c^2)
//   da = [dc_tot*g * i(1-i), dc_tot*c_prev * f(1-f), dc_tot*i * (1-g^2),
//         dh_raw*tanh_c * o(1-o)]                (grads of the gate pre-activations)
//   dh <- da.astype(wh.dtype) @ wh^T + (1 - m) * dhk   (f32 accumulation)
//   dc <- dc_tot * f + (1 - m) * dck
// Outputs da [T, B, 4H], dh0, dc0 [B, H] (the carries after step 0). dWh =
// h_prev^T @ da is one matrix product outside the kernel, as in the JAX
// package's _fused_bwd.
//
// The bf16 path has three plans, by row count (ops/lstm_cuda.py::bwd_plan;
// WIDE_MIN_ROWS): from WIDE_MIN_ROWS the wide-row kernel (namespace wide
// below: wgmma, TMA, clusters); below it the narrow-row kernel (namespace
// narrow: a cluster of two splits K, wh in registers) wherever its plan
// fits (up to 32 rows at H 1024), and the mma.sync kernel
// (lstm_bwd_mma_kernel) for the rows between.
//
// The wide-row kernel at --nsamples training's shape (T 96, 640 rows, H
// 1024; plan 2 row groups of 320 rows x 32 unit groups of 32 units x the 2
// K halves of a cluster, 128 blocks):
// - what bounds it (lstm_ablation.py, NVIDIA H100 80GB HBM3 at 700 W):
//   the products. Without them a call takes 4.36 of 5.91 ms, without the
//   TMA loads 4.65, without the cell backward 4.27, without the cluster
//   exchange 5.77. The phase profile puts 72% of a consumer warpgroup's
//   step in its k-loop: ~790 SM clocks for each 64-k slab of 4 wgmma
//   m64n32k16 (the dense bf16 rate would take 64 a slab: at N 32 each
//   instruction's fixed cost dominates), 96 slabs for the warpgroup with
//   three m-tiles; then 19% waiting at the grid barrier, for the last
//   m-tile's cell backward and the slowest block. Against that, the step's
//   5.4 GFLOP over the grid is 5.5 us at the dense rate, and the cell
//   backward's HBM traffic (gates, c_prev, dhs, da and the carries) ~42 MB
//   a step, 12.5 us.
// - bytes of da_t a step: 1,310,720 into each SM (its 320 rows x its 2048-k
//   half in bf16) and 167,772,160 from L2 over the grid, 4x below the
//   32-row kernel's plan at 640 rows (every block read all of da_t:
//   5,242,880 into each SM, 671,088,640 from L2, at the L2's rate).
// - the barrier: one grid.sync() a step (cooperative launch with clusters).
//
// Design of the wide-row kernel:
// - Block 2 (rg UG + ug) + kc owns the product of rows [rg MP, rg MP + MP)
//   x units [32 ug, 32 ug + 32) over k in K half kc: it keeps those units'
//   rows of wh (their K half) resident in shared memory as the K-major B
//   operand of wgmma (N = 32, 128-byte swizzle; 128 KB at H 1024).
// - Two consumer warpgroups take the 64-row m-tiles alternately; each has a
//   4-deep ring of 64 x 64 bf16 tiles of da_t (A), filled by TMA from the
//   row-major bf16 ring by its own producer warp, a slot refilled once the
//   consumer has released it (mbarriers). A consumer waits for its tile,
//   issues the four wgmma, keeps one group in flight, releases the slot.
// - The two K halves of a (row group, unit group) are the two blocks of a
//   cluster. Each consumer thread sends its partial of the other block's 16
//   units to the thread with the same index there (distributed shared
//   memory, an mbarrier with cluster-scope release and acquire), which
//   owns those pairs and sums (its half) + (the other half): one fixed
//   order, no atomics, the same bits every run. The halves land in receive
//   slot mt % R; a slot for every m-tile (R = the m-tiles of a row group)
//   fits shared memory up to 16 m-tiles, past that R slots are refilled
//   within a step, each once the other block's epilogue has read it (a
//   freed mbarrier in the writer's block, arrived from the reader's).
// - The sums go back into the same shared-memory slot for the epilogue
//   warpgroup, which runs the cell backward of step t-1 for every m-tile in
//   order (fused, as before) while the consumers go on to the next m-tile's
//   products: it loads each m-tile's inputs before waiting for its sums, and
//   before the step's barrier brings the next step's inputs into L2. It
//   writes da (f32, the output) and bf16(da) into the row-major ring slot
//   (t - 1) % 2 that the next step's TMA reads, and the carries.
//
// The narrow-row kernel at the training shape (T 96, B 32, H 1024; plan
// 128 blocks of 8 units in clusters of 2, 16 warps):
// - what bounds it (lstm_ablation.py, NVIDIA H100 80GB HBM3 at 700 W): the
//   serial chain of a step, 11,196 SM clocks (the phase profile of warp 0):
//   the wait for the copy of the block's half of da_t after the grid
//   barrier ~2,300 (128 KiB into each SM), the products ~1,700-2,500, the
//   exchange of the block's sums (the cluster barrier) ~1,000-1,800, the
//   cell ~750, the grid barrier ~1,100-3,600. The empty step (barrier,
//   copy, exchange; no product, no cell) takes 0.52 of 0.62-0.71 ms: T x
//   that is the floor of this design, 13x the byte bound (0.040 ms). The
//   mma.sync kernel's step is 11,829 clocks: its k-loop 6,649 (every block
//   copying all of da_t: 262,144 bytes into each SM, 33,554,432 from L2 a
//   step), the grid barrier 2,564, the cell 1,904.
// - bytes of da_t a step: 131,072 into each SM, 16,777,216 from L2 over
//   the grid (each half read once for its cluster).
//
// Design of the narrow-row kernel:
// - Block b = 2 g + r owns units [8 b, 8 b + 8); the cluster's two blocks
//   take the product of its 16 units over the two halves of K = 4H, rank r
//   half r, copied by cp.async.bulk from the ring after the grid barrier
//   (fragment order: contiguous runs a m-tile).
// - Warp w takes K part w of its half (8 k-steps at H 1024) for both
//   m-tiles and both n-tiles, with those wh fragments in its registers for
//   the whole sequence (32 a thread): a step reads only da_t from shared
//   memory, each A fragment once. The mma.sync kernel read wh's fragments
//   from shared memory every step. With 16 units a block (64 blocks) the
//   fragments take 64 registers a thread and spill: the plan is 8 units in
//   pairs.
// - The block sums its warps' partial tiles in warp order and stores each
//   sum into the receive slot of the block that owns its units
//   (st.shared::cluster); after the cluster barrier the owning thread adds
//   the two halves' sums in rank order: no atomics, equal inputs give equal
//   bits.
// - Thread p owns pairs (row p / 8, unit 8 b + p % 8); the carries dh, dc
//   stay in its registers; gates, c_prev, dhs and the mask of step t-1 are
//   requested with non-caching loads at the top of the step, before the
//   copy; bf16(da_{t-1}) goes to the ring before the grid barrier, the f32
//   da after it.
//
// The mma.sync kernel (rows no narrow plan fits), at 32 rows for scale:
// the sweep is serial in t, and each step's product [B, 4H] x [4H, H] needs
// every unit's da_t: one grid-wide barrier per step; the product is
// 2*32*4096*1024 = 0.27 GFLOP a step, 512 mma.m16n8k16 per block over 128
// blocks; but every block needs all of da_t.
//
// Design of the mma.sync kernel (wh in bf16):
// - Persistent cooperative grid (launch plan from
//   ops/lstm_cuda.py::bwd_plan): block b owns hidden units [b*J, b*J + J),
//   J = 8 * NT, keeps those units' ROWS of wh (wh[j, :], all 4H columns) in
//   shared memory in mma B-fragment order (KS x NT x 256 B; 64 KB at J 8),
//   and waits at one grid.sync() per step.
// - The product dh_blk [B, J] = da_t [B, 4H] x wh_rows^T runs on the tensor
//   cores: with J = 8 it is one m16n8k16 n-tile, 2 m-tiles x 256 k-steps at
//   B 32.
// - Warps split K, not rows: warp w takes k-steps [w*KSW, (w+1)*KSW) of the
//   4H reduction for all rows (16 warps whatever B is), and the partial
//   [B, J] tiles are summed once through shared memory (W x 2 KB at B 32).
// - The cell backward of step t-1 writes da_{t-1} twice: f32 into da (the
//   output) and bf16 into a two-slot ring in A-fragment order
//   (lstm_mma.cuh), rounded where it is produced since the product rounds to
//   bf16 anyway. Each lane then stages exactly its own fragments of its
//   warp's K-slice, CK k-steps per stage, with 16-byte cp.async.cg (L2 only,
//   never a stale L1 line) into a kStages-deep per-warp ring in shared
//   memory and reads each back with one conflict-free 16-byte load: no
//   register round trip, no transposition, no integer division in the loop,
//   and no block-wide barrier per chunk (a lane reads only what it copied
//   itself). Writing the
//   ring in fragment order costs 2-byte scattered stores, B*4H per step over
//   the whole grid; it saves the per-chunk staging of every block.
// - Before each step's barrier, every thread prefetches into L2 the gates,
//   c_prev and dhs lines of the pairs whose cell backward it runs next.
// - The carries live in dh0 / dc0, each element read and written by its one
//   owning thread (dh0 holds (1 - m) * dhk between the two halves of a
//   step). Slot t % 2 is read in step t while step t-1's slot is written;
//   the barrier between steps orders them.
//
// wh in f32 is lstm_f32.cu's (FMA pipes): tensor cores have no exact f32
// product (TF32 keeps 10 bits of mantissa), and the f32 route is defined by
// f32 products.

#include <cooperative_groups.h>

#include "lstm_mma.cuh"
#include "lstm_wgmma.cuh"

namespace cg = cooperative_groups;
using namespace lstm_mma;

namespace {

constexpr int kStages = 4;     // cp.async ring depth per warp (stages in flight: kStages - 1)
constexpr int kFillBatch = 8;  // wh loads a thread keeps in flight while filling b_s

// The cell backward of step t for (row, unit): writes da[t], the carries
// (1 - m) * dhk -> dhc and dc_{t-1} -> dcc, and returns the four da values
// for the caller's ring.
__device__ __forceinline__ void cell_bwd(int t, int row, int unit, int B, int H,
                                         const float* __restrict__ gates,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ cprev,
                                         const float* __restrict__ dhs,
                                         float dh_in, float dc_in,
                                         float* da, float* dhc, float* dcc, float a[4]) {
  const size_t H4 = 4 * (size_t)H;
  const size_t go = ((size_t)t * B + row) * H4 + unit;
  const size_t so = (size_t)row * H + unit;
  const size_t to = (size_t)t * B * H + so;
  const float ig = gates[go], fg = gates[go + H], gg = gates[go + 2 * (size_t)H],
              og = gates[go + 3 * (size_t)H];
  const float cp = cprev[to];
  const float tanh_c = tanhf(fg * cp + ig * gg);
  const float dhk = dh_in + dhs[to];
  const float dck = dc_in;
  const float m = mask[(size_t)t * B + row];
  const float dh_raw = m * dhk;
  const float dc_raw = m * dck;
  const float do_ = dh_raw * tanh_c;
  const float dc_tot = dc_raw + dh_raw * og * (1.f - tanh_c * tanh_c);
  a[0] = dc_tot * gg * ig * (1.f - ig);
  a[1] = dc_tot * cp * fg * (1.f - fg);
  a[2] = dc_tot * ig * (1.f - gg * gg);
  a[3] = do_ * og * (1.f - og);
#pragma unroll
  for (int q = 0; q < 4; ++q) da[go + (size_t)q * H] = a[q];
  dhc[so] = (1.f - m) * dhk;
  dcc[so] = dc_tot * fg + (1.f - m) * dck;
}

// ------------------------------------------------------------ bf16: tensor cores

// The (row, unit) of epilogue slot s of a pass whose first m-tile is mt0:
// slot s = ((m * NT + nt) * 32 + lane) * 4 + c is accumulator c of `lane` for
// m-tile mt0 + m and n-tile nt (the mma C-fragment layout).
template <int NT>
__device__ __forceinline__ void slot_pair(int s, int mt0, int u0, int& row, int& unit) {
  const int c = s & 3, lane = (s >> 2) & 31, nt = (s >> 7) % NT, m = (s >> 7) / NT;
  row = (mt0 + m) * 16 + (lane >> 2) + 8 * (c >> 1);
  unit = u0 + nt * 8 + 2 * (lane & 3) + (c & 1);
}

template <int NT, int MG>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
lstm_bwd_mma_kernel(const float* __restrict__ gates, const float* __restrict__ mask,
                    const __nv_bfloat16* __restrict__ wh, const float* __restrict__ cprev,
                    const float* __restrict__ dhs, const float* __restrict__ dhT,
                    const float* __restrict__ dcT, float* da, __nv_bfloat16* ring,
                    float* dh0, float* dc0, int T_, int B, int H, int CK) {
  constexpr int J = 8 * NT;
  constexpr int SLOTS = MG * NT * 128;  // accumulator slots of one pass over the block
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H, KS = cdiv(H4, 16), MT = cdiv(B, 16);
  const int W = blockDim.x >> 5, KSW = cdiv(KS, W);
  const int u0 = blockIdx.x * J;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t slot_elems = (size_t)MT * KS * kTileElems;
  const int ks0 = min(KS, warp * KSW), ks1 = min(KS, ks0 + KSW);

  const uint2* b_s = reinterpret_cast<const uint2*>(smem);  // [KS][NT][32]
  unsigned char* p = smem + (size_t)KS * NT * 256;
  uint4* a_s = reinterpret_cast<uint4*>(p) + (size_t)warp * kStages * CK * MG * 32;  // [kStages][CK][MG][32]
  float* red = reinterpret_cast<float*>(p + (size_t)W * kStages * CK * MG * 512);    // [W][SLOTS]

  // wh's rows of this block's units, zero-padded, in B-fragment order
  // (B[k, n] = wh[u0 + n, k]); consecutive threads read one wh row, and each
  // thread keeps kFillBatch loads in flight.
  {
    __nv_bfloat16* b_w = reinterpret_cast<__nv_bfloat16*>(smem);
    const int KP = KS * 16;
    for (int base = threadIdx.x; base < J * KP; base += kFillBatch * blockDim.x) {
      __nv_bfloat16 v[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * blockDim.x, n = idx / KP, k = idx % KP;
        v[u] = (idx < J * KP && u0 + n < H && k < H4) ? wh[(size_t)(u0 + n) * H4 + k]
                                                      : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < J * KP) b_w[b_frag_index(idx % KP, idx / KP, NT)] = v[u];
      }
    }
  }
  // bring the inputs of the cell backward of step t for this thread's pairs into L2
  auto prefetch_cell = [&](int t) {
    for (int mt0 = 0; mt0 < MT; mt0 += MG)
      for (int s = threadIdx.x; s < SLOTS; s += blockDim.x) {
        int row, unit;
        slot_pair<NT>(s, mt0, u0, row, unit);
        if (row >= B || unit >= H) continue;
        const size_t go = ((size_t)t * B + row) * H4 + unit, to = ((size_t)t * B + row) * H + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) prefetch_l2(gates + go + (size_t)q * H);
        prefetch_l2(cprev + to);
        prefetch_l2(dhs + to);
      }
  };

  auto to_ring = [&](int t, int row, int unit, const float a[4]) {
    __nv_bfloat16* r = ring + (size_t)(t & 1) * slot_elems;
#pragma unroll
    for (int q = 0; q < 4; ++q) r[a_frag_index(row, q * H + unit, KS)] = __float2bfloat16(a[q]);
  };

  // step T-1: the cell backward from the final carries dhT, dcT
  for (int mt0 = 0; mt0 < MT; mt0 += MG) {
    for (int s = threadIdx.x; s < SLOTS; s += blockDim.x) {
      int row, unit;
      slot_pair<NT>(s, mt0, u0, row, unit);
      if (row >= B || unit >= H) continue;
      const size_t so = (size_t)row * H + unit;
      float a[4];
      cell_bwd(T_ - 1, row, unit, B, H, gates, mask, cprev, dhs, dhT[so], dcT[so],
               da, dh0, dc0, a);
      to_ring(T_ - 1, row, unit, a);
    }
  }
  __syncthreads();

  for (int t = T_ - 1; t >= 0; --t) {
    if (t > 0) prefetch_cell(t - 1);
    grid.sync();  // da_t (ring slot t % 2) is complete in every block
    const __nv_bfloat16* src = ring + (size_t)(t & 1) * slot_elems + lane * 8;
    for (int mt0 = 0; mt0 < MT; mt0 += MG) {
      bool live[MG];
#pragma unroll
      for (int m = 0; m < MG; ++m) live[m] = mt0 + m < MT;
      float acc[MG][NT][4];
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][nt][c] = 0.f;

      // stage i: k-steps [ks0 + i*CK, ks0 + i*CK + CK) of this warp's slice;
      // each lane copies its own fragments into ring slot i % kStages
      const int n_items = cdiv(ks1 - ks0, CK);
      auto issue = [&](int i) {
        uint4* d = a_s + (size_t)(i % kStages) * CK * MG * 32 + lane;
        for (int kk = 0; kk < CK; ++kk) {
          const int ks = ks0 + i * CK + kk;
          if (ks >= ks1) break;
#pragma unroll
          for (int m = 0; m < MG; ++m)
            if (live[m])
              cp_async16(d + (kk * MG + m) * 32, src + ((size_t)(mt0 + m) * KS + ks) * kTileElems);
        }
      };
#pragma unroll
      for (int s = 0; s < kStages - 1; ++s) {
        if (s < n_items) issue(s);
        cp_async_commit();
      }
      for (int i = 0; i < n_items; ++i) {
        if (i + kStages - 1 < n_items) issue(i + kStages - 1);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
        const uint4* a = a_s + (size_t)(i % kStages) * CK * MG * 32 + lane;
        for (int kk = 0; kk < CK; ++kk) {
          const int ks = ks0 + i * CK + kk;
          if (ks >= ks1) break;
          const uint2* b = b_s + (size_t)ks * NT * 32 + lane;
#pragma unroll
          for (int m = 0; m < MG; ++m) {
            if (!live[m]) continue;
            const uint4 af = a[(kk * MG + m) * 32];
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[m][nt], af, b[nt * 32]);
          }
        }
      }

      // sum the warps' partial tiles, then the cell backward of step t-1
      float4* mine = reinterpret_cast<float4*>(red + (size_t)warp * SLOTS) + lane;
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mine[(m * NT + nt) * 32] = make_float4(acc[m][nt][0], acc[m][nt][1], acc[m][nt][2],
                                                 acc[m][nt][3]);
      __syncthreads();
      for (int s = threadIdx.x; s < SLOTS; s += blockDim.x) {
        int row, unit;
        slot_pair<NT>(s, mt0, u0, row, unit);
        if (row >= B || unit >= H) continue;
        float sum = 0.f;
        for (int w = 0; w < W; ++w) sum += red[(size_t)w * SLOTS + s];
        const size_t so = (size_t)row * H + unit;
        const float dh = sum + dh0[so];
        if (t > 0) {
          float a[4];
          cell_bwd(t - 1, row, unit, B, H, gates, mask, cprev, dhs, dh, dc0[so], da, dh0, dc0, a);
          to_ring(t - 1, row, unit, a);
        } else {
          dh0[so] = dh;
        }
      }
      __syncthreads();  // red is rewritten by the next pass
    }
  }
}

size_t mma_smem_bytes(int H, int NT, int W, int MG, int CK) {
  return (size_t)cdiv(4 * H, 16) * NT * 256 + (size_t)W * kStages * CK * MG * 512
         + (size_t)W * MG * NT * 512;
}

template <int NT, int MG>
cudaError_t launch_mma(const float* gates, const float* mask, const __nv_bfloat16* wh,
                       const float* cprev, const float* dhs, const float* dhT, const float* dcT,
                       float* da, __nv_bfloat16* ring, float* dh0, float* dc0, int T_, int B,
                       int H, int W, int CK, size_t smem, cudaStream_t stream) {
  const int grid = cdiv(H, 8 * NT);
  auto kern = lstm_bwd_mma_kernel<NT, MG>;
  cudaError_t err = check_cooperative((const void*)kern, grid, W * 32, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&gates, (void*)&mask, (void*)&wh, (void*)&cprev, (void*)&dhs,
                  (void*)&dhT, (void*)&dcT, (void*)&da, (void*)&ring, (void*)&dh0,
                  (void*)&dc0, (void*)&T_, (void*)&B, (void*)&H, (void*)&CK};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(W * 32), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ------------------------------------------------------------ bf16: narrow rows
// The narrow-row path (ops/lstm_cuda.py::NarrowPlan): the cluster splits
// K, its blocks swap partial dh tiles through distributed shared memory,
// wh in registers, the carries in registers, the cell's inputs requested
// before the step's copy.
namespace narrow {
namespace wg = lstm_wgmma;

constexpr int kMaxPairs = 2;     // (row, unit) pairs a thread owns at most
constexpr int kMaxM = 2;         // m-tiles (rows / 16) the kernel takes
constexpr int kMaxKPW = 8;       // k-steps of a warp's K part (its B fragments in registers)
constexpr int kSumBatch = 8;     // partial tiles a thread loads before adding them, in order

// Byte offsets in shared memory: the slice of da_t in the ring's fragment
// order [MT][KSC] x 512 bytes, the warps' partial tiles [W][MT][C NT][32]
// float4, the receive slots [C ranks][MT][NT][32] float4, the full
// mbarrier. wh lives in registers.
struct Smem {
  size_t red, recv, bar, total;
};
__host__ __device__ inline Smem smem_layout(int H, int NT, int C, int MT, int W) {
  const size_t KSC = cdiv(cdiv(4 * H, 16), C);
  Smem s;
  s.red = (size_t)MT * KSC * 512;
  s.recv = s.red + (size_t)W * MT * C * NT * 512;
  s.bar = s.recv + (size_t)C * MT * NT * 512;
  s.total = s.bar + 8;
  return s;
}

// Block b = g C + r (cluster g, rank r) owns units [b J, b J + J), J = 8 NT,
// for every row; the cluster's C blocks take the product of its C J units
// over the C slices of K = 4H, rank r slice r: k-steps [r KSC, r KSC + KSC)
// of da_t, copied from the ring (cp.async.bulk) after the grid barrier that
// ends the step before. Warp w takes K part w of the
// slice (KPW k-steps) for every m-tile and every n-tile of the cluster's
// units, with its B fragments (wh's rows there) held in registers for the
// whole sequence: a step reads only da_t from shared memory, each A
// fragment once. The block sums its warps' partial tiles in warp order and
// stores each sum into the receive slot of the block that owns the
// n-tile's units (st.shared::cluster); after the cluster barrier the owner
// adds the C ranks' sums in rank order: no atomics, the same bits every
// run.
template <int NT, int C>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
lstm_bwd_narrow_kernel(const float* __restrict__ gates, const float* __restrict__ mask,
                       const __nv_bfloat16* __restrict__ wh, const float* __restrict__ cprev,
                       const float* __restrict__ dhs, const float* __restrict__ dhT,
                       const float* __restrict__ dcT, float* __restrict__ da,
                       __nv_bfloat16* __restrict__ ring, float* __restrict__ dh0,
                       float* __restrict__ dc0, int T_, int B, int H) {
  constexpr int J = 8 * NT;
  constexpr int NTU = C * NT;  // n-tiles of the cluster's units
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int H4 = 4 * H, KS = cdiv(H4, 16), MT = cdiv(B, 16);
  const int nthr = blockDim.x, W = nthr >> 5, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int crank = (int)cluster.block_rank();
  const int KSC = cdiv(KS, C), k0 = min(KS, crank * KSC), k1 = min(KS, k0 + KSC);
  const int KPW = cdiv(KSC, W), kw0 = min(k1, k0 + warp * KPW), kw1 = min(k1, kw0 + KPW);
  const int uc = (blockIdx.x - crank) * J, u0 = blockIdx.x * J;
  const size_t slot_elems = (size_t)MT * KS * kTileElems;
  const Smem L = smem_layout(H, NT, C, MT, W);
  const uint4* a_s = reinterpret_cast<const uint4*>(smem);
  float4* red = reinterpret_cast<float4*>(smem + L.red);
  const float* recv = reinterpret_cast<const float*>(smem + L.recv);
  const uint32_t s_a = wg::smem_u32(smem), s_recv = wg::smem_u32(smem + L.recv);
  const uint32_t full_bar = wg::smem_u32(smem + L.bar);
  // this lane's B fragments of its warp's K part, for good: B[k, n] =
  // wh[uc + n, k] (zero past H and 4H), registers b0, b1 of m16n8k16 (PTX
  // ISA): k = 16 ks + 2 (lane % 4) + {0, 1} (+ 8 for b1), n = 8 nt + lane / 4
  uint2 bfr[kMaxKPW][NTU];
#pragma unroll
  for (int kk = 0; kk < kMaxKPW; ++kk)
#pragma unroll
    for (int nt = 0; nt < NTU; ++nt) {
      const int ks = kw0 + kk, n = uc + 8 * nt + (lane >> 2);
      uint32_t v[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int k = 16 * ks + 2 * (lane & 3) + 8 * r;
        const bool ok = kk < KPW && ks < kw1 && n < H;
        const __nv_bfloat16 lo = ok && k < H4 ? wh[(size_t)n * H4 + k] : __float2bfloat16(0.f);
        const __nv_bfloat16 hi =
            ok && k + 1 < H4 ? wh[(size_t)n * H4 + k + 1] : __float2bfloat16(0.f);
        v[r] = (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
      }
      bfr[kk][nt] = make_uint2(v[0], v[1]);
    }
  // this thread's pairs p = tid + i nthr: row p / J, unit u0 + p % J; their
  // carries dh ((1 - m) dhk between steps) and dc live in registers
  int prow[kMaxPairs], punit[kMaxPairs];
  bool pok[kMaxPairs];
  float dh[kMaxPairs], dc[kMaxPairs];
  float g4[kMaxPairs][4], cpv[kMaxPairs], dhsv[kMaxPairs], mk[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = tid + i * nthr;
    prow[i] = p / J;
    punit[i] = u0 + p % J;
    pok[i] = prow[i] < B && punit[i] < H;
    const size_t so = (size_t)prow[i] * H + punit[i];
    dh[i] = pok[i] ? dhT[so] : 0.f;
    dc[i] = pok[i] ? dcT[so] : 0.f;
  }
  // the cell inputs of step tc for this thread's pairs
  auto load_in = [&](int tc) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const size_t to = ((size_t)tc * B + prow[i]) * H + punit[i];
      const size_t go = ((size_t)tc * B + prow[i]) * H4 + punit[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) g4[i][q] = pok[i] ? ld_nc(gates + go + (size_t)q * H) : 0.f;
      cpv[i] = pok[i] ? ld_nc(cprev + to) : 0.f;
      dhsv[i] = pok[i] ? ld_nc(dhs + to) : 0.f;
      mk[i] = pok[i] ? ld_nc(mask + (size_t)tc * B + prow[i]) : 0.f;
    }
  };
  // the cell backward of step tc from dh_in: its bf16 da in ring slot tc %
  // 2, the carries (as cell_bwd above); the f32 da stays in dav for
  // store_da, once the ring slot is published
  float dav[kMaxPairs][4];
  auto store_da = [&](int tc) {
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      if (!pok[i]) continue;
      const size_t go = ((size_t)tc * B + prow[i]) * H4 + punit[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) da[go + (size_t)q * H] = dav[i][q];
    }
  };
  auto cell = [&](int tc, int i, float dh_in) {
    const float ig = g4[i][0], fg = g4[i][1], gg = g4[i][2], og = g4[i][3], cp = cpv[i];
    const float tanh_c = tanhf(fg * cp + ig * gg);
    const float dhk = dh_in + dhsv[i];
    const float dck = dc[i];
    const float m = mk[i];
    const float dh_raw = m * dhk, dc_raw = m * dck;
    const float do_ = dh_raw * tanh_c;
    const float dc_tot = dc_raw + dh_raw * og * (1.f - tanh_c * tanh_c);
    float a[4];
    a[0] = dc_tot * gg * ig * (1.f - ig);
    a[1] = dc_tot * cp * fg * (1.f - fg);
    a[2] = dc_tot * ig * (1.f - gg * gg);
    a[3] = do_ * og * (1.f - og);
    __nv_bfloat16* r = ring + (size_t)(tc & 1) * slot_elems;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      dav[i][q] = a[q];
      r[a_frag_index(prow[i], q * H + punit[i], KS)] = __float2bfloat16(a[q]);
    }
    dh[i] = (1.f - m) * dhk;
    dc[i] = dc_tot * fg + (1.f - m) * dck;
  };

  if (tid == 0) {
    wg::mbar_init(full_bar, 1);
    wg::fence_mbar_init();
  }
  // step T-1: the cell backward from the final carries dhT, dcT
  load_in(T_ - 1);
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i)
    if (pok[i]) cell(T_ - 1, i, dh[i]);
  cluster.sync();  // the barrier's init, before the cluster's stores into its slots
  if (tid == 0) wg::fence_proxy_async_global();  // the ring stores, before the bulk copies
  grid.sync();
  store_da(T_ - 1);

  for (int t = T_ - 1; t >= 0; --t) {
    const int s = T_ - 1 - t;  // steps done
    if (t > 0) load_in(t - 1);
    // this block's K slice of da_t (ring slot t % 2), by the last warp's
    // lane 0 (the fewest pairs)
    if (tid == nthr - 32 && k0 < k1) {
      wg::fence_proxy_async_global();  // the ring stores before the barrier, before this copy
      wg::mbar_arrive_tx(full_bar, (uint32_t)(MT * (k1 - k0) * 512));
      const __nv_bfloat16* src = ring + (size_t)(t & 1) * slot_elems;
      for (int mt = 0; mt < MT; ++mt)
        bulk_load(s_a + (uint32_t)mt * KSC * 512, src + ((size_t)mt * KS + k0) * kTileElems,
                  (uint32_t)(k1 - k0) * 512, full_bar);
    }
    if (k0 < k1) wg::mbar_wait(full_bar, s & 1);

    // this warp's partial dh tiles: every m-tile x every n-tile over its K
    // part, into the block's partial tiles
    {
      float acc[kMaxM][NTU][4];
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
#pragma unroll
        for (int n = 0; n < NTU; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kMaxKPW; ++kk) {
        if (kw0 + kk >= kw1) break;
        uint4 af[kMaxM];
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
          if (m < MT) af[m] = a_s[((size_t)m * KSC + kw0 + kk - k0) * 32 + lane];
#pragma unroll
        for (int m = 0; m < kMaxM; ++m)
#pragma unroll
          for (int n = 0; n < NTU; ++n)
            if (m < MT) mma_bf16(acc[m][n], af[m], bfr[kk][n]);
      }
#pragma unroll
      for (int m = 0; m < kMaxM; ++m)
#pragma unroll
        for (int n = 0; n < NTU; ++n)
          if (m < MT)
            red[(((size_t)warp * MT + m) * NTU + n) * 32 + lane] =
                make_float4(acc[m][n][0], acc[m][n][1], acc[m][n][2], acc[m][n][3]);
    }
    __syncthreads();
    // the block's sum of each partial tile, in warp order, to the block that
    // owns the tile's units: thread (m, n, lane) of MT x C NT x 32
    if (tid < MT * NTU * 32) {
      const int m = tid / (NTU * 32), n = (tid / 32) % NTU, l = tid & 31;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w0 = 0; w0 < W; w0 += kSumBatch) {  // kSumBatch loads in flight, then the adds
        float4 part[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (w0 + u < W) part[u] = red[(((size_t)(w0 + u) * MT + m) * NTU + n) * 32 + l];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (w0 + u < W) {
            v.x += part[u].x;
            v.y += part[u].y;
            v.z += part[u].z;
            v.w += part[u].w;
          }
      }
      const int owner = n / NT, nl = n % NT;
      const uint32_t slot = s_recv + (uint32_t)((((size_t)crank * MT + m) * NT + nl) * 32 + l) * 16;
      wg::st_cluster(wg::map_rank(slot, owner), v);
    }
    cluster.sync();  // every partial tile is in its owner's receive slot

    // the owner's sums, in source order, then the cell backward of step t-1
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      if (!pok[i]) continue;
      const int r16 = prow[i] & 15, j = punit[i] - u0;
      const int pl = (r16 & 7) * 4 + ((j & 7) >> 1), pc = (r16 >> 3) * 2 + (j & 1);
      const int pm = prow[i] >> 4, nl = j >> 3;
      const float* rp = recv + ((size_t)pm * NT + nl) * 128 + pl * 4 + pc;
      float sum = 0.f;
#pragma unroll
      for (int r = 0; r < C; ++r) sum += rp[(size_t)r * MT * NT * 128];  // the ranks' sums in order
      const float dh_in = sum + dh[i];
      if (t > 0)
        cell(t - 1, i, dh_in);
      else
        dh[i] = dh_in;
    }
    if (t > 0) {  // da_{t-1} is out in every block; the receive slots are read
      __syncthreads();
      if (tid == 0) wg::fence_proxy_async_global();  // the block's ring stores, before bulk copies
      grid.sync();
      store_da(t - 1);  // after the barrier: the next step's copy does not wait for it
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    if (!pok[i]) continue;
    const size_t so = (size_t)prow[i] * H + punit[i];
    dh0[so] = dh[i];
    dc0[so] = dc[i];
  }
  cluster.sync();  // no block leaves while another may still write to it
}

template <int NT, int C>
cudaError_t launch(const float* gates, const float* mask, const __nv_bfloat16* wh,
                   const float* cprev, const float* dhs, const float* dhT, const float* dcT,
                   float* da, __nv_bfloat16* ring, float* dh0, float* dc0, int T_, int B, int H,
                   int W, size_t smem, cudaStream_t stream) {
  const int grid = cdiv(cdiv(H, 8 * NT), C) * C;
  return wg::launch_cluster_cooperative(lstm_bwd_narrow_kernel<NT, C>, grid, W * 32, smem, C,
                                        stream, gates, mask, wh, cprev, dhs, dhT, dcT, da, ring,
                                        dh0, dc0, T_, B, H);
}

}  // namespace narrow

// ------------------------------------------------------------ bf16: wide rows
// The wide-row path (ops/lstm_cuda.py::WidePlan): wgmma, TMA, clusters.
namespace wide {
namespace wg = lstm_wgmma;

constexpr int kWarpgroups = 2;                // consumer warpgroups, 64-row m-tiles each
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kProducers = 32 * kWarpgroups;  // a producer warp for each
constexpr int kThreads = kConsumers + kProducers + 128;  // + the epilogue warpgroup
constexpr int kStages = 4;                    // deepest TMA ring of a warpgroup (plan: 2..4)
constexpr int kUnits = 32;                    // units a block: the product's N
constexpr int kCluster = 2;                   // the two K halves of one (row group, unit group)
constexpr int kBSlabBytes = kUnits * 128;     // one 64-k slab of the block's wh rows
constexpr int kRecvBytes = 128 * 8 * 4;       // a receive slot: 128 threads x 8 f32

// R receive slots, each with three mbarriers (received, summed, freed)
size_t smem_bytes(int Kp, int S, int R) {
  return (size_t)wg::kAlign + (size_t)(Kp / kCluster / wg::kSlab) * kBSlabBytes
         + (size_t)kWarpgroups * S * wg::kTileBytes + (size_t)R * kRecvBytes
         + 8 * ((size_t)2 * kWarpgroups * S + 3 * R);
}

__device__ __forceinline__ float pick(float2 v, int e) { return e ? v.y : v.x; }

// The cell backward's inputs of a thread's 8 pairs p = 4 ii + 2 h + e of
// one m-tile (row r(h), unit u(ii) + e), loaded while the product runs.
struct CellIn {
  float2 g[2][2][4], cp[2][2], dhs[2][2], dh[2][2], dc[2][2];
  float m[2];
};

// Block b = 2 (rg * UG + ug) + kc: rows [rg MP, rg MP + MP) x units
// [32 ug, 32 ug + 32), k in [kc Kp / 2, kc Kp / 2 + Kp / 2); the cluster is
// the two K halves, and block kc owns units [32 ug + 16 kc, + 16). The
// other half's partial tile of m-tile mt lands in receive slot mt % R.
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_wide_kernel(const __grid_constant__ CUtensorMap tm_da,
                     const float* __restrict__ gates, const float* __restrict__ mask,
                     const __nv_bfloat16* __restrict__ wh, const float* __restrict__ cprev,
                     const float* __restrict__ dhs, const float* __restrict__ dhT,
                     const float* __restrict__ dcT, float* __restrict__ da,
                     __nv_bfloat16* __restrict__ ring, float* __restrict__ dh0,
                     float* __restrict__ dc0, int T_, int B, int H, int Kp, int Rp, int MP,
                     int UG, int S, int R) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sB = (raw + wg::kAlign - 1) & ~(uint32_t)(wg::kAlign - 1);
  unsigned char* smem = smem_raw + (sB - raw);
  const int Kh = Kp / kCluster, KS = Kh / wg::kSlab;
  const uint32_t sA = sB + KS * kBSlabBytes;                   // [kWarpgroups][S] tiles
  const uint32_t sR = sA + kWarpgroups * S * wg::kTileBytes;   // [R] receive slots
  const uint32_t sBar = sR + R * kRecvBytes;
  auto full_bar = [&](int w, int s) { return sBar + 8u * (w * S + s); };
  auto empty_bar = [&](int w, int s) { return sBar + 8u * ((kWarpgroups + w) * S + s); };
  // receive slot j: the other half has arrived, the sums are there for the
  // epilogue, and (arrived from the other block) the other block's slot j
  // has been read by its epilogue
  auto recv_bar = [&](int j) { return sBar + 8u * (2 * kWarpgroups * S + j); };
  auto epi_bar = [&](int j) { return sBar + 8u * (2 * kWarpgroups * S + R + j); };
  auto free_bar = [&](int j) { return sBar + 8u * (2 * kWarpgroups * S + 2 * R + j); };

  const int kc = (int)cluster.block_rank(), pk = 1 - kc;
  const int pair = blockIdx.x / kCluster, rg = pair / UG, ug = pair % UG;
  const int u0 = ug * kUnits, row0 = rg * MP, kbase = kc * Kh;
  const int MTb = cdiv(max(0, min(MP, B - row0)), wg::kTileRows);
  // consumer warpgroup w = tid / 128, the producer warp of warpgroup w, or
  // the epilogue warpgroup (its thread lt runs the cell backward of the pairs
  // that consumer thread lt's registers hold, in every m-tile)
  const int tid = threadIdx.x;
  const bool producer = tid >= kConsumers && tid < kConsumers + kProducers;
  const bool epilogue = tid >= kConsumers + kProducers;
  const int w = producer ? (tid - kConsumers) >> 5 : epilogue ? 0 : tid >> 7;
  const int lt = epilogue ? tid - kConsumers - kProducers : tid & 127, wq = lt >> 5;
  const int lane = tid & 31, g8 = lane >> 2, tq = lane & 3;
  const size_t H4 = 4 * (size_t)H;
  const int n_mt = MTb > w ? cdiv(MTb - w, kWarpgroups) : 0;  // warpgroup w's m-tiles
  const int n_loads = n_mt * KS;                                // its A tiles a step
  // fewer receive slots than m-tiles: a slot is written again within a step,
  // once the other block's epilogue has read it (its freed barrier here)
  const bool recycle = R < MTb;
  // m-tile mt of step t is the (n U_j + mt / R)-th use of slot j = mt % R,
  // n = T-1-t, U_j = the slot's uses a step: each of its barriers completes
  // once a use, so this is the phase the use waits for
  auto slot_use = [&](int t, int mt) {
    return (uint32_t)((T_ - 1 - t) * cdiv(MTb - mt % R, R) + mt / R);
  };

  // wh's rows of this block's units, this block's K half, as the K-major B
  // operand, zero-padded: B[n][k] = wh[u0 + n, kbase + k]; consecutive
  // threads read consecutive k of one wh row.
  {
    const int total = kUnits * Kh;
    for (int base = tid; base < total; base += kFillBatch * kThreads) {
      __nv_bfloat16 v[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * kThreads, n = idx / Kh, k = idx % Kh;
        v[u] = (idx < total && u0 + n < H && kbase + k < 4 * H)
                   ? wh[(size_t)(u0 + n) * H4 + kbase + k] : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * kThreads, n = idx / Kh, k = idx % Kh;
        if (idx < total)
          *reinterpret_cast<__nv_bfloat16*>(smem + (k / wg::kSlab) * kBSlabBytes
                                            + wg::swz_elem(n, k % wg::kSlab)) = v[u];
      }
    }
  }
  if (tid == 0) {
    for (int w = 0; w < kWarpgroups; ++w)
      for (int s = 0; s < S; ++s) {
        wg::mbar_init(full_bar(w, s), 1);
        wg::mbar_init(empty_bar(w, s), 1);
      }
    for (int j = 0; j < R; ++j) {
      wg::mbar_init(recv_bar(j), 128);
      wg::mbar_init(epi_bar(j), 128);
      wg::mbar_init(free_bar(j), 128);
    }
    wg::fence_mbar_init();
  }
  wg::fence_proxy_async_smem();  // the B fill, before wgmma reads it
  __syncthreads();
  cluster.sync();

  // this thread's pairs in m-tile mt: row r(h) = row0 + 64 mt + 16 wq + g8 +
  // 8 h, unit u(ii) = u0 + 16 kc + 8 ii + 2 tq (+ e); the accumulator
  // registers 8 kc + 4 ii + 2 h + e hold them (wgmma's column 8 i + 2 tq + e)
  auto pair_at = [&](int mt, int h, int ii, int& row, int& unit) {
    row = row0 + mt * wg::kTileRows + wq * 16 + g8 + 8 * h;
    unit = u0 + 16 * kc + 8 * ii + 2 * tq;
    return row < B && unit < H;
  };
  auto f2 = [](const float* p) { return *reinterpret_cast<const float2*>(p); };
  // the inputs of the cell backward of step tc (tc = -1: the carry dh only)
  auto load_in = [&](int tc, int mt, bool init, CellIn& in) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        int row, unit;
        const bool ok = pair_at(mt, h, ii, row, unit);
        const float2 z = make_float2(0.f, 0.f);
        const size_t so = (size_t)row * H + unit;
        in.dh[h][ii] = ok ? f2((init ? dhT : dh0) + so) : z;
        if (tc < 0) continue;
        const size_t to = (size_t)tc * B * H + so, go = ((size_t)tc * B + row) * H4 + unit;
        if (ii == 0) in.m[h] = row < B ? mask[(size_t)tc * B + row] : 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) in.g[h][ii][q] = ok ? f2(gates + go + (size_t)q * H) : z;
        in.cp[h][ii] = ok ? f2(cprev + to) : z;
        in.dhs[h][ii] = ok ? f2(dhs + to) : z;
        in.dc[h][ii] = ok ? f2((init ? dcT : dc0) + so) : z;
      }
    }
  };
  // the cell backward of step tc from dh = dsum + carry: da[tc], its bf16
  // copy in ring slot tc % 2, and the carries (as cell_bwd above)
  auto cell = [&](int tc, int mt, const CellIn& in, const float (&dsum)[8]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        int row, unit;
        if (!pair_at(mt, h, ii, row, unit)) continue;
        float a[4][2], dhc[2], dcc[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ig = pick(in.g[h][ii][0], e), fg = pick(in.g[h][ii][1], e),
                      gg = pick(in.g[h][ii][2], e), og = pick(in.g[h][ii][3], e);
          const float cp = pick(in.cp[h][ii], e);
          const float tanh_c = tanhf(fg * cp + ig * gg);
          const float dhk = (dsum[4 * ii + 2 * h + e] + pick(in.dh[h][ii], e))
                            + pick(in.dhs[h][ii], e);
          const float dck = pick(in.dc[h][ii], e);
          const float m = in.m[h];
          const float dh_raw = m * dhk, dc_raw = m * dck;
          const float do_ = dh_raw * tanh_c;
          const float dc_tot = dc_raw + dh_raw * og * (1.f - tanh_c * tanh_c);
          a[0][e] = dc_tot * gg * ig * (1.f - ig);
          a[1][e] = dc_tot * cp * fg * (1.f - fg);
          a[2][e] = dc_tot * ig * (1.f - gg * gg);
          a[3][e] = do_ * og * (1.f - og);
          dhc[e] = (1.f - m) * dhk;
          dcc[e] = dc_tot * fg + (1.f - m) * dck;
        }
        const size_t so = (size_t)row * H + unit, go = ((size_t)tc * B + row) * H4 + unit;
        __nv_bfloat16* rr = ring + ((size_t)(tc & 1) * Rp + row) * Kp + unit;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          *reinterpret_cast<float2*>(da + go + (size_t)q * H) = make_float2(a[q][0], a[q][1]);
          *reinterpret_cast<__nv_bfloat162*>(rr + (size_t)q * H) =
              __floats2bfloat162_rn(a[q][0], a[q][1]);
        }
        *reinterpret_cast<float2*>(dh0 + so) = make_float2(dhc[0], dhc[1]);
        *reinterpret_cast<float2*>(dc0 + so) = make_float2(dcc[0], dcc[1]);
      }
    }
  };
  // bring the inputs of the cell backward of step tc for this thread's pairs into L2
  auto prefetch_cell = [&](int tc) {
    for (int mt = 0; mt < MTb; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          int row, unit;
          if (!pair_at(mt, h, ii, row, unit)) continue;
          const size_t to = ((size_t)tc * B + row) * H + unit, go = ((size_t)tc * B + row) * H4 + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) prefetch_l2(gates + go + (size_t)q * H);
          prefetch_l2(cprev + to);
          prefetch_l2(dhs + to);
        }
  };

  // step T-1: the cell backward from the final carries dhT, dcT
  if (epilogue) {
    const float zero[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int mt = 0; mt < MTb; ++mt) {
      CellIn in;
      load_in(T_ - 1, mt, true, in);
      cell(T_ - 1, mt, in, zero);
    }
    wg::fence_proxy_async();  // the ring stores, before the TMA reads of other blocks
  }

  uint32_t seq = 0;  // warpgroup w's A tiles so far
  float acc[kUnits / 2];
#pragma unroll
  for (int i = 0; i < kUnits / 2; ++i) acc[i] = 0.f;
  for (int t = T_ - 1; t >= 0; --t) {
    if (epilogue && t > 0) prefetch_cell(t - 1);
    grid.sync();  // da_t (ring slot t % 2) is complete in every block
    if (producer) {
      // warpgroup w's A tiles of this step in order: m-tile w + (i / KS)
      // kWarpgroups, k slab i % KS of this block's K half, each once its
      // slot has been released
      if (lane == 0 && n_loads > 0) {
        wg::fence_proxy_async();  // the other blocks' ring stores, before this TMA reads them
        const int src_row = (t & 1) * Rp + row0;
        for (int i = 0; i < n_loads; ++i) {
          const uint32_t g = seq + i, use = g / S;
          const int s = g % S, mt = w + (i / KS) * kWarpgroups, ks = i % KS;
          if (use > 0) wg::mbar_wait(empty_bar(w, s), (use - 1) & 1);
          wg::mbar_arrive_tx(full_bar(w, s), wg::kTileBytes);
          wg::tma_load_2d(sA + (w * S + s) * wg::kTileBytes, &tm_da, kbase + ks * wg::kSlab,
                          src_row + mt * wg::kTileRows, full_bar(w, s));
        }
      }
      __syncwarp();
    } else if (epilogue) {
      // the cell backward of step t - 1 (at t = 0, dh0) for every m-tile,
      // in order, as the consumers hand over each m-tile's sums
      for (int mt = 0; mt < MTb; ++mt) {
        CellIn in;
        load_in(t - 1, mt, false, in);
        const int j = mt % R;
        wg::mbar_wait(epi_bar(j), slot_use(t, mt) & 1);
        const float4* got = reinterpret_cast<const float4*>(smem + (sR - sB) + j * kRecvBytes
                                                            + lt * 32);
        const float4 r0 = got[0], r1 = got[1];
        if (recycle) wg::mbar_arrive_rank(free_bar(j), pk);  // the slot may be written again
        const float dsum[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
        if (t > 0) {
          cell(t - 1, mt, in, dsum);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              int row, unit;
              if (!pair_at(mt, h, ii, row, unit)) continue;
              const int p = 4 * ii + 2 * h;
              *reinterpret_cast<float2*>(dh0 + (size_t)row * H + unit) =
                  make_float2(dsum[p] + in.dh[h][ii].x, dsum[p + 1] + in.dh[h][ii].y);
            }
        }
      }
      wg::fence_proxy_async();  // this step's ring stores, before the next step's TMA reads
    } else {
      int i = 0;
      for (int mi = 0; mi < n_mt; ++mi) {
        const int mt = w + mi * kWarpgroups;
        for (int ks = 0; ks < KS; ++ks, ++i) {
          const uint32_t g = seq + i;
          const int s = g % S;
          wg::mbar_wait(full_bar(w, s), (g / S) & 1);
          wg::wgmma_fence();
          wg::wgmma_slab<kUnits>(acc, sA + (w * S + s) * wg::kTileBytes, sB + ks * kBSlabBytes,
                                 ks == 0);
          wg::wgmma_commit();
          wg::wgmma_wait<1>();  // tile i - 1 has been read: its slot may be refilled
          if (lt == 0 && ks > 0) wg::mbar_arrive(empty_bar(w, (seq + i - 1) % S));
          __syncwarp();
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(acc);
        if (lt == 0) wg::mbar_arrive(empty_bar(w, (seq + i - 1) % S));
        __syncwarp();

        // the K halves: this thread's partial of the other block's pairs goes
        // to the thread with the same index there, which owns them; it sums
        // (its half) + (this half), one fixed order, no atomics, and leaves
        // the sums in the same slot for the epilogue warpgroup
        float mine[8], theirs[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mine[j] = kc ? acc[8 + j] : acc[j];
          theirs[j] = kc ? acc[j] : acc[8 + j];
        }
        const int j = mt % R;
        const uint32_t use = slot_use(t, mt);
        const uint32_t slot = sR + j * kRecvBytes + lt * 32;
        const uint32_t remote = wg::map_rank(slot, pk);
        if (mt >= R) wg::mbar_wait_cluster(free_bar(j), (use - 1) & 1);  // its last use read
        wg::st_cluster(remote, make_float4(theirs[0], theirs[1], theirs[2], theirs[3]));
        wg::st_cluster(remote + 16, make_float4(theirs[4], theirs[5], theirs[6], theirs[7]));
        wg::mbar_arrive_rank(recv_bar(j), pk);
        wg::mbar_wait_cluster(recv_bar(j), use & 1);
        float4* got = reinterpret_cast<float4*>(smem + (slot - sB));
        const float4 r0 = got[0], r1 = got[1];
        got[0] = make_float4(mine[0] + r0.x, mine[1] + r0.y, mine[2] + r0.z, mine[3] + r0.w);
        got[1] = make_float4(mine[4] + r1.x, mine[5] + r1.y, mine[6] + r1.z, mine[7] + r1.w);
        wg::mbar_arrive(epi_bar(j));
      }
    }
    seq += n_loads;
  }
  cluster.sync();  // no block leaves while the other may still write to it
}

}  // namespace wide

}  // namespace

extern "C" {

// gates [T, B, 4H] (activations i, f, g, o), mask [T, B], c_prev [T, B, H]
// (c_{t-1}, c_0 first), dhs [T, B, H], dhT, dcT [B, H]: all f32; wh [H, 4H]
// bf16. Writes da [T, B, 4H], dh0, dc0 [B, H] (f32); ring is the bf16 da
// ring [2, ceil(B/16), ceil(4H/16), 256], zeros on entry. The launch plan
// (ops/lstm_cuda.py::bwd_plan): n_sub NT (J = 8 NT units per block), warps,
// m_group MG, k_chunk CK (k-steps per pipeline stage), stages, smem_bytes;
// it is checked here and refused with cudaErrorInvalidValue when it is not
// one this kernel was built for.
// Returns a cudaError_t.
int lstm_bwd_bf16(const float* gates, const float* mask, const void* wh, const float* cprev,
                  const float* dhs, const float* dhT, const float* dcT, float* da, void* ring,
                  float* dh0, float* dc0, int T, int B, int H, int n_sub, int warps,
                  int m_group, int k_chunk, int stages, int smem_bytes, void* stream) {
  const int NT = n_sub, W = warps, MG = m_group, CK = k_chunk;
  if (T < 1 || B < 1 || H < 1 || W < 1 || W > kMaxWarps || CK < 1 || stages != kStages
      || smem_bytes < 0 || (size_t)smem_bytes != mma_smem_bytes(H, NT, W, MG, CK))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  const size_t sm = smem_bytes;
#define LSTM_BWD_CASE(nt, mg)                                                                   \
  if (NT == nt && MG == mg)                                                                     \
    return launch_mma<nt, mg>(gates, mask, w, cprev, dhs, dhT, dcT, da, r, dh0, dc0, T, B, H,  \
                              W, CK, sm, s);
  LSTM_BWD_CASE(1, 1)
  LSTM_BWD_CASE(1, 2)
  LSTM_BWD_CASE(1, 3)
  LSTM_BWD_CASE(1, 4)
  LSTM_BWD_CASE(2, 1)
  LSTM_BWD_CASE(2, 2)
  LSTM_BWD_CASE(2, 3)
  LSTM_BWD_CASE(2, 4)
#undef LSTM_BWD_CASE
  return cudaErrorInvalidValue;
}

// The narrow-row path: the same contract with the plan of
// ops/lstm_cuda.py::NarrowPlan (n_sub 1: 8 units a block; cluster 2: the two
// blocks that split K; warps W, and k_split = W: K parts of a block's
// slice, one a warp; smem_bytes), refused with cudaErrorInvalidValue when
// it is not one this kernel was built for. ring is the bf16 da ring of the
// mma.sync path ([2, ceil(B/16), ceil(4H/16), 256], fragment order), zeros
// on entry.
int lstm_bwd_narrow(const float* gates, const float* mask, const void* wh, const float* cprev,
                    const float* dhs, const float* dhT, const float* dcT, float* da, void* ring,
                    float* dh0, float* dc0, int T, int B, int H, int n_sub, int cluster,
                    int warps, int k_split, int smem_bytes, void* stream) {
  const int NT = n_sub, C = cluster, W = warps, MT = cdiv(B, 16);
  if (T < 1 || B < 1 || H < 1 || NT != 1 || C != 2 || W < 1 || W > kMaxWarps
      || k_split != W || MT > narrow::kMaxM || cdiv(cdiv(cdiv(4 * H, 16), C), W) > narrow::kMaxKPW
      || B * 8 * NT > narrow::kMaxPairs * 32 * W || smem_bytes < 0
      || (size_t)smem_bytes != narrow::smem_layout(H, NT, C, MT, W).total)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  return narrow::launch<1, 2>(gates, mask, w, cprev, dhs, dhT, dcT, da, r, dh0, dc0, T, B, H, W,
                              smem_bytes, s);
}

// Blocks of the narrow-row backward that the card holds at once in its
// clusters of 2, at the most shared memory a block may take (any plan's
// blocks fit at least as densely), into *blocks.
int lstm_bwd_narrow_blocks(int* blocks) {
  int dev, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  return lstm_wgmma::cluster_blocks(narrow::lstm_bwd_narrow_kernel<1, 2>, kMaxWarps * 32,
                                    smem_max, 2, blocks);
}

// The wide-row path: the same contract with the plan of
// ops/lstm_cuda.py::WidePlan (row_groups x rows_per_group rows, units per
// block, k_slices, cluster, warpgroups, stages, smem_bytes), refused with
// cudaErrorInvalidValue when it is not the one this kernel was built for,
// and recv_slots (1 .. rows_per_group / 64). ring is the bf16 da ring [2,
// row_groups * rows_per_group, Kp], Kp = 4H rounded up to 128, row-major,
// zeros on entry; H must be even.
int lstm_bwd_wide(const float* gates, const float* mask, const void* wh, const float* cprev,
                  const float* dhs, const float* dhT, const float* dcT, float* da, void* ring,
                  float* dh0, float* dc0, int T, int B, int H, int row_groups,
                  int rows_per_group, int units, int k_slices, int cluster, int warpgroups,
                  int stages, int smem_bytes, int recv_slots, void* stream) {
  const int MP = rows_per_group, S = stages, R = recv_slots;
  const int Kp = cdiv(4 * H, 2 * lstm_wgmma::kSlab) * 2 * lstm_wgmma::kSlab;
  const int UG = cdiv(H, wide::kUnits);
  if (T < 1 || B < 1 || H < 2 || H % 2 || MP < 1 || MP % lstm_wgmma::kTileRows
      || row_groups != cdiv(B, MP) || units != wide::kUnits || k_slices != wide::kCluster
      || cluster != wide::kCluster || warpgroups != wide::kWarpgroups || S < 2
      || S > wide::kStages || R < 1 || R > MP / lstm_wgmma::kTileRows || smem_bytes < 0
      || (size_t)smem_bytes != wide::smem_bytes(Kp, S, R))
    return cudaErrorInvalidValue;
  const int Rp = row_groups * MP;
  CUtensorMap tm_da;
  cudaError_t err = lstm_wgmma::encode_2d(
      &tm_da, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ring, Kp, 2 * (uint64_t)Rp, 2 * (uint64_t)Kp,
      lstm_wgmma::kSlab, lstm_wgmma::kTileRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  return lstm_wgmma::launch_cluster_cooperative(
      wide::lstm_bwd_wide_kernel, row_groups * UG * wide::kCluster, wide::kThreads,
      (size_t)smem_bytes, wide::kCluster, static_cast<cudaStream_t>(stream), tm_da, gates, mask,
      w, cprev, dhs, dhT, dcT, da, r, dh0, dc0, T, B, H, Kp, Rp, MP, UG, S, R);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
