// Masked-carry LSTM forward, bf16 wh, on the tensor cores of Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernels
//   ops/lstm_pallas.py::_infer_kernel  (pallas_call at line 238): kSaveResiduals = false
//   ops/lstm_pallas.py::_fwd_kernel    (pallas_call at line 126): kSaveResiduals = true,
//     which also writes the residuals a backward pass needs: cs [T, rows, H]
//     (the kept c) and gates [T, rows, 4H] (the activations i, f, g, o)
// Per step t, for gates (i, f, g, o) = (sigmoid, sigmoid, tanh, sigmoid) of
//   a = xw[t] + bf16(h_{t-1}) @ wh                      (f32 accumulation)
//   c_raw = f * c + i * g;  h_raw = o * tanh(c_raw)
//   h = m * h_raw + (1 - m) * h;  c = m * c_raw + (1 - m) * c   (m = mask[t, row])
// Outputs hs [T, rows, H] (the KEPT h), hT, cT (and the residuals). xw
// [T, rows, 4H] f32, wh [H, 4H] bf16. The f32-wh forward is lstm_f32.cu.
//
// Three paths, by row count (ops/lstm_cuda.py::infer_plan; WIDE_MIN_ROWS):
// from WIDE_MIN_ROWS the wide-row path (namespace wide below: wgmma, TMA,
// clusters); below it the narrow-row path (namespace narrow: mma.sync on an
// h tile shared by a cluster through bulk-copy multicast) wherever its plan
// fits shared memory (up to 64 rows at H 1024), and the mma.sync path
// (lstm_infer_kernel: cp.async) for the rows between.
//
// The wide-row path, at the IW decoder's shape (T 96, 640 rows, H 1024; plan
// 2 row groups of 320 rows x 64 unit groups of 16 units, 128 blocks in
// clusters of 2):
// - what bounds it (lstm_ablation.py, NVIDIA H100 80GB HBM3 at 700 W):
//   the products and the cell epilogue, in turns within each warpgroup.
//   Without the epilogue's work a call takes 1.72 of 3.04 ms; without the
//   products 2.53. The phase profile puts 70% of a consumer warpgroup's
//   step in its k-loop, ~790 SM clocks for each 64-k slab of 4 wgmma
//   m64n64k16 (the dense bf16 rate would take 128 a slab), 48 slabs for the
//   warpgroup with three m-tiles. Against that, 5.4 GFLOP a step over the
//   grid is 5.5 us at the dense rate, and the epilogue's HBM traffic (xw
//   10.5 MB, hs, cT, and with residuals cs and gates, 13 MB more, a step)
//   4-7 us. A warpgroup of its own for the epilogue (as the backward has)
//   measured slower here: one warpgroup's cell of five m-tiles a step
//   outlasts the products.
// - bytes of h_{t-1} a step: 655,360 into each SM (its 320 rows x 1024 k in
//   bf16) and 41,943,040 from L2 over the grid (each tile read once for the
//   two blocks of a cluster); the 32-row path's plan at 640 rows moved
//   1,310,720 into each SM and 167,772,160 from L2 (every block read all of
//   h_{t-1}), 2x and 4x more.
// - the barrier: one grid.sync() a step (cooperative launch with clusters),
//   ~1-3 us with the wait for the slowest block.
//
// Design of the wide-row path:
// - Block rg * UG + ug owns rows [rg MP, rg MP + MP) (MP a multiple of 64)
//   x units [16 ug, 16 ug + 16); it keeps those units' four gate columns of
//   wh resident in shared memory as the K-major B operand of wgmma (N = 64
//   columns, n = 8 (2q + j / 8) + j % 8 for gate q, unit j, 128-byte
//   swizzle; 128 KB at H 1024), filled once.
// - Two consumer warpgroups take the 64-row m-tiles alternately; each has a
//   4-deep ring of 64 x 64 bf16 A tiles of h_{t-1}, filled by TMA from the
//   row-major bf16 ring by its own producer warp. The two blocks of a
//   cluster (ug even and odd) share every tile: each loads half its rows
//   into both (.multicast::cluster), and a slot is refilled once both
//   blocks' warpgroups have released it (an mbarrier with an arrival from
//   each; the remote arrival is CTA-scoped: the slot orders no data). The
//   consumer only waits for its tile, issues the four wgmma, keeps one
//   group in flight and releases the previous slot.
// - The accumulator layout gives a thread rows 16 w + l/4 (+ 8) and columns
//   8 i + 2 (l % 4) (+ 1): with the column order above, all four gates of
//   its units, so the cell runs in registers. xw of the m-tile comes by TMA
//   into shared memory (the next m-tile's, or the next step's first, is
//   requested as soon as the warpgroup has read this one, before the grid
//   barrier), c and h_{t-1} and the mask are loaded before the products.
// - The epilogue writes hs, cT (hT at the last step), with residuals cs and
//   the gate activations, as float2 (four lanes a 32-byte sector), and
//   bf16(h_t) into ring slot t % 2 as bf16x2; rows and units past the
//   problem are never written (the ring's padding stays zero).
//
// The narrow-row path, at the encoder's and the training forward's 32 rows
// (T 96, H 1024; plan 128 blocks of 8 units in clusters of 2, 16 warps):
// - what bounds it (lstm_ablation.py, NVIDIA H100 80GB HBM3 at 700 W): the
//   serial chain of a step, 7,893 SM clocks at 32 rows (the phase profile
//   of warp 0): the grid barrier ~2,000, the wait for the copy of h_{t-1}
//   after it ~2,050 (its 64 KiB into each SM), the products ~1,780, the
//   K-slice sum ~690, the cell ~730. The empty step (the barrier and the
//   copy, no product, no cell) takes 0.30 of 0.46-0.54 ms: T x that is the
//   floor of this design, 7x the byte bound (0.040 ms). The mma.sync
//   kernel's step is 10,737 clocks (epilogue 4,207 of them, its dependent
//   loads of xw, c, h_{t-1} and the mask issued after the product; grid
//   barrier 2,331, k-loop 3,290, K-slice sum 737); its empty step 0.24 ms.
// - bytes of h_{t-1} a step: 65,536 into each SM, 4,194,304 from L2 over
//   the grid (each piece read once for the cluster; the mma.sync plan read
//   8,388,608: every block all of h).
// - per-block publication flags with release/acquire in place of the grid
//   barrier measured slower (a step's flag wait ~5,000 clocks, the empty
//   step 0.48-0.54 ms): each copier waits on the 64 blocks of its piece,
//   which is the whole grid's step every time; the grid barrier stays.
//
// Design of the narrow-row path:
// - Block b owns units [b J, b J + J), J = 8 NT, for every row, keeps their
//   four gate columns of wh in shared memory in B-fragment order (as the
//   mma.sync path) and multiplies the whole h tile: warp w takes m-tile
//   w % MT over K slice w / MT; every warp stores its partial tiles, the
//   block's threads sum them in slice order over the read h tile (no
//   atomics: equal inputs, equal bits), and the pairs' threads read four
//   sums each.
// - The h tile arrives by cp.async.bulk .multicast::cluster: after the grid
//   barrier that ends step t-1, cluster rank r copies its 1/C of the k-steps
//   of every m-tile from the ring (fragment order: contiguous runs) into the
//   same offset of every block of the cluster; one mbarrier counts the
//   bytes of all pieces (its expect-tx arrival for step t+1 comes once the
//   tile of step t has been read). mma.sync stays, not wgmma: a warpgroup's
//   m64 tile would take 64 of 32 rows, or 4J = 64 gate columns a block (64
//   blocks, twice the products an SM), and the wide path measured ~200 SM clocks a
//   wgmma m64n32k16 on this card; 16 warps of mma.sync take ~1,800.
// - Thread p owns pairs (row p / J, unit u0 + p % J): c and h stay in its
//   registers for the sequence; xw[t] and mask[t] are requested with
//   non-caching loads at the top of the step, before the copy and the
//   product; bf16(h_t) goes to the ring before the barrier, and hs, cs and
//   the gates after it, so the next step's copy does not wait for them. cT
//   and hT are written once, at the end.
// - The ring's stores reach the bulk copies through a proxy fence of one
//   thread after a block barrier, before the grid barrier, and another by
//   the copying thread after it.
// - 8-unit blocks (128 at H 1024) in pairs only: 16-unit blocks in clusters
//   of 16 (64 blocks: twice the products an SM) measured 0.65 against 0.53
//   ms, and clusters of 4 or more admit only 120 blocks on this card. Where
//   the card's pairs cannot hold the grid (ops/lstm_cuda.py asks the card:
//   lstm_infer_narrow_blocks) the mma.sync plan runs.
//
// The mma.sync path (rows no narrow plan fits): what bounds it is the grid
// barrier, the epilogue's dependent loads and every block reading all of
// h_{t-1} (1,310,720 bytes into each SM at 640 rows).
// Design of the mma.sync path:
// - Persistent cooperative grid (launch plan from
//   ops/lstm_cuda.py::infer_plan, an MMAPlan). Block u owns hidden units [u*J, u*J + J),
//   J = 8 * NT, for every row, keeps their four gate columns of wh resident
//   in shared memory in B-fragment order (KS x 4NT x 256 B; 64 KB at J 8),
//   and waits at one grid.sync() per step. NT = 2 serves H > 8 x the SM
//   count.
// - The product runs on the tensor cores: n-tile q*NT + j is gate q of
//   units [j*8, j*8 + 8), so the lane holding a (row, unit) accumulator holds
//   all four of its gates and applies the cell in registers.
// - Warps split the rows: warp w of WM owns 16-row m-tiles w, w + WM, ...,
//   MG m-tiles x 4NT n-tiles of f32 accumulators per pass. With fewer than
//   16 m-tiles (32 rows: 2) a block runs 16 warps all the same, the spare
//   ones as WK K slices whose partial tiles are summed through shared memory
//   into the slice-0 warp, which owns the pairs.
// - h is rounded once, where it is produced: the lane that computes h_t
//   writes the f32 hs the caller gets and a bf16 copy into a two-slot ring
//   in A-fragment order (lstm_mma.cuh), its four values of an 8-unit block
//   as one 8-byte store. Each lane then stages exactly its own fragments of
//   h_{t-1}, CK k-steps per stage, with 16-byte cp.async.cg (L2 only, never
//   a stale L1 line) into a kStages-deep per-warp ring in shared memory,
//   and reads each back with one conflict-free 16-byte load: no register
//   round trip, no transposition, no integer division in the loop, and no
//   barrier between warps (a lane reads only what it copied itself).
// - The epilogue's loads and stores are float2 (a lane's two units are
//   adjacent; four lanes cover a row's 32-byte sector), the residuals too:
//   cs like cT, and each gate's activations of the lane's two units.
// - wh in f32 is lstm_f32.cu's (FMA pipes): tensor cores have no exact
//   f32 product (TF32 keeps 10 bits of mantissa), and the f32 route is
//   defined by f32 products.
//
// All paths: ring slot t % 2 holds bf16(h_t); slot 1 holds bf16(h0) for
// step 0. Step t reads slot (t + 1) % 2 while slot t % 2 is written; the
// grid barrier between steps orders them. In the mma.sync and wide paths
// the state c lives in cT, each element read and written by its one owning
// lane, and hs[t - 1] is read back by the lane that wrote it.

#include <cooperative_groups.h>

#include "lstm_mma.cuh"
#include "lstm_wgmma.cuh"

namespace cg = cooperative_groups;
using namespace lstm_mma;

namespace {

constexpr int kStages = 4;     // cp.async ring depth per warp (stages in flight: kStages - 1)
constexpr int kFillBatch = 8;  // wh loads a thread keeps in flight while filling b_s

// Two neighbouring floats: one 8-byte access where aligned and both exist.
__device__ __forceinline__ float2 ld2(const float* p, bool ok0, bool ok1, bool vec) {
  if (vec && ok0 && ok1) return *reinterpret_cast<const float2*>(p);
  return make_float2(ok0 ? p[0] : 0.f, ok1 ? p[1] : 0.f);
}
__device__ __forceinline__ void st2(float* p, float a, float b, bool ok0, bool ok1, bool vec) {
  if (vec && ok0 && ok1) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
    return;
  }
  if (ok0) p[0] = a;
  if (ok1) p[1] = b;
}
__device__ __forceinline__ float pick(float2 v, int e) { return e ? v.y : v.x; }

template <int NT, int MG, bool kSaveResiduals>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
lstm_infer_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                  const __nv_bfloat16* __restrict__ wh, const float* __restrict__ h0,
                  const float* __restrict__ c0, float* __restrict__ hs, float* __restrict__ cs,
                  float* __restrict__ gates, float* __restrict__ hT, float* __restrict__ cT,
                  __nv_bfloat16* __restrict__ ring, int T_, int rows, int H, int WK, int CK) {
  constexpr int NTILES = 4 * NT;  // n-tile q * NT + j: gate q, units [j*8, j*8 + 8)
  constexpr int J = 8 * NT;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = cdiv(H, 16), MT = cdiv(rows, 16);
  const int W = blockDim.x >> 5, WM = W / WK;
  const int u0 = blockIdx.x * J;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp % WM, wk = warp / WM;  // m-tile column, K slice
  const int g = lane >> 2, tig = lane & 3;
  const int KSW = cdiv(KS, WK);
  const int ks0 = min(KS, wk * KSW), ks1 = min(KS, ks0 + KSW);
  const int n_pass = cdiv(MT, WM * MG);  // the same in every warp
  const size_t H4 = 4 * (size_t)H;
  const size_t slot_elems = (size_t)MT * KS * kTileElems;
  const bool vec = (H & 1) == 0;  // float2 accesses are 8-byte aligned

  const uint2* b_s = reinterpret_cast<const uint2*>(smem);  // [KS][NTILES][32]
  unsigned char* p = smem + (size_t)KS * NTILES * 256;
  uint4* a_s = reinterpret_cast<uint4*>(p) + (size_t)warp * kStages * CK * MG * 32;
  // partial tiles of the K slices wk >= 1: [WK - 1][WM][MG][NTILES][32] float4
  float4* red = reinterpret_cast<float4*>(p + (size_t)W * kStages * CK * MG * 512);

  // wh's gate columns of this block's units, zero-padded, in B-fragment
  // order; consecutive threads read consecutive units of one wh row, and
  // each thread keeps kFillBatch loads in flight.
  {
    __nv_bfloat16* b_w = reinterpret_cast<__nv_bfloat16*>(smem);
    const int total = KS * 16 * NTILES * 8;
    for (int base = threadIdx.x; base < total; base += kFillBatch * blockDim.x) {
      __nv_bfloat16 v[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * blockDim.x;
        const int n = idx % (NTILES * 8), k = idx / (NTILES * 8);
        const int q = n / J, unit = u0 + n % J;
        v[u] = (idx < total && k < H && unit < H) ? wh[(size_t)k * H4 + (size_t)q * H + unit]
                                                  : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * blockDim.x;
        if (idx < total) b_w[b_frag_index(idx / (NTILES * 8), idx % (NTILES * 8), NTILES)] = v[u];
      }
    }
  }
  // bf16(h0) into ring slot 1 (any partition: the grid barrier follows)
  for (size_t idx = blockIdx.x * (size_t)blockDim.x + threadIdx.x; idx < (size_t)rows * H;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int row = (int)(idx / H), unit = (int)(idx % H);
    ring[slot_elems + a_frag_index(row, unit, KS)] = __float2bfloat16(h0[idx]);
  }
  __syncthreads();
  grid.sync();

  for (int t = 0; t < T_; ++t) {
    const __nv_bfloat16* src = ring + (size_t)((t + 1) & 1) * slot_elems + lane * 8;
    __nv_bfloat16* dst = ring + (size_t)(t & 1) * slot_elems;
    const float* xw_t = xw + (size_t)t * rows * H4;
    for (int pass = 0; pass < n_pass; ++pass) {
      int mts[MG];
      bool live[MG];
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        mts[m] = wm + (pass * MG + m) * WM;
        live[m] = mts[m] < MT;
      }
      float acc[MG][NTILES][4];
#pragma unroll
      for (int m = 0; m < MG; ++m)
#pragma unroll
        for (int nt = 0; nt < NTILES; ++nt)
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
              cp_async16(d + (kk * MG + m) * 32, src + ((size_t)mts[m] * KS + ks) * kTileElems);
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
          uint4 af[MG];
#pragma unroll
          for (int m = 0; m < MG; ++m)
            af[m] = live[m] ? a[(kk * MG + m) * 32] : make_uint4(0, 0, 0, 0);
          const uint2* b = b_s + (size_t)ks * NTILES * 32 + lane;
#pragma unroll
          for (int nt = 0; nt < NTILES; ++nt) {
            const uint2 bf = b[nt * 32];
#pragma unroll
            for (int m = 0; m < MG; ++m)
              if (live[m]) mma_bf16(acc[m][nt], af[m], bf);
          }
        }
      }

      if (WK > 1) {  // sum the K slices into the wk = 0 warp of this m-tile column
        if (wk > 0) {
          float4* mine = red + ((size_t)((wk - 1) * WM + wm) * MG * NTILES) * 32 + lane;
#pragma unroll
          for (int m = 0; m < MG; ++m)
#pragma unroll
            for (int nt = 0; nt < NTILES; ++nt)
              mine[(m * NTILES + nt) * 32] = make_float4(acc[m][nt][0], acc[m][nt][1],
                                                         acc[m][nt][2], acc[m][nt][3]);
        }
        __syncthreads();
        if (wk == 0) {
          for (int o = 1; o < WK; ++o) {
            const float4* theirs = red + ((size_t)((o - 1) * WM + wm) * MG * NTILES) * 32 + lane;
#pragma unroll
            for (int m = 0; m < MG; ++m)
#pragma unroll
              for (int nt = 0; nt < NTILES; ++nt) {
                const float4 v = theirs[(m * NTILES + nt) * 32];
                acc[m][nt][0] += v.x; acc[m][nt][1] += v.y;
                acc[m][nt][2] += v.z; acc[m][nt][3] += v.w;
              }
          }
        }
        __syncthreads();  // red is rewritten by the next pass
      }
      if (wk != 0) continue;

      // the cell for the (row, unit) pairs this lane's accumulators hold: rows
      // g and g + 8 of the m-tile, units 2*tig and 2*tig + 1 of each 8-unit
      // block, so every access is a float2 (8 consecutive floats per row
      // across the 4 lanes of a row: whole 32-byte sectors) and the four bf16
      // values for the ring are 8 contiguous bytes of the lane's fragment.
      // All loads of an (m-tile, unit block) are issued before its stores.
#pragma unroll
      for (int m = 0; m < MG; ++m) {
        if (!live[m]) continue;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int unit = u0 + j * 8 + 2 * tig;
          const bool uok[2] = {unit < H, unit + 1 < H};
          int row[2];
          bool rok[2];
          float2 x[2][4], cp[2], hp[2];
          float mk[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            row[h] = mts[m] * 16 + g + 8 * h;
            rok[h] = row[h] < rows;
            const bool ok0 = rok[h] && uok[0], ok1 = rok[h] && uok[1];
            const size_t xo = (size_t)row[h] * H4 + unit, so = (size_t)row[h] * H + unit;
#pragma unroll
            for (int q = 0; q < 4; ++q) x[h][q] = ld2(xw_t + xo + (size_t)q * H, ok0, ok1, vec);
            cp[h] = ld2(t == 0 ? c0 + so : cT + so, ok0, ok1, vec);
            hp[h] = ld2(t == 0 ? h0 + so : hs + (size_t)(t - 1) * rows * H + so, ok0, ok1, vec);
            mk[h] = rok[h] ? mask[(size_t)t * rows + row[h]] : 0.f;
          }
          float hk[4];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float ck[2], act[4][2];  // act[q][e]: gate q of unit + e
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = 2 * h + e;
              act[0][e] = sigmoid(pick(x[h][0], e) + acc[m][j][c]);
              act[1][e] = sigmoid(pick(x[h][1], e) + acc[m][NT + j][c]);
              act[2][e] = tanhf(pick(x[h][2], e) + acc[m][2 * NT + j][c]);
              act[3][e] = sigmoid(pick(x[h][3], e) + acc[m][3 * NT + j][c]);
              const float c_prev = pick(cp[h], e), h_prev = pick(hp[h], e);
              const float c_raw = act[1][e] * c_prev + act[0][e] * act[2][e];
              const float h_raw = act[3][e] * tanhf(c_raw);
              const bool ok = rok[h] && uok[e];
              hk[c] = ok ? mk[h] * h_raw + (1.f - mk[h]) * h_prev : 0.f;
              ck[e] = mk[h] * c_raw + (1.f - mk[h]) * c_prev;
            }
            const bool ok0 = rok[h] && uok[0], ok1 = rok[h] && uok[1];
            const size_t so = (size_t)row[h] * H + unit;
            st2(hs + (size_t)t * rows * H + so, hk[2 * h], hk[2 * h + 1], ok0, ok1, vec);
            st2(cT + so, ck[0], ck[1], ok0, ok1, vec);
            if (t == T_ - 1) st2(hT + so, hk[2 * h], hk[2 * h + 1], ok0, ok1, vec);
            if (kSaveResiduals) {
              st2(cs + (size_t)t * rows * H + so, ck[0], ck[1], ok0, ok1, vec);
              float* gt = gates + ((size_t)t * rows + row[h]) * H4 + unit;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                st2(gt + (size_t)q * H, act[q][0], act[q][1], ok0, ok1, vec);
            }
          }
          // hk of invalid pairs is 0: the ring's padding stays zero
          __nv_bfloat162 lo = __floats2bfloat162_rn(hk[0], hk[1]);
          __nv_bfloat162 hi = __floats2bfloat162_rn(hk[2], hk[3]);
          uint2 packed;
          packed.x = *reinterpret_cast<unsigned*>(&lo);
          packed.y = *reinterpret_cast<unsigned*>(&hi);
          *reinterpret_cast<uint2*>(dst + a_frag_index(row[0], unit, KS)) = packed;
        }
      }
    }
    if (t + 1 < T_) grid.sync();
  }
}

size_t smem_bytes_for(int H, int NT, int W, int WK, int MG, int CK) {
  return (size_t)cdiv(H, 16) * 4 * NT * 256 + (size_t)W * kStages * CK * MG * 512
         + (size_t)(WK - 1) * (W / WK) * MG * 4 * NT * 512;
}

template <int NT, int MG, bool kSaveResiduals>
cudaError_t launch(const float* xw, const float* mask, const __nv_bfloat16* wh, const float* h0,
                   const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
                   __nv_bfloat16* ring, int T_, int rows, int H, int W, int WK, int CK,
                   size_t smem, cudaStream_t stream) {
  const int grid = cdiv(H, 8 * NT);
  auto kern = lstm_infer_kernel<NT, MG, kSaveResiduals>;
  cudaError_t err = check_cooperative((const void*)kern, grid, W * 32, smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&xw, (void*)&mask, (void*)&wh, (void*)&h0, (void*)&c0, (void*)&hs,
                  (void*)&cs, (void*)&gates, (void*)&hT, (void*)&cT, (void*)&ring, (void*)&T_,
                  (void*)&rows, (void*)&H, (void*)&WK, (void*)&CK};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(W * 32), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// ---------------------------------------------------------------- narrow rows
// The narrow-row path (ops/lstm_cuda.py::NarrowPlan): mma.sync on an h tile
// that the cluster shares by bulk-copy multicast, the state in registers,
// the cell's inputs requested before the step's barrier.
namespace narrow {
namespace wg = lstm_wgmma;

constexpr int kMaxPairs = 2;  // (row, unit) pairs a thread owns at most
constexpr int kSumBatch = 8;  // partial tiles a thread loads before adding them, in order
constexpr int kNT = 1;        // 8-unit n-tiles a gate: J = 8 units a block
constexpr int kCluster = 2;   // blocks of a cluster, sharing the h tile

// Byte offsets in shared memory: wh's B fragments [KS][4NT][32] x 8 bytes,
// the h tile in the ring's fragment order [MT][KS] x 512 bytes, which the
// sums of the partial tiles [MT][4NT][32] float4 overwrite once it has been
// read (the next step's pieces land only after the grid barrier), the
// warps' partial tiles [W][4NT][32] float4, the full mbarrier.
struct Smem {
  size_t a, red, bar, total;
};
__host__ __device__ inline Smem smem_layout(int H, int NT, int MT, int W) {
  const size_t KS = cdiv(H, 16);
  Smem s;
  s.a = KS * 4 * NT * 256;
  s.red = s.a + (size_t)MT * (KS > 4 * NT ? KS : 4 * NT) * 512;
  s.bar = s.red + (size_t)W * 4 * NT * 512;
  s.total = s.bar + 8;
  return s;
}

// Block b owns units [b J, b J + J), J = 8 NT, for every row, in a cluster
// of C consecutive blocks. After the grid barrier that ends step t-1,
// cluster rank r copies k-steps [r KSP, r KSP + KSP) of h_{t-1} (every
// m-tile) from the ring into the same offset of all C blocks
// (cp.async.bulk .multicast::cluster); the full mbarrier counts the bytes
// of every piece. Warp w takes m-tile w % MT over K slice w / MT; the
// block's threads sum the partial tiles in slice order, then the threads
// that own the pairs run the cell.
template <bool kSaveResiduals>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
lstm_infer_narrow_kernel(const float* __restrict__ xw, const float* __restrict__ mask,
                         const __nv_bfloat16* __restrict__ wh, const float* __restrict__ h0,
                         const float* __restrict__ c0, float* __restrict__ hs,
                         float* __restrict__ cs, float* __restrict__ gates, float* __restrict__ hT,
                         float* __restrict__ cT, __nv_bfloat16* __restrict__ ring, int T_,
                         int rows, int H, int WK) {
  constexpr int NT = kNT;
  constexpr int NTILES = 4 * NT;  // n-tile q * NT + j: gate q, units [j*8, j*8 + 8)
  constexpr int J = 8 * NT;
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int KS = cdiv(H, 16), MT = cdiv(rows, 16);
  const int nthr = blockDim.x, W = nthr >> 5, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm = warp % MT, wk = warp / MT;  // m-tile, K slice
  const int KSW = cdiv(KS, WK), ks0 = min(KS, wk * KSW), ks1 = min(KS, ks0 + KSW);
  const int u0 = blockIdx.x * J;
  const int C = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const size_t H4 = 4 * (size_t)H, slot_elems = (size_t)MT * KS * kTileElems;
  const Smem L = smem_layout(H, NT, MT, W);
  const uint2* b_s = reinterpret_cast<const uint2*>(smem);
  const uint4* a_s = reinterpret_cast<const uint4*>(smem + L.a);
  float4* red = reinterpret_cast<float4*>(smem + L.red);
  float4* sums = reinterpret_cast<float4*>(smem + L.a);  // over the h tile, once read
  const uint32_t s_a = wg::smem_u32(smem + L.a), full_bar = wg::smem_u32(smem + L.bar);
  const uint32_t a_bytes = (uint32_t)(slot_elems * 2);
  // this block's piece of the tile: k-steps [p0, p1)
  const int KSP = cdiv(KS, C), p0 = min(KS, crank * KSP), p1 = min(KS, p0 + KSP);

  // wh's gate columns of this block's units, zero-padded, in B-fragment order
  {
    __nv_bfloat16* b_w = reinterpret_cast<__nv_bfloat16*>(smem);
    const int total = KS * 16 * NTILES * 8;
    for (int base = tid; base < total; base += kFillBatch * nthr) {
      __nv_bfloat16 v[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * nthr;
        const int n = idx % (NTILES * 8), k = idx / (NTILES * 8);
        const int q = n / J, unit = u0 + n % J;
        v[u] = (idx < total && k < H && unit < H) ? wh[(size_t)k * H4 + (size_t)q * H + unit]
                                                  : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * nthr;
        if (idx < total) b_w[b_frag_index(idx / (NTILES * 8), idx % (NTILES * 8), NTILES)] = v[u];
      }
    }
  }
  // this thread's pairs p = tid + i nthr: row p / J, unit u0 + p % J; their
  // state lives in registers for the whole sequence
  int prow[kMaxPairs], punit[kMaxPairs];
  bool pok[kMaxPairs];
  float c[kMaxPairs], h[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int p = tid + i * nthr;
    prow[i] = p / J;
    punit[i] = u0 + p % J;
    pok[i] = prow[i] < rows && punit[i] < H;
    const size_t so = (size_t)prow[i] * H + punit[i];
    c[i] = pok[i] ? c0[so] : 0.f;
    h[i] = pok[i] ? h0[so] : 0.f;
    // bf16(h0) into ring slot 1
    if (pok[i]) ring[slot_elems + a_frag_index(prow[i], punit[i], KS)] = __float2bfloat16(h[i]);
  }
  if (tid == 0) {
    wg::mbar_init(full_bar, 1);
    wg::fence_mbar_init();
    wg::mbar_arrive_tx(full_bar, a_bytes);  // step 0's tile
  }
  cluster.sync();  // the barrier, before the other blocks' pieces complete on it
  if (tid == 0) wg::fence_proxy_async_global();  // the ring's h0, before the bulk copies read it
  grid.sync();

  const float* sf = reinterpret_cast<const float*>(sums);
  for (int t = 0; t < T_; ++t) {
    // the cell's inputs of step t, requested before the copy and the product
    float x[kMaxPairs][4], mk[kMaxPairs];
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const size_t xo = ((size_t)t * rows + prow[i]) * H4 + punit[i];
#pragma unroll
      for (int q = 0; q < 4; ++q) x[i][q] = pok[i] ? ld_nc(xw + xo + (size_t)q * H) : 0.f;
      mk[i] = pok[i] ? ld_nc(mask + (size_t)t * rows + prow[i]) : 0.f;
    }
    // this block's piece of h_{t-1} (ring slot (t + 1) % 2), into every
    // block of the cluster, by the last warp's lane 0 (the fewest pairs)
    if (tid == nthr - 32 && p0 < p1) {
      wg::fence_proxy_async_global();  // the ring stores before the barrier, before this copy
      const __nv_bfloat16* src = ring + (size_t)((t + 1) & 1) * slot_elems;
      for (int mt = 0; mt < MT; ++mt) {
        const size_t off = ((size_t)mt * KS + p0) * kTileElems;
        bulk_load_mc(s_a + (uint32_t)(off * 2), src + off, (uint32_t)(p1 - p0) * 512, full_bar,
                     (uint16_t)((1u << C) - 1));
      }
    }
    wg::mbar_wait(full_bar, t & 1);

    float acc[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll 4
    for (int ks = ks0; ks < ks1; ++ks) {
      const uint4 af = a_s[((size_t)wm * KS + ks) * 32 + lane];
      const uint2* b = b_s + (size_t)ks * NTILES * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt) mma_bf16(acc[nt], af, b[nt * 32]);
    }
    {
      float4* mine = red + (size_t)warp * NTILES * 32 + lane;
#pragma unroll
      for (int nt = 0; nt < NTILES; ++nt)
        mine[nt * 32] = make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
    __syncthreads();
    // the tile has been read: the next step's pieces may complete on the barrier
    if (tid == 0 && t + 1 < T_) wg::mbar_arrive_tx(full_bar, a_bytes);
    // the sum of the K slices' partial tiles, in slice order: thread (m, n,
    // lane) of MT x 4NT x 32
    for (int e = tid; e < MT * NTILES * 32; e += nthr) {
      const int m = e / (NTILES * 32), rest = e % (NTILES * 32);
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w0 = 0; w0 < WK; w0 += kSumBatch) {  // kSumBatch loads in flight, then the adds
        float4 part[kSumBatch];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (w0 + u < WK) part[u] = red[((size_t)(w0 + u) * MT + m) * NTILES * 32 + rest];
#pragma unroll
        for (int u = 0; u < kSumBatch; ++u)
          if (w0 + u < WK) {
            v.x += part[u].x;
            v.y += part[u].y;
            v.z += part[u].z;
            v.w += part[u].w;
          }
      }
      sums[e] = v;
    }
    __syncthreads();

    // the cell; h_t goes to the ring before the barrier, the outputs after it
    float act[kMaxPairs][4];
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      if (!pok[i]) continue;
      const int r16 = prow[i] & 15, j = punit[i] - u0;
      const int pl = (r16 & 7) * 4 + ((j & 7) >> 1), pc = (r16 >> 3) * 2 + (j & 1);
      const int pm = prow[i] >> 4;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = x[i][q] + sf[(((size_t)pm * NTILES + q * NT + (j >> 3)) * 32 + pl) * 4 + pc];
      const float ig = sigmoid(pre[0]), fg = sigmoid(pre[1]), gg = tanhf(pre[2]),
                  og = sigmoid(pre[3]);
      const float c_raw = fg * c[i] + ig * gg;
      const float h_raw = og * tanhf(c_raw);
      h[i] = mk[i] * h_raw + (1.f - mk[i]) * h[i];
      c[i] = mk[i] * c_raw + (1.f - mk[i]) * c[i];
      act[i][0] = ig;
      act[i][1] = fg;
      act[i][2] = gg;
      act[i][3] = og;
      ring[(size_t)(t & 1) * slot_elems + a_frag_index(prow[i], punit[i], KS)] =
          __float2bfloat16(h[i]);
    }
    if (t + 1 < T_) {  // h_t is out in every block; the partial tiles are read
      __syncthreads();
      if (tid == 0) wg::fence_proxy_async_global();  // the block's ring stores, before bulk copies
      grid.sync();
    }
    // the outputs, after the barrier: the next step's copy does not wait for them
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      if (!pok[i]) continue;
      const size_t so = (size_t)prow[i] * H + punit[i];
      hs[(size_t)t * rows * H + so] = h[i];
      if (kSaveResiduals) {
        cs[(size_t)t * rows * H + so] = c[i];
        float* gt = gates + ((size_t)t * rows + prow[i]) * H4 + punit[i];
#pragma unroll
        for (int q = 0; q < 4; ++q) gt[(size_t)q * H] = act[i][q];
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    if (!pok[i]) continue;
    const size_t so = (size_t)prow[i] * H + punit[i];
    hT[so] = h[i];
    cT[so] = c[i];
  }
  cluster.sync();  // no block leaves while a piece it copied may still land in another
}

template <bool kSaveResiduals>
cudaError_t launch(const float* xw, const float* mask, const __nv_bfloat16* wh, const float* h0,
                   const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
                   __nv_bfloat16* ring, int T_, int rows, int H, int W, int WK, size_t smem,
                   cudaStream_t stream) {
  const int grid = cdiv(cdiv(H, 8 * kNT), kCluster) * kCluster;
  return wg::launch_cluster_cooperative(lstm_infer_narrow_kernel<kSaveResiduals>, grid, W * 32,
                                        smem, kCluster, stream, xw, mask, wh, h0, c0, hs, cs,
                                        gates, hT, cT, ring, T_, rows, H, WK);
}

}  // namespace narrow

// ------------------------------------------------------------------ wide rows
// The wide-row path (ops/lstm_cuda.py::WidePlan): wgmma, TMA, clusters.
namespace wide {
namespace wg = lstm_wgmma;

constexpr int kWarpgroups = 2;                 // consumer warpgroups, 64-row m-tiles each
constexpr int kConsumers = 128 * kWarpgroups;
constexpr int kThreads = kConsumers + 32 * kWarpgroups;  // + a producer warp for each
constexpr int kStages = 4;                     // deepest TMA ring of a warpgroup (plan: 2..4)
constexpr int kUnits = 16;                     // units a block: N = 4 x 16 gate columns
constexpr int kN = 4 * kUnits;                 // column n = 8 (2q + j / 8) + j % 8: gate q, unit j
constexpr int kCluster = 2;                    // unit groups of one row group sharing h tiles
constexpr int kHalfRows = wg::kTileRows / kCluster;
constexpr int kBSlabBytes = kN * 128;          // one 64-k slab of the block's wh columns
constexpr int kXwBytes = 4 * wg::kTileRows * kUnits * 4;  // [4 gates][64 rows][16 units] f32

size_t smem_bytes(int Hp, int S) {
  return (size_t)wg::kAlign + (size_t)(Hp / wg::kSlab) * kBSlabBytes
         + (size_t)kWarpgroups * S * wg::kTileBytes + (size_t)kWarpgroups * kXwBytes
         + 8 * (size_t)kWarpgroups * (2 * S + 1);
}

// Block b = rg * UG + ug: rows [rg MP, rg MP + MP) x units [16 ug, 16 ug + 16);
// the two blocks of a cluster are ug = 2c, 2c + 1 of one row group.
template <bool kSaveResiduals>
__global__ void __launch_bounds__(kThreads, 1)
lstm_infer_wide_kernel(const __grid_constant__ CUtensorMap tm_h,
                       const __grid_constant__ CUtensorMap tm_xw,
                       const float* __restrict__ mask, const __nv_bfloat16* __restrict__ wh,
                       const float* __restrict__ h0, const float* __restrict__ c0,
                       float* __restrict__ hs, float* __restrict__ cs,
                       float* __restrict__ gates, float* __restrict__ hT,
                       float* __restrict__ cT, __nv_bfloat16* __restrict__ ring, int T_,
                       int rows, int H, int Hp, int Rp, int MP, int UG, int S) {
  cg::grid_group grid = cg::this_grid();
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = wg::smem_u32(smem_raw);
  const uint32_t sB = (raw + wg::kAlign - 1) & ~(uint32_t)(wg::kAlign - 1);
  unsigned char* smem = smem_raw + (sB - raw);
  const int KS = Hp / wg::kSlab;
  const uint32_t sA = sB + KS * kBSlabBytes;                      // [kWarpgroups][S] tiles
  const uint32_t sX = sA + kWarpgroups * S * wg::kTileBytes;      // [kWarpgroups] xw tiles
  const uint32_t sBar = sX + kWarpgroups * kXwBytes;
  auto full_bar = [&](int w, int s) { return sBar + 8u * (w * S + s); };
  auto empty_bar = [&](int w, int s) { return sBar + 8u * ((kWarpgroups + w) * S + s); };
  auto x_bar = [&](int w) { return sBar + 8u * (2 * kWarpgroups * S + w); };

  const int rg = blockIdx.x / UG, ug = blockIdx.x % UG;
  const int u0 = ug * kUnits, row0 = rg * MP;
  const uint32_t crank = cluster.block_rank();
  const int MTb = cdiv(max(0, min(MP, rows - row0)), wg::kTileRows);
  // consumer warpgroup w = tid / 128, or the producer warp of warpgroup w
  const int tid = threadIdx.x;
  const bool producer = tid >= kConsumers;
  const int w = producer ? (tid - kConsumers) >> 5 : tid >> 7, lt = tid & 127, wq = lt >> 5;
  const int lane = tid & 31, g8 = lane >> 2, tq = lane & 3;
  const size_t H4 = 4 * (size_t)H;
  const int n_mt = MTb > w ? cdiv(MTb - w, kWarpgroups) : 0;  // warpgroup w's m-tiles
  const int n_loads = n_mt * KS;                                // its A tiles a step

  // wh's gate columns of this block's units as the K-major B operand,
  // zero-padded: B[n][k] = wh[k, q H + u0 + j]; consecutive threads read
  // consecutive units of one wh row.
  {
    const int total = Hp * kN;
    for (int base = tid; base < total; base += kFillBatch * kThreads) {
      __nv_bfloat16 v[kFillBatch];
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * kThreads, k = idx / kN, q = (idx % kN) >> 4, j = idx & 15;
        v[u] = (idx < total && k < H && u0 + j < H) ? wh[(size_t)k * H4 + (size_t)q * H + u0 + j]
                                                    : __float2bfloat16(0.f);
      }
#pragma unroll
      for (int u = 0; u < kFillBatch; ++u) {
        const int idx = base + u * kThreads, k = idx / kN, q = (idx % kN) >> 4, j = idx & 15;
        if (idx < total)
          *reinterpret_cast<__nv_bfloat16*>(smem + (k / wg::kSlab) * kBSlabBytes
                                            + wg::swz_elem(8 * (2 * q + (j >> 3)) + (j & 7),
                                                           k % wg::kSlab)) = v[u];
      }
    }
  }
  // bf16(h0) into ring slot 1 (any partition: the grid barrier follows)
  for (size_t idx = blockIdx.x * (size_t)kThreads + tid; idx < (size_t)rows * H;
       idx += (size_t)gridDim.x * kThreads) {
    const size_t row = idx / H, unit = idx % H;
    ring[((size_t)Rp + row) * Hp + unit] = __float2bfloat16(h0[idx]);
  }
  if (tid == 0) {
    for (int w = 0; w < kWarpgroups; ++w) {
      for (int s = 0; s < S; ++s) {
        wg::mbar_init(full_bar(w, s), 1);
        wg::mbar_init(empty_bar(w, s), kCluster);
      }
      wg::mbar_init(x_bar(w), 1);
    }
    wg::fence_mbar_init();
  }
  wg::fence_proxy_async_smem();  // the B fill, before wgmma reads it
  wg::fence_proxy_async();       // the ring's h0, before TMA reads it
  __syncthreads();
  cluster.sync();
  grid.sync();

  // xw of (step t, m-tile mt) into this warpgroup's xw tile: 4 boxes of
  // 64 rows x 16 units, one per gate (thread lt == 0)
  auto issue_xw = [&](int t, int mt) {
    wg::fence_proxy_async_smem();
    wg::mbar_arrive_tx(x_bar(w), kXwBytes);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      wg::tma_load_2d(sX + w * kXwBytes + q * (kXwBytes / 4), &tm_xw, q * H + u0,
                      t * rows + row0 + mt * wg::kTileRows, x_bar(w));
  };
  if (!producer && lt == 0 && n_mt > 0) issue_xw(0, w);
  __syncwarp();

  const float* xs = reinterpret_cast<const float*>(smem + (sX - sB) + w * kXwBytes);
  uint32_t seq = 0, xseq = 0;  // warpgroup w's A tiles and xw tiles so far
  float acc[kN / 2];
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < T_; ++t) {
    if (producer) {
      // warpgroup w's A tiles of this step in order, m-tile w + (i / KS)
      // kWarpgroups, k slab i % KS: this block loads its half of the rows
      // into both blocks of the cluster once both have released the slot
      if (lane == 0 && n_loads > 0) {
        wg::fence_proxy_async();  // the other blocks' ring stores, before this TMA reads them
        const int src_row = ((t + 1) & 1) * Rp + row0;  // ring slot of h_{t-1}
        for (int i = 0; i < n_loads; ++i) {
          const uint32_t g = seq + i, use = g / S;
          const int s = g % S, mt = w + (i / KS) * kWarpgroups, ks = i % KS;
          if (use > 0) wg::mbar_wait(empty_bar(w, s), (use - 1) & 1);
          wg::mbar_arrive_tx(full_bar(w, s), wg::kTileBytes);
          wg::tma_load_2d_mc(
              sA + (w * S + s) * wg::kTileBytes + crank * (wg::kTileBytes / kCluster), &tm_h,
              ks * wg::kSlab, src_row + mt * wg::kTileRows + crank * kHalfRows, full_bar(w, s),
              (uint16_t)((1 << kCluster) - 1));
        }
      }
      __syncwarp();
    } else {
      // every block of the cluster may refill the slot of tile i (thread lt == 0)
      auto release = [&](int i) {
        const int s = (seq + i) % S;
        wg::mbar_arrive(empty_bar(w, s));
#pragma unroll
        for (int r = 1; r < kCluster; ++r)
          wg::mbar_arrive_rank_relaxed(empty_bar(w, s), (crank + r) % kCluster);
      };
      int i = 0;
      for (int mi = 0; mi < n_mt; ++mi) {
        const int mt = w + mi * kWarpgroups;
        // this thread's pairs: rows r(h) = row0 + 64 mt + 16 wq + g8 + 8 h, units
        // u0 + 8 jh + 2 tq + e; their state and mask are loaded during the product
        int row[2];
        bool ok[2][2];
        float mk[2];
        float2 cp[2][2], hp[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          row[h] = row0 + mt * wg::kTileRows + wq * 16 + g8 + 8 * h;
          mk[h] = row[h] < rows ? mask[(size_t)t * rows + row[h]] : 0.f;
#pragma unroll
          for (int jh = 0; jh < 2; ++jh) {
            const int unit = u0 + 8 * jh + 2 * tq;
            ok[h][jh] = row[h] < rows && unit < H;
            const size_t so = (size_t)row[h] * H + unit;
            cp[h][jh] = ok[h][jh] ? *reinterpret_cast<const float2*>(t == 0 ? c0 + so : cT + so)
                                  : make_float2(0.f, 0.f);
            hp[h][jh] = ok[h][jh]
                ? *reinterpret_cast<const float2*>(t == 0 ? h0 + so
                                                          : hs + (size_t)(t - 1) * rows * H + so)
                : make_float2(0.f, 0.f);
          }
        }
        for (int ks = 0; ks < KS; ++ks, ++i) {
          const uint32_t g = seq + i;
          const int s = g % S;
          wg::mbar_wait(full_bar(w, s), (g / S) & 1);
          wg::wgmma_fence();
          wg::wgmma_slab<kN>(acc, sA + (w * S + s) * wg::kTileBytes, sB + ks * kBSlabBytes,
                             ks == 0);
          wg::wgmma_commit();
          wg::wgmma_wait<1>();  // tile i - 1 has been read
          if (lt == 0 && ks > 0) release(i - 1);
          __syncwarp();
        }
        wg::wgmma_wait<0>();
        wg::fence_acc(acc);
        if (lt == 0) release(i - 1);
        __syncwarp();
        wg::mbar_wait(x_bar(w), xseq & 1);
        ++xseq;

        // the cell, in registers: this thread holds all four gates of its 8 pairs
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int jh = 0; jh < 2; ++jh) {
            const int rl = wq * 16 + g8 + 8 * h, j = 8 * jh + 2 * tq, unit = u0 + j;
            float2 x[4];
#pragma unroll
            for (int q = 0; q < 4; ++q)
              x[q] = *reinterpret_cast<const float2*>(xs + q * (wg::kTileRows * kUnits)
                                                      + rl * kUnits + j);
            float act[4][2], hk[2], ck[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 2 * h + e;
              act[0][e] = sigmoid(pick(x[0], e) + acc[4 * (0 + jh) + r]);
              act[1][e] = sigmoid(pick(x[1], e) + acc[4 * (2 + jh) + r]);
              act[2][e] = tanhf(pick(x[2], e) + acc[4 * (4 + jh) + r]);
              act[3][e] = sigmoid(pick(x[3], e) + acc[4 * (6 + jh) + r]);
              const float c_prev = pick(cp[h][jh], e), h_prev = pick(hp[h][jh], e);
              const float c_raw = act[1][e] * c_prev + act[0][e] * act[2][e];
              const float h_raw = act[3][e] * tanhf(c_raw);
              hk[e] = mk[h] * h_raw + (1.f - mk[h]) * h_prev;
              ck[e] = mk[h] * c_raw + (1.f - mk[h]) * c_prev;
            }
            if (!ok[h][jh]) continue;
            const size_t so = (size_t)row[h] * H + unit;
            *reinterpret_cast<float2*>(hs + (size_t)t * rows * H + so) = make_float2(hk[0], hk[1]);
            *reinterpret_cast<float2*>(cT + so) = make_float2(ck[0], ck[1]);
            if (t == T_ - 1) *reinterpret_cast<float2*>(hT + so) = make_float2(hk[0], hk[1]);
            if (kSaveResiduals) {
              *reinterpret_cast<float2*>(cs + (size_t)t * rows * H + so) =
                  make_float2(ck[0], ck[1]);
              float* gt = gates + ((size_t)t * rows + row[h]) * H4 + unit;
#pragma unroll
              for (int q = 0; q < 4; ++q)
                *reinterpret_cast<float2*>(gt + (size_t)q * H) = make_float2(act[q][0], act[q][1]);
            }
            *reinterpret_cast<__nv_bfloat162*>(ring + ((size_t)(t & 1) * Rp + row[h]) * Hp
                                               + unit) = __floats2bfloat162_rn(hk[0], hk[1]);
          }
        }
        wg::bar_sync(1 + w, 128);  // the warpgroup has read its xw tile
        if (lt == 0) {             // the next one: this step's next m-tile, or the next step's first
          const bool last = mi + 1 == n_mt;
          if (!last || t + 1 < T_)
            issue_xw(last ? t + 1 : t, w + (last ? 0 : mi + 1) * kWarpgroups);
        }
        __syncwarp();
      }
      wg::fence_proxy_async();  // this step's ring stores, before the next step's TMA reads
    }
    seq += n_loads;
    if (t + 1 < T_) grid.sync();
  }
  cluster.sync();  // no block leaves while the other may still arrive on its barriers
}

template <bool kSaveResiduals>
cudaError_t launch(const CUtensorMap& tm_h, const CUtensorMap& tm_xw, const float* mask,
                   const __nv_bfloat16* wh, const float* h0, const float* c0, float* hs,
                   float* cs, float* gates, float* hT, float* cT, __nv_bfloat16* ring, int T_,
                   int rows, int H, int Hp, int Rp, int MP, int UG, int S, int grid, size_t smem,
                   cudaStream_t stream) {
  return wg::launch_cluster_cooperative(lstm_infer_wide_kernel<kSaveResiduals>, grid, kThreads,
                                        smem, kCluster, stream, tm_h, tm_xw, mask, wh, h0, c0, hs,
                                        cs, gates, hT, cT, ring, T_, rows, H, Hp, Rp, MP, UG, S);
}

}  // namespace wide

}  // namespace

extern "C" {

// xw [T, rows, 4H] f32, mask [T, rows] f32, wh [H, 4H] bf16, h0, c0 [rows, H]
// f32. Writes hs [T, rows, H], hT, cT [rows, H] (f32) and, when
// save_residuals, cs [T, rows, H] and gates [T, rows, 4H] (f32; null
// otherwise); ring is the bf16 h ring [2, ceil(rows/16), ceil(H/16), 256],
// zeros on entry. The launch plan (ops/lstm_cuda.py::infer_plan): n_sub NT
// (J = 8 NT units per block), warps W, k_split WK (W / WK m-tile columns),
// m_group MG, k_chunk CK (k-steps per pipeline stage), stages, smem_bytes;
// it is checked here and refused with cudaErrorInvalidValue when it is not
// one this kernel was built for (LSTM_INFER_CASE without residuals,
// LSTM_RESID_CASE with them). Returns a cudaError_t.
int lstm_infer(const float* xw, const float* mask, const void* wh, const float* h0,
               const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
               void* ring, int T, int rows, int H, int save_residuals, int n_sub, int warps,
               int k_split, int m_group, int k_chunk, int stages, int smem_bytes, void* stream) {
  const int NT = n_sub, W = warps, WK = k_split, MG = m_group, CK = k_chunk;
  if (T < 1 || rows < 1 || H < 1 || W < 1 || W > kMaxWarps || WK < 1 || W % WK || CK < 1
      || stages != kStages || smem_bytes < 0
      || (size_t)smem_bytes != smem_bytes_for(H, NT, W, WK, MG, CK)
      || (save_residuals && (!cs || !gates)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  const size_t sm = smem_bytes;
#define LSTM_CASE(nt, mg, res)                                                                  \
  if (NT == nt && MG == mg && !save_residuals == !res)                                          \
    return launch<nt, mg, res>(xw, mask, w, h0, c0, hs, cs, gates, hT, cT, r, T, rows, H, W,   \
                               WK, CK, sm, s);
#define LSTM_INFER_CASE(nt, mg) LSTM_CASE(nt, mg, false)
#define LSTM_RESID_CASE(nt, mg) LSTM_CASE(nt, mg, true)
  LSTM_INFER_CASE(1, 1)
  LSTM_INFER_CASE(1, 2)
  LSTM_INFER_CASE(1, 3)
  LSTM_INFER_CASE(1, 4)
  LSTM_INFER_CASE(2, 1)
  LSTM_INFER_CASE(2, 2)
  LSTM_RESID_CASE(1, 1)
  LSTM_RESID_CASE(2, 1)
#undef LSTM_RESID_CASE
#undef LSTM_INFER_CASE
#undef LSTM_CASE
  return cudaErrorInvalidValue;
}

// The narrow-row path: the same contract with the plan of
// ops/lstm_cuda.py::NarrowPlan (n_sub 1: 8 units a block; cluster 2 blocks
// sharing the h tile; warps W = ceil(rows / 16) x k_split; smem_bytes),
// refused with cudaErrorInvalidValue when it is not one this kernel was
// built for. ring is the bf16 h ring of the mma.sync path
// ([2, ceil(rows/16), ceil(H/16), 256], fragment order), zeros on entry.
int lstm_infer_narrow(const float* xw, const float* mask, const void* wh, const float* h0,
                      const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
                      void* ring, int T, int rows, int H, int save_residuals, int n_sub,
                      int cluster, int warps, int k_split, int smem_bytes, void* stream) {
  const int W = warps, WK = k_split, MT = cdiv(rows, 16);
  if (T < 1 || rows < 1 || H < 1 || n_sub != narrow::kNT || cluster != narrow::kCluster
      || WK < 1 || W != MT * WK || W > kMaxWarps
      || rows * 8 * narrow::kNT > narrow::kMaxPairs * 32 * W || smem_bytes < 0
      || (size_t)smem_bytes != narrow::smem_layout(H, narrow::kNT, MT, W).total
      || (save_residuals && (!cs || !gates)))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  if (save_residuals)
    return narrow::launch<true>(xw, mask, w, h0, c0, hs, cs, gates, hT, cT, r, T, rows, H, W, WK,
                                smem_bytes, s);
  return narrow::launch<false>(xw, mask, w, h0, c0, hs, cs, gates, hT, cT, r, T, rows, H, W, WK,
                               smem_bytes, s);
}

// Blocks of the narrow-row forward (with or without residuals) that the
// card holds at once in its clusters, at the most shared memory a block may
// take (any plan's blocks fit at least as densely), into *blocks.
int lstm_infer_narrow_blocks(int save_residuals, int* blocks) {
  int dev, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  return save_residuals ? lstm_wgmma::cluster_blocks(narrow::lstm_infer_narrow_kernel<true>,
                                                     kMaxWarps * 32, smem_max, narrow::kCluster,
                                                     blocks)
                        : lstm_wgmma::cluster_blocks(narrow::lstm_infer_narrow_kernel<false>,
                                                     kMaxWarps * 32, smem_max, narrow::kCluster,
                                                     blocks);
}

// The wide-row path: the same contract with the plan of
// ops/lstm_cuda.py::WidePlan (row_groups x rows_per_group rows, units per
// block, k_slices, cluster, warpgroups, stages, smem_bytes), refused with
// cudaErrorInvalidValue when it is not the one this kernel was built for.
// ring is the bf16 h ring [2, row_groups * rows_per_group, Hp], Hp = H
// rounded up to 64, zeros on entry; H must be even.
int lstm_infer_wide(const float* xw, const float* mask, const void* wh, const float* h0,
                    const float* c0, float* hs, float* cs, float* gates, float* hT, float* cT,
                    void* ring, int T, int rows, int H, int save_residuals, int row_groups,
                    int rows_per_group, int units, int k_slices, int cluster, int warpgroups,
                    int stages, int smem_bytes, void* stream) {
  const int MP = rows_per_group, S = stages;
  const int Hp = cdiv(H, lstm_wgmma::kSlab) * lstm_wgmma::kSlab;
  const int UG = cdiv(cdiv(H, wide::kUnits), wide::kCluster) * wide::kCluster;
  if (T < 1 || rows < 1 || H < 2 || H % 2 || MP < 1 || MP % lstm_wgmma::kTileRows
      || row_groups != cdiv(rows, MP) || units != wide::kUnits || k_slices != 1
      || cluster != wide::kCluster || warpgroups != wide::kWarpgroups || S < 2
      || S > wide::kStages || smem_bytes < 0
      || (size_t)smem_bytes != wide::smem_bytes(Hp, S) || (save_residuals && (!cs || !gates)))
    return cudaErrorInvalidValue;
  const int Rp = row_groups * MP;
  CUtensorMap tm_h, tm_xw;
  cudaError_t err = lstm_wgmma::encode_2d(
      &tm_h, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ring, Hp, 2 * (uint64_t)Rp, 2 * (uint64_t)Hp,
      lstm_wgmma::kSlab, wide::kHalfRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  err = lstm_wgmma::encode_2d(&tm_xw, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, xw, 4 * (uint64_t)H,
                              (uint64_t)T * rows, 16 * (uint64_t)H, wide::kUnits,
                              lstm_wgmma::kTileRows, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const __nv_bfloat16*>(wh);
  auto* r = static_cast<__nv_bfloat16*>(ring);
  const int grid = row_groups * UG;
  if (save_residuals)
    return wide::launch<true>(tm_h, tm_xw, mask, w, h0, c0, hs, cs, gates, hT, cT, r, T, rows, H,
                              Hp, Rp, MP, UG, S, grid, smem_bytes, s);
  return wide::launch<false>(tm_h, tm_xw, mask, w, h0, c0, hs, cs, gates, hT, cT, r, T, rows, H,
                             Hp, Rp, MP, UG, S, grid, smem_bytes, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
