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
//     operand type (bf16, or f32 in f32-operand mode), into the residual
//     spill, and a second running sum s2 of exp(rounded - running max) over
//     the real columns gives lse[n] = m + log(s2), the logsumexp of the
//     ROUNDED logits, so that the backward's exp(spill - lse) rows sum to
//     exactly 1; logp keeps the unrounded m + log(s).
//
// What bounds it on the H100: 2*N*nh*V operations (2.5 TFLOP per call at the
// IW decoder's N = 640*95, nh = 1024, V = 20004: 2.5 ms at the dense bf16
// rate), against which the inputs are small (h 124 MB, W 41 MB in bf16). The
// bf16 path below moves, per call, each block's A tile once per vocab tile
// and all of W once per row tile from L2 to shared memory: with 128 x 256
// tiles that is 475 x 79 x 256 KB (A) + 475 x 41 MB (W) = ~29 GB at the IW
// shape (~39 GB with 128 x 128 tiles: the reason for BN 256), ~12 TB/s if
// the products ran at the full bf16 rate, above what the L2 delivers; so L2
// bandwidth, not the tensor cores, is this design's expected bound there (a
// 2-block cluster sharing W through TMA multicast would halve W's part).
// Blocks are numbered row tile fastest, so the blocks resident together walk
// the same W columns at about the same time and W stays L2-resident (each W
// tile is fetched from device memory about once per wave).
//
// Design of the bf16 path (ce_fwd_bf16), both modes:
// - Block = 128 rows x one range of vocab tiles of BN = 256 columns; two
//   warpgroups of 64 rows each issue wgmma.mma_async m64n256k16 (bf16 in, f32
//   accumulate in 128 registers a thread), A and B both K-major from shared
//   memory through 128-byte-swizzle descriptors.
// - K is staged in 64-element slabs (128 bytes a row) in a 4-stage ring
//   (48 KB a stage: 16 KB of h, 32 KB of W^T), filled by all 256 threads
//   with 16-byte cp.async.cg (zero-filled past N and nh), written at the
//   swizzled address the descriptor reads: chunk c of row r at
//   r * 128 + ((c ^ (r & 7)) << 4), on a 1024-byte-aligned ring. Two slabs
//   are in flight ahead of the one multiplied; one wgmma group stays in
//   flight while the next slab's copies are issued (wait_group 1), so a slot
//   is refilled only after both warpgroups passed the barrier that follows
//   their wait on its products. B is W made K-major, rounded to bf16 and
//   zero-padded, W^T [Vp, Kp] (Vp = V rounded up to BN, Kp = nh rounded up
//   to 64), packed by a first small kernel (ce_pack_wt_kernel, ~41 MB
//   written) in the same call, because a bf16 row of W itself (V = 20004:
//   40,008 bytes) is not 16-byte aligned.
// - Epilogue from registers: the wgmma accumulator layout gives the 4 lanes
//   of a quad a whole row of the 256-column tile (lane t: columns 8i + 2t,
//   8i + 2t + 1), so each lane keeps its own running (max, sum, sum of the
//   rounded, target logit) per row and the quad merges them once at the
//   end: no logits tile goes through shared memory. In grad mode the spill
//   [N, Vp] (returned as the [:, :V] view) is stored from the accumulators as
//   packed bf16 pairs.
// - Filling the card: the launch plan (ops/ce_cuda.py::ce_plan; checked
//   here) splits the vocab tiles of a row tile over `splits` blocks when
//   there are fewer row tiles than SMs (24 at the training shape's N 3040;
//   one block fits an SM); each block writes its partial (m, s, s2, t) per
//   row to part [4, splits, N] and a second small kernel merges them:
//   M = max m_i, s = sum s_i exp(m_i - M). With one split the block writes
//   logp and lse itself.
//
// The f32-operand path (ce_fwd_f32, used by the f32 checks) is simple: 64-row
// blocks over 128-column tiles, products on CUDA cores (FMA) through an f32
// logits tile in shared memory (tensor cores have no exact f32 product).

#include <math.h>

#include "ce_wgmma.cuh"

namespace {
namespace wg = lstm_wgmma;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// ------------------------------------------------------------- bf16 path
constexpr int kWarpgroups = 2;                       // consumer warpgroups of 64 rows
constexpr int kBM = 64 * kWarpgroups, kBN = 256, kBK = 64;
constexpr int kStages = 4;                           // ring depth; kStages - 2 slabs in flight
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kABytes = kBM * kBK * 2, kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAlign = 1024;                         // the 128-byte swizzle repeats every 8 rows
constexpr int kSmemBytes = kStages * kStageBytes + kAlign;
static_assert(kThreads == 256 && kBM % 32 == 0 && kBN % 32 == 0, "a pass of loads: 32 rows");

// Byte offset of 16-byte chunk c (0..7) of row r in a [rows][64] bf16 slab
// with the 128-byte swizzle (the layout TMA's SWIZZLE_128B writes and
// lstm_wgmma.cuh's sw128_desc makes wgmma read).
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (uint32_t)(r * 128 + ((c ^ (r & 7)) << 4));
}

// 16-byte global -> shared copy through L2; bytes past src_bytes are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// h [N, ldh] bf16 (columns >= nh ignored), wt [Vp, Kp] bf16 (W^T, zero past
// nh and V), tgt [N]. Block b takes row tile b % row_tiles and vocab tiles
// [s nv / splits, (s + 1) nv / splits) of s = b / row_tiles.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
ce_bf16_kernel(const __nv_bfloat16* __restrict__ h, const __nv_bfloat16* __restrict__ wt,
               const int* __restrict__ tgt, float* __restrict__ logp, float* __restrict__ lse,
               __nv_bfloat16* __restrict__ spill, float* __restrict__ part, int N, int nh, int V,
               int ldh, int Vp, int Kp, int splits) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t ring =
      ((uint32_t)__cvta_generic_to_shared(smem_raw) + kAlign - 1) & ~(uint32_t)(kAlign - 1);
  const int row_tiles = cdiv(N, kBM);
  const int rt = blockIdx.x % row_tiles, split = blockIdx.x / row_tiles;
  const int nv = Vp / kBN, KS = Kp / kBK;
  const int j0 = (int)((long long)split * nv / splits);
  const int j1 = (int)((long long)(split + 1) * nv / splits);
  const int row0 = rt * kBM;
  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int tq = lane & 3;

  // Loads: thread t copies 16-byte chunk t & 7 of rows t / 8 + 32 u of each
  // slab (u < 4 for h, u < 8 for W^T): one swizzled offset per thread, rows
  // 32 apart are 4096 bytes apart (the swizzle repeats every 8 rows).
  const int lr = tid >> 3, lc = (tid & 7) * 8;
  const uint32_t soff = swz(lr, tid & 7);
  const __nv_bfloat16* hrow = h + (size_t)(row0 + lr) * ldh + lc;
  const __nv_bfloat16* wrow = wt + (size_t)lr * Kp + lc;
  auto load = [&](int slot, int jt, int k0) {
    const uint32_t sa = ring + (uint32_t)slot * kStageBytes + soff, sb = sa + kABytes;
    const bool kok = k0 + lc < nh;
#pragma unroll
    for (int u = 0; u < kBM / 32; ++u) {
      const bool ok = kok && row0 + lr + 32 * u < N;
      cp_async16(sa + u * 4096, ok ? hrow + (size_t)u * 32 * ldh + k0 : h, ok ? 16 : 0);
    }
    const __nv_bfloat16* wp = wrow + (size_t)jt * kBN * Kp + k0;
#pragma unroll
    for (int u = 0; u < kBN / 32; ++u) cp_async16(sb + u * 4096, wp + (size_t)u * 32 * Kp, 16);
  };
  // the copies run kStages - 2 stages ahead of the products, across vocab
  // tiles: stage s is K slab s % KS of vocab tile j0 + s / KS, in slot
  // s % kStages
  int ld_left = (j1 - j0) * KS, ld_jt = j0, ld_kk = 0, ld_slot = 0;
  auto load_next = [&]() {
    if (ld_left > 0) {
      load(ld_slot, ld_jt, ld_kk * kBK);
      --ld_left;
      if (++ld_kk == KS) ld_kk = 0, ++ld_jt;
      if (++ld_slot == kStages) ld_slot = 0;
    }
    cp_async_commit();
  };

  int row[2], trg[2];
  float m_run[2], s_run[2], s2_run[2], t_run[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    row[hh] = row0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * hh;
    trg[hh] = row[hh] < N ? tgt[row[hh]] : -1;
    m_run[hh] = -INFINITY;
    s_run[hh] = s2_run[hh] = t_run[hh] = 0.f;
  }
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;

#pragma unroll
  for (int p = 0; p < kStages - 2; ++p) load_next();
  int slot = 0;
  for (int jt = j0; jt < j1; ++jt) {
    // K loop: only wgmma touches the accumulators here, so one group stays
    // in flight across iterations (any other access to them inside this
    // loop makes ptxas wait for every group at the loop's back edge)
    for (int kk = 0; kk < KS; ++kk) {
      cp_async_wait<kStages - 3>();  // this thread's copies of this stage have landed
      wg::fence_proxy_async_smem();  // visible to the async proxy that wgmma reads through
      __syncthreads();  // everyone's have; and the products of two stages back are done
      load_next();      // into that slot
      const uint32_t sa = ring + (uint32_t)slot * kStageBytes + wg * (64 * 128);
      const uint32_t sb = ring + (uint32_t)slot * kStageBytes + kABytes;
      if (++slot == kStages) slot = 0;
      wg::wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBK / 16; ++k16)
        ce_wgmma::wgmma_m64n256k16<0, 0>(acc, wg::sw128_desc(sa + k16 * 32),
                                         wg::sw128_desc(sb + k16 * 32), (kk | k16) != 0);
      wg::wgmma_commit();
      wg::wgmma_wait<1>();
    }
    wg::wgmma_wait<0>();
    wg::fence_acc(acc);

    // the finished logits tile: this lane's columns of its two rows
    const int col0 = jt * kBN;
    const bool full = col0 + kBN <= V;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (kSave && row[hh] < N) {
        __nv_bfloat16* dst = spill + (size_t)row[hh] * Vp + col0 + 2 * tq;
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * i) =
              __floats2bfloat162_rn(acc[4 * i + 2 * hh], acc[4 * i + 2 * hh + 1]);
      }
      float lm = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (full || col0 + 8 * i + 2 * tq + e < V) lm = fmaxf(lm, acc[4 * i + 2 * hh + e]);
      if ((unsigned)(trg[hh] - col0) < (unsigned)kBN) {
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (col0 + 8 * i + 2 * tq + e == trg[hh]) t_run[hh] += acc[4 * i + 2 * hh + e];
      }
      if (lm == -INFINITY) continue;  // no real column of this tile in this lane
      const float mn = fmaxf(m_run[hh], lm);
      float ss = 0.f, ss2 = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = acc[4 * i + 2 * hh + e];
          if (full || col0 + 8 * i + 2 * tq + e < V) {
            ss += __expf(x - mn);
            if (kSave) ss2 += __expf(round_bf16(x) - mn);
          }
        }
      const float sc = __expf(m_run[hh] - mn);  // 0 while m_run is -inf
      s_run[hh] = s_run[hh] * sc + ss;
      if (kSave) s2_run[hh] = s2_run[hh] * sc + ss2;
      m_run[hh] = mn;
    }
  }

  // merge the quad's four lanes of each row; one lane writes the row
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
    if (splits == 1) {
      const float l = M + logf(s);
      lse[row[hh]] = kSave ? M + logf(s2) : l;
      logp[row[hh]] = t - l;
    } else {
      const size_t o = (size_t)split * N + row[hh], plane = (size_t)splits * N;
      part[o] = M;
      part[plane + o] = s;
      part[2 * plane + o] = s2;
      part[3 * plane + o] = t;
    }
  }
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

// The splits' partials part [4, splits, N] (m, s, s2, t) -> logp, lse.
__global__ void ce_merge_kernel(const float* __restrict__ part, int splits, int N,
                                float* __restrict__ logp, float* __restrict__ lse, int save) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t plane = (size_t)splits * N;
  float M = -INFINITY;
  for (int s = 0; s < splits; ++s) M = fmaxf(M, part[(size_t)s * N + n]);
  float sum = 0.f, sum2 = 0.f, t = 0.f;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (size_t)s * N + n;
    const float sc = expf(part[o] - M);
    sum += part[plane + o] * sc;
    sum2 += part[2 * plane + o] * sc;
    t += part[3 * plane + o];
  }
  const float l = M + logf(sum);
  lse[n] = save ? M + logf(sum2) : l;
  logp[n] = t - l;
}

// -------------------------------------------------------------- f32 path
constexpr int BM = 64, BN = 128, BK = 32, NTHREADS = 256;
constexpr float NEG = -1e30f;
constexpr int LDA_F = BM + 4;  // f32 A tile stored transposed [BK][BM]
constexpr int LDB_F = BN + 4;  // f32 B tile [BK][BN]
constexpr int LDC = BN + 4;    // f32 logits tile [BM][BN]
constexpr size_t kF32ABytes = sizeof(float) * BK * LDA_F;
constexpr size_t kF32BBytes = sizeof(float) * BK * LDB_F;
constexpr size_t kF32Smem = kF32ABytes + kF32BBytes + sizeof(float) * BM * LDC;

// logits tile for rows [row0, row0+BM) x cols [col0, col0+BN) into Cs (f32)
__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ w,
                                            unsigned char* smem, int row0, int col0,
                                            int N, int nh, int V) {
  float* As = reinterpret_cast<float*>(smem);  // [BK][LDA_F], transposed
  float* Bs = reinterpret_cast<float*>(smem + kF32ABytes);
  float* Cs = reinterpret_cast<float*>(smem + kF32ABytes + kF32BBytes);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;  // rows ty*4, cols tx*8
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < nh; k0 += BK) {
    __syncthreads();
    float va[BM * BK / NTHREADS], vb[BK * BN / NTHREADS];
#pragma unroll
    for (int u = 0; u < BM * BK / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid, gr = row0 + idx / BK, gk = k0 + idx % BK;
      va[u] = (gr < N && gk < nh) ? h[(size_t)gr * nh + gk] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BK * BN / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid, gk = k0 + idx / BN, gc = col0 + idx % BN;
      vb[u] = (gk < nh && gc < V) ? w[(size_t)gk * V + gc] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < BM * BK / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid;
      As[(idx % BK) * LDA_F + idx / BK] = va[u];
    }
#pragma unroll
    for (int u = 0; u < BK * BN / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid;
      Bs[(idx / BN) * LDB_F + idx % BN] = vb[u];
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[4], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[k * LDA_F + ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[k * LDB_F + tx * 8 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) Cs[(ty * 4 + i) * LDC + tx * 8 + j] = acc[i][j];
}

template <bool kSave>
__global__ void __launch_bounds__(NTHREADS)
ce_f32_kernel(const float* __restrict__ h, const float* __restrict__ w, const int* __restrict__ tgt,
              float* __restrict__ logp, float* __restrict__ lse, float* __restrict__ spill,
              int N, int nh, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem + kF32ABytes + kF32BBytes);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int er = tid / 4, ep = tid % 4;  // 4 threads per row; thread ep takes cols c*4 + ep
  const int grow = row0 + er;
  const int target = grow < N ? tgt[grow] : -1;
  float m_run = -INFINITY, s_run = 0.f, t_logit = 0.f;

  for (int col0 = 0; col0 < V; col0 += BN) {
    logits_tile(h, w, smem, row0, col0, N, nh, V);
    __syncthreads();
    if (kSave) {  // the residual: the tile, row-major [N, V]
      for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
        const int r = idx / BN, c = idx % BN, gr = row0 + r, gc = col0 + c;
        if (gr < N && gc < V) spill[(size_t)gr * V + gc] = Cs[r * LDC + c];
      }
    }
    const float* crow = Cs + er * LDC;
    float vmax = NEG;
    for (int c = 0; c < BN / 4; ++c) {
      const int n = c * 4 + ep, gc = col0 + n;
      const float x = gc < V ? crow[n] : NEG;
      vmax = fmaxf(vmax, x);
      if (gc == target) t_logit += x;
    }
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 1));
    vmax = fmaxf(vmax, __shfl_xor_sync(0xffffffffu, vmax, 2));
    const float m_new = fmaxf(m_run, vmax);
    float ssum = 0.f;
    for (int c = 0; c < BN / 4; ++c) {
      const int n = c * 4 + ep, gc = col0 + n;
      ssum += expf((gc < V ? crow[n] : NEG) - m_new);
    }
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 2);
    s_run = s_run * expf(m_run - m_new) + ssum;
    m_run = m_new;
  }
  t_logit += __shfl_xor_sync(0xffffffffu, t_logit, 1);
  t_logit += __shfl_xor_sync(0xffffffffu, t_logit, 2);
  if (ep == 0 && grow < N) {
    // f32 logits are their own rounding: the s2 of grad mode is s
    const float l = m_run + logf(s_run);
    lse[grow] = l;
    logp[grow] = t_logit - l;
  }
}

}  // namespace

extern "C" {

// bf16 operands, both modes. h [N, ldh] bf16 (ldh >= nh, ldh % 8 == 0,
// 16-byte aligned), w [nh, V] f32 (w_f32 = 1) or bf16, tgt [N] int32 in
// [0, V). Writes wt [Vp, Kp] bf16 (W^T rounded to bf16, zero-padded: the
// products' B operand), logp [N] and lse [N] (f32) and, when save_logits,
// spill [N, Vp] bf16 (the rounded logits; lse of the rounded ones); part
// [4, splits, N] f32 is scratch when splits > 1. The launch plan
// (ops/ce_cuda.py::ce_plan): block_m, block_n, block_k, stages (the tile and
// ring this kernel was built for), splits, blocks, smem_bytes; it is
// checked here and refused with cudaErrorInvalidValue when it does not fit.
// Returns a cudaError_t.
int ce_fwd_bf16(const void* h, const void* w, void* wt, const int* tgt, float* logp,
                float* lse, void* spill, float* part, int N, int nh, int V, int ldh, int Vp,
                int Kp, int w_f32, int save_logits, int block_m, int block_n, int block_k,
                int stages, int splits, int blocks, int smem_bytes, void* stream) {
  const int nv = cdiv(V, kBN);
  if (N < 1 || nh < 1 || V < 1 || block_m != kBM || block_n != kBN || block_k != kBK
      || stages != kStages || smem_bytes != kSmemBytes || ldh < nh || ldh % 8
      || reinterpret_cast<uintptr_t>(h) % 16 || reinterpret_cast<uintptr_t>(wt) % 16 || !w
      || Vp != nv * kBN || Kp != cdiv(nh, kBK) * kBK || splits < 1 || splits > nv
      || blocks != cdiv(N, kBM) * splits || (splits > 1 && !part) || (save_logits && !spill))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* hb = static_cast<const __nv_bfloat16*>(h);
  auto* wb = static_cast<__nv_bfloat16*>(wt);
  auto* sp = static_cast<__nv_bfloat16*>(spill);
  const dim3 pack_grid(Vp / 32, Kp / 32);
  if (w_f32)
    ce_pack_wt_kernel<float><<<pack_grid, 256, 0, s>>>(static_cast<const float*>(w), wb, nh, V, Kp);
  else
    ce_pack_wt_kernel<__nv_bfloat16>
        <<<pack_grid, 256, 0, s>>>(static_cast<const __nv_bfloat16*>(w), wb, nh, V, Kp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kern = save_logits ? ce_bf16_kernel<true> : ce_bf16_kernel<false>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  kern<<<blocks, kThreads, kSmemBytes, s>>>(hb, wb, tgt, logp, lse, sp, part, N, nh, V, ldh, Vp,
                                           Kp, splits);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  ce_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(part, splits, N, logp, lse, save_logits);
  return cudaGetLastError();
}

// f32 operands, both modes: h [N, nh], w [nh, V] f32 (the f32 checks). As
// ce_fwd_bf16 with spill [N, V] f32 when save_logits.
int ce_fwd_f32(const float* h, const float* w, const int* tgt, float* logp, float* lse,
               float* spill, int N, int nh, int V, int save_logits, void* stream) {
  if (N < 1 || nh < 1 || V < 1 || (save_logits && !spill)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto kern = save_logits ? ce_f32_kernel<true> : ce_f32_kernel<false>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32Smem);
  if (err != cudaSuccess) return err;
  kern<<<cdiv(N, BM), NTHREADS, kF32Smem, s>>>(h, w, tgt, logp, lse, spill, N, nh, V);
  return cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
