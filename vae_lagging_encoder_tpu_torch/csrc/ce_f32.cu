// Fused vocab projection + cross-entropy forward with f32 operands, for
// Hopper (sm_90a): exact f32 products on the FMA pipes.
//
// Replaces the JAX package's Pallas TPU kernel ops/ce_pallas.py::_ce_kernel
// (pallas_call at line 177) with mxu_dtype=None, the full-precision mode, in
// both its forms: for h [N, nh], W [nh, V] f32 and tgt [N]
//   logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v],   lse[n] = logsumexp
// as an online (max, sum of exp, target logit) over vocab tiles;
//   - forward form (ce_fwd, save_logits = 0): no [N, V] array is written;
//   - grad mode (ce_fwd_train, save_logits = 1): the f32 logits are also
//     written to the spill [N, Vs] (Vs = V rounded up to 4; returned as the
//     [:, :V] view). f32 logits are their own rounding, so the grad mode's
//     second sum s2 (ce_fwd.cu) is s: lse is the same in both forms.
// The bf16-operand kernel is ce_fwd.cu's (wgmma): tensor cores have no
// exact f32 product (TF32 keeps 10 bits of mantissa), and the f32 route is
// defined by f32 products.
//
// What bounds it on the H100: 2 N nh V operations at the f32 rate without
// tensor cores (67 TFLOP/s: 1.86 ms at the training step's N 3040, 37.2 ms
// at the IW decoder's N 60800, nh 1024, V 20004). The operands are not
// small in f32 (W 82 MB, past the 50 MB L2; h 249 MB at N 60800), and a
// 128 x 128 unit reads 1 MB of operands for its 16.8M FMAs: ~1.7 TB/s from
// L2 over the card at the FMA rate, so the resident blocks share their
// operands through L2. Grad mode also writes 4.9 GB of spill at N 60800
// (1.45 ms at 3.35 TB/s), under the products. Measured (ce_ablation.py f32,
// NVIDIA H100 80GB HBM3 at 700 W; PERF.md): ~182,000 SM clocks a unit
// (131,072 at the FMA rate), 2.73 ms at N 3040 and 52.6 ms at N 60800.
//
// Design (a launch plan from ops/ce_cuda.py::ce_f32_plan, a CEF32Plan,
// checked here):
// - Units are (row tile of kBM = 128 rows) x (vocab tile of kBN = 128
//   columns). The persistent grid is `band` x `lanes` blocks, at most what
//   the card holds at once. The units are numbered band by band (`band`
//   row tiles each), vocab tile major within a band, and block c takes
//   units c, c + G, c + 2G, ... (G = band x lanes): so the blocks resident
//   together work on `band` row tiles and `lanes` vocab tiles at each step
//   (each W tile read by `band` blocks at about the same time, each row
//   tile of h, 512 KB at nh 1024, kept in L2 through its band: W comes
//   from device memory once a band, h once), and block c keeps row tile
//   c % band of each band, walking its vocab tiles v = lane (mod lanes),
//   lane = c / band. Units of a row tile past the last are skipped (the
//   last band's).
// - Each (block, row tile) is one segment: the block's consecutive units
//   on that row tile. It keeps a running (max, sum, target logit) per row
//   and thread over the segment's vocab tiles, merges the 8 threads of a
//   row in a warp by shuffles at the segment's end, and writes the row's
//   partial at part[:, 2 lane + half, row] (half: which warp of the two
//   that share the row). ce_f32_merge_kernel sums a row's 2 x `lanes`
//   partials in the order of their lane's first vocab tile: no atomics, the
//   same bits every call.
// - A producer warp fills a ring of kStages K slabs (kBK = 32: 128 bytes of
//   f32, one row of the 128-byte swizzle) by TMA, two boxes a slab: h's 128
//   rows x 32 k (16 KB, SWIZZLE_128B: h is read in place, rows k-inner) and
//   W's 32 k x 128 columns (16 KB, no swizzle); a full and an empty mbarrier
//   a slot. The ring runs on across units, so the next unit's slabs arrive
//   during the epilogue. Elements past N, nh and V read as zeros.
// - 8 consumer warps; thread (ty, tx) of 16 x 16 holds an 8 x 8 register
//   tile: rows 16 i + ty (i < 8), columns 4 tx + j and 64 + 4 tx + j (j <
//   4). Warp w takes ty = 4 (w % 4) .. + 3 and tx = 8 (w / 4) .. + 7: for
//   each 4 k it reads its 8 rows as 16-byte loads of 4 k (its 4 rows of a
//   load have distinct row % 8, so the swizzle puts them in distinct banks,
//   each broadcast to 8 lanes) and, for each k, its 8 columns as two
//   16-byte loads (128 bytes over the warp): 16 loads for 256 FFMAs, each
//   one shared-memory wavefront. h needs no transposed copy. (A warp of 2
//   ty x 16 tx, whose loads of W took two wavefronts, spent 189,300 SM
//   clocks a unit against 182,300; on an H100 at 700 W the SM clock ran
//   ~4 % lower with this one, so 52.8 -> 52.6 ms at N 60800.) The
//   slab's 8 steps of 4 k are unrolled by 4 (ce_ablation.py f32: 52.6 ms
//   at N 60800 against 52.8 by 2 and 53.7 whole; with the earlier warp
//   shape 52.8 against 57.3 whole at the same clocks a unit, the card's
//   clock lower). A ring of 6 slabs does as 4.
// - Epilogue from registers: the spill as 16-byte stores of the thread's
//   column quads, columns past V to -inf in the last tile, the target's
//   column picked up, the running max and sum updated with ex2; a row's 8
//   threads of a warp are merged only at the segment's end. The
//   running state lives in shared memory, not registers: 9 warps a block
//   put 3 on one scheduler, whose 16,384 registers cap a thread at 168, and
//   the products' tile and operands take most of them (with the state in
//   registers grad mode spilled).

#include <math.h>

#include "lstm_wgmma.cuh"

namespace {
namespace wg = lstm_wgmma;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

constexpr int kBM = 128, kBN = 128, kBK = 32;  // a unit's rows x vocab columns; K slab
constexpr int kStages = 4;                     // ring depth
constexpr int kConsumerWarps = 8;              // 16 x 16 threads of 8 x 8 outputs
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;      // + one producer warp
constexpr int kABytes = kBM * kBK * 4;         // h's 128 rows x 32 k: 16 KB, one box
constexpr int kBBytes = kBK * kBN * 4;         // W's 32 k x 128 columns: 16 KB, one box
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kAlign = 1024;                   // the 128-byte swizzle repeats every 8 rows
constexpr int kStateBytes = 4 * 8 * kConsumers * 4;  // (m, s, t, target) of 8 rows a thread
constexpr int kSmemBytes = kAlign + kStages * kStageBytes + 8 * 2 * kStages + kStateBytes;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBK * 4 == 128, "a slab row of h is the 128-byte swizzle's row");
static_assert(kConsumers * 64 == kBM * kBN, "8 x 8 outputs a consumer thread");

// The persistent schedule of ops/ce_cuda.py::CEF32Plan: R row tiles in
// bands of `band`, nv vocab tiles; unit u (vocab tile major within a band)
// is row tile rt (>= R: none) and vocab tile v.
struct Schedule {
  int R, nv, band;
  __host__ __device__ int units() const { return cdiv(R, band) * band * nv; }
  __device__ __forceinline__ void at(int u, int& rt, int& v) const {
    const int per_band = band * nv, b = u / per_band, w = u - b * per_band;
    v = w / band;
    rt = b * band + (w - v * band);
  }
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Row i (< 8) of a thread's tile: 16 i + ty.
__device__ __forceinline__ int tile_row(int ty, int i) { return 16 * i + ty; }

// h [N, ldh] and W [nh, ldw] f32 through their tensor maps, tgt [N]; spill
// [N, lds] f32 (grad mode); part [3, 2 lanes, R * kBM] f32: the segments'
// partials (m, s, t), two a segment (the row's two warps). Shared memory: the ring, the full and empty barriers,
// and the open segment's running (m, s, t, target) of each thread's 8 rows
// ([4][8][kConsumers]: the K loop keeps its registers for the products).
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
ce_f32_kernel(const __grid_constant__ CUtensorMap tm_h, const __grid_constant__ CUtensorMap tm_w,
              const int* __restrict__ tgt, float* __restrict__ spill, float* __restrict__ part,
              int N, int V, int lds, int KS, int R, int nv, int band, int lanes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t base = wg::smem_u32(smem_raw);
  const uint32_t ring_off = ((base + kAlign - 1) & ~(uint32_t)(kAlign - 1)) - base;
  const uint32_t ring = base + ring_off, bars = ring + kStages * kStageBytes;
  auto full_bar = [&](int s) { return bars + 8u * s; };
  auto empty_bar = [&](int s) { return bars + 8u * (kStages + s); };

  const Schedule sch{R, nv, band};
  const int c = blockIdx.x, G = gridDim.x, units = sch.units();
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::mbar_init(full_bar(s), 1);
      wg::mbar_init(empty_bar(s), kConsumerWarps);
    }
    wg::fence_mbar_init();
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer: slab g of this block's units into slot g % kStages once
    // the 8 consumer warps have released its previous slab
    if (tid == kConsumers) {
      int g = 0;
      for (int u = c; u < units; u += G) {
        int rt, v;
        sch.at(u, rt, v);
        if (rt >= R) continue;
        for (int ks = 0; ks < KS; ++ks, ++g) {
          const int s = g % kStages;
          if (g >= kStages) wg::mbar_wait(empty_bar(s), (g / kStages - 1) & 1);
          const uint32_t sa = ring + s * kStageBytes;
          wg::mbar_arrive_tx(full_bar(s), kStageBytes);
          wg::tma_load_2d(sa, &tm_h, ks * kBK, rt * kBM, full_bar(s));
          wg::tma_load_2d(sa + kABytes, &tm_w, v * kBN, ks * kBK, full_bar(s));
        }
      }
    }
    return;  // the consumers take no block-wide barrier from here on
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int ty = 4 * (warp & 3) + (lane >> 3), tx = 8 * (warp >> 2) + (lane & 7);
  // this block's vocab lane and this warp's half of the row: its partials' slot
  const int slot = 2 * (c / band) + (warp >> 2);
  // A reads: row 16 i + ty of a slab, its 16-byte chunk q at ((q ^ (row &
  // 7)) << 4) = ((q ^ (ty & 7)) << 4): (a_off ^ (q << 4)) + i * 2048, the
  // chunk bits of the row's start being (row & 7) << 4
  const uint32_t a_off = (uint32_t)(ty * 128) | ((uint32_t)(ty & 7) << 4);
  const uint32_t b_off = kABytes + 16 * tx;  // W's columns 4 tx .. + 3 of k row 0

  float acc[8][8];
  float* const m_run = reinterpret_cast<float*>(smem_raw + ring_off + kStages * kStageBytes
                                                 + 8 * 2 * kStages) + tid;
  float* const s_run = m_run + 8 * kConsumers;
  float* const t_run = s_run + 8 * kConsumers;
  int* const trg = reinterpret_cast<int*>(t_run + 8 * kConsumers);
  constexpr int R8 = kConsumers;  // row i of the state at [i * R8]
  int cur = -1;  // the row tile of the open segment
  int g = 0;

  // the open segment's partials: the row's 8 threads of this warp merged,
  // the first writes part[:, slot, row]
  auto flush = [&](int rt) {
    const size_t rows = (size_t)R * kBM, plane = (size_t)2 * lanes * rows;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float m = m_run[i * R8];
      float M = m;
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
      float s = m == -INFINITY ? 0.f : s_run[i * R8] * ex2((m - M) * kLog2e);
      float t = t_run[i * R8];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        t += __shfl_xor_sync(0xffffffffu, t, o);
      }
      if ((lane & 7) == 0) {
        const size_t o = (size_t)slot * rows + (size_t)rt * kBM + tile_row(ty, i);
        part[o] = M;
        part[plane + o] = s;
        part[2 * plane + o] = t;
      }
    }
  };

  for (int u = c; u < units; u += G) {
    int rt, v;
    sch.at(u, rt, v);
    if (rt >= R) continue;
    if (rt != cur) {
      if (cur >= 0) flush(cur);
      cur = rt;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = rt * kBM + tile_row(ty, i);
        trg[i * R8] = row < N ? tgt[row] : -1;
        m_run[i * R8] = -INFINITY;
        s_run[i * R8] = t_run[i * R8] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int ks = 0; ks < KS; ++ks, ++g) {
      const int s = g % kStages;
      wg::mbar_wait(full_bar(s), (g / kStages) & 1);
      const unsigned char* slab = smem_raw + ring_off + s * kStageBytes;
#pragma unroll 4
      for (int q = 0; q < kBK / 4; ++q) {
        float4 a[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          a[i] = *reinterpret_cast<const float4*>(slab + (a_off ^ (uint32_t)(q << 4))
                                                  + i * 16 * 128);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const float* brow = reinterpret_cast<const float*>(slab + b_off) + (4 * q + kk) * kBN;
          const float4 b0 = *reinterpret_cast<const float4*>(brow);
          const float4 b1 = *reinterpret_cast<const float4*>(brow + 64);
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const float x = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
            acc[i][0] = fmaf(x, b0.x, acc[i][0]);
            acc[i][1] = fmaf(x, b0.y, acc[i][1]);
            acc[i][2] = fmaf(x, b0.z, acc[i][2]);
            acc[i][3] = fmaf(x, b0.w, acc[i][3]);
            acc[i][4] = fmaf(x, b1.x, acc[i][4]);
            acc[i][5] = fmaf(x, b1.y, acc[i][5]);
            acc[i][6] = fmaf(x, b1.z, acc[i][6]);
            acc[i][7] = fmaf(x, b1.w, acc[i][7]);
          }
        }
      }
      __syncwarp();
      if (lane == 0) wg::mbar_arrive(empty_bar(s));  // this warp is done with the slab
    }

    // the epilogue: the unit's logits are acc[i][j], row tile_row(ty, i),
    // column col0 + 4 tx + j (j < 4) or col0 + 64 + 4 tx + j - 4
    const int col0 = v * kBN, c_lo = col0 + 4 * tx, c_hi = c_lo + 64;
    if (kSave) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = rt * kBM + tile_row(ty, i);
        if (row >= N) continue;
        float* dst = spill + (size_t)row * lds;
        if (c_lo < V)
          *reinterpret_cast<float4*>(dst + c_lo) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        if (c_hi < V)
          *reinterpret_cast<float4*>(dst + c_hi) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
      }
    }
    if (col0 + kBN > V) {  // the last tile: its columns past V to -inf
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if ((j < 4 ? c_lo : c_hi - 4) + j >= V)
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[i][j] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int d = trg[i * R8] - c_lo;  // the target's column, as this thread's j
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (d == (j < 4 ? j : 64 + j - 4)) t_run[i * R8] += acc[i][j];
      const float lm = fmaxf(fmaxf(fmaxf(acc[i][0], acc[i][1]), fmaxf(acc[i][2], acc[i][3])),
                             fmaxf(fmaxf(acc[i][4], acc[i][5]), fmaxf(acc[i][6], acc[i][7])));
      if (lm == -INFINITY) continue;  // no real column of this tile in this thread
      const float m = m_run[i * R8], mn = fmaxf(m, lm), ml = mn * kLog2e;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s0 += ex2(fmaf(acc[i][j], kLog2e, -ml));  // 0 past V
        s1 += ex2(fmaf(acc[i][j + 4], kLog2e, -ml));
      }
      s_run[i * R8] = s_run[i * R8] * ex2((m - mn) * kLog2e) + (s0 + s1);  // 0 while m is -inf
      m_run[i * R8] = mn;
    }
  }
  if (cur >= 0) flush(cur);
}

// The segments' partials part [3, 2 lanes, R * kBM] (m, s, t) -> logp,
// lse: row n of row tile rt (band b) sums the partials of its lanes in the
// order of their first vocab tile q = 0, 1, ..: lane (b nv + q) % lanes,
// each lane's two halves (slots 2 lane, 2 lane + 1) in turn.
__global__ void ce_f32_merge_kernel(const float* __restrict__ part, int N, int nv, int band,
                                    int lanes, int R, float* __restrict__ logp,
                                    float* __restrict__ lse) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const size_t rows = (size_t)R * kBM, plane = (size_t)2 * lanes * rows;
  const int b = n / kBM / band, segs = 2 * min(nv, lanes);
  auto at = [&](int q) {
    return (size_t)(2 * (((long long)b * nv + q / 2) % lanes) + q % 2) * rows + n;
  };
  float M = -INFINITY;
  for (int q = 0; q < segs; ++q) M = fmaxf(M, part[at(q)]);
  float sum = 0.f, t = 0.f;
  for (int q = 0; q < segs; ++q) {
    const size_t o = at(q);
    sum += part[plane + o] * expf(part[o] - M);
    t += part[2 * plane + o];
  }
  const float l = M + logf(sum);
  lse[n] = l;
  logp[n] = t - l;
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// Blocks of the kernel (both modes) that the card holds at once; sets the
// kernels' dynamic shared memory to kSmemBytes.
cudaError_t f32_blocks(int* blocks) {
  int dev = 0, nsm = 0, a = 0, b = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (!err) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (!err)
    err = cudaFuncSetAttribute(ce_f32_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (!err)
    err = cudaFuncSetAttribute(ce_f32_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&a, ce_f32_kernel<true>, kThreads,
                                                        kSmemBytes);
  if (!err)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, ce_f32_kernel<false>, kThreads,
                                                        kSmemBytes);
  *blocks = (a < b ? a : b) * nsm;
  return err;
}

}  // namespace

extern "C" {

// f32 operands, both modes. h [N, ldh] f32 (ldh >= nh, ldh % 4 == 0,
// 16-byte aligned), w [nh, ldw] f32 (ldw >= V, ldw % 4 == 0, 16-byte
// aligned), tgt [N] int32 in [0, V). Writes logp [N] and lse [N] (f32) and,
// when save_logits, spill [N, Vs] f32 (Vs = V rounded up to 4; the logits
// below V, 16-byte aligned); part [3, 2 lanes, R * 128] f32 is scratch (R =
// row tiles). The launch plan (ops/ce_cuda.py::CEF32Plan): block_m, block_n,
// block_k, stages (the tiles and ring this kernel was built for), band
// (row tiles a band), lanes (vocab lanes), blocks (band x lanes, at most
// what the card holds at once: more are refused), smem_bytes; it is checked
// here and refused with cudaErrorInvalidValue when it does not fit. Returns
// a cudaError_t.
int ce_fwd_f32(const float* h, const float* w, const int* tgt, float* logp, float* lse,
               float* spill, float* part, int N, int nh, int V, int ldh, int ldw,
               int save_logits, int block_m, int block_n, int block_k, int stages, int band,
               int lanes, int blocks, int smem_bytes, void* stream) {
  const int R = cdiv(N, kBM), nv = cdiv(V, kBN);
  if (N < 1 || nh < 1 || V < 1 || block_m != kBM || block_n != kBN || block_k != kBK
      || stages != kStages || band < 1 || band > R || lanes < 1 || lanes > nv
      || blocks != band * lanes || smem_bytes != kSmemBytes
      || (long long)cdiv(R, band) * band * nv > 0x7fffffff || ldh < nh || ldh % 4 || ldw < V
      || ldw % 4 || !aligned16(h) || !aligned16(w) || !tgt || !logp || !lse || !part
      || (save_logits && (!spill || !aligned16(spill))))
    return cudaErrorInvalidValue;
  int capacity = 0;
  cudaError_t err = f32_blocks(&capacity);
  if (err != cudaSuccess) return err;
  if (blocks > capacity) return cudaErrorInvalidValue;  // not resident at once: not this card's plan

  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tm_h, tm_w;  // h: 32 k x 128 rows boxes, swizzled; W: 128 columns x 32 k
  if ((err = wg::encode_2d(&tm_h, f32, h, nh, N, 4 * (uint64_t)ldh, kBK, kBM,
                           CU_TENSOR_MAP_SWIZZLE_128B))
      || (err = wg::encode_2d(&tm_w, f32, w, V, nh, 4 * (uint64_t)ldw, kBN, kBK,
                              CU_TENSOR_MAP_SWIZZLE_NONE)))
    return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int KS = cdiv(nh, kBK), lds = cdiv(V, 4) * 4;
  if (save_logits)
    ce_f32_kernel<true><<<blocks, kThreads, smem_bytes, s>>>(tm_h, tm_w, tgt, spill, part, N, V,
                                                             lds, KS, R, nv, band, lanes);
  else
    ce_f32_kernel<false><<<blocks, kThreads, smem_bytes, s>>>(tm_h, tm_w, tgt, spill, part, N, V,
                                                              lds, KS, R, nv, band, lanes);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ce_f32_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(part, N, nv, band, lanes, R, logp, lse);
  return cudaGetLastError();
}

// Blocks of the kernel (either mode) that the card holds at once, into
// *blocks.
int ce_f32_blocks(int* blocks) { return f32_blocks(blocks); }

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
