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
// What bounds it on the H100, at the training shape (T 96, B 32, H 1024):
// the sweep is serial in t, and each step's product [B, 4H] x [4H, H] needs
// every unit's da_t: one grid-wide barrier per step (~1-2 us). The product
// is 2*32*4096*1024 = 0.27 GFLOP a step, 512 mma.m16n8k16 per block over
// 128 blocks (< 1 us); but every block needs all of da_t, 256 KB in bf16,
// 32 MB per step from L2 over the grid (~5 us at L2 rates). Over the call,
// the inputs (gates, c_prev, dhs) and da are ~100 MB of device memory, read
// and written by the cell backward a step at a time: with the barrier,
// about half of a step.
//
// Design of the bf16 kernel (wh in bf16: H > 512, the Yahoo path):
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
// wh in f32 stays on CUDA cores (lstm_bwd_fma_kernel, FMA): tensor cores
// have no exact f32 product (TF32 keeps 10 bits of mantissa), and the f32
// route is defined by f32 products. It keeps the earlier design: da_t
// staged through shared memory in k-chunks, 4 rows x 4 quarter-sums per
// thread, an f32 ring read with __ldcg.

#include <cooperative_groups.h>

#include "lstm_mma.cuh"

namespace cg = cooperative_groups;
using namespace lstm_mma;

namespace {

constexpr int kStages = 4;     // cp.async ring depth per warp (stages in flight: kStages - 1)
constexpr int kFillBatch = 8;  // wh loads a thread keeps in flight while filling b_s

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

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

// ------------------------------------------------------------ f32: CUDA cores

constexpr int KC = 32;           // k-chunk of each gate quarter of da_t staged in shared memory
constexpr int ROWS = 4;          // rows per thread
constexpr int LB = 16;           // global loads a thread keeps in flight while staging
constexpr int MAX_THREADS = 256;

__global__ void lstm_bwd_fma_kernel(const float* __restrict__ gates,
                                    const float* __restrict__ mask,
                                    const float* __restrict__ wh,
                                    const float* __restrict__ cprev,
                                    const float* __restrict__ dhs,
                                    const float* __restrict__ dhT,
                                    const float* __restrict__ dcT,
                                    float* da, float* da_r, float* dh0, float* dc0,
                                    int T_, int B, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / J;             // row groups of ROWS rows
  const int BR = G * ROWS;                  // rows per tile
  const int ld = BR + 4;                    // padded row of the staged chunk
  const size_t H4 = 4 * (size_t)H;
  float* w_s = reinterpret_cast<float*>(smem);  // [H][J][4]: w_s[(k*J + j)*4 + q] = wh[unit j, q*H + k]
  float* d_s = reinterpret_cast<float*>(smem + align16(sizeof(float) * 4 * (size_t)H * J));

  const int tid = threadIdx.x;
  const int jj = tid % J, g = tid / J;
  const int unit = blockIdx.x * J + jj;
  const bool unit_ok = unit < H;

  for (int idx = tid; idx < H * J * 4; idx += blockDim.x) {
    const int k = idx % H, rest = idx / H, q = rest % 4, jl = rest / 4;
    const int u = blockIdx.x * J + jl;
    w_s[((size_t)k * J + jl) * 4 + q] = u < H ? wh[(size_t)u * H4 + (size_t)q * H + k] : 0.f;
  }
  __syncthreads();

  auto cell = [&](int t, int row, float dh_in, float dc_in) {
    float a[4];
    cell_bwd(t, row, unit, B, H, gates, mask, cprev, dhs, dh_in, dc_in, da, dh0, dc0, a);
    float* ring = da_r + (size_t)(t & 1) * B * H4 + (size_t)row * H4 + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q) ring[(size_t)q * H] = a[q];
  };

  // step T-1: the cell backward from the final carries dhT, dcT
  for (int r0 = 0; r0 < B; r0 += BR) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + g * ROWS + i;
      if (row >= B || !unit_ok) continue;
      const size_t so = (size_t)row * H + unit;
      cell(T_ - 1, row, dhT[so], dcT[so]);
    }
  }

  for (int t = T_ - 1; t >= 0; --t) {
    grid.sync();  // da_t (ring slot t % 2) is complete in every block
    const float* dr = da_r + (size_t)(t & 1) * B * H4;
    for (int r0 = 0; r0 < B; r0 += BR) {
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

      for (int kc = 0; kc < H; kc += KC) {
        __syncthreads();
        // stage da_t[r0:r0+BR, q*H + kc : q*H + kc + KC] for q = 0..3
        const int n_el = 4 * KC * BR;
        for (int base = 0; base < n_el; base += LB * blockDim.x) {
          float v[LB];
#pragma unroll
          for (int u = 0; u < LB; ++u) {
            const int idx = base + u * blockDim.x + tid;
            const int q = idx / (KC * BR), rem = idx % (KC * BR);
            const int row = r0 + rem / KC, kk = kc + rem % KC;
            v[u] = (idx < n_el && row < B && kk < H)
                ? __ldcg(dr + (size_t)row * H4 + (size_t)q * H + kk) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < LB; ++u) {
            const int idx = base + u * blockDim.x + tid;
            if (idx < n_el) {
              const int q = idx / (KC * BR), rem = idx % (KC * BR);
              d_s[(q * KC + rem % KC) * ld + rem / KC] = v[u];
            }
          }
        }
        __syncthreads();
        const int kn = min(KC, H - kc);
#pragma unroll 4
        for (int k = 0; k < kn; ++k) {
          const float4 w = *reinterpret_cast<const float4*>(w_s + ((size_t)(kc + k) * J + jj) * 4);
          const float wq[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 dv = *reinterpret_cast<const float4*>(d_s + (q * KC + k) * ld + g * ROWS);
            acc[0][q] = fmaf(dv.x, wq[q], acc[0][q]);
            acc[1][q] = fmaf(dv.y, wq[q], acc[1][q]);
            acc[2][q] = fmaf(dv.z, wq[q], acc[2][q]);
            acc[3][q] = fmaf(dv.w, wq[q], acc[3][q]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + g * ROWS + i;
        if (row >= B || !unit_ok) continue;
        const size_t so = (size_t)row * H + unit;
        const float dh = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]) + dh0[so];
        if (t > 0) {
          cell(t - 1, row, dh, dc0[so]);
        } else {
          dh0[so] = dh;
        }
      }
    }
  }
}

cudaError_t launch_fma(const float* gates, const float* mask, const float* wh,
                       const float* cprev, const float* dhs, const float* dhT, const float* dcT,
                       float* da, float* da_r, float* dh0, float* dc0, int T_, int B, int H,
                       cudaStream_t stream) {
  int dev, nsm;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return err;
  int J = (H + nsm - 1) / nsm;
  const int grid = (H + J - 1) / J;
  int G = MAX_THREADS / J;
  if (G > (B + ROWS - 1) / ROWS) G = (B + ROWS - 1) / ROWS;
  if (G < 1) G = 1;
  const int block = J * G;
  if (block > 1024) return cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(float) * 4 * (size_t)H * J)
                      + sizeof(float) * 4 * KC * (size_t)(G * ROWS + 4);
  auto kern = lstm_bwd_fma_kernel;
  if ((err = check_cooperative((const void*)kern, grid, block, smem))) return err;
  void* args[] = {(void*)&gates, (void*)&mask, (void*)&wh, (void*)&cprev, (void*)&dhs,
                  (void*)&dhT, (void*)&dcT, (void*)&da, (void*)&da_r, (void*)&dh0,
                  (void*)&dc0, (void*)&T_, (void*)&B, (void*)&H, (void*)&J};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(block), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

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

// The same with wh [H, 4H] f32 (CUDA cores); da_r is an f32 scratch ring
// [2, B, 4H]. The launch plan is computed here.
int lstm_bwd_f32(const float* gates, const float* mask, const float* wh, const float* cprev,
                 const float* dhs, const float* dhT, const float* dcT, float* da, float* da_r,
                 float* dh0, float* dc0, int T, int B, int H, void* stream) {
  if (T < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  return launch_fma(gates, mask, wh, cprev, dhs, dhT, dcT, da, da_r, dh0, dc0, T, B, H,
                    static_cast<cudaStream_t>(stream));
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
