// Masked-carry LSTM backward (reverse-time sweep) over a whole sequence, for
// Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel
//   ops/lstm_pallas.py::_bwd_kernel  (with _bwd_call)
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
// What bounds it on the H100: like the forward, the sweep is serial in t and
// each step's product [B, 4H] x [4H, H] cannot start before every unit's da_t
// is complete. The least work is 2*T*B*4H*H operations plus one read of
// gates, c_prev, dhs and one write of da; re-reading wh (8 MB in bf16 at
// H = 1024) every step from device memory would make it bound by bytes.
//
// Design: the persistent cooperative grid of lstm_fwd.cu. Block b owns
// hidden units [b*J, b*J + J), J = ceil(H / #SMs), and keeps those units'
// ROWS of wh (wh[j, :] over all 4H columns; [H][J][4], 64 KB in bf16 at
// H = 1024, J = 8) in shared memory for the whole sweep. Per step, after one
// grid-wide barrier (cooperative_groups grid.sync):
//   - each block computes its units' dh for all rows from ALL of da_t, which
//     it streams through shared memory in k-chunks of KC per gate quarter
//     (4 rows x 4 quarter-sums per thread in f32 registers, FMA);
//   - the same thread then applies the cell backward of step t-1 to the
//     (row, unit) pairs it owns and writes da_{t-1}.
// Every block reads all of da_t (B*4H values, 4x what the forward reads of
// h_{t-1}); the cell backward therefore also writes a copy of da rounded to
// wh's type (the product rounds to it anyway) into a two-slot ring da_r, so
// in bf16 the per-step read is halved. Slot t%2 is read in step t while
// step t-1's slot is written; the barrier between steps orders them.
// The carries live in dh0 / dc0: each element is read and written by its one
// owning thread (dh0 holds (1 - m) * dhk between the two halves of a step).
// Reads of da_r, which other blocks wrote during the kernel, use __ldcg (L2,
// never a stale L1 line).
// The product runs on CUDA cores (FMA), not tensor cores: a first version
// that is right; mma/wgmma tiles are later work.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;           // k-chunk of each gate quarter of da_t staged in shared memory
constexpr int ROWS = 4;          // rows per thread
constexpr int LB = 16;           // global loads a thread keeps in flight while staging
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  return __bfloat162float(__ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p))));
}

__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ void load4(const float* p, float w[4]) {
  float4 v = *reinterpret_cast<const float4*>(p);
  w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float w[4]) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 a = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.x));
  float2 b = __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&raw.y));
  w[0] = a.x; w[1] = a.y; w[2] = b.x; w[3] = b.y;
}

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

// The cell backward of step t for (row, unit): writes da[t], its rounded copy
// into ring slot t % 2, and the carries (1 - m) * dhk -> dhc, dc_{t-1} -> dcc.
template <typename T>
__device__ __forceinline__ void cell_bwd(int t, int row, int unit, int B, int H,
                                         const float* __restrict__ gates,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ cprev,
                                         const float* __restrict__ dhs,
                                         float dh_in, float dc_in,
                                         float* da, T* da_r, float* dhc, float* dcc) {
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
  const float a[4] = {dc_tot * gg * ig * (1.f - ig), dc_tot * cp * fg * (1.f - fg),
                      dc_tot * ig * (1.f - gg * gg), do_ * og * (1.f - og)};
  T* ring = da_r + (size_t)(t & 1) * B * H4 + (size_t)row * H4 + unit;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    da[go + (size_t)q * H] = a[q];
    store_as(ring + (size_t)q * H, a[q]);
  }
  dhc[so] = (1.f - m) * dhk;
  dcc[so] = dc_tot * fg + (1.f - m) * dck;
}

template <typename T>
__global__ void lstm_bwd_kernel(const float* __restrict__ gates,
                                const float* __restrict__ mask,
                                const T* __restrict__ wh,
                                const float* __restrict__ cprev,
                                const float* __restrict__ dhs,
                                const float* __restrict__ dhT,
                                const float* __restrict__ dcT,
                                float* da, T* da_r, float* dh0, float* dc0,
                                int T_, int B, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / J;             // row groups of ROWS rows
  const int BR = G * ROWS;                  // rows per tile
  const int ld = BR + 4;                    // padded row of the staged chunk
  const size_t H4 = 4 * (size_t)H;
  T* w_s = reinterpret_cast<T*>(smem);      // [H][J][4]: w_s[(k*J + j)*4 + q] = wh[unit j, q*H + k]
  float* d_s = reinterpret_cast<float*>(smem + align16(sizeof(T) * 4 * (size_t)H * J));

  const int tid = threadIdx.x;
  const int jj = tid % J, g = tid / J;
  const int unit = blockIdx.x * J + jj;
  const bool unit_ok = unit < H;

  for (int idx = tid; idx < H * J * 4; idx += blockDim.x) {
    const int k = idx % H, rest = idx / H, q = rest % 4, jl = rest / 4;
    const int u = blockIdx.x * J + jl;
    w_s[((size_t)k * J + jl) * 4 + q] = u < H ? wh[(size_t)u * H4 + (size_t)q * H + k] : T(0.f);
  }
  __syncthreads();

  // step T-1: the cell backward from the final carries dhT, dcT
  for (int r0 = 0; r0 < B; r0 += BR) {
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = r0 + g * ROWS + i;
      if (row >= B || !unit_ok) continue;
      const size_t so = (size_t)row * H + unit;
      cell_bwd<T>(T_ - 1, row, unit, B, H, gates, mask, cprev, dhs, dhT[so], dcT[so],
                  da, da_r, dh0, dc0);
    }
  }

  for (int t = T_ - 1; t >= 0; --t) {
    grid.sync();  // da_t (ring slot t % 2) is complete in every block
    const T* dr = da_r + (size_t)(t & 1) * B * H4;
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
                ? ldcg_f(dr + (size_t)row * H4 + (size_t)q * H + kk) : 0.f;
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
          float w[4];
          load4(w_s + ((size_t)(kc + k) * J + jj) * 4, w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float4 dv = *reinterpret_cast<const float4*>(d_s + (q * KC + k) * ld + g * ROWS);
            acc[0][q] = fmaf(dv.x, w[q], acc[0][q]);
            acc[1][q] = fmaf(dv.y, w[q], acc[1][q]);
            acc[2][q] = fmaf(dv.z, w[q], acc[2][q]);
            acc[3][q] = fmaf(dv.w, w[q], acc[3][q]);
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
          cell_bwd<T>(t - 1, row, unit, B, H, gates, mask, cprev, dhs, dh, dc0[so],
                      da, da_r, dh0, dc0);
        } else {
          dh0[so] = dh;
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(const float* gates, const float* mask, const void* wh_raw,
                   const float* cprev, const float* dhs, const float* dhT, const float* dcT,
                   float* da, void* da_r_raw, float* dh0, float* dc0, int T_, int B, int H,
                   cudaStream_t stream) {
  int dev, nsm, coop, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev))) return err;
  if ((err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev)))
    return err;
  if (!coop || T_ < 1 || B < 1 || H < 1) return cudaErrorInvalidValue;
  int J = (H + nsm - 1) / nsm;
  const int grid = (H + J - 1) / J;
  int G = MAX_THREADS / J;
  if (G > (B + ROWS - 1) / ROWS) G = (B + ROWS - 1) / ROWS;
  if (G < 1) G = 1;
  const int block = J * G;
  if (block > 1024) return cudaErrorInvalidValue;
  const size_t smem = align16(sizeof(T) * 4 * (size_t)H * J)
                      + sizeof(float) * 4 * KC * (size_t)(G * ROWS + 4);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kern = lstm_bwd_kernel<T>;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, smem))) return err;
  if (per_sm * nsm < grid) return cudaErrorCooperativeLaunchTooLarge;
  const T* wh = static_cast<const T*>(wh_raw);
  T* da_r = static_cast<T*>(da_r_raw);
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
// bf16 (wh_bf16 = 1) or f32. Writes da [T, B, 4H], dh0, dc0 [B, H] (f32) and
// uses da_r, a scratch ring [2, B, 4H] of wh's type. All arrays contiguous on
// the current device. Returns a cudaError_t.
int lstm_bwd(const float* gates, const float* mask, const void* wh, int wh_bf16,
             const float* cprev, const float* dhs, const float* dhT, const float* dcT,
             float* da, void* da_r, float* dh0, float* dc0, int T, int B, int H,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return wh_bf16
      ? launch<__nv_bfloat16>(gates, mask, wh, cprev, dhs, dhT, dcT, da, da_r, dh0, dc0, T, B, H, s)
      : launch<float>(gates, mask, wh, cprev, dhs, dhT, dcT, da, da_r, dh0, dc0, T, B, H, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
