// Masked-carry LSTM forward over a whole sequence with f32 wh, for Hopper
// (sm_90a), on CUDA cores.
//
// Replaces the JAX package's Pallas TPU kernels for f32 wh:
//   ops/lstm_pallas.py::_fwd_kernel   (kSaveResiduals = true:  hs, cs, gates, hT, cT)
//   ops/lstm_pallas.py::_infer_kernel (kSaveResiduals = false: hs, hT, cT)
// With bf16 wh, both forms are lstm_infer.cu (tensor cores); lstm_fwd refuses
// wh_bf16 = 1 with cudaErrorInvalidValue.
// Per step t, for gates (i, f, g, o) = (sigmoid, sigmoid, tanh, sigmoid) of
//   a = xw[t] + h_{t-1} @ wh                            (f32 products)
//   c_raw = f * c + i * g;  h_raw = o * tanh(c_raw)
//   h = m * h_raw + (1 - m) * h;  c = m * c_raw + (1 - m) * c   (m = mask[t, row])
// hs[t] / cs[t] are the KEPT states, as in the TPU kernels.
//
// What bounds it on the H100: the recurrence is serial in t, and each step is
// a skinny product [B, H] x [H, 4H] that cannot start before the previous
// step's h is complete everywhere. Re-reading wh (16 MB in f32 at H = 1024)
// every step from device memory would make the sequence bound by bytes; the
// least work is 2*T*B*H*4H operations plus one read of xw and one write of hs.
//
// Design: one persistent cooperative grid of ceil(H / J) blocks, J =
// ceil(H / #SMs), so every block is resident at once. Block b owns hidden
// units [b*J, b*J + J) and keeps their four gate columns of wh in shared
// memory for the whole sequence ([H][J][4]), so wh is read from device memory
// once. Each step a block streams h_{t-1} (kept in hs[t-1], L2-resident)
// through shared memory in chunks of KC (LB loads in flight per thread),
// accumulates in f32 registers (4 rows x 4 gates per thread), applies the
// cell and the masked carry for its units, writes h_t into hs[t], and waits
// at a grid-wide barrier (cooperative_groups grid.sync) before the next step
// reads hs[t]. The cell state c lives in cT (each element read and written
// by one thread only). The product runs on CUDA cores (FMA): that is the f32
// route's definition (tensor cores have no exact f32 product; TF32 keeps 10
// bits of mantissa). The f32 route serves the f32 checks and models whose H
// keeps wh in f32; the main paths' bf16 wh never reaches it.
//
// Any T >= 1 and any B; H is limited by the shared memory of one block.
// Reads of data written during the kernel (hs, cT) use __ldcg (L2, not L1).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int KC = 32;           // k-chunk of h_{t-1} staged in shared memory
constexpr int ROWS = 4;          // rows per thread
constexpr int LB = 16;           // global loads a thread keeps in flight while staging
constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__host__ __device__ __forceinline__ size_t align16(size_t n) { return (n + 15) & ~size_t(15); }

template <bool kSaveResiduals>
__global__ void lstm_fwd_kernel(const float* __restrict__ xw,
                                const float* __restrict__ mask,
                                const float* __restrict__ wh,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                float* hs, float* cs, float* gates,
                                float* hT, float* cT,
                                int T_, int B, int H, int J) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
  const int G = blockDim.x / J;             // row groups of ROWS rows
  const int BR = G * ROWS;                  // rows per tile
  const int ld_h = BR + 4;                  // padded row of the staged chunk
  float* w_s = reinterpret_cast<float*>(smem);  // [H][J][4]
  float* h_s = reinterpret_cast<float*>(smem + align16(sizeof(float) * 4 * (size_t)H * J));

  const int tid = threadIdx.x;
  const int jj = tid % J, g = tid / J;
  const int unit = blockIdx.x * J + jj;
  const bool unit_ok = unit < H;

  for (int idx = tid; idx < H * J * 4; idx += blockDim.x) {
    const int q = idx % 4, jl = (idx / 4) % J, k = idx / (4 * J);
    const int u = blockIdx.x * J + jl;
    w_s[idx] = u < H ? wh[(size_t)k * 4 * H + (size_t)q * H + u] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T_; ++t) {
    const float* h_prev = t == 0 ? h0 : hs + (size_t)(t - 1) * B * H;
    const float* c_prev = t == 0 ? c0 : cT;
    for (int r0 = 0; r0 < B; r0 += BR) {
      float acc[ROWS][4];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][q] = 0.f;

      for (int kc = 0; kc < H; kc += KC) {
        __syncthreads();
        // stage h_{t-1}[r0:r0+BR, kc:kc+KC], LB loads in flight per thread
        const int n_el = KC * BR;
        for (int base = 0; base < n_el; base += LB * blockDim.x) {
          float v[LB];
#pragma unroll
          for (int u = 0; u < LB; ++u) {
            const int idx = base + u * blockDim.x + tid;
            const int row = r0 + idx / KC, kk = kc + idx % KC;
            v[u] = (idx < n_el && row < B && kk < H)
                ? __ldcg(h_prev + (size_t)row * H + kk) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < LB; ++u) {
            const int idx = base + u * blockDim.x + tid;
            if (idx < n_el) h_s[(idx % KC) * ld_h + idx / KC] = v[u];
          }
        }
        __syncthreads();
        const int kn = min(KC, H - kc);
#pragma unroll 8
        for (int k = 0; k < kn; ++k) {
          const float4 hv = *reinterpret_cast<const float4*>(h_s + k * ld_h + g * ROWS);
          const float4 wv = *reinterpret_cast<const float4*>(w_s + ((size_t)(kc + k) * J + jj) * 4);
          const float w[4] = {wv.x, wv.y, wv.z, wv.w};
          const float hr[ROWS] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
          for (int i = 0; i < ROWS; ++i)
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[i][q] = fmaf(hr[i], w[q], acc[i][q]);
        }
      }

#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = r0 + g * ROWS + i;
        if (row >= B || !unit_ok) continue;
        const size_t xo = ((size_t)t * B + row) * 4 * H + unit;
        const float ig = sigmoid(xw[xo] + acc[i][0]);
        const float fg = sigmoid(xw[xo + H] + acc[i][1]);
        const float gg = tanhf(xw[xo + 2 * (size_t)H] + acc[i][2]);
        const float og = sigmoid(xw[xo + 3 * (size_t)H] + acc[i][3]);
        const size_t so = (size_t)row * H + unit;
        const float cp = __ldcg(c_prev + so);
        const float hp = __ldcg(h_prev + so);
        const float c_raw = fg * cp + ig * gg;
        const float h_raw = og * tanhf(c_raw);
        const float m = mask[(size_t)t * B + row];
        const float hk = m * h_raw + (1.f - m) * hp;
        const float ck = m * c_raw + (1.f - m) * cp;
        const size_t oo = (size_t)t * B * H + so;
        hs[oo] = hk;
        cT[so] = ck;
        if (kSaveResiduals) {
          cs[oo] = ck;
          gates[xo] = ig;
          gates[xo + H] = fg;
          gates[xo + 2 * (size_t)H] = gg;
          gates[xo + 3 * (size_t)H] = og;
        }
        if (t == T_ - 1) hT[so] = hk;
      }
    }
    if (t + 1 < T_) grid.sync();
  }
}

template <bool kSaveResiduals>
cudaError_t launch(const float* xw, const float* mask, const float* wh,
                   const float* h0, const float* c0, float* hs, float* cs,
                   float* gates, float* hT, float* cT, int T_, int B, int H,
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
  const size_t smem = align16(sizeof(float) * 4 * (size_t)H * J)
                      + sizeof(float) * KC * (size_t)(G * ROWS + 4);
  if (smem > (size_t)smem_max) return cudaErrorInvalidValue;
  auto kern = lstm_fwd_kernel<kSaveResiduals>;
  if ((err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, smem))) return err;
  if (per_sm * nsm < grid) return cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xw, (void*)&mask, (void*)&wh, (void*)&h0, (void*)&c0,
                  (void*)&hs, (void*)&cs, (void*)&gates, (void*)&hT, (void*)&cT,
                  (void*)&T_, (void*)&B, (void*)&H, (void*)&J};
  err = cudaLaunchCooperativeKernel((void*)kern, dim3(grid), dim3(block), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xw [T, B, 4H] f32; mask [T, B] f32; wh [H, 4H] f32 (wh_bf16 = 0; bf16 wh
// is lstm_infer.cu's and refused here); h0, c0 [B, H] f32. Writes hs
// [T, B, H], hT, cT [B, H] and, when save_residuals, cs [T, B, H] and gates
// [T, B, 4H] (activations i, f, g, o).
// All arrays contiguous on the current device. Returns a cudaError_t.
int lstm_fwd(const float* xw, const float* mask, const void* wh, int wh_bf16,
             const float* h0, const float* c0, float* hs, float* cs, float* gates,
             float* hT, float* cT, int T, int B, int H, int save_residuals,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (wh_bf16) return cudaErrorInvalidValue;  // the tensor-core lstm_infer.cu
  const auto* w = static_cast<const float*>(wh);
  return save_residuals
      ? launch<true>(xw, mask, w, h0, c0, hs, cs, gates, hT, cT, T, B, H, s)
      : launch<false>(xw, mask, w, h0, c0, hs, cs, gates, hT, cT, T, B, H, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
