// Fused vocab projection + cross-entropy forward, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas TPU kernel ops/ce_pallas.py::_ce_kernel
// in both its forms: for h [N, nh], W [nh, V], tgt [N]
//   logp[n] = (h W)[n, tgt[n]] - logsumexp_v (h W)[n, v],   lse[n] = logsumexp
// as an online (max, sum of exp, target logit) over vocab tiles, with the
// ragged last tile masked to -1e30.
//   - forward form (ce_fwd, kSave = false): no [N, V] array ever reaches
//     device memory;
//   - grad mode (ce_fwd_train, kSave = true; the TPU kernel with
//     save_logits=True): each logits tile is also written, rounded to the
//     operand type (bf16, or f32 in f32-operand mode), into the residual
//     spill [N, V], and a second running sum s2 of exp(rounded - running max)
//     over the real columns gives lse[n] = m + log(s2), the logsumexp of the
//     ROUNDED logits, so that the backward's exp(spill - lse) rows sum to
//     exactly 1; logp keeps the unrounded m + log(s).
//
// What bounds it on the H100: 2*N*nh*V operations (2.5 TFLOP per call at the
// IW decoder's N = 640*95, nh = 1024, V = 20004), against which the inputs are
// small (h 124 MB, W 41 MB in bf16): at the bf16 tensor-core rate the product
// is the bound, not the bytes. Every block re-streams W from L2 (W is about
// L2-sized), so taller row tiles cut that traffic; this version does not tune it.
//
// Design: one block per BM = 64 rows walks V in BN = 128-column tiles. For
// each tile it forms the logits tile h_tile . W_tile in f32 in shared memory,
// over K-chunks of BK = 32 staged in shared memory:
//   - bf16 operands: tensor cores through nvcuda::wmma (16x16x16, f32
//     accumulators), 8 warps of 32x32;
//   - f32 operands (used by the f32 checks): FMA, 4x8 outputs per thread.
// Then 4 threads per row update the row's running max, sum of exp and target
// logit over the tile (shuffle reductions), exactly the TPU kernel's
// per-vocab-tile update. The operands are what the caller passes (bf16 as in
// the JAX package's default mxu_dtype), accumulation is f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BM = 64, BN = 128, BK = 32, NTHREADS = 256;
constexpr float NEG = -1e30f;
constexpr int LDA_H = BK + 8;  // bf16 A tile [BM][BK] row-major
constexpr int LDB_H = BN + 8;  // bf16 B tile [BK][BN] row-major
constexpr int LDA_F = BM + 4;  // f32 A tile stored transposed [BK][BM]
constexpr int LDB_F = BN + 4;  // f32 B tile [BK][BN]
constexpr int LDC = BN + 4;    // f32 logits tile [BM][BN]

template <typename T>
struct Tiles {
  static constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  static constexpr size_t a_bytes = kBf16 ? sizeof(T) * BM * LDA_H : sizeof(float) * BK * LDA_F;
  static constexpr size_t b_bytes = kBf16 ? sizeof(T) * BK * LDB_H : sizeof(float) * BK * LDB_F;
  static constexpr size_t c_bytes = sizeof(float) * BM * LDC;
  static constexpr size_t smem = a_bytes + b_bytes + c_bytes;
};

// logits tile for rows [row0, row0+BM) x cols [col0, col0+BN) into Cs (f32)
__device__ __forceinline__ void logits_tile(const __nv_bfloat16* __restrict__ h,
                                            const __nv_bfloat16* __restrict__ w,
                                            unsigned char* smem, int row0, int col0,
                                            int N, int nh, int V) {
  using Tl = Tiles<__nv_bfloat16>;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = reinterpret_cast<__nv_bfloat16*>(smem + Tl::a_bytes);
  float* Cs = reinterpret_cast<float*>(smem + Tl::a_bytes + Tl::b_bytes);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 4, wc = warp % 4;  // warp tile: rows wr*32, cols wc*32
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < nh; k0 += BK) {
    __syncthreads();
    // all loads of the chunk in flight before the shared-memory stores
    __nv_bfloat16 va[BM * BK / NTHREADS], vb[BK * BN / NTHREADS];
#pragma unroll
    for (int u = 0; u < BM * BK / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid, gr = row0 + idx / BK, gk = k0 + idx % BK;
      va[u] = (gr < N && gk < nh) ? h[(size_t)gr * nh + gk] : zero;
    }
#pragma unroll
    for (int u = 0; u < BK * BN / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid, gk = k0 + idx / BN, gc = col0 + idx % BN;
      vb[u] = (gk < nh && gc < V) ? w[(size_t)gk * V + gc] : zero;
    }
#pragma unroll
    for (int u = 0; u < BM * BK / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid;
      As[(idx / BK) * LDA_H + idx % BK] = va[u];
    }
#pragma unroll
    for (int u = 0; u < BK * BN / NTHREADS; ++u) {
      const int idx = u * NTHREADS + tid;
      Bs[(idx / BN) * LDB_H + idx % BN] = vb[u];
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wr * 32 + i * 16) * LDA_H + kk, LDA_H);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + kk * LDB_H + wc * 32 + j * 16, LDB_H);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wr * 32 + i * 16) * LDC + wc * 32 + j * 16, acc[i][j], LDC,
                              wmma::mem_row_major);
}

__device__ __forceinline__ void logits_tile(const float* __restrict__ h,
                                            const float* __restrict__ w,
                                            unsigned char* smem, int row0, int col0,
                                            int N, int nh, int V) {
  using Tl = Tiles<float>;
  float* As = reinterpret_cast<float*>(smem);  // [BK][LDA_F], transposed
  float* Bs = reinterpret_cast<float*>(smem + Tl::a_bytes);
  float* Cs = reinterpret_cast<float*>(smem + Tl::a_bytes + Tl::b_bytes);
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

__device__ __forceinline__ float rounded(float x, float) { return x; }
__device__ __forceinline__ float rounded(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

template <typename T, bool kSave>
__global__ void __launch_bounds__(NTHREADS)
ce_fwd_kernel(const T* __restrict__ h, const T* __restrict__ w, const int* __restrict__ tgt,
              float* __restrict__ logp, float* __restrict__ lse, T* __restrict__ spill,
              int N, int nh, int V) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* Cs = reinterpret_cast<const float*>(smem + Tiles<T>::a_bytes + Tiles<T>::b_bytes);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  const int er = tid / 4, ep = tid % 4;  // 4 threads per row; thread ep takes cols c*4 + ep
  const int grow = row0 + er;
  const int target = grow < N ? tgt[grow] : -1;
  float m_run = -INFINITY, s_run = 0.f, s2_run = 0.f, t_logit = 0.f;

  for (int col0 = 0; col0 < V; col0 += BN) {
    logits_tile(h, w, smem, row0, col0, N, nh, V);
    __syncthreads();
    if (kSave) {  // the residual: the tile rounded to T, row-major [N, V]
      for (int idx = tid; idx < BM * BN; idx += NTHREADS) {
        const int r = idx / BN, c = idx % BN, gr = row0 + r, gc = col0 + c;
        if (gr < N && gc < V) spill[(size_t)gr * V + gc] = T(Cs[r * LDC + c]);
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
    float ssum = 0.f, ssum2 = 0.f;
    for (int c = 0; c < BN / 4; ++c) {
      const int n = c * 4 + ep, gc = col0 + n;
      ssum += expf((gc < V ? crow[n] : NEG) - m_new);
      if (kSave) ssum2 += expf((gc < V ? rounded(crow[n], T(0.f)) : NEG) - m_new);
    }
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 1);
    ssum += __shfl_xor_sync(0xffffffffu, ssum, 2);
    const float scale = expf(m_run - m_new);
    s_run = s_run * scale + ssum;
    if (kSave) {
      ssum2 += __shfl_xor_sync(0xffffffffu, ssum2, 1);
      ssum2 += __shfl_xor_sync(0xffffffffu, ssum2, 2);
      s2_run = s2_run * scale + ssum2;
    }
    m_run = m_new;
  }
  t_logit += __shfl_xor_sync(0xffffffffu, t_logit, 1);
  t_logit += __shfl_xor_sync(0xffffffffu, t_logit, 2);
  if (ep == 0 && grow < N) {
    const float l = m_run + logf(s_run);
    lse[grow] = kSave ? m_run + logf(s2_run) : l;
    logp[grow] = t_logit - l;
  }
}

template <typename T, bool kSave>
cudaError_t launch(const void* h, const void* w, const int* tgt, float* logp, float* lse,
                   void* spill, int N, int nh, int V, cudaStream_t stream) {
  if (N < 1 || nh < 1 || V < 1) return cudaErrorInvalidValue;
  auto kern = ce_fwd_kernel<T, kSave>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Tiles<T>::smem);
  if (err != cudaSuccess) return err;
  kern<<<(N + BM - 1) / BM, NTHREADS, Tiles<T>::smem, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(w), tgt, logp, lse,
      static_cast<T*>(spill), N, nh, V);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// h [N, nh], w [nh, V]: both bf16 (bf16 = 1) or both f32; tgt [N] int32 in
// [0, V). Writes logp [N] and lse [N] (f32). Contiguous, on the current
// device. Returns a cudaError_t.
int ce_fwd(const void* h, const void* w, const int* tgt, float* logp, float* lse,
           int N, int nh, int V, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, false>(h, w, tgt, logp, lse, nullptr, N, nh, V, s)
              : launch<float, false>(h, w, tgt, logp, lse, nullptr, N, nh, V, s);
}

// Grad mode: as ce_fwd, and writes spill [N, V] (the logits in the operand
// type) and, as lse, the logsumexp of the spilled (rounded) logits.
int ce_fwd_train(const void* h, const void* w, const int* tgt, float* logp, float* lse,
                 void* spill, int N, int nh, int V, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch<__nv_bfloat16, true>(h, w, tgt, logp, lse, spill, N, nh, V, s)
              : launch<float, true>(h, w, tgt, logp, lse, spill, N, nh, V, s);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
