// Fused squared distance + argmin: the nearest center of every point.
//
// Replaces: repro/kernels/pdist_argmin.py, the Pallas kernel `_kernel`
// launched by `_pairwise_argmin` (public entry `pairwise_argmin`).
//
// Computes, for x (B, n, d) and centers c (B, k, d) or a shared (k, d),
//   dist(i, r) = max(||x_i||^2 - 2 x_i.c_r + ||c_r||^2, 0)
// with a masked center's distance set to exactly MASKED_DIST, and returns
// idx (B, n) int32 / min dist (B, n) f32. Ties go to the smallest center
// index: a strict `<` merges the center tiles in index order.
//
// What bounds it on an H100: it does 2k flops per 4-byte x element, and
// the card's f32 ridge point is 67 TFLOP/s over 3.35 TB/s = 20 flop/byte.
// So at the local shapes (k' = 10 centers, d = 300) reading x once from
// HBM is the bound, and at the server's k = 100 the f32 FMA rate is.
// The (n, k) distance matrix never leaves registers.
//
// Design: one block of TN threads owns TN rows of one batch entry, one
// row per thread. Feature chunks of x are staged transposed in shared
// memory (coalesced loads, conflict-free reads) and centers are staged
// per (TK x TD) tile, read as warp broadcasts. Each thread keeps TK
// partial dot products in registers and folds the finished tile into its
// running (best, idx) pair. TK is a template parameter picked from k, so
// a small k does not pay for a 32-wide register tile. Accumulation is
// IEEE f32 on the CUDA cores (no TF32, no tensor cores); bf16 storage is
// widened to f32 on load.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int TN = 128;  // rows per block, one per thread
constexpr int TD = 32;   // feature chunk staged in shared memory

template <typename T, int TK>
__global__ void __launch_bounds__(TN) pdist_argmin_kernel(
    const T* __restrict__ x, const T* __restrict__ c,
    const uint8_t* __restrict__ cmask, int32_t* __restrict__ idx_out,
    float* __restrict__ val_out, int n, int k, int d, long long c_bstride,
    long long m_bstride) {
  __shared__ float xs[TD][TN + 1];
  __shared__ float cs[TK][TD + 1];
  __shared__ float cn[TK];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  const int row = row0 + tid;
  const T* xb = x + (long long)b * n * d;
  const T* cb = c + (long long)b * c_bstride;
  const uint8_t* mb = cmask ? cmask + (long long)b * m_bstride : nullptr;

  float xn = 0.f;
  float best = inf_f();
  int besti = 0;
  for (int k0 = 0; k0 < k; k0 += TK) {
    float acc[TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) acc[t] = 0.f;
    for (int d0 = 0; d0 < d; d0 += TD) {
      for (int e = tid; e < TN * TD; e += TN) {
        const int r = e / TD, j = e % TD;
        const int gr = row0 + r, gj = d0 + j;
        xs[j][r] = (gr < n && gj < d) ? load_f(xb + (long long)gr * d + gj)
                                      : 0.f;
      }
      for (int e = tid; e < TK * TD; e += TN) {
        const int t = e / TD, j = e % TD;
        const int gt = k0 + t, gj = d0 + j;
        cs[t][j] = (gt < k && gj < d) ? load_f(cb + (long long)gt * d + gj)
                                      : 0.f;
      }
      __syncthreads();
      const int jmax = min(TD, d - d0);
      for (int j = 0; j < jmax; ++j) {
        const float xv = xs[j][tid];
        if (k0 == 0) xn = fmaf(xv, xv, xn);
#pragma unroll
        for (int t = 0; t < TK; ++t) acc[t] = fmaf(xv, cs[t][j], acc[t]);
      }
      __syncthreads();
    }
    if (tid < TK) {
      const int gt = k0 + tid;
      float s = 0.f;
      if (gt < k) {
        for (int j = 0; j < d; ++j) {
          const float v = load_f(cb + (long long)gt * d + j);
          s = fmaf(v, v, s);
        }
      }
      cn[tid] = s;
    }
    __syncthreads();
    const int tmax = min(TK, k - k0);
#pragma unroll
    for (int t = 0; t < TK; ++t) {
      if (t < tmax) {
        float dist = fmaxf(xn - 2.f * acc[t] + cn[t], 0.f);
        if (mb != nullptr && mb[k0 + t] == 0) dist = kMaskedDist;
        if (dist < best) {
          best = dist;
          besti = k0 + t;
        }
      }
    }
    __syncthreads();  // cn is rewritten by the next tile
  }
  if (row < n) {
    idx_out[(long long)b * n + row] = besti;
    val_out[(long long)b * n + row] = best;
  }
}

template <typename T, int TK>
cudaError_t launch(const void* x, const void* c, const void* cmask,
                   void* idx, void* val, int B, int n, int k, int d,
                   long long c_bstride, long long m_bstride,
                   cudaStream_t stream) {
  dim3 grid((n + TN - 1) / TN, B);
  pdist_argmin_kernel<T, TK><<<grid, TN, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const uint8_t*>(cmask), static_cast<int32_t*>(idx),
      static_cast<float*>(val), n, k, d, c_bstride, m_bstride);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* c, const void* cmask,
                     void* idx, void* val, int B, int n, int k, int d,
                     long long c_bstride, long long m_bstride,
                     cudaStream_t stream) {
  if (k <= 8)
    return launch<T, 8>(x, c, cmask, idx, val, B, n, k, d, c_bstride,
                        m_bstride, stream);
  if (k <= 16)
    return launch<T, 16>(x, c, cmask, idx, val, B, n, k, d, c_bstride,
                         m_bstride, stream);
  return launch<T, 32>(x, c, cmask, idx, val, B, n, k, d, c_bstride,
                       m_bstride, stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). x: (B, n, d); c: batch stride
// c_bstride elements (0 = shared); cmask: uint8 (B or 1, k) with batch
// stride m_bstride, or null. Returns the cudaError_t of the launch.
extern "C" int pdist_argmin_f32(const void* x, const void* c,
                                const void* cmask, void* idx, void* val,
                                int B, int n, int k, int d,
                                long long c_bstride, long long m_bstride,
                                void* stream) {
  return (int)repro_torch::dispatch<float>(
      x, c, cmask, idx, val, B, n, k, d, c_bstride, m_bstride,
      static_cast<cudaStream_t>(stream));
}

extern "C" int pdist_argmin_bf16(const void* x, const void* c,
                                 const void* cmask, void* idx, void* val,
                                 int B, int n, int k, int d,
                                 long long c_bstride, long long m_bstride,
                                 void* stream) {
  return (int)repro_torch::dispatch<__nv_bfloat16>(
      x, c, cmask, idx, val, B, n, k, d, c_bstride, m_bstride,
      static_cast<cudaStream_t>(stream));
}
