// Per-cluster (weighted) sums and counts of an assignment: the center
// update of every Lloyd step.
//
// Replaces: repro/kernels/kmeans_update.py, the Pallas kernel built by
// `_make_kernel` and launched by `kmeans_update`.
//
// Computes, for x (B, n, d), assign (B, n) int32 in [-1, k) and optional
// weights (B, n) f32,
//   sums[b, r, :] = sum_{i : assign[b, i] == r} w_i x_i,
//   counts[b, r]  = sum_{i : assign[b, i] == r} w_i,
// where assign == -1 contributes nothing.
//
// What bounds it on an H100: one add per loaded x element, so reading x
// (and the n-long assignment, once per cluster, from L2) is the bound.
//
// Design: the TPU kernel carried its sums across a sequential grid. Here
// nothing carries between blocks, and the repository's determinism rule
// forbids float atomics, so each block owns one (batch entry, cluster,
// 128-column chunk of d): it walks the n points in index order (the
// assignment staged through shared memory) and each thread accumulates
// its own column. Every sum therefore comes out in a fixed order, with
// no second pass. The column-chunk-0 block writes the weighted count.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int TC = 128;   // columns per block, one per thread
constexpr int CH = 1024;  // assignment / weight chunk staged in smem

template <typename T>
__global__ void __launch_bounds__(TC) kmeans_update_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ assign,
    const float* __restrict__ w, float* __restrict__ sums,
    float* __restrict__ counts, int n, int k, int d) {
  __shared__ int32_t as[CH];
  __shared__ float ws[CH];
  const int j = blockIdx.x * TC + threadIdx.x;
  const int r = blockIdx.y;
  const int b = blockIdx.z;
  const T* xb = x + (long long)b * n * d;
  const int32_t* ab = assign + (long long)b * n;
  const float* wb = w ? w + (long long)b * n : nullptr;

  float acc = 0.f, cnt = 0.f;
  for (int i0 = 0; i0 < n; i0 += CH) {
    const int m = min(CH, n - i0);
    for (int e = threadIdx.x; e < m; e += TC) {
      as[e] = ab[i0 + e];
      ws[e] = wb ? wb[i0 + e] : 1.f;
    }
    __syncthreads();
    for (int e = 0; e < m; ++e) {
      if (as[e] == r) {  // uniform across the block: no divergence
        const float wv = ws[e];
        cnt += wv;
        if (j < d) acc = fmaf(wv, load_f(xb + (long long)(i0 + e) * d + j),
                              acc);
      }
    }
    __syncthreads();
  }
  if (j < d) sums[((long long)b * k + r) * d + j] = acc;
  if (blockIdx.x == 0 && threadIdx.x == 0) counts[(long long)b * k + r] = cnt;
}

template <typename T>
cudaError_t launch(const void* x, const void* assign, const void* w,
                   void* sums, void* counts, int B, int n, int k, int d,
                   cudaStream_t stream) {
  dim3 grid((d + TC - 1) / TC, k, B);
  kmeans_update_kernel<T><<<grid, TC, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int32_t*>(assign),
      static_cast<const float*>(w), static_cast<float*>(sums),
      static_cast<float*>(counts), n, k, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). x: (B, n, d); assign: (B, n) int32;
// w: (B, n) f32 or null; sums: (B, k, d) f32; counts: (B, k) f32.
// Returns the cudaError_t of the launch.
extern "C" int kmeans_update_f32(const void* x, const void* assign,
                                 const void* w, void* sums, void* counts,
                                 int B, int n, int k, int d, void* stream) {
  return (int)repro_torch::launch<float>(x, assign, w, sums, counts, B, n,
                                         k, d,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int kmeans_update_bf16(const void* x, const void* assign,
                                  const void* w, void* sums, void* counts,
                                  int B, int n, int k, int d,
                                  void* stream) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      x, assign, w, sums, counts, B, n, k, d,
      static_cast<cudaStream_t>(stream));
}
