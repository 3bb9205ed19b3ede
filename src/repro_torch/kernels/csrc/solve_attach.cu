// The fused serve step: per request, the bounded Lloyd loop until the
// assignment is stable (Algorithm 1 step 4), the Theorem 3.2 attach of
// the converged centers against tau, and the Definition 3.3 labels.
//
// Replaces: repro/kernels/solve_attach.py, the Pallas kernel `_kernel`
// launched by `_solve_attach` (public entry `solve_attach_fused`).
//
// Contract (kernels/ref.py solve_attach): x (B, n, d), centers0 (B, k', d)
// and tau (k, d) in the storage type (f32, or bf16 with f32
// accumulation), center_mask (B, k') and point_mask (B, n) as uint8 ->
// labels (B, n) int32, min_sq_dist (B, n) f32, centers (B, k', d) f32,
// center_labels (B, k') int32.
//
// What bounds it on an H100: per Lloyd iteration it reads the request's
// x twice (assignment, then center sums) and does about 4 k' flops per x
// element, so on-chip bandwidth to x bounds it. At the serve shape one
// request (n = 1024, d = 300 f32) is 1.2 MB, which does not fit in the
// 227 KB of shared memory a block may use, so x streams from L2 every
// iteration; a batch of 8 requests is 9.8 MB, well inside the 50 MB L2,
// so only the first pass reads HBM. A batch of 8 occupies 8 of the 132
// SMs: the kernel is latency bound at that batch.
//
// Design: one block per request, so each request's data-dependent loop
// ends by itself inside the kernel, with no host sync per iteration. The
// centers, their new sums, the counts, the point norms and the n-long
// assignment stay in shared memory (about 32 KB at k' = 10, d = 300,
// n = 1024). Assignment: one warp per point, lanes strided over d, the
// partial dots summed by warp shuffles; convergence is a block-wide OR of
// "some assignment changed". Center sums: one thread per column walks
// the points in index order into its own column of the shared sums, a
// fixed-order reduction with no atomics. The attach (k' x k) and the
// induced labels run in the same block after the loop.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int THREADS = 512;
constexpr int NWARPS = THREADS / 32;
constexpr int G = 16;  // centers per register group in the assignment

struct Smem {
  float* cen;    // (kp, d) current centers, values of the storage type
  float* sums;   // (kp, d)
  float* xn;     // (n) point norms
  float* cn;     // (kp) center norms
  float* cnt;    // (kp) counts
  int32_t* a;    // (n) assignment, -2 before the first iteration
  int32_t* ctr;  // (kp) tau label of each center
};

__host__ __device__ inline size_t smem_bytes(int n, int kp, int d) {
  return sizeof(float) * (2 * (size_t)kp * d + n + 2 * (size_t)kp) +
         sizeof(int32_t) * ((size_t)n + kp);
}

template <typename T>
__device__ void center_norms(const Smem& s, int kp, int d) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kp; r += NWARPS) {
    float v = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float c = s.cen[r * d + j];
      v = fmaf(c, c, v);
    }
    v = warp_sum(v);
    if (lane == 0) s.cn[r] = v;
  }
}

// Nearest center of every point; returns nonzero in lane 0 of a warp if
// one of its points changed assignment. Writes min_sq_dist when `mind`
// is not null.
template <typename T>
__device__ int assign_points(const Smem& s, const T* __restrict__ xb,
                             const uint8_t* __restrict__ cm,
                             const uint8_t* __restrict__ pm, int n, int kp,
                             int d, float* __restrict__ mind) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int changed = 0;
  for (int i = warp; i < n; i += NWARPS) {
    const T* xi = xb + (long long)i * d;
    float best = inf_f();
    int bi = 0;
    for (int g0 = 0; g0 < kp; g0 += G) {
      float p[G];
#pragma unroll
      for (int t = 0; t < G; ++t) p[t] = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float xv = load_f(xi + j);
#pragma unroll
        for (int t = 0; t < G; ++t)
          if (g0 + t < kp) p[t] = fmaf(xv, s.cen[(g0 + t) * d + j], p[t]);
      }
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (g0 + t < kp) {
          const float dot = warp_sum(p[t]);
          float dist = fmaxf(s.xn[i] - 2.f * dot + s.cn[g0 + t], 0.f);
          if (cm[g0 + t] == 0) dist = kMaskedDist;
          if (dist < best) {
            best = dist;
            bi = g0 + t;
          }
        }
      }
    }
    const bool live = pm[i] != 0;
    const int ai = live ? bi : -1;
    if (lane == 0) {
      changed |= (s.a[i] != ai);
      s.a[i] = ai;
      if (mind != nullptr) mind[i] = live ? best : 0.f;
    }
  }
  return changed;
}

template <typename T>
__global__ void __launch_bounds__(THREADS) solve_attach_kernel(
    const T* __restrict__ x, const T* __restrict__ c0,
    const T* __restrict__ tau, const uint8_t* __restrict__ cmask,
    const uint8_t* __restrict__ pmask, int32_t* __restrict__ labels,
    float* __restrict__ mind, float* __restrict__ centers_out,
    int32_t* __restrict__ clbl, int n, int kp, int k, int d,
    int max_iters) {
  extern __shared__ float smem[];
  Smem s;
  s.cen = smem;
  s.sums = s.cen + kp * d;
  s.xn = s.sums + kp * d;
  s.cn = s.xn + n;
  s.cnt = s.cn + kp;
  s.a = reinterpret_cast<int32_t*>(s.cnt + kp);
  s.ctr = s.a + n;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const T* xb = x + (long long)b * n * d;
  const uint8_t* cm = cmask + (long long)b * kp;
  const uint8_t* pm = pmask + (long long)b * n;

  for (int e = tid; e < kp * d; e += THREADS)
    s.cen[e] = load_f(c0 + (long long)b * kp * d + e);
  for (int i = tid; i < n; i += THREADS) s.a[i] = -2;
  for (int i = warp; i < n; i += NWARPS) {
    const T* xi = xb + (long long)i * d;
    float v = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float xv = load_f(xi + j);
      v = fmaf(xv, xv, v);
    }
    v = warp_sum(v);
    if (lane == 0) s.xn[i] = v;
  }
  __syncthreads();

  for (int it = 0; it < max_iters; ++it) {
    center_norms<T>(s, kp, d);
    __syncthreads();
    const int changed =
        __syncthreads_or(assign_points<T>(s, xb, cm, pm, n, kp, d, nullptr));
    // Counts and sums of the new assignment, both in point order.
    if (tid < kp) {
      float c = 0.f;
      for (int i = 0; i < n; ++i) c += (s.a[i] == tid) ? 1.f : 0.f;
      s.cnt[tid] = c;
    }
    for (int j = tid; j < d; j += THREADS) {
      for (int r = 0; r < kp; ++r) s.sums[r * d + j] = 0.f;
      for (int i0 = 0; i0 < n; i0 += 4) {
        int r[4];
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          r[u] = (i0 + u < n) ? s.a[i0 + u] : -1;
          v[u] = (r[u] >= 0) ? load_f(xb + (long long)(i0 + u) * d + j) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (r[u] >= 0) s.sums[r[u] * d + j] += v[u];
      }
    }
    __syncthreads();
    for (int e = tid; e < kp * d; e += THREADS) {
      const float c = s.cnt[e / d];
      if (c > 0.f) s.cen[e] = round_store<T>(s.sums[e] / fmaxf(c, 1.f));
    }
    __syncthreads();
    if (!changed) break;
  }

  // Final assignment against the final centers, with min distances.
  center_norms<T>(s, kp, d);
  __syncthreads();
  assign_points<T>(s, xb, cm, pm, n, kp, d, mind + (long long)b * n);
  __syncthreads();

  // Theorem 3.2 attach: nearest tau center of every local center.
  for (int r = warp; r < kp; r += NWARPS) {
    float best = inf_f();
    int bi = 0;
    for (int q = 0; q < k; ++q) {
      const T* tq = tau + (long long)q * d;
      float dot = 0.f, tn = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float tv = load_f(tq + j);
        dot = fmaf(s.cen[r * d + j], tv, dot);
        tn = fmaf(tv, tv, tn);
      }
      dot = warp_sum(dot);
      tn = warp_sum(tn);
      const float dist = fmaxf(s.cn[r] - 2.f * dot + tn, 0.f);
      if (dist < best) {
        best = dist;
        bi = q;
      }
    }
    if (lane == 0) s.ctr[r] = cm[r] ? bi : -1;
  }
  __syncthreads();

  // Definition 3.3 induced labels and the outputs.
  for (int i = tid; i < n; i += THREADS) {
    const int ai = s.a[i];
    labels[(long long)b * n + i] = ai >= 0 ? s.ctr[ai] : -1;
  }
  for (int e = tid; e < kp * d; e += THREADS)
    centers_out[(long long)b * kp * d + e] = s.cen[e];
  for (int r = tid; r < kp; r += THREADS) clbl[(long long)b * kp + r] = s.ctr[r];
}

template <typename T>
cudaError_t launch(const void* x, const void* c0, const void* tau,
                   const void* cmask, const void* pmask, void* labels,
                   void* mind, void* centers, void* clbl, int B, int n,
                   int kp, int k, int d, int max_iters,
                   cudaStream_t stream) {
  const size_t bytes = smem_bytes(n, kp, d);
  cudaError_t err = cudaFuncSetAttribute(
      solve_attach_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  solve_attach_kernel<T><<<B, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c0),
      static_cast<const T*>(tau), static_cast<const uint8_t*>(cmask),
      static_cast<const uint8_t*>(pmask), static_cast<int32_t*>(labels),
      static_cast<float*>(mind), static_cast<float*>(centers),
      static_cast<int32_t*>(clbl), n, kp, k, d, max_iters);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// Dynamic shared memory one request needs; the wrapper refuses shapes
// above the card's per-block limit.
extern "C" long long solve_attach_smem_bytes(int n, int kp, int d) {
  return (long long)repro_torch::smem_bytes(n, kp, d);
}

// C interface (loaded with ctypes). Returns the cudaError_t of the launch.
extern "C" int solve_attach_f32(const void* x, const void* c0,
                                const void* tau, const void* cmask,
                                const void* pmask, void* labels, void* mind,
                                void* centers, void* clbl, int B, int n,
                                int kp, int k, int d, int max_iters,
                                void* stream) {
  return (int)repro_torch::launch<float>(
      x, c0, tau, cmask, pmask, labels, mind, centers, clbl, B, n, kp, k, d,
      max_iters, static_cast<cudaStream_t>(stream));
}

extern "C" int solve_attach_bf16(const void* x, const void* c0,
                                 const void* tau, const void* cmask,
                                 const void* pmask, void* labels, void* mind,
                                 void* centers, void* clbl, int B, int n,
                                 int kp, int k, int d, int max_iters,
                                 void* stream) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      x, c0, tau, cmask, pmask, labels, mind, centers, clbl, B, n, kp, k, d,
      max_iters, static_cast<cudaStream_t>(stream));
}
