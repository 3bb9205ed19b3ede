// Sliding-window decode attention: one query token per sequence against a
// window of W cached keys (the ring cache of a sliding-window model), with
// GQA head groups.
//
// Replaces: repro/kernels/swa_decode.py, the Pallas kernel of
// `swa_decode_attention` (its body `_make_kernel`).
//
// Computes, for q (b, h, dh), kw / vw (b, W, kvh, dh), bias (b, W) f32 and
// scale, with g = h / kvh and query head i = hh * g + gi of kv head hh:
//   s[j]      = (q[b, i] . kw[b, j, hh]) * scale + bias[b, j]
//   out[b, i] = sum_j softmax_j(s) * vw[b, j, hh]
// in f32, stored in q's dtype. The window is a ring: its valid slots (bias
// 0) may lie anywhere, and the kernel assumes no order among them.
//
// What bounds it on an H100: bytes. Every key and value of the window is
// read once (2 * b * W * kvh * dh elements) for 4 flops per pair of
// elements, far below the card's ~295 flops per byte in bf16.
//
// Design: the TPU kernel walked the window on a sequential grid axis
// (batch, kv_head, window_block) over a window padded to its block size,
// carrying the running max, denominator and accumulator in scratch. Here
// one block owns one (batch, kv head) and walks the whole window itself
// in tiles of 64 keys: each tile of K and V is loaded once, widened to f32
// (16-byte loads where the row allows), into shared memory, and serves
// all g query rows of the group. The g rows' running max m, denominator l
// and correction live in shared memory, the (g, dh) accumulator in
// registers (a thread owns g * dh / 256 of it). The last tile is cut to
// the window, so W needs no padding and no copy on the host. The order of
// operations is the TPU kernel's: m starts at -1e30, p = exp(s - m_new),
// l = l * corr + sum(p), acc = acc * corr + p V, and the final division
// is by max(l, 1e-30). A tile of masked keys before the first valid one
// adds p = 1 for each of them, which the correction exp(-1e30 - m) = 0
// wipes when the first valid key arrives, as on the TPU.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;      // keys per tile
constexpr int kMaxAcc = 32;    // accumulators per thread: g * dh <= 8192
constexpr float kMaskInit = -1e30f;

// 16-byte vectors of the storage type, widened to f32.
template <typename E>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void widen(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 is the high half of an f32; element 0 is the low half of a word.
  __device__ static void widen(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      f[2 * t] = __uint_as_float(w[t] << 16);
      f[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
    }
  }
};

__device__ __forceinline__ float store_cast(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 store_cast(float v,
                                                     __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One (batch, kv head) per block. Shared memory, all f32: the K tile with
// rows padded to dh + 1 (the score loop reads one row per thread), the V
// tile, the g query rows, the g x 64 scores / probabilities, the tile's
// bias, and m, l and the correction of each query row.
template <typename E>
__global__ void __launch_bounds__(kThreads) swa_decode_kernel(
    const E* __restrict__ q, const E* __restrict__ kw,
    const E* __restrict__ vw, const float* __restrict__ bias,
    E* __restrict__ out, int64_t W, int kvh, int g, int dh, float scale,
    bool vec) {
  extern __shared__ float smem[];
  const int ks = dh + 1;
  float* k_s = smem;
  float* v_s = k_s + kTile * ks;
  float* q_s = v_s + kTile * dh;
  float* p_s = q_s + g * dh;
  float* b_s = p_s + g * kTile;
  float* m_s = b_s + kTile;
  float* l_s = m_s + g;
  float* c_s = l_s + g;

  const int64_t b = blockIdx.x / kvh;
  const int hh = blockIdx.x % kvh;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gd = g * dh;
  const int64_t key_stride = (int64_t)kvh * dh;   // between window slots
  const E* kb = kw + (b * W * kvh + hh) * dh;
  const E* vb = vw + (b * W * kvh + hh) * dh;
  const float* bb = bias + b * W;
  const int64_t qo = (b * kvh + hh) * (int64_t)gd;   // rows hh*g .. hh*g+g-1

  for (int i = tid; i < gd; i += kThreads) q_s[i] = load_f(q + qo + i);
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kMaskInit;
    l_s[i] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int e = 0; e < kMaxAcc; ++e) acc[e] = 0.f;

  constexpr int N = Pack<E>::N;
  for (int64_t w0 = 0; w0 < W; w0 += kTile) {
    const int64_t rest = W - w0;
    const int n = rest < kTile ? (int)rest : kTile;
    __syncthreads();   // the last tile's readers are done with it
    if (vec) {
      const int per_row = dh / N;
#pragma unroll 4
      for (int i = tid; i < n * per_row; i += kThreads) {
        const int j = i / per_row, c = (i - j * per_row) * N;
        const int64_t off = (w0 + j) * key_stride + c;
        const uint4 ku = *reinterpret_cast<const uint4*>(kb + off);
        const uint4 vu = *reinterpret_cast<const uint4*>(vb + off);
        float kf[N], vf[N];
        Pack<E>::widen(ku, kf);
        Pack<E>::widen(vu, vf);
#pragma unroll
        for (int t = 0; t < N; ++t) {
          k_s[j * ks + c + t] = kf[t];
          v_s[j * dh + c + t] = vf[t];
        }
      }
    } else {
      for (int i = tid; i < n * dh; i += kThreads) {
        const int j = i / dh, d = i - j * dh;
        const int64_t off = (w0 + j) * key_stride + d;
        k_s[j * ks + d] = load_f(kb + off);
        v_s[j * dh + d] = load_f(vb + off);
      }
    }
    for (int j = tid; j < n; j += kThreads) b_s[j] = bb[w0 + j];
    __syncthreads();

    // Scores of the g rows against the tile's n keys.
    for (int i = tid; i < g * n; i += kThreads) {
      const int gi = i / n, j = i - gi * n;
      const float* qr = q_s + gi * dh;
      const float* kr = k_s + j * ks;
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      int d = 0;
      for (; d + 4 <= dh; d += 4) {
        s0 = fmaf(qr[d], kr[d], s0);
        s1 = fmaf(qr[d + 1], kr[d + 1], s1);
        s2 = fmaf(qr[d + 2], kr[d + 2], s2);
        s3 = fmaf(qr[d + 3], kr[d + 3], s3);
      }
      for (; d < dh; ++d) s0 = fmaf(qr[d], kr[d], s0);
      p_s[gi * kTile + j] = ((s0 + s1) + (s2 + s3)) * scale + b_s[j];
    }
    __syncthreads();

    // Online softmax, one warp per query row.
    for (int gi = warp; gi < g; gi += kThreads / 32) {
      float* pr = p_s + gi * kTile;
      float mx = -inf_f();
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, pr[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[gi];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(pr[j] - m_new);
        pr[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[gi] = corr;
        l_s[gi] = l_s[gi] * corr + sum;
        m_s[gi] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p V over the tile.
#pragma unroll
    for (int e = 0; e < kMaxAcc; ++e) {
      const int i = tid + e * kThreads;
      if (i < gd) {
        const int gi = i / dh, d = i - gi * dh;
        const float* pr = p_s + gi * kTile;
        float a = acc[e] * c_s[gi];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], v_s[j * dh + d], a);
        acc[e] = a;
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kMaxAcc; ++e) {
    const int i = tid + e * kThreads;
    if (i < gd) {
      const float v = acc[e] / fmaxf(l_s[i / dh], 1e-30f);
      out[qo + i] = store_cast(v, out);
    }
  }
}

template <typename E>
cudaError_t launch(const void* q, const void* kw, const void* vw,
                   const void* bias, void* out, int64_t b, int64_t h,
                   int64_t W, int64_t kvh, int64_t dh, float scale,
                   cudaStream_t stream) {
  if (b < 1 || kvh < 1 || W < 1 || dh < 1 || h % kvh) {
    return cudaErrorInvalidValue;
  }
  const int64_t g = h / kvh;
  if (g * dh > (int64_t)kMaxAcc * kThreads || dh > 256 ||
      b * kvh > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  const size_t smem =
      sizeof(float) * (kTile * (dh + 1) + kTile * dh + g * dh + g * kTile +
                       kTile + 3 * g);
  auto kernel = swa_decode_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  constexpr int N = Pack<E>::N;
  const bool vec = dh % N == 0 &&
                   reinterpret_cast<uintptr_t>(kw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vw) % 16 == 0;
  kernel<<<(unsigned)(b * kvh), kThreads, smem, stream>>>(
      static_cast<const E*>(q), static_cast<const E*>(kw),
      static_cast<const E*>(vw), static_cast<const float*>(bias),
      static_cast<E*>(out), W, (int)kvh, (int)g, (int)dh, scale, vec);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). q / out: (b, h, dh); kw / vw:
// (b, W, kvh, dh), all of one dtype; bias: (b, W) f32. Returns the
// cudaError_t of the launch.
extern "C" int swa_decode_f32(const void* q, const void* kw, const void* vw,
                              const void* bias, void* out, int64_t b,
                              int64_t h, int64_t W, int64_t kvh, int64_t dh,
                              float scale, void* stream) {
  return (int)repro_torch::launch<float>(q, kw, vw, bias, out, b, h, W, kvh,
                                         dh, scale,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int swa_decode_bf16(const void* q, const void* kw, const void* vw,
                               const void* bias, void* out, int64_t b,
                               int64_t h, int64_t W, int64_t kvh, int64_t dh,
                               float scale, void* stream) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      q, kw, vw, bias, out, b, h, W, kvh, dh, scale,
      static_cast<cudaStream_t>(stream));
}
