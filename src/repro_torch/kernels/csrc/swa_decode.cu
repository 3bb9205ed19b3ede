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
// 0) may lie anywhere, and the kernel assumes no order among them. A row
// with no valid slot averages V over all W keys, as the plain version does.
//
// What bounds it on an H100: bytes. Every key and value of the window is
// read once (2 * b * W * kvh * dh elements) for 4 flops per pair of
// elements, far below the card's ~295 flops per byte in bf16. At the
// Mixtral decode shape (4 sequences, 8 kv heads, W = 4096, dh = 128, bf16)
// that is 67 MB, 0.020 ms at 3.35 TB/s.
//
// Design: a split-window decode in two kernels, with no float atomics, so
// the result is the same bit for bit from call to call.
//
// 1. swa_split_kernel. The TPU kernel walked the window on a sequential grid
//    axis and carried the softmax state in scratch. Here the window of each
//    (batch, kv head) is cut into S chunks of at least 64 keys (the launcher
//    picks S, at most 32, from b * kvh, W and the SM count so that the grid
//    fills the card about twice over), and one block of 4 warps owns one
//    (batch, kv head, group of up to 8 query rows, chunk). The last chunk ends
//    at W inside the kernel: no padding, no copy. Each key row is taken by L
//    lanes (L = the row's 16-byte pieces rounded up to a power of two, at most
//    32): at dh = 128 bf16 a row is 256 bytes, 16 lanes of 8 bf16, so a warp
//    takes two keys per step. Keys and values go as 16-byte vectors straight
//    from device memory into registers and are widened to f32 there: no
//    shared-memory tile and no block barrier in the key loop. The loop is
//    unrolled by U key steps whose loads are all issued before the first of
//    them is used, so each warp keeps U steps of keys and values (4 KB at the
//    Mixtral shape) in flight, and the many resident warps cover the memory
//    latency. The query rows, each key group's running max m, denominator l
//    and its lanes' slice of the (rows, dh) accumulator stay in registers; a
//    score is reduced over its L lanes with warp shuffles. The order of
//    operations is the TPU kernel's, a tile being the U keys a lane group
//    takes in one loop trip: m starts at -1e30, p = exp(s - m_new), l = l *
//    corr + sum(p), acc = acc * corr + p V. A slot past the chunk's end scores
//    -inf and adds nothing. At the end the key groups of a warp merge by
//    shuffles and the warps once through shared memory, and the block writes
//    its chunk's partial state (m, l, acc) in f32 to a scratch buffer the
//    wrapper allocates, or, when S = 1, the output itself. The partial
//    entry point (swa_decode_partial_*) stops here and hands the chunk
//    states back, S = 1 included: a rank of a context-parallel cache
//    computes the state of its block of the keys.
// 2. swa_combine_kernel, one block per query row, its S chunk states read
//    into shared memory with every load in flight at once: M = max_s m_s,
//    w_s = exp(m_s - M), out = sum_s w_s acc_s / max(sum_s w_s l_s, 1e-30),
//    summed in chunk order. A chunk of masked keys only has m_s = -1e30 and
//    weight 0 as soon as another chunk holds a key; if none does, every
//    weight is 1 and the result is the average over the W keys. Its own
//    entry point (swa_combine_*) merges the chunk states that the ranks of
//    a context-parallel cache gathered, rank after rank: rank r's chunk j
//    of S_r over W_r keys spans the keys that chunk r S_r + j of one launch
//    with S = R S_r over the R W_r keys spans, so the merge gives that
//    launch's bits. The combine stages S states in shared memory, so S is
//    at most kMaxSplits over all ranks: the wrapper caps each rank's S at
//    kMaxSplits / R.
//
// A head width that is not a multiple of the 16-byte vector (8 bf16, 4
// f32), or a key or value pointer that is not 16-byte aligned, takes the
// same kernel with scalar loads.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 128;        // split kernel: 4 warps a block
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 128;
constexpr int kMaxRows = 8;          // query rows a split block holds
constexpr int64_t kMinChunk = 64;    // keys a chunk holds, at least
constexpr int64_t kMaxSplits = 32;   // the combine stages 33 KB at most
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

// One piece of a row: N elements read at once (a 16-byte vector), or one
// element (N = 1, the scalar path). Raw is what sits in registers between
// the load and its use.
template <typename E, int N>
struct Piece {
  static_assert(N == Pack<E>::N, "a vector piece is 16 bytes");
  using Raw = uint4;
  __device__ static Raw load(const E* p) {
    return *reinterpret_cast<const uint4*>(p);
  }
  __device__ static Raw zero() { return make_uint4(0u, 0u, 0u, 0u); }
  __device__ static void widen(const Raw& r, float* f) { Pack<E>::widen(r, f); }
};
template <typename E>
struct Piece<E, 1> {
  using Raw = float;
  __device__ static Raw load(const E* p) { return load_f(p); }
  __device__ static Raw zero() { return 0.f; }
  __device__ static void widen(const Raw& r, float* f) { f[0] = r; }
};

__device__ __forceinline__ float store_cast(float v, float*) { return v; }
__device__ __forceinline__ __nv_bfloat16 store_cast(float v,
                                                     __nv_bfloat16*) {
  return __float2bfloat16_rn(v);
}

// Two softmax states (m, l, acc) merged as a * w_a + b * w_b with
// w = exp(m - max(m_a, m_b)). Products and sum rounded one by one (no FMA
// contraction), so the merge is symmetric in its operands.
__device__ __forceinline__ float merge2(float a, float wa, float b, float wb) {
  return __fadd_rn(__fmul_rn(a, wa), __fmul_rn(b, wb));
}

// One block per (batch, kv head, group of GR query rows, chunk). VPL pieces
// of N elements of each row per lane; U key steps per loop trip.
// Shared memory: kWarps x GR x (dh + 2) f32, each warp's merged state.
template <typename E, int N, int VPL, int GR, int U>
__global__ void __launch_bounds__(kThreads) swa_split_kernel(
    const E* __restrict__ q, const E* __restrict__ kw,
    const E* __restrict__ vw, const float* __restrict__ bias,
    float* __restrict__ part, E* __restrict__ out, int64_t W, int kvh,
    int g, int dh, int L, int S, int RC, float scale) {
  using P = Piece<E, N>;
  constexpr int NE = VPL * N;   // elements of a row a lane holds
  extern __shared__ float smem[];

  int64_t id = blockIdx.x;
  const int s = (int)(id % S);
  id /= S;
  const int rc = (int)(id % RC);
  const int64_t pair = id / RC;   // b * kvh + hh
  const int64_t b = pair / kvh;
  const int hh = (int)(pair % kvh);
  const int row0 = rc * GR;
  const int nrows = min(GR, g - row0);
  const int64_t lo = s * W / S, hi = (s + 1) * W / S;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = lane & (L - 1);   // lane within its key's group
  const int sub = lane / L;       // key group within the warp
  const int kpw = 32 / L;         // keys a warp takes per step
  const int step = kWarps * kpw;  // keys the block takes per step
  const int VR = dh / N;          // pieces per row
  const int64_t key_stride = (int64_t)kvh * dh;   // between window slots
  const E* kb = kw + (b * W * kvh + hh) * dh;
  const E* vb = vw + (b * W * kvh + hh) * dh;
  const float* bb = bias + b * W;
  const int64_t qrow0 = (b * kvh + hh) * g + row0;   // query row b * h + i

  float qf[GR][NE], acc[GR][NE], m[GR], l[GR];
#pragma unroll
  for (int r = 0; r < GR; ++r) {
    m[r] = kMaskInit;
    l[r] = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v) {
      const int vi = v * L + t;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        acc[r][v * N + e] = 0.f;
        qf[r][v * N + e] = (r < nrows && vi < VR)
                               ? load_f(q + (qrow0 + r) * dh + vi * N + e)
                               : 0.f;
      }
    }
  }

  for (int64_t base = lo + warp * kpw; base < hi;
       base += (int64_t)U * step) {
    // Every load of the U steps first; nothing below waits on them before
    // the last one is issued.
    typename P::Raw kr[U][VPL], vr[U][VPL];
    float bj[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int64_t j = base + (int64_t)u * step + sub;
      const bool ok = j < hi;
      const int64_t off = j * key_stride;
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = v * L + t;
        const bool take = ok && vi < VR;
        kr[u][v] = take ? P::load(kb + off + vi * N) : P::zero();
        vr[u][v] = take ? P::load(vb + off + vi * N) : P::zero();
      }
      bj[u] = ok ? bb[j] : -inf_f();
    }

    // Scores: each lane's part of the dot product, summed over its L lanes.
    float sc[U][GR];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[NE];
#pragma unroll
      for (int v = 0; v < VPL; ++v) P::widen(kr[u][v], kf + v * N);
#pragma unroll
      for (int r = 0; r < GR; ++r) {
        float a = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) a = fmaf(qf[r][e], kf[e], a);
        sc[u][r] = a;
      }
    }
    for (int o = L >> 1; o > 0; o >>= 1) {
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int r = 0; r < GR; ++r)
          sc[u][r] += __shfl_xor_sync(0xffffffffu, sc[u][r], o);
    }

    // Online softmax over the U keys of this step (a slot past the chunk
    // scores -inf: p = 0, and m_new never moves to it).
    float p[U][GR], corr[GR];
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      float mx = -inf_f();
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sc[u][r] = sc[u][r] * scale + bj[u];
        mx = fmaxf(mx, sc[u][r]);
      }
      const float m_new = fmaxf(m[r], mx);
      corr[r] = __expf(m[r] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        p[u][r] = __expf(sc[u][r] - m_new);
        psum += p[u][r];
      }
      l[r] = l[r] * corr[r] + psum;
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[r][e] *= corr[r];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[NE];
#pragma unroll
      for (int v = 0; v < VPL; ++v) P::widen(vr[u][v], vf + v * N);
#pragma unroll
      for (int r = 0; r < GR; ++r)
#pragma unroll
        for (int e = 0; e < NE; ++e)
          acc[r][e] = fmaf(p[u][r], vf[e], acc[r][e]);
    }
  }

  // The key groups of a warp, merged by a butterfly over lanes L, 2L, ...
  for (int o = L; o < 32; o <<= 1) {
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[r], o);
      const float lother = __shfl_xor_sync(0xffffffffu, l[r], o);
      const float M = fmaxf(m[r], mo);
      const float ws = __expf(m[r] - M), wo = __expf(mo - M);
      l[r] = merge2(l[r], ws, lother, wo);
      m[r] = M;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[r][e], o);
        acc[r][e] = merge2(acc[r][e], ws, ao, wo);
      }
    }
  }

  // The warps, merged once through shared memory in warp order.
  const int ps = dh + 2;   // a state: m, l, acc[dh]
  if (lane < L) {
    float* mine = smem + warp * GR * ps;
#pragma unroll
    for (int r = 0; r < GR; ++r) {
      if (r >= nrows) break;
      if (t == 0) {
        mine[r * ps] = m[r];
        mine[r * ps + 1] = l[r];
      }
#pragma unroll
      for (int v = 0; v < VPL; ++v) {
        const int vi = v * L + t;
        if (vi < VR) {
#pragma unroll
          for (int e = 0; e < N; ++e)
            mine[r * ps + 2 + vi * N + e] = acc[r][v * N + e];
        }
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nrows * dh; i += kThreads) {
    const int r = i / dh, d = i - r * dh;
    float M = -inf_f();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, smem[(w * GR + r) * ps]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float* st = smem + (w * GR + r) * ps;
      const float ww = __expf(st[0] - M);
      lsum = __fadd_rn(lsum, __fmul_rn(st[1], ww));
      a = __fadd_rn(a, __fmul_rn(st[2 + d], ww));
    }
    const int64_t row = qrow0 + r;
    if (S == 1 && out != nullptr) {
      out[row * dh + d] = store_cast(a / fmaxf(lsum, 1e-30f), out);
    } else {
      float* pr = part + (row * S + s) * ps;
      if (d == 0) {
        pr[0] = M;
        pr[1] = lsum;
      }
      pr[2 + d] = a;
    }
  }
}

// One block per query row: the row's S chunk states staged in shared
// memory (all loads at once), then merged in chunk order.
template <typename E>
__global__ void __launch_bounds__(kCombineThreads) swa_combine_kernel(
    const float* __restrict__ part, E* __restrict__ out, int dh, int S) {
  extern __shared__ float st[];   // S x (m, l, acc[dh])
  const int64_t row = blockIdx.x;
  const int ps = dh + 2;
  const float* pr = part + row * S * ps;
  for (int i = threadIdx.x; i < S * ps; i += kCombineThreads) st[i] = pr[i];
  __syncthreads();
  float M = -inf_f();
  for (int s = 0; s < S; ++s) M = fmaxf(M, st[s * ps]);
  for (int d = threadIdx.x; d < dh; d += kCombineThreads) {
    float lsum = 0.f, a = 0.f;
    for (int s = 0; s < S; ++s) {
      const float w = __expf(st[s * ps] - M);
      lsum = __fadd_rn(lsum, __fmul_rn(st[s * ps + 1], w));
      a = __fadd_rn(a, __fmul_rn(st[s * ps + 2 + d], w));
    }
    out[row * dh + d] = store_cast(a / fmaxf(lsum, 1e-30f), out);
  }
}

int64_t pow2_ceil(int64_t v) {
  int64_t p = 1;
  while (p < v) p <<= 1;
  return p;
}

// The number of chunks: enough blocks to fill the card about twice over,
// a power of two, and no chunk shorter than kMinChunk keys.
int64_t plan_splits(int64_t b, int64_t h, int64_t W, int64_t kvh,
                    int64_t sms) {
  const int64_t g = h / kvh;
  const int64_t units = b * kvh * ((g + kMaxRows - 1) / kMaxRows);
  const int64_t want = pow2_ceil((2 * sms + units - 1) / units);
  int64_t most = W / kMinChunk;
  if (most > kMaxSplits) most = kMaxSplits;
  if (most < 1) most = 1;
  return want < most ? want : most;
}

// The combine of `rows` query rows' S chunk states each (part: rows x S x
// (dh + 2) f32) into out (rows x dh).
template <typename E>
cudaError_t combine(const void* part, void* out, int64_t rows, int64_t dh,
                    int64_t S, cudaStream_t stream) {
  if (rows < 1 || dh < 1 || dh > 256 || S < 1 || S > kMaxSplits ||
      rows > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  swa_combine_kernel<E><<<(unsigned)rows, kCombineThreads,
                          sizeof(float) * S * (dh + 2), stream>>>(
      static_cast<const float*>(part), static_cast<E*>(out), (int)dh,
      (int)S);
  return cudaGetLastError();
}

struct Args {
  const void *q, *kw, *vw, *bias;
  void *part, *out;
  int64_t b, h, W, kvh, g, dh, S;
  int L;
  float scale;
  cudaStream_t stream;
};

template <typename E, int N, int VPL, int GR>
cudaError_t run(const Args& a) {
  constexpr int U = GR >= 8 ? 2 : 4;   // key steps in flight per warp
  const int64_t RC = (a.g + GR - 1) / GR;
  const int64_t blocks = a.b * a.kvh * RC * a.S;
  if (blocks > 0x7fffffff || a.b * a.h > 0x7fffffff) {
    return cudaErrorInvalidValue;
  }
  // At most 4 x 8 x 258 f32 (33 KB): under the default 48 KB.
  const size_t smem = sizeof(float) * kWarps * GR * (a.dh + 2);
  swa_split_kernel<E, N, VPL, GR, U><<<(unsigned)blocks, kThreads, smem,
                                       a.stream>>>(
      static_cast<const E*>(a.q), static_cast<const E*>(a.kw),
      static_cast<const E*>(a.vw), static_cast<const float*>(a.bias),
      static_cast<float*>(a.part), static_cast<E*>(a.out), a.W, (int)a.kvh,
      (int)a.g, (int)a.dh, a.L, (int)a.S, (int)RC, a.scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1 || a.out == nullptr) return err;
  return combine<E>(a.part, a.out, a.b * a.h, a.dh, a.S, a.stream);
}

template <typename E, int N, int VPL>
cudaError_t by_rows(int64_t gr, const Args& a) {
  switch (gr) {
    case 1: return run<E, N, VPL, 1>(a);
    case 2: return run<E, N, VPL, 2>(a);
    case 4: return run<E, N, VPL, 4>(a);
    default: return run<E, N, VPL, kMaxRows>(a);
  }
}

template <typename E>
cudaError_t launch(Args a) {
  if (a.b < 1 || a.kvh < 1 || a.W < 1 || a.dh < 1 || a.h % a.kvh) {
    return cudaErrorInvalidValue;
  }
  a.g = a.h / a.kvh;
  if (a.g * a.dh > 8192 || a.dh > 256 || a.S < 1 || a.S > kMaxSplits ||
      a.S > a.W || ((a.S > 1 || a.out == nullptr) && a.part == nullptr)) {
    return cudaErrorInvalidValue;
  }
  constexpr int N = Pack<E>::N;
  const bool vec = a.dh % N == 0 &&
                   reinterpret_cast<uintptr_t>(a.kw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(a.vw) % 16 == 0;
  const int64_t VR = vec ? a.dh / N : a.dh;   // pieces per row
  a.L = (int)(VR < 32 ? pow2_ceil(VR) : 32);
  const int64_t vpl = (VR + a.L - 1) / a.L;
  if (!vec) return run<E, 1, 8, kMaxRows>(a);   // dh <= 256: vpl <= 8
  const int64_t gr = a.g < kMaxRows ? pow2_ceil(a.g) : kMaxRows;
  if (vpl == 1) return by_rows<E, N, 1>(gr, a);
  if constexpr (N == 4) return by_rows<E, N, 2>(gr, a);   // f32, dh > 128
  return cudaErrorInvalidValue;
}

cudaError_t call(const void* q, const void* kw, const void* vw,
                 const void* bias, void* part, void* out, int64_t b,
                 int64_t h, int64_t W, int64_t kvh, int64_t dh, int64_t S,
                 float scale, void* stream, bool bf16) {
  Args a{q, kw, vw, bias, part, out, b, h, W, kvh, 0, dh, S, 0, scale,
         static_cast<cudaStream_t>(stream)};
  return bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes).
//
// swa_decode_splits: the number of chunks S the launch of this shape takes
// on CUDA device `device`, or minus a cudaError_t.
extern "C" int64_t swa_decode_splits(int64_t b, int64_t h, int64_t W,
                                     int64_t kvh, int device) {
  if (b < 1 || kvh < 1 || W < 1 || h % kvh) {
    return -(int64_t)cudaErrorInvalidValue;
  }
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int64_t)err;
  return repro_torch::plan_splits(b, h, W, kvh, sms);
}

// swa_decode_f32 / _bf16: q / out (b, h, dh); kw / vw (b, W, kvh, dh), all
// of one dtype; bias (b, W) f32; part: b * h * S * (dh + 2) f32 of scratch
// (unused when S = 1). Launches the split kernel and, for S > 1, the
// combine kernel on `stream`; returns the first cudaError_t.
extern "C" int swa_decode_f32(const void* q, const void* kw, const void* vw,
                              const void* bias, void* part, void* out,
                              int64_t b, int64_t h, int64_t W, int64_t kvh,
                              int64_t dh, int64_t S, float scale,
                              void* stream) {
  return (int)repro_torch::call(q, kw, vw, bias, part, out, b, h, W, kvh,
                                dh, S, scale, stream, false);
}

extern "C" int swa_decode_bf16(const void* q, const void* kw, const void* vw,
                               const void* bias, void* part, void* out,
                               int64_t b, int64_t h, int64_t W, int64_t kvh,
                               int64_t dh, int64_t S, float scale,
                               void* stream) {
  return (int)repro_torch::call(q, kw, vw, bias, part, out, b, h, W, kvh,
                                dh, S, scale, stream, true);
}

// swa_decode_partial_f32 / _bf16: the split kernel alone, for S >= 1 chunks:
// each query row's S chunk states (m, l, acc[dh]) in f32 written to part
// (b * h x S x (dh + 2)); no output. Returns the cudaError_t.
extern "C" int swa_decode_partial_f32(const void* q, const void* kw,
                                      const void* vw, const void* bias,
                                      void* part, int64_t b, int64_t h,
                                      int64_t W, int64_t kvh, int64_t dh,
                                      int64_t S, float scale, void* stream) {
  return (int)repro_torch::call(q, kw, vw, bias, part, nullptr, b, h, W, kvh,
                                dh, S, scale, stream, false);
}

extern "C" int swa_decode_partial_bf16(const void* q, const void* kw,
                                       const void* vw, const void* bias,
                                       void* part, int64_t b, int64_t h,
                                       int64_t W, int64_t kvh, int64_t dh,
                                       int64_t S, float scale, void* stream) {
  return (int)repro_torch::call(q, kw, vw, bias, part, nullptr, b, h, W, kvh,
                                dh, S, scale, stream, true);
}

// swa_combine_f32 / _bf16: rows x S chunk states (part, f32, as the partial
// entry point writes them, or several ranks' side by side) merged in chunk
// order into out (rows x dh, f32 or bf16); S <= 32. Returns the cudaError_t.
extern "C" int swa_combine_f32(const void* part, void* out, int64_t rows,
                               int64_t dh, int64_t S, void* stream) {
  return (int)repro_torch::combine<float>(
      part, out, rows, dh, S, static_cast<cudaStream_t>(stream));
}

extern "C" int swa_combine_bf16(const void* part, void* out, int64_t rows,
                                int64_t dh, int64_t S, void* stream) {
  return (int)repro_torch::combine<__nv_bfloat16>(
      part, out, rows, dh, S, static_cast<cudaStream_t>(stream));
}
