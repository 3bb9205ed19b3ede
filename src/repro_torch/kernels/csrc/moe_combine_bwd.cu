// The backward of the weighted re-assembly (moe_combine) of a
// mixture-of-experts layer: the gradient of its slot rows and of its
// gates, for training.
//
// Replaces: no Pallas kernel. The Pallas kernels have no backward, and
// the JAX package trains through repro/kernels/ref.py's moe_combine
// (ref.py:142), which XLA differentiates into a scatter-add. This
// kernel computes that gradient in gather form, so that a training step
// on the card launches no library scatter where the forward launches a
// kernel.
//
// Computes, for dout (T, d) f32 (the gradient of the combine's output),
// ybuf (S, d), src_entry (S,) int32 (the (token, choice) entry e that
// owns each slot), valid (S,) bool and w (T*top_k,) f32 (the gates the
// forward took), for every slot s:
//   valid[s]:  e = src_entry[s], t = e / top_k,
//              dybuf[s, :] = round(w[e] * dout[t, :]) in ybuf's type,
//              dgates[e]   = sum_c dout[t, c] * ybuf[s, c] in f32;
//   otherwise: dybuf[s, :] = 0.
// An entry that owns no slot (dropped by the capacity) is not written:
// the wrapper zeroes dgates first. A dropped entry names a slot that a
// kept entry owns (its position is clipped to C-1), so reading through
// the slot -> entry map, and never scattering, gives every output one
// writer and needs no atomics.
//
// What bounds it on an H100: three flops an element of a valid slot, so
// the bytes: for each valid slot its token's dout row (f32) and its
// ybuf row read, and every slot's dybuf row written (at Mixtral's
// training microbatch of 4096 tokens, 10240 slots of 4096 columns:
// 168 MB of dout rows, 84 MB of ybuf read, 84 MB written).
//
// Design (a first, simple one): one block a slot. A thread owns 16-byte
// pieces of the slot's ybuf row (8 bf16 or 4 f32 columns: the vector
// path, where d is a multiple of the piece and every base is 16-byte
// aligned), or single columns (the scalar path), and walks its pieces
// in order. It reads the dout piece (two or one float4) and the ybuf
// piece, stores the product row, and keeps its share of the dot in a
// register (fused multiply-adds, columns in order). The block then sums
// the shares in a fixed order: a butterfly in each warp, the warps'
// sums through shared memory, and a butterfly over those in warp 0. The
// block's shape depends on (d, type) only, so two calls give the same
// bits. An invalid slot writes zeros and reads nothing. Offsets are
// 64-bit.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 512;

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Columns of a thread's piece, and threads of a block.
struct Plan {
  int V;
  long long pieces;
  int threads;
};

bool make_plan(long long S, long long d, int esize, bool vec, Plan* p) {
  if (S < 1 || d < 1 || S > 0x7fffffff) return false;
  p->V = vec ? 16 / esize : 1;
  if (d % p->V) return false;
  p->pieces = d / p->V;
  p->threads = static_cast<int>(
      cdiv(p->pieces < kMaxThreads ? p->pieces : kMaxThreads, 32) * 32);
  return true;
}

// Row access of one piece: one column (the scalar path) or 16 bytes of
// ybuf and dybuf with the matching f32 columns of dout (the vector path).
template <typename E, bool kVec>
struct Piece {
  static constexpr int V = 1;
  __device__ static void load(const E* y, const float* g, float* yv,
                              float* gv) {
    yv[0] = load_f(y);
    gv[0] = *g;
  }
  __device__ static void store(E* o, const float* v) {
    if constexpr (sizeof(E) == 4)
      *o = v[0];
    else
      *o = __float2bfloat16_rn(v[0]);
  }
};

template <typename E>
struct Piece<E, true> {
  static constexpr int V = 16 / sizeof(E);
  __device__ static void load(const E* y, const float* g, float* yv,
                              float* gv) {
    const uint4 raw = __ldg(reinterpret_cast<const uint4*>(y));
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int c = 0; c < V; ++c) {
      if constexpr (sizeof(E) == 4) {
        yv[c] = __uint_as_float(w[c]);
      } else {
        const uint32_t u = w[c >> 1];
        yv[c] = __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
      }
    }
#pragma unroll
    for (int c = 0; c < V; c += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(g + c));
      gv[c] = f.x;
      gv[c + 1] = f.y;
      gv[c + 2] = f.z;
      gv[c + 3] = f.w;
    }
  }
  __device__ static void store(E* o, const float* v) {
    uint32_t w[4];
    if constexpr (sizeof(E) == 4) {
#pragma unroll
      for (int c = 0; c < 4; ++c) w[c] = __float_as_uint(v[c]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const uint32_t lo =
            __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * c]));
        const uint32_t hi =
            __bfloat16_as_ushort(__float2bfloat16_rn(v[2 * c + 1]));
        w[c] = lo | (hi << 16);
      }
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <typename E, bool kVec>
__global__ void __launch_bounds__(kMaxThreads) moe_combine_bwd_kernel(
    const float* __restrict__ dout, const E* __restrict__ ybuf,
    const int32_t* __restrict__ src_entry, const uint8_t* __restrict__ valid,
    const float* __restrict__ w, E* __restrict__ dybuf,
    float* __restrict__ dgates, int64_t T, int64_t d, int top_k,
    int64_t pieces) {
  using P = Piece<E, kVec>;
  __shared__ float warp_sums[kMaxThreads / 32];
  const int64_t s = blockIdx.x;
  E* orow = dybuf + s * d;
  if (!valid[s]) {
    const float zero[P::V] = {};
    for (int64_t p = threadIdx.x; p < pieces; p += blockDim.x)
      P::store(orow + p * P::V, zero);
    return;
  }
  const int64_t e = src_entry[s];
  const int64_t t = e / top_k;
  const float we = w[e];
  const E* yrow = ybuf + s * d;
  const float* grow = dout + t * d;
  float dot = 0.f;
  for (int64_t p = threadIdx.x; p < pieces; p += blockDim.x) {
    float yv[P::V], gv[P::V], ov[P::V];
    P::load(yrow + p * P::V, grow + p * P::V, yv, gv);
#pragma unroll
    for (int c = 0; c < P::V; ++c) {
      ov[c] = __fmul_rn(we, gv[c]);
      dot = __fmaf_rn(gv[c], yv[c], dot);
    }
    P::store(orow + p * P::V, ov);
  }
  // The block's sum in a fixed order: each warp's butterfly, then the
  // warps' sums in warp 0.
  dot = warp_sum(dot);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  if (lane == 0) warp_sums[warp] = dot;
  __syncthreads();
  if (warp == 0) {
    float v = lane < warps ? warp_sums[lane] : 0.f;
    v = warp_sum(v);
    if (lane == 0) dgates[e] = v;
  }
}

template <typename E>
cudaError_t launch(const void* dout, const void* ybuf, const void* src_entry,
                   const void* valid, const void* w, void* dybuf,
                   void* dgates, int64_t S, int64_t T, int64_t d,
                   int64_t top_k, int vec, cudaStream_t cs) {
  Plan p;
  if (top_k < 1 || top_k > 0x7fffffff ||
      !make_plan(S, d, sizeof(E), vec != 0, &p))
    return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(S));
  if (vec)
    moe_combine_bwd_kernel<E, true><<<grid, p.threads, 0, cs>>>(
        static_cast<const float*>(dout), static_cast<const E*>(ybuf),
        static_cast<const int32_t*>(src_entry),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(w),
        static_cast<E*>(dybuf), static_cast<float*>(dgates), T, d,
        static_cast<int>(top_k), p.pieces);
  else
    moe_combine_bwd_kernel<E, false><<<grid, p.threads, 0, cs>>>(
        static_cast<const float*>(dout), static_cast<const E*>(ybuf),
        static_cast<const int32_t*>(src_entry),
        static_cast<const uint8_t*>(valid), static_cast<const float*>(w),
        static_cast<E*>(dybuf), static_cast<float*>(dgates), T, d,
        static_cast<int>(top_k), p.pieces);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). dout: (T, d) f32; ybuf, dybuf:
// (S, d) of the kernel's type; src_entry: (S,) int32, in [0, T*top_k)
// where valid; valid: (S,) bool (one byte each); w, dgates:
// (T*top_k,) f32, dgates zeroed by the caller. vec: 1 where d is a
// multiple of a 16-byte piece of ybuf and dout, ybuf and dybuf are
// 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int moe_combine_bwd_f32(const void* dout, const void* ybuf,
                                   const void* src_entry, const void* valid,
                                   const void* w, void* dybuf, void* dgates,
                                   int64_t S, int64_t T, int64_t d,
                                   int64_t top_k, int vec, void* cs) {
  return (int)repro_torch::launch<float>(dout, ybuf, src_entry, valid, w,
                                         dybuf, dgates, S, T, d, top_k, vec,
                                         static_cast<cudaStream_t>(cs));
}

extern "C" int moe_combine_bwd_bf16(const void* dout, const void* ybuf,
                                    const void* src_entry, const void* valid,
                                    const void* w, void* dybuf, void* dgates,
                                    int64_t S, int64_t T, int64_t d,
                                    int64_t top_k, int vec, void* cs) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      dout, ybuf, src_entry, valid, w, dybuf, dgates, S, T, d, top_k, vec,
      static_cast<cudaStream_t>(cs));
}
