// The gradient of the MoE layer's dispatch (the queue-order row gather)
// with respect to x: each token's kept slot rows, summed.
//
// Replaces: no Pallas kernel. The JAX package differentiates
// repro/kernels/ref.py `moe_dispatch` (where(valid, x[clip(src)], 0)),
// whose gradient is a scatter-add of where(valid, dbuf, 0) into x's rows.
//
// Computes, for dbuf (S, d), slot (T*top_k,) int32 and keep (T*top_k,)
// bool,
//   dx[t, :] = sum over kept j < top_k of dbuf[clip(slot[t*top_k + j]), :]
// summed in f32 from +0 with j in order, and rounded once to dbuf's type
// (x's: bf16 or f32) on the store.
//
// What bounds it on an H100: one add per element read, so the bytes: the
// kept rows of dbuf read once, dx written once, and 5 bytes of slot and
// keep an entry (at Mixtral's train routing, 67 MB read and 34 MB
// written).
//
// What it replaces in the port: the moe_combine kernel with the keep
// mask as 0/1 gates, then a cast. That route read every entry's row (a
// dropped entry's too, multiplied by 0), wrote an f32 (T, d) sum and read
// it back for the cast: about 2.3x the bytes, in three launches.
//
// Design (moe_combine.cu's launch, `make_plan` in moe_plan.cuh):
// - A thread owns one 16-byte piece of a row (8 bf16 or 4 f32 columns of
//   dbuf; d a multiple of the piece and dbuf's base 16-byte aligned), or
//   one column (the scalar path, any d and base). A block takes chunks of
//   one or more tokens' rows in whole warps.
// - Each warp holds one token: lane j loads its choice's slot (clipped)
//   and keep flag; the warp shares the rows by shuffles and the flags by
//   one ballot, so a dropped entry's row is skipped by the whole warp (no
//   divergence) and costs no read.
// - Every kept choice's load is issued before the first add: the loop
//   over j is unrolled for top_k in {1, 2, 4, 8}; other top_k go through
//   stages of 8 choices.
// - The sum stays in registers; each add is rounded on its own
//   (__fadd_rn, j in order; no multiply, so no FMA can form), and the
//   store rounds a bf16 dx with __float2bfloat16_rn (round to nearest
//   even, as Tensor.to rounds): 8 bf16 columns a 16-byte store. No f32
//   (T, d) tensor exists.
// A sum that starts at +0 is never -0, so skipping a dropped entry gives
// the bits of adding its +0: the plain version's where(keep, row, 0) bit
// for bit, on any input. A dropped entry's clamped slot belongs to
// another token, whose non-finite gradient thus never reaches this one,
// as in JAX's gradient. Offsets are 64-bit.

#include "moe_plan.cuh"

namespace repro_torch {
namespace {

// A piece as loaded: 16 raw bytes on the vector path, else the element
// widened to f32.
template <typename E, bool kVec>
struct Piece {
  static constexpr int V = 1;
  using Raw = float;
  __device__ static Raw load(const E* p) { return load_f(p); }
  __device__ static void add(float* acc, Raw raw) {
    acc[0] = __fadd_rn(acc[0], raw);
  }
};

template <typename E>
struct Piece<E, true> {
  static constexpr int V = Vec16<E>::V;
  using Raw = uint4;
  __device__ static Raw load(const E* p) { return Vec16<E>::load(p); }
  __device__ static void add(float* acc, const Raw& raw) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      acc[c] = __fadd_rn(acc[c], Vec16<E>::column(raw, c));
  }
};

// Two f32 values rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// A piece's V columns of f32 sums stored in dbuf's type E: one element
// (V = 1), or one 16-byte store (4 f32, or 8 bf16 in packed pairs).
template <typename E, int V>
__device__ __forceinline__ void store(E* o, const float* acc) {
  if constexpr (V == 1) {
    if constexpr (sizeof(E) == 4) *o = acc[0];
    else *o = __float2bfloat16_rn(acc[0]);
  } else if constexpr (sizeof(E) == 4) {
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    *reinterpret_cast<uint4*>(o) =
        make_uint4(pack_bf16(acc[0], acc[1]), pack_bf16(acc[2], acc[3]),
                   pack_bf16(acc[4], acc[5]), pack_bf16(acc[6], acc[7]));
  }
}

// E: the storage type of dbuf and dx (float or __nv_bfloat16); kVec:
// the vector path; K: top_k where it is 1, 2, 4 or 8, else 0 (stages of
// kStage choices, lanes past top_k not kept). Each warp holds one token:
// lane j loads its choice j, and the warp shares them.
template <typename E, bool kVec, int K>
__global__ void __launch_bounds__(kMaxThreads) moe_dispatch_bwd_kernel(
    const E* __restrict__ dbuf, const int32_t* __restrict__ slot,
    const uint8_t* __restrict__ keep, E* __restrict__ dx, int64_t S,
    int64_t T, int64_t d, int top_k, int64_t pieces, FastDiv chunks,
    FastDiv cw, int G) {
  using P = Piece<E, kVec>;
  constexpr int KS = K ? K : kStage;  // choices a stage
  const uint32_t group = chunks.div(blockIdx.x);
  const uint32_t g = cw.div(threadIdx.x);
  const int64_t t = static_cast<int64_t>(group) * G + g;
  const int64_t piece =
      static_cast<int64_t>(blockIdx.x - group * chunks.d) * cw.d +
      (threadIdx.x - g * cw.d);
  const bool active = t < T && piece < pieces;
  const int lane = threadIdx.x & 31;
  const E* col = dbuf + piece * P::V;
  float acc[P::V];
#pragma unroll
  for (int c = 0; c < P::V; ++c) acc[c] = 0.f;
  const int stages = K ? 1 : (top_k + kStage - 1) / kStage;
  for (int s = 0; s < stages; ++s) {
    const int j = s * KS + lane;
    int32_t r = 0;
    bool kept = false;
    if (lane < KS && t < T && j < top_k) {
      const int64_t e = t * top_k + j;
      const int64_t v = slot[e];
      kept = keep[e] != 0;
      r = static_cast<int32_t>(v < 0 ? 0 : (v >= S ? S - 1 : v));
    }
    const uint32_t mask = __ballot_sync(0xffffffffu, kept);
    int64_t row[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i)
      row[i] = static_cast<int64_t>(__shfl_sync(0xffffffffu, r, i)) * d;
    if (active) {
      typename P::Raw raw[KS];
#pragma unroll
      for (int i = 0; i < KS; ++i)
        if ((mask >> i) & 1u) raw[i] = P::load(col + row[i]);
#pragma unroll
      for (int i = 0; i < KS; ++i)
        if ((mask >> i) & 1u) P::add(acc, raw[i]);
    }
  }
  if (active) store<E, P::V>(dx + t * d + piece * P::V, acc);
}

template <typename E, bool kVec, int K>
void launch_as(const Plan& p, const void* dbuf, const void* slot,
               const void* keep, void* dx, int64_t S, int64_t T, int64_t d,
               int top_k, cudaStream_t cs) {
  moe_dispatch_bwd_kernel<E, kVec, K>
      <<<static_cast<unsigned>(p.blocks), p.threads, 0, cs>>>(
          static_cast<const E*>(dbuf), static_cast<const int32_t*>(slot),
          static_cast<const uint8_t*>(keep), static_cast<E*>(dx), S, T, d,
          top_k, p.pieces, FastDiv(p.chunks), FastDiv(p.cw), p.G);
}

template <typename E, bool kVec>
void launch_k(const Plan& p, const void* dbuf, const void* slot,
              const void* keep, void* dx, int64_t S, int64_t T, int64_t d,
              int top_k, cudaStream_t cs) {
  switch (p.K) {
    case 1:
      return launch_as<E, kVec, 1>(p, dbuf, slot, keep, dx, S, T, d,
                                   top_k, cs);
    case 2:
      return launch_as<E, kVec, 2>(p, dbuf, slot, keep, dx, S, T, d,
                                   top_k, cs);
    case 4:
      return launch_as<E, kVec, 4>(p, dbuf, slot, keep, dx, S, T, d,
                                   top_k, cs);
    case 8:
      return launch_as<E, kVec, 8>(p, dbuf, slot, keep, dx, S, T, d,
                                   top_k, cs);
    default:
      return launch_as<E, kVec, 0>(p, dbuf, slot, keep, dx, S, T, d,
                                   top_k, cs);
  }
}

template <typename E>
cudaError_t launch(const void* dbuf, const void* slot, const void* keep,
                   void* dx, int64_t S, int64_t T, int64_t d, int64_t top_k,
                   int vec, cudaStream_t cs) {
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(T, d, top_k, sizeof(E), vec != 0, card, &p))
    return cudaErrorInvalidValue;
  if (vec)
    launch_k<E, true>(p, dbuf, slot, keep, dx, S, T, d, (int)top_k, cs);
  else
    launch_k<E, false>(p, dbuf, slot, keep, dx, S, T, d, (int)top_k, cs);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). dbuf: (S, d); slot: (T*top_k,)
// int32; keep: (T*top_k,) bool (one byte each); dx: (T, d) in dbuf's
// type, 16-byte aligned. vec: 1 where d is a multiple of a 16-byte piece
// and dbuf is 16-byte aligned. Returns the cudaError_t of the launch.
extern "C" int moe_dispatch_bwd_f32(const void* dbuf, const void* slot,
                                    const void* keep, void* dx, int64_t S,
                                    int64_t T, int64_t d, int64_t top_k,
                                    int vec, void* cs) {
  return (int)repro_torch::launch<float>(dbuf, slot, keep, dx, S, T, d,
                                         top_k, vec,
                                         static_cast<cudaStream_t>(cs));
}

extern "C" int moe_dispatch_bwd_bf16(const void* dbuf, const void* slot,
                                     const void* keep, void* dx, int64_t S,
                                     int64_t T, int64_t d, int64_t top_k,
                                     int vec, void* cs) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      dbuf, slot, keep, dx, S, T, d, top_k, vec,
      static_cast<cudaStream_t>(cs));
}

// The plan of a call on the current device (moe_plan.cuh report_plan).
extern "C" int moe_dispatch_bwd_plan(long long T, long long d,
                                     long long top_k, int esize, int vec,
                                     long long* out) {
  return repro_torch::report_plan(T, d, top_k, esize, vec, out);
}
