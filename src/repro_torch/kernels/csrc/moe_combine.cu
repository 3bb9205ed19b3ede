// Weighted re-assembly of per-slot outputs into token (request) order:
// the combine of the routed serving step, and of a mixture-of-experts
// layer in general.
//
// Replaces: repro/kernels/moe_dispatch.py, the Pallas kernel built in
// `_moe_combine` (its inner `kernel`).
//
// Computes, for ybuf (S, d), slot (T*top_k,) int32 and gates
// (T*top_k,) f32,
//   y[t, :] = sum_{j < top_k} gates[t*top_k + j] * ybuf[clip(slot[...]), :]
// in f32, with j in order.
//
// What bounds it on an H100: one multiply and one add per element read,
// so the bytes: top_k rows of ybuf read and one f32 row written per
// token (at Mixtral's prefill, 268 MB read and 268 MB written a layer).
//
// What the first design lacked: bytes in flight. It gave each thread one
// column, so a thread had one 2-byte (bf16) load per choice in flight,
// behind a load of its token's slot: at most about 8 KB of ybuf in
// flight an SM, where the card's bandwidth times its memory latency asks
// for about 15-20 KB. It reached 37% of the bytes bound on an H100.
//
// Design (`make_plan` in moe_plan.cuh lays out each launch from the shape
// and the card):
// - A thread owns one 16-byte piece of a row: 8 bf16 or 4 f32 columns
//   (the vector path; d a multiple of the piece and ybuf's base 16-byte
//   aligned), or one column (the scalar path, any d and base).
// - A block takes chunks of one or more tokens' rows, each chunk at
//   most 512 pieces in whole warps (lanes past the row idle); the grid
//   is one-dimensional over (token group, chunk). At the Mixtral
//   prefill a block is one token's row, 512 threads. Where the tokens
//   are fewer than the SMs (a decode step's 4), rows are cut into
//   chunks of 32 pieces, so that no SM reads and writes a whole token
//   alone.
// - Each warp holds one token: it loads the token's slots (clipped) and
//   gates once, lane j the choice j, and shares them by shuffles. No
//   shared memory, no barrier, and integer divisions by a multiply
//   (FastDiv), so a block of one warp starts its row loads soon after
//   it starts.
// - Every choice's load is issued before the first multiply: the loop
//   over j is unrolled for top_k in {1, 2, 4, 8}, so at top_k = 2 a
//   thread has 32 bytes in flight and an SM up to 64 KB. Other top_k go
//   through stages of 8 choices, each unrolled and masked, the sums
//   carried across stages in registers.
// - The f32 output is written as plain float4 stores (a streaming hint,
//   `__stcs`, was no faster on an H100 at the prefill shape).
// Each product and each sum is rounded on its own (__fmul_rn /
// __fadd_rn, from a sum of 0, j in order), so nvcc cannot contract them
// into an FMA: the result is the plain version's bit for bit for top_k
// <= 2, and the sequential sum's for any top_k. An entry whose gate is 0
// is still read and multiplied, so 0 * inf gives NaN as in the Pallas
// kernel. Offsets are 64-bit.

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
  __device__ static void add(float* acc, Raw raw, float g) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(raw, g));
  }
  __device__ static void store(float* o, const float* acc) { *o = acc[0]; }
};

template <typename E>
struct Piece<E, true> {
  static constexpr int V = Vec16<E>::V;
  using Raw = uint4;
  __device__ static Raw load(const E* p) { return Vec16<E>::load(p); }
  __device__ static void add(float* acc, const Raw& raw, float g) {
#pragma unroll
    for (int c = 0; c < V; ++c)
      acc[c] = __fadd_rn(acc[c], __fmul_rn(Vec16<E>::column(raw, c), g));
  }
  __device__ static void store(float* o, const float* acc) {
#pragma unroll
    for (int c = 0; c < V; c += 4)
      *reinterpret_cast<float4*>(o + c) =
          make_float4(acc[c], acc[c + 1], acc[c + 2], acc[c + 3]);
  }
};

// E: the storage type of ybuf (float or __nv_bfloat16); kVec: the vector
// path; K: top_k where it is 1, 2, 4 or 8, else 0 (stages of kStage
// choices, masked past top_k). Each warp holds one token: lane j loads
// its choice j, and the warp shares them by shuffles.
template <typename E, bool kVec, int K>
__global__ void __launch_bounds__(kMaxThreads) moe_combine_kernel(
    const E* __restrict__ ybuf, const int32_t* __restrict__ slot,
    const float* __restrict__ gates, float* __restrict__ out, int64_t S,
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
  const E* col = ybuf + piece * P::V;
  float acc[P::V];
#pragma unroll
  for (int c = 0; c < P::V; ++c) acc[c] = 0.f;
  const int stages = K ? 1 : (top_k + kStage - 1) / kStage;
  for (int s = 0; s < stages; ++s) {
    const int j = s * KS + lane;
    int32_t r = 0;
    float w = 0.f;
    if (lane < KS && t < T && j < top_k) {
      const int64_t v = slot[t * top_k + j];
      r = static_cast<int32_t>(v < 0 ? 0 : (v >= S ? S - 1 : v));
      w = gates[t * top_k + j];
    }
    int64_t row[KS];
    float gate[KS];
#pragma unroll
    for (int i = 0; i < KS; ++i) {
      row[i] = static_cast<int64_t>(__shfl_sync(0xffffffffu, r, i)) * d;
      gate[i] = __shfl_sync(0xffffffffu, w, i);
    }
    if (active) {
      typename P::Raw raw[KS];
#pragma unroll
      for (int i = 0; i < KS; ++i)
        if (K || s * KS + i < top_k) raw[i] = P::load(col + row[i]);
#pragma unroll
      for (int i = 0; i < KS; ++i)
        if (K || s * KS + i < top_k) P::add(acc, raw[i], gate[i]);
    }
  }
  if (active) P::store(out + t * d + piece * P::V, acc);
}

template <typename E, bool kVec, int K>
void launch_as(const Plan& p, const void* ybuf, const void* slot,
               const void* gates, void* out, int64_t S, int64_t T, int64_t d,
               int top_k, cudaStream_t cs) {
  moe_combine_kernel<E, kVec, K>
      <<<static_cast<unsigned>(p.blocks), p.threads, 0, cs>>>(
          static_cast<const E*>(ybuf), static_cast<const int32_t*>(slot),
          static_cast<const float*>(gates), static_cast<float*>(out), S, T,
          d, top_k, p.pieces, FastDiv(p.chunks), FastDiv(p.cw), p.G);
}

template <typename E, bool kVec>
void launch_k(const Plan& p, const void* ybuf, const void* slot,
              const void* gates, void* out, int64_t S, int64_t T, int64_t d,
              int top_k, cudaStream_t cs) {
  switch (p.K) {
    case 1:
      return launch_as<E, kVec, 1>(p, ybuf, slot, gates, out, S, T, d, top_k,
                                   cs);
    case 2:
      return launch_as<E, kVec, 2>(p, ybuf, slot, gates, out, S, T, d, top_k,
                                   cs);
    case 4:
      return launch_as<E, kVec, 4>(p, ybuf, slot, gates, out, S, T, d, top_k,
                                   cs);
    case 8:
      return launch_as<E, kVec, 8>(p, ybuf, slot, gates, out, S, T, d, top_k,
                                   cs);
    default:
      return launch_as<E, kVec, 0>(p, ybuf, slot, gates, out, S, T, d, top_k,
                                   cs);
  }
}

template <typename E>
cudaError_t launch(const void* ybuf, const void* slot, const void* gates,
                   void* out, int64_t S, int64_t T, int64_t d, int64_t top_k,
                   int vec, cudaStream_t cs) {
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return err;
  Plan p;
  if (!make_plan(T, d, top_k, sizeof(E), vec != 0, card, &p))
    return cudaErrorInvalidValue;
  if (vec)
    launch_k<E, true>(p, ybuf, slot, gates, out, S, T, d, (int)top_k, cs);
  else
    launch_k<E, false>(p, ybuf, slot, gates, out, S, T, d, (int)top_k, cs);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). ybuf: (S, d); slot: (T*top_k,) int32;
// gates: (T*top_k,) f32; out: (T, d) f32, 16-byte aligned. vec: 1 where
// d is a multiple of a 16-byte piece and ybuf is 16-byte aligned.
// Returns the cudaError_t of the launch.
extern "C" int moe_combine_f32(const void* ybuf, const void* slot,
                               const void* gates, void* out, int64_t S,
                               int64_t T, int64_t d, int64_t top_k, int vec,
                               void* cs) {
  return (int)repro_torch::launch<float>(ybuf, slot, gates, out, S, T, d,
                                         top_k, vec,
                                         static_cast<cudaStream_t>(cs));
}

extern "C" int moe_combine_bf16(const void* ybuf, const void* slot,
                                const void* gates, void* out, int64_t S,
                                int64_t T, int64_t d, int64_t top_k, int vec,
                                void* cs) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      ybuf, slot, gates, out, S, T, d, top_k, vec,
      static_cast<cudaStream_t>(cs));
}

// The plan of a call on the current device (moe_plan.cuh report_plan).
extern "C" int moe_combine_plan(long long T, long long d, long long top_k,
                                int esize, int vec, long long* out) {
  return repro_torch::report_plan(T, d, top_k, esize, vec, out);
}
