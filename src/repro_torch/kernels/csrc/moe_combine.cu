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
// What bounds it on an H100: one multiply-add per element read, so the
// bytes: top_k rows of ybuf read and one f32 row written per token.
//
// Design: the TPU kernel walked j on a sequential grid axis, adding into
// its resident output block. Here each block owns one token and a chunk
// of 256 columns, one per thread: it loads the token's top_k slots and
// gates itself (the same addresses for every thread, served by one
// broadcast) and keeps the sum in a register across j. The products
// and sums are rounded one at a time (__fmul_rn / __fadd_rn), so nvcc
// cannot contract them into an FMA and the result is the plain
// version's, sum order included. Loads widen f32 or bf16 to f32;
// offsets are 64-bit.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;  // columns per block

// E: the storage type of ybuf (float or __nv_bfloat16).
template <typename E>
__global__ void __launch_bounds__(kThreads) moe_combine_kernel(
    const E* __restrict__ ybuf, const int32_t* __restrict__ slot,
    const float* __restrict__ gates, float* __restrict__ out, int64_t S,
    int64_t d, int top_k) {
  const int64_t t = blockIdx.x;
  const int64_t c = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  if (c >= d) return;
  float acc = 0.f;
  for (int j = 0; j < top_k; ++j) {
    const int64_t e = t * top_k + j;
    int64_t r = slot[e];
    r = r < 0 ? 0 : (r >= S ? S - 1 : r);
    acc = __fadd_rn(acc, __fmul_rn(load_f(ybuf + r * d + c), gates[e]));
  }
  out[t * d + c] = acc;
}

template <typename E>
cudaError_t launch(const void* ybuf, const void* slot, const void* gates,
                   void* out, int64_t S, int64_t T, int64_t d, int top_k,
                   cudaStream_t stream) {
  const int64_t chunks = (d + kThreads - 1) / kThreads;
  if (T > 0x7fffffff || chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)T, (unsigned)chunks);
  moe_combine_kernel<E><<<grid, kThreads, 0, stream>>>(
      static_cast<const E*>(ybuf), static_cast<const int32_t*>(slot),
      static_cast<const float*>(gates), static_cast<float*>(out), S, d,
      top_k);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). ybuf: (S, d); slot: (T*top_k,) int32;
// gates: (T*top_k,) f32; out: (T, d) f32. Returns the cudaError_t of the
// launch.
extern "C" int moe_combine_f32(const void* ybuf, const void* slot,
                               const void* gates, void* out, int64_t S,
                               int64_t T, int64_t d, int64_t top_k,
                               void* stream) {
  return (int)repro_torch::launch<float>(ybuf, slot, gates, out, S, T, d,
                                         (int)top_k,
                                         static_cast<cudaStream_t>(stream));
}

extern "C" int moe_combine_bf16(const void* ybuf, const void* slot,
                                const void* gates, void* out, int64_t S,
                                int64_t T, int64_t d, int64_t top_k,
                                void* stream) {
  return (int)repro_torch::launch<__nv_bfloat16>(
      ybuf, slot, gates, out, S, T, d, (int)top_k,
      static_cast<cudaStream_t>(stream));
}
