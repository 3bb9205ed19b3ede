// Queue-order row gather: the dispatch of the routed serving step, which
// gathers whole requests into per-cluster head queues.
//
// Replaces: repro/kernels/moe_dispatch.py, the Pallas kernel
// `_dispatch_kernel` launched by `_moe_dispatch`.
//
// Computes, for x (T, d), src (S,) int32 and valid (S,) bool,
//   out[s, :] = valid[s] ? x[clip(src[s], 0, T-1), :] : 0.
//
// What bounds it on an H100: no arithmetic at all, so the bytes: each
// valid slot reads one row of x and every slot writes one row.
//
// Design: the TPU kernel prefetched the routing indices to scalar memory
// and let each grid step's index map point the DMA engine at the source
// row. Here each block owns one slot and one chunk of its row and loads
// src[s] and valid[s] itself. A routed row is a whole request
// (n_pad * d values, up to hundreds of KB), so a row is split into
// 16 KB chunks, one per block, to put enough blocks in flight. Rows are
// copied as raw bits with 16-byte vector loads and stores where both
// addresses are 16-byte aligned, and one element at a time on the
// ragged tail (or where a row is not aligned). An invalid slot writes
// zeros and never reads x. f32 and bf16 storage are the same copy at
// 4- and 2-byte element width. Offsets are 64-bit.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 256;
constexpr int kChunkBytes = 16384;  // row bytes per block

// U: an unsigned integer of the element's width (the copy is bitwise).
template <typename U>
__global__ void __launch_bounds__(kThreads) moe_dispatch_kernel(
    const U* __restrict__ x, const int32_t* __restrict__ src,
    const uint8_t* __restrict__ valid, U* __restrict__ out, int64_t T,
    int64_t d) {
  constexpr int64_t kChunk = kChunkBytes / sizeof(U);  // elements
  constexpr int64_t kVec = 16 / sizeof(U);             // elements / uint4
  const int64_t s = blockIdx.x;
  const int64_t c0 = (int64_t)blockIdx.y * kChunk;
  const int64_t c1 = d < c0 + kChunk ? d : c0 + kChunk;
  U* orow = out + s * d;
  const bool keep = valid[s] != 0;
  const U* xrow = nullptr;
  if (keep) {
    int64_t r = src[s];
    r = r < 0 ? 0 : (r >= T ? T - 1 : r);
    xrow = x + r * d;
  }
  const uintptr_t addr = reinterpret_cast<uintptr_t>(orow + c0) |
                         (keep ? reinterpret_cast<uintptr_t>(xrow + c0) : 0);
  int64_t tail = c0;
  if ((addr & 15) == 0) {
    const int64_t nvec = (c1 - c0) / kVec;
    uint4* ov = reinterpret_cast<uint4*>(orow + c0);
    if (keep) {
      const uint4* xv = reinterpret_cast<const uint4*>(xrow + c0);
      for (int64_t i = threadIdx.x; i < nvec; i += kThreads)
        ov[i] = __ldg(xv + i);
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int64_t i = threadIdx.x; i < nvec; i += kThreads) ov[i] = z;
    }
    tail = c0 + nvec * kVec;
  }
  for (int64_t j = tail + threadIdx.x; j < c1; j += kThreads)
    orow[j] = keep ? xrow[j] : U(0);
}

template <typename U>
cudaError_t launch(const void* x, const void* src, const void* valid,
                   void* out, int64_t T, int64_t S, int64_t d,
                   cudaStream_t stream) {
  constexpr int64_t kChunk = kChunkBytes / sizeof(U);
  const int64_t chunks = (d + kChunk - 1) / kChunk;
  if (S > 0x7fffffff || chunks > 65535) return cudaErrorInvalidValue;
  dim3 grid((unsigned)S, (unsigned)chunks);
  moe_dispatch_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<const U*>(x), static_cast<const int32_t*>(src),
      static_cast<const uint8_t*>(valid), static_cast<U*>(out), T, d);
  return cudaGetLastError();
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). x: (T, d); src: (S,) int32; valid:
// (S,) bool (one byte each); out: (S, d) of x's type. Returns the
// cudaError_t of the launch.
extern "C" int moe_dispatch_f32(const void* x, const void* src,
                                const void* valid, void* out, int64_t T,
                                int64_t S, int64_t d, void* stream) {
  return (int)repro_torch::launch<uint32_t>(
      x, src, valid, out, T, S, d, static_cast<cudaStream_t>(stream));
}

extern "C" int moe_dispatch_bf16(const void* x, const void* src,
                                 const void* valid, void* out, int64_t T,
                                 int64_t S, int64_t d, void* stream) {
  return (int)repro_torch::launch<uint16_t>(
      x, src, valid, out, T, S, d, static_cast<cudaStream_t>(stream));
}
