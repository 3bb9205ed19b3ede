// The launch plan and the row pieces shared by the token-order MoE
// gathers (moe_combine.cu, moe_dispatch_bwd.cu): a token's row cut into
// 16-byte pieces, one a thread, in chunks of whole warps, so that each
// warp holds one token and shares that token's slots by shuffles.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kMaxThreads = 512;   // threads of a block
constexpr int kStage = 8;          // choices a stage of the generic path
constexpr int kFill = 4;           // blocks an SM aimed at
constexpr int kMaxDevices = 64;

struct Card {
  int sms;  // SMs
};

// The current device's index and its Card, queried once per device.
cudaError_t current_card(int* dev, Card* card) {
  static Card cards[kMaxDevices];
  static bool known[kMaxDevices] = {false};
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return err;
  if (*dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!known[*dev]) {
    Card q;
    err = cudaDeviceGetAttribute(&q.sms, cudaDevAttrMultiProcessorCount, *dev);
    if (err != cudaSuccess) return err;
    cards[*dev] = q;
    known[*dev] = true;
  }
  *card = cards[*dev];
  return cudaSuccess;
}

// n / d for 0 <= n < 2^31 in a multiply and a shift (the divisor's
// magic number is computed on the host, as PyTorch's IntDivider does),
// so a one-warp block does not wait on an integer division.
struct FastDiv {
  uint32_t d, m, s;
  FastDiv() = default;
  explicit FastDiv(uint32_t div) : d(div), s(0) {
    while (s < 32 && (1ull << s) < div) ++s;
    m = static_cast<uint32_t>(((1ull << 32) * ((1ull << s) - div)) / div + 1);
  }
  __device__ uint32_t div(uint32_t n) const {
    return (__umulhi(n, m) + n) >> s;
  }
};

// One call's launch.
struct Plan {
  int V;             // columns of a piece: 16 bytes' worth, or 1 (scalar)
  long long pieces;  // pieces of a row
  int chunks;        // chunks a row is cut into
  int cw;            // threads a chunk, a piece each, in whole warps
  int G;             // tokens a block
  int K;             // choices unrolled: top_k in {1, 2, 4, 8}, else 0
  int stages;        // stages of choices (1, or ceil(top_k / kStage))
  int threads;       // threads of a block: G * cw
  long long blocks;  // ceil(T / G) * chunks
};

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// The launch for T tokens of d columns at top_k, with elements of esize
// bytes, on the vector path (vec) or the scalar one:
// - Chunks: a row's pieces cut into the fewest chunks of at most
//   kMaxThreads pieces, or, where T tokens give fewer blocks than the
//   card has SMs, into as many chunks of at least 32 pieces as make one
//   block an SM (a token's row is then not one SM's to read and write).
//   A chunk takes whole warps, so that each warp holds one token.
// - G: tokens a block, as many as make kFill blocks an SM busy, at
//   least one and at most kMaxThreads threads.
// Returns false where the grid would be too large.
bool make_plan(long long T, long long d, long long top_k, int esize,
               bool vec, const Card& card, Plan* out) {
  if (T < 1 || d < 1 || top_k < 1 || top_k > 0x7fffffff) return false;
  Plan& p = *out;
  p.V = vec ? 16 / esize : 1;
  if (d % p.V) return false;
  p.pieces = d / p.V;
  long long chunks = cdiv(p.pieces, kMaxThreads);
  if (T * chunks < card.sms)
    chunks = std::max(chunks, std::min(cdiv(p.pieces, 32),
                                       cdiv(card.sms, T)));
  p.chunks = static_cast<int>(chunks);
  p.cw = static_cast<int>(cdiv(cdiv(p.pieces, chunks), 32) * 32);
  const bool unrolled = top_k == 1 || top_k == 2 || top_k == 4 || top_k == 8;
  p.K = unrolled ? static_cast<int>(top_k) : 0;
  p.stages = unrolled ? 1 : static_cast<int>(cdiv(top_k, kStage));
  const long long most = kMaxThreads / p.cw;
  const long long want =
      cdiv(T * p.chunks, static_cast<long long>(card.sms) * kFill);
  p.G = static_cast<int>(std::min(most, std::max(1LL, want)));
  p.threads = p.G * p.cw;
  p.blocks = cdiv(T, p.G) * p.chunks;
  return p.blocks <= 0x7fffffff;
}


// A 16-byte piece of a row (the vector path): 8 bf16 or 4 f32 columns,
// loaded raw and read out column by column as f32.
template <typename E>
struct Vec16 {
  static constexpr int V = 16 / sizeof(E);
  __device__ static uint4 load(const E* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  // Column c of the piece as f32: bf16 pairs sit low half first.
  __device__ static float column(const uint4& raw, int c) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
    if (sizeof(E) == 4) return __uint_as_float(w[c]);
    const uint32_t u = w[c >> 1];
    return __uint_as_float((c & 1) ? (u & 0xffff0000u) : (u << 16));
  }
};

// The plan of a call on the current device, for the wrappers, reports
// and tests: out gets the piece's columns, pieces a row, chunks a row,
// threads a chunk, tokens a block, choices unrolled (0: stages),
// stages, threads a block, blocks and the card's SMs. Returns a
// cudaError_t (cudaErrorInvalidValue where the grid would be too large).
inline int report_plan(long long T, long long d, long long top_k, int esize,
                       int vec, long long* out) {
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return (int)err;
  Plan p;
  if (!make_plan(T, d, top_k, esize, vec != 0, card, &p))
    return (int)cudaErrorInvalidValue;
  const long long v[] = {p.V, p.pieces, p.chunks,  p.cw,     p.G,
                         p.K, p.stages, p.threads, p.blocks, card.sms};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}

}  // namespace
}  // namespace repro_torch
