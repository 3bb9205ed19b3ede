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
// where assign == -1 (or any value outside [0, k)) contributes nothing.
//
// What bounds it on an H100: one add per element of a valid row, so
// reading those rows of x is the bound; rows at -1 need not be read.
//
// Design (`make_plan` below picks L, the warps and the column groups
// from the shape and the card). Two kernels, one after the other on the
// stream, with no float atomics:
// - kmeans_bucket_kernel, one block per batch entry: a stable counting
//   sort of the entry's valid rows by cluster. Each warp takes a chunk
//   of consecutive rows and counts them by cluster in index order
//   (__match_any_sync ranks the lanes of a cluster, a per-warp count
//   table in shared memory carries the chunk's running counts, and a
//   32-row group with no valid row is skipped); exclusive prefixes over
//   the warps then give every row its place in its cluster's list, so
//   each list is in point order whatever the scheduling. The lists are
//   cut into segments of L rows, and each segment is written as one
//   item record: (cluster, segment, segments of the cluster, rows) and
//   its row indices (and weights). An empty cluster gets one record of
//   no rows, so its sums are written too; records past the last are
//   marked -1. The block also zeroes the tickets of the summing kernel.
// - kmeans_sum_kernel, one block per (item, column group, batch entry):
//   a thread owns 4 consecutive columns and walks its segment in list
//   order, with kU rows' loads (16 bytes each where the row stride
//   allows) issued before the first FMA; so a block's work is its own
//   rows, and no block reads a row at -1. A cluster of one segment is
//   written at once, summed by fmaf in point order from 0 (the bits of a
//   sequential sum). A longer list writes per-segment partials to
//   scratch, added in a fixed tree through integer tickets: the last
//   block of each group of kGroup consecutive segments adds the group's
//   partials in segment order, and the last group of the list adds the
//   groups' sums in group order (a list of 1024 rows waits for 8 + 8
//   partials, not 64). Counts are summed the same way, in list order by
//   one thread within a segment. It is a programmatic dependent launch:
//   its blocks start while the bucketing kernel ends, and wait for its
//   records.
// Every sum's order depends only on the shape and the assignment, so two
// runs give the same bits.

#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kU = 8;                      // rows a thread has in flight
constexpr int kSegRows[] = {64, 32, 16};   // L choices, larger first
constexpr int kMaxL = 64;                  // the largest of kSegRows
constexpr int kGroup = 8;                  // segments a first-level sum adds
constexpr int kFill = 4;                   // summing blocks an SM aimed at
constexpr int kMaxSumThreads = 256;
constexpr int kMaxWarps = 32;              // warps of a bucketing block
constexpr int kMaxDevices = 64;

struct Card {
  int sms;         // SMs
  int smem_limit;  // shared memory a block may opt in to
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
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &q.smem_limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *dev);
    if (err != cudaSuccess) return err;
    cards[*dev] = q;
    known[*dev] = true;
  }
  *card = cards[*dev];
  return cudaSuccess;
}

// What both kernels need to know of a call.
struct Shape {
  int n, k, d;
  int L;        // rows of a segment, a power of two
  int lg;       // log2 L
  int items;    // item records of a batch entry
  int stride;   // ints of a record: 4 + L (+ L weights)
  int warps;    // warps of a bucketing block
  int chunk;    // rows a bucketing warp takes, a multiple of 32
  int d4;       // 4-column groups of a row
  int groups;   // column groups
  int cols;     // 4-column groups a column group takes
};

// One call's launch and scratch.
struct Plan {
  Shape s;
  int B;
  int sum_threads;
  size_t bucket_smem;
  long long sum_blocks;
  // scratch, in 4-byte words: records, tickets, partials
  long long rec_words, ticket_words, part_words;
  long long scratch_bytes;
};

inline int cdiv(long long a, long long b) {
  return static_cast<int>((a + b - 1) / b);
}
inline size_t bucket_smem(int warps, int k) {
  return sizeof(int32_t) * (static_cast<size_t>(warps) * k + 2 * k + 1);
}
inline long long align4(long long words) { return (words + 3) / 4 * 4; }

// The launch for x (B, n, d) into k clusters, weighted or not:
// - Column groups of at most kMaxSumThreads 4-column groups; a summing
//   block has one thread a 4-column group, in whole warps.
// - L: the largest of kSegRows that still gives kFill summing blocks an
//   SM if every row were valid (else the smallest): short segments keep
//   a block's chain of loads short, long ones need fewer partials.
// - Items a batch entry: ceil(n / L) + k bounds sum_r max(1, ceil(len_r
//   / L)) whatever the assignment.
// - Bucketing warps: one a 32 rows up to kMaxWarps, halved until the
//   per-warp count tables fit the card's shared memory.
// Returns false where no block fits the card or a grid is too large.
bool make_plan(int B, int n, int k, int d, bool weighted, const Card& card,
               Plan* out) {
  if (B < 1 || B > 65535 || n < 0 || k < 1 || d < 1) return false;
  Shape& s = out->s;
  s = Shape{};
  s.n = n;
  s.k = k;
  s.d = d;
  s.d4 = cdiv(d, 4);
  s.groups = cdiv(s.d4, kMaxSumThreads);
  s.cols = cdiv(s.d4, s.groups);
  if (s.groups > 65535) return false;
  s.L = kSegRows[2];
  for (int L : kSegRows) {
    if (static_cast<long long>(B) * s.groups * cdiv(n, L) >=
        static_cast<long long>(kFill) * card.sms) {
      s.L = L;
      break;
    }
  }
  s.lg = s.L == 64 ? 6 : s.L == 32 ? 5 : 4;
  const long long items = static_cast<long long>(cdiv(n, s.L)) + k;
  if (items > 0x7fffffffLL) return false;
  s.items = static_cast<int>(items);
  s.stride = 4 + s.L * (weighted ? 2 : 1);
  s.warps = std::max(1, std::min(kMaxWarps, cdiv(n, 32)));
  while (s.warps > 1 && bucket_smem(s.warps, k) >
                            static_cast<size_t>(card.smem_limit))
    s.warps /= 2;
  if (bucket_smem(s.warps, k) > static_cast<size_t>(card.smem_limit))
    return false;
  s.chunk = std::max(32, cdiv(cdiv(n, s.warps), 32) * 32);
  out->B = B;
  out->sum_threads = cdiv(s.cols, 32) * 32;
  out->bucket_smem = bucket_smem(s.warps, k);
  out->sum_blocks = items * s.groups * B;
  out->rec_words = align4(B * items * s.stride);
  // tickets of the lists, then of the groups of segments
  out->ticket_words = align4((static_cast<long long>(B) * k + B * items) *
                             s.groups);
  out->part_words = B * items * (4LL * s.d4 + 1);
  out->scratch_bytes =
      4 * (out->rec_words + out->ticket_words + out->part_words);
  return true;
}

template <bool WEIGHTED>
__global__ void __launch_bounds__(32 * kMaxWarps) kmeans_bucket_kernel(
    const int32_t* __restrict__ assign, const float* __restrict__ w,
    int32_t* __restrict__ rec, int32_t* __restrict__ tickets, Shape s) {
  // The summing kernel may launch now; it waits for this grid to end.
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ int32_t sm[];
  int32_t* wc = sm;                     // [warps][k] counts, then prefixes
  int32_t* len = wc + s.warps * s.k;    // [k] rows of each cluster
  int32_t* start = len + s.k;           // [k + 1] first item of a cluster
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nt = blockDim.x;
  const unsigned lt = (1u << lane) - 1u;
  const int32_t* ab = assign + static_cast<long long>(b) * s.n;
  int32_t* rb = rec + static_cast<long long>(b) * s.items * s.stride;
  int32_t* own = wc + warp * s.k;
  for (int e = tid; e < s.warps * s.k; e += nt) wc[e] = 0;
  __syncthreads();

  // Pass 1: each warp counts its chunk's rows by cluster; a 32-row group
  // with no valid row is skipped.
  const int lo = warp * s.chunk, hi = min(s.n, lo + s.chunk);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int a = i < hi ? ab[i] : -1;
    const bool valid = static_cast<unsigned>(a) < static_cast<unsigned>(s.k);
    if (__ballot_sync(0xffffffffu, valid) == 0) continue;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? a : -1);
    if (valid && (peers & lt) == 0) own[a] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // Exclusive prefixes over the warps, and each cluster's length.
  for (int r = tid; r < s.k; r += nt) {
    int run = 0;
    for (int q = 0; q < s.warps; ++q) {
      const int c = wc[q * s.k + r];
      wc[q * s.k + r] = run;
      run += c;
    }
    len[r] = run;
  }
  __syncthreads();

  // Each cluster's first item: an exclusive scan of max(1, ceil(len / L))
  // over the clusters, a contiguous run of clusters a lane.
  if (warp == 0) {
    const int per = (s.k + 31) / 32;
    const int r0 = min(s.k, lane * per), r1 = min(s.k, r0 + per);
    int mine = 0;
    for (int r = r0; r < r1; ++r) mine += max(1, (len[r] + s.L - 1) >> s.lg);
    int inc = mine;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += v;
    }
    int run = inc - mine;
    for (int r = r0; r < r1; ++r) {
      start[r] = run;
      run += max(1, (len[r] + s.L - 1) >> s.lg);
    }
    if (lane == 31) start[s.k] = inc;
  }
  __syncthreads();

  // Pass 2: the same walk places every valid row in its cluster's list:
  // after the earlier warps' rows of the cluster and the chunk's earlier
  // rows.
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const int a = i < hi ? ab[i] : -1;
    const bool valid = static_cast<unsigned>(a) < static_cast<unsigned>(s.k);
    if (__ballot_sync(0xffffffffu, valid) == 0) continue;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? a : -1);
    if (valid) {
      const int pos = own[a] + __popc(peers & lt);
      int32_t* item =
          rb + static_cast<long long>(start[a] + (pos >> s.lg)) * s.stride;
      const int slot = 4 + (pos & (s.L - 1));
      item[slot] = i;
      if (WEIGHTED)
        item[slot + s.L] =
            __float_as_int(w[static_cast<long long>(b) * s.n + i]);
    }
    __syncwarp();
    if (valid && (peers & lt) == 0) own[a] += __popc(peers);
    __syncwarp();
  }

  // Headers: (cluster, segment, segments of the cluster, rows); -1 past
  // the last item.
  const int total = start[s.k];
  for (int j = tid; j < s.items; j += nt) {
    int4 h = make_int4(-1, 0, 0, 0);
    if (j < total) {
      int r = 0, top = s.k - 1;  // the last cluster whose first item <= j
      while (r < top) {
        const int mid = (r + top + 1) >> 1;
        if (start[mid] <= j) r = mid; else top = mid - 1;
      }
      const int seg = j - start[r];
      h = make_int4(r, seg, start[r + 1] - start[r],
                    min(s.L, len[r] - (seg << s.lg)));
    }
    *reinterpret_cast<int4*>(rb + static_cast<long long>(j) * s.stride) = h;
  }
  int32_t* tb = tickets + static_cast<long long>(b) * s.k * s.groups;
  for (int e = tid; e < s.k * s.groups; e += nt) tb[e] = 0;
  tb = tickets + static_cast<long long>(gridDim.x) * s.k * s.groups +
       static_cast<long long>(b) * s.items * s.groups;
  for (int e = tid; e < s.items * s.groups; e += nt) tb[e] = 0;
}

// Four consecutive elements of a row from column c0 on, widened to f32;
// `left` = d - c0 of them exist.
template <typename T, bool VEC>
__device__ __forceinline__ void load4(const T* p, int left, float v[4]);
template <>
__device__ __forceinline__ void load4<float, true>(const float* p, int,
                                                   float v[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16, true>(
    const __nv_bfloat16* p, int, float v[4]) {
  const uint2 q = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 c = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x; v[1] = a.y; v[2] = c.x; v[3] = c.y;
}
template <>
__device__ __forceinline__ void load4<float, false>(const float* p, int left,
                                                    float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < left ? __ldg(p + q) : 0.f;
}
template <>
__device__ __forceinline__ void load4<__nv_bfloat16, false>(
    const __nv_bfloat16* p, int left, float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) v[q] = q < left ? load_f(p + q) : 0.f;
}

__device__ __forceinline__ void store4(float* p, int left, const float v[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < left) p[q] = v[q];
}

// Counts this block in at an integer ticket of `of` blocks; true in the
// last of them, which then sees every earlier block's writes.
__device__ __forceinline__ bool arrive(int32_t* ticket, int of, int* last) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) *last = atomicAdd(ticket, 1) == of - 1;
  __syncthreads();
  if (!*last) return false;
  __threadfence();
  return true;
}

// The sum, in order, of the partials of items first, first + step, ...
// (n of them): this thread's 4 columns (part already offset to them) and,
// for the counting thread, the counts; 4 loads in flight.
__device__ __forceinline__ void add_partials(const float* part,
                                             const float* pc, long long first,
                                             int step, int n, int pstride,
                                             bool live, bool counter,
                                             float tot[4], float* cnt) {
  tot[0] = tot[1] = tot[2] = tot[3] = 0.f;
  if (live) {
    for (int q0 = 0; q0 < n; q0 += 4) {
      float4 p[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q0 + q < n)
          p[q] = __ldcg(reinterpret_cast<const float4*>(
              part + (first + static_cast<long long>(q0 + q) * step) *
                         pstride));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (q0 + q < n) {
          tot[0] += p[q].x; tot[1] += p[q].y;
          tot[2] += p[q].z; tot[3] += p[q].w;
        }
      }
    }
  }
  if (counter) {
    float c = 0.f;
    for (int q = 0; q < n; ++q)
      c += __ldcg(pc + first + static_cast<long long>(q) * step);
    *cnt = c;
  }
}

template <typename T, bool VEC, bool WEIGHTED>
__global__ void __launch_bounds__(kMaxSumThreads) kmeans_sum_kernel(
    const T* __restrict__ x, const int32_t* __restrict__ rec,
    float* __restrict__ sums, float* __restrict__ counts,
    float* __restrict__ part, int32_t* __restrict__ tickets, Shape s) {
  __shared__ int32_t it[4 + 2 * kMaxL];  // this block's item record
  __shared__ int last;
  const int j = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the records
  const long long pj = static_cast<long long>(b) * s.items + j;
  const int32_t* rp = rec + pj * s.stride;
  for (int e = tid; e < s.stride; e += blockDim.x) it[e] = rp[e];
  __syncthreads();
  const int r = it[0];
  if (r < 0) return;
  const int seg = it[1], nseg = it[2], cnt = it[3];
  const int32_t* rows = it + 4;
  const float* wts = reinterpret_cast<const float*>(it + 4 + s.L);
  const int c4 = g * s.cols + tid;
  const bool live = tid < s.cols && c4 < s.d4;
  const int c0 = 4 * c4, left = s.d - c0;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (live) {
    const T* xb = x + static_cast<long long>(b) * s.n * s.d + c0;
    for (int p0 = 0; p0 < cnt; p0 += kU) {
      float v[kU][4];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (p0 + u < cnt)
          load4<T, VEC>(xb + static_cast<long long>(rows[p0 + u]) * s.d,
                        left, v[u]);
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        if (p0 + u < cnt) {
          const float wv = WEIGHTED ? wts[p0 + u] : 1.f;
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = fmaf(wv, v[u][q], acc[q]);
        }
      }
    }
  }
  const bool counter = g == 0 && tid == 0;
  float cntf = 0.f;
  if (counter)
    for (int u = 0; u < cnt; ++u) cntf += WEIGHTED ? wts[u] : 1.f;
  const long long out = static_cast<long long>(b) * s.k + r;
  if (nseg == 1) {
    if (live) store4(sums + out * s.d + c0, left, acc);
    if (counter) counts[out] = cntf;
    return;
  }

  // A list of several segments: partials to scratch, added in a fixed
  // tree. The last block of each group of kGroup consecutive segments
  // adds the group's partials in segment order and keeps the sum in the
  // group's first slot; the last group of the list adds the groups' sums
  // in group order.
  const int pstride = 4 * s.d4;
  float* pc = part + static_cast<long long>(s.items) * gridDim.z * pstride;
  const long long first = pj - seg, g0 = first + seg / kGroup * kGroup;
  const int ngroups = (nseg + kGroup - 1) / kGroup;
  const int gsize = min(kGroup, static_cast<int>(first + nseg - g0));
  if (live)
    __stcg(reinterpret_cast<float4*>(part + pj * pstride + c0),
           make_float4(acc[0], acc[1], acc[2], acc[3]));
  if (counter) __stcg(pc + pj, cntf);
  int32_t* gtickets = tickets + static_cast<long long>(gridDim.z) * s.k *
                                    s.groups;
  if (!arrive(gtickets + g0 * s.groups + g, gsize, &last)) return;
  add_partials(part + c0, pc, g0, 1, gsize, pstride, live, counter, acc,
               &cntf);
  if (ngroups > 1) {
    if (live)
      __stcg(reinterpret_cast<float4*>(part + g0 * pstride + c0),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
    if (counter) __stcg(pc + g0, cntf);
    if (!arrive(tickets + out * s.groups + g, ngroups, &last)) return;
    add_partials(part + c0, pc, first, kGroup, ngroups, pstride, live,
                 counter, acc, &cntf);
  }
  if (live) store4(sums + out * s.d + c0, left, acc);
  if (counter) counts[out] = cntf;
}

template <typename T, bool VEC, bool WEIGHTED>
cudaError_t launch_sum(const void* x, void* sums, void* counts,
                       int32_t* rec, float* part, int32_t* tickets,
                       const Plan& pl, cudaStream_t stream) {
  // A programmatic dependent launch: the blocks may start while the
  // bucketing kernel runs, and wait for it (griddepcontrol.wait) before
  // they read its records.
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(pl.s.items, pl.s.groups, pl.B);
  cfg.blockDim = dim3(pl.sum_threads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kmeans_sum_kernel<T, VEC, WEIGHTED>,
                            static_cast<const T*>(x),
                            static_cast<const int32_t*>(rec),
                            static_cast<float*>(sums),
                            static_cast<float*>(counts), part, tickets, pl.s);
}

template <bool WEIGHTED>
cudaError_t launch_bucket(const void* assign, const void* w, int32_t* rec,
                          int32_t* tickets, int dev, const Plan& pl,
                          cudaStream_t stream) {
  // Shared memory a block may take, per device, once raised.
  static int raised[kMaxDevices] = {0};
  auto kernel = kmeans_bucket_kernel<WEIGHTED>;
  const int smem = static_cast<int>(pl.bucket_smem);
  if (smem > 48 * 1024 && smem > raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
  }
  kernel<<<pl.B, 32 * pl.s.warps, smem, stream>>>(
      static_cast<const int32_t*>(assign), static_cast<const float*>(w), rec,
      tickets, pl.s);
  return cudaGetLastError();
}

template <typename T>
cudaError_t run(const void* x, const void* assign, const void* w,
                void* sums, void* counts, void* scratch,
                long long scratch_bytes, int B, int n, int k, int d, int vec,
                cudaStream_t stream) {
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return err;
  Plan pl;
  const bool weighted = w != nullptr;
  if (!make_plan(B, n, k, d, weighted, card, &pl) ||
      scratch_bytes < pl.scratch_bytes)
    return cudaErrorInvalidValue;
  int32_t* rec = static_cast<int32_t*>(scratch);
  int32_t* tickets = rec + pl.rec_words;
  float* part = reinterpret_cast<float*>(tickets + pl.ticket_words);
  err = weighted
      ? launch_bucket<true>(assign, w, rec, tickets, dev, pl, stream)
      : launch_bucket<false>(assign, w, rec, tickets, dev, pl, stream);
  if (err != cudaSuccess) return err;
  if (vec)
    return weighted
        ? launch_sum<T, true, true>(x, sums, counts, rec, part, tickets, pl,
                                    stream)
        : launch_sum<T, true, false>(x, sums, counts, rec, part, tickets, pl,
                                     stream);
  return weighted
      ? launch_sum<T, false, true>(x, sums, counts, rec, part, tickets, pl,
                                   stream)
      : launch_sum<T, false, false>(x, sums, counts, rec, part, tickets, pl,
                                    stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). x: (B, n, d); assign: (B, n) int32;
// w: (B, n) f32 or null; sums: (B, k, d) f32; counts: (B, k) f32;
// scratch: at least the plan's scratch bytes, 16-byte aligned; vec: x may
// be read 4 elements at a time (d a multiple of 4, base aligned to 4
// elements). Returns the cudaError_t of the launches
// (cudaErrorInvalidValue where no plan fits the card or the scratch is
// short).
extern "C" int kmeans_update_f32(const void* x, const void* assign,
                                 const void* w, void* sums, void* counts,
                                 void* scratch, long long scratch_bytes,
                                 int B, int n, int k, int d, int vec,
                                 void* stream) {
  return (int)repro_torch::run<float>(x, assign, w, sums, counts, scratch,
                                      scratch_bytes, B, n, k, d, vec,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int kmeans_update_bf16(const void* x, const void* assign,
                                  const void* w, void* sums, void* counts,
                                  void* scratch, long long scratch_bytes,
                                  int B, int n, int k, int d, int vec,
                                  void* stream) {
  return (int)repro_torch::run<__nv_bfloat16>(
      x, assign, w, sums, counts, scratch, scratch_bytes, B, n, k, d, vec,
      static_cast<cudaStream_t>(stream));
}

// The plan of a call on the current device, for the wrapper, reports and
// tests: out gets L, kU, kGroup, items a batch entry, ints a record,
// bucketing warps, bucketing shared memory, column groups, threads a
// summing block, summing blocks, scratch bytes and the card's SMs. Returns a
// cudaError_t (cudaErrorInvalidValue where no plan fits the card).
extern "C" int kmeans_update_plan(int B, int n, int k, int d, int weighted,
                                  long long* out) {
  int dev = 0;
  repro_torch::Card card;
  cudaError_t err = repro_torch::current_card(&dev, &card);
  if (err != cudaSuccess) return (int)err;
  repro_torch::Plan pl;
  if (!repro_torch::make_plan(B, n, k, d, weighted != 0, card, &pl))
    return (int)cudaErrorInvalidValue;
  const repro_torch::Shape& s = pl.s;
  const long long v[] = {s.L,         repro_torch::kU,
                         repro_torch::kGroup, s.items,
                         s.stride,
                         s.warps,     static_cast<long long>(pl.bucket_smem),
                         s.groups,    pl.sum_threads,
                         pl.sum_blocks, pl.scratch_bytes,
                         card.sms};
  for (int i = 0; i < 12; ++i) out[i] = v[i];
  return 0;
}
