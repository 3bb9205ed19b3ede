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
// What bounds it on an H100: not bytes and not operations. A request
// (n = 1024, d = 300 f32, 1.2 MB) is read from HBM once, 0.4 us at 3.35
// TB/s, and a Lloyd step is 4 k' flops per element of x, 0.2 us on one SM
// of the card. But the loop is a chain of data-dependent steps, each of
// which needs the whole request's new centers before the next assignment
// starts, so latency bounds it: each step's phases (assign, sum, agree on
// the centers, reload them) run one after another on the SMs that share
// the request. The TPU kernel keeps a request resident in VMEM; one SM's
// 227 KB of shared memory cannot hold it, and one block per request ran
// a batch of 8 on 8 of 132 SMs with x streaming from L2 on every step.
//
// Design: one persistent, cooperative launch of 512-thread blocks. A
// request's points are cut into P slices of R rows (R = 64; the last
// slice ragged), one block a slice, and each block keeps its slice of x
// in shared memory for the whole loop, with a row stride of an odd number
// of 32-bit words so that a warp reading 32 rows at one column hits 32
// banks. x is read from HBM once. Where a slice does not fit (large d or
// k') the block reads its rows from global memory on every pass with the
// same arithmetic (the streaming mode, chosen by shape: a template
// argument, so the loads know their address space). The grid is G groups
// of P blocks, G as many as are co-resident at the block's shared memory;
// group g serves requests g, g + G, ... in turn, and
// cudaLaunchCooperativeKernel refuses a grid that cannot be co-resident
// rather than let its barriers deadlock. Copies out of global memory keep
// several loads in flight per thread.
//
// One Lloyd step in a block: (1) assign its rows: 8 parts of d per row,
// one thread per (row, part), the partial dots of up to 16 centers in
// registers (blocked sums of 16 columns), centers broadcast from shared
// memory as float4, the parts added in part order; (2) sort its live rows
// by center (stable, warp match) and sum each center's rows in row order:
// the slice's partial sums and counts; (3) write them and a "some row
// changed" flag to a scratch buffer the wrapper allocates, double-buffered
// by the parity of the step, so a block that runs ahead never overwrites
// partials a slower block still reads; (4) barrier of the request's P
// blocks (an integer counter in scratch, __threadfence, no float atomics,
// no clusters); (5) every block ORs the P flags and stops if no row
// changed anywhere: the centers of this step would equal the last step's
// bit for bit; (6) block p reduces the 1/P-th share of the k' x d entries,
// summing the P partials in slice order, and writes the new centers; (7)
// a second barrier; every block reads all new centers. Reducing a share
// and a second barrier moves k' d floats per block per step through L2;
// every block reducing every entry would move P k' d (190 KB at the serve
// shape, 24 MB a step over 128 blocks) to save one barrier of about 2 us.
// A request of one slice (P = 1) needs neither scratch nor barrier: its
// new centers go straight into shared memory.
//
// After the loop each block writes min_sq_dist and the labels of its own
// rows. The attach is split too: block p takes tau rows [k p / P,
// k (p + 1) / P) and writes its first minimum per center; after a third
// barrier every block takes the first minimum over the P candidates in
// block order. Block 0 of the group writes the centers.
//
// P depends only on the request's shape (n, d, k', dtype) and the card,
// never on B: every request is computed by the same slices, summed in the
// same order, whatever batch it comes in, so a request alone and inside a
// batch gives the same bits (the batching contract of utils/prng.py), and
// two calls give the same bits.

#include "common.cuh"

namespace repro_torch {
namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                 // rows one dot pass takes
constexpr int kParts = kThreads / kTile;  // parts of d per row
constexpr int kMaxGroup = 16;             // centers per register group
constexpr int kRows = 64;                 // rows a slice holds
constexpr int kTd = kTile + 1;            // row stride of the attach dists

struct Params {
  const void* x;
  const void* c0;
  const void* tau;
  const uint8_t* cm;
  const uint8_t* pm;
  int32_t* labels;
  float* mind;
  float* centers;
  int32_t* clbl;
  float* part;     // (groups, 2, P, k' d) partial sums of the slices
  float* newc;     // (groups, k' d) the step's new centers
  float* cand;     // (groups, 2, P, 2 k') attach candidates (dist, index)
  int32_t* pcnt;   // (groups, 2, P, k' + 1) partial counts, changed flag
  unsigned* bar;   // (groups) barrier counters, zero at launch
  int B, n, kp, k, d, max_iters;
  int R, P, groups, xstride, cstride;
};

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared memory of one block, in 4-byte words, in the order of the layout
// in the kernel; x's slice (resident mode) comes last.
__host__ __device__ inline size_t common_words(int R, int kp, int cstride) {
  return (size_t)kp * cstride + round4(kp)            // centers, norms
         + (size_t)(kParts - 1) * kMaxGroup * kTile   // part sums
         + (size_t)kMaxGroup * kTd + kTile            // attach: dists, norms
         + 6 * (size_t)round4(R)          // xn, bd, a, bi, list, point mask
         + 6 * (size_t)round4(kp);        // cm, cnt, start, fill, ctr, tbest
}

__host__ inline int x_stride(int d, int esize) {
  // Row stride in elements: an odd number of 32-bit words.
  const int words = (d * esize + 3) / 4;
  return ((words | 1) * 4) / esize;
}

__host__ inline size_t block_bytes(int R, int kp, int d, int esize,
                                   bool resident) {
  size_t b = 4 * common_words(R, kp, round4(d));
  if (resident) b += (size_t)R * x_stride(d, esize) * esize;
  return b;
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float* v) {
#pragma unroll
  for (int u = 0; u < 4; ++u) v[u] = load_f(p + u);
}

// Four columns of a row times four columns of centers g0 .. g0 + G - 1,
// added to acc (within a center, the columns in order).
template <typename T, int G>
__device__ __forceinline__ void dot4(const T* xr, const float* cen, int cs,
                                     int g0, int gn, int j, float* acc) {
  float xv[4];
  load4(xr + j, xv);
#pragma unroll
  for (int t = 0; t < G; ++t) {
    if (t < gn) {
      const float4 c =
          *reinterpret_cast<const float4*>(cen + (g0 + t) * cs + j);
      acc[t] = fmaf(xv[0], c.x, acc[t]);
      acc[t] = fmaf(xv[1], c.y, acc[t]);
      acc[t] = fmaf(xv[2], c.z, acc[t]);
      acc[t] = fmaf(xv[3], c.w, acc[t]);
    }
  }
}

// Dots of rows [0, rows) (row i at rowp + i * stride, storage type) with
// centers g0 .. g0 + gn - 1 of `cen` (f32, row stride cs, 16-byte
// aligned). Thread (row i % 64, part) sums its part of d in blocks of 16
// columns, each block summed on its own and then added to the running
// sum (a blocked sum: at d = 2048 a part's running sum takes 16 additions,
// not 256, so fewer roundings land on a large value); parts 1.. hand their
// sums to part 0 through `red`, which adds them in part order and calls
// epi(i, t, dot) for t = 0 .. gn - 1 in order.
template <typename T, int G, typename Epi>
__device__ void row_dots(const T* rowp, long long stride, int rows,
                         const float* cen, int cs, int g0, int gn, int d,
                         float* red, Epi epi) {
  const int li = threadIdx.x % kTile;
  const int part = threadIdx.x / kTile;
  const int dq = round4((d + kParts - 1) / kParts);
  const int j0 = min(d, part * dq), j1 = min(d, j0 + dq);
  for (int i0 = 0; i0 < rows; i0 += kTile) {
    const int i = i0 + li;
    float p[G];
#pragma unroll
    for (int t = 0; t < G; ++t) p[t] = 0.f;
    if (i < rows) {
      const T* xr = rowp + (long long)i * stride;
      int j = j0;
      for (; j + 16 <= j1; j += 16) {
        float b[G];
#pragma unroll
        for (int t = 0; t < G; ++t) b[t] = 0.f;
#pragma unroll
        for (int u = 0; u < 16; u += 4)
          dot4<T, G>(xr, cen, cs, g0, gn, j + u, b);
#pragma unroll
        for (int t = 0; t < G; ++t) p[t] += b[t];
      }
      for (; j + 4 <= j1; j += 4) dot4<T, G>(xr, cen, cs, g0, gn, j, p);
      for (; j < j1; ++j) {
        const float xv = load_f(xr + j);
#pragma unroll
        for (int t = 0; t < G; ++t)
          if (t < gn) p[t] = fmaf(xv, cen[(g0 + t) * cs + j], p[t]);
      }
    }
    if (part > 0) {
#pragma unroll
      for (int t = 0; t < G; ++t)
        red[((part - 1) * kMaxGroup + t) * kTile + li] = p[t];
    }
    __syncthreads();
    if (part == 0 && i < rows) {
#pragma unroll
      for (int t = 0; t < G; ++t) {
        if (t < gn) {
          float s = p[t];
          for (int q = 1; q < kParts; ++q)
            s += red[((q - 1) * kMaxGroup + t) * kTile + li];
          epi(i, t, s);
        }
      }
    }
    __syncthreads();
  }
}

// row_dots with the register group sized to the centers it takes.
template <typename T, typename Epi>
__device__ void row_dots_any(const T* rowp, long long stride, int rows,
                             const float* cen, int cs, int g0, int gn, int d,
                             float* red, Epi epi) {
  if (gn <= 4)
    row_dots<T, 4>(rowp, stride, rows, cen, cs, g0, gn, d, red, epi);
  else if (gn <= 8)
    row_dots<T, 8>(rowp, stride, rows, cen, cs, g0, gn, d, red, epi);
  else if (gn <= 12)
    row_dots<T, 12>(rowp, stride, rows, cen, cs, g0, gn, d, red, epi);
  else
    row_dots<T, 16>(rowp, stride, rows, cen, cs, g0, gn, d, red, epi);
}

// Squared norms of rows [0, rows); warp per row, lanes over d.
template <typename T>
__device__ void row_norms(const T* rowp, long long stride, int rows, int d,
                          float* out) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < rows; i += kWarps) {
    float v = 0.f;
#pragma unroll 4
    for (int j = lane; j < d; j += 32) {
      const float xv = load_f(rowp + (long long)i * stride + j);
      v = fmaf(xv, xv, v);
    }
    v = warp_sum(v);
    if (lane == 0) out[i] = v;
  }
}

// st(e, ld(e)) for e in [0, count), the block's threads over e, each
// with N loads in flight before its first store: a copy out of global
// memory waits one memory latency per N elements a thread, not one per
// element.
constexpr int kFlight = 8;
// Partials of this many slices are read at once (one memory latency for
// a request of up to 16 slices).
constexpr int kSlices = 16;
template <typename V, int N = kFlight, typename Ld, typename St>
__device__ void batched(int count, Ld ld, St st) {
  for (int e0 = threadIdx.x; e0 < count; e0 += N * kThreads) {
    V v[N];
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = e0 + u * kThreads;
      if (e < count) v[u] = ld(e);
    }
#pragma unroll
    for (int u = 0; u < N; ++u) {
      const int e = e0 + u * kThreads;
      if (e < count) st(e, v[u]);
    }
  }
}

// Element w of a 16-byte vector of the storage type.
template <typename T>
__device__ __forceinline__ T lane_of(const uint4& v, int w);
template <>
__device__ __forceinline__ float lane_of<float>(const uint4& v, int w) {
  return __uint_as_float(w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w);
}
template <>
__device__ __forceinline__ __nv_bfloat16 lane_of<__nv_bfloat16>(
    const uint4& v, int w) {
  const int k = w >> 1;
  const unsigned u = k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
  return __ushort_as_bfloat16(
      static_cast<unsigned short>((w & 1) ? (u >> 16) : (u & 0xffffu)));
}

// Rows [0, rows) of a contiguous (rows, d) block of global memory into
// shared memory with row stride `xs`: 16-byte loads where the source is
// 16-byte aligned (scattered to the padded rows element by element),
// single elements for the rest.
template <typename T>
__device__ void stage_rows(T* dst, int xs, const T* src, int rows, int d) {
  constexpr int E = 16 / sizeof(T);
  const int total = rows * d;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    batched<uint4, 4>(
        total / E, [&](int v) { return s4[v]; },
        [&](int v, const uint4& val) {
          int i = v * E / d, j = v * E - i * d;
#pragma unroll
          for (int w = 0; w < E; ++w) {
            dst[i * xs + j] = lane_of<T>(val, w);
            if (++j == d) {
              j = 0;
              ++i;
            }
          }
        });
    done = total / E * E;
  }
  batched<T>(
      total - done, [&](int e) { return src[done + e]; },
      [&](int e, T val) {
        const int i = (done + e) / d;
        dst[i * xs + (done + e - i * d)] = val;
      });
}

// Squared norms of the kp centers; warp per center.
__device__ void center_norms(const float* cen, int cs, int kp, int d,
                             float* cn) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < kp; r += kWarps) {
    float v = 0.f;
    for (int j = lane; j < d; j += 32) v = fmaf(cen[r * cs + j],
                                                cen[r * cs + j], v);
    v = warp_sum(v);
    if (lane == 0) cn[r] = v;
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Barrier of the P blocks of one group: the counter reaches `target` once
// every block has arrived `target / P` times. The blocks are co-resident
// (cooperative launch), so a wait of seconds is a fault: it traps, and
// the launch fails loudly instead of hanging the card.
__device__ void group_barrier(unsigned* ctr, unsigned target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(ctr, 1u);
    const unsigned long long t0 = global_ns();
    while (*reinterpret_cast<volatile unsigned*>(ctr) < target) {
      if (global_ns() - t0 > 5000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// RES: x's slice resident in shared memory (else read from global memory
// on every pass); a template argument, so the loads of x know their
// address space.
template <typename T, bool RES>
__global__ void __launch_bounds__(kThreads, 1)
    solve_attach_kernel(Params q) {
  extern __shared__ __align__(16) float smem[];
  const int kp = q.kp, d = q.d, R = q.R, P = q.P, cs = q.cstride;
  const int kd = kp * d;
  float* cen = smem;                                   // (kp, cs)
  float* cn = cen + (size_t)kp * cs;                   // (kp)
  float* red = cn + round4(kp);                        // (3, 16, 64)
  float* tdist = red + (kParts - 1) * kMaxGroup * kTile;  // (16, 64)
  float* tn = tdist + kMaxGroup * kTd;                 // (64) tau norms
  float* xn = tn + kTile;                              // (R)
  float* bd = xn + round4(R);                          // (R) best dist
  int32_t* a = reinterpret_cast<int32_t*>(bd + round4(R));  // (R)
  int32_t* bi = a + round4(R);                         // (R) best center
  int32_t* list = bi + round4(R);                      // (R) rows by center
  int32_t* pml = list + round4(R);                     // (R) point mask
  int32_t* cml = pml + round4(R);                      // (kp) center mask
  int32_t* cnt = cml + round4(kp);                     // (kp)
  int32_t* start = cnt + round4(kp);                   // (kp)
  int32_t* fill = start + round4(kp);                  // (kp)
  int32_t* ctr = fill + round4(kp);                    // (kp) tau labels
  float* tbest = reinterpret_cast<float*>(ctr + round4(kp));  // (kp)
  T* xs = reinterpret_cast<T*>(tbest + round4(kp));    // (R, xstride)

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = blockIdx.x / P, p = blockIdx.x % P;
  const int row0 = p * R;
  const int rows = max(0, min(R, q.n - row0));
  const T* xg = static_cast<const T*>(q.x);
  const T* c0g = static_cast<const T*>(q.c0);
  const T* taug = static_cast<const T*>(q.tau);
  float* part = q.part + (size_t)g * 2 * P * kd;
  int32_t* pcnt = q.pcnt + (size_t)g * 2 * P * (kp + 1);
  float* newc = q.newc + (size_t)g * kd;
  float* cand = q.cand + (size_t)g * 2 * P * 2 * kp;
  unsigned* bar = q.bar + g;
  unsigned nbar = 0;  // barriers this block has passed
  int pb = 0;         // parity of the step: which scratch half
  int ab = 0;         // parity of the request: which candidate half

  for (int b = g; b < q.B; b += q.groups) {
    const T* xb = xg + ((long long)b * q.n + row0) * d;
    const T* rowp = RES ? xs : xb;
    const long long rstride = RES ? q.xstride : d;
    if (RES) stage_rows(xs, q.xstride, xb, rows, d);
    for (int e = tid; e < kp * cs; e += kThreads) cen[e] = 0.f;
    __syncthreads();
    batched<float>(
        kd, [&](int e) { return load_f(c0g + (long long)b * kd + e); },
        [&](int e, float v) { cen[e / d * cs + e % d] = v; });
    for (int r = tid; r < kp; r += kThreads)
      cml[r] = q.cm[(long long)b * kp + r];
    for (int i = tid; i < rows; i += kThreads) {
      pml[i] = q.pm[(long long)b * q.n + row0 + i];
      a[i] = -2;
    }
    __syncthreads();
    row_norms(rowp, rstride, rows, d, xn);
    center_norms(cen, cs, kp, d, cn);
    __syncthreads();

    // Nearest center of each row; returns whether a row changed (block).
    auto assign = [&]() {
      for (int i = tid; i < rows; i += kThreads) {
        bd[i] = inf_f();
        bi[i] = 0;
      }
      __syncthreads();
      for (int g0 = 0; g0 < kp; g0 += kMaxGroup) {
        const int gn = min(kMaxGroup, kp - g0);
        row_dots_any<T>(rowp, rstride, rows, cen, cs, g0, gn, d, red,
                        [&](int i, int t, float dot) {
                          const int r = g0 + t;
                          float dist = fmaxf(xn[i] - 2.f * dot + cn[r], 0.f);
                          if (cml[r] == 0) dist = kMaskedDist;
                          if (dist < bd[i]) {
                            bd[i] = dist;
                            bi[i] = r;
                          }
                        });
      }
      int changed = 0;
      for (int i = tid; i < rows; i += kThreads) {
        const int ai = pml[i] ? bi[i] : -1;
        changed |= (a[i] != ai);
        a[i] = ai;
      }
      return __syncthreads_or(changed);
    };

    bool fresh = false;  // a and bd hold the assignment to `cen`
    for (int it = 0; it < q.max_iters; ++it) {
      const int changed = assign();
      fresh = true;

      // Stable sort of the live rows by center (warp 0), then each
      // center's rows summed in row order: the slice's partials.
      if (warp == 0) {
        for (int r = lane; r < kp; r += 32) cnt[r] = 0;
        __syncwarp();
        for (int i0 = 0; i0 < rows; i0 += 32) {
          const int ai = i0 + lane < rows ? a[i0 + lane] : -1;
          const unsigned m = __match_any_sync(0xffffffffu, ai);
          if (ai >= 0 && lane == __ffs(m) - 1) cnt[ai] += __popc(m);
          __syncwarp();
        }
        if (lane == 0) {
          int s = 0;
          for (int r = 0; r < kp; ++r) {
            start[r] = fill[r] = s;
            s += cnt[r];
          }
        }
        __syncwarp();
        for (int i0 = 0; i0 < rows; i0 += 32) {
          const int ai = i0 + lane < rows ? a[i0 + lane] : -1;
          const unsigned m = __match_any_sync(0xffffffffu, ai);
          if (ai >= 0)
            list[fill[ai] + __popc(m & ((1u << lane) - 1u))] = i0 + lane;
          __syncwarp();
          if (ai >= 0 && lane == __ffs(m) - 1) fill[ai] += __popc(m);
          __syncwarp();
        }
      }
      __syncthreads();
      // Entry (r, j) of the slice's sums: center r's rows in row order.
      auto slice_sum = [&](int r, int j) {
        float s = 0.f;
        for (int t0 = start[r], t1 = start[r] + cnt[r]; t0 < t1; t0 += 8) {
          float v[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            v[u] = t0 + u < t1 ? load_f(rowp + list[t0 + u] * rstride + j)
                               : 0.f;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            if (t0 + u < t1) s += v[u];
        }
        return s;
      };
      if (P == 1) {
        // A request of one slice: its sums are the request's, and the
        // new centers go straight into shared memory (the same
        // arithmetic as below with one partial), with no scratch.
        if (!changed) {
          pb ^= 1;
          break;
        }
        for (int e = tid; e < kd; e += kThreads) {
          const int r = e / d, j = e - r * d;
          const float s = slice_sum(r, j);
          if (cnt[r] > 0)
            cen[r * cs + j] = round_store<T>(s / fmaxf((float)cnt[r], 1.f));
        }
        __syncthreads();
        center_norms(cen, cs, kp, d, cn);
        __syncthreads();
        fresh = false;
        pb ^= 1;
        continue;
      }
      float* mine = part + ((size_t)pb * P + p) * kd;
      for (int e = tid; e < kd; e += kThreads)
        mine[e] = slice_sum(e / d, e % d);
      int32_t* mc = pcnt + ((size_t)pb * P + p) * (kp + 1);
      for (int r = tid; r < kp; r += kThreads) mc[r] = cnt[r];
      if (tid == 0) mc[kp] = changed;

      group_barrier(bar, ++nbar * (unsigned)P);
      // The request's counts (thread r < k') and whether a row of any
      // slice changed (thread k'), the P slices read at once.
      const int32_t* pc = pcnt + (size_t)pb * P * (kp + 1);
      int any = 0;
      for (int r = tid; r <= kp; r += kThreads) {
        int c = 0;
        for (int s0 = 0; s0 < P; s0 += kSlices) {
          int v[kSlices];
#pragma unroll
          for (int u = 0; u < kSlices; ++u)
            v[u] = s0 + u < P ? __ldcg(pc + (s0 + u) * (kp + 1) + r) : 0;
#pragma unroll
          for (int u = 0; u < kSlices; ++u) c += v[u];
        }
        if (r < kp) cnt[r] = c;
        else any = c;
      }
      if (!__syncthreads_or(any)) {
        pb ^= 1;
        break;  // no row moved: this step's centers equal the last ones
      }

      // Block p's share of the new centers, the P partials summed in
      // slice order.
      const float* ps = part + (size_t)pb * P * kd;
      const int e0 = (int)((long long)kd * p / P);
      const int e1 = (int)((long long)kd * (p + 1) / P);
      for (int e = e0 + tid; e < e1; e += kThreads) {
        float s = 0.f;
        for (int s0 = 0; s0 < P; s0 += kSlices) {
          float v[kSlices];
#pragma unroll
          for (int u = 0; u < kSlices; ++u)
            v[u] = s0 + u < P ? __ldcg(ps + (size_t)(s0 + u) * kd + e) : 0.f;
#pragma unroll
          for (int u = 0; u < kSlices; ++u)
            if (s0 + u < P) s = (s0 + u == 0) ? v[u] : s + v[u];
        }
        const int r = e / d, j = e - r * d;
        const int c = cnt[r];
        newc[e] = c > 0 ? round_store<T>(s / fmaxf((float)c, 1.f))
                        : cen[r * cs + j];
      }
      group_barrier(bar, ++nbar * (unsigned)P);
      batched<float>(
          kd, [&](int e) { return __ldcg(newc + e); },
          [&](int e, float v) { cen[e / d * cs + e % d] = v; });
      __syncthreads();
      center_norms(cen, cs, kp, d, cn);
      __syncthreads();
      fresh = false;
      pb ^= 1;
    }
    if (!fresh) assign();  // the last step moved the centers

    // Theorem 3.2 attach: the nearest tau row of each center, ties to the
    // smaller index. Block p takes tau rows [k p / P, k (p + 1) / P),
    // staged 64 at a time, and writes its first minimum of each center;
    // after a barrier every block takes the first minimum over the P
    // candidates in block order. The candidates are double-buffered by
    // request, as the partials are by step.
    for (int r = tid; r < kp; r += kThreads) {
      tbest[r] = inf_f();
      ctr[r] = 0;
    }
    const int qa = (int)((long long)q.k * p / P);
    const int qb = (int)((long long)q.k * (p + 1) / P);
    for (int q0 = qa; q0 < qb; q0 += kTile) {
      const int nq = min(kTile, qb - q0);
      const T* tp = taug + (long long)q0 * d;
      const T* trows = RES ? xs : tp;
      const long long tstride = RES ? q.xstride : d;
      __syncthreads();
      if (RES) stage_rows(xs, q.xstride, tp, nq, d);
      __syncthreads();
      row_norms(trows, tstride, nq, d, tn);
      __syncthreads();
      for (int g0 = 0; g0 < kp; g0 += kMaxGroup) {
        const int gn = min(kMaxGroup, kp - g0);
        row_dots_any<T>(trows, tstride, nq, cen, cs, g0, gn, d, red,
                        [&](int i, int t, float dot) {
                          tdist[t * kTd + i] =
                              fmaxf(cn[g0 + t] - 2.f * dot + tn[i], 0.f);
                        });
        for (int t = tid; t < gn; t += kThreads) {
          float best = tbest[g0 + t];
          int bq = ctr[g0 + t];
          for (int i = 0; i < nq; ++i) {
            if (tdist[t * kTd + i] < best) {
              best = tdist[t * kTd + i];
              bq = q0 + i;
            }
          }
          tbest[g0 + t] = best;
          ctr[g0 + t] = bq;
        }
        __syncthreads();
      }
    }
    if (P > 1) {
      float* cb = cand + (size_t)ab * P * 2 * kp;
      for (int r = tid; r < kp; r += kThreads) {
        __stcg(cb + (p * kp + r) * 2, tbest[r]);
        __stcg(cb + (p * kp + r) * 2 + 1, __int_as_float(ctr[r]));
      }
      group_barrier(bar, ++nbar * (unsigned)P);
      for (int r = tid; r < kp; r += kThreads) {
        float best = inf_f();
        int bq = 0;
        for (int s0 = 0; s0 < P; s0 += kSlices) {
          float dv[kSlices], iv[kSlices];
#pragma unroll
          for (int u = 0; u < kSlices; ++u) {
            const float* c = cb + ((s0 + u) * kp + r) * 2;
            dv[u] = s0 + u < P ? __ldcg(c) : inf_f();
            iv[u] = s0 + u < P ? __ldcg(c + 1) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kSlices; ++u) {
            if (dv[u] < best) {
              best = dv[u];
              bq = __float_as_int(iv[u]);
            }
          }
        }
        ctr[r] = bq;
      }
      ab ^= 1;
    }
    __syncthreads();
    for (int r = tid; r < kp; r += kThreads)
      if (cml[r] == 0) ctr[r] = -1;
    __syncthreads();

    // Definition 3.3 induced labels and the outputs.
    for (int i = tid; i < rows; i += kThreads) {
      const long long o = (long long)b * q.n + row0 + i;
      const int ai = a[i];
      q.labels[o] = ai >= 0 ? ctr[ai] : -1;
      q.mind[o] = pml[i] ? bd[i] : 0.f;
    }
    if (p == 0) {
      for (int e = tid; e < kd; e += kThreads) {
        const int r = e / d, j = e - r * d;
        q.centers[(long long)b * kd + e] = cen[r * cs + j];
      }
      for (int r = tid; r < kp; r += kThreads)
        q.clbl[(long long)b * kp + r] = ctr[r];
    }
    __syncthreads();
  }
}

// The launch plan of one request shape on the current device: rows a
// slice holds (R), slices a request takes (P), resident or streaming,
// shared memory a block takes, blocks co-resident on one SM, SMs, and the
// card's per-block limit. Returns a cudaError_t.
template <typename T>
void (*kernel_of(bool resident))(Params) {
  if (resident) return solve_attach_kernel<T, true>;
  return solve_attach_kernel<T, false>;
}

template <typename T>
cudaError_t plan(int n, int kp, int d, long long* out) {
  const int esize = sizeof(T);
  int dev = 0, sms = 0, limit = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  for (int res = 0; res < 2 && err == cudaSuccess; ++res)
    err = cudaFuncSetAttribute(kernel_of<T>(res == 1),
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               limit);
  if (err != cudaSuccess) return err;
  long long R = kRows;
  bool resident = block_bytes(kRows, kp, d, esize, true) <= (size_t)limit;
  size_t bytes = block_bytes(kRows, kp, d, esize, resident);
  int per_sm = 0;
  if (bytes <= (size_t)limit) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel_of<T>(resident), kThreads, bytes);
    if (err != cudaSuccess) return err;
    const long long cap = (long long)per_sm * sms;
    if (cap > 0 && (n + R - 1) / R > cap) {
      // More slices than can be co-resident: stream larger slices.
      R = ((n + cap - 1) / cap + kTile - 1) / kTile * kTile;
      resident = false;
      bytes = block_bytes((int)R, kp, d, esize, false);
      per_sm = 0;
      if (bytes <= (size_t)limit) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel_of<T>(false), kThreads, bytes);
        if (err != cudaSuccess) return err;
      }
    }
  }
  out[0] = R;
  out[1] = n > 0 ? (n + R - 1) / R : 1;
  out[2] = resident ? 1 : 0;
  out[3] = (long long)bytes;
  out[4] = per_sm;
  out[5] = sms;
  out[6] = limit;
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* c0, const void* tau,
                   const void* cmask, const void* pmask, void* labels,
                   void* mind, void* centers, void* clbl, void* part,
                   void* newc, void* cand, void* ints, int B, int n, int kp,
                   int k,
                   int d, int max_iters, int R, int P, int resident,
                   long long bytes, int groups, cudaStream_t stream) {
  Params q;
  q.x = x;
  q.c0 = c0;
  q.tau = tau;
  q.cm = static_cast<const uint8_t*>(cmask);
  q.pm = static_cast<const uint8_t*>(pmask);
  q.labels = static_cast<int32_t*>(labels);
  q.mind = static_cast<float*>(mind);
  q.centers = static_cast<float*>(centers);
  q.clbl = static_cast<int32_t*>(clbl);
  q.part = static_cast<float*>(part);
  q.newc = static_cast<float*>(newc);
  q.cand = static_cast<float*>(cand);
  q.bar = static_cast<unsigned*>(ints);
  q.pcnt = static_cast<int32_t*>(ints) + groups;
  q.B = B;
  q.n = n;
  q.kp = kp;
  q.k = k;
  q.d = d;
  q.max_iters = max_iters;
  q.R = R;
  q.P = P;
  q.groups = groups;
  q.xstride = x_stride(d, sizeof(T));
  q.cstride = round4(d);
  void* args[] = {&q};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel_of<T>(resident != 0)),
      dim3(groups * P), dim3(kThreads), args, (size_t)bytes, stream);
}

}  // namespace
}  // namespace repro_torch

// The plan of a request of n points, k' centers and d features on the
// current device (bf16: storage type), into out[7]: R, P, resident (1) or
// streaming (0), shared memory bytes a block takes, blocks co-resident on
// one SM at that size (0 if it exceeds the limit), SMs, and the card's
// per-block shared memory limit. Returns the cudaError_t.
extern "C" int solve_attach_plan(int n, int kp, int d, int bf16,
                                 long long* out) {
  return (int)(bf16 ? repro_torch::plan<__nv_bfloat16>(n, kp, d, out)
                    : repro_torch::plan<float>(n, kp, d, out));
}

// The name of a cudaError_t, for the wrapper's messages.
extern "C" const char* solve_attach_error_name(int err) {
  return cudaGetErrorName(static_cast<cudaError_t>(err));
}

// C interface (loaded with ctypes). part: groups * ((2 P + 1) k' d +
// 4 P k') floats; ints: groups * (1 + 2 P (k' + 1)) int32, zero. Returns
// the cudaError_t of the cooperative launch.
extern "C" int solve_attach_f32(const void* x, const void* c0,
                                const void* tau, const void* cmask,
                                const void* pmask, void* labels, void* mind,
                                void* centers, void* clbl, void* part,
                                void* ints, int B, int n, int kp, int k,
                                int d, int max_iters, int R, int P,
                                int resident, long long bytes, int groups,
                                void* stream) {
  float* f = static_cast<float*>(part);
  float* newc = f + (size_t)groups * 2 * P * kp * d;
  return (int)repro_torch::launch<float>(
      x, c0, tau, cmask, pmask, labels, mind, centers, clbl, f, newc,
      newc + (size_t)groups * kp * d, ints, B, n, kp, k, d, max_iters, R, P,
      resident, bytes, groups, static_cast<cudaStream_t>(stream));
}

extern "C" int solve_attach_bf16(const void* x, const void* c0,
                                 const void* tau, const void* cmask,
                                 const void* pmask, void* labels, void* mind,
                                 void* centers, void* clbl, void* part,
                                 void* ints, int B, int n, int kp, int k,
                                 int d, int max_iters, int R, int P,
                                 int resident, long long bytes, int groups,
                                 void* stream) {
  float* f = static_cast<float*>(part);
  float* newc = f + (size_t)groups * 2 * P * kp * d;
  return (int)repro_torch::launch<__nv_bfloat16>(
      x, c0, tau, cmask, pmask, labels, mind, centers, clbl, f, newc,
      newc + (size_t)groups * kp * d, ints, B, n, kp, k, d, max_iters, R, P,
      resident, bytes, groups, static_cast<cudaStream_t>(stream));
}
