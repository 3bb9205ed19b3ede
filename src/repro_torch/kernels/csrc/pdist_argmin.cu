// Fused squared distance + argmin: the nearest center of every point.
//
// Replaces: repro/kernels/pdist_argmin.py, the Pallas kernel `_kernel`
// launched by `_pairwise_argmin` (public entry `pairwise_argmin`).
//
// Computes, for x (B, n, d) and centers c (B, k, d) or a shared (k, d),
//   dist(i, r) = max(||x_i||^2 - 2 x_i.c_r + ||c_r||^2, 0)
// with a masked center's distance set to exactly MASKED_DIST, and returns
// idx (B, n) int32 / min dist (B, n) f32. Ties go to the smallest center
// index. Accumulation is IEEE f32 on the CUDA cores (no TF32, no tensor
// cores); bf16 storage is widened to f32 when read from shared memory.
//
// What bounds it on an H100: 2k flops per x element against the card's
// f32 ridge of 67 TFLOP/s over 3.35 TB/s = 20 flop/byte. At the paths'
// k' = 10 shapes (the round's (50, 400, 300), a serve batch's
// (8, 1024, 300), the routed (64, 64, 128) at k' = 4) reading x once from
// HBM is the bound: 7.4 / 3.0 / 0.7 us. At k = 100 (the server's 500
// uploaded centers, the Theorem 3.2 attach of (50, 10, 300), the serve
// refresh's 10240 fold slots) the f32 FMA rate is: 0.45 / 0.45 / 9.3 us.
// Below about 10 us the launch (about 2 us) and each block's chain of
// copy latency, shared-memory reads and barriers set the time.
//
// Design (`make_plan` below picks R, S, F and TK from shape and card):
// - A block owns R consecutive rows. When c is shared the rows of all
//   batch entries are one flat (B n) axis, so 500 rows spread like 500
//   rows whatever their batch; with per-entry centers a block's rows lie
//   in one entry. R is the largest of 32..1 that still gives a block to
//   a third of the SMs, so the grid covers the card at every path shape.
// - x is read once: the block's R rows and its centers are copied whole
//   into shared memory with cp.async (16-byte copies in f32, 8-byte in
//   bf16; plain loads where d is not a multiple of 4 or a base is not
//   aligned), all issued before one wait, so every copy is in flight at
//   once. Rows are kept in their global order with a row stride whose
//   count of 4-element groups is odd, so the 16-byte reads of 8 lanes on
//   8 rows hit 8 distinct bank groups. The mask of the block's centers
//   is copied beside them.
// - Thread (r, s, f) keeps a register tile of TK dot products (TK in
//   {4, 8, 10}, the one that pads k least: 10 for k' = 10 and k = 100, 4
//   for k' = 4) of row r with center slice s over feature part f. Each
//   step reads 4 features of its row (distinct per lane) and of each of
//   its TK centers (a broadcast across the lanes of a slice), 4 TK FMAs,
//   added to the running sums as one term per 4 features (a quarter of
//   the roundings of a plain FMA chain).
//   The slices of a block are padded apart so the slices of a warp read
//   distinct bank groups. F feature parts give a block about 256 such
//   threads where R S alone is small.
// - Whole warps after them take the center norms while the dot products
//   run, one thread a center, in the same parts and order as the dot
//   products and the row norms: a row equal to a center (the server's
//   seeds are some of its rows) is at a distance of exactly 0. No thread
//   walks a center on the critical path.
// - The F partial sums are added in part order with Kahan's
//   compensation, and the distance takes the sums and their
//   compensations apart: (|x|^2 - 2 x.c + |c|^2) of the sums minus the
//   same of the compensations, so that rounding the three sums of d
//   terms before they cancel costs no more than the distance's own
//   rounding (the server's rows lie close to their seeds). Where the
//   plan has one part (F = 1: under 64 features, or 128 and more row and
//   slice threads) the part is the whole row, so its running sums of d / 4
//   terms are themselves added under Kahan's compensation (the norm
//   threads' too, in the same order), and the compensations enter the
//   distance as those of the parts do. The TK
//   distances of a slice are scanned in index order, and the S slices (then the center
//   groups, where k does not fit at once) are merged in slice order, all
//   with a strict `<`: the first minimum wins, so ties go to the smallest
//   index. Duplicated centers give bit-identical distances.

#include <algorithm>

#include "common.cuh"

namespace repro_torch {
namespace {

struct Shape {
  int n, k, d;       // rows per batch entry, centers, features
  int rows_per;      // rows of one tile axis: n, or B n with shared c
  int tiles;         // blocks along one tile axis
  int R, S, F, G;    // rows, slices, feature parts, 4-groups per part
  int XP, CP, SP;    // x row stride, center row stride, slice stride
  int groups;        // center groups staged one after another
  int workers;       // threads of the dot products (R S F, whole warps)
  int norm_threads;  // threads after them that take the center norms
  int vec;           // 4-element async copies (else plain loads)
  int alias;         // partial sums reuse the x / center buffers
  long long c_bstride, m_bstride;
};

struct Layout {
  size_t xs, cs, red, cn, mk, mv, mi, total;
};

__host__ __device__ inline size_t up16(size_t v) {
  return (v + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the block's shared buffers: x rows, centers, partial
// sums (over the x / center buffers when one center group suffices),
// center norms, the centers' mask, and each slice's best (value, index)
// per row.
__host__ __device__ inline Layout layout(int R, int S, int F, int TK, int XP,
                                         int SP, int esize, bool alias) {
  Layout L;
  L.xs = 0;
  L.cs = up16(static_cast<size_t>(R) * XP * esize);
  size_t end = L.cs + up16(static_cast<size_t>(S) * SP * esize);
  const size_t red = up16(static_cast<size_t>(R) * S * F * (TK + 1) * 4);
  if (alias) {
    L.red = 0;
    end = end > red ? end : red;
  } else {
    L.red = end;
    end += red;
  }
  L.cn = end;  // each center's norm and its compensation
  end += up16(static_cast<size_t>(S) * TK * 8);
  L.mk = end;
  end += up16(static_cast<size_t>(S) * TK);
  L.mv = end;
  end += up16(static_cast<size_t>(S) * R * 4);
  L.mi = end;
  end += up16(static_cast<size_t>(S) * R * 4);
  L.total = end;
  return L;
}

// The dot product of 4 features, as one term of a running sum: the
// terms of a part are added one after another, so a sum over d features
// takes d / 4 roundings on the accumulator instead of d. Row norms,
// center norms and dot products all use it, so equal inputs give equal
// sums.
__device__ __forceinline__ float dot4(float4 a, float4 b) {
  float p = __fmul_rn(a.x, b.x);
  p = fmaf(a.y, b.y, p);
  p = fmaf(a.z, b.z, p);
  return fmaf(a.w, b.w, p);
}

// s + v with Kahan's compensation c (the sum is s - c): the rounding
// error of each addition is carried into the next.
__device__ __forceinline__ void kahan_add(float& s, float& c, float v) {
  const float y = __fsub_rn(v, c);
  const float t = __fadd_rn(s, y);
  c = __fsub_rn(__fsub_rn(t, s), y);
  s = t;
}

// Four consecutive elements in shared memory, widened to f32.
__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 lds4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

// Asynchronous copy of 4 elements, global -> shared.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// Copy `rows` rows of d elements (global row stride d) into shared rows:
// row t lands at dst + (t / per) * outer + (t % per) * inner, padded with
// zeros up to a multiple of 4 elements. Copies are only issued here; the
// caller waits.
template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* src, int rows, int d,
                                      int per, int outer, int inner,
                                      bool vec, int tid, int nthreads) {
  const int d4 = (d + 3) >> 2;
  if (vec) {
    const int total = rows * d4;
    for (int e = tid; e < total; e += nthreads) {
      const int t = e / d4, g = e - t * d4;
      cp_async4(dst + (t / per) * outer + (t % per) * inner + 4 * g,
                src + static_cast<long long>(t) * d + 4 * g);
    }
  } else {
    const int w = 4 * d4;
    const int total = rows * w;
    for (int e = tid; e < total; e += nthreads) {
      const int t = e / w, j = e - t * w;
      dst[(t / per) * outer + (t % per) * inner + j] =
          j < d ? src[static_cast<long long>(t) * d + j] : zero_of<T>();
    }
  }
}

// Parts of a center's norm that one norm thread sums at once, each its
// own running sum (independent chains).
constexpr int kNormIlp = 4;

// KC: the plan has one feature part, whose running sums are compensated.
template <typename T, int TK, bool KC>
__global__ void __launch_bounds__(512) pdist_argmin_kernel(
    const T* __restrict__ x, const T* __restrict__ c,
    const uint8_t* __restrict__ cmask, int32_t* __restrict__ idx_out,
    float* __restrict__ val_out, Shape p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = p.R, S = p.S, F = p.F;
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int r = tid % R, s = (tid / R) % S, f = tid / (R * S);
  const bool worker = tid < R * S * F;

  const int b = blockIdx.x / p.tiles;
  const long long fr0 = static_cast<long long>(b) * p.rows_per +
                        static_cast<long long>(blockIdx.x % p.tiles) * R;
  const int nr = static_cast<int>(
      min(static_cast<long long>(R),
          static_cast<long long>(b) * p.rows_per + p.rows_per - fr0));
  const long long row = fr0 + r;
  const bool live = r < nr;
  const T* cb = c + b * p.c_bstride;
  // One mask row for the whole block, unless shared centers meet a mask
  // of one row per batch entry (then each row reads its own).
  const bool block_mask =
      cmask != nullptr && (p.c_bstride != 0 || p.m_bstride == 0);
  const uint8_t* mb = block_mask ? cmask + b * p.m_bstride : nullptr;

  const Layout L = layout(R, S, F, TK, p.XP, p.SP, sizeof(T), p.alias);
  T* xs = reinterpret_cast<T*>(smem + L.xs);
  T* cs = reinterpret_cast<T*>(smem + L.cs);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* cn = reinterpret_cast<float*>(smem + L.cn);
  uint8_t* mk = reinterpret_cast<uint8_t*>(smem + L.mk);
  float* mv = reinterpret_cast<float*>(smem + L.mv);
  int* mi = reinterpret_cast<int*>(smem + L.mi);

  const int d4 = (p.d + 3) >> 2;
  const int g0 = f * p.G, g1 = min(g0 + p.G, d4);

  float best = inf_f();
  int besti = 0;
  stage(xs, x + fr0 * p.d, nr, p.d, 1, p.XP, 0, p.vec, tid, nthreads);
  for (int grp = 0; grp < p.groups; ++grp) {
    const int k0 = grp * S * TK;
    const int nc = min(S * TK, p.k - k0);
    if (grp > 0) __syncthreads();  // the last group's reads are done
    stage(cs, cb + static_cast<long long>(k0) * p.d, nc, p.d, TK, p.SP, p.CP,
          p.vec, tid, nthreads);
    if (mb != nullptr)
      for (int t = tid; t < nc; t += nthreads) mk[t] = mb[k0 + t];
    cp_async_wait_all();
    __syncthreads();

    float acc[TK], accc[TK];
#pragma unroll
    for (int t = 0; t < TK; ++t) acc[t] = accc[t] = 0.f;
    float xq = 0.f, xqc = 0.f;
    if (worker && live) {
      const T* xr = xs + r * p.XP;
      const T* cr = cs + s * p.SP;
#pragma unroll 2
      for (int g = g0; g < g1; ++g) {
        const float4 xv = lds4(xr + 4 * g);
        if (KC) kahan_add(xq, xqc, dot4(xv, xv));
        else xq = __fadd_rn(xq, dot4(xv, xv));
#pragma unroll
        for (int t = 0; t < TK; ++t) {
          const float4 cv = lds4(cr + t * p.CP + 4 * g);
          if (KC) kahan_add(acc[t], accc[t], dot4(xv, cv));
          else acc[t] = __fadd_rn(acc[t], dot4(xv, cv));
        }
      }
    } else if (tid >= p.workers) {
      // The norm threads, while the dot products run: center t's norm
      // in the parts and the order of the dot products (and of the row
      // norms above), so a center equal to a row is at a distance of
      // exactly 0 from it.
      for (int t = tid - p.workers; t < nc; t += p.norm_threads) {
        const T* cr = cs + (t / TK) * p.SP + (t % TK) * p.CP;
        float sum = 0.f, comp = 0.f;
        for (int f0 = 0; f0 < F; f0 += kNormIlp) {
          float a[kNormIlp], ac[kNormIlp];
#pragma unroll
          for (int q = 0; q < kNormIlp; ++q) a[q] = ac[q] = 0.f;
          for (int g = 0; g < p.G; ++g) {
#pragma unroll
            for (int q = 0; q < kNormIlp; ++q) {
              const int h = (f0 + q) * p.G + g;
              if (f0 + q < F && h < d4) {
                const float4 v = lds4(cr + 4 * h);
                if (KC) kahan_add(a[q], ac[q], dot4(v, v));
                else a[q] = __fadd_rn(a[q], dot4(v, v));
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kNormIlp; ++q) {
            if (f0 + q == 0) {
              sum = a[q];
              comp = ac[q];
            } else if (f0 + q < F) {
              kahan_add(sum, comp, a[q]);
            }
          }
        }
        cn[2 * t] = sum;
        cn[2 * t + 1] = comp;
      }
    }
    // The partial sums overwrite x and the centers when aliased, and
    // the norms are read below: every thread is past both.
    __syncthreads();
    if (worker) {
      float* o = red + ((f * S + s) * R + r) * (TK + 1);
#pragma unroll
      for (int t = 0; t < TK; ++t) o[t] = acc[t];
      o[TK] = xq;
    }
    __syncthreads();

    if (tid < R * S && live) {  // f == 0: parts in order, then the slice
      // With one part this thread took the sums itself (f == 0), and
      // its compensations are still in registers.
      float dot[TK], dc[TK];
      const float* o = red + (s * R + r) * (TK + 1);
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        dot[t] = o[t];
        dc[t] = KC ? accc[t] : 0.f;
      }
      float xn = o[TK], xc = KC ? xqc : 0.f;
      for (int ff = 1; ff < F; ++ff) {
        const float* q = red + ((ff * S + s) * R + r) * (TK + 1);
#pragma unroll
        for (int t = 0; t < TK; ++t) kahan_add(dot[t], dc[t], q[t]);
        kahan_add(xn, xc, q[TK]);
      }
      const uint8_t* mrow =
          cmask == nullptr ? nullptr
          : block_mask     ? mk - k0
                           : cmask + (row / p.n) * p.m_bstride;
      float bv = inf_f();
      int bi = 0;
#pragma unroll
      for (int t = 0; t < TK; ++t) {
        const int gt = k0 + s * TK + t;
        if (gt < p.k) {
          const float* ct = cn + 2 * (s * TK + t);
          const float hi = __fadd_rn(__fmaf_rn(-2.f, dot[t], xn), ct[0]);
          const float lo = __fadd_rn(__fmaf_rn(-2.f, dc[t], xc), ct[1]);
          float dist = fmaxf(__fsub_rn(hi, lo), 0.f);
          if (mrow != nullptr && mrow[gt] == 0) dist = kMaskedDist;
          if (dist < bv) {
            bv = dist;
            bi = gt;
          }
        }
      }
      if (S == 1) {  // this thread is (r, 0, 0)
        if (bv < best) {
          best = bv;
          besti = bi;
        }
      } else {
        mv[s * R + r] = bv;
        mi[s * R + r] = bi;
      }
    }
    if (S > 1) {
      __syncthreads();
      if (tid < R && live) {
        for (int ss = 0; ss < S; ++ss) {
          const float v = mv[ss * R + r];
          if (v < best) {
            best = v;
            besti = mi[ss * R + r];
          }
        }
      }
    }
  }
  if (tid < R && live) {
    idx_out[row] = besti;
    val_out[row] = best;
  }
}

// The card, as the plan sees it.
struct Card {
  int sms;          // SMs
  int smem_limit;   // shared memory a block may opt in to
  int smem_per_sm;  // shared memory of one SM
};

constexpr int kMaxDevices = 64;

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
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &q.smem_per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, *dev);
    if (err != cudaSuccess) return err;
    cards[*dev] = q;
    known[*dev] = true;
  }
  *card = cards[*dev];
  return cudaSuccess;
}

// What make_plan may choose from.
constexpr int kTiles[] = {10, 8, 4};            // register tiles, larger first
constexpr int kRows[] = {32, 16, 8, 4, 2, 1};   // rows a block may take
constexpr int kWorkerThreads = 256;  // dot-product threads a block aims at
constexpr int kMaxWorkers = 384;     // rows x slices a block may take
constexpr int kMaxThreads = 512;     // threads a block may have
constexpr int kMaxSlices = 32;       // center slices a block takes at once
constexpr long long kCenterBytes = 144 * 1024;  // shared memory of centers

// One call's launch.
struct Plan {
  Shape p;
  int tk;            // centers in a thread's register tile
  long long blocks;  // blocks of the launch
  size_t smem;       // dynamic shared memory of a block
  int per_sm;        // blocks co-resident on one SM
};

inline int round_up(int v, int m) { return (v + m - 1) / m * m; }

// The launch for x (B, n, d) against k centers of d features, shared by
// every batch entry or not, stored `esize` bytes an element:
// - TK: of 10, 8 and 4, the tile that pads k least (the larger on a
//   tie): 10 at k' = 10 and k = 100, 4 at k' = 4.
// - S: all ceil(k / TK) slices at once where their centers fit in
//   kCenterBytes (at most kMaxSlices), else as many center groups as
//   needed, each of the same number of slices.
// - R: `rows` where it is not 0; else the largest of kRows that still
//   gives a block to at least a third of the SMs (else 1); then halved
//   until the block's shared memory fits. At k = 100 each block copies
//   in all the centers, so fewer, larger blocks read less from L2: R = 8
//   for the server's 500 rows.
// - F: enough feature parts for about kWorkerThreads threads, each part
//   at least 8 groups of 4 features.
// - Norm threads: whole warps after the workers, one thread a center
//   of the group (at most kMaxThreads in all); they take the center
//   norms while the workers take the dot products.
// Returns false where no block fits the card.
bool make_plan(int B, int n, int k, int d, bool shared, int esize, int rows,
               const Card& card, Plan* out) {
  if (B < 1 || n < 1 || k < 1 || d < 1) return false;
  Shape& p = out->p;
  p = Shape{};
  p.n = n;
  p.k = k;
  p.d = d;
  p.CP = round_up(d, 4);
  const int d4 = p.CP / 4;
  // Strides whose count of 4-element groups is odd (distinct bank groups).
  p.XP = d4 % 2 ? p.CP : p.CP + 4;
  auto slice_stride = [&](int tk) {
    return (tk * d4) % 2 ? tk * p.CP : tk * p.CP + 4;
  };
  int tk = 0;
  for (int t : kTiles) {
    const bool fits =
        static_cast<long long>(slice_stride(t)) * esize <= kCenterBytes;
    if (fits && (tk == 0 || round_up(k, t) < round_up(k, tk))) tk = t;
  }
  if (tk == 0) tk = kTiles[2];
  p.SP = slice_stride(tk);
  const int nsl = (k + tk - 1) / tk;
  const long long s_cap =
      kCenterBytes / (static_cast<long long>(p.SP) * esize);
  const int s_fit = static_cast<int>(std::max(
      1LL, std::min(static_cast<long long>(kMaxSlices), s_cap)));
  const int per_group = std::min(nsl, s_fit);
  p.groups = (nsl + per_group - 1) / per_group;
  p.S = (nsl + p.groups - 1) / p.groups;
  const long long rows_per = shared ? static_cast<long long>(B) * n : n;
  const long long entries = shared ? 1 : B;
  auto blocks = [&](int R) { return entries * ((rows_per + R - 1) / R); };
  int R = rows;
  if (R <= 0) {
    R = 1;
    for (int r : kRows) {
      if (r * p.S <= kMaxWorkers && 3 * blocks(r) >= card.sms) {
        R = r;
        break;
      }
    }
  }
  p.alias = p.groups == 1;
  size_t smem = 0;
  for (;;) {
    p.F = std::max(1, std::min(kWorkerThreads / (R * p.S), d4 / 8));
    smem = layout(R, p.S, p.F, tk, p.XP, p.SP, esize, p.alias).total;
    if (smem <= static_cast<size_t>(card.smem_limit) || R == 1) break;
    R /= 2;
  }
  if (smem > static_cast<size_t>(card.smem_limit)) return false;
  p.R = R;
  p.G = (d4 + p.F - 1) / p.F;
  p.workers = round_up(R * p.S * p.F, 32);
  p.norm_threads = 32 * std::max(1, std::min((p.S * tk + 31) / 32,
                                             (kMaxThreads - p.workers) / 32));
  const int threads = p.workers + p.norm_threads;
  if (threads > kMaxThreads) return false;
  if (rows_per > 0x7fffffffLL) return false;
  p.rows_per = static_cast<int>(rows_per);
  p.tiles = static_cast<int>((rows_per + R - 1) / R);
  out->tk = tk;
  out->blocks = blocks(R);
  out->smem = smem;
  out->per_sm = std::min({card.smem_per_sm / static_cast<int>(smem + 1024),
                          2048 / threads, 32});
  return true;
}

template <typename T, int TK, bool KC>
cudaError_t launch(const void* x, const void* c, const void* cmask, void* idx,
                   void* val, int dev, const Plan& pl, cudaStream_t stream) {
  // Shared memory a block may take, per device, once raised.
  static int raised[kMaxDevices] = {0};
  auto kernel = pdist_argmin_kernel<T, TK, KC>;
  const int smem = static_cast<int>(pl.smem);
  if (smem > 48 * 1024 && smem > raised[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    raised[dev] = smem;
  }
  kernel<<<static_cast<unsigned>(pl.blocks),
           pl.p.workers + pl.p.norm_threads, pl.smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(c),
      static_cast<const uint8_t*>(cmask), static_cast<int32_t*>(idx),
      static_cast<float*>(val), pl.p);
  return cudaGetLastError();
}

template <typename T, bool KC>
cudaError_t launch_tk(const void* x, const void* c, const void* cmask,
                      void* idx, void* val, int dev, const Plan& pl,
                      cudaStream_t stream) {
  switch (pl.tk) {
    case 4:
      return launch<T, 4, KC>(x, c, cmask, idx, val, dev, pl, stream);
    case 8:
      return launch<T, 8, KC>(x, c, cmask, idx, val, dev, pl, stream);
    case 10:
      return launch<T, 10, KC>(x, c, cmask, idx, val, dev, pl, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t run(const void* x, const void* c, const void* cmask, void* idx,
                void* val, int B, int n, int k, int d, long long c_bstride,
                long long m_bstride, int vec, int rows, cudaStream_t stream) {
  int dev = 0;
  Card card;
  cudaError_t err = current_card(&dev, &card);
  if (err != cudaSuccess) return err;
  Plan pl;
  if (!make_plan(B, n, k, d, c_bstride == 0, sizeof(T), rows, card, &pl))
    return cudaErrorInvalidValue;
  pl.p.c_bstride = c_bstride;
  pl.p.m_bstride = m_bstride;
  pl.p.vec = vec;
  return pl.p.F == 1 ? launch_tk<T, true>(x, c, cmask, idx, val, dev, pl,
                                          stream)
                     : launch_tk<T, false>(x, c, cmask, idx, val, dev, pl,
                                           stream);
}

}  // namespace
}  // namespace repro_torch

// C interface (loaded with ctypes). x: (B, n, d); c: batch stride
// c_bstride elements (0 = shared: the rows of all entries are one axis);
// cmask: uint8 (B or 1, k) with batch stride m_bstride, or null; vec: x
// and c may be copied 4 elements at a time (d a multiple of 4, bases
// aligned); rows: R of the plan, or 0 to let make_plan choose. Returns
// the cudaError_t of the launch (cudaErrorInvalidValue where no block
// fits the card).
extern "C" int pdist_argmin_f32(const void* x, const void* c,
                                const void* cmask, void* idx, void* val,
                                int B, int n, int k, int d,
                                long long c_bstride, long long m_bstride,
                                int vec, int rows, void* stream) {
  return (int)repro_torch::run<float>(x, c, cmask, idx, val, B, n, k, d,
                                      c_bstride, m_bstride, vec, rows,
                                      static_cast<cudaStream_t>(stream));
}

extern "C" int pdist_argmin_bf16(const void* x, const void* c,
                                 const void* cmask, void* idx, void* val,
                                 int B, int n, int k, int d,
                                 long long c_bstride, long long m_bstride,
                                 int vec, int rows, void* stream) {
  return (int)repro_torch::run<__nv_bfloat16>(
      x, c, cmask, idx, val, B, n, k, d, c_bstride, m_bstride, vec, rows,
      static_cast<cudaStream_t>(stream));
}

// The plan of a call on the current device, for reports and tests: out
// gets TK, R, S, F, center groups, blocks, threads a block, shared
// memory a block, blocks an SM and the card's SMs. Returns a cudaError_t
// (cudaErrorInvalidValue where no block fits the card).
extern "C" int pdist_argmin_plan(int B, int n, int k, int d, int shared,
                                 int bf16, int rows, long long* out) {
  int dev = 0;
  repro_torch::Card card;
  cudaError_t err = repro_torch::current_card(&dev, &card);
  if (err != cudaSuccess) return (int)err;
  repro_torch::Plan pl;
  if (!repro_torch::make_plan(B, n, k, d, shared != 0, bf16 ? 2 : 4, rows,
                              card, &pl))
    return (int)cudaErrorInvalidValue;
  const repro_torch::Shape& p = pl.p;
  const long long v[] = {pl.tk,      p.R,        p.S,
                         p.F,        p.groups,   pl.blocks,
                         p.workers + p.norm_threads,
                         static_cast<long long>(pl.smem),
                         pl.per_sm,  card.sms};
  for (int i = 0; i < 10; ++i) out[i] = v[i];
  return 0;
}
