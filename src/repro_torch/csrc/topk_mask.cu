// Sort-free top-k / top-p logit filter for Hopper (sm_90a), plain C
// interface.
//
// Replaces: src/repro/kernels/topk_mask.py::topk_topp_mask, the Pallas
// TPU kernel (def at line 94, pl.pallas_call at line 103).
//
// Computes, per row of logits [B, V] f32 with knobs k[b] (<= 0 disables)
// and p[b] (>= 1 disables), the keep-set of repro/kernels/ref.py
// topk_topp_mask_ref, and writes the kept logits and -1e30 elsewhere:
//   * top-k: a 4-round byte-radix descent over the monotone uint32 key
//     (-0.0 canonicalised to +0.0) finds the exact k-th largest key;
//     every value >= it is kept (ties keep all equal values);
//   * top-p on the top-k survivors: softmax, then the same descent over
//     probability mass finds the boundary key T and the mass strictly
//     above it; values above T are kept, and the tied run at T is split
//     in index order (rank r kept iff above + r * p_T < p).
//
// What bounds it on the card: device-memory bytes, one read of the row and
// one write (608 KB each way for a 152064-entry vocab).
//
// Design: one thread-block cluster of C CTAs per row (the wrapper's plan:
// the fewest CTAs, a power of two, whose slices fit 52 KB; C = 16 at
// qwen3-4b's vocab, a non-portable cluster size). CTA r copies slice r of
// the row from device memory into its shared memory once (cp.async);
// every later pass (4 radix rounds a filter, the softmax max and sum, the
// tie count, the output) reads shared memory only, and 8 rows keep 128
// SMs busy. Each warp owns a contiguous segment of its slice and reads it
// as float4s. Per pass, each warp builds its own histogram in shared
// memory, so no two warps contend for a bin: the lanes that fall in one
// bucket are found with 8 ballots (one per bucket bit) and their leader
// adds the group's count (or mass). Mass is held in fixed point (2^60
// units of probability, u64), so every histogram sum is exact and the
// same in any order; no float atomic is used anywhere. The warps' bins
// are summed into the CTA's histogram, and after cluster.sync() every CTA
// reads the C histograms through distributed shared memory (all C loads
// of a bin in flight at once) and decides the bucket itself, the same way
// in every CTA. The softmax max is exact, its sum is taken in a fixed
// order (lane, warp, then a fixed tree over ranks), and the tie rank is
// an exclusive count in index order across warps and CTAs, so the
// keep-set of a row is the same on every run. expf and the division are
// the precise ones (no --use_fast_math), and the tie test uses explicitly
// rounded multiply and add so nothing is contracted. Rows with both
// filters off are copied through with no pass at all.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 16;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;
constexpr float kFix = 0x1p60f;               // fixed-point unit of mass
constexpr float kUnfix = 0x1p-60f;

struct Shared {
  // read by the other CTAs of the cluster
  unsigned cnt[4][256];                       // top-k count histograms
  unsigned long long mass[4][256];            // top-p mass histograms
  float red_max[kWarps];
  float red_sum[kWarps];
  int ties[kWarps];
  // this CTA's own
  union {                                     // each warp's own histogram
    unsigned cnt[kWarps][256];
    unsigned long long mass[kWarps][256];
  } wh;
  unsigned long long scan64[8];
  unsigned scan32[8];
  unsigned char cond[256];
  int sel_j;
  unsigned sel_above;
  unsigned long long sel_mass;
  float mx, tot;
  int tie_base;
  unsigned long long stage[kWarps][32];       // mass_add's group sums
};
constexpr int kSharedBytes = (sizeof(Shared) + 15) / 16 * 16;
static_assert(kSharedBytes <= 50 * 1024, "kernels/topk_mask.py::SHARED_BYTES");

__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// The top-k survivor: x itself, or -1e30 when the radix select drops it.
__device__ __forceinline__ float top_k_value(float x, int k, unsigned kth) {
  return (k <= 0 || key_of(x) >= kth) ? x : kNegInf;
}

// Probability of a survivor. A dropped entry's exp(-1e30 - mx) is 0 for
// any row whose max is above -9.9e29, so it is not computed.
__device__ __forceinline__ float prob(float xv, float mx, float tot) {
  return xv == kNegInf ? 0.f : expf(xv - mx) / tot;
}

__device__ __forceinline__ float unfix(unsigned long long m) {
  return __ull2float_rn(m) * kUnfix;
}

// The lanes of `act` whose bucket is this lane's (8 ballots, no match).
__device__ __forceinline__ unsigned peers_of(unsigned bucket, unsigned act) {
  unsigned same = act;
#pragma unroll
  for (int bit = 0; bit < 8; ++bit) {
    const bool on = (bucket >> bit) & 1u;
    const unsigned bal = __ballot_sync(kFull, on);
    same &= on ? bal : ~bal;
  }
  return same;
}

// Distributed shared memory: the address of p in CTA `rank` of the
// cluster, and loads from it.
__device__ __forceinline__ unsigned map_rank(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"((unsigned)__cvta_generic_to_shared(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ unsigned ld_u32(unsigned a) {
  unsigned v;
  asm volatile("ld.shared::cluster.u32 %0, [%1];\n" : "=r"(v) : "r"(a));
  return v;
}
__device__ __forceinline__ unsigned long long ld_u64(unsigned a) {
  unsigned long long v;
  asm volatile("ld.shared::cluster.u64 %0, [%1];\n" : "=l"(v) : "r"(a));
  return v;
}

// Adds 1 per candidate lane to the warp's own hist[bucket]: one atomic
// per bucket group, none contended by another warp.
__device__ __forceinline__ void count_add(unsigned* hist, bool cand,
                                          unsigned bucket, int lane) {
  const unsigned act = __ballot_sync(kFull, cand);
  if (act == 0) return;                                   // warp-uniform
  if (__popc(act) <= 2) {
    if (cand) atomicAdd(&hist[bucket], 1u);
    return;
  }
  const unsigned same = peers_of(bucket, act);
  if (cand && lane == __ffs(same) - 1) atomicAdd(&hist[bucket], __popc(same));
}

// Adds each candidate lane's fixed-point mass to the warp's own
// hist[bucket]: the group leader sums its group through `stage` (the
// warp's 32 slots) and adds it; leaders hold distinct buckets.
__device__ __forceinline__ void mass_add(unsigned long long* hist,
                                         unsigned long long* stage, bool cand,
                                         unsigned bucket,
                                         unsigned long long m, int lane) {
  const unsigned act = __ballot_sync(kFull, cand);
  if (act == 0) return;                                   // warp-uniform
  const unsigned same = peers_of(bucket, act);
  stage[lane] = m;
  __syncwarp();
  if (cand && lane == __ffs(same) - 1) {
    unsigned long long s = 0;
    for (unsigned rest = same; rest; rest &= rest - 1) s += stage[__ffs(rest) - 1];
    hist[bucket] += s;
  }
  __syncwarp();
}

// Threads 0..255: bin j of the CTA's histogram is the sum of the warps'
// (integers: any order), which are cleared for the next pass.
template <typename U>
__device__ __forceinline__ void merge_warps(U* cta, U (*warps)[256],
                                            int tid) {
  if (tid < 256) {
    U s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      s += warps[w][tid];
      warps[w][tid] = 0;
    }
    cta[tid] = s;
  }
}

// One histogram bin summed over the cluster's C CTAs: every remote load
// is issued before the first is used.
template <typename U>
__device__ __forceinline__ U cluster_bin(const U* bin, int C) {
  U v[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) v[r] = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) {
    if (r < C) {
      if constexpr (sizeof(U) == 8)
        v[r] = ld_u64(map_rank(bin, r));
      else
        v[r] = ld_u32(map_rank(bin, r));
    }
  }
  U s = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r) s += v[r];
  return s;
}

template <typename U>
__device__ __forceinline__ U warp_incl_scan(U v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const U t = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += t;
  }
  return v;
}

// One pass over this warp's segment [lo, hi) of the slice: f(i, v) with
// v = xs[i .. i + 3], i = lo + 4 * lane + 128 * step. Every lane calls f
// in every step (f may use warp collectives) and must ignore i + j >= hi.
template <typename F>
__device__ __forceinline__ void each4(const float* xs, int lo, int hi,
                                      int lane, F&& f) {
  for (int i0 = lo; i0 < hi; i0 += 128) {
    const int i = i0 + 4 * lane;
    const float4 v = i < hi ? *reinterpret_cast<const float4*>(xs + i)
                            : make_float4(0.f, 0.f, 0.f, 0.f);
    f(i, v);
  }
}

// Lane r < n of a warp: rank r's per-warp values folded in warp order
// (its kWarps remote loads issued before the first is used); other lanes
// get `init`.
template <typename U, typename F>
__device__ __forceinline__ U fold_ranks(const U* per_warp, int n, int lane,
                                        U init, F&& f) {
  U v[kWarps];
  if (lane < n) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned bits = ld_u32(map_rank(per_warp + w, lane));
      if constexpr (std::is_same_v<U, float>)
        v[w] = __uint_as_float(bits);
      else
        v[w] = static_cast<U>(bits);
    }
  }
  U acc = init;
  if (lane < n) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc = f(acc, v[w]);
  }
  return acc;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Threads 0..255 (bucket j = 255 - tid): the bucket holding the krem-th
// largest candidate over the cluster's count histograms of `round`.
__device__ void decide_count(Shared& sh, int C,
                             int round, unsigned krem, int tid) {
  const int lane = tid & 31, warp = tid >> 5, j = 255 - tid;
  unsigned c = 0, incl = 0;
  if (tid < 256) {
    c = cluster_bin(&sh.cnt[round][j], C);
    incl = warp_incl_scan(c, lane);
    if (lane == 31) sh.scan32[warp] = incl;
  }
  __syncthreads();
  if (tid < 256) {
    for (int w = 0; w < warp; ++w) incl += sh.scan32[w];
    const unsigned above = incl - c;
    if (above < krem && krem <= incl) {
      sh.sel_j = j;
      sh.sel_above = above;
    }
  }
  __syncthreads();
}

// Threads 0..255: the lowest bucket whose mass above it (plus the mass
// above the prefix, above_fix) is < p, else bucket 0, as argmax does.
__device__ void decide_mass(Shared& sh, int C,
                            int round, unsigned long long above_fix, float p,
                            int tid) {
  const int lane = tid & 31, warp = tid >> 5, j = 255 - tid;
  unsigned long long m = 0, incl = 0, above = 0;
  bool cond = false;
  if (tid < 256) {
    m = cluster_bin(&sh.mass[round][j], C);
    incl = warp_incl_scan(m, lane);
    if (lane == 31) sh.scan64[warp] = incl;
  }
  __syncthreads();
  if (tid < 256) {
    for (int w = 0; w < warp; ++w) incl += sh.scan64[w];
    above = incl - m + above_fix;
    cond = unfix(above) < p;          // exact sums: monotone in j
    sh.cond[j] = cond;
  }
  __syncthreads();
  if (tid < 256 && (cond ? (j == 0 || !sh.cond[j - 1])
                         : (j == 0 && !sh.cond[255]))) {
    sh.sel_j = cond ? j : 0;
    sh.sel_mass = above;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) topk_topp_cluster_kernel(
    const float* __restrict__ logits, const int* __restrict__ ks,
    const float* __restrict__ ps, float* __restrict__ out, int V,
    int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  Shared& sh = *reinterpret_cast<Shared*>(smem);
  float* xs = reinterpret_cast<float*>(smem + kSharedBytes);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.y;
  const int start = rank * slice;
  const int n = max(0, min(slice, V - start));
  const float* x = logits + (size_t)row * V + start;
  float* o = out + (size_t)row * V + start;
  const int k = ks[row] >= V ? 0 : ks[row];     // k >= V keeps every entry
  const float p = ps[row];
  const bool vec = V % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(logits) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;

  if (k <= 0 && p >= 1.0f) {  // both filters off: copy through
    if (vec) {
      for (int i = 4 * tid; i < n; i += 4 * kThreads)
        *reinterpret_cast<float4*>(o + i) =
            *reinterpret_cast<const float4*>(x + i);
    } else {
      for (int i = tid; i < n; i += kThreads) o[i] = x[i];
    }
    return;                   // uniform over the cluster: no barrier waits
  }

  // ---- the slice into shared memory, once ---------------------------- //
  if (vec) {
    for (int i = 4 * tid; i < n; i += 4 * kThreads)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(xs + i)),
                   "l"(x + i)
                   : "memory");
  } else {
    for (int i = tid; i < n; i += kThreads)
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(xs + i)),
                   "l"(x + i)
                   : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int i = tid; i < kWarps * 256; i += kThreads)
    (&sh.wh.mass[0][0])[i] = 0ull;
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  const int seg = (n + kWarps - 1) / kWarps + 3 & ~3;
  const int lo = min(n, warp * seg), hi = min(n, lo + seg);

  // ---- pass A: the row max, and top-k's first radix round ------------ //
  unsigned kth = 0, mask = 0, krem = (unsigned)min(k, V);
  {
    float mx = -INFINITY;
    each4(xs, lo, hi, lane, [&](int i, float4 v) {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool valid = i + j < hi;
        if (valid) mx = fmaxf(mx, e[j]);
        if (k > 0)
          count_add(sh.wh.cnt[warp], valid, key_of(e[j]) >> 24, lane);
      }
    });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) sh.red_max[warp] = mx;
  }
  __syncthreads();
  merge_warps(sh.cnt[0], sh.wh.cnt, tid);
  cluster.sync();
  if (warp == 0) {  // the max of the survivors is the row max (k >= 1)
    float mx = fold_ranks(sh.red_max, C, lane, -INFINITY,
                          [](float a, float b) { return fmaxf(a, b); });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
    if (lane == 0) sh.mx = mx;
  }

  // ---- top-k: radix-select the exact k-th largest key ----------------- //
  if (k > 0) {
    for (int round = 0; round < 4; ++round) {
      const int shift = 24 - 8 * round;
      if (round > 0) {
        each4(xs, lo, hi, lane, [&](int i, float4 v) {
          const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const unsigned key = key_of(e[j]);
            count_add(sh.wh.cnt[warp], i + j < hi && (key & mask) == kth,
                      (key >> shift) & 0xffu, lane);
          }
        });
        __syncthreads();
        merge_warps(sh.cnt[round], sh.wh.cnt, tid);
        cluster.sync();
      }
      decide_count(sh, C, round, krem, tid);
      krem -= sh.sel_above;
      kth |= (unsigned)sh.sel_j << shift;
      mask |= 0xffu << shift;
    }
  } else {
    __syncthreads();  // sh.mx
  }
  const float mx = sh.mx;

  if (p >= 1.0f) {  // top-p off: the top-k survivors are the output
    cluster_arrive();  // this CTA reads no other shared memory from here
    each4(xs, lo, hi, lane, [&](int i, float4 v) {
      const float e[4] = {v.x, v.y, v.z, v.w};
      float r[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) r[j] = top_k_value(e[j], k, kth);
      if (vec) {
        if (i < hi) *reinterpret_cast<float4*>(o + i) =
            make_float4(r[0], r[1], r[2], r[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (i + j < hi) o[i + j] = r[j];
      }
    });
    cluster_wait();
    return;
  }

  // ---- softmax denominator: lane, warp, rank order -------------------- //
  {
    float sum = 0.f;
    each4(xs, lo, hi, lane, [&](int i, float4 v) {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = top_k_value(e[j], k, kth);
        if (i + j < hi && xv != kNegInf) sum += expf(xv - mx);
      }
    });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(kFull, sum, off);
    if (lane == 0) sh.red_sum[warp] = sum;
  }
  cluster.sync();
  if (warp == 0) {  // lane r: rank r's warps in order; then a fixed tree
    float tot = fold_ranks(sh.red_sum, C, lane, 0.f,
                           [](float a, float b) { return a + b; });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tot += __shfl_xor_sync(kFull, tot, off);
    if (lane == 0) sh.tot = tot;
  }
  __syncthreads();
  const float tot = sh.tot;

  // ---- top-p: refine the nucleus boundary over probability mass ------- //
  unsigned tkey = 0;
  unsigned long long above_fix = 0;
  mask = 0;
  for (int round = 0; round < 4; ++round) {
    const int shift = 24 - 8 * round;
    each4(xs, lo, hi, lane, [&](int i, float4 v) {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float xv = top_k_value(e[j], k, kth);
        const unsigned key = key_of(xv);
        unsigned long long m = 0;
        if (i + j < hi && (key & mask) == tkey)
          m = __float2ull_rn(prob(xv, mx, tot) * kFix);
        mass_add(sh.wh.mass[warp], sh.stage[warp], m > 0,    // zero mass
                 (key >> shift) & 0xffu, m, lane);        // adds nothing
      }
    });
    __syncthreads();
    merge_warps(sh.mass[round], sh.wh.mass, tid);
    cluster.sync();
    decide_mass(sh, C, round, above_fix, p, tid);
    above_fix = sh.sel_mass;
    tkey |= (unsigned)sh.sel_j << shift;
    mask |= 0xffu << shift;
  }
  const float above = unfix(above_fix);
  const float p_t = expf(value_of(tkey) - mx) / tot;

  // ---- the tied run at T: ranks in index order across warps and CTAs -- //
  {
    int cnt = 0;
    each4(xs, lo, hi, lane, [&](int i, float4 v) {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        cnt += i + j < hi && key_of(top_k_value(e[j], k, kth)) == tkey;
    });
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cnt += __shfl_xor_sync(kFull, cnt, off);
    if (lane == 0) sh.ties[warp] = cnt;
  }
  cluster.sync();
  if (warp == 0) {
    int before = fold_ranks(sh.ties, rank, lane, 0,   // ties in the CTAs
                            [](int a, int b) { return a + b; });  // below
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      before += __shfl_xor_sync(kFull, before, off);
    if (lane == 0) sh.tie_base = before;
  }
  __syncthreads();
  cluster_arrive();  // this CTA reads no other shared memory from here
  int running = sh.tie_base;
  for (int w = 0; w < warp; ++w) running += sh.ties[w];

  // ---- output --------------------------------------------------------- //
  each4(xs, lo, hi, lane, [&](int i, float4 v) {
    const float e[4] = {v.x, v.y, v.z, v.w};
    float xv[4];
    unsigned key[4];
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      xv[j] = top_k_value(e[j], k, kth);
      key[j] = key_of(xv[j]);
      mine += i + j < hi && key[j] == tkey;
    }
    int rank_j = running, total = 0;
    if (__ballot_sync(kFull, mine > 0)) {
      const int incl = warp_incl_scan(mine, lane);
      rank_j += incl - mine;
      total = __shfl_sync(kFull, incl, 31);
    }
    running += total;
    float r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool eq = i + j < hi && key[j] == tkey;
      const bool keep =
          key[j] > tkey ||
          (eq && __fadd_rn(above, __fmul_rn((float)rank_j, p_t)) < p);
      rank_j += eq;
      r[j] = keep ? xv[j] : kNegInf;
    }
    if (vec) {
      if (i < hi) *reinterpret_cast<float4*>(o + i) =
          make_float4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (i + j < hi) o[i + j] = r[j];
    }
  });
  cluster_wait();     // no CTA leaves while another reads its histograms
}

}  // namespace

extern "C" int topk_topp_mask_f32(const float* logits, const int* k,
                                  const float* p, float* out, int B, int V,
                                  int cluster, int slice, void* stream) {
  if (B == 0 || V == 0) return 0;
  if (V < 0 || B < 0 || B > 65535 || cluster < 1 ||
      cluster > kMaxCluster || slice < 4 || slice % 4 ||
      (long long)slice * cluster < V || (long long)slice * (cluster - 1) >= V)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kSharedBytes + (size_t)slice * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      topk_topp_cluster_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(topk_topp_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, topk_topp_cluster_kernel, logits, k, p, out,
                           V, slice);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
