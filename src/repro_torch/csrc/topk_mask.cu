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
// one write. One f32 row of a 152064-entry vocab is 608 KB, more than a
// block's 227 KB of shared memory, so this simple design re-reads the row
// in every pass (4 radix rounds per filter, the softmax max and sum, the
// output pass), from L2 after the first pass: the rows of a batch
// (8 x 608 KB) fit the 50 MB L2.
//
// Design: one block of 1024 threads per row; every pass keeps 8 loads per
// thread in flight (one load at a time left the first version
// latency-bound at ~0.8 ms for a row). Histograms are warp-private
// in shared memory. Lanes of a warp that fall in the same bucket are
// grouped with __match_any_sync; the group's lowest lane adds the count,
// or the mass summed over the group in lane order, to its warp's
// histogram. The 32 warp histograms are then combined in warp order. No
// float atomics anywhere: the mass histogram, the softmax max and sum,
// and the exclusive scan that gives the tie rank all reduce in a fixed
// order, so the keep-set of a row is the same on every run. expf and the
// division are the precise ones (no --use_fast_math), and the tie test
// uses explicitly rounded multiply and add so nothing is contracted.
//
// Not done yet: keeping the row in registers/shared memory across passes
// (a cluster of blocks would hold 608 KB), more than one block per row.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kPrefetch = 8;                 // loads a thread keeps in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ unsigned key_of(float x) {
  const unsigned u = __float_as_uint(x + 0.0f);  // -0.0 -> +0.0
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float value_of(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

struct Shared {
  union {
    int i[kWarps][256];
    float f[kWarps][256];
  } warp_hist;
  int hist_i[256];
  float hist_f[256];
  float red[kWarps];
  int warp_cnt[kWarps];
  int sel_j;
  int sel_above;
  float sel_mass;
};

__device__ __forceinline__ void clear_warp_hist(Shared& sh) {
  for (int i = threadIdx.x; i < kWarps * 256; i += kThreads)
    (&sh.warp_hist.i[0][0])[i] = 0;
}

// The top-k survivor: x itself, or -1e30 when the radix select drops it.
__device__ __forceinline__ float top_k_value(float x, int k, unsigned kth) {
  return (k <= 0 || key_of(x) >= kth) ? x : kNegInf;
}

// One pass over the row: f(i, x[i]) for i = tid, tid + 1024, ... in that
// order (lane-contiguous 32-element chunks per warp). kPrefetch loads are
// issued before any is used, so the pass is not bound by one load's
// latency. f is called for every lane of a chunk that starts below V
// (warp-uniform, so f may use warp collectives) and must ignore i >= V.
template <typename F>
__device__ __forceinline__ void for_each(const float* __restrict__ x, int V,
                                         F&& f) {
  for (int base = threadIdx.x & ~31; base < V; base += kThreads * kPrefetch) {
    float xv[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int i = base + u * kThreads + (threadIdx.x & 31);
      xv[u] = i < V ? x[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u)
      if (base + u * kThreads < V) f(base + u * kThreads + (threadIdx.x & 31), xv[u]);
  }
}

__global__ void __launch_bounds__(kThreads) topk_topp_kernel(
    const float* __restrict__ logits, const int* __restrict__ ks,
    const float* __restrict__ ps, float* __restrict__ out, int V) {
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* x = logits + (size_t)blockIdx.x * V;
  float* o = out + (size_t)blockIdx.x * V;
  const int k = ks[blockIdx.x];
  const float p = ps[blockIdx.x];

  // ---- top-k: radix-select the exact k-th largest key ----------------- //
  unsigned kth = 0;
  if (k > 0) {
    int krem = min(k, V);
    unsigned mask = 0;
    for (int shift = 24; shift >= 0; shift -= 8) {
      clear_warp_hist(sh);
      __syncthreads();
      for_each(x, V, [&](int i, float xv) {
        bool cand = false;
        unsigned byte = 0;
        if (i < V) {
          const unsigned key = key_of(xv);
          cand = (key & mask) == kth;
          byte = (key >> shift) & 0xffu;
        }
        const unsigned act = __ballot_sync(kFull, cand);
        if (cand) {
          const unsigned peers = __match_any_sync(act, byte);
          if (lane == __ffs(peers) - 1) sh.warp_hist.i[warp][byte] += __popc(peers);
        }
      });
      __syncthreads();
      if (tid < 256) {
        int s = 0;
        for (int w = 0; w < kWarps; ++w) s += sh.warp_hist.i[w][tid];
        sh.hist_i[tid] = s;
      }
      __syncthreads();
      if (tid == 0) {  // the bucket holding the krem-th largest candidate
        int above = 0, j = 255;
        for (; j > 0; --j) {
          if (above + sh.hist_i[j] >= krem) break;
          above += sh.hist_i[j];
        }
        sh.sel_j = j;
        sh.sel_above = above;
      }
      __syncthreads();
      krem -= sh.sel_above;
      kth |= (unsigned)sh.sel_j << shift;
      mask |= 0xffu << shift;
    }
  }

  if (p >= 1.0f) {  // top-p disabled: the top-k survivors are the output
    for_each(x, V, [&](int i, float xv) {
      if (i < V) o[i] = top_k_value(xv, k, kth);
    });
    return;
  }

  // ---- softmax of the survivors: max and sum in a fixed order --------- //
  float mx = -INFINITY;
  for_each(x, V, [&](int i, float xv) {
    if (i < V) mx = fmaxf(mx, top_k_value(xv, k, kth));
  });
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  if (lane == 0) sh.red[warp] = mx;
  __syncthreads();
  mx = sh.red[0];
  for (int w = 1; w < kWarps; ++w) mx = fmaxf(mx, sh.red[w]);
  __syncthreads();
  float sum = 0.f;
  for_each(x, V, [&](int i, float xv) {
    if (i < V) sum += expf(top_k_value(xv, k, kth) - mx);
  });
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(kFull, sum, off);
  if (lane == 0) sh.red[warp] = sum;
  __syncthreads();
  float tot = 0.f;
  for (int w = 0; w < kWarps; ++w) tot += sh.red[w];

  // ---- top-p: refine the nucleus boundary over probability mass ------- //
  unsigned tkey = 0, mask = 0;
  float above_mass = 0.f;
  for (int shift = 24; shift >= 0; shift -= 8) {
    clear_warp_hist(sh);
    __syncthreads();
    for_each(x, V, [&](int i, float x_i) {
      bool cand = false;
      unsigned byte = 0;
      float w = 0.f;
      if (i < V) {
        const float xv = top_k_value(x_i, k, kth);
        const unsigned key = key_of(xv);
        if ((key & mask) == tkey) {
          w = expf(xv - mx) / tot;
          cand = w > 0.f;                        // zero mass adds nothing
          byte = (key >> shift) & 0xffu;
        }
      }
      const unsigned act = __ballot_sync(kFull, cand);
      if (act) {
        const unsigned peers = cand ? __match_any_sync(act, byte) : 0u;
        const int leader = cand ? __ffs(peers) - 1 : -1;
        float group = 0.f;
        for (int src = 0; src < 32; ++src) {  // lane order
          const float v = __shfl_sync(kFull, w, src);
          if (lane == leader && ((peers >> src) & 1u)) group += v;
        }
        if (lane == leader) sh.warp_hist.f[warp][byte] += group;
      }
    });
    __syncthreads();
    if (tid < 256) {
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += sh.warp_hist.f[w][tid];
      sh.hist_f[tid] = s;
    }
    __syncthreads();
    if (tid == 0) {  // the lowest bucket whose mass above it is < p
      float incl = 0.f, sel_mass = 0.f, mass0 = 0.f;
      int j_sel = -1;
      for (int j = 255; j >= 0; --j) {
        incl += sh.hist_f[j];
        const float above = (incl - sh.hist_f[j]) + above_mass;
        if (above < p) {
          j_sel = j;
          sel_mass = above;
        }
        if (j == 0) mass0 = above;
      }
      if (j_sel < 0) {  // no bucket qualifies: bucket 0, as argmax does
        j_sel = 0;
        sel_mass = mass0;
      }
      sh.sel_j = j_sel;
      sh.sel_mass = sel_mass;
    }
    __syncthreads();
    above_mass = sh.sel_mass;
    tkey |= (unsigned)sh.sel_j << shift;
    mask |= 0xffu << shift;
  }
  const float p_t = expf(value_of(tkey) - mx) / tot;

  // ---- output: the tied run at T is split by rank in index order ------ //
  // Tiles of 1024 consecutive elements, kPrefetch tiles loaded at a time;
  // the tile loop bounds are the same for every thread (block barriers).
  int running = 0;
  for (int t0 = 0; t0 < V; t0 += kThreads * kPrefetch) {
    float xs[kPrefetch];
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      const int i = t0 + u * kThreads + tid;
      xs[u] = i < V ? x[i] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kPrefetch; ++u) {
      if (t0 + u * kThreads >= V) break;          // the same for the block
      const int i = t0 + u * kThreads + tid;
      float xv = kNegInf;
      unsigned key = 0;
      bool eq = false;
      if (i < V) {
        xv = top_k_value(xs[u], k, kth);
        key = key_of(xv);
        eq = key == tkey;
      }
      const unsigned bal = __ballot_sync(kFull, eq);
      if (lane == 0) sh.warp_cnt[warp] = __popc(bal);
      __syncthreads();
      int rank = running + __popc(bal & ((1u << lane) - 1u));
      int tile = 0;
      for (int w = 0; w < kWarps; ++w) {
        if (w < warp) rank += sh.warp_cnt[w];
        tile += sh.warp_cnt[w];
      }
      if (i < V) {
        const bool keep =
            key > tkey ||
            (eq && __fadd_rn(above_mass, __fmul_rn((float)rank, p_t)) < p);
        o[i] = keep ? xv : kNegInf;
      }
      running += tile;
      __syncthreads();  // warp_cnt is rewritten by the next tile
    }
  }
}

}  // namespace

extern "C" int topk_topp_mask_f32(const float* logits, const int* k,
                                  const float* p, float* out, int B, int V,
                                  void* stream) {
  if (B == 0 || V == 0) return 0;
  if (V < 0 || B < 0) return (int)cudaErrorInvalidValue;
  topk_topp_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(logits, k, p,
                                                            out, V);
  return (int)cudaGetLastError();
}
