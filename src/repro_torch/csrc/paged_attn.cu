// Paged-attention decode step for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attn.py::paged_attention_step, the
// Pallas TPU kernel (def at line 150, pl.pallas_call at line 198).
//
// Computes, for every batch row b and KV head h, with pos = seq_lens[b]:
//   1. the fused KV write: k_new/v_new[b, h] land in pool slot
//      (page_table[b, pos / ps], pos % ps) before that position is read;
//   2. GQA attention of the G query heads of h over positions
//      max(0, pos - window + 1) .. pos (window 0 = all), reading pages
//      through the row's table and skipping null page 0, with softmax
//      statistics and sums in f32. o is stored in the input dtype. A row
//      with no live position (an inactive row: seq_len 0, all-null table)
//      gets o = 0, as the Pallas kernel gives.
// The pools are updated in place.
//
// What bounds it on the card: device-memory bytes. Every live position
// costs 2 * KVd * Dh * sizeof(T) bytes of K and V per row and only
// 4 * G * Dh flops per KV head, far below the H100's compute rate.
//
// Design. A block of 128 threads takes one (row, KV head) and one split
// of `split_pos` positions, so a batch of 8 rows at ~500 positions fills
// the card with a few hundred blocks (flash-decoding). The block stages
// tiles of positions in shared memory: every thread issues up to 16
// independent 16-byte loads of the contiguous Dh-slices of K and V before
// storing any, so a whole tile is in flight at once (a page-at-a-time
// walk with per-position loads was latency-bound at about 240x the byte
// bound). Warps score the tile's positions (lanes over Dh, shuffle
// reduction); warp g then turns head g's scores into weights and updates
// its running max and sum, and every thread accumulates the dims it owns.
// Positions outside the live stretch or on a null page get weight 0 and
// their V is never read, so stale values (even NaN) cannot reach o. Each
// split writes (max, sum, unnormalised o) in f32; a second kernel
// combines the splits of a (row, head) in split order.
//
// Not done yet: cp.async/TMA double buffering of tiles, and tensor-core
// (mma) scoring of the G heads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                        // query heads per KV head
constexpr int kMaxDh = 256;
constexpr int kDimsPerThread = kMaxDh / kThreads;
constexpr int kTileBytes = 32768;               // K + V tile in shared memory
constexpr int kMaxTile = 64;                    // positions per tile
constexpr int kLoads = 8;                       // 16-byte loads in flight
constexpr int kNullPage = 0;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
int tile_positions(int Dh) {
  return min(kMaxTile, kTileBytes / (2 * Dh * (int)sizeof(T)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attn_split_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pool, T* v_pool,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int KVd,
    int G, int Dh, int ps, int P, float scale, int window, int split_pos,
    int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                   // [tile][Dh]
  T* v_s = k_s + (size_t)tile * Dh;                       // [tile][Dh]
  long long* off_s = reinterpret_cast<long long*>(v_s + (size_t)tile * Dh);
  float* q_s = reinterpret_cast<float*>(off_s + tile);    // [G][Dh]
  float* p_s = q_s + G * Dh;                              // [G][tile]
  float* m_s = p_s + G * tile;                            // [G] running max
  float* l_s = m_s + kMaxG;                               // [G] running sum
  float* alpha_s = l_s + kMaxG;                           // [G] tile rescale

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int n_splits = gridDim.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = seq_lens[b];
  const int* table = page_table + (size_t)b * P;
  const size_t slot_stride = (size_t)KVd * Dh;  // one pool position
  const size_t head_off = (size_t)h * Dh;
  const size_t bh = (size_t)b * KVd + h;
  const int lo = max(window > 0 ? pos - window + 1 : 0, split * split_pos);
  const int hi = min(pos, (split + 1) * split_pos - 1);

  // 1. fused KV write, by the split that will read position pos
  //    (inactive rows write into the never-read null page)
  if (pos / split_pos == split) {
    const size_t dst =
        ((size_t)table[pos / ps] * ps + pos % ps) * slot_stride + head_off;
    for (int d = tid; d < Dh; d += kThreads) {
      k_pool[dst + d] = k_new[bh * Dh + d];
      v_pool[dst + d] = v_new[bh * Dh + d];
    }
  }
  for (int i = tid; i < G * Dh; i += kThreads) q_s[i] = to_f(q[bh * G * Dh + i]);
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kMaxG][kDimsPerThread];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] = 0.f;

  const int chunks = Dh * (int)sizeof(T) / 16;         // 16-byte chunks
  for (int t0 = lo; t0 <= hi; t0 += tile) {
    const int n = min(tile, hi - t0 + 1);
    // 2. element offset of each position's head slice (-1: null page)
    for (int j = tid; j < n; j += kThreads) {
      const int t = t0 + j, page = table[t / ps];
      off_s[j] = page == kNullPage
                     ? -1
                     : (long long)(((size_t)page * ps + t % ps) * slot_stride +
                                   head_off);
    }
    __syncthreads();  // (the first pass also orders the KV write and q_s)

    // 3. stage the tile: a thread's loads are all issued before its stores
    for (int idx0 = tid; idx0 < n * chunks; idx0 += kThreads * kLoads) {
      uint4 kr[kLoads], vr[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = idx0 + u * kThreads;
        const long long off = idx < n * chunks ? off_s[idx / chunks] : -1;
        if (off >= 0) {
          kr[u] = reinterpret_cast<const uint4*>(k_pool + off)[idx % chunks];
          vr[u] = reinterpret_cast<const uint4*>(v_pool + off)[idx % chunks];
        }
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int idx = idx0 + u * kThreads;
        const long long off = idx < n * chunks ? off_s[idx / chunks] : -1;
        if (off >= 0) {
          const int j = idx / chunks, c = idx % chunks;
          reinterpret_cast<uint4*>(k_s + (size_t)j * Dh)[c] = kr[u];
          reinterpret_cast<uint4*>(v_s + (size_t)j * Dh)[c] = vr[u];
        }
      }
    }
    __syncthreads();

    // 4. scores: warp w takes positions w, w + 4, ...; -inf where dead
    for (int j = warp; j < n; j += kWarps) {
      const bool live = off_s[j] >= 0;                  // warp-uniform
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (live) {
        for (int d = lane; d < Dh; d += 32) {
          const float kv = to_f(k_s[(size_t)j * Dh + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g)
            if (g < G) part[g] += q_s[g * Dh + d] * kv;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          float v = part[g];
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
          if (lane == 0) p_s[g * tile + j] = live ? v * scale : -INFINITY;
        }
      }
    }
    __syncthreads();

    // 5. warp g: the tile's max, weights and sum for head g, and the
    //    online-softmax update of its running max and sum
    for (int g = warp; g < G; g += kWarps) {
      float mp = -INFINITY;
      for (int j = lane; j < n; j += 32) mp = fmaxf(mp, p_s[g * tile + j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mp = fmaxf(mp, __shfl_xor_sync(0xffffffffu, mp, o));
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, mp);
      float sum = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float sc = p_s[g * tile + j];
        const float w = sc == -INFINITY ? 0.f : expf(sc - m_new);
        p_s[g * tile + j] = w;
        sum += w;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        // 0 on the first live tile; 1 while nothing is live yet
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 6. every thread: rescale and accumulate the dims it owns
#pragma unroll
    for (int g = 0; g < kMaxG; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] *= alpha_s[g];
    for (int j = 0; j < n; ++j) {
      if (off_s[j] < 0) continue;                       // V never read
      float vv[kDimsPerThread];
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int d = tid + i * kThreads;
        vv[i] = d < Dh ? to_f(v_s[(size_t)j * Dh + d]) : 0.f;
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g < G) {
          const float w = p_s[g * tile + j];
#pragma unroll
          for (int i = 0; i < kDimsPerThread; ++i) acc[g][i] += w * vv[i];
        }
      }
    }
    __syncthreads();  // the tile buffers are rewritten next
  }
  __syncthreads();    // m_s/l_s are final (also when the split is empty)

  // 7. this split's (max, sum, unnormalised o)
  const size_t base = (bh * n_splits + split) * G;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < G) {
#pragma unroll
      for (int i = 0; i < kDimsPerThread; ++i) {
        const int d = tid + i * kThreads;
        if (d < Dh) part_acc[(base + g) * Dh + d] = acc[g][i];
      }
    }
  }
  if (tid < G) {
    part_ml[(base + tid) * 2] = m_s[tid];
    part_ml[(base + tid) * 2 + 1] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attn_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    T* __restrict__ out, int G, int Dh, int n_splits) {
  const size_t bh = (size_t)blockIdx.x * gridDim.y + blockIdx.y;
  for (int g = 0; g < G; ++g) {
    float mx = -INFINITY;
    for (int s = 0; s < n_splits; ++s)
      mx = fmaxf(mx, part_ml[((bh * n_splits + s) * G + g) * 2]);
    float l = 0.f;
    float acc[kDimsPerThread] = {};
    if (mx != -INFINITY) {
      for (int s = 0; s < n_splits; ++s) {  // split order: deterministic
        const size_t base = (bh * n_splits + s) * G + g;
        const float w = expf(part_ml[base * 2] - mx);  // 0 for empty splits
        l += w * part_ml[base * 2 + 1];
#pragma unroll
        for (int i = 0; i < kDimsPerThread; ++i) {
          const int d = threadIdx.x + i * kThreads;
          if (d < Dh) acc[i] += w * part_acc[base * Dh + d];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kDimsPerThread; ++i) {
      const int d = threadIdx.x + i * kThreads;
      if (d < Dh)
        out[(bh * G + g) * Dh + d] = from_f<T>(l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const int* page_table, const int* seq_lens,
           void* out, float* part_acc, float* part_ml, int B, int KVd, int G,
           int Dh, int ps, int P, float scale, int window, int split_pos,
           int n_splits, void* stream) {
  if (G < 1 || G > kMaxG || Dh < 1 || Dh > kMaxDh ||
      (Dh * (int)sizeof(T)) % 16 || ps < 1 || KVd < 1 || KVd > 65535 ||
      P < 1 || split_pos < 1 || n_splits < 1 || n_splits > 65535 ||
      (long long)split_pos * n_splits < (long long)P * ps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int tile = tile_positions<T>(Dh);
  const size_t smem = 2 * (size_t)tile * Dh * sizeof(T) +
                      (size_t)tile * sizeof(long long) +
                      ((size_t)G * Dh + (size_t)G * tile + 3 * kMaxG) *
                          sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  paged_attn_split_kernel<T><<<dim3(B, KVd, n_splits), kThreads, smem, s>>>(
      (const T*)q, (const T*)k_new, (const T*)v_new, (T*)k_pool, (T*)v_pool,
      page_table, seq_lens, part_acc, part_ml, KVd, G, Dh, ps, P, scale,
      window, split_pos, tile);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_attn_combine_kernel<T><<<dim3(B, KVd), kThreads, 0, s>>>(
      part_acc, part_ml, (T*)out, G, Dh, n_splits);
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_ATTN_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* k_new, const void* v_new,  \
                      void* k_pool, void* v_pool, const int* page_table,     \
                      const int* seq_lens, void* out, float* part_acc,       \
                      float* part_ml, int B, int KVd, int G, int Dh, int ps, \
                      int P, float scale, int window, int split_pos,         \
                      int n_splits, void* stream) {                          \
    return launch<T>(q, k_new, v_new, k_pool, v_pool, page_table, seq_lens,  \
                     out, part_acc, part_ml, B, KVd, G, Dh, ps, P, scale,    \
                     window, split_pos, n_splits, stream);                   \
  }

PAGED_ATTN_ENTRY(paged_attention_step_bf16, __nv_bfloat16)
PAGED_ATTN_ENTRY(paged_attention_step_f32, float)
