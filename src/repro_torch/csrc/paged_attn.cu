// Paged-attention decode step for Hopper (sm_90a), plain C interface.
//
// Replaces: src/repro/kernels/paged_attn.py::paged_attention_step, the
// Pallas TPU kernel (def at line 150, pl.pallas_call at line 198).
//
// Computes, for every batch row b and KV head h, with pos = seq_lens[b]:
//   1. the fused KV write: k_new/v_new[b, h] land in pool slot
//      (page_table[b, pos / ps], pos % ps);
//   2. GQA attention of the G query heads of h over positions
//      max(0, pos - window + 1) .. pos (window 0 = all), reading pages
//      through the row's table and skipping null page 0, with softmax
//      statistics and sums in f32. o is stored in the input dtype. A row
//      with no live position (an inactive row: seq_len 0, all-null table)
//      gets o = 0, as the Pallas kernel gives.
// The pools are updated in place. Position pos is attended from k_new/v_new
// themselves, the values its pool slot receives, so no read of the pool
// can see the slot before its write.
//
// What bounds it on the card: device-memory bytes. Every live position
// costs 2 * Dh * sizeof(T) bytes of K and V per KV head and only
// 4 * G * Dh flops, far below the H100's compute rate.
//
// Design: one launch, one thread-block cluster per (row, KV head). The
// cluster's CTA r takes split r of the row's positions (the wrapper's
// plan: at most 8 CTAs, splits of whole 64-position tiles). In a CTA, each
// of the 4 warps is an independent flash-decoding worker over 16-position
// chunks of its split (chunks w, w + 4, ...): per chunk, 16 lanes resolve
// one position each through the split's page ids (read once per CTA) and
// the warp streams the chunk's K and V rows into its own ring of
// shared-memory stages with cp.async (16-byte pieces of each position's
// contiguous Dh slice; positions that are dead, masked or out of range
// are zero-filled and never read from the pool), so the next chunk is in
// flight while this one is scored and accumulated, with no block barrier
// in the loop. The kernel is instantiated per head dim and per head group
// (a power of two >= G), so every index is a shift and no lane work is
// predicated away. bf16 scores come from mma.sync.m16n8k16 with positions
// on M and the query heads on N (bf16 x bf16 products are exact in f32);
// f32 scores from the CUDA cores (lanes over Dh, shuffle sums). The online
// softmax keeps each head's running max and sum in registers, and P.V
// stays in f32 on the CUDA cores (each lane owns pairs of dims of every
// head). At the end each warp's (max, sum, unnormalised o) is combined in
// warp order into the CTA's partial; after cluster.sync() CTA r reads the
// partials of all CTAs through distributed shared memory, in rank order,
// for its 1/C share of o's elements, and writes them. Nothing goes through
// global memory between the two; every sum has a fixed order, so o is the
// same bits on every run.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 16;                      // positions a warp step
constexpr int kMaxG = 8;                        // query heads per KV head
constexpr int kMaxCluster = 8;
constexpr int kNullPage = 0;

template <typename T> struct Elt;
template <> struct Elt<float> {
  static __device__ __forceinline__ float2 pair(const unsigned char* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ float from(float x) { return x; }
};
template <> struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float2 pair(const unsigned char* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  }
  static __device__ __forceinline__ __nv_bfloat16 from(float x) {
    return __float2bfloat16(x);
  }
};

// Shared-memory layout; kernels/paged_attn.py::smem_bytes mirrors it.
__host__ __device__ inline int row_bytes(int Dh, int isz) {
  return Dh * isz + 16;                         // 16-byte pad: no conflicts
}
__host__ __device__ inline int part_bytes(int G, int Dh) {
  return (2 * kMaxG + G * Dh) * 4;              // m[kMaxG], l[kMaxG], o
}
__host__ __device__ inline int pages_bytes(int split, int ps) {
  return ((split / ps + 2) * 4 + 15) / 16 * 16;
}
__host__ __device__ inline int stage_bytes(int Dh, int isz) {
  return 2 * kChunk * row_bytes(Dh, isz);       // K rows then V rows
}
__host__ __device__ inline int warp_bytes(int Dh, int isz, int stages) {
  return stages * stage_bytes(Dh, isz) + kChunk * kMaxG * 4 + kMaxG * 4 +
         kChunk * 8;                            // p_s, alpha_s, off_s
}
inline size_t smem_bytes(int G, int Dh, int isz, int split, int ps,
                         int stages) {
  return (size_t)part_bytes(G, Dh) + pages_bytes(split, ps) +
         (size_t)kWarps * warp_bytes(Dh, isz, stages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait(int stages) {
  if (stages > 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Distributed shared memory: the address of p in CTA `rank` of the
// cluster, and a 4-byte load from it.
__device__ __forceinline__ uint32_t map_rank(const void* p, int rank) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}
__device__ __forceinline__ float ld_cluster(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Row {
  int pos, lo, hi;                              // live stretch [lo, hi]
  int ps, page0;                                // page size, pages[0]'s index
  const int* pages;                             // the split's page ids
  __device__ __forceinline__ int page(int t) const {
    return pages[t / ps - page0];
  }
  __device__ __forceinline__ bool live(int t) const {
    return t >= lo && t <= hi && page(t) != kNullPage;
  }
};

// A warp's cp.async of one chunk's K and V rows into a stage: lane j < 16
// resolves position base + j once (its head slice's element offset in the
// pools, -1 dead, -2 the token itself), then the lanes copy 16-byte
// pieces of the 32 rows.
template <typename T, int DH>
__device__ __forceinline__ void issue_chunk(
    unsigned char* stage, long long* off_s, int base, const Row& row,
    const T* k_pool, const T* v_pool, const T* k_tok, const T* v_tok,
    int KVd, int h, int lane) {
  constexpr int kPerRow = DH * (int)sizeof(T) / 16;
  constexpr int kRow = DH * (int)sizeof(T) + 16;
  if (lane < kChunk) {
    const int t = base + lane;
    off_s[lane] = !row.live(t) ? -1
                  : t == row.pos
                      ? -2
                      : ((long long)row.page(t) * row.ps + t % row.ps) *
                                KVd * DH +
                            (long long)h * DH;
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 2 * kChunk * kPerRow; i += 32) {
    const int kv = i / (kChunk * kPerRow);      // 0: K, 1: V
    const int j = i / kPerRow % kChunk, c = i % kPerRow;
    const long long off = off_s[j];
    const T* src = off == -2 ? (kv ? v_tok : k_tok)
                             : (kv ? v_pool : k_pool) + (off < 0 ? 0 : off);
    cp_async16(stage + (kv * kChunk + j) * kRow + c * 16,
               reinterpret_cast<const unsigned char*>(src) + c * 16,
               off != -1);
  }
  __syncwarp();  // off_s is rewritten by the next chunk's issue
}

// DH: head dim; KG: query heads computed (a power of two >= G; heads
// past G have q = 0 and are not stored).
template <typename T, int DH, int KG>
__global__ void __launch_bounds__(kThreads) paged_attn_cluster_kernel(
    const T* __restrict__ q, const T* __restrict__ k_new,
    const T* __restrict__ v_new, T* k_pool, T* v_pool,
    const int* __restrict__ page_table, const int* __restrict__ seq_lens,
    T* __restrict__ out, int KVd, int G, int ps, int P, float scale,
    int window, int split, int stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int isz = sizeof(T);
  constexpr int kRow = DH * isz + 16;
  constexpr int kPairs = (DH + 63) / 64;        // dim pairs a lane owns
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int stage_b = stage_bytes(DH, isz);

  float* part = reinterpret_cast<float*>(smem);   // m[kMaxG] l[kMaxG] o[G*DH]
  int* pages = reinterpret_cast<int*>(smem + part_bytes(G, DH));
  unsigned char* wbase = smem + part_bytes(G, DH) + pages_bytes(split, ps) +
                         (size_t)warp * warp_bytes(DH, isz, stages);
  float* p_s = reinterpret_cast<float*>(wbase + stages * stage_b);
  float* alpha_s = p_s + kChunk * kMaxG;
  long long* off_s = reinterpret_cast<long long*>(alpha_s + kMaxG);

  const int pos = seq_lens[b];
  const int* table = page_table + (size_t)b * P;
  const size_t bh = (size_t)b * KVd + h;
  const int s0 = rank * split;
  Row row;
  row.pos = pos;
  row.lo = max(window > 0 ? pos - window + 1 : 0, s0);
  row.hi = min(pos, s0 + split - 1);
  row.ps = ps;
  row.page0 = s0 / ps;
  row.pages = pages;

  // 1. the fused KV write, by the CTA whose split holds pos (an inactive
  //    row writes into the never-read null page)
  if (pos >= s0 && pos < s0 + split) {
    const size_t dst = ((size_t)table[pos / ps] * ps + pos % ps) *
                           (size_t)KVd * DH + (size_t)h * DH;
    for (int d = tid; d < DH; d += kThreads) {
      k_pool[dst + d] = k_new[bh * DH + d];
      v_pool[dst + d] = v_new[bh * DH + d];
    }
  }
  // 2. the split's page ids, once
  const int last_page = min((s0 + split - 1) / ps, P - 1);
  for (int i = tid; i <= last_page - row.page0; i += kThreads)
    pages[i] = table[row.page0 + i];

  // q: bf16 as mma B fragments (column n = head lane / 4, rows k = dims),
  // f32 as the lane's dim pairs of every head
  uint32_t bq[DH / 16][2];
  float2 qf[KG][kPairs];
  if constexpr (isz == 2) {
    const int n = lane >> 2, k2 = 2 * (lane & 3);
    const uint32_t* qw =
        reinterpret_cast<const uint32_t*>(q + (bh * G + n) * DH);
#pragma unroll
    for (int ks = 0; ks < DH / 16; ++ks) {
      bq[ks][0] = n < G ? qw[(ks * 16 + k2) / 2] : 0u;
      bq[ks][1] = n < G ? qw[(ks * 16 + 8 + k2) / 2] : 0u;
    }
  } else {
#pragma unroll
    for (int g = 0; g < KG; ++g)
#pragma unroll
      for (int i = 0; i < kPairs; ++i) {
        const int d = 2 * lane + 64 * i;
        qf[g][i] = g < G && d < DH
                       ? *reinterpret_cast<const float2*>(
                             reinterpret_cast<const float*>(q) +
                             (bh * G + g) * DH + d)
                       : make_float2(0.f, 0.f);
      }
  }
  __syncthreads();  // pages[] for every warp

  // 3. this warp's chunks of [lo, hi]: chunk c_first + kWarps * i
  float2 acc[KG][kPairs];
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int i = 0; i < kPairs; ++i) acc[g][i] = make_float2(0.f, 0.f);
  const int n0 = 2 * (lane & 3), r0 = lane >> 2;  // mma C layout
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  int n_chunks = 0, c_first = 0;
  if (row.lo <= row.hi) {
    c_first = (row.lo - s0) / kChunk + warp;
    const int c_last = (row.hi - s0) / kChunk;
    n_chunks = c_first <= c_last ? (c_last - c_first) / kWarps + 1 : 0;
  }
  const T* k_tok = k_new + bh * DH;
  const T* v_tok = v_new + bh * DH;
  for (int i = 0; i < stages; ++i) {
    if (i < n_chunks)
      issue_chunk<T, DH>(wbase + i * stage_b, off_s,
                         s0 + (c_first + kWarps * i) * kChunk, row, k_pool,
                         v_pool, k_tok, v_tok, KVd, h, lane);
    cp_async_commit();
  }
  for (int i = 0; i < n_chunks; ++i) {
    const int base = s0 + (c_first + kWarps * i) * kChunk;
    const unsigned live =
        __ballot_sync(0xffffffffu, lane < kChunk && row.live(base + lane));
    cp_async_wait(stages);
    __syncwarp();
    const unsigned char* kst = wbase + (i % stages) * stage_b;
    const unsigned char* vst = kst + kChunk * kRow;

    // scores of rows r0, r0 + 8 for heads n0, n0 + 1 (mma C layout)
    float sc[4] = {0.f, 0.f, 0.f, 0.f};
    if constexpr (isz == 2) {
      const unsigned char* arow = kst + (lane & 15) * kRow + (lane >> 4) * 16;
#pragma unroll
      for (int ks = 0; ks < DH / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, arow + ks * 32);
        mma_bf16(sc, a, bq[ks][0], bq[ks][1]);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < kChunk; ++j) {
        float part_g[KG];
#pragma unroll
        for (int g = 0; g < KG; ++g) part_g[g] = 0.f;
#pragma unroll
        for (int ii = 0; ii < kPairs; ++ii) {
          const int d = 2 * lane + 64 * ii;
          if (d < DH) {
            const float2 kv = Elt<T>::pair(kst + j * kRow + d * isz);
#pragma unroll
            for (int g = 0; g < KG; ++g)
              part_g[g] += qf[g][ii].x * kv.x + qf[g][ii].y * kv.y;
          }
        }
#pragma unroll
        for (int g = 0; g < KG; ++g) {
#pragma unroll
          for (int o = 16; o > 0; o >>= 1)
            part_g[g] += __shfl_xor_sync(0xffffffffu, part_g[g], o);
        }
        float s0v = 0.f, s1v = 0.f;
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g == n0) s0v = part_g[g];
          if (g == n0 + 1) s1v = part_g[g];
        }
        if (j == r0) {
          sc[0] = s0v;
          sc[1] = s1v;
        } else if (j == r0 + 8) {
          sc[2] = s0v;
          sc[3] = s1v;
        }
      }
    }

    // online softmax per head; dead rows get weight 0
    const bool live0 = (live >> r0) & 1u, live1 = (live >> (r0 + 8)) & 1u;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float a = live0 ? sc[hh] * scale : -INFINITY;
      const float c = live1 ? sc[2 + hh] * scale : -INFINITY;
      float mx = fmaxf(a, c);
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[hh], mx);
      const float alpha = m_new == -INFINITY ? 1.f : expf(m_run[hh] - m_new);
      const float pa = a == -INFINITY ? 0.f : expf(a - m_new);
      const float pc = c == -INFINITY ? 0.f : expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_run[hh] = l_run[hh] * alpha + sum;
      m_run[hh] = m_new;
      p_s[r0 * kMaxG + n0 + hh] = pa;
      p_s[(r0 + 8) * kMaxG + n0 + hh] = pc;
      if (lane < 4) alpha_s[n0 + hh] = alpha;
    }
    __syncwarp();

    // P.V in f32: rescale, then every position of the chunk
#pragma unroll
    for (int g = 0; g < KG; ++g) {
      const float al = alpha_s[g];
#pragma unroll
      for (int ii = 0; ii < kPairs; ++ii) {
        acc[g][ii].x *= al;
        acc[g][ii].y *= al;
      }
    }
#pragma unroll 4
    for (int j = 0; j < kChunk; ++j) {
      const float4 pa = *reinterpret_cast<const float4*>(p_s + j * kMaxG);
      const float4 pb =
          *reinterpret_cast<const float4*>(p_s + j * kMaxG + 4);
      const float p8[kMaxG] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
#pragma unroll
      for (int ii = 0; ii < kPairs; ++ii) {
        const int d = 2 * lane + 64 * ii;
        if (d < DH) {
          const float2 vv = Elt<T>::pair(vst + j * kRow + d * isz);
#pragma unroll
          for (int g = 0; g < KG; ++g) {
            acc[g][ii].x += p8[g] * vv.x;
            acc[g][ii].y += p8[g] * vv.y;
          }
        }
      }
    }
    __syncwarp();  // this stage and p_s are rewritten next
    if (i + stages < n_chunks)
      issue_chunk<T, DH>(wbase + (i % stages) * stage_b, off_s,
                         s0 + (c_first + kWarps * (i + stages)) * kChunk, row,
                         k_pool, v_pool, k_tok, v_tok, KVd, h, lane);
    cp_async_commit();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncwarp();

  // 4. the warp's partial into its own (now idle) stage ring
  float* wp = reinterpret_cast<float*>(wbase);
  if (lane < 4) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      wp[n0 + hh] = m_run[hh];
      wp[kMaxG + n0 + hh] = l_run[hh];
    }
  }
#pragma unroll
  for (int g = 0; g < KG; ++g)
#pragma unroll
    for (int ii = 0; ii < kPairs; ++ii) {
      const int d = 2 * lane + 64 * ii;
      if (g < G && d < DH)
        *reinterpret_cast<float2*>(wp + 2 * kMaxG + g * DH + d) = acc[g][ii];
    }
  __syncthreads();

  // 5. the CTA's partial: its warps combined in warp order
  const int wstride = warp_bytes(DH, isz, stages) / 4;   // in floats
  const float* w0 = reinterpret_cast<const float*>(
      smem + part_bytes(G, DH) + pages_bytes(split, ps));
  for (int e = tid; e < G * DH; e += kThreads) {
    const int g = e / DH;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, w0[w * wstride + g]);
    float l = 0.f, o = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* x = w0 + w * wstride;
        const float f = expf(x[g] - M);       // 0 for a warp with no key
        l += f * x[kMaxG + g];
        o += f * x[2 * kMaxG + e];
      }
    }
    part[2 * kMaxG + e] = o;
    if (e % DH == 0) {
      part[g] = M;
      part[kMaxG + g] = l;
    }
  }
  cluster.sync();

  // 6. CTA r combines its share of o's elements over the cluster's
  //    partials, in rank order
  {
    uint32_t parts[kMaxCluster];
#pragma unroll
    for (int r = 0; r < kMaxCluster; ++r)
      if (r < C) parts[r] = map_rank(part, r);
    T* o_out = out + bh * G * DH;
    const int share = (G * DH + C - 1) / C;
    const int e_hi = min(G * DH, (rank + 1) * share);
    for (int e = rank * share + tid; e < e_hi; e += kThreads) {
      const int g = e / DH;
      float m[kMaxCluster], l_r[kMaxCluster], o_r[kMaxCluster];
      float M = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < C) {
          m[r] = ld_cluster(parts[r] + 4 * g);
          l_r[r] = ld_cluster(parts[r] + 4 * (kMaxG + g));
          o_r[r] = ld_cluster(parts[r] + 4 * (2 * kMaxG + e));
          M = fmaxf(M, m[r]);
        }
      }
      float l = 0.f, o = 0.f;
      if (M != -INFINITY) {
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < C) {
            const float f = expf(m[r] - M);
            l += f * l_r[r];
            o += f * o_r[r];
          }
        }
      }
      o_out[e] = Elt<T>::from(l > 0.f ? o / l : 0.f);
    }
  }
  cluster.sync();  // no CTA leaves while another reads its shared memory
}

template <typename T, int DH, int KG>
cudaError_t launch_kernel(const cudaLaunchConfig_t& cfg, const void* q,
                          const void* k_new, const void* v_new, void* k_pool,
                          void* v_pool, const int* page_table,
                          const int* seq_lens, void* out, int KVd, int G,
                          int ps, int P, float scale, int window, int split,
                          int stages) {
  auto kernel = paged_attn_cluster_kernel<T, DH, KG>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return err;
  return cudaLaunchKernelEx(&cfg, kernel, (const T*)q, (const T*)k_new,
                            (const T*)v_new, (T*)k_pool, (T*)v_pool,
                            page_table, seq_lens, (T*)out, KVd, G, ps, P,
                            scale, window, split, stages);
}

template <typename T, int DH>
cudaError_t launch_dh(const cudaLaunchConfig_t& cfg, const void* q,
                      const void* k_new, const void* v_new, void* k_pool,
                      void* v_pool, const int* page_table,
                      const int* seq_lens, void* out, int KVd, int G, int ps,
                      int P, float scale, int window, int split, int stages) {
#define PAGED_KG(KG)                                                        \
  if (G <= KG)                                                              \
    return launch_kernel<T, DH, KG>(cfg, q, k_new, v_new, k_pool, v_pool,   \
                                    page_table, seq_lens, out, KVd, G, ps,  \
                                    P, scale, window, split, stages);
  PAGED_KG(1)
  PAGED_KG(2)
  PAGED_KG(4)
  PAGED_KG(8)
#undef PAGED_KG
  return cudaErrorInvalidValue;
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_pool,
           void* v_pool, const int* page_table, const int* seq_lens,
           void* out, int B, int KVd, int G, int Dh, int ps, int P,
           float scale, int window, int cluster, int split, int stages,
           void* stream) {
  if (G < 1 || G > kMaxG || (Dh != 16 && Dh != 64 && Dh != 128 && Dh != 256) ||
      ps < 1 || KVd < 1 || KVd > 65535 || B > 65535 || P < 1 ||
      cluster < 1 || cluster > kMaxCluster || split < kWarps * kChunk ||
      split % (kWarps * kChunk) || stages < 1 || stages > 2 ||
      (long long)split * cluster < (long long)P * ps ||
      (long long)split * (cluster - 1) >= (long long)P * ps)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, KVd, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem_bytes(G, Dh, sizeof(T), split, ps, stages);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t err;
  switch (Dh) {
#define PAGED_DH(DH)                                                        \
  case DH:                                                                  \
    err = launch_dh<T, DH>(cfg, q, k_new, v_new, k_pool, v_pool,            \
                           page_table, seq_lens, out, KVd, G, ps, P, scale, \
                           window, split, stages);                          \
    break;
    PAGED_DH(16)
    PAGED_DH(64)
    PAGED_DH(128)
    PAGED_DH(256)
#undef PAGED_DH
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

#define PAGED_ATTN_ENTRY(NAME, T)                                             \
  extern "C" int NAME(const void* q, const void* k_new, const void* v_new,  \
                      void* k_pool, void* v_pool, const int* page_table,     \
                      const int* seq_lens, void* out, int B, int KVd, int G, \
                      int Dh, int ps, int P, float scale, int window,        \
                      int cluster, int split, int stages, void* stream) {    \
    return launch<T>(q, k_new, v_new, k_pool, v_pool, page_table, seq_lens,  \
                     out, B, KVd, G, Dh, ps, P, scale, window, cluster,      \
                     split, stages, stream);                                 \
  }

PAGED_ATTN_ENTRY(paged_attention_step_bf16, __nv_bfloat16)
PAGED_ATTN_ENTRY(paged_attention_step_f32, float)
