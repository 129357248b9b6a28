// flash_attention: causal / sliding-window attention with the online
// softmax, forward only, f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn.py:79
// (flash_attention, pallas_call at :93). It carries every attention of
// the port's gradient-free forwards: the ZO head's probe forwards and the
// serving prefill (models/layers.py::attention).
//
// Function (the plain version is kernels/ref.py::flash_attention_ref):
// q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> o [B,H,Sq,D] in q's dtype; q head h
// reads kv head h / (H / Hkv). Scores s = (q . k) * scale in f32; query
// row i sits at position p = q_offset + i (0 for the TPU kernel's
// function; a rank's rows of a sequence-sharded attention start further
// on), and the causal and window masks are aligned to it (k <= p,
// k > p - window): top-left at offset 0. They set a masked score to
// -1e30, as the TPU kernel does, so a row with
// no visible key averages V over all Sk keys, as the reference does; a
// key past Sk scores -inf. The result is acc / max(l, 1e-30). Given an
// lse buffer, each row's log-sum-exp m + log(max(l, 1e-30)) is written
// too (f32 [B,H,Sq]: a rank's partial attention over its share of the
// keys, which a context-parallel decode combines across ranks); the
// output's arithmetic is the same with or without it. Any Sq,
// Sk >= 1; D in {16, 64, 128}; f32 or bf16. Each of q, k, v, o is
// addressed through its own (b, h, s) element strides with a contiguous
// last dim, so the model's transposed [B,S,H,D] views need no copy. Key
// tiles that the masks remove for every row of a block are skipped
// (exact: the TPU kernel multiplies them away with a rescale of
// exp(-1e30 - m) = 0); a block holding a row that sees no key walks
// every tile. Longest query tiles are scheduled first. No atomics: the
// result is the same bits on every run.
//
// Bound on an H100 SXM: operations, 4 * B * H * D per visible (q, k)
// pair (two products of D multiply-adds). At qwen3-4b's S 4096, H 32,
// D 128 causal that is 1.375e11: 0.139 ms on the bf16 tensor cores; the
// bytes (q, k, v read once, o written once) take 0.025 ms.
//
// bf16 (flash_tc): Hopper's tensor cores through wgmma. A block of two
// consumer warpgroups owns 128 query rows (64 a warpgroup) and walks key
// tiles of 64, with a ring of four K/V stages in shared memory filled by
// cp.async two tiles ahead (16-byte copies, zero-filled past Sk; element
// copies when a view is not 16-byte aligned), so loads overlap the
// products. Q, K and V tiles sit in the swizzled layout the wgmma
// descriptors name (128-byte rows, or 32-byte rows at D 16).
//  - S = Q K^T: wgmma m64n64k16, both operands from shared memory, K
//    K-major as stored (D contiguous). bf16 x bf16 products are exact in
//    f32, so S is the f32 result up to summation order.
//  - Online softmax in f32 on the accumulator fragments: a row's 64
//    scores lie on the four threads of a quad (max by two shuffles); each
//    thread keeps its share of the row sum and the quad adds them once at
//    the end.
//  - P V with P split in registers into three bf16 terms, hi = bf16(p),
//    mid = bf16(p - hi), lo = bf16(p - hi - mid). Three 8-bit
//    significands carry all 24 bits of f32's, so each product with a
//    bf16 V is exact and the sum differs from the f32 plain version by
//    order only, which keeps the bf16 output within one bf16 ulp of it. A
//    single bf16 rounding of P puts ~12% of the outputs of a qwen3-4b
//    shaped case beyond that, and two terms (hi + lo) still a few (CPU
//    simulation of the three choices against the plain version). So P V
//    is three wgmma m64nDk16 a 16-key slice, A from registers (the S
//    accumulator's layout is wgmma's A-fragment layout), B the V tile
//    MN-major (its D is contiguous) with the transpose bit. The tensor
//    work is 2x the one-product bound, a 0.278 ms floor at the case above.
//  - A tile's P V goes into a fresh accumulator that is added to O in f32
//    (O = O alpha + P V): the tensor cores truncate as they accumulate,
//    and carried in one accumulator across a row's key tiles that error
//    grows with |O| (at S 4096 it put hundreds of outputs of large scores
//    beyond one ulp of a float64 result; per tile, none at q x 4).
//  - Tile i's P V runs on the tensor cores while tile i + 1's softmax runs
//    on the CUDA cores: each step issues S of this tile, then P V of the
//    last one, waits for S only, and folds P V in after the softmax.
//    Every branch around a wgmma is the same for the whole block (ptxas
//    serialises wgmma near divergent paths), so both warpgroups walk all
//    of the block's tiles and the mask test uses the block's rows.
// f32 (flash_fwd): the CUDA cores. TF32 would break the 1e-5 agreement
// with the plain version, and only the reduced f32 model runs this path:
// one block of 256 threads per (query tile of 64, head, batch row); Q in
// shared memory as f32; a loop over key tiles of 64 with K and V in
// shared memory; each thread holds a 4 x 4 block of scores and a 4 x D/16
// block of the output in registers, with the running max and sum of its
// 4 rows (the 16 threads of a row group reduce with warp shuffles).
// Padded rows make every shared-memory read conflict-free and P^T reuses
// the K buffer.
//
// C interface (ctypes): returns the CUDA error of the launch (0 if none).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
  int q_off;          // the position of query row 0
  float* lse;         // [B, H, Sq] row log-sum-exps, or null
};

// The key range [begin, end) that the rows q_first..q_last (positions
// q_off + q_first ..) can see; the whole of [0, Sk) when one of them sees
// no key (it averages all of them).
struct KeyRange {
  int begin, end;
};

// (The wrapper keeps q_off + Sq below 2**31, so positions fit an int.)
__device__ __forceinline__ KeyRange visible_keys(const Args& a, int q_first,
                                                 int q_last) {
  const int p_first = q_first + a.q_off, p_last = q_last + a.q_off;
  KeyRange r{a.window > 0 ? max(0, p_first - a.window + 1) : 0,
             a.causal ? min(a.Sk, p_last + 1) : a.Sk};
  if (a.window > 0 && p_last >= a.Sk + a.window - 1) r = KeyRange{0, a.Sk};
  return r;
}

// Whether the row at position p sees key ki.
__device__ __forceinline__ bool seen_by(const Args& a, int ki, int p) {
  return (!a.causal || ki <= p) && (a.window <= 0 || ki > p - a.window);
}

// ------------------------------------------------------------------ //
// f32: CUDA cores
// ------------------------------------------------------------------ //
constexpr int kBQ = 64;           // queries a block
constexpr int kBK = 64;           // keys a tile
constexpr int kThreads = 256;     // 16 x 16: ty owns rows, tx columns

template <int D>
struct Layout {
  static constexpr int LD = D + 4;          // Q and K rows, padded
  static constexpr int LP = kBK + 4;        // P^T rows, padded
  static constexpr int KBUF = (kBK * LD > kBK * LP) ? kBK * LD : kBK * LP;
  static constexpr int FLOATS = kBQ * LD + KBUF + kBK * D;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr bool VEC = D % 64 == 0;  // float4 reads of V
  static constexpr int NC = D / 16;         // output columns a thread
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// output column of a thread's c-th value
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  return Layout<D>::VEC ? (c / 4) * 64 + tx * 4 + (c % 4) : c * 16 + tx;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(Args a) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* Ks = Qs + kBQ * L::LD;                 // [kBK][LD]; P^T [kBK][LP]
  float* Vs = Ks + L::KBUF;                     // [kBK][D]
  float* Ps = Ks;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int p0 = q0 + a.q_off + ty * 4;                // row ty * 4's position
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * L::LD + c] = qi < a.Sq ? qp[qi * a.q_ss + c] : 0.f;
  }

  const KeyRange keys = visible_keys(a, q0, min(q0 + kBQ, a.Sq) - 1);

  float m[4], l[4], acc[4][L::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (keys.begin / kBK) * kBK; k0 < keys.end; k0 += kBK) {
    __syncthreads();      // the last tile's P^T and V reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, ki = k0 + r;
      const bool in = ki < a.Sk;
      Ks[r * L::LD + c] = in ? kp[ki * a.k_ss + c] : 0.f;
      Vs[r * D + c] = in ? vp[ki * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * L::LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * L::LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
    __syncthreads();      // every K read is done before P^T overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        const bool seen = seen_by(a, ki, p0 + i);
        const float x = ki >= a.Sk ? -CUDART_INF_F
                                   : (seen ? s[i][j] * a.scale : kNegInf);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * L::LP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * L::LP + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
      if constexpr (L::VEC) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[c * D + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g * 4 + 0] += pr[i] * vv.x;
            acc[i][g * 4 + 1] += pr[i] * vv.y;
            acc[i][g * 4 + 2] += pr[i] * vv.z;
            acc[i][g * 4 + 3] += pr[i] * vv.w;
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < L::NC; ++g) {
          const float vv = Vs[c * D + g * 16 + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][g] += pr[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < L::NC; ++c)
      op[qi * a.o_ss + out_col<D>(tx, c)] = acc[i][c] / den;
    if (a.lse != nullptr && tx == 0)
      a.lse[(static_cast<long long>(b) * a.H + h) * a.Sq + qi] =
          m[i] + logf(den);
  }
}

template <int D>
int go(const Args& a, cudaStream_t stream) {
  const int bytes = Layout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd<D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------------ //
// bf16: tensor cores (wgmma)
// ------------------------------------------------------------------ //
namespace tc {

constexpr int kBQ = 128;          // queries a block: two warpgroups of 64
constexpr int kBK = 64;           // keys a tile
constexpr int kThreads = 256;
constexpr int kStages = 4;        // K/V tiles in the shared-memory ring
constexpr int kAhead = kStages - 2;   // tiles loaded ahead: a tile's V is
                                      // read one iteration after its K

// Shared-memory tiles of R rows x D bf16: [D / (RB / 2)][R][RB bytes],
// each 16-byte chunk moved by the swizzle (bits 4-6 of the byte offset
// XOR bits 7-9; bit 4 XOR bit 7 for 32-byte rows), as wgmma reads them.
template <int D>
struct Tile {
  static constexpr int RB = D == 16 ? 32 : 128;    // bytes a swizzled row
  static constexpr int PER_ROW = RB / 2;           // elements a row
  static constexpr uint32_t MASK = D == 16 ? 1 : 7;
  static constexpr uint64_t LAYOUT = D == 16 ? 3 : 1;   // 32B / 128B swizzle
  static constexpr int Q_BYTES = kBQ * D * 2;
  static constexpr int KV_BYTES = kBK * D * 2;
  static constexpr int BYTES = 1024 + Q_BYTES + kStages * 2 * KV_BYTES;
};

// byte offset of element (r, c) (c a multiple of 8) in a tile of R rows
template <int D>
__device__ __forceinline__ uint32_t swizzled(int R, int r, int c) {
  using L = Tile<D>;
  const uint32_t off = (c / L::PER_ROW) * R * L::RB + r * L::RB +
                       (c % L::PER_ROW) * 2;
  return off ^ (((off >> 7) & L::MASK) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units) and the swizzle mode
__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo, uint64_t mode) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (mode << 62);
}

// R rows from row r0 of a [rows, D] bf16 view with row stride ss into the
// tile at dst; rows at or past `limit` are zeros. vec: every 16-byte
// chunk is aligned, so cp.async moves it; otherwise element loads.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src,
                                          long long ss, int r0, int R,
                                          int limit, bool vec, int tid) {
  constexpr int CH = D / 8;
  for (int e = tid; e < R * CH; e += kThreads) {
    const int r = e / CH, c = (e % CH) * 8;
    const uint32_t s = dst + swizzled<D>(R, r, c);
    const bool in = r0 + r < limit;
    const __nv_bfloat16* g = src + (in ? (r0 + r) * ss : 0) + c;
    if (vec) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                   "l"(g), "r"(in ? 16 : 0)
                   : "memory");
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (in) {
        const unsigned short* x = reinterpret_cast<const unsigned short*>(g);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = static_cast<uint32_t>(x[2 * i]) |
                 (static_cast<uint32_t>(x[2 * i + 1]) << 16);
      }
      asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(s),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep registers that an asynchronous wgmma reads or writes in place
// until the wait that ends it.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(i)                                                          \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),          \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : F8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


#undef F8

// scale_d 0: o = P V, ignoring o's old value; 1: o += P V
template <int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  if constexpr (D == 16)
    wgmma_rs_n16(o, a, db, scale_d);
  else if constexpr (D == 64)
    wgmma_rs_n64(o, a, db, scale_d);
  else
    wgmma_rs_n128(o, a, db, scale_d);
}

// p = hi + mid + lo exactly, each a bf16 (two lanes packed low first)
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float rx = x - hf.x, ry = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(rx, ry);
  const float2 mf = __bfloat1622float2(m);
  const __nv_bfloat162 l = __floats2bfloat162_rn(rx - mf.x, ry - mf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  mid = *reinterpret_cast<const uint32_t*>(&m);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// grid (query tiles of 128, H, B); 256 threads: warpgroup wg owns query
// rows q0 + 64 wg ..; in it, warp w and lane (g = lane / 4, t = lane % 4)
// hold rows 16 w + g and 16 w + g + 8 of the accumulators, columns
// 8 j + 2 t and 8 j + 2 t + 1 (wgmma's fragment layout).
template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_tc(Args a, int vec) {
  using L = Tile<D>;
  extern __shared__ uint8_t smem[];
  const uint32_t sQ =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem)) + 1023) & ~1023u;
  const uint32_t sKV = sQ + L::Q_BYTES;      // stage s: K, then V

  const int tid = threadIdx.x, wg = tid / 128, w = (tid % 128) / 32;
  const int g = (tid % 32) / 4, t = tid % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                      h * a.o_sh;

  // the key tiles the block walks. Both warpgroups multiply every one of
  // them, so every branch below is the same for the whole block (ptxas
  // serialises wgmma around divergent paths); a tile that the masks
  // remove for all of a row's keys adds exactly 0 to a row that sees a
  // key (its weights exp(-1e30 - m) are 0, or are rescaled to 0).
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  const KeyRange blk = visible_keys(a, q0, q_last);
  const int kt0 = (blk.begin / kBK) * kBK;
  const int nt = (blk.end - kt0 + kBK - 1) / kBK;
  const int wq0 = q0 + 64 * wg;

  auto load_kv = [&](int i) {
    const uint32_t sK = sKV + (i % kStages) * 2 * L::KV_BYTES;
    const int k0 = kt0 + i * kBK;
    load_tile<D>(sK, kp, a.k_ss, k0, kBK, a.Sk, vec, tid);
    load_tile<D>(sK + L::KV_BYTES, vp, a.v_ss, k0, kBK, a.Sk, vec, tid);
  };
  load_tile<D>(sQ, qp, a.q_ss, q0, kBQ, a.Sq, vec, tid);
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    if (i < nt) load_kv(i);
    cp_async_commit();
  }

  const int qi0 = wq0 + 16 * w + g, qi1 = qi0 + 8;
  const int pi0 = qi0 + a.q_off, pi1 = qi1 + a.q_off;   // their positions
  const int pb0 = q0 + a.q_off, pb1 = q_last + a.q_off; // the block's
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  // P of the last tile in three exact bf16 terms (16 keys a slice), the
  // rescale of O it waits for, and its V tile: its P.V runs on the
  // tensor cores while the next tile's softmax runs on the CUDA cores.
  // Before the first tile P is 0 and alpha 1.
  uint32_t ph[4][4], pm[4][4], pl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) ph[kk][r] = pm[kk][r] = pl[kk][r] = 0u;
  float ap0 = 1.f, ap1 = 1.f;
  uint32_t sVp = sKV + L::KV_BYTES;
  // accumulators; each product starts with scale-d 0, which ignores
  // their old value, so they are zeroed once
  float s[32], pv[D / 2];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) pv[i] = 0.f;

  // O = O alpha + P V: the tensor cores sum a tile's P V into a fresh
  // accumulator, which is added in f32 (they truncate as they
  // accumulate; across every key tile of a row that error grows with |O|)
  auto issue_pv = [&]() {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = descriptor(sVp + kk * 16 * L::RB, kBK * L::RB,
                                     8 * L::RB, L::LAYOUT);
      wgmma_pv<D>(pv, ph[kk], dv, kk > 0);
      wgmma_pv<D>(pv, pm[kk], dv, 1);
      wgmma_pv<D>(pv, pl[kk], dv, 1);
    }
    wgmma_commit();
  };
  auto fold_pv = [&]() {
    wgmma_wait<0>();
    hold(pv);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hold(ph[kk]);
      hold(pm[kk]);
      hold(pl[kk]);
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i)
      o[i] = fmaf(o[i], (i & 2) ? ap1 : ap0, pv[i]);
  };

  for (int it = 0; it < nt; ++it) {
    cp_async_wait<kAhead - 1>();           // tile it has landed
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();          // ... for every thread; tile it - 2 is done
    if (it + kAhead < nt) load_kv(it + kAhead);
    cp_async_commit();

    const int k0 = kt0 + it * kBK;
    const uint32_t sK = sKV + (it % kStages) * 2 * L::KV_BYTES;

    // S = Q K^T (f32) of this tile, then P V of the last one
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = (kk * 16) / L::PER_ROW;
      const int in_row = (kk * 16) % L::PER_ROW;
      const uint32_t qa = sQ + col * kBQ * L::RB + 64 * wg * L::RB + in_row * 2;
      const uint32_t ka = sK + col * kBK * L::RB + in_row * 2;
      wgmma_ss_n64(s, descriptor(qa, 16, 8 * L::RB, L::LAYOUT),
                   descriptor(ka, 16, 8 * L::RB, L::LAYOUT), kk > 0);
    }
    wgmma_commit();
    issue_pv();
    wgmma_wait<1>();
    hold(s);

    // online softmax; the mask only where the tile crosses an edge of
    // the block's rows
    const bool inside = k0 + kBK <= a.Sk &&
                        (!a.causal || k0 + kBK - 1 <= pb0) &&
                        (a.window <= 0 || k0 > pb1 - a.window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * a.scale;
      if (!inside) {
        const int ki = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        const bool seen = seen_by(a, ki, (i & 2) ? pi1 : pi0);
        x = ki >= a.Sk ? -CUDART_INF_F : (seen ? x : kNegInf);
      }
      s[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if (i & 2) {
        s[i] = expf(s[i] - mn1);
        ps1 += s[i];
      } else {
        s[i] = expf(s[i] - mn0);
        ps0 += s[i];
      }
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
    fold_pv();

#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
               pm[kk][r], pl[kk][r]);
    ap0 = al0;
    ap1 = al1;
    sVp = sK + L::KV_BYTES;
  }
  issue_pv();               // the P V of the block's last tile
  fold_pv();
  cp_async_wait<0>();

  const float den0 = fmaxf(quad_sum(l0), 1e-30f);
  const float den1 = fmaxf(quad_sum(l1), 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    const int qi = (i & 2) ? qi1 : qi0;
    if (qi < a.Sq)
      op[qi * a.o_ss + 8 * (i / 4) + 2 * t + (i & 1)] =
          __float2bfloat16_rn(o[i] / ((i & 2) ? den1 : den0));
  }
  if (a.lse != nullptr && t == 0) {
    const long long row = (static_cast<long long>(b) * a.H + h) * a.Sq;
    if (qi0 < a.Sq) a.lse[row + qi0] = m0 + logf(den0);
    if (qi1 < a.Sq) a.lse[row + qi1] = m1 + logf(den1);
  }
}

template <int D>
int go(const Args& a, int vec, cudaStream_t stream) {
  const int bytes = Tile<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_tc<D><<<grid, kThreads, bytes, stream>>>(a, vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

Args make_args(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Hkv, int Sq, int Sk, const long long* st,
               float scale, int causal, int window, int q_offset,
               void* lse) {
  return Args{q,     k,     v,     o,     B,      H,      Hkv,   Sq,
              Sk,    st[0], st[1], st[2], st[3], st[4], st[5], st[6],
              st[7], st[8], st[9], st[10], st[11], scale, causal, window,
              q_offset, static_cast<float*>(lse)};
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) of q, k, v, o;
// q_offset: the position of query row 0 (>= 0); lse: null, or f32
// [B, H, Sq] (contiguous) for each row's log-sum-exp of its scaled,
// masked scores, m + log(l) of the online softmax.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Hkv, int Sq, int Sk,
                              int D, const long long* strides, float scale,
                              int causal, int window, int q_offset,
                              void* lse, cudaStream_t stream) {
  const Args a = make_args(q, k, v, o, B, H, Hkv, Sq, Sk, strides, scale,
                           causal, window, q_offset, lse);
  switch (D) {
    case 16:
      return go<16>(a, stream);
    case 64:
      return go<64>(a, stream);
    case 128:
      return go<128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int D, const long long* strides, float scale,
                               int causal, int window, int q_offset,
                               void* lse, cudaStream_t stream) {
  const Args a = make_args(q, k, v, o, B, H, Hkv, Sq, Sk, strides, scale,
                           causal, window, q_offset, lse);
  // cp.async moves 16-byte chunks: every row of q, k, v must start on 16
  // bytes
  bool vec = reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
             reinterpret_cast<uintptr_t>(v) % 16 == 0;
  for (int i = 0; i < 9; ++i) vec = vec && strides[i] % 8 == 0;
  switch (D) {
    case 16:
      return tc::go<16>(a, vec, stream);
    case 64:
      return tc::go<64>(a, vec, stream);
    case 128:
      return tc::go<128>(a, vec, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
