// The ZO noise, shared by the noise kernels of csrc/: z for zo_perturb.cu
// and zo_fused_replay.cu, the int8 lane's noise and rounding for
// int8_perturb.cu and zo_fused_replay_int8.cu.
//
// z = Box-Muller over two murmur-fmix32 streams of (global flat index,
// salt 2s+1 / 2s+2, seed), op for op src/repro_torch/core/prng.py::normal
// (and src/repro/core/prng.py::normal). The hash runs in native uint32
// (multiplication wraps). Every float multiply and add is written with
// __fmul_rn / __fadd_rn so that nvcc cannot contract them into an FMA,
// and the transcendentals are the precise logf / cosf and an IEEE sqrt:
// PyTorch's CUDA log, cos and sqrt use the same functions, so the plain
// version on the card gives the same bits. Never build with
// --use_fast_math.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace zo {

constexpr uint32_t kM1 = 0x85EBCA6Bu;
constexpr uint32_t kM2 = 0xC2B2AE35u;
constexpr uint32_t kPhi = 0x9E3779B9u;
constexpr float kTwoPi = 6.28318548202514648438f;  // float32(2 pi)

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kM1;
  h ^= h >> 13;
  h *= kM2;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t hash_bits(uint32_t idx, uint32_t salt,
                                              uint32_t seed) {
  uint32_t h = idx * kPhi + salt;
  h = fmix32(h ^ seed);
  return fmix32(h + seed * kM2);
}

__device__ __forceinline__ float normal(uint32_t idx, uint32_t seed,
                                        uint32_t salt) {
  const uint32_t b1 = hash_bits(idx, 2u * salt + 1u, seed);
  const uint32_t b2 = hash_bits(idx, 2u * salt + 2u, seed);
  const float u1 =
      __fadd_rn(__fmul_rn(__uint2float_rn(b1 >> 8), 0x1p-24f), 0x1p-25f);
  const float u2 = __fmul_rn(__uint2float_rn(b2 >> 8), 0x1p-24f);
  const float r = __fsqrt_rn(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

// Element type: load to f32, store from f32 (bf16 rounds to nearest even,
// as tensor.to(torch.bfloat16) does), and the per-step cast round trip.
template <typename T>
struct Elt;

template <>
struct Elt<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Elt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
};

// VEC consecutive elements, loaded and stored as one 16-byte access when
// VEC * sizeof(T) == 16 (the wrapper picks VEC = 1 for unaligned pointers).
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

constexpr int kThreads = 256;

// Blocks for a grid-stride loop over `blocks` blocks' worth of work:
// enough to fill the card's 132 SMs many times over, no more.
inline unsigned grid_cap(size_t blocks) {
  const size_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return blocks ? static_cast<unsigned>(blocks) : 1u;
}

// Blocks for a grid-stride loop over `items` work items of a thread each.
inline unsigned grid_for(size_t items) {
  return grid_cap((items + kThreads - 1) / kThreads);
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

// ---- a shard's global flat indices ---------------------------------------
//
// A rank's shard of a sharded leaf holds elements whose global flat indices
// are strided: local element e (row-major over extents e0 x e1 x e2) sits
// at base + i0 * s0 + i1 * s1 + i2 * s2 (src/repro_torch/core/prng.py::
// IndexMap, at most three levels after contiguous dims merge). The kernels
// split a local index into (run, column) with Lemire's 32-bit fastdiv
// (one 64-bit high multiply a division, no division instruction), once
// per 16-byte vector: a vector never crosses a run, since the wrapper takes
// the vector path only where VEC divides e2. Every global index is below
// 2^32 (the wrapper holds the map's largest), so the sums cannot wrap.
struct Map3 {
  uint64_t m1, m2;     // ceil(2^64 / e1), ceil(2^64 / e2) mod 2^64 (0: e = 1)
  uint32_t e1, e2;     // the inner two extents (e0 = n / (e1 * e2))
  uint32_t s0, s1, s2;
  uint32_t base;
};

// floor(a / d) for every uint32 a and 1 <= d < 2^32, from m = ceil(2^64 /
// d) mod 2^64 (Lemire, Kaser and Kurz 2019: a 64-bit m is exact for a
// 32-bit numerator); m = 0 stands for d = 1.
__device__ __forceinline__ uint32_t fastdiv(uint32_t a, uint64_t m) {
  return m ? static_cast<uint32_t>(__umul64hi(m, a)) : a;
}

// The global flat index of local element e.
__device__ __forceinline__ uint32_t map_index(uint32_t e, const Map3& m) {
  const uint32_t r = fastdiv(e, m.m2);
  const uint32_t c = e - r * m.e2;
  const uint32_t i0 = fastdiv(r, m.m1);
  const uint32_t i1 = r - i0 * m.e1;
  return m.base + i0 * m.s0 + i1 * m.s1 + c * m.s2;
}

// ---- the int8 lane ------------------------------------------------------
//
// The sparse uniform noise z = m * u of Alg. 2, op for op
// src/repro_torch/core/int8.py::int8_noise: u = bits_u mod (2 r_max + 1)
// - r_max from salt 3s+1, kept where float32(bits_m) < keep_thresh, bits_m
// from salt 3s+2 (keep_thresh = (1 - p_zero) * 2^32, rounded in f32). The
// kernels take both from integers only: the host passes the least uint32
// T with float32(T) >= keep_thresh (kernels/zo_perturb.py::keep_bound;
// rounding to nearest is monotone, so the tests agree for every bits_m),
// and the remainder is Lemire's fastmod. Salts are below 2^30, so 3s+2
// stays below 2^32.

// h ^ (h >> 16), fmix32's first and last step. A logical shift
// distributes over xor, so xs16(a ^ b) == xs16(a) ^ xs16(b): the seed's
// share of hash_bits's first step is taken once a record.
__device__ __forceinline__ uint32_t xs16(uint32_t h) { return h ^ (h >> 16); }

// hash_bits(idx, salt, seed) from t = xs16(idx * kPhi + salt) ^
// xs16(seed) and sm2 = seed * kM2: the rest of the first fmix32, the seed
// added, the second fmix32.
__device__ __forceinline__ uint32_t hash_tail(uint32_t t, uint32_t sm2) {
  uint32_t h = t * kM1;
  h ^= h >> 13;
  h *= kM2;
  return fmix32(xs16(h) + sm2);
}

// The per-launch constants of the int8 noise, from the host.
struct Int8Noise {
  uint64_t magic;        // ceil(2^64 / d) mod 2^64 (0 for d = 1)
  uint32_t d;            // 2 r_max + 1
  int r_max;
  uint32_t keep_below;   // keep where bits_m < keep_below ...
  uint32_t keep_all;     // ... or everywhere (no uint32 reaches keep_thresh)
};

// a mod d for every uint32 a and 1 <= d < 2^32: ((magic * a mod 2^64) * d)
// >> 64 (Lemire, Kaser and Kurz, "Faster remainder by direct computation",
// 2019, Theorem 1 with N = 32 and F = 64), the 96-bit product taken in
// 32-bit pieces.
__device__ __forceinline__ uint32_t fastmod(uint32_t a, const Int8Noise& nz) {
  const uint64_t low = nz.magic * a;
  const uint64_t q = static_cast<uint64_t>(static_cast<uint32_t>(low >> 32)) *
                         nz.d +
                     __umulhi(static_cast<uint32_t>(low), nz.d);
  return static_cast<uint32_t>(q >> 32);
}

// c * z of one element from its two hashes, wrapping as int32 does:
// c * (r - r_max) = c * r - c_rmax where kept, else 0.
__device__ __forceinline__ int scaled_noise(uint32_t bits_u, uint32_t bits_m,
                                            uint32_t c, uint32_t c_rmax,
                                            const Int8Noise& nz) {
  const uint32_t cz = c * fastmod(bits_u, nz) - c_rmax;
  return bits_m < nz.keep_below || nz.keep_all ? static_cast<int>(cz) : 0;
}

// Pseudo-stochastic rounding of x right by s bits, op for op
// src/repro/core/int8.py::psr_shift in int32 (|INT_MIN| stays INT_MIN),
// with XLA's rule for shift counts outside [0, 32): 0 for a left or
// logical shift. The count is the same for a whole launch, so the host
// picks one of three forms and the kernel is built for each.
enum PsrMode { kPsrNone = 0, kPsrShift = 1, kPsrWide = 2 };

struct Psr {
  uint32_t s;        // kPsrShift: the count, 0 < s < 32
  uint32_t low;      // kPsrShift: 2^s - 1
  uint32_t c;        // kPsrShift: 32 - s
  uint32_t wide32;   // kPsrWide: s == 32 (the threshold is h), else s > 32 (0)
};

template <int MODE>
__device__ __forceinline__ int psr(int x, const Psr& ps) {
  if (MODE == kPsrNone) return x;   // s <= 0: out = |x|, times sign(x)
  const uint32_t mag =
      x < 0 ? 0u - static_cast<uint32_t>(x) : static_cast<uint32_t>(x);
  uint32_t out;
  if (MODE == kPsrShift) {
    const uint32_t rem = mag & ps.low;            // < 2^31: a signed compare
    const uint32_t h = xs16((rem * kPhi) ^ mag);  // is an unsigned one
    out = (mag >> ps.s) + ((h >> ps.c) < rem ? 1u : 0u);
  } else {                                        // base 0, rem = mag
    const uint32_t h = xs16((mag * kPhi) ^ mag);
    const int thresh = ps.wide32 ? static_cast<int>(h) : 0;
    out = thresh < static_cast<int>(mag) ? 1u : 0u;
  }
  return static_cast<int>(x < 0 ? 0u - out : out);   // x == 0 gives out 0
}

__device__ __forceinline__ int clamp127(int v) {
  return v < -127 ? -127 : (v > 127 ? 127 : v);
}

// A table of int8 leaves, passed by value as a kernel parameter, so that
// one launch covers every leaf of a model. The leaves are cut into tiles
// of kThreads * VEC elements; leaf i holds tiles [tile0, tile_end), and a
// block walks tiles in a grid-stride loop, finding each tile's leaf by
// moving forward through the table. Every element keeps its leaf's flat
// index and salt.
constexpr int kMaxLeaves = 64;     // kernels/zo_perturb.py::MAX_LEAVES

struct Leaf {
  const int8_t* in;
  int8_t* out;                     // may be `in` itself; leaves do not overlap
  uint32_t n;
  uint32_t salt1;                  // 3 * salt + 1 (bits_u; bits_m is + 1)
  uint32_t tile0, tile_end;
  uint32_t vec_ok;                 // in and out aligned to VEC bytes
  uint32_t pad;
};

struct LeafTable {
  Leaf leaf[kMaxLeaves];
  uint32_t tiles;
};

// Runs f(x, first, step, salt1) on every tile: x[j] is element first + j *
// step of the tile's leaf (int32, zero past the end; stores past the end are
// dropped). A whole in-range run of VEC elements of an aligned leaf moves
// as one VEC-byte access (step 1); a partial run (the ragged tail) or an
// unaligned leaf goes element by element, step 1 or kThreads (coalesced).
template <int VEC, class F>
__device__ __forceinline__ void for_each_tile(const LeafTable& t, F&& f) {
  using P = Pack<int8_t, VEC>;
  int l = 0;
  for (uint32_t tile = blockIdx.x; tile < t.tiles; tile += gridDim.x) {
    while (tile >= t.leaf[l].tile_end) ++l;
    const Leaf& L = t.leaf[l];
    const uint64_t lo = static_cast<uint64_t>(tile - L.tile0) * (kThreads * VEC);
    const uint64_t first = lo + threadIdx.x * VEC;
    int x[VEC];
    if (__builtin_expect(L.vec_ok && first + VEC <= L.n, 1)) {
      P p = *reinterpret_cast<const P*>(L.in + first);
#pragma unroll
      for (int j = 0; j < VEC; ++j) x[j] = p.v[j];
      f(x, static_cast<uint32_t>(first), 1u, L.salt1);
#pragma unroll
      for (int j = 0; j < VEC; ++j) p.v[j] = static_cast<int8_t>(x[j]);
      *reinterpret_cast<P*>(L.out + first) = p;
      continue;
    }
    const uint64_t base = L.vec_ok ? first : lo + threadIdx.x;
    const uint32_t step = L.vec_ok ? 1u : static_cast<uint32_t>(kThreads);
    if (base >= L.n) continue;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint64_t e = base + static_cast<uint64_t>(j) * step;
      x[j] = e < L.n ? L.in[e] : 0;
    }
    f(x, static_cast<uint32_t>(base), step, L.salt1);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint64_t e = base + static_cast<uint64_t>(j) * step;
      if (e < L.n) L.out[e] = static_cast<int8_t>(x[j]);
    }
  }
}

// Fills the leaf table from the wrapper's rows (count x {in, out, n,
// salt}, uint64) and returns the elements a thread takes: 16 where that
// still gives two tiles to each of the 132 SMs, else 4 (LeNet-5's 107,550
// elements make 107 tiles of 1,024). Returns 0 for a table that does not
// fit.
inline int leaf_table(const uint64_t* rows, int count, LeafTable* t) {
  if (count < 1 || count > kMaxLeaves) return 0;
  auto tiles_at = [&](int vec) {
    uint64_t tiles = 0;
    for (int i = 0; i < count; ++i)
      tiles += (rows[4 * i + 2] + kThreads * vec - 1) / (kThreads * vec);
    return tiles;
  };
  const int vec = tiles_at(16) >= 2 * 132 ? 16 : 4;
  if (tiles_at(vec) >= (1ull << 31)) return 0;
  uint32_t tiles = 0;
  for (int i = 0; i < count; ++i) {
    const uint64_t* r = rows + 4 * i;
    Leaf& L = t->leaf[i];
    L.in = reinterpret_cast<const int8_t*>(r[0]);
    L.out = reinterpret_cast<int8_t*>(r[1]);
    L.n = static_cast<uint32_t>(r[2]);
    L.salt1 = 3u * static_cast<uint32_t>(r[3]) + 1u;
    L.tile0 = tiles;
    tiles += static_cast<uint32_t>((r[2] + kThreads * vec - 1) /
                                   (kThreads * vec));
    L.tile_end = tiles;
    L.vec_ok = ((r[0] | r[1]) % vec) == 0;
    L.pad = 0;
  }
  t->tiles = tiles;
  return vec;
}

inline Int8Noise int8_noise_consts(int r_max, uint64_t magic,
                                   uint64_t keep_below) {
  Int8Noise nz;
  nz.magic = magic;
  nz.d = 2u * static_cast<uint32_t>(r_max) + 1u;
  nz.r_max = r_max;
  nz.keep_below = static_cast<uint32_t>(keep_below);
  nz.keep_all = keep_below > 0xFFFFFFFFull;
  return nz;
}

}  // namespace zo
