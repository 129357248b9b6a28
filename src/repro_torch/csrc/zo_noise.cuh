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

// The int8 lane's sparse uniform noise z = m * u (Alg. 2), op for op
// src/repro_torch/core/int8.py::int8_noise: u = bits_u mod (2 r_max + 1)
// - r_max from salt 3s+1, and the keep test float32(bits_m) < keep_thresh
// from salt 3s+2 (keep_thresh = (1 - p_zero) * 2^32, rounded in f32 by
// the caller). Salts are below 2^30, so 3s+2 stays below 2^32.
__device__ __forceinline__ int int8_noise(uint32_t idx, uint32_t seed,
                                          uint32_t salt, int r_max,
                                          float keep_thresh) {
  const uint32_t bu = hash_bits(idx, 3u * salt + 1u, seed);
  const uint32_t bm = hash_bits(idx, 3u * salt + 2u, seed);
  const int u = static_cast<int>(bu % static_cast<uint32_t>(2 * r_max + 1)) -
                r_max;
  return __uint2float_rn(bm) < keep_thresh ? u : 0;
}

// Pseudo-stochastic rounding of x right by s bits, op for op
// src/repro/core/int8.py::psr_shift in int32/uint32, with XLA's rule for
// shift counts outside [0, 32) (0 for left and logical shifts), which C++
// leaves undefined: every shift below checks its count first.
__device__ __forceinline__ int psr_shift(int x, int s) {
  const uint32_t us = static_cast<uint32_t>(s);
  const bool in_range = us < 32u;
  const int mag = x < 0 ? static_cast<int>(0u - static_cast<uint32_t>(x)) : x;
  const uint32_t umag = static_cast<uint32_t>(mag);
  const int base = in_range ? static_cast<int>(umag >> us) : 0;
  const int rem =
      mag - (in_range ? static_cast<int>(static_cast<uint32_t>(base) << us)
                      : 0);
  uint32_t h = (static_cast<uint32_t>(rem) * kPhi) ^ umag;
  h ^= h >> 16;
  const uint32_t c = 32u - us;
  const int thresh = static_cast<int>(c < 32u ? h >> c : 0u);
  const int out = s > 0 ? base + (thresh < rem ? 1 : 0) : mag;
  if (x > 0) return out;
  return x < 0 ? static_cast<int>(0u - static_cast<uint32_t>(out)) : 0;
}

__device__ __forceinline__ int clamp127(int v) {
  return v < -127 ? -127 : (v > 127 ? 127 : v);
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

// Blocks for a grid-stride loop over `items` work items: enough to fill
// the card's 132 SMs many times over, no more.
inline unsigned grid_for(size_t items) {
  size_t blocks = (items + kThreads - 1) / kThreads;
  const size_t cap = 132 * 16;
  if (blocks > cap) blocks = cap;
  return blocks ? static_cast<unsigned>(blocks) : 1u;
}

inline bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15u) == 0;
}

}  // namespace zo
