// zo_fused_replay: apply S steps x P probes of ZO records to one leaf in
// one pass. For each step s, in probe order:
//
//   inner = 0;  inner = inner + coeff[s,p] * z(seed[s,p])   (f32, no FMA)
//   x = float(cast(x - inner))                              (per-step cast)
//
// and store cast(x) at the end. S = 1 is the live ZO update of the port's
// ElasticZO step (core/engine.py::Fp32Engine.zo_apply, one launch per ZO
// leaf per step); S > 1 is ledger replay (apply_zo_records). One kernel
// serves both, so an S-step replay equals S live steps bitwise.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_fused_replay.py:58
// (zo_fused_replay, pallas_call at :77).
//
// Bound on an H100 SXM: bytes are one read and one write of theta
// (2 * n * itemsize over 3.35 TB/s, plus the S*P records); operations are
// about 100 per element per record (hash, Box-Muller, three precise
// transcendentals, the mul and add) against 33.5e12 lane operations/s.
// At S*P = 1 the operation bound is already ~2.5x the byte bound, and it
// grows with S*P while the bytes do not: the kernel is bound by
// operations by construction. The design: theta is read and written once
// whatever S is; every block copies the S*P seeds and coefficients from
// device memory into shared memory once; each thread keeps its elements
// in registers in f32 across all steps; 16-byte vector loads and stores;
// a grid-stride loop. In place (out == theta) is allowed: every element
// is read and written by the same thread.
//
// A rank's shard of a sharded leaf replays at its global flat indices:
// zo_fused_replay_map_* take the shard's index map (zo_noise.cuh::Map3)
// as zo_perturb_map_* do, one fastdiv pair a 16-byte vector.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

template <typename T>
__device__ __forceinline__ float replay_one(float x, uint32_t idx,
                                            const uint32_t* seeds,
                                            const float* coeffs, int S, int P,
                                            uint32_t salt) {
  for (int s = 0; s < S; ++s) {
    float inner = 0.0f;
    for (int p = 0; p < P; ++p) {
      const int r = s * P + p;
      inner = __fadd_rn(inner, __fmul_rn(coeffs[r], zo::normal(idx, seeds[r],
                                                               salt)));
    }
    x = zo::Elt<T>::round(__fsub_rn(x, inner));
  }
  return x;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(zo::kThreads)
    zo_replay_kernel(const T* theta, T* out, const uint32_t* seeds,
                     const float* coeffs, int S, int P, uint32_t salt,
                     uint32_t n) {
  using E = zo::Elt<T>;
  using Pk = zo::Pack<T, VEC>;
  extern __shared__ uint32_t smem[];
  uint32_t* s_seed = smem;
  float* s_coef = reinterpret_cast<float*>(smem + S * P);
  for (int r = threadIdx.x; r < S * P; r += blockDim.x) {
    s_seed[r] = seeds[r];
    s_coef[r] = coeffs[r];
  }
  __syncthreads();
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    Pk p = reinterpret_cast<const Pk*>(theta)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t idx = static_cast<uint32_t>(i * VEC + j);
      p.v[j] = E::store(replay_one<T>(E::load(p.v[j]), idx, s_seed, s_coef,
                                      S, P, salt));
    }
    reinterpret_cast<Pk*>(out)[i] = p;
  }
  for (size_t i = nvec * VEC + tid; i < n; i += stride) {
    out[i] = E::store(replay_one<T>(E::load(theta[i]),
                                    static_cast<uint32_t>(i), s_seed, s_coef,
                                    S, P, salt));
  }
}

// The shard form: element e replays at map_index(e). VEC > 1 only where
// VEC divides the run length e2; UNIT: the innermost stride is 1.
template <typename T, int VEC, bool UNIT>
__global__ void __launch_bounds__(zo::kThreads)
    zo_replay_map_kernel(const T* theta, T* out, const uint32_t* seeds,
                         const float* coeffs, int S, int P, uint32_t salt,
                         zo::Map3 m, uint32_t n) {
  using E = zo::Elt<T>;
  using Pk = zo::Pack<T, VEC>;
  extern __shared__ uint32_t smem[];
  uint32_t* s_seed = smem;
  float* s_coef = reinterpret_cast<float*>(smem + S * P);
  for (int r = threadIdx.x; r < S * P; r += blockDim.x) {
    s_seed[r] = seeds[r];
    s_coef[r] = coeffs[r];
  }
  __syncthreads();
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    Pk p = reinterpret_cast<const Pk*>(theta)[i];
    const uint32_t g = zo::map_index(static_cast<uint32_t>(i * VEC), m);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      p.v[j] = E::store(replay_one<T>(E::load(p.v[j]),
                                      g + j * (UNIT ? 1u : m.s2), s_seed,
                                      s_coef, S, P, salt));
    }
    reinterpret_cast<Pk*>(out)[i] = p;
  }
}

template <typename T, int VEC, bool UNIT>
cudaError_t launch_map_vec(const T* t, T* o, const uint32_t* seeds,
                           const float* coeffs, int S, int P, uint32_t salt,
                           const zo::Map3& m, uint32_t n,
                           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * P * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        zo_replay_map_kernel<T, VEC, UNIT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  zo_replay_map_kernel<T, VEC, UNIT><<<zo::grid_for(n / VEC), zo::kThreads,
                                       smem, stream>>>(t, o, seeds, coeffs, S,
                                                       P, salt, m, n);
  return cudaGetLastError();
}

template <typename T>
int launch_map(const void* theta, void* out, const uint32_t* seeds,
               const float* coeffs, int S, int P, uint32_t salt,
               const zo::Map3& m, uint32_t n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* t = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  if (zo::aligned16(theta, out) && m.e2 % kVec == 0) {
    if (m.s2 == 1)      // a run of consecutive indices: the usual shard
      return static_cast<int>(launch_map_vec<T, kVec, true>(
          t, o, seeds, coeffs, S, P, salt, m, n, stream));
    return static_cast<int>(launch_map_vec<T, kVec, false>(
        t, o, seeds, coeffs, S, P, salt, m, n, stream));
  }
  return static_cast<int>(launch_map_vec<T, 1, false>(t, o, seeds, coeffs, S,
                                                      P, salt, m, n, stream));
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* t, T* o, const uint32_t* seeds,
                       const float* coeffs, int S, int P, uint32_t salt,
                       uint32_t n, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * P * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        zo_replay_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  zo_replay_kernel<T, VEC><<<zo::grid_for(n / VEC), zo::kThreads, smem,
                             stream>>>(t, o, seeds, coeffs, S, P, salt, n);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* theta, void* out, const uint32_t* seeds,
           const float* coeffs, int S, int P, uint32_t salt, uint32_t n,
           cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* t = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  if (zo::aligned16(theta, out))
    return static_cast<int>(
        launch_vec<T, kVec>(t, o, seeds, coeffs, S, P, salt, n, stream));
  return static_cast<int>(
      launch_vec<T, 1>(t, o, seeds, coeffs, S, P, salt, n, stream));
}

}  // namespace

extern "C" int zo_fused_replay_f32(const void* theta, void* out,
                                   const uint32_t* seeds, const float* coeffs,
                                   int S, int P, uint32_t salt, uint32_t n,
                                   cudaStream_t stream) {
  return launch<float>(theta, out, seeds, coeffs, S, P, salt, n, stream);
}

extern "C" int zo_fused_replay_bf16(const void* theta, void* out,
                                    const uint32_t* seeds,
                                    const float* coeffs, int S, int P,
                                    uint32_t salt, uint32_t n,
                                    cudaStream_t stream) {
  return launch<__nv_bfloat16>(theta, out, seeds, coeffs, S, P, salt, n,
                               stream);
}

extern "C" int zo_fused_replay_map_f32(const void* theta, void* out,
                                       const uint32_t* seeds,
                                       const float* coeffs, int S, int P,
                                       uint32_t salt, const zo::Map3* map,
                                       uint32_t n, cudaStream_t stream) {
  return launch_map<float>(theta, out, seeds, coeffs, S, P, salt, *map, n,
                           stream);
}

extern "C" int zo_fused_replay_map_bf16(const void* theta, void* out,
                                        const uint32_t* seeds,
                                        const float* coeffs, int S, int P,
                                        uint32_t salt, const zo::Map3* map,
                                        uint32_t n, cudaStream_t stream) {
  return launch_map<__nv_bfloat16>(theta, out, seeds, coeffs, S, P, salt,
                                   *map, n, stream);
}
