// zo_perturb: theta' = cast(float(theta) + scale * z), z regenerated from
// (seed, salt, offset + flat index) and never stored.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_perturb.py:72
// (zo_perturb, pallas_call at :85). It carries every +eps / -eps
// perturbation of the port's ElasticZO step: whole leaves
// (core/zo.py::perturb, offset 0) and one period's slice of a stacked
// leaf at a time (core/zo.py::perturb_slice, offset = period * slice
// size, so the slice draws the stacked leaf's noise).
//
// Bound on an H100 SXM: the bytes are one read and one write of theta,
// 2 * n * itemsize over 3.35 TB/s (1.04 ms for the 871.6M-element bf16
// w_gate leaf of qwen3-4b). The operations are about 100 per element:
// two murmur streams of ~14 integer ops each, the Box-Muller float ops and
// three precise transcendentals (logf, cosf, sqrt), against 33.5e12 lane
// operations/s; that is ~2.6 ms for the same leaf, so the kernel is bound
// by operations, not bytes. The design does what keeps it at that bound:
// one pass with no z buffer, 16-byte vector loads and stores (4 f32 or
// 8 bf16 per thread per iteration, independent chains for the scheduler),
// and a grid-stride loop over a grid sized to fill the 132 SMs. The noise
// math is in zo_noise.cuh (no FMA contraction, precise math, so the plain
// PyTorch version on the card gives the same bits).
//
// A rank's shard of a sharded leaf (core/zo.py::perturb with index maps,
// sharding/params.py::shard_desc) draws at its global flat indices:
// zo_perturb_map_* take the shard's index map (zo_noise.cuh::Map3, up to
// three (extent, stride) levels) and split each vector's local index into
// (run, column) with one fastdiv pair, so the noise per element is the
// contiguous kernel's and the 16-byte vectors stay within a run. A map of
// one contiguous run goes to the offset kernel, unchanged.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.
// The seed is read from device memory (one uint32), so the host never
// waits on the device to launch. Flat indices are uint32: the wrapper
// refuses an offset plus leaf size, or a map's largest index, above
// 2**32 - 1.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

template <typename T, int VEC>
__global__ void __launch_bounds__(zo::kThreads)
    zo_perturb_kernel(const T* theta, T* out, const uint32_t* seed_ptr,
                      uint32_t salt, float scale, uint32_t offset,
                      uint32_t n) {
  using E = zo::Elt<T>;
  using P = zo::Pack<T, VEC>;
  const uint32_t seed = *seed_ptr;
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    P p = reinterpret_cast<const P*>(theta)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t idx = offset + static_cast<uint32_t>(i * VEC + j);
      const float z = zo::normal(idx, seed, salt);
      p.v[j] = E::store(__fadd_rn(E::load(p.v[j]), __fmul_rn(scale, z)));
    }
    reinterpret_cast<P*>(out)[i] = p;
  }
  for (size_t i = nvec * VEC + tid; i < n; i += stride) {
    const float z =
        zo::normal(offset + static_cast<uint32_t>(i), seed, salt);
    out[i] = E::store(__fadd_rn(E::load(theta[i]), __fmul_rn(scale, z)));
  }
}

// The shard form: element e draws at map_index(e). VEC > 1 only where VEC
// divides the run length e2 (then n is a multiple of VEC too); UNIT: the
// innermost stride is 1, as in every shard whose last dim has more than
// one element.
template <typename T, int VEC, bool UNIT>
__global__ void __launch_bounds__(zo::kThreads)
    zo_perturb_map_kernel(const T* theta, T* out, const uint32_t* seed_ptr,
                          uint32_t salt, float scale, zo::Map3 m,
                          uint32_t n) {
  using E = zo::Elt<T>;
  using P = zo::Pack<T, VEC>;
  const uint32_t seed = *seed_ptr;
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    P p = reinterpret_cast<const P*>(theta)[i];
    const uint32_t g = zo::map_index(static_cast<uint32_t>(i * VEC), m);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float z = zo::normal(g + j * (UNIT ? 1u : m.s2), seed, salt);
      p.v[j] = E::store(__fadd_rn(E::load(p.v[j]), __fmul_rn(scale, z)));
    }
    reinterpret_cast<P*>(out)[i] = p;
  }
}

template <typename T>
int launch_map(const void* theta, void* out, const uint32_t* seed,
               uint32_t salt, float scale, const zo::Map3& m, uint32_t n,
               cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* t = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  if (zo::aligned16(theta, out) && m.e2 % kVec == 0) {
    const unsigned grid = zo::grid_for(n / kVec);
    if (m.s2 == 1)      // a run of consecutive indices: the usual shard
      zo_perturb_map_kernel<T, kVec, true><<<grid, zo::kThreads, 0, stream>>>(
          t, o, seed, salt, scale, m, n);
    else
      zo_perturb_map_kernel<T, kVec, false><<<grid, zo::kThreads, 0,
                                              stream>>>(t, o, seed, salt,
                                                        scale, m, n);
  } else {
    zo_perturb_map_kernel<T, 1, false><<<zo::grid_for(n), zo::kThreads, 0,
                                         stream>>>(t, o, seed, salt, scale, m,
                                                   n);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* theta, void* out, const uint32_t* seed, uint32_t salt,
           float scale, uint32_t offset, uint32_t n, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* t = static_cast<const T*>(theta);
  T* o = static_cast<T*>(out);
  if (zo::aligned16(theta, out)) {
    zo_perturb_kernel<T, kVec><<<zo::grid_for(n / kVec), zo::kThreads, 0,
                                 stream>>>(t, o, seed, salt, scale, offset,
                                            n);
  } else {
    zo_perturb_kernel<T, 1><<<zo::grid_for(n), zo::kThreads, 0, stream>>>(
        t, o, seed, salt, scale, offset, n);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int zo_perturb_f32(const void* theta, void* out,
                              const uint32_t* seed, uint32_t salt, float scale,
                              uint32_t offset, uint32_t n,
                              cudaStream_t stream) {
  return launch<float>(theta, out, seed, salt, scale, offset, n, stream);
}

extern "C" int zo_perturb_bf16(const void* theta, void* out,
                               const uint32_t* seed, uint32_t salt,
                               float scale, uint32_t offset, uint32_t n,
                               cudaStream_t stream) {
  return launch<__nv_bfloat16>(theta, out, seed, salt, scale, offset, n,
                               stream);
}

extern "C" int zo_perturb_map_f32(const void* theta, void* out,
                                  const uint32_t* seed, uint32_t salt,
                                  float scale, const zo::Map3* map,
                                  uint32_t n, cudaStream_t stream) {
  return launch_map<float>(theta, out, seed, salt, scale, *map, n, stream);
}

extern "C" int zo_perturb_map_bf16(const void* theta, void* out,
                                   const uint32_t* seed, uint32_t salt,
                                   float scale, const zo::Map3* map,
                                   uint32_t n, cudaStream_t stream) {
  return launch_map<__nv_bfloat16>(theta, out, seed, salt, scale, *map, n,
                                   stream);
}
