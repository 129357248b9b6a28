// int8_perturb: theta' = clamp(theta + k * z, -127, 127) on an int8 leaf,
// z = m * u the int8 lane's sparse uniform noise (Alg. 2), regenerated
// from (seed, salt, global flat index) and never stored.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_perturb.py:117
// (int8_perturb, pallas_call at :125). It carries every +1 / -1 probe
// perturbation of the port's ElasticZO-INT8 step
// (core/int8.py::perturb_int8, one launch per ZO leaf per perturbation).
//
// Bound on an H100 SXM: the bytes are one read and one write of theta,
// 2 bytes an element over 3.35 TB/s. The operations are integer: two
// murmur hashes of ~16 int32 ops each, a 32-bit remainder (~20 ops, the
// divisor is not a constant), the keep test, the add and the clamp, about
// 60 int32 ops an element on the INT32 pipe (64 lanes a clock on each of
// the 132 SMs), which makes the kernel bound by operations by about 8x.
// The design: one pass with no noise buffer, 16-byte vector loads and
// stores (16 elements a thread an iteration), a grid-stride loop over a
// grid sized to fill the SMs, and a scalar path for a leaf or output that
// is not 16-byte aligned and for the ragged tail.
//
// C interface (ctypes): returns cudaGetLastError() after the launch. The
// seed is read from device memory (one uint32), so the host never waits
// on the device to launch. Flat indices are uint32: the wrapper refuses
// leaves of 2**32 elements or more.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

__device__ __forceinline__ int8_t perturb_one(int8_t t, uint32_t idx,
                                              uint32_t seed, uint32_t salt,
                                              int k, int r_max,
                                              float keep_thresh) {
  const int z = zo::int8_noise(idx, seed, salt, r_max, keep_thresh);
  return static_cast<int8_t>(zo::clamp127(static_cast<int>(t) + k * z));
}

template <int VEC>
__global__ void __launch_bounds__(zo::kThreads)
    int8_perturb_kernel(const int8_t* theta, int8_t* out,
                        const uint32_t* seed_ptr, uint32_t salt, int k,
                        int r_max, float keep_thresh, uint32_t n) {
  using P = zo::Pack<int8_t, VEC>;
  const uint32_t seed = *seed_ptr;
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    P p = reinterpret_cast<const P*>(theta)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      p.v[j] = perturb_one(p.v[j], static_cast<uint32_t>(i * VEC + j), seed,
                           salt, k, r_max, keep_thresh);
    reinterpret_cast<P*>(out)[i] = p;
  }
  for (size_t i = nvec * VEC + tid; i < n; i += stride)
    out[i] = perturb_one(theta[i], static_cast<uint32_t>(i), seed, salt, k,
                         r_max, keep_thresh);
}

}  // namespace

extern "C" int int8_perturb(const void* theta, void* out, const uint32_t* seed,
                            uint32_t salt, int k, int r_max, float keep_thresh,
                            uint32_t n, cudaStream_t stream) {
  const int8_t* t = static_cast<const int8_t*>(theta);
  int8_t* o = static_cast<int8_t*>(out);
  if (zo::aligned16(theta, out)) {
    int8_perturb_kernel<16><<<zo::grid_for(n / 16), zo::kThreads, 0, stream>>>(
        t, o, seed, salt, k, r_max, keep_thresh, n);
  } else {
    int8_perturb_kernel<1><<<zo::grid_for(n), zo::kThreads, 0, stream>>>(
        t, o, seed, salt, k, r_max, keep_thresh, n);
  }
  return static_cast<int>(cudaGetLastError());
}
