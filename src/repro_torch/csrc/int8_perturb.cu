// int8_perturb: theta' = clamp(theta + k * z, -127, 127) on every int8 leaf
// of a model in one launch, z = m * u the int8 lane's sparse uniform noise
// (Alg. 2), regenerated from (seed, the leaf's salt, the leaf's flat
// index) and never stored.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_perturb.py:117
// (int8_perturb, pallas_call at :125). It carries every +1 / -1 probe
// perturbation of the port's ElasticZO-INT8 step
// (core/int8.py::perturb_int8: one launch a perturbation for the whole
// model, up to kMaxLeaves leaves a launch).
//
// Bound on an H100 SXM: the bytes are one read and one write of theta, 2
// bytes an element over 3.35 TB/s. The operations are integer: two murmur
// hashes, a remainder, the keep test, the add and the clamp, on the INT32
// pipe (64 lanes a clock on each of the 132 SMs) and the FMA pipe (IMAD),
// which makes the kernel bound by operations, not bytes. The design:
//   - the launch floor (LeNet-5's five leaves hold 107,550 elements, a
//     few microseconds of work): one launch for every leaf, from a leaf
//     table passed by value (zo_noise.cuh::LeafTable), with fewer
//     elements a thread for small totals so that the tiles cover the SMs;
//   - the issue rate (large leaves): no I2F and no division an element
//     (an integer keep test against a host threshold, Lemire's fastmod
//     with a host magic), the seed's share of the first hash step once a
//     launch, 16-byte loads and stores of 16 elements a thread.
// An unaligned leaf and the ragged tail of a leaf go element by element.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a table it does not take. The seed is read
// from device memory (one uint32), so the host never waits on the device
// to launch. Flat indices are uint32: the wrapper refuses leaves of 2**32
// elements or more.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

template <int VEC>
__global__ void __launch_bounds__(zo::kThreads)
    int8_perturb_kernel(const __grid_constant__ zo::LeafTable table,
                        const uint32_t* seed_ptr, int k,
                        const __grid_constant__ zo::Int8Noise nz) {
  const uint32_t seed = *seed_ptr;
  const uint32_t cs = zo::xs16(seed), sm2 = seed * zo::kM2;
  const uint32_t uk = static_cast<uint32_t>(k);
  const uint32_t k_rmax = uk * static_cast<uint32_t>(nz.r_max);
  zo::for_each_tile<VEC>(table, [&](int (&x)[VEC], uint32_t first,
                                    uint32_t step, uint32_t salt1) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t hv = (first + j * step) * zo::kPhi + salt1;
      const uint32_t bu = zo::hash_tail(zo::xs16(hv) ^ cs, sm2);
      const uint32_t bm = zo::hash_tail(zo::xs16(hv + 1u) ^ cs, sm2);
      const int kz = zo::scaled_noise(bu, bm, uk, k_rmax, nz);
      x[j] = zo::clamp127(static_cast<int>(static_cast<uint32_t>(x[j]) +
                                           static_cast<uint32_t>(kz)));
    }
  });
}

template <int VEC>
void launch(const zo::LeafTable& t, const uint32_t* seed, int k,
            const zo::Int8Noise& nz, cudaStream_t stream) {
  int8_perturb_kernel<VEC><<<zo::grid_cap(t.tiles), zo::kThreads, 0,
                             stream>>>(t, seed, k, nz);
}

}  // namespace

extern "C" int int8_perturb(const uint64_t* leaves, int count,
                            const uint32_t* seed, int k, int r_max,
                            uint64_t magic, uint64_t keep_below,
                            cudaStream_t stream) {
  zo::LeafTable t;
  const int vec = zo::leaf_table(leaves, count, &t);
  if (!vec || r_max < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (!t.tiles) return 0;
  const zo::Int8Noise nz = zo::int8_noise_consts(r_max, magic, keep_below);
  if (vec == 4) launch<4>(t, seed, k, nz, stream);
  else launch<16>(t, seed, k, nz, stream);
  return static_cast<int>(cudaGetLastError());
}
