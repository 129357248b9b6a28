// zo_fused_replay_int8: apply S steps x P probes of int8-lane ZO records
// (seed, ternary g) to one int8 leaf in one pass. For each step s, in
// probe order:
//
//   acc = 0;  acc += psr(g[s,p] * z(seed[s,p]), shift)   (int32)
//   x = clamp(x - acc, -127, 127)                        (one clamp a step)
//
// with x carried in int32 across steps and stored as int8 at the end.
// S = 1 is the live ZO update of the port's ElasticZO-INT8 step
// (core/engine.py::Int8Engine.zo_apply, one launch per ZO leaf per step,
// in place); S > 1 is ledger replay (apply_zo_records). One kernel serves
// both, so an S-step replay equals S live steps bitwise. A record with
// g = 0 (a masked probe, or a tied loss) adds psr(0, shift) = 0, so its
// noise is skipped: exact.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_fused_replay.py:123
// (zo_fused_replay_int8, pallas_call at :141).
//
// Bound on an H100 SXM: bytes are one read and one write of theta (2
// bytes an element over 3.35 TB/s, plus 8 bytes a record); operations are
// integer, about 60 int32 ops an element and record for the noise plus
// ~25 for psr, on the INT32 pipe (64 lanes a clock on each of 132 SMs):
// bound by operations at every S * P. The design: theta is read and
// written once whatever S is; every block copies the S * P seeds and gs
// into shared memory once; each thread keeps its elements in registers
// across all steps; 16-byte vector loads and stores; a grid-stride loop.
// In place (out == theta) is allowed: every element is read and written
// by the same thread.
//
// C interface (ctypes): returns cudaGetLastError() after the launch.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

__device__ __forceinline__ int8_t replay_one(int8_t t, uint32_t idx,
                                             const uint32_t* seeds,
                                             const int* gs, int S, int P,
                                             uint32_t salt, int r_max,
                                             float keep_thresh, int shift) {
  int x = t;
  for (int s = 0; s < S; ++s) {
    int acc = 0;
    for (int p = 0; p < P; ++p) {
      const int g = gs[s * P + p];
      if (g == 0) continue;
      const int z = zo::int8_noise(idx, seeds[s * P + p], salt, r_max,
                                   keep_thresh);
      acc += zo::psr_shift(g * z, shift);
    }
    x = zo::clamp127(x - acc);
  }
  return static_cast<int8_t>(x);
}

template <int VEC>
__global__ void __launch_bounds__(zo::kThreads)
    replay_int8_kernel(const int8_t* theta, int8_t* out,
                       const uint32_t* seeds, const int* gs, int S, int P,
                       uint32_t salt, int r_max, float keep_thresh, int shift,
                       uint32_t n) {
  using Pk = zo::Pack<int8_t, VEC>;
  extern __shared__ uint32_t smem[];
  uint32_t* s_seed = smem;
  int* s_g = reinterpret_cast<int*>(smem + S * P);
  for (int r = threadIdx.x; r < S * P; r += blockDim.x) {
    s_seed[r] = seeds[r];
    s_g[r] = gs[r];
  }
  __syncthreads();
  const size_t nvec = n / VEC;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  const size_t tid = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (size_t i = tid; i < nvec; i += stride) {
    Pk p = reinterpret_cast<const Pk*>(theta)[i];
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      p.v[j] = replay_one(p.v[j], static_cast<uint32_t>(i * VEC + j), s_seed,
                          s_g, S, P, salt, r_max, keep_thresh, shift);
    reinterpret_cast<Pk*>(out)[i] = p;
  }
  for (size_t i = nvec * VEC + tid; i < n; i += stride)
    out[i] = replay_one(theta[i], static_cast<uint32_t>(i), s_seed, s_g, S, P,
                        salt, r_max, keep_thresh, shift);
}

template <int VEC>
cudaError_t launch_vec(const int8_t* t, int8_t* o, const uint32_t* seeds,
                       const int* gs, int S, int P, uint32_t salt, int r_max,
                       float keep_thresh, int shift, uint32_t n,
                       cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(S) * P * 8;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        replay_int8_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  replay_int8_kernel<VEC><<<zo::grid_for(n / VEC), zo::kThreads, smem,
                            stream>>>(t, o, seeds, gs, S, P, salt, r_max,
                                      keep_thresh, shift, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int zo_fused_replay_int8(const void* theta, void* out,
                                    const uint32_t* seeds, const int* gs,
                                    int S, int P, uint32_t salt, int r_max,
                                    float keep_thresh, int shift, uint32_t n,
                                    cudaStream_t stream) {
  const int8_t* t = static_cast<const int8_t*>(theta);
  int8_t* o = static_cast<int8_t*>(out);
  if (zo::aligned16(theta, out))
    return static_cast<int>(launch_vec<16>(t, o, seeds, gs, S, P, salt, r_max,
                                           keep_thresh, shift, n, stream));
  return static_cast<int>(launch_vec<1>(t, o, seeds, gs, S, P, salt, r_max,
                                        keep_thresh, shift, n, stream));
}
