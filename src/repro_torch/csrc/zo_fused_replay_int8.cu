// zo_fused_replay_int8: apply S steps x P probes of int8-lane ZO records
// (seed, ternary g) to every int8 leaf of a model in one pass and one
// launch. For each step s, in probe order:
//
//   acc = 0;  acc += psr(g[s,p] * z(seed[s,p]), shift)   (int32)
//   x = clamp(x - acc, -127, 127)                        (one clamp a step)
//
// with x carried in int32 across steps and stored as int8 at the end.
// S = 1 is the live ZO update of the port's ElasticZO-INT8 step
// (core/engine.py::Int8Engine.zo_apply, in place; core/int8.py::
// zo_update_int8, out of place); S > 1 is ledger replay
// (Int8Engine.apply_zo_records). One kernel serves both, so an S-step
// replay equals S live steps bitwise. A record with g = 0 (a masked probe,
// or a tied loss) adds psr(0, shift) = 0, so its noise is skipped: exact.
//
// Replaces the Pallas TPU kernel src/repro/kernels/zo_fused_replay.py:123
// (zo_fused_replay_int8, pallas_call at :141).
//
// Bound on an H100 SXM: bytes are one read and one write of theta (2
// bytes an element over 3.35 TB/s, plus 8 bytes a record); operations are
// integer, the noise (as in int8_perturb.cu) and psr for every element and
// record, on the INT32 and FMA pipes: bound by operations at every S * P.
// The design:
//   - one launch for every leaf, from a leaf table (zo_noise.cuh), as in
//     int8_perturb.cu;
//   - the records outside the elements: each thread holds its VEC
//     elements in int32 registers with the record-free part of both hashes
//     (xs16(idx * kPhi + salt)), reads each record's seed and g once,
//     skips a g = 0 record once, and clamps once a step;
//   - psr's handling of the shift count once a launch: the count is the
//     same for every element, so the kernel is built for its three forms
//     (s <= 0, 0 < s < 32, s >= 32);
//   - theta read and written once whatever S is, 16-byte loads and stores.
// In place (out == theta) is allowed: every element is read and written by
// the same thread.
//
// C interface (ctypes): returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a table or shift form it does not take.
#include <cstdint>

#include <cuda_runtime.h>

#include "zo_noise.cuh"

namespace {

template <int VEC, int MODE>
__global__ void __launch_bounds__(zo::kThreads)
    replay_int8_kernel(const __grid_constant__ zo::LeafTable table,
                       const uint32_t* seeds, const int* gs, int S, int P,
                       const __grid_constant__ zo::Int8Noise nz,
                       const __grid_constant__ zo::Psr ps) {
  __builtin_assume(S > 0 && P > 0);   // the host's check: no empty loops
  zo::for_each_tile<VEC>(table, [&](int (&x)[VEC], uint32_t first,
                                    uint32_t step, uint32_t salt1) {
    uint32_t a1[VEC], a2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const uint32_t hv = (first + j * step) * zo::kPhi + salt1;
      a1[j] = zo::xs16(hv);
      a2[j] = zo::xs16(hv + 1u);
    }
#pragma unroll 1
    for (int s = 0; s < S; ++s) {
      uint32_t acc[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] = 0u;
#pragma unroll 1
      for (int p = 0; p < P; ++p) {
        const uint32_t g = static_cast<uint32_t>(gs[s * P + p]);
        if (g == 0u) continue;
        const uint32_t seed = seeds[s * P + p];
        const uint32_t cs = zo::xs16(seed), sm2 = seed * zo::kM2;
        const uint32_t g_rmax = g * static_cast<uint32_t>(nz.r_max);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const uint32_t bu = zo::hash_tail(a1[j] ^ cs, sm2);
          const uint32_t bm = zo::hash_tail(a2[j] ^ cs, sm2);
          acc[j] += static_cast<uint32_t>(
              zo::psr<MODE>(zo::scaled_noise(bu, bm, g, g_rmax, nz), ps));
        }
      }
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        x[j] = zo::clamp127(
            static_cast<int>(static_cast<uint32_t>(x[j]) - acc[j]));
    }
  });
}

template <int VEC, int MODE>
void launch(const zo::LeafTable& t, const uint32_t* seeds, const int* gs,
            int S, int P, const zo::Int8Noise& nz, const zo::Psr& ps,
            cudaStream_t stream) {
  replay_int8_kernel<VEC, MODE><<<zo::grid_cap(t.tiles), zo::kThreads, 0,
                                  stream>>>(t, seeds, gs, S, P, nz, ps);
}

template <int MODE>
void launch_mode(int vec, const zo::LeafTable& t, const uint32_t* seeds,
                 const int* gs, int S, int P, const zo::Int8Noise& nz,
                 const zo::Psr& ps, cudaStream_t stream) {
  if (vec == 4) launch<4, MODE>(t, seeds, gs, S, P, nz, ps, stream);
  else launch<16, MODE>(t, seeds, gs, S, P, nz, ps, stream);
}

}  // namespace

extern "C" int zo_fused_replay_int8(const uint64_t* leaves, int count,
                                    const uint32_t* seeds, const int* gs,
                                    int S, int P, int r_max, uint64_t magic,
                                    uint64_t keep_below, int shift,
                                    cudaStream_t stream) {
  zo::LeafTable t;
  const int vec = zo::leaf_table(leaves, count, &t);
  if (!vec || r_max < 0 || S < 1 || P < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!t.tiles) return 0;
  const zo::Int8Noise nz = zo::int8_noise_consts(r_max, magic, keep_below);
  zo::Psr ps = {0u, 0u, 0u, 0u};
  if (shift <= 0) {
    launch_mode<zo::kPsrNone>(vec, t, seeds, gs, S, P, nz, ps, stream);
  } else if (shift < 32) {
    ps.s = static_cast<uint32_t>(shift);
    ps.low = (1u << shift) - 1u;
    ps.c = 32u - ps.s;
    launch_mode<zo::kPsrShift>(vec, t, seeds, gs, S, P, nz, ps, stream);
  } else {
    ps.wide32 = shift == 32;
    launch_mode<zo::kPsrWide>(vec, t, seeds, gs, S, P, nz, ps, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
