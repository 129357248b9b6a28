// int8_matmul: out = a . w with int8 a [M, K], int8 w [K, N] and int32
// out [M, N], plus max|out| fused into the epilogue (the NITI rescale
// picks its shift from it, so the int32 output is not read again).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py:40
// (int8_matmul, pallas_call at :52). In the port every product of the
// int8 lane goes through it: qdense, qconv2d (im2col) and both products
// of the NITI FC backward (core/int8.py). PyTorch has no integer matrix
// product on CUDA for the port to call.
//
// Bound on an H100 SXM: 2 M N K operations against the int8 tensor-core
// peak of 1,979 TOPS, or the bytes (M K + K N + 4 M N) over 3.35 TB/s,
// whichever is larger; at the LeNet-5 path's shapes (K = 25..784, N =
// 6..120) the bytes bound, at 4096^3 the operations. This first kernel
// does not reach the tensor cores: it is a tiled shared-memory GEMM with
// __dp4a (four int8 products summed into int32 per instruction), 64 x 64
// output tiles, 32-deep k slices, 256 threads each owning 4 x 4 outputs.
// A is staged row-major and B transposed, both with rows padded to 36
// bytes, so each thread's operands are 4-byte shared loads without bank
// conflicts. Tile loads zero-pad outside [M, K, N] (exact in integer
// arithmetic), so any shape is taken. mma.sync s8 or wgmma is later work.
//
// max|out|: each block reduces its tile (warp shuffles, then shared
// memory) and does one atomicMax on a device int32 that this function
// zeroes on the same stream first. Integer max does not depend on order,
// so the result is deterministic.
//
// C interface (ctypes): returns cudaGetLastError() after the launch. The
// wrapper refuses K > 133,143 (K * 127^2 must fit in int32).
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;
constexpr int kLds = kBK + 4;      // padded row, in bytes
constexpr int kThreads = 256;      // 16 x 16, 4 x 4 outputs each

__global__ void __launch_bounds__(kThreads)
    int8_matmul_kernel(const int8_t* __restrict__ a,
                       const int8_t* __restrict__ w, int32_t* __restrict__ out,
                       int32_t* maxabs, int M, int K, int N) {
  __shared__ __align__(16) int8_t s_a[kBM * kLds];
  __shared__ __align__(16) int8_t s_bt[kBN * kLds];
  __shared__ int s_max[kThreads / 32];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long m0 = static_cast<long>(blockIdx.x) * kBM;
  const long n0 = static_cast<long>(blockIdx.y) * kBN;
  int acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int idx = tid; idx < kBM * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx % kBK;
      const long gm = m0 + r;
      const int gk = k0 + c;
      s_a[r * kLds + c] = (gm < M && gk < K) ? a[gm * K + gk] : int8_t(0);
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kr = idx / kBN, nc = idx % kBN;
      const int gk = k0 + kr;
      const long gn = n0 + nc;
      s_bt[nc * kLds + kr] =
          (gk < K && gn < N) ? w[static_cast<long>(gk) * N + gn] : int8_t(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      int av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        av[i] = *reinterpret_cast<const int*>(&s_a[(ty + 16 * i) * kLds + kk]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] = *reinterpret_cast<const int*>(&s_bt[(tx + 16 * j) * kLds + kk]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  unsigned local = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long gm = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long gn = n0 + tx + 16 * j;
      if (gm < M && gn < N) {
        out[gm * N + gn] = acc[i][j];
        const int v = acc[i][j];
        const unsigned mag = v < 0 ? 0u - static_cast<unsigned>(v)
                                   : static_cast<unsigned>(v);
        local = mag > local ? mag : local;
      }
    }
  }
  local = __reduce_max_sync(0xffffffffu, local);
  if (tid % 32 == 0) s_max[tid / 32] = static_cast<int>(local);
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int i = 0; i < kThreads / 32; ++i) m = s_max[i] > m ? s_max[i] : m;
    atomicMax(maxabs, m);
  }
}

}  // namespace

extern "C" int int8_matmul(const void* a, const void* w, void* out,
                           void* maxabs, int M, int K, int N,
                           cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(maxabs, 0, sizeof(int32_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  int8_matmul_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(a), static_cast<const int8_t*>(w),
      static_cast<int32_t*>(out), static_cast<int32_t*>(maxabs), M, K, N);
  return static_cast<int>(cudaGetLastError());
}
