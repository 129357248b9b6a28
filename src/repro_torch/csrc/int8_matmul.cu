// int8_matmul: out = a . w with int8 a [M, K], int8 w [K, N] and int32
// out [M, N], plus max|out| fused into the epilogue (the NITI rescale
// picks its shift from it, so the int32 output is not read again).
//
// Replaces the Pallas TPU kernel src/repro/kernels/int8_matmul.py:40
// (int8_matmul, pallas_call at :52). In the port every product of the
// int8 lane goes through it: qdense, qconv2d (im2col) and both products
// of the NITI FC backward (core/int8.py).
//
// Bound on an H100 SXM: 2 M N K operations against the int8 tensor-core
// peak of 1,979 TOPS, or the bytes (M K + K N + 4 M N) over 3.35 TB/s,
// whichever is larger; at the LeNet-5 path's shapes (K = 10..784, N =
// 6..120) the bytes bound, at 4096^3 the operations (0.069 ms).
//
// Design: the int8 tensor cores through mma.sync.m16n8k32 (s8 x s8 ->
// s32, exact), with a ring of four 64-deep k stages in shared memory
// filled by cp.async, so the next stages load while this one is
// multiplied. The MMA takes both operands K-major; a is (K contiguous)
// and is read with ldmatrix, but w is N-major and int8 has no transposing
// ldmatrix, so w's tile is stored as it lies and each thread builds its B
// fragments itself: one 32-bit load gives four adjacent columns of one k
// row, four rows give a 4 x 4 byte block, and a byte transpose (PRMT)
// turns it into the four columns' k-quads. For that the n8 tile nt of a
// warp maps its column slot j to column NI j + nt of the warp's slice, so
// a thread's four fragments are four adjacent columns; the epilogue puts
// each sum back where it belongs. No pass over w in device memory. Tile
// rows are XOR-swizzled in 16-byte chunks, so ldmatrix and the fragment
// loads hit distinct banks.
//
// Two tiles, picked by the host: 128 x 128 (8 warps of 64 x 32) where
// there are enough of them to fill the card, else 64 x 16 (4 warps of
// 16 x 16) for the LeNet-5 shapes (N = 6..120, tall or short M), where a
// 128-wide tile would be mostly padding. Tile loads zero-pad outside [M,
// K, N] (exact in integer arithmetic), so any shape is taken; rows that
// are not 16-byte aligned (K or N not a multiple of 16, or a view that
// starts off alignment) are copied a byte at a time.
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

constexpr int kBK = 64;            // k bytes a stage
constexpr int kStages = 4;

// byte offset of the 16-byte chunk c of row r in an a tile (64-byte rows)
__device__ __forceinline__ int a_off(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// byte offset of the 16-byte chunk c of k row r in a w tile (BN-byte rows)
template <int BN>
__device__ __forceinline__ int b_off(int r, int c) {
  return r * BN + ((BN >= 128 ? c ^ (((r >> 2) & 3) << 1) : c) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst,
                                            const uint32_t (&w)[4]) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
               : "memory");
}

// 16 bytes of a row from byte `col` on, zero past `len` or out of rows
__device__ __forceinline__ void bytes16(uint32_t (&w)[4], const int8_t* row,
                                        long long col, long long len,
                                        bool in) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t x = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long c = col + 4 * i + j;
      if (in && c < len)
        x |= static_cast<uint32_t>(static_cast<uint8_t>(row[c])) << (8 * j);
    }
    w[i] = x;
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N>
struct Cfg {
  static constexpr int THREADS = 32 * WARPS_M * WARPS_N;
  static constexpr int WTM = BM / WARPS_M;    // warp tile rows
  static constexpr int WTN = BN / WARPS_N;    // warp tile columns
  static constexpr int MI = WTM / 16;         // m16 tiles a warp
  static constexpr int NI = WTN / 8;          // n8 tiles a warp (2 or 4)
  static constexpr int A_BYTES = BM * kBK;
  static constexpr int STAGE = A_BYTES + kBK * BN;
  static constexpr int SMEM = kStages * STAGE;
};

// One stage: a's rows m0.. and w's k rows k0.., columns n0..
template <int BM, int BN, int THREADS, bool VEC>
__device__ __forceinline__ void load_stage(uint32_t sa, uint32_t sb,
                                           const int8_t* a, const int8_t* w,
                                           long long m0, long long n0, int k0,
                                           int M, int K, int N, int tid) {
  for (int e = tid; e < BM * (kBK / 16); e += THREADS) {
    const int r = e / (kBK / 16), c = e % (kBK / 16);
    const long long gm = m0 + r;
    const int gk = k0 + 16 * c;
    const uint32_t dst = sa + a_off(r, c);
    if (VEC) {
      const bool in = gm < M && gk < K;
      cp_async16(dst, a + (in ? gm * K + gk : 0), in);
    } else {
      uint32_t v[4];
      bytes16(v, a + (gm < M ? gm * K : 0), gk, K, gm < M);
      st_shared16(dst, v);
    }
  }
  for (int e = tid; e < kBK * (BN / 16); e += THREADS) {
    const int r = e / (BN / 16), c = e % (BN / 16);
    const int gk = k0 + r;
    const long long gn = n0 + 16 * c;
    const uint32_t dst = sb + b_off<BN>(r, c);
    if (VEC) {
      const bool in = gk < K && gn < N;
      cp_async16(dst, w + (in ? static_cast<long long>(gk) * N + gn : 0), in);
    } else {
      uint32_t v[4];
      bytes16(v, w + (gk < K ? static_cast<long long>(gk) * N : 0), gn, N,
              gk < K);
      st_shared16(dst, v);
    }
  }
}

// column quad of the 4 x 4 bytes x0..x3 (rows): y[j] = x0.bj x1.bj x2.bj x3.bj
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t2 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t2, 0x5410);
  y[1] = __byte_perm(t0, t2, 0x7632);
  y[2] = __byte_perm(t1, t3, 0x5410);
  y[3] = __byte_perm(t1, t3, 0x7632);
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
__global__ void __launch_bounds__(Cfg<BM, BN, WARPS_M, WARPS_N>::THREADS)
    int8_mma(const int8_t* __restrict__ a, const int8_t* __restrict__ w,
             int32_t* __restrict__ out, int32_t* maxabs, int M, int K,
             int N) {
  using C = Cfg<BM, BN, WARPS_M, WARPS_N>;
  constexpr int MI = C::MI, NI = C::NI;
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ int s_max[C::THREADS / 32];
  const uint32_t s0 = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / WARPS_N, wn = warp % WARPS_N;
  const long long m0 = static_cast<long long>(blockIdx.x) * BM;
  const long long n0 = static_cast<long long>(blockIdx.y) * BN;
  const int nk = (K + kBK - 1) / kBK;

  auto load = [&](int kt) {
    const uint32_t sa = s0 + (kt % kStages) * C::STAGE;
    load_stage<BM, BN, C::THREADS, VEC>(sa, sa + C::A_BYTES, a, w, m0, n0,
                                        kt * kBK, M, K, N, tid);
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load(s);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  for (int kt = 0; kt < nk; ++kt) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();          // stage kt is in; stage kt - 1 is read
    if (kt + kStages - 1 < nk) load(kt + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");

    const uint32_t sa = s0 + (kt % kStages) * C::STAGE;
    const uint32_t sb = sa + C::A_BYTES;
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r = wm * C::WTM + i * 16 + (lane % 8) + ((lane / 8) & 1) * 8;
        const uint32_t addr = sa + a_off(r, 2 * ks + lane / 16);
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
            "[%4];\n"
            : "=r"(af[i][0]), "=r"(af[i][1]), "=r"(af[i][2]), "=r"(af[i][3])
            : "r"(addr));
      }
      // b[j][h]: k quad 4 t (h = 0) or 16 + 4 t (h = 1) of column
      // wn WTN + NI g + j
      uint32_t bf[NI][2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t x[4], y[4];
        const int byte = wn * C::WTN + NI * g;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ks * 32 + hh * 16 + 4 * t + i;
          const uint8_t* p = smem + (sb - s0) + b_off<BN>(r, byte / 16) +
                             byte % 16;
          if constexpr (NI == 4)
            x[i] = *reinterpret_cast<const uint32_t*>(p);
          else
            x[i] = *reinterpret_cast<const uint16_t*>(p);
        }
        transpose4(x, y);
#pragma unroll
        for (int j = 0; j < NI; ++j) bf[j][hh] = y[j];
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j)
          asm volatile(
              "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
              "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
              "{%0, %1, %2, %3};\n"
              : "+r"(acc[i][j][0]), "+r"(acc[i][j][1]), "+r"(acc[i][j][2]),
                "+r"(acc[i][j][3])
              : "r"(af[i][0]), "r"(af[i][1]), "r"(af[i][2]), "r"(af[i][3]),
                "r"(bf[j][0]), "r"(bf[j][1]));
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // the thread's sums: rows g and g + 8 of each m16 tile, 2 NI adjacent
  // columns from wn WTN + 2 NI t (slot 2 t of tile j is column 2 NI t + j,
  // slot 2 t + 1 is column 2 NI t + NI + j)
  unsigned local = 0;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const long long gm = m0 + wm * C::WTM + i * 16 + g + 8 * hr;
      if (gm >= M) continue;
      const long long gn0 = n0 + wn * C::WTN + 2 * NI * t;
#pragma unroll
      for (int c = 0; c < 2 * NI; ++c) {
        const int v = acc[i][c % NI][2 * hr + c / NI];
        if (gn0 + c < N) {
          out[gm * N + gn0 + c] = v;
          const unsigned mag = v < 0 ? 0u - static_cast<unsigned>(v)
                                     : static_cast<unsigned>(v);
          local = mag > local ? mag : local;
        }
      }
    }
  local = __reduce_max_sync(0xffffffffu, local);
  if (lane == 0) s_max[warp] = static_cast<int>(local);
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int i = 0; i < C::THREADS / 32; ++i) m = s_max[i] > m ? s_max[i] : m;
    atomicMax(maxabs, m);
  }
}

template <int BM, int BN, int WARPS_M, int WARPS_N, bool VEC>
int go(const int8_t* a, const int8_t* w, int32_t* out, int32_t* maxabs,
       int M, int K, int N, cudaStream_t stream) {
  using C = Cfg<BM, BN, WARPS_M, WARPS_N>;
  auto* kernel = int8_mma<BM, BN, WARPS_M, WARPS_N, VEC>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  kernel<<<grid, C::THREADS, C::SMEM, stream>>>(a, w, out, maxabs, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int pick(const int8_t* a, const int8_t* w, int32_t* out, int32_t* maxabs,
         int M, int K, int N, cudaStream_t stream) {
  const long long wide_tiles =
      ((M + 127LL) / 128) * ((N + 127LL) / 128);
  if (N > 64 && wide_tiles >= 132)       // enough 128 x 128 tiles for 132 SMs
    return go<128, 128, 2, 4, VEC>(a, w, out, maxabs, M, K, N, stream);
  return go<64, 16, 4, 1, VEC>(a, w, out, maxabs, M, K, N, stream);
}

}  // namespace

extern "C" int int8_matmul(const void* a, const void* w, void* out,
                           void* maxabs, int M, int K, int N,
                           cudaStream_t stream) {
  cudaError_t e = cudaMemsetAsync(maxabs, 0, sizeof(int32_t), stream);
  if (e != cudaSuccess) return static_cast<int>(e);
  const auto* a8 = static_cast<const int8_t*>(a);
  const auto* w8 = static_cast<const int8_t*>(w);
  auto* o32 = static_cast<int32_t*>(out);
  auto* mx = static_cast<int32_t*>(maxabs);
  // 16-byte copies need every row of a and w to start on 16 bytes
  const bool vec = reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && K % 16 == 0 &&
                   N % 16 == 0;
  return vec ? pick<true>(a8, w8, o32, mx, M, K, N, stream)
             : pick<false>(a8, w8, o32, mx, M, K, N, stream);
}
