// flash_attention: causal / sliding-window attention with the online
// softmax, forward only, f32 accumulation.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn.py:79
// (flash_attention, pallas_call at :93). It carries every attention of
// the port's gradient-free forwards: the ZO head's probe forwards and the
// serving prefill (models/layers.py::attention).
//
// Function (the plain version is kernels/ref.py::flash_attention_ref):
// q [B,H,Sq,D], k/v [B,Hkv,Sk,D] -> o [B,H,Sq,D] in q's dtype; q head h
// reads kv head h / (H / Hkv). Scores s = (q . k) * scale in f32; the
// causal and window masks are top-left aligned (k <= q, k > q - window)
// and set a masked score to -1e30, as the TPU kernel does, so a row with
// no visible key averages V over all Sk keys, as the reference does; the
// result is acc / max(l, 1e-30). Any Sq, Sk >= 1; D in {16, 64, 128};
// f32 or bf16. Each of q, k, v, o is addressed through its own (b, h, s)
// element strides with a contiguous last dim, so the model's transposed
// [B,S,H,D] views need no copy.
//
// Bound on an H100 SXM: operations, 4 * B * H * D per visible (q, k)
// pair (two products of D multiply-adds). At qwen3-4b's S 4096, H 32,
// D 128 causal that is 1.37e11: 0.139 ms on the bf16 tensor cores, 2.05
// ms on the f32 CUDA cores this kernel uses; the bytes (q, k, v read
// once, o written once) take 0.025 ms. The design keeps the [Sq, Sk]
// scores out of device memory, which is what the TPU kernel is for:
// one block of 256 threads per (query tile of 64, head, batch row); Q in
// shared memory as f32; a loop over key tiles of 64 with K and V in
// shared memory; each thread holds a 4 x 4 block of scores and a 4 x D/16
// block of the output in registers, with the running max and sum of its
// 4 rows (the 16 threads of a row group reduce with warp shuffles).
// Padded rows make every shared-memory read conflict-free, P^T reuses the
// K buffer, so D 128 takes 100,352 bytes and two blocks fit an SM. Key
// tiles that the causal and window masks remove for every row of the
// block are skipped (exact: the TPU kernel multiplies them away with a
// rescale of exp(-1e30 - m) = 0), and the longest query tiles are
// scheduled first. Tensor cores (mma / wgmma on bf16), cp.async or TMA
// loads and double buffering are the next steps.
//
// C interface (ctypes): returns the CUDA error of the launch (0 if none).
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kBQ = 64;           // queries a block
constexpr int kBK = 64;           // keys a tile
constexpr int kThreads = 256;     // 16 x 16: ty owns rows, tx columns
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  long long q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int D>
struct Layout {
  static constexpr int LD = D + 4;          // Q and K rows, padded
  static constexpr int LP = kBK + 4;        // P^T rows, padded
  static constexpr int KBUF = (kBK * LD > kBK * LP) ? kBK * LD : kBK * LP;
  static constexpr int FLOATS = kBQ * LD + KBUF + kBK * D;
  static constexpr int BYTES = FLOATS * 4;
  static constexpr bool VEC = D % 64 == 0;  // float4 reads of V
  static constexpr int NC = D / 16;         // output columns a thread
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// output column of a thread's c-th value
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  return Layout<D>::VEC ? (c / 4) * 64 + tx * 4 + (c % 4) : c * 16 + tx;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_fwd(Args a) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* Ks = Qs + kBQ * L::LD;                 // [kBK][LD]; P^T [kBK][LP]
  float* Vs = Ks + L::KBUF;                     // [kBK][D]
  float* Ps = Ks;

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;   // longest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  T* op = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, c = e % D, qi = q0 + r;
    Qs[r * L::LD + c] = qi < a.Sq ? to_f32(qp[qi * a.q_ss + c]) : 0.f;
  }

  // the key tiles any row of this block can see
  const int q_last = min(q0 + kBQ, a.Sq) - 1;
  int k_begin = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  int k_end = a.causal ? min(a.Sk, q_last + 1) : a.Sk;
  if (a.window > 0 && q_last >= a.Sk + a.window - 1) {
    k_begin = 0;          // a row sees no key: it averages all of them
    k_end = a.Sk;
  }

  float m[4], l[4], acc[4][L::NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();      // the last tile's P^T and V reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, c = e % D, ki = k0 + r;
      const bool in = ki < a.Sk;
      Ks[r * L::LD + c] = in ? to_f32(kp[ki * a.k_ss + c]) : 0.f;
      Vs[r * D + c] = in ? to_f32(vp[ki * a.v_ss + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + i) * L::LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * L::LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y +
                     qv[i].z * kv[j].z + qv[i].w * kv[j].w;
    }
    __syncthreads();      // every K read is done before P^T overwrites it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int ki = k0 + tx + 16 * j;
        const bool seen = (!a.causal || ki <= qi) &&
                          (a.window <= 0 || ki > qi - a.window);
        const float x = ki >= a.Sk ? -CUDART_INF_F
                                   : (seen ? s[i][j] * a.scale : kNegInf);
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + group_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::NC; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * L::LP + ty * 4]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[c * L::LP + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
      if constexpr (L::VEC) {
#pragma unroll
        for (int g = 0; g < D / 64; ++g) {
          const float4 vv =
              *reinterpret_cast<const float4*>(&Vs[c * D + g * 64 + tx * 4]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[i][g * 4 + 0] += pr[i] * vv.x;
            acc[i][g * 4 + 1] += pr[i] * vv.y;
            acc[i][g * 4 + 2] += pr[i] * vv.z;
            acc[i][g * 4 + 3] += pr[i] * vv.w;
          }
        }
      } else {
#pragma unroll
        for (int g = 0; g < L::NC; ++g) {
          const float vv = Vs[c * D + g * 16 + tx];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][g] += pr[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < L::NC; ++c)
      op[qi * a.o_ss + out_col<D>(tx, c)] = from_f32<T>(acc[i][c] / den);
  }
}

template <typename T, int D>
int go(const Args& a, cudaStream_t stream) {
  const int bytes = Layout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_fwd<T, D><<<grid, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int Sq, int Sk, int D, const long long* st, float scale,
           int causal, int window, cudaStream_t stream) {
  const Args a{q,     k,     v,     o,     B,     H,     Hkv,   Sq,
               Sk,    st[0], st[1], st[2], st[3], st[4], st[5], st[6],
               st[7], st[8], st[9], st[10], st[11], scale, causal, window};
  switch (D) {
    case 16:
      return go<T, 16>(a, stream);
    case 64:
      return go<T, 64>(a, stream);
    case 128:
      return go<T, 128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, sequence) of q, k, v, o.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int B, int H, int Hkv, int Sq, int Sk,
                              int D, const long long* strides, float scale,
                              int causal, int window, cudaStream_t stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, Sq, Sk, D, strides, scale,
                       causal, window, stream);
}

extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int Hkv, int Sq, int Sk,
                               int D, const long long* strides, float scale,
                               int causal, int window, cudaStream_t stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Sk, D, strides,
                               scale, causal, window, stream);
}
