// Flash attention forward for Hopper: blockwise online softmax, fp32 accumulation.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas / _flash_kernel) and computes what it computes:
// s = scale * q.k; softcap cap*tanh(s/cap); masks for causal (k <= q), sliding
// window (q - k < window) and ragged keys (k < Sk); GQA maps head h to kv head
// h / g with no KV copy; the running max, denominator and accumulator stay in
// fp32; l is clamped to 1e-30; masked logits take the finite NEG_INF = -2e38,
// so a row whose keys are all masked averages v over its Sk keys (the
// reference's finite answer) instead of giving NaN.
//
// Bound on this card: at the prefill shapes it does 4*Sq*Sk_eff*d flops per head
// against (2*Sq + 2*Sk)*d elements moved, so it is bound by operations. This
// first version does its products on CUDA cores in fp32, which is simple and
// exact against the fp32 reference; wgmma and TMA come later.
//
// Design: one block of 256 threads per (q tile of 64 rows, b*h). The TPU's
// sequential kv grid axis becomes a loop over kv tiles of 64 keys inside the
// block; causal and window bounds skip kv tiles that are masked for every row.
// q, k, v tiles are staged in shared memory as fp32 (rows padded by one word so
// the 16 threads of a row group hit distinct banks). Thread (ty, tx) owns rows
// 4*ty..4*ty+3, score columns tx+16j and output columns tx+16c; row maxima and
// sums reduce across the 16 lanes of a row group with warp shuffles. At d=256
// (recurrentgemma's local layers) the tiles take 213,760 bytes of shared
// memory, under the 232,448 a block may opt into, so one block runs per SM,
// and each thread keeps acc[4][16] in registers.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;
constexpr float kNegInf = -2.0e38f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float group16_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group16_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int group, int Sq, int Sk, float scale,
                 int causal, int has_window, int window, int has_softcap, float softcap,
                 int skip_tiles) {
  constexpr int QP = D + 1;
  constexpr int KP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int CPT = D / 16;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x QP
  float* Ks = Qs + BQ * QP;            // BK x KP
  float* Vs = Ks + BK * KP;            // BK x D
  float* Ps = Vs + BK * D;             // BQ x PP

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int Hkv = H / group;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + h / group) * Sk * D;
  const T* kp = k + kv_off;
  const T* vp = v + kv_off;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * QP + c] = (q0 + r < Sq) ? to_f(qp[i]) : 0.f;
  }

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int k_lo = 0, k_hi = Sk;
  if (skip_tiles) {
    if (causal) k_hi = min(Sk, q0 + BQ);
    if (has_window) k_lo = max(0, q0 - window + 1);
  }

  for (int kt = (k_lo / BK) * BK; kt < k_hi; kt += BK) {
    __syncthreads();                   // previous tile's readers are done
    for (int i = tid; i < BK * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const bool in = kt + r < Sk;
      const size_t g = static_cast<size_t>(kt) * D + i;
      Ks[r * KP + c] = in ? to_f(kp[g]) : 0.f;
      Vs[r * D + c] = in ? to_f(vp[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = kt + tx + 16 * j;
        float x = s[i][j] * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        bool ok = true;
        if (causal) ok = ok && kj <= qi;
        if (has_window) ok = ok && (qi - kj) < window;
        x = ok ? x : kNegInf;
        if (kj >= Sk) x = -INFINITY;   // no key here: weight exactly 0
        s[i][j] = x;
        mt = fmaxf(mt, x);
      }
      mt = group16_max(mt);
      const float m_new = fmaxf(m[i], mt);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps += p;
        Ps[(ty * 4 + i) * PP + tx + 16 * j] = p;
      }
      ps = group16_sum(ps);
      l[i] = alpha * l[i] + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PP + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const float vv = Vs[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int Hkv,
           int Sq, int Sk, float scale, int causal, int has_window, int window,
           int has_softcap, float softcap, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // Skipping kv tiles masked for every row of a q tile is exact whenever each
  // row keeps at least one key; a window below 1, or one with Sq > Sk, can leave
  // a row with none, and such a row must still average all Sk keys.
  const int skip = !(has_window && (window < 1 || Sq > Sk));
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / Hkv, Sq, Sk, scale, causal, has_window, window,
      has_softcap, softcap, skip);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B, int H,
               int Hkv, int Sq, int Sk, float scale, int causal, int has_window,
               int window, int has_softcap, float softcap, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                                  has_window, window, has_softcap, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                                  has_window, window, has_softcap, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                                    has_window, window, has_softcap, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                                    has_window, window, has_softcap, softcap, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,H,Sq,D), k/v (B,Hkv,Sk,D), o like q; all
// contiguous. Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int Sq, int Sk, int D,
                                      int dtype, float scale, int causal, int has_window,
                                      int window, int has_softcap, float softcap,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, has_window,
                             window, has_softcap, softcap, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal,
                                     has_window, window, has_softcap, softcap, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
