// Flash decode for Hopper: one new query token per (batch, head) against a KV
// cache, fp32 online softmax, split across blocks along the cache.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention/kernel.py
// (decode_attention_pallas / _decode_kernel) and computes what it computes:
// s = scale * q.k over the g = H/Hkv query heads that share a kv head; softcap
// cap*tanh(s/cap); slots whose mask byte is 0 take the finite NEG_INF = -2e38,
// so a row with no valid slot averages v over its S slots (the oracle's finite
// answer) instead of giving NaN; the running max, denominator and accumulator
// stay in fp32; l is clamped to 1e-30; the output is in q's dtype. The mask is
// (S,) shared by the batch (valid_stride 0) or (B, S), one row per batch entry
// (valid_stride S), which is what per-slot ring positions need.
//
// Bound on this card: bytes. Each step streams the cache once and does 4*g*d
// flops per cached slot, far below the ~20 flops per byte (fp32 CUDA cores) or
// ~295 (bf16 tensor cores) where the card stops being bound by memory. So the
// design keeps the stream dense and the grid full:
// - All g query heads of a kv head are computed from each K/V row while it is
//   in registers: the only reuse decode has (the TPU kernel's reason for its
//   (1, 1, g, d) q block).
// - Loads are 16 bytes a lane, neighbouring lanes on neighbouring addresses: a
//   row of d elements is read by LPR = min(32, d*sizeof(T)/16) lanes, each
//   taking VPL 16-byte vectors of it (2 for fp32 at d=256), and a warp reads
//   RPW = 32/LPR consecutive rows per load. Each lane keeps NJ rows of K and V
//   in flight per step.
// - g is a loop bound, not a lane count, so any g works; the dispatch builds
//   g = 1, 2, 4, 8 and 10 (recurrentgemma's 10 query heads over one kv head).
//   Where q's share of registers would crowd out the g accumulators (d=256,
//   g=10) q is staged in shared memory, in the space the warps' final merge
//   uses after the loop.
// - The TPU's sequential kv grid axis and VMEM scratch become, per lane group,
//   a loop over the cache with the online-softmax state in registers; the lane
//   groups of a warp and the warps of a block merge their states at the end
//   (shuffles, then shared memory).
// - At a decode batch the (b, kv-head) pairs alone are too few blocks for 132
//   SMs (B=4, Hkv=8 gives 32), so the cache is also split across blocks
//   (flash-decoding): each block writes its (m, l, acc) to a scratch buffer the
//   wrapper allocates, and a second kernel merges the splits of each head.
// - Where a row has at least one valid slot, a warp skips a step whose slots
//   are all invalid without loading them (their weight exp(NEG_INF - m) is
//   exactly 0), so a cache that is mostly empty costs what its filled slots
//   cost. A row with no valid slot loads everything, to average it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vector loads, widened to fp32.
__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Merge online-softmax state (m, l, acc) with another one (mo, lo, acco).
__device__ __forceinline__ void merge_state(float& m, float& l, float mo, float lo,
                                            float& a, float& b) {
  const float mn = fmaxf(m, mo);
  a = expf(m - mn);
  b = expf(mo - mn);
  l = l * a + lo * b;
  m = mn;
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    T* __restrict__ out, float* __restrict__ part, int Hkv, int S,
                    int valid_stride, float scale, int has_softcap, float softcap,
                    int split_len, int n_splits) {
  constexpr int EPL = 16 / sizeof(T);          // elements per 16-byte load
  constexpr int VPR = D / EPL;                 // 16-byte vectors in a row
  constexpr int LPR = VPR < 32 ? VPR : 32;     // lanes reading one row
  constexpr int VPL = VPR / LPR;               // vectors a lane reads per row
  constexpr int CPL = VPL * EPL;               // columns a lane holds
  constexpr int RPW = 32 / LPR;                // rows a warp reads per load
  constexpr int NJ = (G * CPL >= 32) ? 2 : 4;  // rows per lane group per step
  constexpr int STEP = RPW * NJ;               // rows per warp per step
  // q lives in registers unless its G*CPL values would crowd out the
  // accumulators (d=256 with g=10: 80 each); then it is read from shared memory
  constexpr bool kQShared = G * CPL > 64;
  static_assert(LPR >= 1 && 32 % LPR == 0 && VPR % LPR == 0, "unsupported head dim");

  __shared__ float sm_m[kWarps][G];
  __shared__ float sm_l[kWarps][G];
  __shared__ float sm_acc[kWarps][G][D];       // also holds q (G x D) during the loop
  float* sm_q = &sm_acc[0][0][0];

  const int sp = blockIdx.x;
  const int bh = blockIdx.y;                   // b * Hkv + kv head
  const int b = bh / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane / LPR;                  // which row of a load
  const int col0 = (lane % LPR) * EPL;         // first column this lane holds
  const uint8_t* vrow = valid + static_cast<size_t>(b) * valid_stride;
  // q rows of the g heads that share this kv head: (b, hk*G + gi) = bh*G + gi
  const T* qbase = q + static_cast<size_t>(bh) * G * D;

  float qr[kQShared ? 1 : G][CPL];
  if constexpr (kQShared) {
    for (int t = threadIdx.x; t < G * D; t += kThreads) sm_q[t] = to_float(qbase[t]);
  } else {
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
        load16(qbase + gi * D + col0 + vv * LPR * EPL, qr[gi] + vv * EPL);
  }

  int any = 0;
  for (int j = threadIdx.x; j < S; j += kThreads) any |= vrow[j];
  const int row_any = __syncthreads_or(any);   // also publishes sm_q

  float m[G], l[G], acc[G][CPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    m[gi] = kNegInf;
    l[gi] = 0.f;
#pragma unroll
    for (int e = 0; e < CPL; ++e) acc[gi][e] = 0.f;
  }

  const size_t kv_base = static_cast<size_t>(bh) * S * D;
  const int s0 = sp * split_len;
  const int s1 = min(S, s0 + split_len);
  for (int c0 = s0 + warp * STEP; c0 < s1; c0 += kWarps * STEP) {
    bool in[NJ], ok[NJ];
    bool mine = false;
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const int j = c0 + i * RPW + sub;
      in[i] = j < s1;
      ok[i] = in[i] && vrow[j] != 0;
      mine |= ok[i];
    }
    if (row_any && !__any_sync(kFull, mine)) continue;   // uniform across the warp

    float kf[NJ][CPL], vf[NJ][CPL];
#pragma unroll
    for (int i = 0; i < NJ; ++i) {
      const size_t off = kv_base + static_cast<size_t>(c0 + i * RPW + sub) * D + col0;
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv) {
        if (in[i]) {
          load16(k + off + vv * LPR * EPL, kf[i] + vv * EPL);
          load16(v + off + vv * LPR * EPL, vf[i] + vv * EPL);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kf[i][vv * EPL + e] = vf[i][vv * EPL + e] = 0.f;
        }
      }
    }

#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      float qg[CPL];
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          qg[vv * EPL + e] = kQShared ? sm_q[gi * D + col0 + vv * LPR * EPL + e]
                                      : qr[kQShared ? 0 : gi][vv * EPL + e];
      float s[NJ];
      float mt = -INFINITY;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < CPL; ++e) dot = fmaf(qg[e], kf[i][e], dot);
#pragma unroll
        for (int off = LPR / 2; off > 0; off >>= 1) dot += __shfl_xor_sync(kFull, dot, off);
        float x = dot * scale;
        if (has_softcap) x = softcap * tanhf(x / softcap);
        x = ok[i] ? x : kNegInf;
        if (!in[i]) x = -INFINITY;             // another split's slot: weight exactly 0
        s[i] = x;
        mt = fmaxf(mt, x);
      }
      const float m_new = fmaxf(m[gi], mt);
      const float alpha = expf(m[gi] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < NJ; ++i) {
        s[i] = expf(s[i] - m_new);
        ps += s[i];
      }
      l[gi] = l[gi] * alpha + ps;
      m[gi] = m_new;
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        float a = acc[gi][e] * alpha;
#pragma unroll
        for (int i = 0; i < NJ; ++i) a = fmaf(s[i], vf[i][e], a);
        acc[gi][e] = a;
      }
    }
  }

  // merge the RPW lane groups of the warp (they hold the same columns)
#pragma unroll
  for (int off = LPR; off < 32; off <<= 1) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float mo = __shfl_xor_sync(kFull, m[gi], off);
      const float lo = __shfl_xor_sync(kFull, l[gi], off);
      float a, c;
      merge_state(m[gi], l[gi], mo, lo, a, c);
#pragma unroll
      for (int e = 0; e < CPL; ++e) {
        const float ao = __shfl_xor_sync(kFull, acc[gi][e], off);
        acc[gi][e] = acc[gi][e] * a + ao * c;
      }
    }
  }
  if constexpr (kQShared) __syncthreads();     // every warp is done reading sm_q
  if (lane < LPR) {
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
#pragma unroll
      for (int vv = 0; vv < VPL; ++vv)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          sm_acc[warp][gi][col0 + vv * LPR * EPL + e] = acc[gi][vv * EPL + e];
      if (lane == 0) {
        sm_m[warp][gi] = m[gi];
        sm_l[warp][gi] = l[gi];
      }
    }
  }
  __syncthreads();

  // merge the warps; write the head's output, or this split's partial state
  for (int t = threadIdx.x; t < G * D; t += kThreads) {
    const int gi = t / D, c = t % D;
    float mm = sm_m[0][gi], ll = sm_l[0][gi], aa = sm_acc[0][gi][c];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      float a, cw;
      merge_state(mm, ll, sm_m[w][gi], sm_l[w][gi], a, cw);
      aa = aa * a + sm_acc[w][gi][c] * cw;
    }
    const size_t head = static_cast<size_t>(bh) * G + gi;   // b * H + h
    if (n_splits == 1) {
      out[head * D + c] = from_f<T>(aa / fmaxf(ll, 1e-30f));
    } else {
      float* p = part + (head * n_splits + sp) * (D + 2);
      if (c == 0) {
        p[0] = mm;
        p[1] = ll;
      }
      p[2 + c] = aa;
    }
  }
}

// One block per (b, h), one thread per output column: merge the splits.
template <typename T>
__global__ void decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                                      int D, int n_splits) {
  const size_t head = blockIdx.x;
  const float* p = part + head * n_splits * (D + 2);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    float mm = p[0], ll = p[1], aa = p[2 + c];
    for (int i = 1; i < n_splits; ++i) {
      const float* pi = p + static_cast<size_t>(i) * (D + 2);
      float a, b;
      merge_state(mm, ll, pi[0], pi[1], a, b);
      aa = aa * a + pi[2 + c] * b;
    }
    out[head * D + c] = from_f<T>(aa / fmaxf(ll, 1e-30f));
  }
}

template <typename T, int D, int G>
int launch(const void* q, const void* k, const void* v, const uint8_t* valid, void* out,
           float* part, int B, int H, int Hkv, int S, int valid_stride, float scale,
           int has_softcap, float softcap, int n_splits, int split_len,
           cudaStream_t stream) {
  dim3 grid(n_splits, B * Hkv);
  decode_split_kernel<T, D, G><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), valid,
      static_cast<T*>(out), part, Hkv, S, valid_stride, scale, has_softcap, softcap,
      split_len, n_splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_splits == 1) return static_cast<int>(err);
  decode_combine_kernel<T><<<B * H, D, 0, stream>>>(part, static_cast<T*>(out), D,
                                                   n_splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dispatch_g(int G, const void* q, const void* k, const void* v, const uint8_t* valid,
               void* out, float* part, int B, int H, int Hkv, int S, int valid_stride,
               float scale, int has_softcap, float softcap, int n_splits, int split_len,
               cudaStream_t s) {
#define DECODE_CASE(g)                                                                 \
  case g:                                                                              \
    return launch<T, D, g>(q, k, v, valid, out, part, B, H, Hkv, S, valid_stride,      \
                           scale, has_softcap, softcap, n_splits, split_len, s);
  switch (G) {
    DECODE_CASE(1)
    DECODE_CASE(2)
    DECODE_CASE(4)
    DECODE_CASE(8)
    DECODE_CASE(10)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DECODE_CASE
}

template <typename T>
int dispatch_d(int D, int G, const void* q, const void* k, const void* v,
               const uint8_t* valid, void* out, float* part, int B, int H, int Hkv, int S,
               int valid_stride, float scale, int has_softcap, float softcap,
               int n_splits, int split_len, cudaStream_t s) {
  switch (D) {
    case 32: return dispatch_g<T, 32>(G, q, k, v, valid, out, part, B, H, Hkv, S,
                                      valid_stride, scale, has_softcap, softcap,
                                      n_splits, split_len, s);
    case 64: return dispatch_g<T, 64>(G, q, k, v, valid, out, part, B, H, Hkv, S,
                                      valid_stride, scale, has_softcap, softcap,
                                      n_splits, split_len, s);
    case 128: return dispatch_g<T, 128>(G, q, k, v, valid, out, part, B, H, Hkv, S,
                                        valid_stride, scale, has_softcap, softcap,
                                        n_splits, split_len, s);
    case 256: return dispatch_g<T, 256>(G, q, k, v, valid, out, part, B, H, Hkv, S,
                                        valid_stride, scale, has_softcap, softcap,
                                        n_splits, split_len, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,H,D), k/v (B,Hkv,S,D), out like q, all
// contiguous and 16-byte aligned; valid uint8 with row stride valid_stride (0 for
// one (S,) row shared by the batch, S for (B,S)); part: n_splits > 1 only,
// B*H*n_splits*(D+2) floats of scratch. The cache is cut into n_splits ranges of
// split_len slots. Returns cudaGetLastError() after the launches.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* part, int B,
                                       int H, int Hkv, int S, int D, int dtype,
                                       int valid_stride, float scale, int has_softcap,
                                       float softcap, int n_splits, int split_len,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || n_splits <= 0 ||
      static_cast<long long>(n_splits) * split_len < S)
    return static_cast<int>(cudaErrorInvalidValue);
  const int G = H / Hkv;
  const uint8_t* vb = static_cast<const uint8_t*>(valid);
  float* pf = static_cast<float*>(part);
  if (dtype == 0)
    return dispatch_d<float>(D, G, q, k, v, vb, out, pf, B, H, Hkv, S, valid_stride,
                             scale, has_softcap, softcap, n_splits, split_len, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, G, q, k, v, vb, out, pf, B, H, Hkv, S,
                                     valid_stride, scale, has_softcap, softcap, n_splits,
                                     split_len, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
