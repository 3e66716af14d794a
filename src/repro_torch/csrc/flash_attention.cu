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
// against (2*Sq + 2*Sk)*d elements moved, so it is bound by operations. Two
// routes, chosen by the wrapper (kernels/flash_attention/ops.py, plan()):
//
// tc_bf16 (every bf16 call): the products run on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate). One block of BQ/16 warps per
// (batch*head, q tile of BQ rows); each warp owns 16 query rows. Its Q fragment
// is loaded once with ldmatrix and kept in registers (d <= 128; at d=256 it is
// re-read from shared memory per kv tile, so the 16x256 fp32 accumulator fits
// in 247 registers without spilling).
// K/V tiles of BK keys arrive in bf16 shared memory through cp.async, double
// buffered, so the load of tile j+1 overlaps the products of tile j; K and V
// are separate copy groups, so Q.K^T starts before V has landed. Rows are
// padded by 16 bytes (an odd number of 16-byte units), so ldmatrix is free of
// bank conflicts. The online softmax runs on the accumulator fragments in
// registers (row max across the 4 lanes of a quad); P is rounded to bf16 in
// registers and fed back as the A operand of P.V, with V as the B operand
// through ldmatrix.trans. Causal q tiles are launched heaviest first. The
// card's full bf16 rate needs wgmma on TMA-fed swizzled tiles; that is the
// next design for this route.
//
// cuda_core (fp32: qwen3's d=128 prefill, recurrentgemma's d=256 local layers):
// products on CUDA cores in fp32, exact against the fp32 bar (TF32 would break
// it). One block of 256 threads per (batch*head, q tile of 64 rows), kv tiles of
// 64 keys staged in shared memory as fp32 (rows padded by one word). Thread
// (ty, tx) owns rows 4*ty..4*ty+3, score columns tx+16j and output columns
// tx+16c; row maxima and sums reduce across the 16 lanes of a row group. At
// d=256 the tiles take 213,760 bytes of shared memory, one block per SM.
//
// Both skip kv tiles that the causal or window mask hides from a whole q tile.
//
// Head dims that are not a multiple of 16 (h2o-danube3's 120) are padded in
// shared memory only: rows of D elements arrive in tiles DP = pad16(D) wide
// whose columns D..DP-1 are zeros, so the k-steps of 16 and the column split
// work on DP; nothing is padded in device memory, and only D columns are
// written back.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.0e38f;
constexpr float kLog2e = 1.4426950408889634f;

// the head dim a shared-memory tile is laid out for: D rounded up to 16
__host__ __device__ constexpr int pad16(int d) { return (d + 15) / 16 * 16; }

// ---------------------------------------------------------------------------------
// cuda_core route (fp32)
// ---------------------------------------------------------------------------------

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int kThreads = 256;

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
  return BQ * (D + 1) + BK * (D + 1) + BK * pad16(D) + BQ * (BK + 1);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, int H, int group,
                 int Sq, int Sk, float scale, int causal, int has_window, int window,
                 int has_softcap, float softcap, int skip_tiles, int heavy_first) {
  constexpr int QP = D + 1;
  constexpr int KP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DP = pad16(D);         // V rows in shared memory, zeros past D
  constexpr int CPT = DP / 16;         // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x QP
  float* Ks = Qs + BQ * QP;            // BK x KP
  float* Vs = Ks + BK * KP;            // BK x DP
  float* Ps = Vs + BK * DP;            // BQ x PP

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int Hkv = H / group;
  const int qt = heavy_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * BQ;
  const float* qp = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + h / group) * Sk * D;
  const float* kp = k + kv_off;
  const float* vp = v + kv_off;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  for (int i = tid; i < BQ * D; i += kThreads) {
    const int r = i / D, c = i % D;
    Qs[r * QP + c] = (q0 + r < Sq) ? qp[i] : 0.f;
  }
  if constexpr (DP != D) {             // the pad columns of V, never loaded
    for (int i = tid; i < BK * (DP - D); i += kThreads)
      Vs[(i / (DP - D)) * DP + D + i % (DP - D)] = 0.f;
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
      Ks[r * KP + c] = in ? kp[g] : 0.f;
      Vs[r * DP + c] = in ? vp[g] : 0.f;
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
        const float vv = Vs[kk * DP + tx + 16 * c];
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
    float* orow = o + (static_cast<size_t>(bh) * Sq + qi) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      if (tx + 16 * c < D) orow[tx + 16 * c] = acc[i][c] / denom;
  }
}

// ---------------------------------------------------------------------------------
// tc_bf16 route: mma.sync on the tensor cores
// ---------------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 fills zeros (rows past
// the end of q or k/v), so no garbage (or NaN) enters a product.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  const int n = in ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c (16x8 fp32) += a (16x16 bf16, row) * b (16x8 bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 -> one register of two bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ float fast_exp2(float x) {   // -inf -> 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A q tile of TBQ rows (16 per warp), kv tiles of TBK keys.
template <int D, int TBQ, int TBK>
struct TcCfg {
  static constexpr int kWarps = TBQ / 16;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int DP = pad16(D);            // tile width: k-steps of 16
  static constexpr int kStride = DP + 8;         // bf16 per shared row: 16 B of padding
  static constexpr bool kQRegs = DP <= 128;      // Q fragment kept in registers
  static constexpr int kQTile = TBQ * kStride;
  static constexpr int kKVTile = TBK * kStride;
  static constexpr size_t kSmem = (kQTile + 4 * kKVTile) * sizeof(bf16);  // Q, K[2], V[2]
};

// rows [0, R) of a (rows, D) bf16 tile into a shared tile pad16(D) wide; rows
// >= valid and columns >= D are zeros
template <int R, int D, int NT>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src, int valid, int tid) {
  constexpr int CPR = pad16(D) / 8;              // 16-byte chunks per shared row
  constexpr int kStride = pad16(D) + 8;
#pragma unroll
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r < valid && c * 8 < D;
    cp_async16(dst + (r * kStride + c * 8) * 2,
               src + (in ? static_cast<size_t>(r) * D + c * 8 : 0), in);
  }
}

// K and V tiles of a kv tile are separate cp.async groups: Q.K^T starts once K
// has landed while V is still in flight. Groups are committed in the order
// (Q, K0) V0 K1 V1 K2 ...; the K of tile j+1 is issued before Q.K^T of tile j
// and its V before P.V of tile j, each into the stage tile j-1 used.
template <int D, int TBQ, int TBK, int MINB>
__global__ void __launch_bounds__(TcCfg<D, TBQ, TBK>::kThreads, MINB)
flash_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, int H, int group, int Sq,
                int Sk, float scale, int causal, int has_window, int window, int has_softcap,
                float softcap, int skip_tiles, int heavy_first) {
  using C = TcCfg<D, TBQ, TBK>;
  constexpr int NT = C::kThreads;
  constexpr int kStride = C::kStride;
  constexpr int NS = TBK / 8;                    // 8-key column blocks of S
  constexpr int KS = C::DP / 16;                 // k-steps of Q.K^T, 16-wide blocks of O
  constexpr int NO = C::DP / 8;                  // 8-wide column blocks of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  const uint32_t q_s = smem_u32(Qs);
  const uint32_t k_s = q_s + C::kQTile * 2;      // stage st at k_s + st * kKVTile * 2
  const uint32_t v_s = k_s + 2 * C::kKVTile * 2;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int Hkv = H / group;
  const int qt = heavy_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * TBQ;
  const bf16* qp = q + (static_cast<size_t>(bh) * Sq + q0) * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + h / group) * Sk * D;
  const bf16* kp = k + kv_off;
  const bf16* vp = v + kv_off;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;       // mma fragment row group / column pair

  int k_lo = 0, k_hi = Sk;
  if (skip_tiles) {
    if (causal) k_hi = min(Sk, q0 + TBQ);
    if (has_window) k_lo = max(0, q0 - window + 1);
  }
  const int kt0 = (k_lo / TBK) * TBK;
  const int n_kt = k_hi > kt0 ? (k_hi - kt0 + TBK - 1) / TBK : 0;

  load_tile<TBQ, D, NT>(q_s, qp, Sq - q0, tid);
  if (n_kt > 0) load_tile<TBK, D, NT>(k_s, kp + static_cast<size_t>(kt0) * D, Sk - kt0, tid);
  cp_async_commit();
  if (n_kt > 0) load_tile<TBK, D, NT>(v_s, vp + static_cast<size_t>(kt0) * D, Sk - kt0, tid);
  cp_async_commit();

  // ldmatrix lane addresses (bytes, relative to a tile's base)
  // A (Q rows of this warp): matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
  const uint32_t a_off =
      ((warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1)) * kStride + 8 * (lane >> 4)) * 2;
  // B of Q.K^T (K rows = keys): keys (0-7 | 8-15) x d (0-7 | 8-15)
  const uint32_t kb_off = (((lane & 7) + 8 * (lane >> 4)) * kStride + 8 * ((lane >> 3) & 1)) * 2;
  // B of P.V (V rows = keys, transposed): keys (0-7 | 8-15) x d (0-7 | 8-15)
  const uint32_t vb_off = (((lane & 7) + 8 * ((lane >> 3) & 1)) * kStride + 8 * (lane >> 4)) * 2;

  // scores are kept in log2 units: x2 = x * log2(e), so p = 2^(x2 - m2)
  const float scale2 = scale * kLog2e;
  constexpr float kNegInf2 = kNegInf * kLog2e;
  const int r0 = q0 + warp * 16 + gq;            // this lane's two query rows
  const int r1 = r0 + 8;
  float m_r[2] = {kNegInf2, kNegInf2};
  float l_r[2] = {0.f, 0.f};                     // this lane's partial row sums
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qf[C::kQRegs ? KS : 1][4];

  for (int it = 0; it < n_kt; ++it) {
    const int kt = kt0 + it * TBK;
    const int st = it & 1;
    const bool more = it + 1 < n_kt;
    const uint32_t next = (st ^ 1) * C::kKVTile * 2;
    if (more) {                                  // K of tile it+1 into the other stage
      load_tile<TBK, D, NT>(k_s + next, kp + static_cast<size_t>(kt + TBK) * D,
                            Sk - kt - TBK, tid);
      cp_async_commit();
      cp_async_wait<2>();                        // K of tile it has landed
    } else {
      cp_async_wait<1>();
    }
    __syncthreads();
    if constexpr (C::kQRegs) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldmatrix_x4(qf[kk], q_s + a_off + kk * 32);
      }
    }
    const uint32_t ks = k_s + st * C::kKVTile * 2;
    const uint32_t vs = v_s + st * C::kKVTile * 2;

    // S = Q K^T for this warp's 16 rows x TBK keys
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t af[4];
      if constexpr (C::kQRegs) {
#pragma unroll
        for (int e = 0; e < 4; ++e) af[e] = qf[kk][e];
      } else {
        ldmatrix_x4(af, q_s + a_off + kk * 32);
      }
#pragma unroll
      for (int nb = 0; nb < NS / 2; ++nb) {
        uint32_t bb[4];
        ldmatrix_x4(bb, ks + kb_off + (nb * 16 * kStride + kk * 16) * 2);
        mma_bf16(s[2 * nb], af, bb[0], bb[1]);
        mma_bf16(s[2 * nb + 1], af, bb[2], bb[3]);
      }
    }

    // scale, softcap, masks; then the online softmax on the fragments
    const bool full = kt + TBK <= Sk && (!causal || kt + TBK - 1 <= q0) &&
                      (!has_window || q0 + TBQ - 1 - kt < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x;
        if (has_softcap)
          x = softcap * tanhf(s[j][e] * scale / softcap) * kLog2e;
        else
          x = s[j][e] * scale2;
        if (!full) {
          const int qi = e < 2 ? r0 : r1;
          const int kj = kt + j * 8 + 2 * tq + (e & 1);
          bool ok = true;
          if (causal) ok = ok && kj <= qi;
          if (has_window) ok = ok && (qi - kj) < window;
          x = ok ? x : kNegInf2;
          if (kj >= Sk) x = -INFINITY;         // no key here: weight exactly 0
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m_r[i], quad_max(mx[i]));
      alpha[i] = fast_exp2(m_r[i] - m_new);
      m_r[i] = m_new;
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = fast_exp2(s[j][e] - m_r[e >> 1]);
        ps[e >> 1] += p;
        s[j][e] = p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l_r[i] = alpha[i] * l_r[i] + ps[i];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    if (more) {                                  // V of tile it+1 into the other stage
      load_tile<TBK, D, NT>(v_s + next, vp + static_cast<size_t>(kt + TBK) * D,
                            Sk - kt - TBK, tid);
      cp_async_commit();
      cp_async_wait<2>();                        // V of tile it has landed
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                             // also: every warp is done with K[st]

    // O += P V: P (bf16) from the S fragments, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < TBK / 16; ++kk) {
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nb = 0; nb < KS; ++nb) {
        uint32_t bb[4];
        ldmatrix_x4_trans(bb, vs + vb_off + (kk * 16 * kStride + nb * 16) * 2);
        mma_bf16(acc[2 * nb], pf, bb[0], bb[1]);
        mma_bf16(acc[2 * nb + 1], pf, bb[2], bb[3]);
      }
    }
    // no barrier here: K[st] was free once every warp passed the barrier above
    // (all had finished Q.K^T), and V[st] is refilled only after the next
    // iteration's first barrier, which every warp reaches after this P.V
  }
  if (n_kt == 0) {                               // Q's copies are still in flight
    cp_async_wait<0>();
    __syncthreads();
  }

  // normalize, stage this warp's 16 rows in its own rows of Qs, store 16 B a lane
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = 1.f / fmaxf(quad_sum(l_r[i]), 1e-30f);
  bf16* Ow = Qs + warp * 16 * kStride;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(Ow + gq * kStride + c) =
        pack_bf16(acc[n][0] * inv[0], acc[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(Ow + (gq + 8) * kStride + c) =
        pack_bf16(acc[n][2] * inv[1], acc[n][3] * inv[1]);
  }
  __syncwarp();
  constexpr int CPR = D / 8;                     // 16-byte chunks of a global row
  bf16* orow0 = o + (static_cast<size_t>(bh) * Sq + q0 + warp * 16) * D;
  const int rows = min(16, Sq - q0 - warp * 16);
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    if (r < rows)
      *reinterpret_cast<uint4*>(orow0 + static_cast<size_t>(r) * D + c * 8) =
          *reinterpret_cast<const uint4*>(Ow + r * kStride + c * 8);
  }
}

// ---------------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------------

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) only when a launch needs more
// than the kernel is already allowed on this device, not on every launch;
// `allowed` is the kernel's own table (a static of its launch function)
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, std::atomic<int> (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && bytes <= allowed[dev].load())) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) {
    int seen = allowed[dev].load();
    while (seen < bytes && !allowed[dev].compare_exchange_weak(seen, bytes)) {
    }
  }
  return err;
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, H, Hkv, Sq, Sk;
  float scale;
  int causal, has_window, window, has_softcap;
  float softcap;
  int heavy_first;
  cudaStream_t stream;
};

// Skipping kv tiles masked for every row of a q tile is exact whenever each
// row keeps at least one key; a window below 1, or one with Sq > Sk, can leave
// a row with none, and such a row must still average all Sk keys.
inline int skip_rule(const Args& a) {
  return !(a.has_window && (a.window < 1 || a.Sq > a.Sk));
}

template <int D>
int launch_core(const Args& a, int block_q, int block_k) {
  if (block_q != BQ || block_k != BK) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_floats<D>() * sizeof(float);
  static std::atomic<int> allowed[64];
  cudaError_t err = allow_smem(flash_fwd_kernel<D>, static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.B * a.H, (a.Sq + BQ - 1) / BQ);
  flash_fwd_kernel<D><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.H, a.H / a.Hkv, a.Sq,
      a.Sk, a.scale, a.causal, a.has_window, a.window, a.has_softcap, a.softcap,
      skip_rule(a), a.heavy_first);
  return static_cast<int>(cudaGetLastError());
}

// MINB: blocks per SM the registers must allow (__launch_bounds__)
template <int D, int TBQ, int TBK, int MINB>
int launch_tc(const Args& a, int block_q, int block_k) {
  using C = TcCfg<D, TBQ, TBK>;
  if (block_q != TBQ || block_k != TBK) return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<int> allowed[64];
  cudaError_t err =
      allow_smem(flash_tc_kernel<D, TBQ, TBK, MINB>, static_cast<int>(C::kSmem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.B * a.H, (a.Sq + TBQ - 1) / TBQ);
  flash_tc_kernel<D, TBQ, TBK, MINB><<<grid, C::kThreads, C::kSmem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.H, a.H / a.Hkv, a.Sq,
      a.Sk, a.scale, a.causal, a.has_window, a.window, a.has_softcap, a.softcap,
      skip_rule(a), a.heavy_first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 = cuda_core (float32), 1 = tc_bf16 (bfloat16). block_q, block_k and
// heavy_first (launch the q tile with the most keys first) come from the
// wrapper's plan and must match a compiled tiling. q (B,H,Sq,D), k/v
// (B,Hkv,Sk,D), o like q; all contiguous, 16-byte aligned for tc_bf16.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      int B, int H, int Hkv, int Sq, int Sk, int D,
                                      int route, int block_q, int block_k, int heavy_first,
                                      float scale, int causal, int has_window, int window,
                                      int has_softcap, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const Args a{q, k, v, o, B, H, Hkv, Sq, Sk, scale, causal, has_window, window,
               has_softcap, softcap, heavy_first, static_cast<cudaStream_t>(stream)};
  if (route == 0) {
    switch (D) {
      case 32: return launch_core<32>(a, block_q, block_k);
      case 64: return launch_core<64>(a, block_q, block_k);
      case 120: return launch_core<120>(a, block_q, block_k);
      case 128: return launch_core<128>(a, block_q, block_k);
      case 256: return launch_core<256>(a, block_q, block_k);
    }
  } else if (route == 1) {
    switch (D) {
      case 32: return launch_tc<32, 64, 64, 1>(a, block_q, block_k);
      case 64: return launch_tc<64, 64, 64, 1>(a, block_q, block_k);
      case 120: return launch_tc<120, 64, 64, 1>(a, block_q, block_k);
      case 128: return launch_tc<128, 64, 64, 1>(a, block_q, block_k);
      case 256: return launch_tc<256, 64, 64, 1>(a, block_q, block_k);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
