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
// through ldmatrix.trans. Causal q tiles are launched heaviest first. When a
// gradient will be taken it also writes each row's log-sum-exp in fp32, from
// the row max (kept in log2 units) and the quad's summed denominator. The
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
constexpr float kLn2 = 0.6931471805599453f;

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
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int H, int group,
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
    // the row's log-sum-exp, for the backward (a null pointer when no gradient
    // will be taken); a row whose keys are all masked keeps m = NEG_INF, and
    // NEG_INF + log(Sk) rounds back to NEG_INF
    if (lse != nullptr && tx == 0) lse[static_cast<size_t>(bh) * Sq + qi] = m[i] + logf(l[i]);
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
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int H, int group, int Sq,
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
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l_r[i]);
    inv[i] = 1.f / fmaxf(l_row, 1e-30f);
    // the row's log-sum-exp for the backward (null: no gradient will be
    // taken), as the cuda_core route writes it: m (here m2 = m * log2(e)) plus
    // log(l); a row whose keys are all masked keeps m2 = NEG_INF * log2(e),
    // and its lse rounds to about NEG_INF, which the backward reads as such
    const int row = i == 0 ? r0 : r1;
    if (lse != nullptr && tq == 0 && row < Sq)
      lse[static_cast<size_t>(bh) * Sq + row] = m_r[i] * kLn2 + logf(l_row);
  }
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
  float* lse;                          // (B,H,Sq) fp32; null: not written
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
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H, a.H / a.Hkv,
      a.Sq, a.Sk, a.scale, a.causal, a.has_window, a.window, a.has_softcap, a.softcap,
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
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H, a.H / a.Hkv, a.Sq,
      a.Sk, a.scale, a.causal, a.has_window, a.window, a.has_softcap, a.softcap,
      skip_rule(a), a.heavy_first);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// route: 0 = cuda_core (float32), 1 = tc_bf16 (bfloat16). block_q, block_k and
// heavy_first (launch the q tile with the most keys first) come from the
// wrapper's plan and must match a compiled tiling. q (B,H,Sq,D), k/v
// (B,Hkv,Sk,D), o like q; all contiguous, 16-byte aligned for tc_bf16. lse
// (B,H,Sq) fp32 receives each row's log-sum-exp for the backward on either
// route, null when no gradient will be taken. Returns cudaGetLastError()
// after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int B, int H, int Hkv, int Sq, int Sk,
                                      int D, int route, int block_q, int block_k,
                                      int heavy_first, float scale, int causal,
                                      int has_window, int window, int has_softcap,
                                      float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0) return 0;
  const Args a{q, k, v, o, static_cast<float*>(lse), B, H, Hkv, Sq, Sk, scale, causal,
               has_window, window, has_softcap, softcap, heavy_first,
               static_cast<cudaStream_t>(stream)};
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

// ---------------------------------------------------------------------------------
// backward (fp32 or bf16 in, fp32 arithmetic on CUDA cores): FlashAttention-2's
// algorithm
// ---------------------------------------------------------------------------------
//
// No TPU kernel has a backward: the reference trains through jnp attention
// (src/repro/models/attention.py:111) and XLA differentiates it. The port runs
// no plain version on the card, so the backward is a kernel too. From the
// forward's row log-sum-exp lse (B,H,Sq) and its output O:
//   D = rowsum(dO * O)                          flash_bwd_dot_kernel
//   P = exp(s - lse) recomputed per tile, s the forward's scaled, soft-capped,
//   masked logit; dP = dO V^T; dS = P * (dP - D), times 1 - tanh^2 under the
//   softcap and 0 where the mask replaced the logit by NEG_INF;
//   dV = P^T dO, dK = scale * dS^T Q            flash_bwd_dkdv_kernel
//   dQ = scale * dS K                           flash_bwd_dq_kernel
// A row whose keys are all masked (lse = NEG_INF) averaged v over its Sk keys
// in the forward, so there P = 1/Sk and dS = 0.
//
// Bound on this card: operations (five products of 2*d flops per unmasked
// (q, k) pair, against the bytes of q, k, v, O, dO, dQ, dK, dV). No float
// atomics: the dK/dV kernel gives each block one kv head's tile of T keys and
// loops over the group's g query heads and their q tiles inside the block;
// the dQ kernel gives each block one q tile and loops over the key tiles. Each
// sum runs in a fixed order, so a step is bitwise reproducible. Layout as the
// forward's cuda_core route: 256 threads as 16 x 16; tiles of T = 64 rows
// (T = 32 at d=256, inside the shared memory) in fp32 rows padded to an odd
// stride; thread (ty, tx) owns rows ty*R.. of its block's resident tile
// (R = T/16) and columns tx + 16j of the streamed one. Head dims that are not
// a multiple of 16 use DP = pad16(D) output columns, the pad ones never read
// or written. The kernels are templated on the element type E of q, k, v, O,
// dO and of dQ, dK, dV: bf16 is widened to fp32 as it is loaded into the fp32
// shared tiles, every sum (and D) runs in fp32, and the gradients are rounded
// to E once, as they are stored. lse and D stay fp32. The card's tensor cores
// are left for a later design.

namespace {

template <int D>
struct BwdCfg {
  static constexpr int T = D > 128 ? 32 : 64;   // rows of a q tile and of a key tile
  static constexpr int R = T / 16;              // rows per thread
  static constexpr int DP = pad16(D);
  static constexpr int CPT = DP / 16;           // output columns per thread
  static constexpr int RS = D + 1;              // shared row stride
  static constexpr int PS = T + 1;
  static constexpr size_t kSmem = (4 * T * RS + 2 * T * PS + 2 * T) * sizeof(float);
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

struct BwdMask {
  int Sq, Sk, causal, has_window, window, has_softcap;
  float scale, softcap;
};

// P and dS of one (query row qi, key kj) from the raw dot products q.k and
// dO.v, the row's lse and D
__device__ __forceinline__ void bwd_entry(const BwdMask& m, int qi, int kj, float qk,
                                          float dov, float lse_i, float d_i, float& p,
                                          float& ds) {
  p = 0.f;
  ds = 0.f;
  if (qi >= m.Sq || kj >= m.Sk) return;
  float x = qk * m.scale, t = 0.f;
  if (m.has_softcap) {
    t = tanhf(x / m.softcap);
    x = m.softcap * t;
  }
  bool vis = true;
  if (m.causal) vis = vis && kj <= qi;
  if (m.has_window) vis = vis && (qi - kj) < m.window;
  if (lse_i < -1e38f) {                 // every key of the row masked: P = 1/Sk
    p = 1.f / m.Sk;
    return;
  }
  p = expf((vis ? x : kNegInf) - lse_i);
  if (vis) ds = p * (dov - d_i) * (m.has_softcap ? 1.f - t * t : 1.f);
}

// rows [r0, r0 + T) of a (rows, D) matrix of E into a shared fp32 tile of
// stride RS; rows past `rows` are zeros
template <int D, int T, typename E>
__device__ __forceinline__ void load_rows(float* dst, const E* __restrict__ src, int r0,
                                          int rows, int tid) {
  for (int i = tid; i < T * D; i += kThreads) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] = (r0 + r < rows) ? to_f(src[static_cast<size_t>(r0) * D + i]) : 0.f;
  }
}

template <typename E>
__global__ void flash_bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dout,
                                     float* __restrict__ delta, int rows, int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const E* a = o + static_cast<size_t>(row) * D;
  const E* b = dout + static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s = fmaf(to_f(a[c]), to_f(b[c]), s);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      E* __restrict__ dk, E* __restrict__ dv, int H, int group,
                      BwdMask mk, int skip_tiles, int heavy_first) {
  using C = BwdCfg<D>;
  constexpr int T = C::T, R = C::R, RS = C::RS, PS = C::PS, CPT = C::CPT;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + T * RS;
  float* Qs = Vs + T * RS;
  float* Os = Qs + T * RS;               // dO rows
  float* Ps = Os + T * RS;               // P^T: keys x queries
  float* Ss = Ps + T * PS;               // dS^T
  float* Ls = Ss + T * PS;
  float* Dl = Ls + T;

  const int Hkv = H / group;
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv, hk = bkv % Hkv;
  const int kt = heavy_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int k0 = kt * T;
  const int Sq = mk.Sq, Sk = mk.Sk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t kv_off = static_cast<size_t>(bkv) * Sk * D;
  load_rows<D, T, E>(Ks, k + kv_off, k0, Sk, tid);
  load_rows<D, T, E>(Vs, v + kv_off, k0, Sk, tid);

  float acc_k[R][CPT], acc_v[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  int q_lo = 0, q_hi = Sq;
  if (skip_tiles) {
    if (mk.causal) q_lo = k0;
    if (mk.has_window) q_hi = min(Sq, k0 + T - 1 + mk.window);
  }
  for (int hq = 0; hq < group; ++hq) {
    const size_t bh = static_cast<size_t>(b) * H + hk * group + hq;
    const E* qp = q + bh * Sq * D;
    const E* op = dout + bh * Sq * D;
    for (int q0 = (q_lo / T) * T; q0 < q_hi; q0 += T) {
      __syncthreads();                   // the previous tile's readers are done
      load_rows<D, T, E>(Qs, qp, q0, Sq, tid);
      load_rows<D, T, E>(Os, op, q0, Sq, tid);
      for (int r = tid; r < T; r += kThreads) {
        const bool in = q0 + r < Sq;
        Ls[r] = in ? lse[bh * Sq + q0 + r] : 0.f;
        Dl[r] = in ? delta[bh * Sq + q0 + r] : 0.f;
      }
      __syncthreads();

      float qk[R][R], dov[R][R];         // keys ty*R+i x queries tx+16j
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) qk[i][j] = dov[i][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float ka[R], va[R], qb[R], ob[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          ka[i] = Ks[(ty * R + i) * RS + d];
          va[i] = Vs[(ty * R + i) * RS + d];
        }
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qb[j] = Qs[(tx + 16 * j) * RS + d];
          ob[j] = Os[(tx + 16 * j) * RS + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < R; ++j) {
            qk[i][j] = fmaf(qb[j], ka[i], qk[i][j]);
            dov[i][j] = fmaf(ob[j], va[i], dov[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qr = tx + 16 * j;
          float p, ds;
          bwd_entry(mk, q0 + qr, k0 + ty * R + i, qk[i][j], dov[i][j], Ls[qr], Dl[qr], p, ds);
          Ps[(ty * R + i) * PS + qr] = p;
          Ss[(ty * R + i) * PS + qr] = ds;
        }
      __syncthreads();

#pragma unroll 4
      for (int qq = 0; qq < T; ++qq) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[(ty * R + i) * PS + qq];
          sv[i] = Ss[(ty * R + i) * PS + qq];
        }
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = tx + 16 * c;
          if (C::DP != D && col >= D) continue;
          const float ov = Os[qq * RS + col], qv = Qs[qq * RS + col];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
            acc_k[i][c] = fmaf(sv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int kj = k0 + ty * R + i;
    if (kj >= Sk) continue;
    const size_t row = kv_off + static_cast<size_t>(kj) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dk[row + col] = from_f<E>(acc_k[i][c] * mk.scale);
        dv[row + col] = from_f<E>(acc_v[i][c]);
      }
    }
  }
}

template <int D, typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const E* __restrict__ q, const E* __restrict__ k,
                    const E* __restrict__ v, const E* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    E* __restrict__ dq, int H, int group, BwdMask mk, int skip_tiles,
                    int heavy_first) {
  using C = BwdCfg<D>;
  constexpr int T = C::T, R = C::R, RS = C::RS, PS = C::PS, CPT = C::CPT;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Os = Qs + T * RS;               // dO rows
  float* Ks = Os + T * RS;
  float* Vs = Ks + T * RS;
  float* Ss = Vs + T * RS;               // dS: queries x keys
  float* Ls = Ss + T * PS;
  float* Dl = Ls + T;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int Hkv = H / group;
  const int qt = heavy_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * T;
  const int Sq = mk.Sq, Sk = mk.Sk;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const size_t q_off = static_cast<size_t>(bh) * Sq * D;
  const size_t kv_off = static_cast<size_t>(b * Hkv + h / group) * Sk * D;
  load_rows<D, T, E>(Qs, q + q_off, q0, Sq, tid);
  load_rows<D, T, E>(Os, dout + q_off, q0, Sq, tid);
  for (int r = tid; r < T; r += kThreads) {
    const bool in = q0 + r < Sq;
    Ls[r] = in ? lse[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
    Dl[r] = in ? delta[static_cast<size_t>(bh) * Sq + q0 + r] : 0.f;
  }

  float acc[R][CPT];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int k_lo = 0, k_hi = Sk;
  if (skip_tiles) {
    if (mk.causal) k_hi = min(Sk, q0 + T);
    if (mk.has_window) k_lo = max(0, q0 - mk.window + 1);
  }
  for (int k0 = (k_lo / T) * T; k0 < k_hi; k0 += T) {
    __syncthreads();
    load_rows<D, T, E>(Ks, k + kv_off, k0, Sk, tid);
    load_rows<D, T, E>(Vs, v + kv_off, k0, Sk, tid);
    __syncthreads();

    float qk[R][R], dov[R][R];           // queries ty*R+i x keys tx+16j
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) qk[i][j] = dov[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[R], oa[R], kb[R], vb[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qa[i] = Qs[(ty * R + i) * RS + d];
        oa[i] = Os[(ty * R + i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        kb[j] = Ks[(tx + 16 * j) * RS + d];
        vb[j] = Vs[(tx + 16 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < R; ++j) {
          qk[i][j] = fmaf(qa[i], kb[j], qk[i][j]);
          dov[i][j] = fmaf(oa[i], vb[j], dov[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int qr = ty * R + i;
        float p, ds;
        bwd_entry(mk, q0 + qr, k0 + tx + 16 * j, qk[i][j], dov[i][j], Ls[qr], Dl[qr], p, ds);
        Ss[qr * PS + tx + 16 * j] = ds;
      }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < T; ++kk) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = Ss[(ty * R + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int col = tx + 16 * c;
        if (C::DP != D && col >= D) continue;
        const float kv = Ks[kk * RS + col];
#pragma unroll
        for (int i = 0; i < R; ++i) acc[i][c] = fmaf(sv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qi = q0 + ty * R + i;
    if (qi >= Sq) continue;
    E* row = dq + q_off + static_cast<size_t>(qi) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) row[col] = from_f<E>(acc[i][c] * mk.scale);
    }
  }
}

template <int D, typename E>
int launch_bwd(const Args& a, const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv) {
  using C = BwdCfg<D>;
  static std::atomic<int> allowed_kv[64], allowed_q[64];
  cudaError_t err =
      allow_smem(flash_bwd_dkdv_kernel<D, E>, static_cast<int>(C::kSmem), allowed_kv);
  if (err == cudaSuccess)
    err = allow_smem(flash_bwd_dq_kernel<D, E>, static_cast<int>(C::kSmem), allowed_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = a.B * a.H * a.Sq;
  const E* g = static_cast<const E*>(dout);
  flash_bwd_dot_kernel<E><<<(rows + 7) / 8, 256, 0, a.stream>>>(
      static_cast<const E*>(a.o), g, delta, rows, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const BwdMask mk{a.Sq, a.Sk, a.causal, a.has_window, a.window, a.has_softcap, a.scale,
                   a.softcap};
  const int group = a.H / a.Hkv;
  const E* q = static_cast<const E*>(a.q);
  const E* k = static_cast<const E*>(a.k);
  const E* v = static_cast<const E*>(a.v);
  // causal: the key tiles with the most queries are the first ones, the q
  // tiles with the most keys the last ones; each grid starts with its heaviest
  dim3 grid_kv(a.B * a.Hkv, (a.Sk + C::T - 1) / C::T);
  flash_bwd_dkdv_kernel<D, E><<<grid_kv, kThreads, C::kSmem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<E*>(dk), static_cast<E*>(dv), a.H, group, mk,
      skip_rule(a), 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q(a.B * a.H, (a.Sq + C::T - 1) / C::T);
  flash_bwd_dq_kernel<D, E><<<grid_q, kThreads, C::kSmem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<E*>(dq), a.H, group, mk, skip_rule(a),
      a.heavy_first);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_bwd_d(const Args& a, int D, const void* dout, const float* lse, float* delta,
                 void* dq, void* dk, void* dv) {
  switch (D) {
    case 32: return launch_bwd<32, E>(a, dout, lse, delta, dq, dk, dv);
    case 64: return launch_bwd<64, E>(a, dout, lse, delta, dq, dk, dv);
    case 120: return launch_bwd<120, E>(a, dout, lse, delta, dq, dk, dv);
    case 128: return launch_bwd<128, E>(a, dout, lse, delta, dq, dk, dv);
    case 256: return launch_bwd<256, E>(a, dout, lse, delta, dq, dk, dv);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The backward of either route. route: 0 = float32, 1 = bfloat16, the type of
// q, k, v, o, dout and of dq, dk, dv. q, o, dout, dq (B,H,Sq,D); k, v, dk, dv
// (B,Hkv,Sk,D); lse and delta (scratch for D = rowsum(dO * O)) (B,H,Sq) fp32;
// all contiguous. Three launches on `stream`: the rowsum, dK/dV, dQ. Returns
// the first CUDA error of a launch, else 0.
extern "C" int flash_attention_backward_launch(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const void* lse, void* delta, void* dq, void* dk, void* dv, int B, int H, int Hkv,
    int Sq, int Sk, int D, int route, int heavy_first, float scale, int causal,
    int has_window, int window, int has_softcap, float softcap, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0) return 0;
  const Args a{q, k, v, const_cast<void*>(o), nullptr, B, H, Hkv, Sq, Sk, scale, causal,
               has_window, window, has_softcap, softcap, heavy_first,
               static_cast<cudaStream_t>(stream)};
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (route == 0) return launch_bwd_d<float>(a, D, dout, l, dl, dq, dk, dv);
  if (route == 1) return launch_bwd_d<bf16>(a, D, dout, l, dl, dq, dk, dv);
  return static_cast<int>(cudaErrorInvalidValue);
}
