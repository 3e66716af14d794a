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

// rows [0, R) of a (rows, D) tile of E (bf16 or fp32) into a shared tile
// pad16(D) wide plus 16 bytes of padding a row; rows >= valid and columns >= D
// are zeros
template <int R, int D, int NT, typename E = bf16>
__device__ __forceinline__ void load_tile(uint32_t dst, const E* src, int valid, int tid) {
  constexpr int EPC = 16 / sizeof(E);            // elements per 16-byte chunk
  constexpr int CPR = pad16(D) / EPC;            // chunks per shared row
  constexpr int kStride = pad16(D) + EPC;
#pragma unroll
  for (int i = tid; i < R * CPR; i += NT) {
    const int r = i / CPR, c = i % CPR;
    const bool in = r < valid && c * EPC < D;
    cp_async16(dst + (r * kStride + c * EPC) * sizeof(E),
               src + (in ? static_cast<size_t>(r) * D + c * EPC : 0), in);
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
      case 16: return launch_core<16>(a, block_q, block_k);
      case 32: return launch_core<32>(a, block_q, block_k);
      case 64: return launch_core<64>(a, block_q, block_k);
      case 120: return launch_core<120>(a, block_q, block_k);
      case 128: return launch_core<128>(a, block_q, block_k);
      case 256: return launch_core<256>(a, block_q, block_k);
    }
  } else if (route == 1) {
    switch (D) {
      case 16: return launch_tc<16, 64, 64, 1>(a, block_q, block_k);
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
// backward: FlashAttention-2's algorithm on the tensor cores (bf16 on mma.sync,
// fp32 as three TF32 products)
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
//   dV = P^T dO, dK = scale * dS^T Q            flash_bwd_kernel<KV = true>
//   dQ = scale * dS K                           flash_bwd_kernel<KV = false>
// A row whose keys are all masked (lse = NEG_INF) averaged v over its Sk keys
// in the forward, so there P = 1/Sk and dS = 0.
//
// No float atomics, so a step is bitwise reproducible: the dK/dV launch gives
// each block one kv head's TR = 64 keys (resident) and streams the group's
// query heads and their q tiles through it; the dQ launch gives each block one
// head's 64 queries (resident) and streams the key tiles, recomputing S and dP.
// That is 7 products of 2*d flops per unmasked (q, k) pair against the 5 the
// gradient needs; the bound (kernels/sweep.py, flash_backward_work) counts 5.
// Both are one kernel: resident tiles R1, R2 (K, V or Q, dO), streamed tiles
// T1, T2 (Q, dO or K, V); per streamed tile each warp takes its 16 resident
// rows and computes s1 = R1 T1^T and s2 = R2 T2^T (S^T and dP^T for dK/dV,
// S and dP for dQ, so lse and D index columns in the first and rows in the
// second), turns them into P and dS in registers, and accumulates
// acc1 += dS T1 (dK or dQ) and, for dK/dV, acc0 += P T2 (dV). The fp32
// accumulator fragments of P and dS are the A operands of those products
// directly: no shared-memory round trip. Streamed tiles arrive through
// cp.async one tile ahead (two stages, or one staging tile refilled once it
// is split), so the next tile's loads overlap this tile's products; causal and window masks skip whole tiles (skip_rule), and only
// tiles the mask cuts run the per-entry mask; causal dQ tiles launch
// heaviest first. Tiles are E in shared memory, pad16(D) wide (d=120 pads to
// 128 with zeros) plus 16 bytes a row.
//
// tc_bf16 (E = bf16): mma.sync.m16n8k16, fp32 accumulate; R operands by
// ldmatrix, the T operand of s1/s2 by ldmatrix and of the dK/dV/dQ products by
// ldmatrix.trans; P and dS rounded to bf16 (pack_bf16) as they become A
// operands, as FlashAttention-2 and the reference's bf16 path round P; exp2
// with lse * log2(e). Bound: operations, 5 products at 989 TFLOP/s.
//
// tc_tf32x3 (E = float): each fp32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi) (cvt.rna), and each product is lo.hi + hi.lo, then hi.hi,
// on mma.sync.m16n8k8 tf32 with fp32 accumulate: about 2^-22 of a product,
// inside the fp32 bar of 1e-4 where one TF32 product (2^-11) is not. Operands
// come by 32-bit shared loads (ldmatrix is 16-bit). At d <= 128 each
// streamed tile is split once, into {hi, lo} pairs in shared memory, as soon
// as it lands, so the warps' B operands are one 64-bit load each. An
// accumulator fragment holds columns 2t, 2t+1 where a tf32 A fragment wants
// t, t+4: the k index of the dK/dV/dQ products is permuted (k = t is
// streamed row 2t, k = t + 4 row 2t + 1) in A and B alike, so the fragments
// are used as they stand. The tensor cores' fp32 accumulation rounds toward
// zero, which over thousands of products drifts past the bar, so each tile's
// dK/dV/dQ products sum in fresh fragments that one fp32 add puts into the
// running ones. Bound: three TF32 products per fp32 product, 5 products at
// 494.7 TFLOP/s (the CUDA cores' 67 TFLOP/s fp32 is the other bound a row
// states).
//
// Tiles (BwdCfg): 64 resident rows of 4 warps; streamed tiles of TS = 64
// rows at d = 32 and in bf16 at d = 64, 32 in fp32 at d = 64 and at d = 128
// (dQ in bf16: 64), 32 (bf16) or 16 (fp32) at d = 256. At d = 256 the dK and
// dV accumulators of a warp owning 16 keys by 256 columns (256 fp32 a
// thread) outgrow the registers, so both launches give the columns to WN = 2
// warps (8 warps a block); each warp of a pair reduces s1, s2 over its half
// of d and the pair adds the halves through shared memory. The dK/dV grid is
// B * Hkv * ceil(Sk / 64) blocks: with few kv heads and one sequence (g=10
// at recurrentgemma's d=256) it leaves most SMs idle.

namespace {

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 4 : 0));
}

// c (16x8 fp32) += a (16x8 tf32, row) * b (8x8 tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, each a tf32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// c[n] += a * b[n] as 3xTF32 for N independent fragments: lo.hi and hi.lo
// first, then hi.hi, each round over all N (the mma asm is volatile, so nvcc
// emits them in this order: no two dependent products back to back)
template <int N>
__device__ __forceinline__ void mma_tf32x3(float (&c)[N][4], const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4], const uint32_t (&bh)[N][2],
                                           const uint32_t (&bl)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], al, bh[n][0], bh[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bl[n][0], bl[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[n], ah, bh[n][0], bh[n][1]);
}

template <typename E>
struct IsF32 {
  static constexpr bool value = false;
};
template <>
struct IsF32<float> {
  static constexpr bool value = true;
};

// One backward launch's tiling: KV = the dK/dV launch, else dQ.
template <int D, typename E, bool KV>
struct BwdCfg {
  static constexpr bool kF32 = IsF32<E>::value;
  static constexpr int DP = pad16(D);
  static constexpr int TR = 64;                   // resident rows: 16 per warp row
  static constexpr int TS = DP <= 32  ? 64        // streamed rows per tile
                          : DP == 64  ? (kF32 ? 32 : 64)
                          : DP == 128 ? (KV || kF32 ? 32 : 64)
                                      : (kF32 ? 16 : 32);
  // warps splitting the output columns and the d-reduction of s1, s2 (d=256)
  static constexpr int WN = DP == 256 ? 2 : 1;
  static constexpr int DPW = DP / WN;             // columns a warp owns
  static constexpr int kWarps = TR / 16 * WN;
  static constexpr int kThreads = kWarps * 32;
  // blocks an SM the registers must allow: bf16 at d <= 64 fits 3 by shared
  // memory (capping its registers to match was faster on one H100), fp32 at
  // d=64 fits 2
  static constexpr int kMinBlocks = !kF32 && DP <= 64 ? 3 : DP == 64 ? 2 : 1;
  static constexpr int kPad = 16 / sizeof(E);     // 16 bytes a row
  static constexpr int kStride = DP + kPad;
  static constexpr int kRTile = TR * kStride;     // elements
  static constexpr int kSTile = TS * kStride;
  // fp32 at d <= 128: each streamed tile is split once into {hi, lo} pairs
  // (row stride kP2 pairs), so the warps' B operands need no conversion; its
  // copy lands in one staging tile, refilled once it is split
  static constexpr bool kPreSplit = kF32 && DP <= 128;
  static constexpr int kStages = kPreSplit ? 1 : 2;
  static constexpr int kP2 = DP + 4;
  static constexpr int kSplitTile = kPreSplit ? TS * kP2 : 0;   // float2
  // a warp's partial s1, s2 (16 x TS fp32 each), read by its partner (WN = 2)
  static constexpr int kXchg = WN > 1 ? kWarps * 2 * 16 * TS : 0;
  // R1, R2, staged T1, T2, split T1, T2; lse and D of two tiles' rows (dK/dV)
  static constexpr size_t kSmem = (2 * kRTile + 2 * kStages * kSTile) * sizeof(E) +
                                  2 * kSplitTile * sizeof(float2) +
                                  ((KV ? 4 * TS : 0) + kXchg) * sizeof(float);
};

// s[j] += R (this warp's 16 rows) . T (rows 8j .. 8j+7)^T over KW columns
template <int KW, int TS, int STRIDE, int TST>
__device__ __forceinline__ void tile_scores(float (&s)[TS / 8][4], const bf16* r,
                                            const bf16* t, int lane) {
  const uint32_t a_base =
      smem_u32(r) + (((lane & 7) + 8 * ((lane >> 3) & 1)) * STRIDE + 8 * (lane >> 4)) * 2;
  const uint32_t b_base =
      smem_u32(t) + (((lane & 7) + 8 * (lane >> 4)) * STRIDE + 8 * ((lane >> 3) & 1)) * 2;
#pragma unroll
  for (int kk = 0; kk < KW / 16; ++kk) {
    uint32_t af[4];
    ldmatrix_x4(af, a_base + kk * 32);
#pragma unroll
    for (int nb = 0; nb < TS / 16; ++nb) {
      uint32_t bb[4];
      ldmatrix_x4(bb, b_base + (nb * 16 * STRIDE + kk * 16) * 2);
      mma_bf16(s[2 * nb], af, bb[0], bb[1]);
      mma_bf16(s[2 * nb + 1], af, bb[2], bb[3]);
    }
  }
}

// a B operand of a TF32 product as hi and lo: split here from fp32, or as
// split ahead into a {hi, lo} pair
__device__ __forceinline__ void b_tf32(const float* t, int i, uint32_t& hi, uint32_t& lo) {
  split_tf32(t[i], hi, lo);
}
__device__ __forceinline__ void b_tf32(const float2* t, int i, uint32_t& hi, uint32_t& lo) {
  const float2 x = t[i];
  hi = __float_as_uint(x.x);
  lo = __float_as_uint(x.y);
}

// fp32 R (row stride RS), T of fp32 or {hi, lo} pairs (row stride TST)
template <int KW, int TS, int RS, int TST, typename TB>
__device__ __forceinline__ void tile_scores(float (&s)[TS / 8][4], const float* r,
                                            const TB* t, int lane) {
  const int g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KW / 8; ++kk) {
    const int c = kk * 8 + q;
    uint32_t ah[4], al[4];
    split_tf32(r[g * RS + c], ah[0], al[0]);
    split_tf32(r[(g + 8) * RS + c], ah[1], al[1]);
    split_tf32(r[g * RS + c + 4], ah[2], al[2]);
    split_tf32(r[(g + 8) * RS + c + 4], ah[3], al[3]);
    uint32_t bh[TS / 8][2], bl[TS / 8][2];
#pragma unroll
    for (int nb = 0; nb < TS / 8; ++nb) {
      b_tf32(t, (nb * 8 + g) * TST + c, bh[nb][0], bl[nb][0]);
      b_tf32(t, (nb * 8 + g) * TST + c + 4, bh[nb][1], bl[nb][1]);
    }
    mma_tf32x3(s, ah, al, bh, bl);
  }
}

// acc[n] += A . T[:, 8n .. 8n+7], A (16 x TS) given as this warp's fp32
// accumulator fragments a[TS/8][4], T the TS streamed rows from column `t` on
template <int NO, int TS, int STRIDE>
__device__ __forceinline__ void tile_accumulate(float (&acc)[NO][4], const float (&a)[TS / 8][4],
                                                const bf16* t, int lane) {
  const uint32_t b_base =
      smem_u32(t) + (((lane & 7) + 8 * ((lane >> 3) & 1)) * STRIDE + 8 * (lane >> 4)) * 2;
#pragma unroll
  for (int kk = 0; kk < TS / 16; ++kk) {
    uint32_t af[4];
    af[0] = pack_bf16(a[2 * kk][0], a[2 * kk][1]);
    af[1] = pack_bf16(a[2 * kk][2], a[2 * kk][3]);
    af[2] = pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]);
    af[3] = pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3]);
#pragma unroll
    for (int nb = 0; nb < NO / 2; ++nb) {
      uint32_t bb[4];
      ldmatrix_x4_trans(bb, b_base + (kk * 16 * STRIDE + nb * 16) * 2);
      mma_bf16(acc[2 * nb], af, bb[0], bb[1]);
      mma_bf16(acc[2 * nb + 1], af, bb[2], bb[3]);
    }
  }
}

// The TF32 products' sum over the tile is taken in fresh fragments, four
// column blocks at a time, and added to acc with one fp32 add: the tensor
// cores' own accumulation rounds toward zero, and thousands of 3xTF32
// products summed into one running fragment drift past the fp32 bar in dK
// and dV (recurrentgemma's d=256 and h2o's training shapes).
template <int NO, int TS, int TST, typename TB>
__device__ __forceinline__ void tile_accumulate(float (&acc)[NO][4], const float (&a)[TS / 8][4],
                                                const TB* t, int lane) {
  const int g = lane >> 2, q = lane & 3;
  constexpr int NG = NO < 4 ? NO : 4;
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += NG) {
    float part[NG][4];
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < TS / 8; ++kk) {
      // k = q is streamed row 8kk + 2q (accumulator column 2q), k = q + 4 row 2q + 1
      uint32_t ah[4], al[4];
      split_tf32(a[kk][0], ah[0], al[0]);
      split_tf32(a[kk][2], ah[1], al[1]);
      split_tf32(a[kk][1], ah[2], al[2]);
      split_tf32(a[kk][3], ah[3], al[3]);
      const int row = (kk * 8 + 2 * q) * TST + g;
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int n = 0; n < NG; ++n) {
        b_tf32(t, row + (n0 + n) * 8, bh[n][0], bl[n][0]);
        b_tf32(t, row + TST + (n0 + n) * 8, bh[n][1], bl[n][1]);
      }
      mma_tf32x3(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < NG; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n0 + n][e] += part[n][e];
  }
}

// rows [0, TS) of a staged fp32 tile (stride DP + 4) as {hi, lo} pairs (stride DP + 4)
template <int TS, int DP, int NT>
__device__ __forceinline__ void split_rows(float2* dst, const float* src, int tid) {
#pragma unroll 4
  for (int i = tid; i < TS * DP / 4; i += NT) {
    const int r = i / (DP / 4), c = (i % (DP / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(src + r * (DP + 4) + c);
    uint32_t h[4], l[4];
    split_tf32(x.x, h[0], l[0]);
    split_tf32(x.y, h[1], l[1]);
    split_tf32(x.z, h[2], l[2]);
    split_tf32(x.w, h[3], l[3]);
    float4* out = reinterpret_cast<float4*>(dst + r * (DP + 4) + c);
    out[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]), __uint_as_float(h[1]),
                         __uint_as_float(l[1]));
    out[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]), __uint_as_float(h[3]),
                         __uint_as_float(l[3]));
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// two adjacent gradient entries, rounded to E once
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

struct BwdMask {
  int Sq, Sk, causal, has_window, window, has_softcap;
  float scale, softcap;
};

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

// KV: block (b * Hkv + kv head, key tile); writes dK to g1 and dV to g0.
// !KV: block (b * H + head, q tile); writes dQ to g1.
template <int D, typename E, bool KV>
__global__ void __launch_bounds__(BwdCfg<D, E, KV>::kThreads, BwdCfg<D, E, KV>::kMinBlocks)
flash_bwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                 const E* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, E* __restrict__ g0, E* __restrict__ g1,
                 int H, int group, BwdMask mk, int skip_tiles, int heavy_first) {
  using C = BwdCfg<D, E, KV>;
  constexpr int TR = C::TR, TS = C::TS, NS = TS / 8, NO = C::DPW / 8, NT = C::kThreads;
  constexpr int STRIDE = C::kStride;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  E* r1 = reinterpret_cast<E*>(smem_raw);        // K (KV) or Q
  E* r2 = r1 + C::kRTile;                        // V or dO
  E* ts = r2 + C::kRTile;                        // stage st: T1 at ts + 2 st kSTile, T2 after
  float2* sp = reinterpret_cast<float2*>(ts + 2 * C::kStages * C::kSTile);  // split T1, T2
  float* ld = reinterpret_cast<float*>(sp + 2 * C::kSplitTile);   // KV: tile it's lse, D at
                                                                   // (it & 1) 2 TS
  float* xch = ld + (KV ? 4 * TS : 0);           // WN = 2: warp w's partial s1, s2

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp / C::WN, wc = warp % C::WN;
  const int gq = lane >> 2, tq = lane & 3;
  const int Sq = mk.Sq, Sk = mk.Sk, Hkv = H / group;
  const int r0 = (heavy_first ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * TR;
  const int bx = blockIdx.x;
  // KV: bx = b * Hkv + kv head; the streamed heads are b * H + (bx % Hkv) * group + hq
  const size_t kv_off =
      static_cast<size_t>(KV ? bx : (bx / H) * Hkv + (bx % H) / group) * Sk * D;
  const size_t q_off = static_cast<size_t>(bx) * Sq * D;      // dQ launch only
  const size_t head0 = KV ? static_cast<size_t>(bx / Hkv) * H + (bx % Hkv) * group : 0;

  // the streamed range: q tiles of each head of the group (KV) or key tiles
  int lo = 0, hi = KV ? Sq : Sk;
  if (skip_tiles) {
    if (KV) {
      if (mk.causal) lo = r0;
      if (mk.has_window) hi = min(Sq, r0 + TR - 1 + mk.window);
    } else {
      if (mk.causal) hi = min(Sk, r0 + TR);
      if (mk.has_window) lo = max(0, r0 - mk.window + 1);
    }
  }
  const int s_first = (lo / TS) * TS;
  const int n_st = hi > s_first ? (hi - s_first + TS - 1) / TS : 0;
  const int n_it = (KV ? group : 1) * n_st;

  auto stream_head = [&](int it) { return KV ? head0 + it / n_st : 0; };
  auto stream_row = [&](int it) { return s_first + (KV ? it % n_st : it) * TS; };
  auto load_stream = [&](int it) {
    const int st = it & 1, s0 = stream_row(it);
    const uint32_t t1 = smem_u32(ts + 2 * (C::kStages > 1 ? st : 0) * C::kSTile);
    const uint32_t t2 = t1 + C::kSTile * sizeof(E);
    if constexpr (KV) {
      const size_t bh = stream_head(it);
      const size_t off = (bh * Sq + s0) * D;
      load_tile<TS, D, NT, E>(t1, q + off, Sq - s0, tid);
      load_tile<TS, D, NT, E>(t2, dout + off, Sq - s0, tid);
      const uint32_t l = smem_u32(ld + st * 2 * TS);
      for (int i = tid; i < TS; i += NT) {
        const bool in = s0 + i < Sq;
        const size_t row = bh * Sq + (in ? s0 + i : 0);
        cp_async4(l + i * 4, lse + row, in);
        cp_async4(l + (TS + i) * 4, delta + row, in);
      }
    } else {
      load_tile<TS, D, NT, E>(t1, k + kv_off + static_cast<size_t>(s0) * D, Sk - s0, tid);
      load_tile<TS, D, NT, E>(t2, v + kv_off + static_cast<size_t>(s0) * D, Sk - s0, tid);
    }
  };

  // the resident tiles, with the first streamed tile: one copy group
  if constexpr (KV) {
    load_tile<TR, D, NT, E>(smem_u32(r1), k + kv_off + static_cast<size_t>(r0) * D, Sk - r0,
                            tid);
    load_tile<TR, D, NT, E>(smem_u32(r2), v + kv_off + static_cast<size_t>(r0) * D, Sk - r0,
                            tid);
  } else {
    load_tile<TR, D, NT, E>(smem_u32(r1), q + q_off + static_cast<size_t>(r0) * D, Sq - r0,
                            tid);
    load_tile<TR, D, NT, E>(smem_u32(r2), dout + q_off + static_cast<size_t>(r0) * D, Sq - r0,
                            tid);
  }
  if (n_it > 0) load_stream(0);
  cp_async_commit();

  // this lane's two resident rows; the dQ launch's lse and D
  const int row_a = r0 + wr * 16 + gq;
  float d_r[2] = {0.f, 0.f}, lse_r[2] = {0.f, 0.f};
  if constexpr (!KV) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qi = row_a + 8 * i;
      if (qi < Sq) {
        lse_r[i] = lse[static_cast<size_t>(bx) * Sq + qi];
        d_r[i] = delta[static_cast<size_t>(bx) * Sq + qi];
      }
    }
  }

  float acc0[KV ? NO : 1][4], acc1[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc1[n][e] = 0.f;
#pragma unroll
  for (int n = 0; n < (KV ? NO : 1); ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc0[n][e] = 0.f;

  const float scale2 = mk.scale * kLog2e, inv_sk = 1.f / Sk;
  const E* r1w = r1 + wr * 16 * STRIDE;
  const E* r2w = r2 + wr * 16 * STRIDE;
  // one streamed tile: s1, s2, then P and dS, then the products. t1, t2: its
  // T1, T2 as E (row stride STRIDE) or as split {hi, lo} pairs (kP2)
  auto tile = [&](int it, const auto* t1, const auto* t2) {
    constexpr int TST = sizeof(*t1) == sizeof(float2) ? C::kP2 : STRIDE;
    const int s0 = stream_row(it);
    const float* ls = ld + (it & 1) * 2 * TS;    // KV: this tile's lse, then D

    float s1[NS][4], s2[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s1[j][e] = s2[j][e] = 0.f;
    // with WN = 2 each warp of a pair reduces half of d, and the pair adds
    // the halves (in either order the same bits)
    const int kc = wc * C::DPW;
    tile_scores<C::DPW, TS, STRIDE, TST>(s1, r1w + kc, t1 + kc, lane);
    tile_scores<C::DPW, TS, STRIDE, TST>(s2, r2w + kc, t2 + kc, lane);
    if constexpr (C::WN > 1) {
      float* mine = xch + warp * 32 * TS;
      const float* other = xch + (warp ^ 1) * 32 * TS;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          mine[(j * 4 + e) * 32 + lane] = s1[j][e];
          mine[((NS + j) * 4 + e) * 32 + lane] = s2[j][e];
        }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s1[j][e] += other[(j * 4 + e) * 32 + lane];
          s2[j][e] += other[((NS + j) * 4 + e) * 32 + lane];
        }
    }

    // P and dS from this warp's 16 rows against the TS streamed rows; a tile
    // the mask leaves whole skips the mask. Masked entries and entries past
    // Sq or Sk take P = dS = 0; a row whose keys are all masked (lse below
    // -1e38) P = 1/Sk and dS = 0
    const int q_lo = KV ? s0 : r0 + wr * 16, q_n = KV ? TS : 16;
    const int k_lo = KV ? r0 + wr * 16 : s0, k_n = KV ? 16 : TS;
    const bool full = q_lo + q_n <= Sq && k_lo + k_n <= Sk &&
                      (!mk.causal || k_lo + k_n - 1 <= q_lo) &&
                      (!mk.has_window || q_lo + q_n - 1 - k_lo < mk.window);
#pragma unroll
    for (int j = 0; j < NS; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * tq + (e & 1);  // streamed row within the tile
        const float lse_v = KV ? ls[c] : lse_r[e >> 1];
        const float dd = KV ? ls[TS + c] : d_r[e >> 1];
        float p, ds;
        if (mk.has_softcap) {
          const float t = tanhf(s1[j][e] * mk.scale / mk.softcap);
          p = fast_exp2(fmaf(mk.softcap * t, kLog2e, -lse_v * kLog2e));
          ds = p * (s2[j][e] - dd) * (1.f - t * t);
        } else {
          p = fast_exp2(fmaf(s1[j][e], scale2, -lse_v * kLog2e));
          ds = p * (s2[j][e] - dd);
        }
        if (!full) {
          const int rr = row_a + 8 * (e >> 1);
          const int qi = KV ? s0 + c : rr, kj = KV ? rr : s0 + c;
          const bool in = qi < Sq && kj < Sk;
          bool vis = in;
          if (mk.causal) vis = vis && kj <= qi;
          if (mk.has_window) vis = vis && qi - kj < mk.window;
          const bool dead = in && lse_v < -1e38f;
          p = dead ? inv_sk : vis ? p : 0.f;
          ds = vis && !dead ? ds : 0.f;
        }
        s1[j][e] = p;
        s2[j][e] = ds;
      }
    }

    if constexpr (KV) tile_accumulate<NO, TS, TST>(acc0, s1, t2 + wc * C::DPW, lane);
    tile_accumulate<NO, TS, TST>(acc1, s2, t1 + wc * C::DPW, lane);
  };

  for (int it = 0; it < n_it; ++it) {
    if constexpr (C::kPreSplit) {
      cp_async_wait<0>();                        // tile it (and the resident tiles) landed
      __syncthreads();                           // and every warp is done with tile it-1
      split_rows<TS, C::DP, NT>(sp, ts, tid);
      split_rows<TS, C::DP, NT>(sp + C::kSplitTile, ts + C::kSTile, tid);
      __syncthreads();
      if (it + 1 < n_it) {                       // the staging tile is free again
        load_stream(it + 1);
        cp_async_commit();
      }
      tile(it, static_cast<const float2*>(sp), static_cast<const float2*>(sp + C::kSplitTile));
    } else {
      __syncthreads();                           // every warp is done with stage (it+1)&1
      if (it + 1 < n_it) {
        load_stream(it + 1);
        cp_async_commit();
        cp_async_wait<1>();                      // tile it (and the resident tiles) landed
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const E* t1 = ts + 2 * (it & 1) * C::kSTile;
      tile(it, t1, t1 + C::kSTile);
    }
  }
  if (n_it == 0) cp_async_wait<0>();             // the resident tiles' copies

  // dK = scale * acc1, dV = acc0 (rows: keys) or dQ = scale * acc1 (rows: queries)
  const int n_rows = KV ? Sk : Sq;
  E* out1 = g1 + (KV ? kv_off : q_off);
  E* out0 = KV ? g0 + kv_off : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row_a + 8 * i;
    if (row >= n_rows) continue;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int col = wc * C::DPW + n * 8 + 2 * tq;
      if (C::DP != D && col >= D) continue;
      const size_t at = static_cast<size_t>(row) * D + col;
      store2(out1 + at, acc1[n][2 * i] * mk.scale, acc1[n][2 * i + 1] * mk.scale);
      if constexpr (KV) store2(out0 + at, acc0[n][2 * i], acc0[n][2 * i + 1]);
    }
  }
}

template <int D, typename E>
int launch_bwd(const Args& a, const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv) {
  using CK = BwdCfg<D, E, true>;
  using CQ = BwdCfg<D, E, false>;
  auto* kv_kernel = flash_bwd_kernel<D, E, true>;
  auto* q_kernel = flash_bwd_kernel<D, E, false>;
  static std::atomic<int> allowed_kv[64], allowed_q[64];
  cudaError_t err = allow_smem(kv_kernel, static_cast<int>(CK::kSmem), allowed_kv);
  if (err == cudaSuccess) err = allow_smem(q_kernel, static_cast<int>(CQ::kSmem), allowed_q);
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
  dim3 grid_kv(a.B * a.Hkv, (a.Sk + CK::TR - 1) / CK::TR);
  kv_kernel<<<grid_kv, CK::kThreads, CK::kSmem, a.stream>>>(
      q, k, v, g, lse, delta, static_cast<E*>(dv), static_cast<E*>(dk), a.H, group, mk,
      skip_rule(a), 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_q(a.B * a.H, (a.Sq + CQ::TR - 1) / CQ::TR);
  q_kernel<<<grid_q, CQ::kThreads, CQ::kSmem, a.stream>>>(
      q, k, v, g, lse, delta, nullptr, static_cast<E*>(dq), a.H, group, mk, skip_rule(a),
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

// The backward of either route. route: 0 = float32 (tc_tf32x3), 1 = bfloat16
// (tc_bf16), the type of q, k, v, o, dout and of dq, dk, dv. q, o, dout, dq
// (B,H,Sq,D); k, v, dk, dv (B,Hkv,Sk,D); lse and delta (scratch for D =
// rowsum(dO * O)) (B,H,Sq) fp32; all contiguous, q, k, v, o and dout 16-byte
// aligned. Three launches on `stream`: the rowsum, dK/dV, dQ. Returns the
// first CUDA error of a launch, else 0.
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
