// Flash decode for Hopper: one new query token per (batch, head) against a KV
// cache, fp32 online softmax, split across blocks along the filled part of the
// cache.
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
// Bound on this card: bytes. Each step streams the filled part of the cache
// once and does 4*g*d flops per slot: at most 5 flops per byte (g=10, fp32),
// under the ~20 where fp32 CUDA cores would be the limit. A decode batch is a
// few rows of a few thousand slots, so what stands between the kernel and its
// bound is latency: too few bytes in flight, and blocks with nothing to do.
// The design:
// - The live extent, decided on the device. Each block reduces its row's mask
//   to its first and last valid slot [lo, hi] (16-byte loads, one block
//   reduction) and takes split `split`'s share of it: split_range below, which
//   computes what ops.split_range computes. A row with no valid slot takes
//   [0, S), to average v over all S slots. A wrapped ring, valid at both ends,
//   takes the whole row. The host picks n_splits from B*Hkv and the SM count
//   alone: it reads no mask and makes no sync.
// - Pipelined loads. A tile of kTile cache rows is one contiguous span of
//   K and one of V; 16-byte cp.async copies them into a ring of NST
//   shared-memory stages, NST-1 tiles ahead of the one being computed (64 KB
//   in flight at fp32 d=128), K and V as separate groups so the scores start
//   before V lands. Where one stage is 66 KB (fp32 d=256) the ring has one
//   stage and two blocks share an SM, overlapping each other's loads. Rows
//   are padded by 16 bytes in shared memory so that a warp reading 32 rows
//   at one column hits 32 banks. Rows past the block's share arrive as zeros.
// - Inside the extent, a tile whose slots are all invalid is not loaded
//   (its weight exp(NEG_INF - m) would be exactly 0); a block learns during
//   its mask reduction whether its extent is dense and then tests no tile.
// - Compute from shared memory, on the CUDA cores (fp32 stays off the tensor
//   cores: TF32 cannot meet the fp32 bar of 2e-5). Scores: each thread dots
//   one key (four for g >= 4, sharing its q loads among them) over a part of
//   the columns, q broadcast from shared memory, so no shuffle reduction per
//   row. Softmax: one warp per head, one lane per key, one max and one sum
//   per tile, a warp's heads reduced side by side. P.V: threads over 16-byte
//   column vectors and interleaved key groups, all g heads from each V vector
//   read, the probabilities of a key read as 16-byte vectors.
// - A split whose share is empty, or holds no valid slot of a row that has
//   some, writes the zero-weight state (m = -inf, l = 0, acc = 0); merges
//   weigh a -inf max as exactly 0 and never form -inf - (-inf). Split 0 holds
//   lo, so it is never empty and its max is finite. A second kernel merges
//   the splits of each head when n_splits > 1, against the max over them.
// - The logsumexp of each head's scores, m + log(l), goes to `lse` when a
//   pointer is passed (the one-split kernel, or the merge): a position-split
//   cache's ranks merge their partial results with it. A row with no valid
//   slot gives about NEG_INF there, so such a partial weighs 0 beside a live
//   one.
// - A head dim that is not a power of two (h2o-danube3's 120) is padded in
//   shared memory only: q and the K/V tiles are DP = pow2ceil(D) wide, their
//   columns D..DP-1 zeros (cp.async fills them without reading), so the
//   thread layout of DP applies; the cache is read in place, never copied.
//   A row is at least four 16-byte vectors wide, one for each column part of
//   a key, so bf16 at d=16 (reduced qwen3-1.7b) runs on rows 32 wide.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;               // split kernel: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kCombineThreads = 1024;
constexpr int kMaxSplits = 4096;            // the combine's weights fit its shared memory
constexpr int kTile = 32;                   // cache rows per pipeline stage (one per lane)
constexpr int kStageBudget = 104 * 1024;    // shared memory for the stage ring, about
constexpr float kNegInf = -2.0e38f;
constexpr unsigned kFull = 0xffffffffu;

constexpr int kMaxSmem = 232448;            // dynamic shared memory a block may use
constexpr int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
__host__ __device__ constexpr int pow2ceil(int x) { return x <= 1 ? 1 : 2 * pow2ceil((x + 1) / 2); }

template <typename T, int D, int G>
struct Cfg {
  static constexpr int EPL = 16 / static_cast<int>(sizeof(T));  // elements per 16 bytes
  // shared row width: at least 4 vectors, one for each column part of a key
  static constexpr int DP = pow2ceil(D) < 4 * EPL ? 4 * EPL : pow2ceil(D);
  static constexpr int NV = DP / EPL;                             // 16-byte vectors per row
  static constexpr int RS = DP * static_cast<int>(sizeof(T)) + 16; // padded row, bytes
  static constexpr int SB = 2 * kTile * RS;                       // one stage: K and V tiles
  static constexpr int NST = clampi(kStageBudget / SB, 1, 4);     // stages in the ring
  // scores: each thread dots KPT keys (sharing its q loads among them) over
  // NVP vectors of the row, one of SP column parts
  static constexpr int KPT = (G >= 4 && NV >= 16) ? 4 : 1;
  static constexpr int KB = kTile / KPT;                          // key bases
  static constexpr int SP = kThreads / KB;                        // column parts
  static constexpr int NVP = NV / SP;
  static constexpr int KG = kThreads / NV;                        // key groups in P.V
  static constexpr int HPW = (G + kWarps - 1) / kWarps;           // heads per softmax warp
  static constexpr int GP = (G + 3) / 4 * 4;                      // probabilities per key
  static constexpr int RED = KG * G * DP * 4;                     // key-group merge buffer
  static constexpr int REGION = NST * SB > RED ? NST * SB : RED;
  static constexpr int OFF_Q = REGION;                            // q, fp32 (G, DP)
  static constexpr int OFF_SC = OFF_Q + G * DP * 4;               // partial scores
  static constexpr int OFF_P = OFF_SC + SP * G * kTile * 4;       // probabilities (kTile, GP)
  static constexpr int OFF_A = OFF_P + GP * kTile * 4;            // alpha, m, l per head
  static constexpr int OFF_I = OFF_A + (3 * G * 4 + 15) / 16 * 16;
  static constexpr int BYTES = OFF_I + (NST + 3 * kWarps) * 4;
  static_assert(NV >= SP && NV % SP == 0 && kThreads % NV == 0 &&
                kTile % KG == 0 && D % EPL == 0, "unsupported head dim");
  static_assert(BYTES <= kMaxSmem, "the configuration does not fit shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; in == false fills zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory, widened to fp32
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

// n fp32 values of shared memory (n a multiple of 4, 16-byte aligned)
template <int N>
__device__ __forceinline__ void load_f32(const float* p, float* out) {
#pragma unroll
  for (int i = 0; i < N; i += 4) load16(p + i, out + i);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// exp(m - mn), with a -inf max (an empty state) weighing exactly 0
__device__ __forceinline__ float weight(float m, float mn) {
  return m == -INFINITY ? 0.f : expf(m - mn);
}

// Split `split` of n_splits over the extent [lo, hi]: [s0, s1), empty when
// s0 == s1. Shares are ceil(len / n) rounded up to whole tiles; they cover
// [lo, hi] once, in order, and split 0 starts at lo. Same as ops.split_range.
__device__ __forceinline__ void split_range(int lo, int hi, int split, int n_splits,
                                            int& s0, int& s1) {
  const int len = hi - lo + 1;
  const int share = ((len + n_splits - 1) / n_splits + kTile - 1) / kTile * kTile;
  s1 = min(hi + 1, lo + (split + 1) * share);
  s0 = min(s1, lo + split * share);
}

// a byte run of the mask: fold its valid slots into (lo, hi, count)
__device__ __forceinline__ void scan_bytes(const uint8_t* row, int j0, int j1, int& lo,
                                           int& hi, int& cnt) {
  for (int j = j0 + static_cast<int>(threadIdx.x); j < j1; j += kThreads) {
    if (row[j]) {
      lo = min(lo, j);
      hi = max(hi, j);
      ++cnt;
    }
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const uint8_t* __restrict__ valid,
                    T* __restrict__ out, float* __restrict__ part,
                    float* __restrict__ lse, int Hkv, int S,
                    int valid_stride, float scale, int has_softcap, float softcap,
                    int n_splits) {
  using C = Cfg<T, D, G>;
  constexpr int DP = C::DP, EPL = C::EPL, NV = C::NV, RS = C::RS, NST = C::NST,
                KG = C::KG, HPW = C::HPW;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem + C::OFF_Q);
  float* sc = reinterpret_cast<float*>(smem + C::OFF_SC);
  float* pbuf = reinterpret_cast<float*>(smem + C::OFF_P);
  float* salpha = reinterpret_cast<float*>(smem + C::OFF_A);
  float* sm_m = salpha + G;
  float* sm_l = sm_m + G;
  int* stage_ts = reinterpret_cast<int*>(smem + C::OFF_I);
  int* red_i = stage_ts + NST;

  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");  // the combine
  const int split = blockIdx.x;
  const int bh = blockIdx.y;                   // b * Hkv + kv head
  const int b = bh / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const uint8_t* vrow = valid + static_cast<size_t>(b) * valid_stride;

  // q rows of the g heads that share this kv head, (b, hk*G + gi) = bh*G + gi
  const T* qbase = q + static_cast<size_t>(bh) * G * D;
  for (int t = tid; t < G * DP; t += kThreads) {
    const int gi = t / DP, c = t % DP;
    sq[t] = c < D ? to_float(qbase[gi * D + c]) : 0.f;
  }

  // the row's live extent: first and last valid slot, and how many are valid
  int lo = S, hi = -1, cnt = 0;
  const int head = min(S, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(vrow) & 15)) & 15));
  const int nvec = (S - head) / 16;
  scan_bytes(vrow, 0, head, lo, hi, cnt);
  const uint4* vv = reinterpret_cast<const uint4*>(vrow + head);
  for (int i = tid; i < nvec; i += kThreads) {
    const uint4 x = vv[i];
    const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t nz = 0;                         // bit e: byte e of the word is nonzero
#pragma unroll
      for (int e = 0; e < 4; ++e) nz |= ((w[j] >> (8 * e)) & 0xffu) ? (1u << e) : 0u;
      if (nz) {
        const int j0 = head + i * 16 + j * 4;
        lo = min(lo, j0 + __ffs(nz) - 1);
        hi = max(hi, j0 + 31 - __clz(nz));
        cnt += __popc(nz);
      }
    }
  }
  scan_bytes(vrow, head + nvec * 16, S, lo, hi, cnt);
  lo = __reduce_min_sync(kFull, lo);
  hi = __reduce_max_sync(kFull, hi);
  cnt = __reduce_add_sync(kFull, cnt);
  if (lane == 0) {
    red_i[warp] = lo;
    red_i[kWarps + warp] = hi;
    red_i[2 * kWarps + warp] = cnt;
  }
  __syncthreads();                             // also publishes sq
  lo = red_i[0];
  hi = red_i[kWarps];
  cnt = red_i[2 * kWarps];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) {
    lo = min(lo, red_i[w]);
    hi = max(hi, red_i[kWarps + w]);
    cnt += red_i[2 * kWarps + w];
  }
  const bool row_any = hi >= 0;
  if (!row_any) {                              // no valid slot: average v over all S
    lo = 0;
    hi = S - 1;
  }
  // dense: every slot of the extent is valid, or none of the row is; then no
  // tile is tested or skipped
  const bool dense = !row_any || cnt == hi - lo + 1;
  int s0, s1;
  split_range(lo, hi, split, n_splits, s0, s1);

  const size_t kv_base = static_cast<size_t>(bh) * S * D;
  const T* kb = k + kv_base;
  const T* vb = v + kv_base;
  int cursor = s0;
  // the start of the next tile of [s0, s1) that holds a valid slot, or -1;
  // uniform across the block (every warp reads the same mask bytes)
  auto next_tile = [&]() -> int {
    while (cursor < s1) {
      const int ts = cursor;
      cursor += kTile;
      if (dense) return ts;
      const int j = ts + lane;
      if (__any_sync(kFull, j < s1 && vrow[j] != 0)) return ts;
    }
    return -1;
  };
  const int vcol = tid % NV, kg = tid / NV;    // this thread's column vector and key group
  const bool col_in = vcol * EPL < D;          // false: a pad column, zeros
  // a tile's K rows, then its V rows, as two copy groups (empty ones for
  // ts < 0) so the scores can start before V lands; this thread copies
  // column vector vcol of rows kg, kg + KG, ... (rows past the share arrive
  // as zeros, and so do pad columns)
  auto issue = [&](int stage, int ts) {
    const uint32_t base = smem_u32(smem + stage * C::SB) + vcol * 16;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      if (ts >= 0) {
        const T* src = half ? vb : kb;
        for (int r = kg; r < kTile; r += KG) {
          const bool in = ts + r < s1 && col_in;
          const size_t off = in ? static_cast<size_t>(ts + r) * D + vcol * EPL
                                : static_cast<size_t>(ts) * D;
          cp_async16(base + (half * kTile + r) * RS, src + off, in);
        }
      }
      cp_async_commit();
    }
  };

  float m_r[HPW], l_r[HPW];                    // this warp's heads: warp + kWarps * i
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    m_r[i] = -INFINITY;
    l_r[i] = 0.f;
  }
  float acc[G][EPL];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[gi][e] = 0.f;

#pragma unroll
  for (int s = 0; s < NST - 1; ++s) {
    const int ts = next_tile();
    if (tid == 0) stage_ts[s] = ts;
    issue(s, ts);
  }
  for (int it = 0;; ++it) {
    {                                          // refill the stage consumed last round
      const int st = (it + NST - 1) % NST;
      const int ts = next_tile();
      if (tid == 0) stage_ts[st] = ts;
      issue(st, ts);
    }
    cp_async_wait<2 * NST - 1>();              // this thread's copies of tile `it`'s K
    __syncthreads();                           // everyone's
    const int st = it % NST;
    const int ts = stage_ts[st];
    if (ts < 0) break;                         // uniform: tiles come in order
    const unsigned char* kt = smem + st * C::SB;
    const unsigned char* vt = kt + kTile * RS;

    {  // partial scores: keys k0 + KB * j of this thread, column part sp
      const int k0 = tid % C::KB, sp = tid / C::KB;
      float dot[C::KPT][G];
#pragma unroll
      for (int j = 0; j < C::KPT; ++j)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) dot[j][gi] = 0.f;
#pragma unroll
      for (int i = 0; i < C::NVP; ++i) {
        const int c = sp * C::NVP + i;
        float kf[C::KPT][EPL];
#pragma unroll
        for (int j = 0; j < C::KPT; ++j)
          load16(reinterpret_cast<const T*>(kt + (k0 + C::KB * j) * RS + c * 16), kf[j]);
#pragma unroll
        for (int gi = 0; gi < G; ++gi) {
          float qf[EPL];
          load_f32<EPL>(sq + gi * DP + c * EPL, qf);  // a broadcast
#pragma unroll
          for (int j = 0; j < C::KPT; ++j)
#pragma unroll
            for (int e = 0; e < EPL; ++e) dot[j][gi] = fmaf(qf[e], kf[j][e], dot[j][gi]);
        }
      }
#pragma unroll
      for (int j = 0; j < C::KPT; ++j)
#pragma unroll
        for (int gi = 0; gi < G; ++gi) sc[(sp * G + gi) * kTile + k0 + C::KB * j] = dot[j][gi];
    }
    __syncthreads();

    // online softmax: one warp per head, lane = key; a warp's heads are
    // reduced side by side (their shuffles interleave)
    {
      float x[HPW], mt[HPW], ps[HPW];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int gi = warp + kWarps * i;
        x[i] = 0.f;                            // a head past G: computed, never stored
        if (gi < G) {
#pragma unroll
          for (int p = 0; p < C::SP; ++p) x[i] += sc[(p * G + gi) * kTile + lane];
          x[i] *= scale;
          if (has_softcap) x[i] = softcap * tanhf(x[i] / softcap);
          const int j = ts + lane;
          if (j >= s1) x[i] = -INFINITY;       // another split's slot: weight exactly 0
          else if (!row_any || (!dense && vrow[j] == 0)) x[i] = kNegInf;
        }
        mt[i] = x[i];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < HPW; ++i) mt[i] = fmaxf(mt[i], __shfl_xor_sync(kFull, mt[i], o));
      float alpha[HPW];
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const float m_new = fmaxf(m_r[i], mt[i]);  // finite: slot ts is in the share
        alpha[i] = weight(m_r[i], m_new);
        x[i] = expf(x[i] - m_new);
        ps[i] = x[i];
        m_r[i] = m_new;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < HPW; ++i) ps[i] += __shfl_xor_sync(kFull, ps[i], o);
#pragma unroll
      for (int i = 0; i < HPW; ++i) {
        const int gi = warp + kWarps * i;
        l_r[i] = l_r[i] * alpha[i] + ps[i];
        if (gi < G) {
          pbuf[lane * C::GP + gi] = x[i];
          if (lane == 0) salpha[gi] = alpha[i];
        }
      }
    }
    cp_async_wait<2 * NST - 2>();              // and V
    __syncthreads();

    // acc = acc * alpha + P.V over this thread's keys and column vector
#pragma unroll
    for (int gi = 0; gi < G; ++gi) {
      const float al = salpha[gi];
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[gi][e] *= al;
    }
#pragma unroll
    for (int i = 0; i < kTile / KG; ++i) {
      const int t = kg + KG * i;
      float vf[EPL], pf[C::GP];
      load16(reinterpret_cast<const T*>(vt + t * RS + vcol * 16), vf);
      load_f32<C::GP>(pbuf + t * C::GP, pf);
#pragma unroll
      for (int gi = 0; gi < G; ++gi)
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[gi][e] = fmaf(pf[gi], vf[e], acc[gi][e]);
    }
    __syncthreads();                           // stage st and pbuf free again
  }

  // merge the key groups (in the stage memory, no copy is in flight), then
  // write the head's output or this split's partial state
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int e = 0; e < EPL; ++e) red[(kg * G + gi) * DP + vcol * EPL + e] = acc[gi][e];
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int gi = warp + kWarps * i;
      if (gi < G) {
        sm_m[gi] = m_r[i];
        sm_l[gi] = l_r[i];
      }
    }
  }
  __syncthreads();
  for (int t = tid; t < G * D; t += kThreads) {
    const int gi = t / D, c = t % D;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < KG; ++j) a += red[(j * G + gi) * DP + c];
    const size_t hd = static_cast<size_t>(bh) * G + gi;   // b * H + h
    if (n_splits == 1) {
      out[hd * D + c] = from_f<T>(a / fmaxf(sm_l[gi], 1e-30f));
      if (lse != nullptr && c == 0) lse[hd] = sm_m[gi] + logf(sm_l[gi]);
    } else {
      float* p = part + (hd * n_splits + split) * (D + 2);
      if (c == 0) {
        p[0] = sm_m[gi];
        p[1] = sm_l[gi];
      }
      p[2 + c] = a;
    }
  }
}

// One block of kCombineThreads per (b, h): merge the splits, in about one
// L2 round trip. The threads, kCombineThreads / D ways per output column (the
// last kCombineThreads % D threads idle),
// first load their splits' accumulators (up to kPre each) into registers;
// meanwhile warp 0 finds the max over the splits (split 0's is finite), each
// split's weight exp(m_i - max) (0 for an empty split) and the merged l.
// Then each thread sums its weighted accumulators and the ways are added in
// shared memory. Launched as a programmatic dependent of the split kernel:
// its blocks start while the split kernel runs and wait for its results.
template <typename T>
__global__ void __launch_bounds__(kCombineThreads)
decode_combine_kernel(const float* __restrict__ part, T* __restrict__ out,
                      float* __restrict__ lse, int D, int n_splits) {
  constexpr int kPre = 8;
  extern __shared__ float sh[];                // weights (n_splits), then kCombineThreads
  __shared__ float s_l;
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const size_t head = blockIdx.x;
  const size_t stride = D + 2;
  const float* p = part + head * n_splits * stride;
  const int tid = threadIdx.x, lane = tid & 31;
  const int ways = kCombineThreads / D, c = tid % D, w = tid / D;
  const int mine = w < ways ? n_splits : 0;    // the splits this thread reads
  float v[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int i = w + j * ways;
    v[j] = i < mine ? p[i * stride + 2 + c] : 0.f;
  }
  if (tid < 32) {
    float ms[2], ls[2], mx = -INFINITY;        // the first 64 splits from registers
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = lane + 32 * j;
      ms[j] = i < n_splits ? p[i * stride] : -INFINITY;
      ls[j] = i < n_splits ? p[i * stride + 1] : 0.f;
      mx = fmaxf(mx, ms[j]);
    }
    for (int i = lane + 64; i < n_splits; i += 32) mx = fmaxf(mx, p[i * stride]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, o));
    float l = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int i = lane + 32 * j;
      if (i < n_splits) {
        const float wt = weight(ms[j], mx);
        sh[i] = wt;
        l = fmaf(ls[j], wt, l);
      }
    }
    for (int i = lane + 64; i < n_splits; i += 32) {
      const float wt = weight(p[i * stride], mx);
      sh[i] = wt;
      l = fmaf(p[i * stride + 1], wt, l);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(kFull, l, o);
    if (lane == 0) {
      s_l = l;
      if (lse != nullptr) lse[head] = mx + logf(l);
    }
  }
  __syncthreads();
  float aa = 0.f;
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int i = w + j * ways;
    if (i < mine) aa = fmaf(v[j], sh[i], aa);
  }
  for (int i = w + kPre * ways; i < mine; i += ways)
    aa = fmaf(p[i * stride + 2 + c], sh[i], aa);
  float* red = sh + n_splits;
  red[tid] = aa;
  __syncthreads();
  if (w == 0) {
    for (int j = 1; j < ways; ++j) aa += red[j * D + c];
    out[head * D + c] = from_f<T>(aa / fmaxf(s_l, 1e-30f));
  }
}

// cudaFuncSetAttribute(MaxDynamicSharedMemorySize) once per kernel and device
template <typename F>
cudaError_t allow_smem(F* kernel, int bytes, std::atomic<int> (&allowed)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && bytes <= allowed[dev].load())) return err;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) allowed[dev].store(bytes);
  return err;
}

template <typename T, int D, int G>
cudaError_t prepare() {
  static std::atomic<int> allowed[64];
  return allow_smem(decode_split_kernel<T, D, G>, Cfg<T, D, G>::BYTES, allowed);
}

struct Args {
  const void *q, *k, *v;
  const uint8_t* valid;
  void* out;
  float* part;
  float* lse;
  int B, H, Hkv, S, valid_stride;
  float scale;
  int has_softcap;
  float softcap;
  int n_splits;
  cudaStream_t stream;
};

template <typename T, int D, int G>
int launch(const Args& a) {
  cudaError_t err = prepare<T, D, G>();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(a.n_splits, a.B * a.Hkv);
  decode_split_kernel<T, D, G><<<grid, kThreads, Cfg<T, D, G>::BYTES, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.valid, static_cast<T*>(a.out), a.part, a.lse, a.Hkv, a.S, a.valid_stride, a.scale,
      a.has_softcap, a.softcap, a.n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.n_splits == 1) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.B * a.H);
  cfg.blockDim = dim3(kCombineThreads);
  cfg.dynamicSmemBytes = (a.n_splits + kCombineThreads) * sizeof(float);
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, decode_combine_kernel<T>, static_cast<const float*>(a.part),
                           static_cast<T*>(a.out), a.lse, static_cast<int>(D),
                           a.n_splits);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, int G>
int occupancy(int* blocks) {
  cudaError_t err = prepare<T, D, G>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, decode_split_kernel<T, D, G>, kThreads, Cfg<T, D, G>::BYTES);
  return static_cast<int>(err);
}

template <typename T_, int D_, int G_>
struct Tag {
  using T = T_;
  static constexpr int D = D_, G = G_;
};

// The (D, G) pairs with a compiled split kernel: every config's head dim and
// group (H/Hkv) and the shapes the tests hold. ops.SHAPES is the same list;
// a config that needs another pair adds it to both.
#define DECODE_SHAPES(X)                                                          \
  X(16, 2) X(32, 1) X(64, 1) X(64, 2) X(64, 3) X(64, 7) X(120, 4) X(120, 7)     \
  X(128, 1) X(128, 2) X(128, 8) X(256, 10)

template <typename T, typename F>
int with_shape(int D, int G, F&& f) {
#define DECODE_CASE(d, g) \
  if (D == d && G == g) return f(Tag<T, d, g>{});
  DECODE_SHAPES(DECODE_CASE)
#undef DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename F>
int with_config(int dtype, int D, int G, F&& f) {
  if (dtype == 0) return with_shape<float>(D, G, f);
  if (dtype == 1) return with_shape<__nv_bfloat16>(D, G, f);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q (B,H,D), k/v (B,Hkv,S,D), out like q, all
// contiguous and 16-byte aligned; valid uint8 with row stride valid_stride (0 for
// one (S,) row shared by the batch, S for (B,S)); part: n_splits > 1 only,
// B*H*n_splits*(D+2) floats of scratch; lse: null, or B*H floats that take each
// head's logsumexp of its scores. Each (b, kv head) row's live extent is cut
// into n_splits shares on the device. Returns cudaGetLastError() after the
// launches.
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v,
                                       const void* valid, void* out, void* part,
                                       void* lse, int B,
                                       int H, int Hkv, int S, int D, int dtype,
                                       int valid_stride, float scale, int has_softcap,
                                       float softcap, int n_splits, void* stream) {
  if (B <= 0 || H <= 0) return 0;
  if (Hkv <= 0 || H % Hkv != 0 || S <= 0 || n_splits <= 0 || n_splits > kMaxSplits ||
      (n_splits > 1 && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, k, v, static_cast<const uint8_t*>(valid), out, static_cast<float*>(part),
               static_cast<float*>(lse), B, H, Hkv, S, valid_stride, scale, has_softcap, softcap, n_splits,
               static_cast<cudaStream_t>(stream)};
  return with_config(dtype, D, H / Hkv, [&](auto tag) {
    using Tg = decltype(tag);
    return launch<typename Tg::T, Tg::D, Tg::G>(a);
  });
}

// Blocks of the split kernel that fit on one SM at (D, dtype, G), into
// *blocks; the host sizes n_splits with it. Returns a CUDA error code.
extern "C" int decode_attention_blocks_per_sm(int D, int dtype, int G, int* blocks) {
  return with_config(dtype, D, G, [&](auto tag) {
    using Tg = decltype(tag);
    return occupancy<typename Tg::T, Tg::D, Tg::G>(blocks);
  });
}
