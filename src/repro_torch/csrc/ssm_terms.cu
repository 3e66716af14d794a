// Recurrence inputs of the Mamba-1 selective scan for Hopper: from the dt_proj
// product's raw output, dt_bias, A_log, the post-conv activations x and the
// B slice of x_proj's product, the fp32 tensors
//   dt = softplus(raw + dt_bias)                    (B, S, di)
//   a  = exp(dt * (-exp(A_log)))                     (B, S, di, N)
//   b  = (dt * x) * B                                (B, S, di, N)
// that diag_recurrence then scans over S (models/ssm.py _selective_terms).
//
// Replaces no TPU kernel: the reference builds a and b in jnp
// (src/repro/models/ssm.py _selective_terms) and leaves the fusion to XLA.
// Eager PyTorch ran the same expression as about ten elementwise kernels, each
// writing an fp32 tensor that the next read back, a and b's (B, S, di, N)
// products among them.
//
// Bound on this card: bytes. An element costs one exp and two or three
// products against the 8 bytes of a and b written once; the inputs are 1/N of
// that (raw dt and x, (B, S, di)) or less (B, (B, S, N); A_log and dt_bias
// once a call). Design: one warp owns 32 adjacent channels and walks kRows
// rows (b, t) of the flattened batch and sequence. Each lane takes one
// channel's raw dt and x (coalesced loads of the row where the channels are
// adjacent; where x keeps the conv's (B, di, S) layout, a lane's sector holds
// its next rows, which L1 serves), computes dt and dt * x once, and the warp
// shares them by shuffles; the warp's 32 * N floats of a
// (and of b) in one row are contiguous, so each store instruction writes 32
// float4s of one contiguous 512-byte run. A lane always stores the same 4
// states, so it holds -exp(A_log) for its K = N/4 (channel, 4 states) pieces
// in registers from the start and B[t, its 4 states] a row; the next row's
// loads are issued before the current row is computed. No intermediate
// touches device memory. The stores are marked streaming (evict first): a
// call's 268 MB at falcon's chunk passes through the 50 MB L2 once. On one
// H100 the stores set the pace: without the exponentials the kernel takes as
// long, without the stores a third of it; 16 or 64 rows a block, 8 warps, rows
// strided over the grid and the plain stores were no faster (PERF.md §6).
//
// Numerics: the plain expression's, operation for operation in fp32 (expf,
// log1pf, PyTorch's softplus with threshold 20, products and the sum rounded
// alone, never fused), so it equals PyTorch's kernels of the plain version
// bit for bit wherever the two share expf's and log1pf's implementation (on
// the H100 they do: tests/test_torch_ssm_terms.py, chip_smoke.py phase 3).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;             // warps a block, one 32-channel tile each
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;             // rows (b, t) a block walks
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// PyTorch's softplus (beta 1, threshold 20): x above the threshold, else
// log1p(exp(x))
__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

struct Row {          // one row's inputs of a lane, in fp32
  float raw, x, bm[4];
};

struct Strides {      // elements, along (batch, sequence, channel or state)
  long long raw[3], x[3], bm[3];
};

template <typename T>
__device__ __forceinline__ void fetch(Row& v, const T* __restrict__ raw,
                                      const T* __restrict__ x, const T* __restrict__ bm,
                                      const Strides& st, int r, int S, int c, bool live,
                                      int q) {
  const long long bi = r / S, t = r - bi * S;
  v.raw = live ? load(raw + bi * st.raw[0] + t * st.raw[1] + c * st.raw[2]) : 0.f;
  v.x = live ? load(x + bi * st.x[0] + t * st.x[1] + c * st.x[2]) : 0.f;
  const T* brow = bm + bi * st.bm[0] + t * st.bm[1] + q * st.bm[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) v.bm[j] = load(brow + j * st.bm[2]);
}

// grid (ceil(rows / kRows), ceil(di / kThreads)); a, b (rows, di, N) fp32
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
ssm_terms_kernel(const T* __restrict__ raw, const float* __restrict__ dt_bias,
                 const float* __restrict__ a_log, const T* __restrict__ x,
                 const T* __restrict__ bm, float* __restrict__ a_out,
                 float* __restrict__ b_out, int rows, int S, int di, Strides st) {
  static_assert(N == 4 || N == 16, "the reduced and the published state size");
  constexpr int K = N / 4;            // float4 stores a lane makes per row and output
  constexpr int kPer = 128 / N;       // channels one store instruction covers
  const int lane = threadIdx.x & 31;
  const int c0 = (blockIdx.y * kWarps + (threadIdx.x >> 5)) * 32;
  if (c0 >= di) return;               // no block-wide barrier below
  const int q = (4 * lane) % N;       // the lane's first state, in every store
  const int sub = (4 * lane) / N;     // its channel within an instruction's kPer
  float A[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = c0 + k * kPer + sub;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      A[k][j] = c < di ? -expf(__ldg(a_log + static_cast<size_t>(c) * N + q + j)) : 0.f;
  }
  const int c = c0 + lane;
  const bool live = c < di;
  const float bias = live ? __ldg(dt_bias + c) : 0.f;
  const int r0 = blockIdx.x * kRows;
  const int r1 = min(rows, r0 + kRows);
  Row cur, nxt;
  fetch(cur, raw, x, bm, st, r0, S, c, live, q);
  for (int r = r0; r < r1; ++r) {
    if (r + 1 < r1)
      fetch(nxt, raw, x, bm, st, r + 1, S, c, live, q);
    const float dt = softplus(__fadd_rn(cur.raw, bias));
    const float dx = __fmul_rn(dt, cur.x);
    const size_t base = (static_cast<size_t>(r) * di + c0) * N + 4 * lane;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int src = k * kPer + sub;
      const float dtk = __shfl_sync(kFull, dt, src);
      const float dxk = __shfl_sync(kFull, dx, src);
      if (c0 + src < di) {
        const float4 av =
            make_float4(expf(__fmul_rn(dtk, A[k][0])), expf(__fmul_rn(dtk, A[k][1])),
                        expf(__fmul_rn(dtk, A[k][2])), expf(__fmul_rn(dtk, A[k][3])));
        const float4 bv = make_float4(__fmul_rn(dxk, cur.bm[0]), __fmul_rn(dxk, cur.bm[1]),
                                      __fmul_rn(dxk, cur.bm[2]), __fmul_rn(dxk, cur.bm[3]));
        __stcs(reinterpret_cast<float4*>(a_out + base + k * 128), av);
        __stcs(reinterpret_cast<float4*>(b_out + base + k * 128), bv);
      }
    }
    if (r + 1 < r1) cur = nxt;
  }
}

template <typename T, int N>
cudaError_t launch(const void* raw, const void* dt_bias, const void* a_log, const void* x,
                   const void* bm, void* a, void* b, int rows, int S, int di,
                   const Strides& st, cudaStream_t stream) {
  const dim3 grid((rows + kRows - 1) / kRows, (di + kThreads - 1) / kThreads);
  ssm_terms_kernel<T, N><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(raw), static_cast<const float*>(dt_bias),
      static_cast<const float*>(a_log), static_cast<const T*>(x), static_cast<const T*>(bm),
      static_cast<float*>(a), static_cast<float*>(b), rows, S, di, st);
  return cudaGetLastError();
}

template <typename T>
cudaError_t by_states(int n, const void* raw, const void* dt_bias, const void* a_log,
                      const void* x, const void* bm, void* a, void* b, int rows, int S,
                      int di, const Strides& st, cudaStream_t stream) {
  switch (n) {
    case 4: return launch<T, 4>(raw, dt_bias, a_log, x, bm, a, b, rows, S, di, st, stream);
    case 16: return launch<T, 16>(raw, dt_bias, a_log, x, bm, a, b, rows, S, di, st, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// raw, x (B, S, di) and bm (B, S, n) in `bf16` ? bfloat16 : float32, each
// with the strides given (elements; `strides` holds raw's three, x's, then
// bm's); dt_bias (di) and a_log (di, n) contiguous float32; a, b contiguous
// (B, S, di, n) float32, 16-byte aligned. n is 4 or 16.
extern "C" int ssm_terms_launch(const void* raw, const void* dt_bias, const void* a_log,
                                const void* x, const void* bm, void* a, void* b, int bf16,
                                int B, int S, int di, int n, const long long* strides,
                                void* stream) {
  if (B <= 0 || S <= 0 || di <= 0) return 0;
  const long long rows = static_cast<long long>(B) * S;
  if (rows > 0x7fffffffLL - kRows || (di + kThreads - 1) / kThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.raw[i] = strides[i];
    st.x[i] = strides[3 + i];
    st.bm[i] = strides[6 + i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      bf16 ? by_states<__nv_bfloat16>(n, raw, dt_bias, a_log, x, bm, a, b,
                                      static_cast<int>(rows), S, di, st, s)
           : by_states<float>(n, raw, dt_bias, a_log, x, bm, a, b, static_cast<int>(rows), S,
                              di, st, s);
  return static_cast<int>(err);
}
