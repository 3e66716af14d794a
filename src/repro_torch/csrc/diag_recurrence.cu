// Diagonal linear recurrence for Hopper: h_t = a_t * h_{t-1} + b_t, elementwise
// over channels, fp32.
//
// Replaces the TPU kernel src/repro/kernels/diag_recurrence/kernel.py
// (diag_recurrence_pallas / _recurrence_kernel) and computes what its oracle
// diag_recurrence_ref computes: a, b (B, S, C) and h0 (B, C) in, h_all (B, S, C)
// and h_final (B, C) = h_all[:, S-1] out. Ragged channel counts are handled by
// a bounds check instead of the Pallas padding (a=1, b=0). Each step rounds the
// product and the sum separately (no fused multiply-add), as PyTorch's
// elementwise a * h + b does, so the kernel equals its plain version bit for bit.
//
// Bound on this card: bytes. The work is one multiply and one add per element
// against 12 bytes moved (a and b read once, h_all written once), far below the
// ~20 flops per byte where fp32 CUDA cores would be the limit.
//
// Two routes, chosen on the host (ops.plan_recurrence):
// - sequential: one thread per (b, channel), 64 threads a block, blockIdx.y =
//   b; the TPU's sequential chunk grid axis becomes a loop over s inside the
//   thread. Neighbouring threads hold neighbouring channels, so each row's
//   loads and stores are coalesced (128 bytes a warp). The loads do not
//   depend on h, so they are issued U rows at a time and the next U rows are
//   requested before the current ones are folded into h: 2U rows of a and b
//   are in flight per thread while the dependent chain runs. h_all is written
//   once, h_final once. Bitwise equal to the plain version.
// - chunked, for shapes whose B*C threads cannot fill the card
//   (recurrentgemma's 2,560 channels would be 40 blocks of 64): the sequence
//   is cut into n_chunks chunks of L rows (a multiple of U) and each (b,
//   channel, chunk) gets a thread, in two launches. The summary pass folds
//   each chunk but the last from zero into its local end state H_k and its
//   product A_k of a, into an fp32 scratch (2, B, n_chunks, C). The apply
//   pass composes a chunk's carry-in from h0 over the earlier chunks (carry =
//   A_j*carry + H_j, from L2), then runs the chunk from it, writing h_all,
//   and the last chunk writes h_final; it takes the chunks last first, so
//   the a and b the summary read last are read again while still in L2. It moves 20 bytes per element against the bound's
//   12 (a and b are read twice; the second read may come from the 50 MB L2),
//   and differs from the plain version only through the composed carry, as
//   the reference's own chunked scan does. A product of a that underflows
//   to 0 is exact and stays finite.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;         // sequential route
constexpr int kChunkThreads = 128;   // chunked route
constexpr int U = 8;                 // rows per load group

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

// Run h = a*h + b over n rows from `base`, `stride` apart, U rows loaded
// ahead of the dependent chain; kStore writes each h to h_all, kProd also
// folds the product of a into prod. Returns the last h.
template <bool kStore, bool kProd>
__device__ __forceinline__ float walk(const float* __restrict__ a,
                                      const float* __restrict__ b,
                                      float* __restrict__ h_all, size_t base,
                                      size_t stride, int n, float h, float& prod) {
  const int full = (n / U) * U;
  float ac[U], bc[U];
  if (full > 0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ac[u] = __ldg(a + base + u * stride);
      bc[u] = __ldg(b + base + u * stride);
    }
  }
  for (int s = 0; s < full; s += U) {
    float an[U], bn[U];
    const bool more = s + U < full;
    if (more) {                        // next group in flight during this one's chain
      const size_t off = base + static_cast<size_t>(s + U) * stride;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        an[u] = __ldg(a + off + u * stride);
        bn[u] = __ldg(b + off + u * stride);
      }
    }
    const size_t off = base + static_cast<size_t>(s) * stride;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      h = step(ac[u], h, bc[u]);
      if (kStore) h_all[off + u * stride] = h;
      if (kProd) prod = __fmul_rn(prod, ac[u]);
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ac[u] = an[u];
        bc[u] = bn[u];
      }
    }
  }
  for (int s = full; s < n; ++s) {     // ragged tail
    const size_t off = base + static_cast<size_t>(s) * stride;
    const float as = __ldg(a + off);
    h = step(as, h, __ldg(b + off));
    if (kStore) h_all[off] = h;
    if (kProd) prod = __fmul_rn(prod, as);
  }
  return h;
}

__global__ void __launch_bounds__(kThreads)
diag_recurrence_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h_all,
                       float* __restrict__ h_final, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bi = blockIdx.y;
  float unused = 1.f;
  h_final[bi * C + c] = walk<true, false>(a, b, h_all, bi * static_cast<size_t>(S) * C + c,
                                          static_cast<size_t>(C), S, h0[bi * C + c], unused);
}

// grid (ceil(C / kChunkThreads), n_chunks - 1, B): the last chunk's summary
// is never composed. scratch: prod (B, n_chunks, C) then state (B, n_chunks, C)
__global__ void __launch_bounds__(kChunkThreads)
chunk_summary_kernel(const float* __restrict__ a, const float* __restrict__ b,
                     float* __restrict__ prod, float* __restrict__ state, int S, int C,
                     int L) {
  const int c = blockIdx.x * kChunkThreads + threadIdx.x;
  if (c >= C) return;
  const int kc = blockIdx.y, nch = gridDim.y + 1;
  const size_t bi = blockIdx.z;
  const int r0 = kc * L;
  float p = 1.f;
  const float h = walk<false, true>(a, b, nullptr,
                                    (bi * S + r0) * static_cast<size_t>(C) + c,
                                    static_cast<size_t>(C), min(L, S - r0), 0.f, p);
  const size_t o = (bi * nch + kc) * static_cast<size_t>(C) + c;
  prod[o] = p;
  state[o] = h;
}

__global__ void __launch_bounds__(kChunkThreads)
chunk_apply_kernel(const float* __restrict__ a, const float* __restrict__ b,
                   const float* __restrict__ h0, const float* __restrict__ prod,
                   const float* __restrict__ state, float* __restrict__ h_all,
                   float* __restrict__ h_final, int S, int C, int L) {
  const int c = blockIdx.x * kChunkThreads + threadIdx.x;
  if (c >= C) return;
  // the last chunks first: their a and b were the summary pass's last reads,
  // the likeliest to be still in L2
  const int nch = gridDim.y, kc = nch - 1 - blockIdx.y;
  const size_t bi = blockIdx.z;
  float carry = h0[bi * C + c];
  const size_t s0 = bi * nch * static_cast<size_t>(C) + c;
#pragma unroll 8
  for (int j = 0; j < kc; ++j) {       // carry-in: the earlier chunks, in order
    const size_t o = s0 + static_cast<size_t>(j) * C;
    carry = step(__ldg(prod + o), carry, __ldg(state + o));
  }
  const int r0 = kc * L;
  float unused = 1.f;
  const float h = walk<true, false>(a, b, h_all, (bi * S + r0) * static_cast<size_t>(C) + c,
                                    static_cast<size_t>(C), min(L, S - r0), carry, unused);
  if (kc == nch - 1) h_final[bi * C + c] = h;
}

}  // namespace

// a, b, h_all (B, S, C) and h0, h_final (B, C): float32, contiguous. S >= 1.
// chunk == 0 takes the sequential route; chunk > 0 the chunked route with
// chunks of `chunk` rows, scratch holding 2 * B * ceil(S / chunk) * C floats.
// Returns cudaGetLastError() after the launches.
extern "C" int diag_recurrence_launch(const void* a, const void* b, const void* h0,
                                      void* h_all, void* h_final, void* scratch, int B,
                                      int S, int C, int chunk, void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (S <= 0 || B > 65535 || chunk < 0 || (chunk > 0 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* hf = static_cast<const float*>(h0);
  if (chunk == 0) {
    dim3 grid((C + kThreads - 1) / kThreads, B);
    diag_recurrence_kernel<<<grid, kThreads, 0, st>>>(af, bf, hf, static_cast<float*>(h_all),
                                                      static_cast<float*>(h_final), S, C);
    return static_cast<int>(cudaGetLastError());
  }
  const int nch = (S + chunk - 1) / chunk;
  if (nch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  float* prod = static_cast<float*>(scratch);
  float* state = prod + static_cast<size_t>(B) * nch * C;
  dim3 grid((C + kChunkThreads - 1) / kChunkThreads, nch, B);
  if (nch > 1) {
    dim3 summary_grid(grid.x, nch - 1, B);
    chunk_summary_kernel<<<summary_grid, kChunkThreads, 0, st>>>(af, bf, prod, state, S, C,
                                                                 chunk);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  chunk_apply_kernel<<<grid, kChunkThreads, 0, st>>>(af, bf, hf, prod, state,
                                                     static_cast<float*>(h_all),
                                                     static_cast<float*>(h_final), S, C,
                                                     chunk);
  return static_cast<int>(cudaGetLastError());
}
