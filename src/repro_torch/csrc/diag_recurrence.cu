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
// Design: one thread per (b, channel), 64 threads a block, blockIdx.y = b; the
// TPU's sequential chunk grid axis becomes a loop over s inside the thread.
// Neighbouring threads hold neighbouring channels, so each row's loads and
// stores are coalesced (128 bytes a warp). The loads do not depend on h, so
// they are issued U rows at a time and the next U rows are requested before
// the current ones are folded into h: 2U rows of a and b are in flight per
// thread while the dependent chain runs. h_all is written once, h_final once.
// At small B*C (recurrentgemma's 2,560 channels give 40 blocks) the grid
// cannot fill 132 SMs and each thread waits on memory latency S/U times: a
// chunk-parallel scan along S is the redesign for that shape.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int U = 8;       // rows per load group

__device__ __forceinline__ float step(float a, float h, float b) {
  return __fadd_rn(__fmul_rn(a, h), b);
}

__global__ void __launch_bounds__(kThreads)
diag_recurrence_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ h0, float* __restrict__ h_all,
                       float* __restrict__ h_final, int S, int C) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= C) return;
  const size_t bi = blockIdx.y;
  const size_t base = bi * static_cast<size_t>(S) * C + c;
  const size_t stride = static_cast<size_t>(C);
  float h = h0[bi * C + c];

  const int full = (S / U) * U;
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
      h_all[off + u * stride] = h;
    }
    if (more) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        ac[u] = an[u];
        bc[u] = bn[u];
      }
    }
  }
  for (int s = full; s < S; ++s) {     // ragged tail of the sequence
    const size_t off = base + static_cast<size_t>(s) * stride;
    h = step(__ldg(a + off), h, __ldg(b + off));
    h_all[off] = h;
  }
  h_final[bi * C + c] = h;
}

}  // namespace

// a, b, h_all (B, S, C) and h0, h_final (B, C): float32, contiguous. S >= 1.
// Returns cudaGetLastError() after the launch.
extern "C" int diag_recurrence_launch(const void* a, const void* b, const void* h0,
                                      void* h_all, void* h_final, int B, int S, int C,
                                      void* stream) {
  if (B <= 0 || C <= 0) return 0;
  if (S <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((C + kThreads - 1) / kThreads, B);
  diag_recurrence_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h_all),
      static_cast<float*>(h_final), S, C);
  return static_cast<int>(cudaGetLastError());
}
