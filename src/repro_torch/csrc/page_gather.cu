// Paged gather for Hopper: out[i, :] = pool[page_ids[i], :], bitwise.
//
// Replaces the TPU kernel src/repro/kernels/page_gather/kernel.py
// (page_gather_pallas / _gather_kernel). Pure data movement, so it is bound by
// device-memory bytes: each row is read once and written once, 2 * K * row_bytes
// in all. The design treats every row as raw bytes whatever its dtype and keeps
// loads wide and coalesced: block (k, c) reads page_ids[k] once into shared
// memory, then its threads copy 16 bytes each (uint4), neighbouring threads on
// neighbouring addresses, striding over the row by gridDim.y chunks. Rows whose
// source or destination is not 16-byte aligned, and the tail of a row whose
// length is not a multiple of 16, are copied byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr long long kChunk = 16LL * kThreads * kUnroll;   // bytes per block step

__global__ void __launch_bounds__(kThreads)
page_gather_kernel(const uint8_t* __restrict__ pool, const int32_t* __restrict__ ids,
                   uint8_t* __restrict__ out, long long row_bytes) {
  __shared__ long long src_row;
  const long long k = blockIdx.x;
  if (threadIdx.x == 0) src_row = static_cast<long long>(ids[k]);
  __syncthreads();
  const uint8_t* src = pool + src_row * row_bytes;
  uint8_t* dst = out + k * row_bytes;

  const bool aligned =
      ((reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const long long vec_bytes = aligned ? (row_bytes & ~15LL) : 0;
  const uint4* s4 = reinterpret_cast<const uint4*>(src);
  uint4* d4 = reinterpret_cast<uint4*>(dst);
  const long long n4 = vec_bytes >> 4;

  for (long long base = blockIdx.y * (kChunk >> 4); base < n4;
       base += static_cast<long long>(gridDim.y) * (kChunk >> 4)) {
    uint4 r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i < n4) r[u] = s4[i];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * kThreads + threadIdx.x;
      if (i < n4) d4[i] = r[u];
    }
  }
  // byte tail (or the whole row when a pointer is misaligned)
  for (long long i = vec_bytes + blockIdx.y * kThreads + threadIdx.x; i < row_bytes;
       i += static_cast<long long>(gridDim.y) * kThreads) {
    dst[i] = src[i];
  }
}

}  // namespace

extern "C" int page_gather_launch(const void* pool, const void* ids, void* out,
                                  long long n_ids, long long row_bytes, void* stream) {
  if (n_ids <= 0 || row_bytes <= 0) return 0;
  long long chunks = (row_bytes + kChunk - 1) / kChunk;
  if (chunks > 65535) chunks = 65535;
  dim3 grid(static_cast<unsigned>(n_ids), static_cast<unsigned>(chunks));
  page_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(pool), static_cast<const int32_t*>(ids),
      static_cast<uint8_t*>(out), row_bytes);
  return static_cast<int>(cudaGetLastError());
}
