// Paged gather for Hopper: out[i, :] = pool[page_ids[i], :], bitwise.
//
// Replaces the TPU kernel src/repro/kernels/page_gather/kernel.py
// (page_gather_pallas / _gather_kernel). Pure data movement, so it is bound by
// device-memory bytes: each row is read once and written once, 2 * K * row_bytes
// in all, whatever the dtype (rows are raw bytes). A short host page list (the
// page server's) travels in the launch parameters, so a call costs no pinned
// copy and no host-to-device transfer.
//
// Design: a persistent grid (a small multiple of the SM count, from the
// wrapper's plan) walks work items: item = (row i, chunk c) covers bytes
// [c * chunk, min((c + 1) * chunk, row_bytes)) of row i, and block b takes items
// b, b + gridDim.x, ... Lane 0 of warp 0 runs a ring of `stages` shared-memory
// buffers: cp.async.bulk global -> shared completing on an mbarrier
// (complete_tx), then cp.async.bulk shared -> global in a bulk group, so each SM
// always has reads and writes in flight and no thread holds the data in
// registers. A stage is reloaded once the store that read it has finished
// reading (wait_group.read). An item's page id is read with __ldg; no
// __syncthreads is spent on it. A bulk copy needs 16-byte aligned addresses and a
// multiple of 16 bytes: an item whose source or destination is misaligned, and
// the byte tail of a row whose length is not a multiple of 16, are copied byte by
// byte by warps 1..3 of the block, beside the bulk pipeline.
#include <cuda_runtime.h>

#include <atomic>
#include <cstring>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;        // warp 0: bulk pipeline; warps 1-3: byte path
constexpr int kMaxStages = 8;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Where the page ids come from: a device array (read with __ldg), or the
// launch's own parameters, for a short host page list (no host-to-device copy;
// __grid_constant__ lets the kernel index the parameter in place). 960 ids keep
// all parameters inside the classic 4 KB launch limit.
constexpr int kInlineIds = 960;
struct DeviceIds {
  const int32_t* p;
  __device__ __forceinline__ int32_t operator[](long long i) const { return __ldg(p + i); }
};
struct InlineIds {
  int32_t v[kInlineIds];
  __device__ __forceinline__ int32_t operator[](long long i) const { return v[i]; }
};

struct Item {
  const uint8_t* src;
  uint8_t* dst;
  long long bytes;                   // the item's length
  long long bulk;                    // bytes [0, bulk) go through the bulk copy
};

template <typename Ids>
__device__ __forceinline__ Item item_at(const uint8_t* pool, const Ids& ids, uint8_t* out,
                                        long long row_bytes, long long chunk,
                                        long long n_chunks, long long it) {
  const long long row = it / n_chunks;
  const long long start = (it - row * n_chunks) * chunk;
  Item m;
  m.src = pool + static_cast<long long>(ids[row]) * row_bytes + start;
  m.dst = out + row * row_bytes + start;
  m.bytes = min(chunk, row_bytes - start);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(m.src) | reinterpret_cast<uintptr_t>(m.dst)) & 15) == 0;
  m.bulk = aligned ? (m.bytes & ~15LL) : 0;
  return m;
}

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

// global -> shared, `bytes` (a multiple of 16 below 2^20) counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  mbar_expect_tx(bar, bytes);
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
}

template <typename Ids>
__global__ void __launch_bounds__(kThreads)
page_gather_kernel(const uint8_t* __restrict__ pool, uint8_t* __restrict__ out,
                   long long row_bytes, long long chunk, long long n_chunks,
                   long long n_items, int stages, const __grid_constant__ Ids ids) {
  extern __shared__ __align__(128) uint8_t stage_buf[];
  __shared__ __align__(8) uint64_t bars[kMaxStages];
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long n_mine = first < n_items ? (n_items - 1 - first) / stride + 1 : 0;

  if (threadIdx.x == 0) {
    const uint32_t buf = smem_u32(stage_buf);
    const uint32_t bar0 = smem_u32(bars);
    for (int s = 0; s < stages; ++s) mbar_init(bar0 + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

    auto load = [&](long long i) {               // the block's i-th item into its stage
      const int s = static_cast<int>(i % stages);
      const Item m = item_at(pool, ids, out, row_bytes, chunk, n_chunks, first + i * stride);
      if (m.bulk > 0)
        bulk_load(buf + s * chunk, m.src, static_cast<uint32_t>(m.bulk), bar0 + 8 * s);
      else
        mbar_arrive(bar0 + 8 * s);               // nothing to move: complete the phase
    };
    for (long long i = 0; i < n_mine && i < stages; ++i) load(i);
    for (long long i = 0; i < n_mine; ++i) {
      const int s = static_cast<int>(i % stages);
      mbar_wait(bar0 + 8 * s, static_cast<uint32_t>((i / stages) & 1));
      const Item m = item_at(pool, ids, out, row_bytes, chunk, n_chunks, first + i * stride);
      if (m.bulk > 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        bulk_store(m.dst, buf + s * chunk, static_cast<uint32_t>(m.bulk));
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (i >= 1 && i - 1 + stages < n_mine) {
        // the store of item i-1 has read its stage: refill it
        asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
        load(i - 1 + stages);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  } else if (threadIdx.x >= 32) {
    // byte path: misaligned items whole, and the tail of each aligned item
    const int t = threadIdx.x - 32;
    constexpr int kByteThreads = kThreads - 32;
    for (long long i = 0; i < n_mine; ++i) {
      const Item m = item_at(pool, ids, out, row_bytes, chunk, n_chunks, first + i * stride);
      for (long long j = m.bulk + t; j < m.bytes; j += kByteThreads) m.dst[j] = m.src[j];
    }
  }
}

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

template <typename Ids>
int launch(const void* pool, void* out, long long n_ids, long long row_bytes,
           long long chunk, long long n_chunks, int grid, int stages, const Ids& ids,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(stages) * chunk;
  static std::atomic<int> allowed[64];
  cudaError_t err = allow_smem(page_gather_kernel<Ids>, static_cast<int>(smem), allowed);
  if (err != cudaSuccess) return static_cast<int>(err);
  page_gather_kernel<Ids><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(pool), static_cast<uint8_t*>(out), row_bytes, chunk,
      n_chunks, n_ids * n_chunks, stages, ids);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The ids are int32 (K,): on the device (`ids`), or, for at most
// page_gather_inline_ids() of them, in host memory (`host_ids`, with `ids` null),
// copied into the launch's parameters. pool (P, row_bytes) and out (K, row_bytes)
// are raw bytes. chunk (a multiple of 16, at most 2^20 - 16), n_chunks, grid and
// stages (2 to 8: an item's stage is refilled one item after its store) come
// from the wrapper's plan; the kernel takes stages * chunk bytes of dynamic
// shared memory. Returns cudaGetLastError() after the launch.
extern "C" int page_gather_inline_ids() { return kInlineIds; }

extern "C" int page_gather_launch(const void* pool, const void* ids, const void* host_ids,
                                  void* out, long long n_ids, long long row_bytes,
                                  long long chunk, long long n_chunks, int grid, int stages,
                                  void* stream) {
  if (n_ids <= 0 || row_bytes <= 0) return 0;
  if (chunk <= 0 || chunk % 16 || chunk >= (1LL << 20) || n_chunks * chunk < row_bytes ||
      stages < 2 || stages > kMaxStages || grid < 1 ||
      (ids == nullptr) == (host_ids == nullptr) || (ids == nullptr && n_ids > kInlineIds))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ids != nullptr)
    return launch(pool, out, n_ids, row_bytes, chunk, n_chunks, grid, stages,
                  DeviceIds{static_cast<const int32_t*>(ids)}, st);
  InlineIds inl;
  memcpy(inl.v, host_ids, static_cast<size_t>(n_ids) * sizeof(int32_t));
  return launch(pool, out, n_ids, row_bytes, chunk, n_chunks, grid, stages, inl, st);
}
