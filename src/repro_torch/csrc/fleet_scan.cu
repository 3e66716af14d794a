// The fleet_vec cap=1 group recursion for Hopper, over every group at once.
//
// Has no TPU kernel counterpart: the reference runs it as a jitted
// jax.lax.scan under enable_x64 (src/repro/core/fleet_vec.py, _get_scan_fn /
// _solve_group_scan), one device dispatch per (worker, fn) group. Here a CSR
// batch of all groups: float64 arrivals concatenated group after group, and
// int64 offsets (group g owns [offsets[g], offsets[g + 1])).
//
// A cap=1 group is a Lindley recursion on a single rotating instance; the
// carry (alive, free, exp) starts at (false, 0.0, 0.0) and each arrival t does
//   alive2 = alive && exp >= t;   queued = alive2 && free > t
//   start  = queued ? free : t;   (svc, svc60) = alive2 ? (warm_s, wm) : (cold_s, cold60)
//   wait   = (start - t) * 60.0;  sample = wait + svc
//   free2  = start + svc60;       exp2 = free2 + ka
// The contract is bit identity with the numpy and lax.scan solvers, so every
// float64 operation is written as a round-to-nearest intrinsic (__dsub_rn,
// __dmul_rn, __dadd_rn): nvcc would otherwise contract (start - t) * 60.0 + svc
// into one DFMA and change the last bit. The comparisons are exactly
// exp >= t and free > t.
//
// Bounds on this card: the bytes, 8 read and 8 * 4 + 2 written per arrival
// (42 B against HBM), and a serial chain of dependent float64 steps. One thread
// per group (the earlier design) made that chain the longest group's, 1.77 M
// steps on azure_scale_xl. This design cuts it to the longest segment's:
//
// Why carries merge. After a group's first arrival alive is true, and exp is
// always free + ka, so the whole carry is the bits of free. Two runs of the
// recursion over the same arrivals, from different carries, whose free2 agree
// bitwise after some arrival agree bitwise on every output after it. And an
// arrival that does not queue sets free2 = t + svc60 whatever the old free
// was, so two runs merge at the first arrival that neither queues behind
// (where both find the instance warm), usually within a few arrivals.
//
// Pass 1 (fleet_scan_segments): each group is cut into segments of at most
// `segment` arrivals; one thread runs one segment. The wrapper counts each
// group's segments (their prefix, seg_first); a thread finds its group by a
// binary search there and writes its row of the segment table for pass 2.
// A group's first segment, and any segment whose warm-up would reach back
// past its group's start, starts from the true carry at the group's start. Every other segment
// guesses the carry before its `warmup` warm-up arrivals (the arrival before
// them warm and not queued: free = t + wm), runs the warm-up without writing,
// then runs and writes its own arrivals. It records the free it entered its
// segment with, and the free it left with.
//   Staging: each thread keeps a ring of two tiles of kChunk arrivals in
// shared memory. Its arrivals come in by cp.async.bulk on the tile's own
// mbarrier (complete_tx), two tiles ahead of the chain; its six outputs go
// out from shared memory by cp.async.bulk stores (bulk groups, one a tile), so
// every transfer is one contiguous run instead of scattered 8-byte and 1-byte
// accesses. Tiles sit on global multiples of kChunk, so only a segment's
// first and last tile are ragged: a bulk copy needs 16-byte aligned addresses
// and sizes, and the float64 head or tail element, and the uint8 outputs' head
// and tail bytes, go through ordinary loads and stores.
//
// Pass 2 (fleet_scan_repair), in rounds. Round 0 checks every boundary inside
// a group: if the left segment's exit free differs bitwise from the right
// segment's entry free, the right segment reruns from the left's exit carry,
// rewrites its outputs, and stops at the first arrival whose free2 equals,
// bitwise, the free2 of the run it replaces (start + svc60, recomputed from
// the stored start and cold flag): from there on the stored outputs are right.
// A rerun that reaches its segment's end without merging changes that
// segment's exit free, and so the next boundary's check. Each round reads a
// snapshot of the exit frees taken before it (two buffers, swapped), each
// thread writes only its own segment, and a later round checks only the
// boundaries whose left exit changed in the round before. Round r leaves the
// first r + 2 segments of every group right, so the rounds end within the
// longest group's segment count; a group queued throughout (no merge at all)
// degrades to a serial rerun, one more segment made right a round (the ones
// after it rerun beside it from carries still wrong), and is never wrong. This
// design was chosen over one kernel with decoupled look-back: a round is a
// plain launch with no inter-block waiting, and its result does not depend on
// the order blocks run in. The common case is one round that rewrites
// nothing. A round whose predecessor changed nothing returns at once, so the
// wrapper queues rounds in batches (one C call launches a batch) and reads a
// batch's flags with one copy.
//
// The floor is now the longest segment's chain, segment + warmup steps, not
// the longest group's; the bytes bound stays 42 B an arrival.
#include <cuda_runtime.h>

#include <atomic>
#include <stdint.h>

namespace {

// pass 1's layout (trial builds of 32 x 64, 128 x 16 and 16 x 128 were no
// faster on azure_scale_xl's batch)
constexpr int kThreads = 64;                   // pass 1: segments per block
constexpr int kChunk = 32;                     // arrivals per tile
constexpr int kStages = 2;                     // tiles in each thread's ring
// a thread's float64 tile, padded by 16 bytes so that the threads of a warp
// reading their own tiles at one index do not all hit one bank
constexpr int kF64Stride = kChunk * 8 + 16;
constexpr int kU8Stride = kChunk + 16;
constexpr int kStageBytes = kThreads * (5 * kF64Stride + 2 * kU8Stride);
constexpr int kSmemBytes = kStages * kStageBytes;
// pass 2: segments per block. Each rerun's loads and stores touch lines of
// their own (its segment's), so a warp's access costs one line a thread: few
// threads a block spread a round's reruns over many SMs
constexpr int kRepairThreads = 8;
constexpr int kAhead = 16;                     // arrivals a rerun loads ahead
static_assert(kChunk % 16 == 0 && kChunk >= 16, "tiles must hold whole 16-byte runs");

struct Consts {
  double warm_s, cold_s, wm, cold60, ka;
};

struct Outs {
  double* sample;
  double* wait;
  double* start;
  double* exp2;
  uint8_t* cold;
  uint8_t* queued;
};

struct Carry {
  bool alive;
  double free_t;
  double exp_t;
};

struct Step {
  double sample, wait, start, exp2;
  bool cold, queued;
};

// one arrival of the recursion; every float64 operation rounded on its own
__device__ __forceinline__ Step step(Carry& c, double ti, const Consts& k) {
  const bool alive2 = c.alive && (c.exp_t >= ti);
  const bool q = alive2 && (c.free_t > ti);
  Step s;
  s.start = q ? c.free_t : ti;
  const double svc = alive2 ? k.warm_s : k.cold_s;
  const double svc60 = alive2 ? k.wm : k.cold60;
  s.wait = __dmul_rn(__dsub_rn(s.start, ti), 60.0);
  s.sample = __dadd_rn(s.wait, svc);
  const double f2 = __dadd_rn(s.start, svc60);
  s.exp2 = __dadd_rn(f2, k.ka);
  s.cold = !alive2;
  s.queued = q;
  c.alive = true;
  c.free_t = f2;
  c.exp_t = s.exp2;
  return s;
}

__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
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
// global -> shared, `bytes` (a multiple of 16) counted on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
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
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// [a, b) of one tile, and its part [lo, hi) that a bulk copy of elements
// aligned to `align` takes; the rest are the tile's ragged edges
struct Span {
  long long a, b, lo, hi;
};
__device__ __forceinline__ Span span(long long a, long long b, long long align) {
  Span s{a, b, 0, 0};
  s.lo = min((a + align - 1) / align * align, b);
  s.hi = max(s.lo, b / align * align);
  return s;
}

__global__ void __launch_bounds__(kThreads)
fleet_scan_segments(const double* __restrict__ t, const long long* __restrict__ offsets,
                    const long long* __restrict__ seg_first, long long n_groups,
                    long long segment, long long n_seg, int warmup, Consts k, Outs o,
                    long long* __restrict__ seg_lo, long long* __restrict__ seg_glo,
                    double* __restrict__ entry, double* __restrict__ exit_free) {
  extern __shared__ __align__(128) uint8_t smem[];
  __shared__ __align__(8) uint64_t bars[kStages][kThreads];
  const int tid = threadIdx.x;
  const long long j = static_cast<long long>(blockIdx.x) * kThreads + tid;
  if (j >= n_seg) return;
  // the group of segment j: the last g with seg_first[g] <= j (empty groups
  // own no segment and share their successor's seg_first)
  long long g = 0;
  for (long long top = n_groups - 1; g < top;) {
    const long long m = (g + top + 1) / 2;
    if (__ldg(seg_first + m) <= j) g = m; else top = m - 1;
  }
  const long long glo = __ldg(offsets + g);
  const long long lo = glo + (j - __ldg(seg_first + g)) * segment;
  const long long hi = min(lo + segment, __ldg(offsets + g + 1));
  seg_lo[j] = lo;                                       // the table pass 2 reads
  seg_glo[j] = glo;
  if (j == n_seg - 1) seg_lo[n_seg] = hi;
  const long long first = lo / kChunk;                  // the tile holding lo
  const long long n_tiles = (hi + kChunk - 1) / kChunk - first;

  auto in_tile = [&](int s) {
    return reinterpret_cast<double*>(smem + s * kStageBytes + tid * kF64Stride);
  };
  auto out_f64 = [&](int s, int a) {                    // sample, wait, start, exp2
    return reinterpret_cast<double*>(smem + s * kStageBytes +
                                     (1 + a) * kThreads * kF64Stride + tid * kF64Stride);
  };
  auto out_u8 = [&](int s, int a) {                     // cold, queued
    return smem + s * kStageBytes + 5 * kThreads * kF64Stride + a * kThreads * kU8Stride +
           tid * kU8Stride;
  };
  uint32_t bar[kStages];
  for (int s = 0; s < kStages; ++s) {
    bar[s] = smem_u32(&bars[s][tid]);
    mbar_init(bar[s]);
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");

  auto load = [&](long long c) {                        // tile c into its stage
    const int s = static_cast<int>(c % kStages);
    const long long base = (first + c) * kChunk;
    const Span f = span(max(lo, base), min(hi, base + kChunk), 2);
    if (f.hi > f.lo)
      bulk_load(smem_u32(in_tile(s) + (f.lo - base)), t + f.lo,
                static_cast<uint32_t>((f.hi - f.lo) * 8), bar[s]);
    else
      mbar_arrive(bar[s]);                              // nothing to move: complete the phase
  };
  for (long long c = 0; c < n_tiles && c < kStages; ++c) load(c);

  // the carry the segment starts from: true at the group's start, else guessed
  Carry cy{false, 0.0, 0.0};
  long long w0 = lo - warmup;
  if (w0 - 1 >= glo) {
    cy.alive = true;                                    // arrival w0 - 1 warm, not queued
    cy.free_t = __dadd_rn(__ldg(t + w0 - 1), k.wm);
    cy.exp_t = __dadd_rn(cy.free_t, k.ka);
  } else {
    w0 = glo;
  }
  for (long long i = w0; i < lo; ++i) step(cy, __ldg(t + i), k);
  if (lo > glo) entry[j] = cy.free_t;

  for (long long c = 0; c < n_tiles; ++c) {
    const int s = static_cast<int>(c % kStages);
    const long long base = (first + c) * kChunk;
    const Span f = span(max(lo, base), min(hi, base + kChunk), 2);
    const Span u = span(f.a, f.b, 16);
    mbar_wait(bar[s], static_cast<uint32_t>((c / kStages) & 1));
    double* in = in_tile(s);
    for (long long i = f.a; i < f.lo; ++i) in[i - base] = __ldg(t + i);
    for (long long i = f.hi; i < f.b; ++i) in[i - base] = __ldg(t + i);
    // this stage's outputs go out again once the store of tile c - kStages has
    // read them
    if (c >= kStages) asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(kStages - 1)
                                   : "memory");
    double* o_sample = out_f64(s, 0);
    double* o_wait = out_f64(s, 1);
    double* o_start = out_f64(s, 2);
    double* o_exp2 = out_f64(s, 3);
    uint8_t* o_cold = out_u8(s, 0);
    uint8_t* o_queued = out_u8(s, 1);
    for (long long i = f.a; i < f.b; ++i) {
      const int x = static_cast<int>(i - base);
      const Step r = step(cy, in[x], k);
      o_sample[x] = r.sample;
      o_wait[x] = r.wait;
      o_start[x] = r.start;
      o_exp2[x] = r.exp2;
      o_cold[x] = r.cold ? 1 : 0;
      o_queued[x] = r.queued ? 1 : 0;
    }
    fence_async_smem();                                 // generic smem accesses before async
    if (c + kStages < n_tiles) load(c + kStages);
    if (f.hi > f.lo) {
      const uint32_t bytes = static_cast<uint32_t>((f.hi - f.lo) * 8);
      const int x = static_cast<int>(f.lo - base);
      bulk_store(o.sample + f.lo, smem_u32(o_sample + x), bytes);
      bulk_store(o.wait + f.lo, smem_u32(o_wait + x), bytes);
      bulk_store(o.start + f.lo, smem_u32(o_start + x), bytes);
      bulk_store(o.exp2 + f.lo, smem_u32(o_exp2 + x), bytes);
    }
    if (u.hi > u.lo) {
      const uint32_t bytes = static_cast<uint32_t>(u.hi - u.lo);
      const int x = static_cast<int>(u.lo - base);
      bulk_store(o.cold + u.lo, smem_u32(o_cold + x), bytes);
      bulk_store(o.queued + u.lo, smem_u32(o_queued + x), bytes);
    }
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    auto edge_f64 = [&](long long i) {
      const int x = static_cast<int>(i - base);
      o.sample[i] = o_sample[x];
      o.wait[i] = o_wait[x];
      o.start[i] = o_start[x];
      o.exp2[i] = o_exp2[x];
    };
    for (long long i = f.a; i < f.lo; ++i) edge_f64(i);
    for (long long i = f.hi; i < f.b; ++i) edge_f64(i);
    auto edge_u8 = [&](long long i) {
      const int x = static_cast<int>(i - base);
      o.cold[i] = o_cold[x];
      o.queued[i] = o_queued[x];
    };
    for (long long i = u.a; i < u.lo; ++i) edge_u8(i);
    for (long long i = u.hi; i < u.b; ++i) edge_u8(i);
  }
  exit_free[j] = cy.free_t;
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// kAhead arrivals of a rerun, with the stored start and cold flag of each
// (the run being replaced), in registers
struct Ahead {
  double t[kAhead], start[kAhead];
  uint8_t cold[kAhead];
  __device__ __forceinline__ void fill(const double* __restrict__ tt, const Outs& o,
                                       long long i0, long long hi) {
#pragma unroll
    for (int m = 0; m < kAhead; ++m) {
      const bool in = i0 + m < hi;
      t[m] = in ? tt[i0 + m] : 0.0;
      start[m] = in ? o.start[i0 + m] : 0.0;
      cold[m] = in ? o.cold[i0 + m] : 0;
    }
  }
  // steps [i0, min(i0 + kAhead, hi)), writing each; the index of the first
  // arrival whose free2 meets the stored run's, or -1
  __device__ __forceinline__ long long run(Carry& cy, const Consts& k, const Outs& o,
                                           long long i0, long long hi) {
#pragma unroll
    for (int m = 0; m < kAhead; ++m) {
      const long long i = i0 + m;
      if (i >= hi) break;
      const double before = __dadd_rn(start[m], cold[m] ? k.cold60 : k.wm);
      const Step r = step(cy, t[m], k);
      o.sample[i] = r.sample;
      o.wait[i] = r.wait;
      o.start[i] = r.start;
      o.exp2[i] = r.exp2;
      o.cold[i] = r.cold ? 1 : 0;
      o.queued[i] = r.queued ? 1 : 0;
      if (same_bits(cy.free_t, before)) return i;
    }
    return -1;
  }
};

// counts[2 r]: arrivals round r rewrote; counts[2 r + 1]: 1 if round r
// changed an exit free that a later boundary of its group reads
__global__ void __launch_bounds__(kRepairThreads)
fleet_scan_repair(const double* __restrict__ t, const long long* __restrict__ seg_lo,
                  const long long* __restrict__ seg_glo, long long n_seg, int round,
                  Consts k, Outs o, double* __restrict__ entry,
                  const double* __restrict__ exit_in, double* __restrict__ exit_out,
                  const uint8_t* __restrict__ changed_in, uint8_t* __restrict__ changed_out,
                  unsigned long long* __restrict__ counts) {
  if (round > 0 && *(volatile unsigned long long*)(counts + 2 * (round - 1) + 1) == 0)
    return;                                             // the round before changed nothing
  const long long j = static_cast<long long>(blockIdx.x) * kRepairThreads + threadIdx.x;
  if (j >= n_seg) return;
  const long long lo = seg_lo[j], hi = seg_lo[j + 1], glo = seg_glo[j];
  double x_out = exit_in[j];
  uint8_t changed = 0;
  if (lo > glo && (round == 0 || changed_in[j - 1])) {
    const double x = exit_in[j - 1];
    if (!same_bits(x, entry[j])) {
      entry[j] = x;
      // rerun from x, loading kAhead arrivals (and the stored start and cold
      // flag) one tile ahead of the steps, in two register tiles
      Carry cy{true, x, __dadd_rn(x, k.ka)};
      Ahead a, b;
      a.fill(t, o, lo, hi);
      long long i0 = lo, merged_at = -1;
      while (true) {
        if (i0 + kAhead < hi) b.fill(t, o, i0 + kAhead, hi);
        merged_at = a.run(cy, k, o, i0, hi);
        i0 += kAhead;
        if (merged_at >= 0 || i0 >= hi) break;
        if (i0 + kAhead < hi) a.fill(t, o, i0 + kAhead, hi);
        merged_at = b.run(cy, k, o, i0, hi);
        i0 += kAhead;
        if (merged_at >= 0 || i0 >= hi) break;
      }
      const long long rewritten = (merged_at >= 0 ? merged_at + 1 : hi) - lo;
      atomicAdd(counts + 2 * round, static_cast<unsigned long long>(rewritten));
      if (merged_at < 0) {
        x_out = cy.free_t;
        changed = j + 1 < n_seg && seg_glo[j + 1] == glo;
      }
    }
  }
  exit_out[j] = x_out;
  changed_out[j] = changed;
  if (changed) atomicMax(counts + 2 * round + 1, 1ULL);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Pass 1 over n_seg segments: group g (offsets[g] .. offsets[g + 1]) is cut
// into segments seg_first[g] .. seg_first[g + 1] - 1 of `segment` arrivals
// (its last shorter); seg_first holds n_groups + 1 entries. Writes the
// segment table pass 2 reads (seg_lo, n_seg + 1 entries: segment j owns
// arrivals [seg_lo[j], seg_lo[j + 1]); seg_glo[j], its group's start), all
// six outputs, and each segment's entry free (where it is not its group's
// first) and exit free. t and the six outputs must be 16-byte aligned.
// Launches on `stream` and returns cudaGetLastError() (0 = none).
extern "C" int fleet_scan_segment_launch(const void* t, const void* offsets,
                                         const void* seg_first, long long n_groups,
                                         long long segment, long long n_seg, int warmup,
                                         double warm_s, double cold_s, double wm,
                                         double cold60, double ka, void* sample, void* wait,
                                         void* start, void* exp2, void* cold, void* queued,
                                         void* seg_lo, void* seg_glo, void* entry,
                                         void* exit_free, void* stream) {
  if (n_seg <= 0) return 0;
  if (warmup < 0 || segment < 1 || n_groups < 1 || !aligned16(t) || !aligned16(sample) ||
      !aligned16(wait) || !aligned16(start) || !aligned16(exp2) || !aligned16(cold) ||
      !aligned16(queued))
    return static_cast<int>(cudaErrorInvalidValue);
  static std::atomic<bool> allowed[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 64 || !allowed[dev].load()) {
    err = cudaFuncSetAttribute(fleet_scan_segments, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < 64) allowed[dev].store(true);
  }
  const Consts k{warm_s, cold_s, wm, cold60, ka};
  const Outs o{static_cast<double*>(sample), static_cast<double*>(wait),
               static_cast<double*>(start),  static_cast<double*>(exp2),
               static_cast<uint8_t*>(cold),  static_cast<uint8_t*>(queued)};
  const long long blocks = (n_seg + kThreads - 1) / kThreads;
  fleet_scan_segments<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t), static_cast<const long long*>(offsets),
      static_cast<const long long*>(seg_first), n_groups, segment, n_seg, warmup, k, o,
      static_cast<long long*>(seg_lo), static_cast<long long*>(seg_glo),
      static_cast<double*>(entry), static_cast<double*>(exit_free));
  return static_cast<int>(cudaGetLastError());
}

// Rounds first_round .. first_round + n_rounds - 1 of pass 2 (see the
// header), one launch each: round r reads the exit frees and changed flags
// of buffer r % 2 (exit_a / changed_a for even r) and writes the other's
// for every segment, and counts[2 r], counts[2 r + 1]; counts (uint64) must
// be zero where a round writes. Returns the first launch error (0 = none).
extern "C" int fleet_scan_repair_launch(const void* t, const void* seg_lo, const void* seg_glo,
                                        long long n_seg, int first_round, int n_rounds,
                                        double warm_s, double cold_s, double wm,
                                        double cold60, double ka, void* sample, void* wait,
                                        void* start, void* exp2, void* cold, void* queued,
                                        void* entry, void* exit_a, void* exit_b,
                                        void* changed_a, void* changed_b, void* counts,
                                        void* stream) {
  if (n_seg <= 0 || n_rounds <= 0) return 0;
  if (first_round < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Consts k{warm_s, cold_s, wm, cold60, ka};
  const Outs o{static_cast<double*>(sample), static_cast<double*>(wait),
               static_cast<double*>(start),  static_cast<double*>(exp2),
               static_cast<uint8_t*>(cold),  static_cast<uint8_t*>(queued)};
  double* exits[2] = {static_cast<double*>(exit_a), static_cast<double*>(exit_b)};
  uint8_t* changed[2] = {static_cast<uint8_t*>(changed_a), static_cast<uint8_t*>(changed_b)};
  const long long blocks = (n_seg + kRepairThreads - 1) / kRepairThreads;
  for (int r = first_round; r < first_round + n_rounds; ++r) {
    fleet_scan_repair<<<static_cast<unsigned>(blocks), kRepairThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const double*>(t), static_cast<const long long*>(seg_lo),
        static_cast<const long long*>(seg_glo), n_seg, r, k, o,
        static_cast<double*>(entry), exits[r % 2], exits[(r + 1) % 2], changed[r % 2],
        changed[(r + 1) % 2], static_cast<unsigned long long*>(counts));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
