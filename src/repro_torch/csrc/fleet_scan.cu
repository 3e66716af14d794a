// The fleet_vec cap=1 group recursion for Hopper, over every group at once.
//
// Has no TPU kernel counterpart: the reference runs it as a jitted
// jax.lax.scan under enable_x64 (src/repro/core/fleet_vec.py, _get_scan_fn /
// _solve_group_scan), one device dispatch per (worker, fn) group. Here one
// launch takes a CSR batch of all groups: float64 arrivals concatenated group
// after group, and int64 offsets (group g owns [offsets[g], offsets[g + 1])).
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
// (42 B against HBM), and the serial chain of the longest group (two dependent
// float64 adds per step through the carry). Design: one thread per group walks
// its arrivals in order. The arrivals are independent of the carry, so a
// thread loads kChunk of them into registers before it runs their steps: the
// loads of a chunk are in flight together instead of one device-memory latency
// per step. Load balance over Zipf-skewed group lengths is later work.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // one warp per block: spreads groups over SMs
constexpr int kChunk = 8;      // arrivals loaded ahead of the dependent chain

__global__ void __launch_bounds__(kThreads)
fleet_scan_kernel(const double* __restrict__ t, const long long* __restrict__ offsets,
                  long long n_groups, double warm_s, double cold_s, double wm,
                  double cold60, double ka, double* __restrict__ sample,
                  double* __restrict__ wait, double* __restrict__ start,
                  double* __restrict__ exp2, uint8_t* __restrict__ cold,
                  uint8_t* __restrict__ queued) {
  const long long g = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (g >= n_groups) return;
  const long long lo = offsets[g];
  const long long hi = offsets[g + 1];
  bool alive = false;
  double free_t = 0.0;
  double exp_t = 0.0;
  for (long long base = lo; base < hi; base += kChunk) {
    double tc[kChunk];
#pragma unroll
    for (int j = 0; j < kChunk; ++j) tc[j] = base + j < hi ? t[base + j] : 0.0;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const long long i = base + j;
      if (i >= hi) break;
      const double ti = tc[j];
      const bool alive2 = alive && (exp_t >= ti);
      const bool q = alive2 && (free_t > ti);
      const double st = q ? free_t : ti;
      const double svc = alive2 ? warm_s : cold_s;
      const double svc60 = alive2 ? wm : cold60;
      const double w = __dmul_rn(__dsub_rn(st, ti), 60.0);
      const double s = __dadd_rn(w, svc);
      const double f2 = __dadd_rn(st, svc60);
      const double e2 = __dadd_rn(f2, ka);
      sample[i] = s;
      wait[i] = w;
      start[i] = st;
      exp2[i] = e2;
      cold[i] = alive2 ? 0 : 1;
      queued[i] = q ? 1 : 0;
      alive = true;
      free_t = f2;
      exp_t = e2;
    }
  }
}

}  // namespace

extern "C" int fleet_scan_threads() { return kThreads; }

// Launch on `stream`; returns the CUDA error of the launch (0 = none).
extern "C" int fleet_scan_launch(const void* t, const void* offsets, long long n_groups,
                                 double warm_s, double cold_s, double wm, double cold60,
                                 double ka, void* sample, void* wait, void* start,
                                 void* exp2, void* cold, void* queued, void* stream) {
  if (n_groups <= 0) return 0;
  const long long blocks = (n_groups + kThreads - 1) / kThreads;
  fleet_scan_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(t), static_cast<const long long*>(offsets), n_groups,
      warm_s, cold_s, wm, cold60, ka, static_cast<double*>(sample),
      static_cast<double*>(wait), static_cast<double*>(start), static_cast<double*>(exp2),
      static_cast<uint8_t*>(cold), static_cast<uint8_t*>(queued));
  return static_cast<int>(cudaGetLastError());
}
