"""The kernels' yardstick on the card, and sweeps of the planners' choices.

    PYTHONPATH=src python -m repro_torch.kernels.sweep [--main] [--out FILE]

The yardstick (:func:`cuda_ms`, :func:`cold_copies`, :func:`bound_ms` and
the work counts) is the one ``chip_smoke.py``'s phase 6 times with too.

Without ``--main`` it sweeps decode_attention's split count and its fixed
cost against how much of each row is filled, and diag_recurrence's two
routes and chunk lengths across channel counts, to place the threshold
between the routes (``diag_recurrence.ops.SEQUENTIAL_MIN_THREADS_PER_SM``).

``--host`` prints the wrappers' host time per call (flash_attention at
qwen1.5-0.5b's S=64 prefill in bf16 and qwen3-1.7b's fp32 prefill,
diag_recurrence at the RG-LRU prefill, decode_attention at qwen3-1.7b's
and recurrentgemma-2b's decode, with and without its lse): the median of
200 calls, each from an idle device, as serving calls them (no gradient). Through the public
wrappers only, so the same file times an earlier tree's as ``--main`` does.

``--main`` times both kernels at the main paths' shapes through their public
wrappers only (decode_attention also with its lse written, where the tree
has that output), on three clocks: device time with a warm L2, device time with
a cold L2, and host-paced (back-to-back calls without the sleep ahead, so a
call shorter than its wrapper's host work reads the host's pace). Since it
calls nothing else of the package, the same file, copied into an earlier
tree's ``repro_torch/kernels/``, times that tree's kernels on the same clocks.

``--fleet-scan`` times fleet_scan's segment length and warm-up (segment in
128, 256, 512, 1024, 4096; warm-up in 0, 8, 32) on azure_scale_xl's
warmswap batch at one instance a function (the scenario's own traces, as
``fleet_vec`` hands them to the kernel) and on ``chip_smoke.py`` phase 19a's
loose and all-queued batches: the call's device time, its kernels' device
time from ``torch.profiler``, pass 2's rounds and repaired arrivals. Through
the public wrapper only: copied into an earlier tree whose wrapper takes no
segment, it times that tree's kernel once a batch.

``--ssm-terms`` times the ssm_terms kernel at falcon-mamba-7b's SSM chunk
(B1 S256, 8,192 channels, 16 states, bf16) and its decode step (S1): the
kernel through its wrapper with a cold and a warm L2 and host-paced, and the
plain chain on the same cold inputs, beside the bytes bound; the wrapper's
and the plain chain's host us a call; the kernel's name in the profiler's
trace; twice in turns.

``--backward`` times the flash_attention backward at the training shapes
phase 6 times (qwen1.5-0.5b B4 H16/16, qwen3-1.7b H16/8 d=128,
recurrentgemma's local H10/1 d=256 with its window, S=1024-2560), in fp32
and bf16: the whole call and, from ``torch.profiler``, each of its three
launches (the rowsum, dK/dV, dQ) and the dK/dV launch's blocks.

Prints one JSON line per measurement and the card's name and power limit;
needs a card.
"""
from __future__ import annotations

import argparse
import itertools
import json
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels.decode_attention import ops as dec
from repro_torch.kernels.diag_recurrence import ops as rec
from repro_torch.kernels.fleet_scan import ops as scan_ops

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
#: dense, per the data sheet: bf16 and TF32 on the tensor cores, float32 and
#: float64 on the CUDA cores. A kernel that computes fp32 as three TF32
#: products a product (3xTF32) is bound by ``3 * ops`` at the "tf32" rate
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 494.7e12, torch.float32: 67e12,
              torch.float64: 34e12}
PRIME_CYCLES = 3_000_000       # sleep ahead of each timed run: ~1.7 ms at 1.75 GHz
L2_SPAN = 4                    # a cold rotation moves this many L2 sizes between reuses


def cuda_ms(fn, iters: int = 20, per: int = 10, warmup: int = 3,
            prime: bool = True) -> float:
    """Median time of one call in ms: ``iters`` runs of ``per`` back-to-back
    calls between two CUDA events. ``fn`` is a callable, or a list of
    callables called in turn across all runs (see :func:`cold_copies`).
    With ``prime`` each run is queued behind a sleep kernel, so the host has
    enqueued the calls before the first starts and a call shorter than its
    own host work (a decode call's 10-25 us against its wrapper's 30-60 us)
    reads device time; without it the runs read the host's pace."""
    fns = itertools.cycle(fn if isinstance(fn, list) else [fn])
    for _ in range(warmup):
        next(fns)()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if prime:
            torch.cuda._sleep(PRIME_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per):
            next(fns)()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per)
    return statistics.median(times)


def l2_bytes(device) -> int:
    return getattr(torch.cuda.get_device_properties(device), "L2_cache_size", 50 << 20)


def cold_copies(make, nbytes: int, l2: int) -> list:
    """Enough results of ``make()`` (fresh copies of one call's inputs) that
    calls rotating over them move :data:`L2_SPAN` L2 sizes (``l2``) of
    ``nbytes`` each before an input comes round again: each call then finds
    its inputs in device memory, not in L2, as a layer's call on the main
    path does after the other layers' weights have passed through."""
    return [make() for _ in range(max(2, -(-L2_SPAN * l2 // nbytes)))]


def bound_ms(moved: int, ops: int, dtype):
    """(ms, "bytes" or "operations"): the larger of ``moved`` bytes over the
    memory rate and ``ops`` operations over the peak rate for ``dtype`` (a
    key of :data:`PEAK_FLOPS`)."""
    return max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
               (ops / PEAK_FLOPS[dtype] * 1e3, "operations"))


def decode_work(q, k_cache, valid):
    """(bytes, operations) one decode_attention call needs: the valid K/V
    rows read once, q read and the output written once, the mask read once."""
    B, H, d = q.shape
    Hkv = k_cache.shape[1]
    esize = k_cache.element_size()
    n_valid = int(valid.expand(B, valid.shape[-1]).sum())
    return (2 * n_valid * Hkv * d * esize + 2 * B * H * d * esize + valid.numel(),
            4 * n_valid * H * d)


def recurrence_work(a):
    """(bytes, operations) of one diag_recurrence call: a, b and h_all once,
    h0 and h_final once, in fp32."""
    B, S, C = a.shape
    return 3 * B * S * C * 4 + 2 * B * C * 4, 2 * B * S * C


def ssm_terms_work(raw, A_log):
    """Bytes of one ssm_terms call: a and b written once in fp32; raw dt and
    x read once and B read once in the inputs' dtype; A_log and dt_bias once
    in fp32."""
    B, S, di = raw.shape
    n, esize = A_log.shape[1], raw.element_size()
    return 2 * B * S * di * n * 4 + 2 * B * S * di * esize + B * S * n * esize + di * (n + 1) * 4


def flash_backward_work(q, k, causal, window):
    """(bytes, operations) of one flash_attention backward in the inputs'
    dtype (fp32 or bf16): q, k, v, the output and its gradient and the rows'
    lse (fp32) read once, dq, dk, dv written once; five products (S, dP, dV,
    dS.K, dS^T.Q) of 2*d operations per unmasked (query, key) pair and head."""
    B, H, Sq, d = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    lo = [max(0, i - window + 1) if window is not None else 0 for i in range(Sq)]
    hi = [min(i + 1, Sk) if causal else Sk for i in range(Sq)]
    pairs = sum(max(0, h - l) for l, h in zip(lo, hi))
    moved = q.element_size() * (4 * B * H * Sq * d + 4 * B * Hkv * Sk * d) + 4 * B * H * Sq
    return moved, 10 * d * pairs * B * H


def flash_backward_bound_ms(moved: int, ops: int, dtype: torch.dtype):
    """``bound_ms`` of the flash backward on the units its route runs on:
    bf16 products at the bf16 rate; fp32 as three TF32 products a product
    (``tc_tf32x3``) at the TF32 rate."""
    if dtype == torch.float32:
        return bound_ms(moved, 3 * ops, "tf32")
    return bound_ms(moved, ops, dtype)


def fleet_scan_work(offsets, segment=getattr(scan_ops, "SEGMENT", None),
                    warmup=getattr(scan_ops, "WARMUP", 0)):
    """(bytes, operations, chain) of one fleet_scan call over a CSR batch:
    each arrival read once (8 B) and its four float64 and two uint8 outputs
    written once (42 B in all); five float64 operations per arrival (a
    subtract, a multiply, three adds); the longest chain of dependent steps
    one thread runs in pass 1, a segment's arrivals and its warm-up (the
    longest group where ``segment`` is None: one thread a group)."""
    import numpy as np
    lengths = np.diff(np.asarray(offsets, dtype=np.int64))
    n = int(lengths.sum())
    if segment is None or not len(lengths):
        return scan_ops.BYTES_PER_ARRIVAL * n, 5 * n, int(lengths.max(initial=0))
    per_group = -(-lengths // segment)
    k = np.arange(int(per_group.sum())) - np.repeat(np.cumsum(per_group) - per_group,
                                                    per_group)
    L = np.repeat(lengths, per_group)
    chain = np.minimum(L - k * segment, segment) + np.minimum(warmup, k * segment)
    return scan_ops.BYTES_PER_ARRIVAL * n, 5 * n, int(chain.max(initial=0))


#: 19a's batches: name -> (keep-alive (min), groups as (kind, arrivals)).
#: "mixed": bursts of gaps under a warm service and one gap in ten that
#: outlives a keep-alive; "queued": gaps under the warm service, so every
#: arrival after the first queues. Lengths straddle the reference's pad
#: buckets (powers of two from 64) and the kernel's segment; one long group.
_AROUND = tuple(n for S in (getattr(scan_ops, "SEGMENT", 256),)
                for n in (S - 1, S, S + 1, 2 * S + 1))
SCAN_CHECK = {
    "tight": (0.02, tuple(("mixed", n) for n in (1, 2, 63, 64, 65, 128, *_AROUND, 10_000))),
    "loose": (15.0, tuple(("mixed", n) for n in (1, 2, 63, 64, 65, 128, *_AROUND, 100_000))),
    "queued": (15.0, (("queued", 10_000),)),
}
SCAN_SERVICE = (2.0, 1.39)  # warm_s, cold_s: a warm service longer than the mean gap


def scan_check_batch(label: str):
    """``(t, offsets, consts)`` of 19a's batch ``label``: CPU tensors from the
    batch's own seed, ``consts`` as ``fleet_vec`` passes them."""
    import numpy as np
    ka, groups = SCAN_CHECK[label]
    rng = np.random.default_rng([19, list(SCAN_CHECK).index(label)])
    arrivals = []
    for kind, n in groups:
        if kind == "mixed":
            gaps = np.where(rng.random(n) < 0.1, rng.exponential(20.0, n),
                            rng.exponential(0.03, n))
        else:
            gaps = rng.uniform(0.0, 0.02, n)
        arrivals.append(np.cumsum(gaps))
    offsets = np.r_[0, np.cumsum([n for _, n in groups])].astype(np.int64)
    warm_s, cold_s = SCAN_SERVICE
    return (torch.from_numpy(np.concatenate(arrivals)), torch.from_numpy(offsets),
            (warm_s, cold_s, warm_s / 60.0, cold_s / 60.0, ka))


def azure_scan_batch():
    """``(t, offsets, consts)`` of azure_scale_xl's warmswap batch with one
    instance a function, as ``fleet_vec`` hands it to the kernel (on the
    card): the scenario's own traces, its scan run stopped at that call."""
    import importlib
    import os
    from pathlib import Path

    from repro_torch.core.scenario import Scenario, run

    # the subpackage, whose attribute fleet_vec looks the wrapper up in at each call
    fs = importlib.import_module("repro_torch.kernels.fleet_scan")

    class Caught(Exception):
        pass

    caught = []

    def catch(*args):
        caught.append(args)
        raise Caught

    path = (Path(__file__).resolve().parents[3] / "benchmarks" / "scenarios"
            / "azure_scale_xl.json")
    scn = Scenario.from_file(str(path)).with_overrides(
        {"max_instances_per_fn": 1, "methods": ["warmswap"]})
    real, old = fs.fleet_scan, os.environ.get("REPRO_FLEET_VEC_SCAN")
    fs.fleet_scan = catch
    os.environ["REPRO_FLEET_VEC_SCAN"] = "1"
    try:
        run(scn)
    except Caught:
        pass
    finally:
        fs.fleet_scan = real
        if old is None:
            del os.environ["REPRO_FLEET_VEC_SCAN"]
        else:
            os.environ["REPRO_FLEET_VEC_SCAN"] = old
    t, offsets, *consts = caught[0]
    return t, offsets, tuple(consts)


def fleet_scan_split(call, n: int = 5) -> dict:
    """Device ms a call of ``call`` spends in each of fleet_scan's kernels
    (``torch.profiler``): pass 1, and pass 2's rounds summed. Each kernel's
    mean launch over the launches the profiler kept (it can drop some),
    times its launches a call (``fleet_scan.last``; one on a tree whose
    wrapper keeps no record)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    last = getattr(scan_ops.fleet_scan, "last", None)
    per_call = {"pass1_ms": 1, "pass2_ms": last["launches"] - 1 if last else 0}
    split = {"pass1_ms": 0.0, "pass2_ms": 0.0}
    for e in prof.key_averages():
        key = ("pass1_ms" if "fleet_scan_segments" in e.key or "fleet_scan_kernel" in e.key
               else "pass2_ms" if "fleet_scan_repair" in e.key else None)
        if key and e.count:
            split[key] = e.device_time_total / e.count / 1e3 * per_call[key]
    return split


#: fleet_scan's (segment, warm-up) grid
FLEET_CUTS = [(S, W) for S in (128, 256, 512, 1024, 4096) for W in (0, 8, 32)]


def sweep_fleet_scan(device, rows: list) -> None:
    """fleet_scan over :data:`FLEET_CUTS` on three batches."""
    import inspect
    fs = scan_ops.fleet_scan
    takes_cut = "segment" in inspect.signature(fs).parameters
    batches = {"azure_scale_xl warmswap": azure_scan_batch(),
               "19a loose": scan_check_batch("loose"),
               "19a queued": scan_check_batch("queued")}
    for label, (t, offsets, consts) in batches.items():
        t, offsets = t.to(device), offsets.to(device)
        lengths = offsets.diff()
        for S, W in (FLEET_CUTS if takes_cut else [(None, 0)]):
            kw = {} if S is None else {"segment": S, "warmup": W}

            def call():
                return fs(t, offsets, *consts, **kw)

            ms = cuda_ms(call, iters=5, per=1, warmup=1)
            split = fleet_scan_split(call)
            last = getattr(fs, "last", None) or {}
            moved, ops, chain = fleet_scan_work(offsets.cpu(), S, W)
            bound = bound_ms(moved, ops, torch.float64)[0]
            kernel_ms = split["pass1_ms"] + split["pass2_ms"]
            row = {"kernel": "fleet_scan", "batch": label, "segment": S, "warmup": W,
                   "arrivals": int(t.shape[0]), "groups": int(lengths.shape[0]),
                   "longest_group": int(lengths.max()), "ms": ms, **split,
                   "bound_ms": bound, "bound_share": bound / kernel_ms if kernel_ms else None,
                   "chain_steps": chain, "segments": last.get("segments"),
                   "rounds": last.get("rounds"), "repaired": last.get("repaired"),
                   "launches": last.get("launches")}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del t, offsets
        torch.cuda.empty_cache()


def host_us(fn, n: int = 200) -> float:
    """Median host time of one call of ``fn`` in us, the device idle before
    each call (a synchronize outside the timed part)."""
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def time_host(device, rows: list) -> None:
    """The wrappers' host time per call, twice in turns."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    gen = torch.Generator(device=device).manual_seed(6)
    cases = []
    for label, (B, H, Hkv, S, d), dtype in (("qwen1.5 prefill S=64", (1, 16, 16, 64, 64),
                                             torch.bfloat16),
                                            ("qwen3 prefill S=2048", (1, 16, 8, 2048, 128),
                                             torch.float32)):
        q = torch.randn((B, H, S, d), generator=gen, device=device).to(dtype)
        k = torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
        cases.append(("flash_attention", label, lambda q=q, k=k: flash_attention(q, k, k)))
    B, S, C = RECURRENCE_CASES["recurrentgemma"]
    a = torch.rand((B, S, C), generator=gen, device=device) * 0.5 + 0.5
    h0 = torch.randn((B, C), generator=gen, device=device)
    cases.append(("diag_recurrence", f"RG-LRU B{B} S{S} C{C}",
                  lambda: rec.diag_recurrence(a, a, h0)))
    for label, q, k, v, valid in decode_cases(gen, device):
        for lse in (False, True):
            cases.append(("decode_attention", label + (" with lse" if lse else ""),
                          lambda q=q, k=k, v=v, m=valid, lse=lse: dec.decode_attention(
                              q, k, v, m, return_lse=lse)))
    for turn, (kernel, label, fn) in itertools.product(range(2), cases):
        for _ in range(10):
            fn()
        row = {"kernel": kernel, "shape": label, "turn": turn, "host_us": host_us(fn)}
        rows.append(row)
        print(json.dumps(row), flush=True)


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(0) + ", power limit not read"


def decode_cases(gen, device):
    """(label, q, k, v, valid): qwen3-1.7b's and recurrentgemma-2b's decode
    shapes, each row filled to a prompt of 512-2048 tokens plus 64 decoded."""
    for label, (B, H, Hkv, C, d) in (("qwen3", (4, 16, 8, 4096, 128)),
                                     ("recurrentgemma", (4, 10, 1, 2048, 256))):
        q = torch.randn((B, H, d), generator=gen, device=device)
        k = torch.randn((B, Hkv, C, d), generator=gen, device=device)
        v = torch.randn((B, Hkv, C, d), generator=gen, device=device)
        fill = torch.randint(512, 2049, (B,), generator=gen, device=device) + 64
        valid = torch.arange(C, device=device)[None, :] < fill.clamp(max=C)[:, None]
        yield label, q, k, v, valid


RECURRENCE_CASES = {"falcon": (1, 256, 131072), "recurrentgemma": (1, 2048, 2560)}


def time_main(device, rows: list) -> None:
    """Both kernels at the main paths' shapes, through their wrappers only:
    warm-L2 and cold-L2 device time and the host-paced time, in that order,
    twice in turns."""
    gen = torch.Generator(device=device).manual_seed(5)
    l2 = l2_bytes(device)
    cases = []
    for label, q, k, v, valid in decode_cases(gen, device):
        moved, ops = decode_work(q, k, valid)
        copies = cold_copies(lambda: (k.clone(), v.clone()), moved, l2)
        cases.append(("decode_attention", label, (moved, ops, q.dtype),
                      lambda q=q, k=k, v=v, m=valid: dec.decode_attention(q, k, v, m),
                      [lambda q=q, kv=kv, m=valid: dec.decode_attention(q, *kv, m)
                       for kv in copies]))
        if "return_lse" in dec.decode_attention.__code__.co_varnames:   # the lse output
            cases.append(("decode_attention", label + "+lse", (moved, ops, q.dtype),
                          lambda q=q, k=k, v=v, m=valid: dec.decode_attention(
                              q, k, v, m, return_lse=True),
                          [lambda q=q, kv=kv, m=valid: dec.decode_attention(
                              q, *kv, m, return_lse=True) for kv in copies]))
    for label, (B, S, C) in RECURRENCE_CASES.items():
        a = torch.rand((B, S, C), generator=gen, device=device) * 0.5 + 0.5
        b = torch.randn((B, S, C), generator=gen, device=device)
        h0 = torch.randn((B, C), generator=gen, device=device)
        moved, ops = recurrence_work(a)
        copies = cold_copies(lambda: (a.clone(), b.clone(), h0), moved, l2)
        cases.append(("diag_recurrence", label, (moved, ops, a.dtype),
                      lambda a=a, b=b, h0=h0: rec.diag_recurrence(a, b, h0),
                      [lambda abh=abh: rec.diag_recurrence(*abh) for abh in copies]))
    for turn, (kernel, label, work, warm, cold) in itertools.product(range(2), cases):
        bound, by = bound_ms(*work)
        row = {"kernel": kernel, "shape": label, "turn": turn,
               "warm_ms": cuda_ms(warm), "cold_ms": cuda_ms(cold),
               "host_paced_ms": cuda_ms(warm, prime=False),
               "bound_ms": bound, "bound_by": by, "cold_copies": len(cold)}
        rows.append(row)
        print(json.dumps(row), flush=True)


SSM_TERMS_CASES = {"falcon chunk": (1, 256, 8192, 16, 256), "falcon decode": (1, 1, 8192, 16, 256)}


def time_ssm_terms(device, rows: list) -> None:
    """ssm_terms against its plain chain at falcon-mamba-7b's shapes."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ssm_terms import ssm_terms, ssm_terms_plain
    gen = torch.Generator(device=device).manual_seed(9)
    l2 = l2_bytes(device)
    cases = []
    for label, (B, S, di, n, r) in SSM_TERMS_CASES.items():
        def make(B=B, S=S, di=di, n=n, r=r):
            raw = (torch.randn((B, S, di), generator=gen, device=device) - 4).bfloat16()
            x = torch.randn((B, S, di), generator=gen, device=device).bfloat16()
            proj = torch.randn((B, S, r + 2 * n), generator=gen, device=device).bfloat16()
            dt_bias = torch.randn(di, generator=gen, device=device) - 4
            A_log = torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32)
                              ).repeat(di, 1)
            return raw, dt_bias, A_log, x, proj[..., r:r + n]
        args = make()
        moved = ssm_terms_work(args[0], args[2])
        copies = cold_copies(make, sum(t.numel() * t.element_size() for t in args[:4]), l2)
        cases.append((label, moved, args, copies))
    for turn, (label, moved, args, copies) in itertools.product(range(2), cases):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ssm_terms(*args)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages() if e.device_time_total > 0})
        bound, by = bound_ms(moved, 0, torch.float32)
        row = {"kernel": "ssm_terms", "shape": label, "turn": turn,
               "warm_ms": cuda_ms(lambda: ssm_terms(*args)),
               "cold_ms": cuda_ms([lambda c=c: ssm_terms(*c) for c in copies]),
               "host_paced_ms": cuda_ms(lambda: ssm_terms(*args), prime=False),
               "plain_cold_ms": cuda_ms([lambda c=c: ssm_terms_plain(*c) for c in copies]),
               "host_us": host_us(lambda: ssm_terms(*args)),
               "plain_host_us": host_us(lambda: ssm_terms_plain(*args)),
               "bound_ms": bound, "bound_by": by, "cold_copies": len(copies),
               "device_kernels": names}
        rows.append(row)
        print(json.dumps(row), flush=True)


def sweep_decode(device, rows: list) -> None:
    gen = torch.Generator(device=device).manual_seed(5)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, q, k, v, valid in decode_cases(gen, device):
        B, H, d = q.shape
        Hkv, C = k.shape[1], k.shape[2]
        fit = dec.blocks_per_sm(device.index or 0, d, q.dtype, H // Hkv)
        planned = dec.plan_splits(B, Hkv, C, n_sms, fit)
        bound, _ = bound_ms(*decode_work(q, k, valid), q.dtype)
        ref = dec.decode_attention_plain(q, k, v, valid)
        for n in sorted({1, max(1, planned // 2), planned, 2 * planned, 4 * planned,
                         8 * planned}):
            out = dec.launch_splits(q, k, v, valid, n)
            err = float((out - ref).abs().max())
            t = cuda_ms(lambda: dec.launch_splits(q, k, v, valid, n))
            rows.append({"kernel": "decode_attention", "shape": label, "n_splits": n,
                         "planned": n == planned, "blocks_per_sm": fit, "ms": t,
                         "bound_ms": bound, "max_abs_err": err})
            print(json.dumps(rows[-1]), flush=True)


def sweep_decode_fill(device, rows: list) -> None:
    """decode_attention against how much of each row is filled (a prefix of
    ``fill`` slots in every row), with one split and with the planner's:
    the time at the smallest fill is the fixed cost of the launches."""
    gen = torch.Generator(device=device).manual_seed(7)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    for label, q, k, v, _ in decode_cases(gen, device):
        B, H, d = q.shape
        Hkv, C = k.shape[1], k.shape[2]
        planned = dec.plan_splits(B, Hkv, C, n_sms,
                                  dec.blocks_per_sm(device.index or 0, d, q.dtype, H // Hkv))
        for fill in (8, 64, 256, 1024, C):
            valid = (torch.arange(C, device=device) < fill).expand(B, C).contiguous()
            for n in sorted({1, planned}):
                t = cuda_ms(lambda: dec.launch_splits(q, k, v, valid, n))
                rows.append({"kernel": "decode_attention", "shape": label, "fill": fill,
                             "n_splits": n, "planned": n == planned, "ms": t})
                print(json.dumps(rows[-1]), flush=True)


def sweep_recurrence(device, rows: list) -> None:
    """Both routes across channel counts: the sequential route, the planner's
    chunking, and chunks of 32-256 rows (2 to MAX_CHUNKS chunks)."""
    gen = torch.Generator(device=device).manual_seed(6)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    for S in (512, 2048):
        for C in (2560, 5120, 10240, 20480, 40960, 81920, 131072):
            a = torch.rand((1, S, C), generator=gen, device=device) * 0.5 + 0.5
            b = torch.randn((1, S, C), generator=gen, device=device)
            h0 = torch.randn((1, C), generator=gen, device=device)
            bound, _ = bound_ms(*recurrence_work(a), a.dtype)
            chosen = rec.plan_recurrence(1, S, C, n_sms)
            plans = [rec.RecurrencePlan("sequential", S, 1), chosen]
            for chunk in (32, 64, 128, 256):
                n_chunks = -(-S // chunk)
                if 2 <= n_chunks <= rec.MAX_CHUNKS:
                    plans.append(rec.RecurrencePlan("chunked", chunk, n_chunks))
            for p in dict.fromkeys(plans):
                t = cuda_ms(lambda: rec.run_plan(a, b, h0, p))
                rows.append({"kernel": "diag_recurrence", "S": S, "C": C, "route": p.route,
                             "chunk": p.chunk, "n_chunks": p.n_chunks,
                             "planned": p == chosen, "ms": t, "bound_ms": bound})
                print(json.dumps(rows[-1]), flush=True)
            del a, b, h0


#: label -> (B, H, Hkv, S, d, window): causal training attention
BACKWARD_CASES = {"qwen1.5-0.5b": (4, 16, 16, 1024, 64, None),
                  "qwen3-1.7b": (1, 16, 8, 1024, 128, None),
                  "recurrentgemma local": (1, 10, 1, 2560, 256, 2048)}


def time_backward(device, rows: list) -> None:
    """The flash backward's call and its launches' device time (profiler)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.flash_attention.ops import BWD_ROWS, flash_attention_backward
    gen = torch.Generator(device=device).manual_seed(8)
    for (label, (B, H, Hkv, S, d, window)), dtype in itertools.product(
            BACKWARD_CASES.items(), (torch.float32, torch.bfloat16)):
        q = torch.randn((B, H, S, d), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
                for _ in range(2))
        dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        out, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, window, None,
                                                         d ** -0.5, True)

        def call():
            return flash_attention_backward(q, k, v, out, lse, dout, window=window)

        ms = cuda_ms(call)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        launches = {}
        for e in prof.key_averages():
            name = ("rowsum" if "dot_kernel" in e.key else "dK/dV" if "true" in e.key
                    else "dQ" if "false" in e.key else None)
            if name and e.count:
                launches[name] = e.device_time_total / e.count / 1e3
        moved, ops = flash_backward_work(q, k, True, window)
        row = {"kernel": "flash_attention_backward", "shape": label,
               "dtype": str(dtype).split(".")[1], "ms": ms, "launch_ms": launches,
               "dkdv_blocks": B * Hkv * -(-S // BWD_ROWS),
               "bound_ms": flash_backward_bound_ms(moved, ops, dtype)[0]}
        rows.append(row)
        print(json.dumps(row), flush=True)
        del q, k, v, dout, out, lse


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--main", action="store_true",
                    help="time both kernels at the main paths' shapes on three clocks")
    ap.add_argument("--host", action="store_true",
                    help="the wrappers' host time per call")
    ap.add_argument("--backward", action="store_true",
                    help="the flash backward's launches at the training shapes")
    ap.add_argument("--ssm-terms", action="store_true",
                    help="ssm_terms against its plain chain at falcon-mamba-7b's shapes")
    ap.add_argument("--fleet-scan", action="store_true",
                    help="fleet_scan's segment and warm-up on three batches")
    ap.add_argument("--out", help="also write the rows as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device: the sweep times kernels on the card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(card(), flush=True)
    rows: list = []
    if args.host:
        time_host(device, rows)
    elif args.backward:
        time_backward(device, rows)
    elif args.fleet_scan:
        sweep_fleet_scan(device, rows)
    elif args.ssm_terms:
        time_ssm_terms(device, rows)
    elif args.main:
        time_main(device, rows)
    else:
        sweep_decode(device, rows)
        sweep_decode_fill(device, rows)
        sweep_recurrence(device, rows)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card(), "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
