#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Drives the port's HotSwap cold-start, serving, training and simulation
paths on the card, for the dense, recurrent, MoE, encoder-decoder and VLM
families, and checks them:

1. environment: card name and power limit, torch and CUDA versions;
2. build of every CUDA kernel from ``src/repro_torch/csrc`` (nvcc, sm_90a),
   one nvcc per source, all started together, and the count of tensor-core
   instructions (HMMA / HGMMA) in flash_attention's SASS where cuobjdump is
   present;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the paths give it (page_gather bitwise, including rows with a byte tail,
   rows shorter than one bulk item, 4 MiB + 16 B rows and an unaligned view
   of a pool; flash_attention and decode_attention within 2e-2 for bf16 and
   2e-5 for fp32, including all-masked rows, Sq != Sk, qwen3's d=128 prefill
   and recurrentgemma's d=256, g=10 layers, h2o-danube3's d=120 (window 4096
   at S=4608), whisper's non-causal encoder (S=1500) and cross prefill (64
   queries over 1500 keys), granite's g=3 and internvl2's g=7, and decode
   masks whose live extent is a short prefix, wraps the ring, holds no valid
   slot or every slot (cross attention over 1500 keys);
   diag_recurrence within 1e-4 at the reference's sweep and at the RG-LRU
   shapes (S=512 and 2048, on the chunked route), and bitwise equal at the
   SSM-chunk shape (on the sequential route), h0 != 0); ssm_terms bitwise
   equal at falcon-mamba's SSM chunk and decode step, B a view of x_proj's
   product and x in the conv's layout;
4. the quickstart loop: three model images in one pool, two tenants per
   serving workload, baseline / warmswap under all four restore policies /
   prebaked, all giving equal classes; every flash_attention launch on the
   tensor-core route;
5. qwen1.5-0.5b at full width: a 0.93 GB image migrated under BULK and
   NO_PAGESERVER, restored leaves bitwise equal to the originals, prefill at
   S=64 and S=2048 with equal logits (flash_attention on the tensor-core
   route), and the kernel path against the plain path;
6. kernel times (``repro_torch.kernels.sweep.cuda_ms``: CUDA events around
   back-to-back calls queued behind a sleep kernel, so device time; median
   of the runs after warm-up) beside their bound, their plain version and
   one library call (flash_attention also at S=64 and at qwen3's fp32 d=128
   prefill, h2o's d=120 prefill, whisper's encoder and cross prefill;
   decode_attention at qwen3's, recurrentgemma's, granite's, internvl2's,
   whisper's cross and h2o's decode,
   diag_recurrence at falcon-mamba's SSM chunk and recurrentgemma's RG-LRU
   prefill, each pair timed in turns, with a cold L2 as the main path finds
   it and with a warm one; the flash backward on both tensor-core routes,
   bf16 and fp32 at qwen1.5's training shape and fp32 at qwen3's d=128 and
   recurrentgemma's local d=256 ones, beside SDPA's backward, its bound and
   its launches by route), page_gather's host time per call, and the
   qwen1.5 cold-start totals;
7. serving on qwen3-1.7b at full width (28 layers, fp32, 6.9 GB image): a
   ReplicaSet of two replicas brought up from the pool (BULK), each with 4
   slots of 4096 positions, serves 8 requests (prompts of 512-2048 tokens, 64
   new tokens each); one replica is killed and recovered through warmswap,
   then through baseline (weights copied from host memory), and serves one
   more request. Checks: prefill + decode steps against the full forward,
   the kernel path against the plain path on the first request, and
   continuous batching against a 1-slot engine, each within 1e-3 of the
   largest |logit| (fp32, different product orders);
8. falcon-mamba-7b at full width and depth (64 SSM layers, bf16, a 14.5 GB
   image): restored under BULK and NO_PAGESERVER bitwise equal, cold starts
   through the orchestrator (warmswap median of 3, baseline once: it writes
   and reads a 14.5 GB checkpoint), a forward at S=2048 through the
   diag_recurrence kernel against the plain recurrence, profiled, and a
   prefill of 512 tokens + 8 decode steps against the full forward;
9. serving on recurrentgemma-2b at full width and depth (26 layers: 18 RG-LRU,
   8 local attention of 10 heads over 1 kv head of 256; fp32), the same run
   and checks as phase 7;
10. serving on granite-moe-3b-a800m at full width and depth (32 layers, 40
   experts padded to 48, top-8, 24 heads over 8 kv heads: g=3; fp32, 15.6
   GB), the same run as phase 7. Its capacity factor of 1.25 drops
   assignments in the forward and not in decode (no_drop), as in the
   reference, so prefill + decode is held against the forward on a prompt
   of 4 + 4 tokens, where no expert reaches capacity; the kernel path against
   the plain path and batching against the 1-slot engine as in phase 7;
11. moonshot-v1-16b-a3b at full width (64 experts, top-6, d=128) and 2 of its
   48 layers, bf16: one forward; the kernel path against the plain path
   within 0.125 of each logit before the first position the two route
   otherwise, and at every position with the plain path replaying the kernel
   path's expert picks; an fp32 twin within 1e-3 of max |logit| at the
   positions routed alike in every layer (routing is recorded per layer);
12. whisper-small (encoder-decoder: 12 + 12 layers over 1500 stub frames) and
   internvl2-1b (24 layers, 256 stub patches prepended, g=7) at full width
   and depth, fp32: restored under BULK bitwise equal, make_prefill_step on
   generated frames / patches and 32 make_serve_step steps, held against the
   full forward and the plain path within 1e-3 of max |logit|;
13. h2o-danube3-4b at full width and depth (24 layers, head dim 120, window
   4096, bf16, 7.9 GB): restored under BULK, a prefill of 4608 tokens that
   wraps every layer's ring, 8 decode steps through it, held against the full
   forward and the plain path within 0.125 of each logit;
3g. (run after phase 3) gradients: the flash_attention backward kernels
   (fp32, 3xTF32 on the tensor cores) against torch.autograd.grad through
   the plain version at the training shapes of qwen1.5-0.5b, qwen3-1.7b,
   recurrentgemma's local layer,
   gemma2-27b (window 4096, softcap 50), whisper's encoder and cross
   attention and h2o-danube3-4b (d=120), and the diag_recurrence backward
   (the kernel run backwards in time) on both routes at falcon-mamba's and
   the RG-LRU's shapes against autograd through the plain loop, each within
   1e-4 of the largest |gradient|;
14. training qwen1.5-0.5b at full width and depth (fp32, B=4, S=1024,
   remat=unit) for 10 steps through the training launcher and its
   supervisor: the loss falls, each step runs 24 flash forwards, 24
   recomputes and 24 backward launches; step time, tokens/s, and one step's
   device busy share from the profiler;
15. rollback: qwen1.5-0.5b at full width and 2 layers (B=2, S=256), 8 steps,
   a checkpoint every 2 steps and injected failures at steps 3 and 6, ends
   within 1e-6 of an uninterrupted run;
16. training recurrentgemma-2b at full width and one pattern unit (B=1,
   S=2560, past the 2048 window), 3 steps: both kernels' backward;
17. export: qwen1.5-0.5b's prefill_logits (B=1, S=64, bf16) through
   torch.export to bytes and back, its logits bitwise equal to eager;
18. sharded: 4 ranks share the card over gloo (NCCL refuses two ranks on one
   device), each case on its own ("data", "model") mesh, fp32, held against
   the same config on one rank on the card: (a) qwen3-1.7b serving at full
   width and depth on 1 x 4 (kv heads split 8/4), prefill + 8 teacher-forced
   decode steps within 1e-3 of max |logit|; (b) the same at batch 1 on 2 x 2,
   the caches' positions split over data, the lse merge on the card; (c) one
   qwen1.5-0.5b train step (B=4, S=1024, remat=unit) on 2 x 2, loss within
   1e-5 relative, parameters within 1e-3, 24 flash forwards, recomputes and
   backwards a rank; (d) falcon-mamba-7b at 2 of 64 layers on 1 x 4,
   prefill 512 + 8 decode steps within 1e-3, the recurrence route per rank;
   (e) moonshot-v1-16b-a3b at 2 of 48 layers on 1 x 4 (16 experts a rank),
   one forward within 1e-3 where its routing agrees. Each rank's peak
   memory and seconds are printed; a failing rank fails the phase;
19. the simulation track: (a) fleet_scan against its plain version (run on
   the host, where it serves), bitwise on all six outputs, over groups of
   1, 2, 63, 64, 65, 128, S - 1, S, S + 1, 2S + 1 (S the kernel's segment)
   and 10^4 / 10^5 arrivals under a tight and a loose keep-alive, and a group
   of 10^4 arrivals queued throughout, at the default segment and warm-up and
   at segment 64 without warm-up: pass 2 must rewrite arrivals on some batch
   (segments, rounds and repaired arrivals are printed beside the times), the
   all-queued group within 2x the one-thread-a-group kernel's recorded time,
   and no DFMA in
   its SASS; (b) azure_scale_xl (10.5 M
   invocations, 2,000 Zipf functions, 4 workers, affinity) with every group
   capped at one instance, through ``scenario.run`` with
   ``engine="fleet_vec"``: the scan on the card against the numpy solver,
   equal sha256 of the sample buffers and equal counters, for warmswap and
   prebaking, with both runs' wall seconds, the kernel's device time, its
   share of the bytes bound and the longest segment's chain floor; then
   one method's scan run under cProfile, its top ten entries printed;
   (c) page_headline (smoke) through ``fleet`` and ``fleet_vec`` (scan on
   the card): equal, and the dependency-loading speedup in 2.2-3.2;
   sharing_fig7's memory saving; (d) the paper's page model's predicted
   cold start (tier local) beside qwen1.5-0.5b's measured warmswap and
   baseline starts;
20. bf16 training and the experiments layer: (a) the tensor-core forward's
   rows' lse and the bf16 flash backward kernels at qwen1.5-0.5b's training
   shape (B=4, S=1024, 16 heads, d=64, causal) against the plain version,
   dq, dk, dv within 2e-2 of their largest |entry| (timed in phase 6 beside
   bf16 SDPA's backward and the bf16 tensor-core bound); (b) qwen1.5-0.5b
   trained in bf16 at full width and depth, B=4, S=1024, remat=unit, 10
   steps through ``models/api.make_train_step``: a finite, falling loss,
   step time and tokens/s beside phase 14's fp32; (c) run among phase 18's
   cases on the same 4 ranks: one qwen1.5-0.5b train step on 2 x 2 with
   ZeRO-1 moments, its parameters, loss and grad_norm bitwise those of the
   step with whole moments, each rank's moment bytes; (d) the experiments
   CLI with ``REPRO_FLEET_VEC_SCAN=1`` on the card: a sweep of page_headline
   (smoke, fleet_vec, 4 seeds) serially and on 2 spawned workers, both
   stores byte-equal to the numpy solver's, then the smoke tournament with
   every method's minimum oracle gaps finite and >= 0;
21. the port's five examples (``examples/*_torch.py``) through their
   ``main`` at the reference examples' default flags: (a) quickstart, equal
   classes on both start paths, one build, flash_attention on the
   tensor-core route; (b) multi_tenant_fleet, the live replay's cold and warm
   counts equal to its twin's, a 46,137,344-byte pool, one build; (c)
   train_small, 200 steps of fnbench-tiny with a failure injected at step 100:
   the loss falls, one restore, the fp32 flash forward and backward; (d)
   serve_e2e, 24 requests on reduced qwen3-1.7b (head dim 16), all
   completed, the recovered replica serves, decode_attention launched; (e)
   fleet_sim, its own asserts (host numpy, no kernel).

Each phase prints its seconds. The launch counters are set to 0 just before
each driven path (phases 4, 5, 7-14, 16, 19b-d, 20b-d, 21a-e) and read just after; a kernel the
path did not launch fails the run; falcon-mamba's path must build its recurrence inputs with
ssm_terms and run diag_recurrence on its sequential route, recurrentgemma's on its chunked route. Each phase frees its models before
the next. Any failed check exits non-zero. The last line is the JSON device
record.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import hashlib
import importlib
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import zlib

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = {"bfloat16": 2e-2, "float32": 2e-5}
QWEN_SEQS = (64, 2048)
FLASH_SWEEP = [  # (B, H, Hkv, S, d, causal, window, softcap) as in tests/test_kernels.py
    (2, 4, 2, 256, 64, True, None, None),
    (1, 4, 4, 128, 64, True, 64, None),
    (2, 2, 1, 200, 32, True, None, 50.0),
    (1, 2, 2, 96, 128, False, None, None),
    (1, 8, 2, 320, 64, True, 100, 30.0),
]
FLASH_MAIN = [(1, 16, 16, s, 64) for s in QWEN_SEQS] + [(1, 8, 4, s, 64) for s in QWEN_SEQS]
DECODE_SWEEP = [  # (B, H, Hkv, S, d, softcap) as in tests/test_kernels.py:50-54
    (2, 4, 2, 300, 64, None),
    (1, 8, 1, 512, 128, 50.0),
    (4, 2, 2, 64, 32, None),
]
SERVE_SLOTS, SERVE_SEQ, SERVE_NEW, SERVE_REQUESTS = 4, 4096, 64, 8
SERVE_PROMPTS = (512, 2048)          # prompt lengths, drawn uniformly (numpy seed 21)
DECODE_MAIN = (SERVE_SLOTS, 16, 8, SERVE_SEQ, 128)      # qwen3-1.7b decode: B, H, Hkv, C, d
SERVE_LOGIT_TOL = 1e-3     # of max |logit|: fp32, products in another order
FLASH_GRIFFIN = (1, 10, 1, 2048, 256, 2048)   # recurrentgemma local layer: B, H, Hkv, S, d, window
FLASH_QWEN3 = (1, 16, 8, 2048, 128)           # qwen3-1.7b serving prefill (fp32): B, H, Hkv, S, d
FLASH_REDUCED = (1, 4, 2, 31, 16)     # examples/serve_e2e_torch.py: reduced qwen3, prompts 4-31
DECODE_REDUCED = (4, 4, 2, 128, 16)   # its decode: 4 slots of 128 positions
DECODE_GRIFFIN = (SERVE_SLOTS, 10, 1, 2048, 256)  # its decode: B, H, Hkv, C = window, d
FLASH_H2O = (1, 32, 8, 4608, 120, 4096)       # h2o-danube3-4b prefill: B, H, Hkv, S, d, window
FLASH_ENCODER = (1, 12, 12, 1500, 64)         # whisper-small encoder (non-causal)
FLASH_CROSS = (1, 12, 12, 64, 1500, 64)       # whisper cross prefill: B, H, Hkv, Sq, Sk, d
FLASH_GRANITE = (1, 24, 8, 2048, 64)          # granite-moe-3b prefill, fp32: B, H, Hkv, S, d
FRONTEND_BATCH, FRONTEND_PROMPT, FRONTEND_NEW = 2, 64, 32   # whisper / internvl2 serve steps
DECODE_GRANITE = (SERVE_SLOTS, 24, 8, SERVE_SEQ, 64)        # granite-moe-3b decode: g = 3
DECODE_INTERNVL = (FRONTEND_BATCH, 14, 2, 256 + FRONTEND_PROMPT + FRONTEND_NEW, 64)  # g = 7
DECODE_CROSS = (FRONTEND_BATCH, 12, 12, 1500, 64)           # whisper cross, all keys valid
DECODE_H2O = (1, 32, 8, 4096, 120)                          # h2o-danube3-4b ring: d = 120
DECODE_LSE = [  # (B, H, Hkv, S, d, live slots): one rank's block in phase 18's split caches
    (1, 8, 4, 192, 128, 184),   # qwen3-1.7b on 2 x 2: a data rank's 192 of 384 slots, 8/4 heads
    (2, 4, 2, 128, 64, 100),    # fnbench-tiny on 1 x 4: a model rank's 128 of 512, all 4 q heads
]
LSE_TOL = (1e-4, 1e-5)      # absolute, relative
RECURRENCE_SWEEP = [(2, 100, 64), (1, 256, 32), (3, 17, 130), (1, 64, 2048)]  # test_kernels.py:68-70
RECURRENCE_MAIN = {  # shape -> the route diag_recurrence's planner must take there
    (1, 2048, 2560): "chunked",          # recurrentgemma-2b RG-LRU prefill at S=2048
    (1, 512, 2560): "chunked",           # ... and at S=512
    (1, 256, 131072): "sequential",      # falcon-mamba-7b, one SSM chunk (256 x 8192 x 16)
    (1, 512, 640): "chunked",            # recurrentgemma-2b at model 4 (18g): a rank's prefill
    (2, 1024, 1280): "chunked",          # ... its train step at 2 x 2 (18g-train), a rank's
}
RECURRENCE_TIMED = {"falcon": (1, 256, 131072), "recurrentgemma": (1, 2048, 2560),
                    "recurrentgemma-tp4": (1, 512, 640),
                    "recurrentgemma-tp2": (2, 1024, 1280)}
#: RECURRENCE_TIMED's sharded rows -> the phase 18 case that runs them
RECURRENCE_CASES = {"recurrentgemma-tp4": "18g", "recurrentgemma-tp2": "18g-train"}
DECODE_TIMED = {  # path -> (its decode shape, the dtype the path runs it in)
    "qwen3": (DECODE_MAIN, "float32"), "recurrentgemma": (DECODE_GRIFFIN, "float32"),
    "granite": (DECODE_GRANITE, "float32"), "internvl2": (DECODE_INTERNVL, "float32"),
    "whisper-cross": (DECODE_CROSS, "float32"), "h2o": (DECODE_H2O, "bfloat16")}
RECURRENCE_TOL = 1e-4
FALCON_ARCH = "falcon_mamba_7b"
FALCON_SEQ = 2048
FALCON_DECODE = (512, 8)   # prefill length, decode steps held against the full forward
# of max |logit|, bf16 decode against the bf16 forward: each of the 64 layers
# rounds its activations to bf16 (2^-8 relative) and a decode step's products
# (M=1) round other elements than the prefill's (M=512); the fp32 twin below
# holds the same path to SERVE_LOGIT_TOL
BF16_DECODE_TOL = 0.1
FALCON_FP32_LAYERS = 4     # depth of the fp32 twin of falcon-mamba-7b (full width)
SERVING_KERNELS = {
    "qwen3_1_7b": ("page_gather", "flash_attention", "decode_attention"),
    "recurrentgemma_2b": ("page_gather", "flash_attention", "decode_attention",
                          "diag_recurrence"),
    "granite_moe_3b_a800m": ("page_gather", "flash_attention", "decode_attention"),
}
# granite's prefill + decode against the forward: at capacity factor 1.25 the
# forward drops assignments past capacity and decode (no_drop) does not, so
# they agree only where no expert reaches capacity: S + K <= top_k (= 8)
MOE_SHORT = (4, 4)
MOONSHOT_LAYERS, MOONSHOT_SEQ = 2, 1024    # moonshot-v1-16b-a3b: full width, depth cut
FLASH_MOONSHOT = (1, 16, 16, MOONSHOT_SEQ, 128)   # its forward (bf16; fp32 twin): B, H, Hkv, S, d
H2O_ARCH, H2O_SEQ, H2O_DECODE = "h2o_danube3_4b", 4608, 8   # prefill crosses the window
# of |logit|, bf16 logits against bf16 logits (tests/test_torch_models.py's
# bound: 4 bf16 ulps at magnitude 4-8)
BF16_LOGIT_BOUND = 0.125


# the flash_attention backward's check (fp32, B=1): label -> (H, Hkv, Sq, Sk, d,
# causal, window, softcap), each config's training shape
FLASH_GRAD = {
    "qwen1.5-0.5b": (16, 16, 1024, 1024, 64, True, None, None),
    "qwen3-1.7b": (16, 8, 1024, 1024, 128, True, None, None),
    "recurrentgemma local": (10, 1, 2560, 2560, 256, True, 2048, None),
    "gemma2-27b": (32, 16, 4608, 4608, 128, True, 4096, 50.0),
    "whisper encoder": (12, 12, 1500, 1500, 64, False, None, None),
    "whisper cross": (12, 12, 64, 1500, 64, False, None, None),
    "h2o-danube3-4b": (32, 8, 4608, 4608, 120, True, 4096, None),
}
RECURRENCE_GRAD = {"falcon": (1, 256, 131072), "recurrentgemma": (1, 2560, 2560)}
GRAD_TOL = 1e-4            # of the largest |gradient| in each tensor
TRAIN_SHAPE, TRAIN_STEPS = (4, 1024), 10          # qwen1.5-0.5b training: B, S; steps
TRAIN_LR = 3e-3            # peak rate: 3e-5 .. 3e-4 over the 10 warm-up steps
ROLLBACK_SHAPE, ROLLBACK_STEPS = (2, 256), 8
ROLLBACK_TOL = 1e-6        # tests/test_serving_ft.py:107
GRIFFIN_TRAIN, GRIFFIN_STEPS = (1, 2560), 3       # recurrentgemma-2b training: B, S
#: median step times (s) of phases 14 and 20b with the flash backward's earlier
#: design (fp32 products on CUDA cores in both dtypes), on one NVIDIA H100 80GB
#: HBM3 at 700 W: printed beside this run's
CUDA_CORE_BWD_STEP_S = {"14": 0.4964, "20b": 0.2797}
#: phase 6's flash backward rows: (FLASH_GRAD label, dtype, batch)
BWD_TIMED = [("qwen1.5-0.5b", "bfloat16", TRAIN_SHAPE[0]),
             ("qwen1.5-0.5b", "float32", TRAIN_SHAPE[0]),
             ("qwen3-1.7b", "float32", 1), ("recurrentgemma local", "float32", 1)]
SCENARIOS = os.path.join(ROOT, "benchmarks", "scenarios")
#: 19a: fleet_scan's batches are kernels.sweep.SCAN_CHECK; each runs at the
#: kernel's default segment and warm-up and at this cut (segment, warm-up = 0),
#: where most guessed carries are wrong and pass 2's rounds all run
SCAN_SMALL_CUT = (64, 0)
#: the kernel's earlier design (one thread a group) took 182.399 ms over
#: azure_scale_xl's cap=1 batch, whose longest group has 1,772,989 arrivals
#: (PERF.md section 6, row 5; NVIDIA H100 80GB HBM3 at 700 W): its time a
#: step of one group's chain
GROUP_KERNEL_MS_PER_STEP = 182.399 / 1_772_989
SCAN_OUTPUTS = ("sample", "wait", "start", "exp2", "cold", "queued")
SIM_SAMPLES = ("latency_samples_s", "queue_wait_s", "sample_fn")
SIM_COUNTERS = ("n_invocations", "n_cold", "n_warm", "n_queued", "n_workers",
                "pool_misses", "evictions", "max_concurrent_instances",
                "placement_warm_hits", "placement_pool_hits", "memory_bytes",
                "cache_local_hits", "cache_remote_hits", "cache_misses",
                "shared_cache_peak_bytes", "shared_cache_evictions", "pages_transferred",
                "prewarm_spawns", "prewarm_hits", "prewarm_dropped", "total_latency_s",
                "queue_delay_s", "instance_resident_min", "horizon_min",
                "per_fn_latency", "per_fn_invocations", "per_worker")


class SmokeFailure(RuntimeError):
    pass


def sync(device) -> None:
    from repro_torch.device import synchronize
    synchronize(device)


def expect(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def kernel_fns() -> dict:
    from repro_torch.kernels import (decode_attention, diag_recurrence,
                                     flash_attention, fleet_scan, page_gather, ssm_terms)
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    return {"page_gather": page_gather, "flash_attention": flash_attention,
            "flash_attention_backward": flash_attention_backward,
            "decode_attention": decode_attention, "diag_recurrence": diag_recurrence,
            "fleet_scan": fleet_scan, "ssm_terms": ssm_terms}


#: the CUDA source each kernel wrapper's library is built from
SOURCES = {"page_gather": "page_gather", "flash_attention": "flash_attention",
           "flash_attention_backward": "flash_attention",
           "decode_attention": "decode_attention", "diag_recurrence": "diag_recurrence",
           "fleet_scan": "fleet_scan", "ssm_terms": "ssm_terms"}


def launch_counts(kernels: dict) -> dict:
    """Each kernel's launches since the last reset; the flash backward's also
    by route, as ``flash_attention_backward:<route>``."""
    counts = {k: v.launches for k, v in kernels.items()}
    bwd = kernels.get("flash_attention_backward")
    if bwd is not None:
        counts.update({f"flash_attention_backward:{r}": n
                       for r, n in bwd.launches_by_route.items()})
    return counts


def bwd_route(dtype: str) -> str:
    """The flash backward's route for ``dtype`` ("float32" or "bfloat16")."""
    import torch
    from repro_torch.kernels.flash_attention.ops import BWD_ROUTES
    return BWD_ROUTES[getattr(torch, dtype)]


def reset_counts(kernels) -> None:
    """Set the launch counters of ``kernels`` to 0 (the counts per route and
    per pass too)."""
    for k in kernels:
        k.launches = 0
        for table in ("launches_by_route", "launches_by_pass"):
            if hasattr(k, table):
                setattr(k, table, dict.fromkeys(getattr(k, table), 0))


def expect_route(tag: str, path: str, route: str, kernel: str = "flash_attention") -> dict:
    """Every launch of ``kernel`` since the last reset went through ``route``
    (flash_attention: ``tc_bf16`` for bf16 images, ``cuda_core`` for fp32
    ones; diag_recurrence: ``sequential`` for falcon-mamba's SSM chunks,
    ``chunked`` for recurrentgemma's RG-LRU prefills)."""
    fn = kernel_fns()[kernel]
    by_route = dict(fn.launches_by_route)
    log(f"[{tag}] {kernel} launches by route during the {path}: {by_route}")
    expect(by_route[route] == fn.launches > 0,
           f"the {path} did not run {kernel} on the {route} route: {by_route}")
    return by_route


def free_device(tag: str) -> int:
    """Drop what the phase left, print its peak device memory and return it."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()
    log(f"[{tag}] peak device memory {peak / 1e9:.2f} GB; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    torch.cuda.reset_peak_memory_stats()
    return peak


def timed(tag: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, printing the phase's seconds."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[{tag}] phase {time.perf_counter() - t0:.1f} s")
    return out


def host_us(fn, n: int = 200) -> float:
    """Median host time of one call of ``fn`` in us, the device idle before
    each call (a synchronize outside the timed part)."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


# ---------------------------------------------------------------------------------
# 1-2. environment and build
# ---------------------------------------------------------------------------------

def phase_environment() -> str:
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log(f"[1] card: {card}")
    log(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def _disassembler():
    """cuobjdump from the CUDA toolkit, or the copy Triton ships; None if
    neither is present."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if os.path.exists(found):
        return found
    try:
        import triton
    except ImportError:
        return None
    found = os.path.join(os.path.dirname(triton.__file__), "backends", "nvidia", "bin",
                         "cuobjdump")
    return found if os.path.exists(found) else None


def sass_count(lib, opcode: str) -> int:
    """Instructions of ``opcode`` (e.g. ``DFMA``) in a built library's SASS."""
    tool = _disassembler()
    expect(tool is not None, "no disassembler (cuobjdump) to read the SASS with")
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True, text=True,
                          timeout=300).stdout
    expect("Function :" in sass, f"{tool} printed no SASS for {lib._name}")
    return sum(1 for line in sass.splitlines() if f" {opcode}" in line
               and line.split(opcode)[1][:1] in (" ", "."))


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    names = sorted(set(SOURCES.values()))
    libs = build.build_all(names)
    log(f"[2] built {' + '.join(names)} in {time.perf_counter() - t0:.2f} s")
    for name, text in sorted(build.BUILD_LOG.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"[2] {name}: {line.strip()}")
    tool = _disassembler()
    if tool is None:
        log("[2] flash_attention SASS: no disassembler (cuobjdump) is present; "
            "tensor-core instructions not counted")
        return
    sass = subprocess.run([tool, "-sass", libs["flash_attention"]._name],
                          capture_output=True, text=True, timeout=300).stdout
    hmma = sum(1 for line in sass.splitlines() if "HMMA" in line)
    hgmma = sum(1 for line in sass.splitlines() if "HGMMA" in line)
    log(f"[2] flash_attention SASS ({tool}): {hmma} HMMA and {hgmma} HGMMA instructions")
    expect(hmma + hgmma > 0, "the flash_attention library has no tensor-core instruction")


# ---------------------------------------------------------------------------------
# 3. kernels against their plain versions
# ---------------------------------------------------------------------------------

def check_page_gather(store, device, errs: dict) -> None:
    import torch
    from repro_torch.kernels.page_gather import page_gather, page_gather_plain
    gen = torch.Generator(device="cpu").manual_seed(3)
    P = store.shape[0]
    cases = [("store/all-permuted", store, torch.randperm(P, generator=gen)),
             ("store/span", store, torch.arange(min(5, P), min(80, P))),
             ("store/repeats", store, torch.randint(0, P, (17,), generator=gen))]
    for dtype in (torch.float32, torch.int32, torch.bfloat16):
        for (p, e, k) in [(64, 256, 20), (16, 128, 16), (8, 512, 1)]:
            pool = (torch.randn((p, e), generator=gen) * 10).to(dtype).to(device)
            cases.append((f"{dtype}/({p},{e})x{k}", pool,
                          torch.randint(0, p, (k,), generator=gen)))
    odd = torch.randint(0, 256, (9, 1000 * 4 + 3), dtype=torch.uint8,
                        generator=gen).to(device)           # byte tail, unaligned rows
    cases.append(("uint8/odd-row", odd, torch.tensor([8, 0, 3, 3, 7])))
    big = torch.randint(0, 256, (5, 4 * 2**20 + 16), dtype=torch.uint8,
                        generator=gen).to(device)           # a last bulk item of 16 B
    cases.append(("uint8/4MiB+16", big, torch.tensor([4, 1, 1, 0, 3, 2])))
    small = torch.randint(0, 256, (40, 48), dtype=torch.uint8, generator=gen).to(device)
    cases.append(("uint8/48B-rows", small, torch.randint(0, 40, (64,), generator=gen)))
    flat = torch.randint(0, 256, (1 + 12 * 4096,), dtype=torch.uint8, generator=gen)
    cases.append(("uint8/unaligned-view", flat.to(device)[1:].view(12, 4096),
                  torch.tensor([3, 3, 0, 11, 5, 3])))
    for name, pool, ids in cases:
        for where in ("host ids", "device ids"):
            ids_in = ids.to(torch.int32)
            if where == "device ids":
                ids_in = ids_in.to(device)
            out = page_gather(pool, ids_in)
            ref = page_gather_plain(pool, ids.to(device))
            sync(device)
            expect(out.dtype == ref.dtype and out.shape == ref.shape
                   and torch.equal(out.view(torch.uint8), ref.view(torch.uint8)),
                   f"page_gather {name} ({where}) is not bitwise equal to pool[ids]")
    errs["page_gather"] = 0.0
    log(f"[3] page_gather: {2 * len(cases)} cases bitwise equal "
        f"(incl. 4 MiB rows of the qwen store, {P} pages)")


def check_flash(device, errs: dict) -> None:
    import torch
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_plain
    gen = torch.Generator(device=device).manual_seed(7)
    cases = []
    for dtype in (torch.float32, torch.bfloat16):
        for (B, H, Hkv, S, d, causal, window, cap) in FLASH_SWEEP:
            cases.append((dtype, B, H, Hkv, S, S, d, causal, window, cap))
        for (B, H, Hkv, S, d) in FLASH_MAIN:
            cases.append((dtype, B, H, Hkv, S, S, d, True, None, None))
        cases.append((dtype, 1, 4, 2, 100, 150, 64, True, None, None))   # Sq != Sk
        cases.append((dtype, 1, 4, 2, 150, 100, 64, True, None, None))
        cases.append((dtype, 1, 2, 2, 70, 70, 64, True, 0, None))        # all masked
        cases.append((dtype, 1, 2, 1, 90, 130, 256, True, 0, None))
        B, H, Hkv, S, d, window = FLASH_GRIFFIN
        cases.append((dtype, B, H, Hkv, S, S, d, True, window, None))
        B, H, Hkv, S, d = FLASH_QWEN3
        cases.append((dtype, B, H, Hkv, S, S, d, True, None, None))
        cases.append((dtype, 2, 8, 2, 333, 333, 128, True, None, 50.0))
        cases.append((dtype, 1, 4, 2, 517, 517, 256, True, 200, None))
        B, H, Hkv, S, d, window = FLASH_H2O                           # d = 120
        cases.append((dtype, B, H, Hkv, S, S, d, True, window, None))
        cases.append((dtype, 2, 8, 2, 300, 300, 120, True, 100, 30.0))
        B, H, Hkv, S, d = FLASH_ENCODER
        cases.append((dtype, B, H, Hkv, S, S, d, False, None, None))
        B, H, Hkv, Sq, Sk, d = FLASH_CROSS
        cases.append((dtype, B, H, Hkv, Sq, Sk, d, False, None, None))
        B, H, Hkv, S, d = FLASH_GRANITE                               # g = 3
        cases.append((dtype, B, H, Hkv, S, S, d, True, None, None))
        cases.append((dtype, 1, 14, 2, 320, 320, 64, True, None, None))     # g = 7
        B, H, Hkv, S, d = FLASH_MOONSHOT
        cases.append((dtype, B, H, Hkv, S, S, d, True, None, None))
        B, H, Hkv, S, d = FLASH_REDUCED                               # d = 16
        cases.append((dtype, B, H, Hkv, S, S, d, True, None, None))
        cases.append((dtype, 2, 4, 2, 200, 200, d, True, None, None))
    worst = 0.0
    # this slice's timed shapes: (path, dtype the path runs, B, H, Hkv, Sq, Sk, d)
    timed = [("h2o", torch.bfloat16, *FLASH_H2O[:4], *FLASH_H2O[3:5]),
             ("whisper", torch.float32, *FLASH_ENCODER[:4], *FLASH_ENCODER[3:]),
             ("whisper", torch.float32, *FLASH_CROSS),
             ("granite", torch.float32, *FLASH_GRANITE[:4], *FLASH_GRANITE[3:])]
    for (dtype, B, H, Hkv, Sq, Sk, d, causal, window, cap) in cases:
        q = torch.randn((B, H, Sq, d), generator=gen, device=device).to(dtype)
        k = torch.randn((B, Hkv, Sk, d), generator=gen, device=device).to(dtype)
        v = torch.randn((B, Hkv, Sk, d), generator=gen, device=device).to(dtype)
        out = flash_attention(q, k, v, causal=causal, window=window, softcap=cap)
        ref = flash_attention_plain(q, k, v, causal=causal, window=window, softcap=cap)
        sync(device)
        tol = TOL[str(dtype).split(".")[1]]
        diff = (out.float() - ref.float()).abs()
        err = float(diff.max())
        ok = bool(torch.isfinite(out.float()).all()) and bool(
            (diff <= tol + tol * ref.float().abs()).all())
        label = (f"{str(dtype).split('.')[1]} B{B} H{H}/{Hkv} Sq{Sq} Sk{Sk} d{d} "
                 f"causal={causal} window={window} softcap={cap}")
        expect(ok, f"flash_attention {label}: max |err| {err} over tolerance {tol}")
        if (B, H, Hkv, d) in [(1, 16, 16, 64), (1, 8, 4, 64)] and Sq in QWEN_SEQS \
                and dtype == torch.bfloat16:
            worst = max(worst, err)
        for path, dt, *shape in timed:
            if (dtype, B, H, Hkv, Sq, Sk, d) == (dt, *shape):
                key = f"flash_attention:{path}"
                errs[key] = max(errs.get(key, 0.0), err)
        log(f"[3] flash_attention {label}: max |err| {err:.3e} (tol {tol})")
    errs["flash_attention"] = worst


def _decode_masks(gen, B, S, device):
    """An (S,) random mask, a (B, S) ring mask with a window (rows at other
    depths, some wrapped), the same with its last row all invalid, a short
    filled prefix in the long cache (a live extent far below S), a wrapped
    ring valid at both ends of every row, and every slot valid (cross
    attention)."""
    import torch
    shared = torch.rand((S,), generator=gen, device=device) < 0.7
    shared[0] = True
    k_pos = torch.full((B, S), -1, dtype=torch.int64, device=device)
    for b in range(B):
        n = int(torch.randint(1, 3 * S // 2, (1,), generator=gen, device=device))
        pos = torch.arange(max(0, n - S), n, device=device)
        k_pos[b, pos % S] = pos
    now = k_pos.max(1, keepdim=True).values
    ring = (k_pos >= 0) & (k_pos <= now) & (now - k_pos < max(S // 3, 1))
    empty = ring.clone()
    empty[-1] = False
    slots = torch.arange(S, device=device)[None, :]
    short = slots < torch.randint(1, 48, (B, 1), generator=gen, device=device)
    wrapped = ((slots < S // 5) | (slots >= S - S // 3)).expand(B, S).contiguous()
    return [("shared", shared), ("ring", ring), ("row-empty", empty),
            ("short-prefix", short), ("wrapped", wrapped),
            ("all-valid", torch.ones((S,), dtype=torch.bool, device=device))]


def check_decode(device, errs: dict) -> None:
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    gen = torch.Generator(device=device).manual_seed(17)
    worst: dict = {}
    shapes = DECODE_SWEEP + [(*shape, None) for shape, _ in DECODE_TIMED.values()]
    shapes.append((2, 21, 3, 300, 120, 50.0))                       # d = 120, g = 7
    shapes.append((*DECODE_REDUCED, None))                          # d = 16, g = 2
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for (B, H, Hkv, S, d, cap) in shapes:
            q = torch.randn((B, H, d), generator=gen, device=device).to(dtype)
            k = torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
            v = torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
            for mname, valid in _decode_masks(gen, B, S, device):
                out = decode_attention(q, k, v, valid, softcap=cap)
                ref = decode_attention_plain(q, k, v, valid, softcap=cap)
                sync(device)
                diff = (out.float() - ref.float()).abs()
                err = float(diff.max())
                ok = bool(torch.isfinite(out.float()).all()) and bool(
                    (diff <= tol + tol * ref.float().abs()).all())
                label = (f"{str(dtype).split('.')[1]} B{B} H{H}/{Hkv} S{S} d{d} "
                         f"softcap={cap} mask={mname}")
                expect(ok, f"decode_attention {label}: max |err| {err} over "
                       f"tolerance {tol}")
                for name, (shape, dt) in DECODE_TIMED.items():
                    if (B, H, Hkv, S, d) == shape and str(dtype) == f"torch.{dt}":
                        worst[name] = max(worst.get(name, 0.0), err)
                n += 1
                log(f"[3] decode_attention {label}: max |err| {err:.3e} (tol {tol})")
    for name, err in worst.items():
        errs[f"decode_attention:{name}"] = err
    log(f"[3] decode_attention: {n} cases within tolerance")


def check_decode_lse(device) -> None:
    """decode_attention's lse output at phase 18's position-split blocks
    (DECODE_LSE): a block holding a live prefix and a block holding no live
    slot, each against the plain version (out within TOL, lse within
    LSE_TOL), and the empty block's weight in the merge, exp(lse_empty -
    lse_live), exactly 0."""
    import torch
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    gen = torch.Generator(device=device).manual_seed(18)
    for dtype in (torch.float32, torch.bfloat16):
        tol = TOL[str(dtype).split(".")[1]]
        for (B, H, Hkv, S, d, live) in DECODE_LSE:
            q = torch.randn((B, H, d), generator=gen, device=device).to(dtype)
            lse_of = {}
            for name in ("live", "empty"):
                k = torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
                v = torch.randn((B, Hkv, S, d), generator=gen, device=device).to(dtype)
                valid = (torch.arange(S, device=device) < (live if name == "live" else 0)
                         ).expand(B, S).contiguous()
                out, lse = decode_attention(q, k, v, valid, return_lse=True)
                ref, ref_lse = decode_attention_plain(q, k, v, valid, return_lse=True)
                sync(device)
                err = float((out.float() - ref.float()).abs().max())
                lse_err = float(((lse - ref_lse).abs()
                                 / (LSE_TOL[0] + LSE_TOL[1] * ref_lse.abs())).max())
                label = (f"{str(dtype).split('.')[1]} B{B} H{H}/{Hkv} S{S} d{d} block={name}")
                expect(bool(torch.isfinite(out.float()).all()) and err <= tol + tol * float(
                    ref.float().abs().max()), f"decode_attention lse {label}: out |err| {err}")
                expect(lse_err <= 1.0, f"decode_attention lse {label}: lse off by {lse_err} "
                       f"of its tolerance {LSE_TOL}")
                lse_of[name] = lse
                log(f"[3] decode_attention lse {label}: out max |err| {err:.3e}, lse "
                    f"{float(lse.min()):.4g}..{float(lse.max()):.4g}, {lse_err:.3f} of "
                    f"tolerance")
            w = torch.exp(lse_of["empty"] - lse_of["live"])
            expect(bool((w == 0).all()), f"decode_attention lse B{B} H{H}/{Hkv} S{S} d{d}: "
                   f"an empty block weighs up to {float(w.max())} beside a live one")


#: ssm_terms' checks (B, S, d_inner, state, dt_rank): falcon-mamba-7b's SSM
#: chunk, a ragged last chunk and a decode step
SSM_TERMS_MAIN = [(1, 256, 8192, 16, 256), (1, 203, 8192, 16, 256), (1, 1, 8192, 16, 256)]


def check_ssm_terms(device, errs: dict) -> None:
    """a and b bitwise equal to the plain version's, from the inputs in the
    layouts the model hands over: x in the conv's (B, d_inner, S) memory
    layout, B a view of x_proj's product."""
    import torch
    from repro_torch.kernels.ssm_terms import ssm_terms, ssm_terms_plain
    gen = torch.Generator(device=device).manual_seed(29)
    for B, S, di, n, r in SSM_TERMS_MAIN:
        raw = (torch.randn((B, S, di), generator=gen, device=device) * 4).bfloat16()
        x = torch.randn((B, di, S), generator=gen, device=device).bfloat16().transpose(1, 2)
        proj = torch.randn((B, S, r + 2 * n), generator=gen, device=device).bfloat16()
        dt_bias = torch.rand(di, generator=gen, device=device) * 4 - 7
        A_log = torch.log(torch.arange(1, n + 1, device=device, dtype=torch.float32)
                          ).repeat(di, 1)
        args = (raw, dt_bias, A_log, x, proj[..., r:r + n])
        before = ssm_terms.launches
        got, want = ssm_terms(*args), ssm_terms_plain(*args)
        sync(device)
        expect(ssm_terms.launches == before + 1, f"ssm_terms S{S} was not launched")
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        bitwise = all(torch.equal(g, w) for g, w in zip(got, want))
        expect(bitwise, f"ssm_terms B{B} S{S} di{di} n{n}: max |err| {err}, not bitwise equal")
        errs["ssm_terms"] = max(errs.get("ssm_terms", 0.0), err)
        log(f"[3] ssm_terms B{B} S{S} di{di} n{n}: bitwise equal {bitwise}")


def check_diag_recurrence(device, errs: dict) -> None:
    """The reference's sweep and the model shapes on the route the planner
    picks there (asserted for the model shapes): within 1e-4 of the plain
    version, and bitwise equal to it on the sequential route."""
    import torch
    from repro_torch.kernels.diag_recurrence import diag_recurrence, diag_recurrence_plain
    from repro_torch.kernels.diag_recurrence.ops import plan_recurrence
    gen = torch.Generator(device=device).manual_seed(19)
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    for (B, S, C) in RECURRENCE_SWEEP + list(RECURRENCE_MAIN):
        a = torch.rand((B, S, C), generator=gen, device=device) * 0.5 + 0.5
        b = torch.randn((B, S, C), generator=gen, device=device)
        h0 = torch.randn((B, C), generator=gen, device=device)
        route = plan_recurrence(B, S, C, n_sms).route
        before = diag_recurrence.launches_by_route[route]
        h_all, h_final = diag_recurrence(a, b, h0)
        ref_all, ref_final = diag_recurrence_plain(a, b, h0)
        sync(device)
        expect(diag_recurrence.launches_by_route[route] == before + 1,
               f"diag_recurrence B{B} S{S} C{C} did not launch its {route} route")
        expect(RECURRENCE_MAIN.get((B, S, C), route) == route,
               f"diag_recurrence B{B} S{S} C{C} planned {route}, want "
               f"{RECURRENCE_MAIN.get((B, S, C))}")
        err = 0.0
        for out, ref in ((h_all, ref_all), (h_final, ref_final)):
            diff = (out - ref).abs()
            err = max(err, float(diff.max()))
            expect(bool(torch.isfinite(out).all()) and bool(
                (diff <= RECURRENCE_TOL + RECURRENCE_TOL * ref.abs()).all()),
                f"diag_recurrence B{B} S{S} C{C}: max |err| {err} over {RECURRENCE_TOL}")
        expect(torch.equal(h_final, h_all[:, -1]), "h_final is not h_all[:, -1]")
        bitwise = torch.equal(h_all, ref_all) and torch.equal(h_final, ref_final)
        expect(route != "sequential" or bitwise,
               f"diag_recurrence B{B} S{S} C{C}: the sequential route is not bitwise equal")
        for name, shape in RECURRENCE_TIMED.items():
            if (B, S, C) == shape:
                errs[f"diag_recurrence:{name}"] = err
        log(f"[3] diag_recurrence B{B} S{S} C{C} on {route} (h0 != 0): max |err| {err:.3e} "
            f"(tol {RECURRENCE_TOL}); bitwise equal {bitwise}")


# ---------------------------------------------------------------------------------
# 4. the quickstart loop
# ---------------------------------------------------------------------------------

def counted(builder, counts: dict, key: str):
    def build():
        counts[key] = counts.get(key, 0) + 1
        return builder()
    return build


def phase_quickstart(device, tmp: str) -> dict:
    import torch
    from repro_torch.core import (ColdStartConfig, ColdStartOrchestrator,
                                  DependencyManager, FunctionRegistry, RestorePolicy)
    from repro_torch.core import workloads as wl
    from repro_torch.kernels import flash_attention, page_gather

    manager = DependencyManager(disk_dir=f"{tmp}/pool", device=device)
    registry = FunctionRegistry(store_dir=f"{tmp}/store")
    builds: dict = {}
    for image_id in wl.IMAGE_CONFIGS:
        builder = counted(wl.model_params_builder(image_id, device=device), builds,
                          image_id)
        execs = wl.make_model_executables(image_id)
        manager.register_image(image_id, image_id, builder, executables=execs)
    for fn in ("lr_serving", "cnn_serving", "rnn_serving"):
        w = wl.WORKLOADS[fn]
        for tenant in ("a", "b"):
            fn_id = f"{fn}-{tenant}"
            registry.register(
                fn_id, w.image_id,
                wl._head_builder(w.image_id, seed=zlib.crc32(fn_id.encode()) % 100),
                w.handler_fn, base_params_builder=wl.model_params_builder(
                    w.image_id, device=device),
                write_baseline_checkpoint=True)
    orch = ColdStartOrchestrator(manager, registry, ColdStartConfig())
    log(f"[4] pool: {manager.summary()['live_images']} "
        f"({manager.pool_bytes() / 1e6:.1f} MB live on {device})")

    reset_counts([page_gather, flash_attention])
    for fn_id in registry.list():
        req = wl.default_request()
        classes = {}
        inst, t = orch.cold_start_baseline(fn_id)
        classes["baseline"] = inst.invoke(req)[0]
        log(f"[4] {fn_id} baseline: {json.dumps(t.as_dict())}")
        for policy in RestorePolicy:
            inst, t = orch.cold_start_warmswap(fn_id, policy)
            classes[f"warmswap/{policy.value}"] = inst.invoke(req)[0]
            log(f"[4] {fn_id} warmswap/{policy.value}: {json.dumps(t.as_dict())}")
        orch.prebake(fn_id)
        inst, t = orch.cold_start_prebaked(fn_id)
        classes["prebaked"] = inst.invoke(req)[0]
        log(f"[4] {fn_id} prebaked: {json.dumps(t.as_dict())}")
        first = classes["baseline"]
        for path, c in classes.items():
            expect(c.shape == first.shape and (c == first).all(),
                   f"{fn_id}: {path} classes {c} differ from baseline {first}")
        log(f"[4] {fn_id}: classes {first.tolist()} equal on all 6 start paths")
    sync(device)
    counts = {"page_gather": page_gather.launches,
              "flash_attention": flash_attention.launches}
    log(f"[4] pool live bytes {manager.pool_bytes()}; "
        f"prebaked bytes {orch.prebaked_bytes()}")
    for image_id in wl.IMAGE_CONFIGS:
        log(f"[4] {image_id}: image initialized {builds.get(image_id, 0)} time(s)")
        expect(builds.get(image_id) == 1, f"{image_id} was initialized "
               f"{builds.get(image_id, 0)} times, want 1")
    log(f"[4] launches during the quickstart loop: {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the quickstart loop")
    expect_route("4", "quickstart loop", "tc_bf16")
    return counts


# ---------------------------------------------------------------------------------
# 5. qwen1.5-0.5b at full width
# ---------------------------------------------------------------------------------

def _prefill_handler(cfg):
    """A serving tenant's handler: prefill_logits (forward at B=1, the last
    position's logits) through the tenant's 16-class head."""
    def handler(params, hw, request, execs):
        import torch
        from repro_torch.models.transformer import forward
        dev = params["embed"]["tok"].device
        tokens = torch.as_tensor(request["tokens"], dtype=torch.int64, device=dev)
        logits = forward(params, tokens, cfg, logits_slice=1)[:, -1]
        w = torch.as_tensor(hw["w"], device=dev)
        return torch.argmax(logits @ w + torch.as_tensor(hw["bias"], device=dev),
                            dim=-1).cpu().numpy()
    return handler


def phase_qwen_setup(device):
    import torch
    from repro_torch.configs.qwen1_5_0_5b import CONFIG
    from repro_torch.core import DependencyManager
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.transformer import init_params

    cfg = CONFIG
    keep: dict = {}

    def builder():
        gen = torch.Generator(device=device).manual_seed(0)
        keep["params"] = init_params(gen, cfg, torch.bfloat16)
        return keep["params"]

    manager = DependencyManager(device=device)
    t0 = time.perf_counter()
    manager.register_image(cfg.name, cfg.name, builder)
    sync(device)
    img = manager._ensure_live(cfg.name)
    table = img.metadata.page_table
    log(f"[3] {cfg.name} image for the checks: {cfg.n_layers} layers d_model {cfg.d_model} "
        f"{cfg.n_heads}x{cfg.resolved_head_dim} heads d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} -> {padded_vocab(cfg)}; payload {table.nbytes_payload} B in "
        f"{table.n_pages} pages of {table.page_size} B ({img.image_bytes} B on device); "
        f"built in {time.perf_counter() - t0:.2f} s")
    expect(padded_vocab(cfg) == 152_064, "qwen vocab must pad to 152,064")
    return cfg, manager, img, keep["params"]


def phase_qwen(cfg, manager, img, original, device) -> dict:
    import torch
    from repro_torch.core import RestorePolicy
    from repro_torch.core.pages import byte_view
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.kernels import flash_attention, page_gather
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.transformer import forward

    gen = torch.Generator(device=device).manual_seed(11)
    tokens = {s: torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=device)
              for s in QWEN_SEQS}
    ref_leaves = dict(flatten_with_keys(original))
    reset_counts([page_gather, flash_attention])
    restored = {}
    for policy in (RestorePolicy.BULK, RestorePolicy.NO_PAGESERVER):
        t0 = time.perf_counter()
        r = manager.request_migration(cfg.name, policy)
        r.fault(r.metadata.page_table.order[0])
        params = r.as_pytree()
        sync(device)
        dt = time.perf_counter() - t0
        manager.release(cfg.name)
        got = dict(flatten_with_keys(params))
        expect(got.keys() == ref_leaves.keys(), f"{policy.value}: leaf keys differ")
        for key, leaf in got.items():
            ref = ref_leaves[key]
            expect(leaf.dtype == ref.dtype and leaf.shape == ref.shape
                   and torch.equal(byte_view(leaf), byte_view(ref)),
                   f"{policy.value}: restored leaf {key} is not bitwise equal")
        log(f"[5] {policy.value}: {len(got)} leaves restored bitwise equal in "
            f"{dt * 1e3:.1f} ms ({r.stats})")
        restored[policy] = params
    for s in QWEN_SEQS:
        out = {}
        for policy, params in restored.items():
            out[policy] = forward(params, tokens[s], cfg)
        ref = forward(original, tokens[s], cfg)
        sync(device)
        for policy, logits in out.items():
            expect(torch.equal(logits, ref), f"S={s}: logits from {policy.value} "
                   "pages differ from the logits before paging")
        expect(ref.shape == (1, s, 152_064) and bool(torch.isfinite(ref).all()),
               f"S={s}: logits not finite or of shape {tuple(ref.shape)}")
        log(f"[5] S={s}: logits {tuple(ref.shape)} equal (torch.equal) for restored "
            f"and original params")
    counts = {"page_gather": page_gather.launches,
              "flash_attention": flash_attention.launches}
    log(f"[5] launches during the qwen path: {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the qwen path")
    expect_route("5", "qwen path", "tc_bf16")

    # kernel path vs plain path on the card (not counted: checks only)
    for s in QWEN_SEQS:
        k_logits = forward(original, tokens[s], cfg)
        p_logits = forward(original, tokens[s], cfg, attention_fn=flash_attention_plain)
        diff = float((k_logits - p_logits).abs().max())
        scale = float(p_logits.abs().max())
        agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
        log(f"[5] S={s}: kernel vs plain forward max |dlogit| {diff:.4e} "
            f"(max |logit| {scale:.4e}, ratio {diff / scale:.3e}); argmax agreement "
            f"{agree:.4f}")
        expect(diff <= 5e-2 * scale, f"S={s}: kernel path differs from plain path "
               f"by {diff} > 5e-2 * max|logit|")
    return counts


def phase_coldstart(cfg, manager, tmp: str, tag: str, name: str,
                    baseline_rounds: int = 3, page_model=None) -> dict:
    """Cold starts of one tenant on ``cfg``'s live image through the
    orchestrator: warmswap under BULK and NO_PAGESERVER, median of 3, and
    baseline (the tenant's checkpoint read from disk) ``baseline_rounds``
    times. Every start's classes must agree. With ``page_model`` the output
    also holds ``predicted``: the model's cold latency for warmswap and
    baseline at tier ``local``, priced on the live image's size."""
    import numpy as np
    from repro_torch.core import (ColdStartConfig, ColdStartOrchestrator,
                                  FunctionRegistry, RestorePolicy)
    from repro_torch.core import workloads as wl
    from repro_torch.models.layers import padded_vocab

    registry = FunctionRegistry(store_dir=f"{tmp}/{name}-store")
    img = manager._ensure_live(cfg.name)
    fn_id = f"{name}-tenant"

    def head():
        rng = np.random.default_rng(5)
        return {"w": (rng.normal(size=(padded_vocab(cfg), 16))
                      / np.sqrt(cfg.d_model)).astype(np.float32),
                "bias": np.zeros((16,), np.float32)}

    def request():
        return {"tokens": np.random.default_rng(7).integers(
            0, min(1000, cfg.vocab_size), (1, 64), dtype=np.int32)}

    handler = _prefill_handler(cfg)
    if fn_id not in wl.WORKLOADS:              # its first request comes from here
        wl.WORKLOADS.register(fn_id, wl.Workload(fn_id, cfg.name, handler, head, request))
    free = shutil.disk_usage(tmp).free
    if free < 2 * img.image_bytes:
        log(f"[{tag}] {name}: baseline not measured: {free} B free under {tmp}, the "
            f"checkpoint needs about {img.image_bytes} B")
        baseline_rounds = 0
    t0 = time.perf_counter()
    registry.register(fn_id, cfg.name, head, handler, base_params_builder=img.params,
                      write_baseline_checkpoint=baseline_rounds > 0)
    ckpt = registry.get(fn_id).checkpoint_path
    if ckpt:
        log(f"[{tag}] {name}: baseline checkpoint of {os.path.getsize(ckpt)} B written "
            f"in {time.perf_counter() - t0:.2f} s ({free} B were free)")
    orch = ColdStartOrchestrator(manager, registry, ColdStartConfig())
    predicted = ({m: orch.predicted_cold_latency_s(fn_id, page_model, m, tier="local")
                  for m in ("warmswap", "baseline")} if page_model is not None else None)
    req = request()
    totals = {"baseline": [], "warmswap/bulk": [], "warmswap/no_pageserver": []}
    classes = []
    for rnd in range(3):
        if rnd < baseline_rounds:
            inst, t = orch.cold_start_baseline(fn_id)
            totals["baseline"].append(t.total)
            classes.append(inst.invoke(req)[0])
            log(f"[{tag}] {name} run {rnd} baseline: {json.dumps(t.as_dict())}")
            del inst
        for policy in (RestorePolicy.BULK, RestorePolicy.NO_PAGESERVER):
            inst, t = orch.cold_start_warmswap(fn_id, policy)
            totals[f"warmswap/{policy.value}"].append(t.total)
            classes.append(inst.invoke(req)[0])
            log(f"[{tag}] {name} run {rnd} warmswap/{policy.value}: "
                f"{json.dumps(t.as_dict())} {inst.migration_stats}")
            del inst
    if ckpt:
        os.remove(ckpt)
    expect(all((c == classes[0]).all() for c in classes),
           f"{name} cold starts disagree on classes")
    out = {k: statistics.median(v) for k, v in totals.items() if v}
    log(f"[{tag}] {name} cold start totals, median of 3 (baseline: of "
        f"{baseline_rounds}) (s): {json.dumps(out)}; all runs {json.dumps(totals)}")
    if predicted is not None:
        out["predicted"] = predicted
    return out


# ---------------------------------------------------------------------------------
# 7. serving qwen3-1.7b at full width
# ---------------------------------------------------------------------------------

def _teacher_forced(params, cfg, prompt, tokens, attention_fn, decode_fn,
                    recurrence_fn, device):
    """Logits (len(tokens), vocab) of the prompt's prefill and of decode steps
    fed ``tokens[:-1]``, on one path (kernels or their plain versions)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import decode_step, forward
    toks = torch.as_tensor(prompt[None], dtype=torch.int64, device=device)
    logits, st = forward(params, toks, cfg, make_state=True, state_len=SERVE_SEQ,
                         logits_slice=1, attention_fn=attention_fn,
                         recurrence_fn=recurrence_fn)
    rows = [logits[0, -1, : cfg.vocab_size].cpu().numpy()]
    for tok in tokens[:-1]:
        lg, st = decode_step(params, st, torch.tensor([[tok]], device=device), cfg,
                             decode_fn=decode_fn)
        rows.append(lg[0, : cfg.vocab_size].cpu().numpy())
    return np.stack(rows)


def _agree_until_divergence(ref_req, req, tol_rel: float):
    """Compare two runs of one request token by token: logits within
    ``tol_rel`` of max |logit| while both saw the same tokens; where a token
    differs, the two tokens must be a near tie in the reference's logits
    (within twice the tolerance), and the rest of the request is conditioned
    on other tokens and not compared. Returns (max |d logit|, steps compared,
    diverged)."""
    import numpy as np
    worst, n = 0.0, 0
    for t, (a, b) in enumerate(zip(ref_req.logits, req.logits)):
        tol = tol_rel * float(np.abs(a).max())
        d = float(np.abs(a - b).max())
        expect(d <= tol, f"request {req.rid} step {t}: |d logit| {d} > {tol}")
        worst, n = max(worst, d), n + 1
        ta, tb = ref_req.tokens[t], req.tokens[t]
        if ta != tb:
            expect(abs(float(a[ta]) - float(a[tb])) <= 2 * tol,
                   f"request {req.rid} step {t}: tokens {ta} != {tb} without a tie")
            return worst, n, True
    return worst, n, False


def profile_decode(eng, device, tag: str, n_steps: int = 3) -> None:
    """torch.profiler over ``n_steps`` decode steps of an engine's state at
    its full slot count (as the engine runs one, logits copied to the host):
    device busy time against the host's wall clock, and the kernels that take
    it. Measures only; the state is left advanced, its slots idle."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.api import make_serve_step_with_logits
    step = make_serve_step_with_logits(eng.cfg)
    tok = torch.zeros((eng.scfg.max_slots, 1), dtype=torch.int64, device=device)
    logits, eng.state = step(eng.params, eng.state, tok)          # warm-up
    np.asarray(logits.cpu())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            logits, eng.state = step(eng.params, eng.state, tok)
            np.asarray(logits.cpu())
        wall = time.perf_counter() - t0
    kernels: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    busy = sum(kernels.values())
    if not kernels:
        log(f"[{tag}] decode step profile: the profiler saw no kernels; device time not "
            "measured")
        return
    n_launch = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    log(f"[{tag}] decode step profile ({n_steps} steps, {eng.scfg.max_slots} slots): wall "
        f"{wall * 1e3 / n_steps:.3f} ms/step, device busy {busy / n_steps:.3f} ms/step "
        f"(idle share {1 - busy / (wall * 1e3):.4f}), {n_launch / n_steps:.0f} kernels "
        f"per step")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag}]   {ms / n_steps:.4f} ms/step  {name[:110]}")


def phase_serving(device, arch: str, tag: str) -> dict:
    """Serve ``arch`` at full width (fp32) through a 2-replica ReplicaSet from
    the pool, kill and recover one replica, and check the logits."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import DependencyManager, RestorePolicy
    from repro_torch.core.tree import flatten_with_keys, nest
    from repro_torch.kernels import decode_attention, diag_recurrence, flash_attention
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.diag_recurrence import diag_recurrence_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import KVCache, decode_valid
    from repro_torch.models.config import LOCAL_ATTN
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.moe import expert_capacity
    from repro_torch.models.transformer import decode_step, forward, init_params
    from repro_torch.runtime import ReplicaSet
    from repro_torch.serving import ServeConfig, ServingEngine
    from repro_torch.serving.scheduler import PlacementContext, place_invocation

    cfg = get_config(arch)
    kernels = {k: v for k, v in kernel_fns().items() if k in SERVING_KERNELS[arch]}

    def builder():
        return init_params(torch.Generator(device=device).manual_seed(0), cfg,
                           torch.float32)

    manager = DependencyManager(device=device)
    t0 = time.perf_counter()
    manager.register_image(cfg.name, cfg.name, builder)
    sync(device)
    table = manager._ensure_live(cfg.name).metadata.page_table
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers {cfg.attn_pattern} d_model "
        f"{cfg.d_model} heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} d_ff "
        f"{cfg.d_ff} vocab "
        f"{cfg.vocab_size} -> {padded_vocab(cfg)}, fp32: payload {table.nbytes_payload} B "
        f"in {table.n_pages} pages ({manager.pool_bytes()} B live on the card), built "
        f"in {time.perf_counter() - t0:.2f} s")
    scfg = ServeConfig(max_slots=SERVE_SLOTS, max_seq_len=SERVE_SEQ,
                       max_new_tokens=SERVE_NEW, keep_logits=True)
    # the model store a cold replica loads from: the weights in host memory,
    # the fastest store there is (no disk read, no deserialization)
    store = {k: v.cpu() for k, v in flatten_with_keys(builder())}

    def make_engine(mgr, image_id, c, method):
        if method == "warmswap":
            eng = ServingEngine.from_pool(mgr, image_id, c, scfg,
                                          policy=RestorePolicy.BULK)
        else:
            eng = ServingEngine(c, nest({k: v.to(device) for k, v in store.items()}),
                                scfg)
        sync(device)
        return eng

    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, cfg.vocab_size, int(n))
               for n in rng.integers(SERVE_PROMPTS[0], SERVE_PROMPTS[1] + 1,
                                     SERVE_REQUESTS)]

    # ---- the main path, counted
    reset_counts(kernels.values())
    rs = ReplicaSet(manager, cfg.name, cfg, make_engine, n_replicas=2)
    names = sorted(rs.replicas)
    for e in rs.events:
        log(f"[{tag}] {e.replica} up via {e.method} in {e.seconds:.4f} s")
    placed = {n: [] for n in names}
    for i in range(len(prompts)):
        placed[place_invocation(names, PlacementContext(
            load=lambda n: len(placed[n])))].append(i)
    served, decode_s, ttft, total_tokens = {}, [], [], 0
    t_serve = time.perf_counter()
    for name in names:                    # the replicas take turns on the one card
        eng = rs.replicas[name]
        t1 = time.perf_counter()
        rids = [eng.submit(prompts[i]) for i in placed[name]]
        while not eng.idle():
            before = eng.pending
            ts = time.perf_counter()
            eng.step()
            if eng.pending == before:              # no admission: a pure decode step
                decode_s.append(time.perf_counter() - ts)
        dt = time.perf_counter() - t1
        m = eng.metrics()
        toks = sum(len(r.tokens) for r in eng.completed.values())
        total_tokens += toks
        ttft += [r.ttft_s for r in eng.completed.values()]
        log(f"[{tag}] {name}: {m['completed']} requests (prompts "
            f"{[len(prompts[i]) for i in placed[name]]}), {toks} tokens in {dt:.3f} s "
            f"({toks / dt:.1f} tok/s), {m['engine_steps']} steps, mean ttft "
            f"{m['mean_ttft_s'] * 1e3:.1f} ms, mean latency {m['mean_latency_s'] * 1e3:.1f} ms")
        served.update((i, eng.completed[rid]) for i, rid in zip(placed[name], rids))
    serve_s = time.perf_counter() - t_serve
    expect(len(served) == SERVE_REQUESTS and all(
        len(r.tokens) == SERVE_NEW and np.isfinite(np.stack(r.logits)).all()
        for r in served.values()), "not every request completed with finite logits")
    victim = names[0]
    rs.kill(victim)
    expect(victim not in rs.replicas, f"{victim} survived kill()")
    warm_s = rs.recover(victim, method="warmswap")
    rs.kill(victim)
    cold_s = rs.recover(victim, method="baseline")
    eng = rs.replicas[victim]
    rid = eng.submit(prompts[0][:SERVE_PROMPTS[0]])
    eng.run_until_done()
    sync(device)
    expect(len(eng.completed[rid].tokens) == SERVE_NEW, "recovered replica did not serve")
    counts = {k: v.launches for k, v in kernels.items()}
    log(f"[{tag}] launches during the serving path: {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the serving path")
    flash_routes = expect_route(tag, "serving path (fp32)", "cuda_core")
    routes = None
    if "diag_recurrence" in kernels:     # every RG-LRU prefill is B=1: too few channels
        routes = expect_route(tag, "serving path (fp32)", "chunked", kernel="diag_recurrence")
    out = {"counts": counts, "diag_routes": routes, "flash_routes": flash_routes,
           "ttft_ms": statistics.mean(ttft) * 1e3,
           "decode_step_ms": statistics.median(decode_s) * 1e3,
           "tokens_per_s": total_tokens / serve_s, "recover_warmswap_s": warm_s,
           "recover_baseline_s": cold_s}
    log(f"[{tag}] serving {cfg.name} fp32, 2 replicas x {SERVE_SLOTS} slots: mean ttft "
        f"{out['ttft_ms']:.2f} ms, decode step {out['decode_step_ms']:.3f} ms (median of "
        f"{len(decode_s)} steps at up to {SERVE_SLOTS} slots), {out['tokens_per_s']:.1f} "
        f"tok/s overall; recovery warmswap {warm_s:.4f} s vs baseline {cold_s:.4f} s "
        f"(x{cold_s / warm_s:.2f})")

    # ---- checks, not counted
    params = rs.replicas[names[1]].params
    moe = cfg.n_experts > 0
    S, K = MOE_SHORT if moe else (SERVE_PROMPTS[0], 8)
    if moe:                               # no expert reaches capacity: no drop
        expect(expert_capacity(cfg, S + K) == S + K and expert_capacity(cfg, S) == S,
               f"{cfg.name}: a prompt of {S} + {K} tokens can fill an expert")
    seq = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, S + K)), device=device)
    full = forward(params, seq, cfg)[0]
    _, st = forward(params, seq[:, :S], cfg, make_state=True, state_len=SERVE_SEQ)
    worst = 0.0
    for i in range(K):
        lg, st = decode_step(params, st, seq[:, S + i: S + i + 1], cfg)
        ref = full[S + i]
        d = float((lg[0] - ref).abs().max())
        tol = SERVE_LOGIT_TOL * float(ref.abs().max())
        expect(d <= tol, f"decode step {i} differs from the forward by {d} > {tol}")
        worst = max(worst, d)
    log(f"[{tag}] prefill {S} + {K} decode steps vs full forward: max |d logit| {worst:.3e} "
        f"(max |logit| {float(full[S:].abs().max()):.3f}, tolerance "
        f"{SERVE_LOGIT_TOL} of it)")
    del full, st

    first = served[0]
    kern = _teacher_forced(params, cfg, prompts[0], first.tokens, flash_attention,
                           decode_attention, diag_recurrence, device)
    plain = _teacher_forced(params, cfg, prompts[0], first.tokens, flash_attention_plain,
                            decode_attention_plain, diag_recurrence_plain, device)
    d = float(np.abs(kern - plain).max())
    tol = SERVE_LOGIT_TOL * float(np.abs(plain).max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).mean())
    log(f"[{tag}] request 0 (prompt {len(prompts[0])}): kernel vs plain path max "
        f"|d logit| {d:.3e} (tolerance {tol:.3e}), argmax agreement {agree:.4f}")
    expect(d <= tol, f"kernel path differs from plain path by {d} > {tol}")

    single = ServingEngine(cfg, params, ServeConfig(
        max_slots=1, max_seq_len=SERVE_SEQ, max_new_tokens=SERVE_NEW, keep_logits=True))
    rids = [single.submit(p) for p in prompts]
    single.run_until_done()
    worst, compared, parts = 0.0, 0, []
    for i, rid in enumerate(rids):
        w, n, div = _agree_until_divergence(single.completed[rid], served[i],
                                            SERVE_LOGIT_TOL)
        worst, compared = max(worst, w), compared + n
        if div:
            parts.append((i, n - 1))
    log(f"[{tag}] continuous batching vs 1-slot engine: {compared} steps compared, max "
        f"|d logit| {worst:.3e}; {len(parts)} of {SERVE_REQUESTS} requests took another "
        f"token at a near tie (request, step where the tokens part: {parts})")
    del single

    profile_decode(rs.replicas[names[1]], device, tag)

    # this run's decode inputs for the timing row: the first attention
    # layer's cache and mask
    st = rs.replicas[names[1]].state
    i = next(i for i, c in enumerate(st["unit"]) if isinstance(c, KVCache))
    cache = st["unit"][i]
    window = cfg.window if cfg.attn_pattern[i] == LOCAL_ATTN else None
    out["decode_inputs"] = (cache.k[0].clone(), cache.v[0].clone(),
                            decode_valid(cache.k_pos[0], st["pos"], window))
    for k, n in counts.items():
        kernels[k].launches = n
    return out


# ---------------------------------------------------------------------------------
# 8. falcon-mamba-7b at full width and depth
# ---------------------------------------------------------------------------------

def profile_forward(params, tokens, cfg, tag: str) -> None:
    """torch.profiler over one forward: device time by kernel, and the shares
    of the diag_recurrence kernel, of the matrix products and of the rest (the
    plain-op expansion around the recurrence, norms, convolution)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.transformer import forward
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        forward(params, tokens, cfg, logits_slice=1)
        sync(tokens.device)
        wall = time.perf_counter() - t0
    kernels: dict = {}
    n_launch = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
            n_launch += 1
    if not kernels:
        log(f"[{tag}] forward profile: the profiler saw no kernels; not measured")
        return
    busy = sum(kernels.values())
    rec = sum(ms for k, ms in kernels.items() if "diag_recurrence" in k)
    gemm = sum(ms for k, ms in kernels.items()
               if any(w in k.lower() for w in ("gemm", "gemv", "cutlass", "nvjet", "xmma")))
    log(f"[{tag}] forward profile S={tokens.shape[1]}: wall {wall * 1e3:.3f} ms under the "
        f"profiler, device busy {busy:.3f} ms (idle share {1 - busy / (wall * 1e3):.4f}), "
        f"{n_launch} kernels; diag_recurrence {rec:.3f} ms ({rec / busy:.4f}), matrix "
        f"products {gemm:.3f} ms ({gemm / busy:.4f}), the rest {busy - rec - gemm:.3f} ms "
        f"({(busy - rec - gemm) / busy:.4f})")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:10]:
        log(f"[{tag}]   {ms:.4f} ms  {name[:110]}")


def _decode_vs_forward(params, cfg, tokens, tol_rel: float):
    """Prefill FALCON_DECODE[0] tokens, then FALCON_DECODE[1] decode steps, each
    step's logits within ``tol_rel`` of max |logit| of the full forward's.
    Returns (worst |d logit| / max |logit|, argmax agreement)."""
    from repro_torch.models.transformer import decode_step, forward
    S, K = FALCON_DECODE
    full = forward(params, tokens[:, :S + K], cfg)[0]
    _, st = forward(params, tokens[:, :S], cfg, make_state=True)
    worst, same = 0.0, 0
    for i in range(K):
        lg, st = decode_step(params, st, tokens[:, S + i: S + i + 1], cfg)
        ref = full[S + i]
        rel = float((lg[0] - ref).abs().max()) / float(ref.abs().max())
        expect(rel <= tol_rel, f"{cfg.name} decode step {i} differs from the forward "
               f"by {rel} of max |logit| > {tol_rel}")
        worst = max(worst, rel)
        same += int(lg[0].argmax() == ref.argmax())
    return worst, same / K


def phase_falcon(device, tmp: str) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import DependencyManager, RestorePolicy
    from repro_torch.core.pages import byte_view
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.kernels.diag_recurrence import diag_recurrence_plain
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.transformer import forward, init_params

    tag, cfg = "8", get_config(FALCON_ARCH)
    kernels = {k: v for k, v in kernel_fns().items()
               if k in ("page_gather", "diag_recurrence", "ssm_terms")}
    keep: dict = {}

    def builder():
        keep["params"] = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                     torch.bfloat16)
        return keep["params"]

    manager = DependencyManager(device=device)
    t0 = time.perf_counter()
    manager.register_image(cfg.name, cfg.name, builder)
    sync(device)
    img = manager._ensure_live(cfg.name)
    table = img.metadata.page_table
    n_params = sum(leaf.numel() for _, leaf in flatten_with_keys(keep["params"]))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} SSM layers d_model {cfg.d_model} d_inner "
        f"{cfg.d_inner} state {cfg.ssm_state} dt_rank {cfg.resolved_dt_rank} vocab "
        f"{cfg.vocab_size} -> {padded_vocab(cfg)}, bf16 (fp32 dt_bias/A_log/D): "
        f"{n_params} parameters, payload {table.nbytes_payload} B in {table.n_pages} "
        f"pages ({img.image_bytes} B on the card), built in {time.perf_counter() - t0:.2f} s")

    # ---- the main path, counted: restores, cold starts, prefill, decode
    reset_counts(kernels.values())
    ref_leaves = dict(flatten_with_keys(keep.pop("params")))
    for policy in (RestorePolicy.BULK, RestorePolicy.NO_PAGESERVER):
        t0 = time.perf_counter()
        r = manager.request_migration(cfg.name, policy)
        r.fault(r.metadata.page_table.order[0])
        got = dict(flatten_with_keys(r.as_pytree()))
        sync(device)
        dt = time.perf_counter() - t0
        manager.release(cfg.name)
        expect(got.keys() == ref_leaves.keys(), f"{policy.value}: leaf keys differ")
        for key, leaf in got.items():
            ref = ref_leaves[key]
            expect(leaf.dtype == ref.dtype and leaf.shape == ref.shape
                   and torch.equal(byte_view(leaf), byte_view(ref)),
                   f"{policy.value}: restored leaf {key} is not bitwise equal")
        log(f"[{tag}] {policy.value}: {len(got)} leaves restored bitwise equal in "
            f"{dt * 1e3:.1f} ms ({r.stats})")
        del got, r
    del ref_leaves
    gc.collect()
    torch.cuda.empty_cache()
    out = {"coldstart": phase_coldstart(cfg, manager, tmp, tag, "falcon",
                                        baseline_rounds=1)}

    params = img.params()                 # views into the pool's store
    gen = torch.Generator(device=device).manual_seed(23)
    tokens = torch.randint(0, cfg.vocab_size, (1, FALCON_SEQ), generator=gen,
                           device=device)
    forward(params, tokens[:, :64], cfg)                  # warm-up
    sync(device)
    t0 = time.perf_counter()
    k_logits = forward(params, tokens, cfg)
    sync(device)
    out["prefill_s"] = time.perf_counter() - t0
    expect(k_logits.shape == (1, FALCON_SEQ, padded_vocab(cfg))
           and bool(torch.isfinite(k_logits).all()),
           f"falcon logits not finite or of shape {tuple(k_logits.shape)}")
    worst, agree = _decode_vs_forward(params, cfg, tokens, BF16_DECODE_TOL)
    sync(device)
    counts = {k: v.launches for k, v in kernels.items()}
    log(f"[{tag}] launches during the falcon path: {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the falcon path")
    routes = expect_route(tag, "falcon path", "sequential", kernel="diag_recurrence")
    log(f"[{tag}] bf16 prefill {FALCON_DECODE[0]} + {FALCON_DECODE[1]} decode steps vs "
        f"full forward: max |d logit| / max |logit| {worst:.4e} (tolerance "
        f"{BF16_DECODE_TOL}), argmax agreement {agree:.4f}")

    # ---- checks and a profile, not counted
    t0 = time.perf_counter()
    p_logits = forward(params, tokens, cfg, recurrence_fn=diag_recurrence_plain)
    sync(device)
    out["prefill_plain_s"] = time.perf_counter() - t0
    diff = float((k_logits - p_logits).abs().max())
    scale = float(p_logits.abs().max())
    agree = float((k_logits.argmax(-1) == p_logits.argmax(-1)).float().mean())
    log(f"[{tag}] S={FALCON_SEQ} forward: kernel path {out['prefill_s']:.4f} s, plain "
        f"recurrence {out['prefill_plain_s']:.4f} s; max |d logit| {diff:.4e} (max |logit| "
        f"{scale:.4e}), torch.equal {torch.equal(k_logits, p_logits)}, argmax agreement "
        f"{agree:.4f}")
    expect(diff <= SERVE_LOGIT_TOL * scale, f"falcon kernel path differs from the plain "
           f"path by {diff} > {SERVE_LOGIT_TOL} * max|logit|")
    del k_logits, p_logits
    profile_forward(params, tokens, cfg, tag)
    del params, img, manager
    gc.collect()
    torch.cuda.empty_cache()
    twin = dataclasses.replace(cfg, n_layers=FALCON_FP32_LAYERS)
    twin_params = init_params(torch.Generator(device=device).manual_seed(0), twin,
                              torch.float32)
    worst, agree = _decode_vs_forward(twin_params, twin, tokens, SERVE_LOGIT_TOL)
    log(f"[{tag}] fp32 twin ({FALCON_FP32_LAYERS} layers, full width): prefill "
        f"{FALCON_DECODE[0]} + {FALCON_DECODE[1]} decode steps vs full forward: max "
        f"|d logit| / max |logit| {worst:.4e} (tolerance {SERVE_LOGIT_TOL}), argmax "
        f"agreement {agree:.4f}")
    for k, n in counts.items():
        kernels[k].launches = n
    out["counts"] = counts
    out["diag_routes"] = routes
    return out


# ---------------------------------------------------------------------------------
# 11. moonshot-v1-16b-a3b, full width, depth cut
# ---------------------------------------------------------------------------------

class RouteRecorder:
    """Within the block, records every MoE routing decision (the gates and
    the top-k experts ``models.moe.top_k`` picks), in call order. Given
    ``replay``, another recorder's calls, each call takes the experts that
    call picked instead, weighted by its own gates."""

    def __init__(self, replay=None):
        self.replay = replay

    def __enter__(self):
        from repro_torch.models import moe
        self.calls, self._top_k = [], moe.top_k

        def top_k(gates, k):
            if self.replay is None:
                w, i = self._top_k(gates, k)
            else:
                i = self.replay[len(self.calls)][1]
                w = gates.gather(-1, i)
            self.calls.append((gates.detach().clone(), i))
            return w, i
        moe.top_k = top_k
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.top_k = self._top_k


def _routing_compare(kern_routes, plain_routes, k_logits, p_logits, n_layers: int):
    """Positions routed alike on both paths in every layer, and the logits'
    differences there, elsewhere, and before the first position routed
    otherwise (whose logits no routing difference can reach: attention is
    causal, and an expert ranks its tokens in order for the capacity cut)."""
    import torch
    expect(len(kern_routes.calls) == len(plain_routes.calls) == n_layers,
           "one routing decision per layer")
    alike = torch.ones(k_logits.shape[1], dtype=torch.bool, device=k_logits.device)
    dgate = 0.0
    for (gk, ik), (gp, ip) in zip(kern_routes.calls, plain_routes.calls):
        alike &= (ik[0].sort(dim=-1).values == ip[0].sort(dim=-1).values).all(dim=-1)
        dgate = max(dgate, float((gk - gp).abs().max()))
    diff = (k_logits[0] - p_logits[0]).abs().amax(dim=-1)
    moved = (~alike).nonzero().flatten().tolist()
    first = moved[0] if moved else len(alike)
    return {"alike": int(alike.sum()),
            "dlogit_alike": float(diff[alike].max()) if bool(alike.any()) else float("nan"),
            "moved": len(moved), "first_moved": moved[:1],
            "dlogit_moved": float(diff[~alike].max()) if moved else 0.0,
            "dlogit_before": float(diff[:first].max()) if first else float("nan"),
            "dgate": dgate, "max_logit": float(p_logits.abs().max())}


def phase_moonshot(device, tag: str = "11") -> dict:
    """One bf16 forward of moonshot-v1-16b-a3b at full width (64 experts,
    top-6, d=128, g=1) and MOONSHOT_LAYERS layers through the kernels: the
    driven path. In bf16 the tensor-core route rounds P to bf16 as the JAX
    model does and the plain version does not, which moves the router's
    inputs by bf16 ulps and flips top-6 picks at near ties; attention and the
    experts' capacity ranks carry a flip to every later position. So the
    bf16 pair is held to BF16_LOGIT_BOUND before the first position routed
    otherwise, and over every position with the plain path replaying the
    kernel path's expert picks; an fp32 twin (same width and depth) routes
    alike and is held to SERVE_LOGIT_TOL of max |logit| where it does."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.transformer import forward, init_params

    cfg = dataclasses.replace(get_config("moonshot_v1_16b_a3b"), n_layers=MOONSHOT_LAYERS)
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg, torch.bfloat16)
    sync(device)
    n_params = sum(leaf.numel() for _, leaf in flatten_with_keys(params))
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} of 48 layers, d_model {cfg.d_model} heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} {cfg.n_experts} experts "
        f"top-{cfg.top_k} d_ff {cfg.d_ff}, bf16: {n_params} parameters "
        f"({n_params * 2} B), built in {time.perf_counter() - t0:.2f} s")
    tokens = torch.randint(0, cfg.vocab_size, (1, MOONSHOT_SEQ), device=device,
                           generator=torch.Generator(device=device).manual_seed(27))
    reset_counts([flash_attention])
    with RouteRecorder() as kern_routes:
        k_logits = forward(params, tokens, cfg)
    sync(device)
    counts = {"flash_attention": flash_attention.launches}
    log(f"[{tag}] launches during the moonshot forward: {counts}")
    expect(counts["flash_attention"] > 0, "flash_attention was not launched by moonshot")
    expect_route(tag, "moonshot forward", "tc_bf16")
    expect(k_logits.shape[:2] == (1, MOONSHOT_SEQ) and bool(torch.isfinite(k_logits).all()),
           f"moonshot logits not finite or of shape {tuple(k_logits.shape)}")

    # ---- checks, not counted
    out = {"counts": counts}
    for dtype in (torch.bfloat16, torch.float32):
        if dtype == torch.float32:
            del params, k_logits
            params = init_params(torch.Generator(device=device).manual_seed(0), cfg, dtype)
            with RouteRecorder() as kern_routes:
                k_logits = forward(params, tokens, cfg)
        with RouteRecorder() as plain_routes:
            p_logits = forward(params, tokens, cfg, attention_fn=flash_attention_plain)
        r = _routing_compare(kern_routes, plain_routes, k_logits, p_logits, cfg.n_layers)
        name = str(dtype).split(".")[1]
        log(f"[{tag}] {name} S={MOONSHOT_SEQ} forward, kernel vs plain path: {r['alike']} "
            f"of {MOONSHOT_SEQ} positions routed alike in every layer, max |d logit| there "
            f"{r['dlogit_alike']:.4e} (max |logit| {r['max_logit']:.4e}); {r['moved']} "
            f"routed otherwise (first at {r['first_moved']}), max |d logit| there "
            f"{r['dlogit_moved']:.4e}, before it {r['dlogit_before']:.4e}; max |d gate| "
            f"{r['dgate']:.3e}")
        out[name] = r
        del p_logits
        if dtype == torch.bfloat16:
            expect(not r["first_moved"] or r["first_moved"][0] > 0,
                   "moonshot bf16: the paths route position 0 otherwise")
            expect(r["dlogit_before"] <= BF16_LOGIT_BOUND,
                   f"moonshot bf16 kernel path differs from the plain path by "
                   f"{r['dlogit_before']} > {BF16_LOGIT_BOUND} before the first position "
                   f"routed otherwise")
            with RouteRecorder(replay=kern_routes.calls):
                p_logits = forward(params, tokens, cfg, attention_fn=flash_attention_plain)
            d = (k_logits[0] - p_logits[0]).abs().amax(dim=-1)
            r["dlogit_replayed"] = float(d.max())
            agree = float((k_logits[0].argmax(-1) == p_logits[0].argmax(-1)).float().mean())
            log(f"[{tag}] bfloat16 S={MOONSHOT_SEQ} forward, plain path replaying the "
                f"kernel path's expert picks: max |d logit| {r['dlogit_replayed']:.4e} over "
                f"all positions (at position {int(d.argmax())}; bound {BF16_LOGIT_BOUND}), "
                f"argmax agreement {agree:.4f}")
            expect(r["dlogit_replayed"] <= BF16_LOGIT_BOUND,
                   f"moonshot bf16 kernel path differs from the plain path replaying its "
                   f"routing by {r['dlogit_replayed']} > {BF16_LOGIT_BOUND}")
            del p_logits
    tol = SERVE_LOGIT_TOL * r["max_logit"]
    expect(r["alike"] > 0 and r["dlogit_alike"] <= tol,
           f"moonshot fp32 kernel path differs from the plain path by {r['dlogit_alike']} "
           f"> {tol} where the routing agreed")
    del params, k_logits
    return out


# ---------------------------------------------------------------------------------
# 12-13. whisper-small, internvl2-1b and h2o-danube3-4b from the pool
# ---------------------------------------------------------------------------------

def _pool_image(device, cfg, dtype, tag: str):
    """``cfg``'s random image (seed 0) in a new pool, restored under BULK:
    (manager, restored params). Every restored leaf is bitwise the built one."""
    import torch
    from repro_torch.core import DependencyManager, RestorePolicy
    from repro_torch.core.pages import byte_view
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.models.layers import padded_vocab
    from repro_torch.models.transformer import init_params
    keep: dict = {}

    def builder():
        keep["params"] = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                                     dtype)
        return keep["params"]

    manager = DependencyManager(device=device)
    t0 = time.perf_counter()
    manager.register_image(cfg.name, cfg.name, builder)
    sync(device)
    img = manager._ensure_live(cfg.name)
    table = img.metadata.page_table
    ref_leaves = dict(flatten_with_keys(keep.pop("params")))
    n_params = sum(leaf.numel() for leaf in ref_leaves.values())
    log(f"[{tag}] {cfg.name}: {cfg.n_layers} layers {cfg.attn_pattern} d_model {cfg.d_model} "
        f"heads {cfg.n_heads}/{cfg.n_kv_heads}x{cfg.resolved_head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size} -> {padded_vocab(cfg)}, {str(dtype).split('.')[1]}: {n_params} "
        f"parameters, payload {table.nbytes_payload} B in {table.n_pages} pages, built in "
        f"{time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    r = manager.request_migration(cfg.name, RestorePolicy.BULK)
    r.fault(r.metadata.page_table.order[0])
    params = r.as_pytree()
    sync(device)
    dt = time.perf_counter() - t0
    manager.release(cfg.name)
    got = dict(flatten_with_keys(params))
    expect(got.keys() == ref_leaves.keys(), f"{cfg.name}: restored leaf keys differ")
    for key, leaf in got.items():
        ref = ref_leaves[key]
        expect(leaf.dtype == ref.dtype and leaf.shape == ref.shape
               and torch.equal(byte_view(leaf), byte_view(ref)),
               f"{cfg.name}: restored leaf {key} is not bitwise equal")
    log(f"[{tag}] bulk: {len(got)} leaves restored bitwise equal in {dt * 1e3:.1f} ms "
        f"({r.stats})")
    return manager, params


def phase_frontend(device, arch: str, tag: str = "12") -> dict:
    """whisper-small or internvl2-1b at full width and depth (fp32) from the
    pool: make_prefill_step on generated frames / patches, then FRONTEND_NEW
    make_serve_step steps, as the reference serves them (its engine admits
    token prompts only). Checks: prefill + decode against the full forward,
    and the kernel path against the plain path, teacher-forced on the served
    tokens, within SERVE_LOGIT_TOL of max |logit|."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention, page_gather
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.api import make_prefill_step, make_serve_step
    from repro_torch.models.attention import decode_valid
    from repro_torch.models.transformer import decode_step, forward

    cfg = get_config(arch)
    kernels = {"page_gather": page_gather, "flash_attention": flash_attention,
               "decode_attention": decode_attention}
    B, S, K = FRONTEND_BATCH, FRONTEND_PROMPT, FRONTEND_NEW
    audio = cfg.frontend == "audio_frames"
    F = 0 if audio else cfg.n_frontend_tokens
    rng = np.random.default_rng(31)
    key, shape = (("frames", (B, cfg.n_enc_positions, cfg.d_model)) if audio
                  else ("patches", (B, F, cfg.d_model)))
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                       device=device),
             key: torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                                  device=device)}
    state_len = F + S + K

    # ---- the main path, counted: restore, prefill, serve steps
    reset_counts(kernels.values())
    manager, params = _pool_image(device, cfg, torch.float32, tag)
    t0 = time.perf_counter()
    tok, st = make_prefill_step(cfg, state_len=state_len)(params, batch)
    sync(device)
    prefill_s = time.perf_counter() - t0
    served = [tok]
    serve = make_serve_step(cfg)
    t0 = time.perf_counter()
    for _ in range(K):
        tok, st = serve(params, st, served[-1][:, None])
        served.append(tok)
    sync(device)
    step_ms = (time.perf_counter() - t0) / K * 1e3
    served = torch.stack(served, dim=1).long()                       # (B, K + 1)
    counts = {k: v.launches for k, v in kernels.items()}
    prompt = (f"{S} tokens over {cfg.n_enc_positions} frames" if audio
              else f"{F} patches + {S} tokens")
    log(f"[{tag}] {cfg.name}: prefill of {B} x ({prompt}) {prefill_s * 1e3:.1f} ms, {K} "
        f"serve steps {step_ms:.3f} ms each; launches {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the {cfg.name} path")
    flash_routes = expect_route(tag, f"{cfg.name} path (fp32)", "cuda_core")

    # ---- checks, not counted
    fe = batch[key]

    def teacher_forced(attention_fn, decode_fn):
        logits, s = forward(params, batch["tokens"], cfg, frontend_embeds=fe,
                            make_state=True, state_len=state_len, logits_slice=1,
                            attention_fn=attention_fn)
        rows = [logits[:, -1]]
        for i in range(K):
            lg, s = decode_step(params, s, served[:, i:i + 1], cfg, decode_fn=decode_fn)
            rows.append(lg)
        return torch.stack(rows, dim=1)[..., :cfg.vocab_size]        # (B, K + 1, V)

    kern = teacher_forced(flash_attention, decode_attention)
    expect(torch.equal(kern.argmax(-1), served), "the served tokens are not the argmax "
           "of the same path's logits")
    full = forward(params, torch.cat([batch["tokens"], served[:, :-1]], dim=1), cfg,
                   frontend_embeds=fe)[:, F + S - 1:, :cfg.vocab_size]
    plain = teacher_forced(flash_attention_plain, decode_attention_plain)
    for what, a, ref in (("prefill + decode vs full forward", kern, full),
                         ("kernel vs plain path", kern, plain)):
        d = float((a - ref).abs().max())
        tol = SERVE_LOGIT_TOL * float(ref.abs().max())
        agree = float((a.argmax(-1) == ref.argmax(-1)).float().mean())
        log(f"[{tag}] {cfg.name} {what}, {K + 1} positions x {B}: max |d logit| "
            f"{d:.3e} (tolerance {tol:.3e}), argmax agreement {agree:.4f}")
        expect(d <= tol, f"{cfg.name} {what}: {d} > {tol}")
    if audio:      # the first layer's cross keys, every one valid
        inputs = (st["cross"]["k"][0].clone(), st["cross"]["v"][0].clone(),
                  torch.ones((cfg.n_enc_positions,), dtype=torch.bool, device=device))
    else:          # the first layer's self-attention cache
        cache = st["unit"][0]
        inputs = (cache.k[0].clone(), cache.v[0].clone(),
                  decode_valid(cache.k_pos[0], st["pos"], None))
    del params, st, kern, full, plain, manager
    return {"counts": counts, "flash_routes": flash_routes, "prefill_ms": prefill_s * 1e3,
            "serve_step_ms": step_ms, "decode_inputs": inputs}


def phase_h2o(device, tag: str = "13") -> dict:
    """h2o-danube3-4b at full width and depth (bf16, head dim 120, window
    4096 on every layer) from the pool: a prefill of H2O_SEQ tokens, which
    wraps each layer's 4096-slot ring, then H2O_DECODE decode steps through
    the wrapped ring. Checks: decode against the full forward, and the kernel
    path against the plain path (teacher-forced), within BF16_LOGIT_BOUND."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention, flash_attention, page_gather
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.models.attention import decode_valid
    from repro_torch.models.transformer import decode_step, forward

    cfg = get_config(H2O_ARCH)
    kernels = {"page_gather": page_gather, "flash_attention": flash_attention,
               "decode_attention": decode_attention}
    S, K = H2O_SEQ, H2O_DECODE
    tokens = torch.randint(0, cfg.vocab_size, (1, S + K), device=device,
                           generator=torch.Generator(device=device).manual_seed(29))

    def run(params, attention_fn, decode_fn):
        """Logits (K + 1, V) of the prefill's last position and the decode
        steps, and the final state."""
        logits, st = forward(params, tokens[:, :S], cfg, make_state=True,
                             state_len=S + K, logits_slice=1, attention_fn=attention_fn)
        rows = [logits[0, -1]]
        for i in range(K):
            lg, st = decode_step(params, st, tokens[:, S + i:S + i + 1], cfg,
                                 decode_fn=decode_fn)
            rows.append(lg[0])
        return torch.stack(rows)[:, :cfg.vocab_size], st

    # ---- the main path, counted
    reset_counts(kernels.values())
    manager, params = _pool_image(device, cfg, torch.bfloat16, tag)
    t0 = time.perf_counter()
    kern, st = run(params, flash_attention, decode_attention)
    sync(device)
    run_s = time.perf_counter() - t0
    counts = {k: v.launches for k, v in kernels.items()}
    cache = st["unit"][0]
    C = cache.k.shape[3]
    log(f"[{tag}] {cfg.name}: prefill {S} + {K} decode steps in {run_s:.3f} s; each "
        f"layer's ring holds {C} slots, positions {int(cache.k_pos[0].min())}-"
        f"{int(cache.k_pos[0].max())}; launches {counts}")
    for name, n in counts.items():
        expect(n > 0, f"{name} was not launched by the {cfg.name} path")
    expect(C == cfg.window < S, f"the ring of {C} slots did not wrap")
    flash_routes = expect_route(tag, f"{cfg.name} path (bf16)", "tc_bf16")
    expect(bool(torch.isfinite(kern).all()), "h2o logits are not finite")

    # ---- checks, not counted
    full = forward(params, tokens, cfg)[0, S - 1:, :cfg.vocab_size]
    plain, _ = run(params, flash_attention_plain, decode_attention_plain)
    for what, ref in (("prefill + decode vs full forward", full),
                      ("kernel vs plain path", plain)):
        d = float((kern - ref).abs().max())
        agree = float((kern.argmax(-1) == ref.argmax(-1)).float().mean())
        log(f"[{tag}] {cfg.name} {what}, {K + 1} positions: max |d logit| {d:.4e} "
            f"(max |logit| {float(ref.abs().max()):.4e}, bound {BF16_LOGIT_BOUND}), "
            f"argmax agreement {agree:.4f}")
        expect(d <= BF16_LOGIT_BOUND, f"{cfg.name} {what}: {d} > {BF16_LOGIT_BOUND}")
    inputs = (cache.k[0].clone(), cache.v[0].clone(),
              decode_valid(cache.k_pos[0], st["pos"], cfg.window))
    del params, st, full, plain, manager
    return {"counts": counts, "flash_routes": flash_routes, "prefill_decode_s": run_s,
            "decode_inputs": inputs}


# ---------------------------------------------------------------------------------
# 6. kernel times
# ---------------------------------------------------------------------------------

# ---------------------------------------------------------------------------------
# 3g, 14-17: gradients, training, rollback, export
# ---------------------------------------------------------------------------------

def check_gradients(device, errs: dict) -> None:
    """The flash_attention backward kernels (fp32) against torch.autograd.grad
    through flash_attention_plain at the training shapes (B=1), dq, dk, dv
    each within GRAD_TOL of its largest |entry|; the diag_recurrence backward
    (the kernel run backwards in time, forced onto each route) against
    autograd through the plain loop at falcon-mamba's SSM chunk and
    recurrentgemma's RG-LRU prefill, within GRAD_TOL of each gradient's
    largest |entry|."""
    import torch
    from repro_torch.kernels import diag_recurrence, flash_attention
    from repro_torch.kernels.diag_recurrence import diag_recurrence_plain
    from repro_torch.kernels.diag_recurrence.ops import (RecurrencePlan,
                                                         diag_recurrence_backward,
                                                         plan_recurrence, run_plan)
    from repro_torch.kernels.flash_attention.ops import (flash_attention_backward,
                                                         flash_attention_backward_plain)
    gen = torch.Generator(device=device).manual_seed(31)
    worst, worst_abs = 0.0, 0.0
    for label, (H, Hkv, Sq, Sk, d, causal, window, cap) in FLASH_GRAD.items():
        q = torch.randn((1, H, Sq, d), generator=gen, device=device).requires_grad_(True)
        k, v = (torch.randn((1, Hkv, Sk, d), generator=gen, device=device)
                .requires_grad_(True) for _ in range(2))
        dout = torch.randn(q.shape, generator=gen, device=device)
        opts = dict(causal=causal, window=window, softcap=cap)
        before = flash_attention_backward.launches
        on_route = flash_attention_backward.launches_by_route[bwd_route("float32")]
        out = flash_attention(q, k, v, **opts)
        got = torch.autograd.grad(out, (q, k, v), dout)
        sync(device)
        expect(flash_attention_backward.launches == before + 1
               and flash_attention_backward.launches_by_route[bwd_route("float32")]
               == on_route + 1,
               f"the {label} gradient did not launch the backward kernel on "
               f"{bwd_route('float32')}")
        ref = flash_attention_backward_plain(q, k, v, dout, **opts)
        rel = []
        for name, g, r in zip("qkv", got, ref):
            scale = float(r.abs().max())
            err = float((g - r).abs().max())
            expect(bool(torch.isfinite(g).all()) and err <= GRAD_TOL * scale,
                   f"flash backward d{name} at {label}: max |err| {err:.3e} against "
                   f"{GRAD_TOL} x {scale:.3e}")
            rel.append(err / scale)
            worst_abs = max(worst_abs, err)
        worst = max(worst, *rel)
        log(f"[3g] flash backward {label} H{H}/{Hkv} Sq{Sq} Sk{Sk} d{d} causal={causal} "
            f"window={window} softcap={cap}: max |err| / max |g| dq {rel[0]:.3e} dk "
            f"{rel[1]:.3e} dv {rel[2]:.3e} (bar {GRAD_TOL})")
        del q, k, v, dout, out, got, ref
        torch.cuda.empty_cache()
    log(f"[3g] flash backward: max |err| / max |g| {worst:.3e}, max |err| {worst_abs:.3e}")
    errs["flash_attention_backward"] = worst_abs
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    worst = 0.0
    for label, (B, S, C) in RECURRENCE_GRAD.items():
        a = (torch.rand((B, S, C), generator=gen, device=device) * 0.5 + 0.5)
        b = torch.randn((B, S, C), generator=gen, device=device)
        h0 = torch.randn((B, C), generator=gen, device=device)
        g_all = torch.randn((B, S, C), generator=gen, device=device)
        g_fin = torch.randn((B, C), generator=gen, device=device)
        leaves = [t.requires_grad_(True) for t in (a, b, h0)]
        r_all, r_fin = diag_recurrence_plain(*leaves)
        ref = torch.autograd.grad((r_all, r_fin), leaves, (g_all, g_fin))
        del r_all, r_fin
        with torch.no_grad():
            h_all, _ = diag_recurrence(a, b, h0)
        planned = plan_recurrence(B, S, C, n_sms)
        plans = {"sequential": RecurrencePlan("sequential", S, 1),
                 "chunked": (planned if planned.route == "chunked"
                             else RecurrencePlan("chunked", 64, -(-S // 64)))}
        for route, plan in plans.items():
            before = dict(diag_recurrence.launches_by_route)
            with torch.no_grad():
                got = diag_recurrence_backward(
                    a, h0, h_all, g_all, g_fin,
                    lambda x, y, z, plan=plan: run_plan(x, y, z, plan, "backward"))
            sync(device)
            expect(diag_recurrence.launches_by_route[route] == before[route] + 1,
                   f"the {label} backward did not run on the {route} route")
            rel = []
            for name, g, r in zip(("a", "b", "h0"), got, ref):
                scale = float(r.abs().max())
                err = float((g - r).abs().max())
                expect(err <= GRAD_TOL * scale,
                       f"diag_recurrence backward d{name} at {label} ({route}): max "
                       f"|err| {err:.3e} against {GRAD_TOL} x {scale:.3e}")
                rel.append(err / scale)
            worst = max(worst, *rel)
            log(f"[3g] diag_recurrence backward {label} B{B} S{S} C{C} on {route} (chunk "
                f"{plan.chunk}): max |err| / max |g| da {rel[0]:.3e} db {rel[1]:.3e} "
                f"dh0 {rel[2]:.3e} (planner: {planned.route})")
        del a, b, h0, g_all, g_fin, leaves, ref, h_all, got
        torch.cuda.empty_cache()
    errs["diag_recurrence:backward"] = worst


def profile_step(step_fn, params, opt_state, batch, step: int, tag: str) -> dict:
    """torch.profiler over one training step: device busy time (the union of
    the kernels' intervals) against the step's wall time, and the kernels
    that took the most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    import torch
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step_fn(params, opt_state, batch, step)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans, kernels = [], {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.append((e.time_range.start, e.time_range.end))
            kernels[e.name] = kernels.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    if not spans:
        log(f"[{tag}] step profile: the profiler saw no kernels; busy share not measured")
        return {"profile": "not measured"}
    busy, end = 0.0, None
    for lo, hi in sorted(spans):
        if end is None or lo > end:
            busy += hi - lo
            end = hi
        elif hi > end:
            busy += hi - end
            end = hi
    busy /= 1e3
    log(f"[{tag}] step profile: wall {wall:.3f} ms under the profiler, device busy "
        f"{busy:.3f} ms (busy share {busy / wall:.4f}, idle share {1 - busy / wall:.4f}), "
        f"{len(spans)} kernels")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag}]   {ms:.4f} ms  {name[:110]}")
    return {"profile_wall_ms": wall, "busy_ms": busy, "busy_share": busy / wall,
            "idle_share": 1 - busy / wall, "kernels_per_step": len(spans)}


def phase_train_qwen(device, tmp: str, tag: str = "14") -> dict:
    """qwen1.5-0.5b at full width and depth, fp32, B=4, S=1024, remat=unit:
    TRAIN_STEPS steps through the training launcher (supervisor, anchor and
    final checkpoints; a peak rate of TRAIN_LR, so the launcher's 100-step
    warm-up reaches 3e-4 at the last step); the loss must fall and each step must run 24 flash
    forwards, 24 recomputes and 24 backward launches; then one profiled step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    from repro_torch.launch import train
    from repro_torch.models.api import make_train_step
    kernels = {k: v for k, v in kernel_fns().items()
               if k in ("flash_attention", "flash_attention_backward")}
    B, S = TRAIN_SHAPE
    n_layers = get_config("qwen1_5_0_5b").n_layers
    reset_counts(kernels.values())
    run = train.main(["--arch", "qwen1_5_0_5b", "--steps", str(TRAIN_STEPS), "--batch",
                      str(B), "--seq", str(S), "--remat", "unit", "--lr", str(TRAIN_LR),
                      "--device", str(device),
                      "--ckpt-dir", os.path.join(tmp, "train_ckpt"),
                      "--log", os.path.join(tmp, "train_log.jsonl")])
    hist = run["history"]
    flash = kernels["flash_attention"]
    per_step = {"forward": flash.launches_by_pass["forward"] / TRAIN_STEPS,
                "recompute": flash.launches_by_pass["recompute"] / TRAIN_STEPS,
                "backward": flash_attention_backward.launches / TRAIN_STEPS}
    counts = launch_counts(kernels)
    log(f"[{tag}] flash_attention launches per step: {per_step} (want {n_layers} each); "
        f"by route {flash.launches_by_route}; backward by route "
        f"{flash_attention_backward.launches_by_route}")
    expect(per_step == dict.fromkeys(per_step, n_layers),
           f"qwen1.5 training ran {per_step} flash launches a step, not {n_layers} each")
    expect(counts[f"flash_attention_backward:{bwd_route('float32')}"]
           == counts["flash_attention_backward"],
           f"qwen1.5 fp32 training ran backwards off {bwd_route('float32')}: {counts}")
    losses = [h["loss"] for h in hist]
    expect(len(hist) == TRAIN_STEPS and all(map(math.isfinite, losses)),
           f"qwen1.5 training history: {losses}")
    expect(losses[-1] < losses[0], f"qwen1.5 training loss did not fall: {losses}")
    times = [h["seconds"] for h in hist[1:]]
    step_s = statistics.median(times)
    log(f"[{tag}] qwen1.5-0.5b fp32 B{B} S{S} remat=unit, {TRAIN_STEPS} steps: loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; step times (s, after the first) "
        f"{[round(t, 4) for t in times]}; median {step_s:.4f} s, {B * S / step_s:.1f} "
        f"tokens/s (with the backward on CUDA cores: {CUDA_CORE_BWD_STEP_S[tag]} s); first "
        f"step {hist[0]['seconds']:.3f} s")
    data = DataConfig(global_batch=B, seq_len=S, seed=0)
    cfg = get_config("qwen1_5_0_5b")
    batch = batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, TRAIN_STEPS), device)
    prof = profile_step(make_train_step(cfg, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                        remat="unit"),
                        run["params"], run["opt_state"], batch, TRAIN_STEPS, tag)
    return {"counts": counts, "losses": losses, "median_step_s": step_s,
            "tokens_per_s": B * S / step_s, "first_step_s": hist[0]["seconds"],
            "flash_per_step": per_step, **prof}


def phase_rollback(device, tmp: str, tag: str = "15") -> dict:
    """qwen1.5-0.5b at full width and 2 layers, B=2, S=256: ROLLBACK_STEPS
    steps under the supervisor with a checkpoint every 2 steps (async saves)
    and InjectedFailure at steps 3 and 6, against an uninterrupted run: the
    final parameters within ROLLBACK_TOL (tests/test_serving_ft.py:107)."""
    import torch
    from repro_torch.checkpoint import CheckpointConfig
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.models.api import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    from repro_torch.runtime import InjectedFailure, SupervisorConfig, TrainSupervisor
    cfg = dataclasses.replace(get_config("qwen1_5_0_5b"), n_layers=2)
    B, S = ROLLBACK_SHAPE
    data = DataConfig(global_batch=B, seq_len=S, seed=5)
    step_fn = make_train_step(cfg, remat="none", total_steps=20)

    def run(fail: bool):
        ckdir = os.path.join(tmp, f"rollback_{int(fail)}")
        sup = TrainSupervisor(
            SupervisorConfig(checkpoint_every=2, checkpoint=CheckpointConfig(ckdir)),
            step_fn,
            lambda s: batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, s), device))
        p = init_params(torch.Generator(device=device).manual_seed(9), cfg, torch.float32)
        o = adamw_init(p)
        fails = {3: InjectedFailure("node died"),
                 6: InjectedFailure("nan storm")} if fail else None
        t0 = time.perf_counter()
        p, o, hist = sup.run(p, o, 0, ROLLBACK_STEPS, fail_at=fails)
        sync(device)
        shutil.rmtree(ckdir, ignore_errors=True)
        return p, sup.restores, hist, time.perf_counter() - t0

    clean, r0, h0, t_clean = run(False)
    faulty, r1, h1, t_faulty = run(True)
    diff = max(float((a - b).abs().max()) for a, b in zip(leaves(clean), leaves(faulty)))
    log(f"[{tag}] rollback: {r1} restores; final params max |diff| against the "
        f"uninterrupted run {diff:.3e} (bar {ROLLBACK_TOL}); final loss {h0[-1]['loss']:.6f}"
        f" / {h1[-1]['loss']:.6f}; {t_clean:.2f} s clean, {t_faulty:.2f} s with failures")
    expect(r0 == 0 and r1 == 2, f"rollback restores {r0} / {r1}, want 0 / 2")
    expect(diff <= ROLLBACK_TOL, f"rollback final params differ by {diff:.3e}")
    return {"restores": r1, "max_abs_diff": diff, "seconds_clean": t_clean,
            "seconds_with_failures": t_faulty}


def phase_train_griffin(device, tag: str = "16") -> dict:
    """recurrentgemma-2b at full width and one pattern unit (2 RG-LRU layers
    and one local attention layer), fp32, B=1, S=2560 (past the 2048
    window), GRIFFIN_STEPS steps: the step runs both kernels' backward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.models.api import make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.optim import adamw_init
    cfg = get_config("recurrentgemma_2b")
    cfg = dataclasses.replace(cfg, n_layers=len(cfg.attn_pattern))
    kernels = {k: v for k, v in kernel_fns().items()
               if k in ("flash_attention", "flash_attention_backward", "diag_recurrence")}
    B, S = GRIFFIN_TRAIN
    data = DataConfig(global_batch=B, seq_len=S, seed=2)
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg, torch.float32)
    opt = adamw_init(params)
    step_fn = make_train_step(cfg, remat="none", total_steps=GRIFFIN_STEPS)
    reset_counts(kernels.values())
    losses, times = [], []
    for step in range(GRIFFIN_STEPS):
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt,
                                 batch_to_torch(SyntheticTokenPipeline.batch_at(
                                     cfg, data, step), device), step)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    rec, flash = kernels["diag_recurrence"], kernels["flash_attention"]
    counts = launch_counts(kernels)
    log(f"[{tag}] recurrentgemma-2b 1 unit fp32 B{B} S{S}: losses {losses}, step times "
        f"{[round(t, 4) for t in times]} s; diag_recurrence by route "
        f"{rec.launches_by_route}, by pass {rec.launches_by_pass}; flash forward "
        f"{flash.launches}, backward {counts['flash_attention_backward']}")
    expect(all(map(math.isfinite, losses)), f"recurrentgemma losses {losses}")
    expect(rec.launches_by_pass["backward"] > 0 and counts["flash_attention_backward"] > 0,
           "recurrentgemma's step did not run both kernels' backward")
    expect(counts[f"flash_attention_backward:{bwd_route('float32')}"]
           == counts["flash_attention_backward"],
           f"recurrentgemma's fp32 step ran backwards off {bwd_route('float32')}: {counts}")
    return {"counts": counts, "losses": losses, "step_s": times,
            "diag_routes": dict(rec.launches_by_route),
            "diag_passes": dict(rec.launches_by_pass)}


def phase_aot(device, tag: str = "17") -> dict:
    """qwen1.5-0.5b's prefill_logits at B=1, S=64 (bf16, quickstart's shape)
    exported with torch.export, saved to bytes and loaded: the loaded
    program's logits bitwise equal to eager; blob bytes and the export, load
    and first-call seconds beside the eager warm-up forward."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.aot import (deserialize_executables, executables_nbytes,
                                      serialize_executables)
    from repro_torch.models.transformer import forward, init_params
    cfg = get_config("qwen1_5_0_5b")
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg,
                         torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (1, 64), device=device,
                           generator=torch.Generator(device=device).manual_seed(3))

    def prefill_logits(p, toks):
        return forward(p, toks, cfg, logits_slice=1)[:, -1]

    t0 = time.perf_counter()
    eager = prefill_logits(params, tokens)
    sync(device)
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    blobs = serialize_executables({"prefill_logits": prefill_logits},
                                  {"prefill_logits": (params, tokens)})
    t_export = time.perf_counter() - t0
    t0 = time.perf_counter()
    run = deserialize_executables(blobs)["prefill_logits"]
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run(params, tokens)
    sync(device)
    t_first = time.perf_counter() - t0
    equal = torch.equal(out, eager)
    log(f"[{tag}] qwen1.5-0.5b prefill_logits B1 S64 bf16 exported: "
        f"{executables_nbytes(blobs)} bytes; export {t_export:.3f} s, load {t_load:.3f} s, "
        f"first call {t_first:.4f} s; eager warm-up forward {t_warm:.4f} s; logits "
        f"bitwise equal: {equal}")
    expect(equal, "the loaded program's logits differ from eager")
    return {"blob_bytes": executables_nbytes(blobs), "export_s": t_export,
            "load_s": t_load, "first_call_s": t_first, "warmup_forward_s": t_warm}


# ---------------------------------------------------------------------------------
# 18. sharded on the card: several ranks over gloo on the one H100
# ---------------------------------------------------------------------------------

SHARD_RANKS = 4
SHARD_TIMEOUT = 600        # s: the ranks' start, each collective, and the whole phase
SHARD_TRAIN_TOL = 1e-5     # relative, the loss of one step against one rank's
SHARD_PARAM_TOL = 1e-3     # the parameters after it (tests/test_sharded_exec.py's bar)
# case -> (arch, layers (None: all), mesh, work); the mesh is (data, model) or
# (pod, data, model); the shapes below
SHARD_CASES = {
    "18a": ("qwen3_1_7b", None, (1, 4), "serve"),
    "18b": ("qwen3_1_7b", None, (2, 2), "serve"),
    "18c": ("qwen1_5_0_5b", None, (2, 2), "train"),
    "18d": ("falcon_mamba_7b", 2, (1, 4), "serve"),
    "18e": ("moonshot_v1_16b_a3b", 2, (1, 4), "forward"),
    "18f": ("fnbench_tiny", None, (1, 4), "serve"),
    # recurrentgemma-2b: attention replicated (10 heads over 4), the cache's
    # positions over model, 640 LRU channels a rank; its train step at 2 x 2
    # (1,280 channels, 5 q heads a rank beside the one kv head) at one pattern
    # unit (2 recurrent + 1 local attention layers): four ranks each build the
    # whole model before they cut it, 10.7 GB fp32 at full depth, and the
    # moments and gradients of the shards come on top
    "18g": ("recurrentgemma_2b", None, (1, 4), "serve"),
    "18g-train": ("recurrentgemma_2b", 3, (2, 2), "train"),
    "18h": ("whisper_small", None, (1, 4), "serve"),      # 3 heads a rank, cross state whole
    "18i": ("internvl2_1b", None, (2, 2), "serve"),       # 7 q / 1 kv heads a rank: g = 7
    "18j": ("qwen3_1_7b", None, (2, 1, 2), "serve"),      # pod x data x model
    # 20c: one train step with ZeRO-1 moments against the same step with whole
    # moments, from the same shards, in the same ranks (no one-rank reference)
    "20c": ("qwen1_5_0_5b", None, (2, 2), "zero1"),
}
# serve cases: batch, prompt, tokens after it (the first K-1 fed teacher-forced to
# the decode steps), cache positions (after internvl2's 256 patches)
SHARD_SERVE = {"18a": (2, 256, 8, 512), "18b": (1, 184, 16, 384), "18d": (1, 512, 8, 520),
               "18f": (2, 100, 40, 512), "18g": (1, 512, 8, 520), "18h": (2, 64, 16, 80),
               "18i": (2, 64, 16, 336), "18j": (2, 256, 8, 512)}
# cases whose cache positions split over ranks, by the axis they split over: 18b's
# batch of 1 does not cover data (192 slots a data rank), 18f's 2 kv heads do not
# divide model 4 (128 slots a rank; all 4 q heads gathered). Each prompt ends short
# of the second block, so a rank attends a block with no live slot at first (its lse
# must weigh 0 in the merge) and takes its first live slot mid-decode
SHARD_SEQ_AXES = {"18b": ["data"], "18f": ["model"]}
SHARD_MOONSHOT_SEQ = 256
# train cases whose gradients are held against one rank's, leaf by leaf (the leaves
# under this path prefix: the RG-LRU's, through the width gathered for its gates)
SHARD_GRADS = {"18g-train": "['unit'][0]['rec']"}


def _shard_cfg(case: str):
    from repro_torch.configs import get_config
    arch, layers, _, _ = SHARD_CASES[case]
    cfg = get_config(arch)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


def _shard_front(cfg, B: int, case: str):
    """The stub frontend's embeddings of a serve case (whisper's frames,
    internvl2's patches) from the case's seed, fp32, or None."""
    import numpy as np
    import torch
    rng = np.random.default_rng(100 + int(case[2], 36))
    n = {"audio_frames": cfg.n_enc_positions,
         "vision_patches": cfg.n_frontend_tokens}.get(cfg.frontend)
    if n is None:
        return None
    return torch.from_numpy((rng.standard_normal((B, n, cfg.d_model)) * 0.02
                             ).astype(np.float32))


def _attn_index(cfg) -> int:
    """The pattern position of the first attention layer."""
    from repro_torch.models.config import GLOBAL_ATTN, LOCAL_ATTN
    return next(i for i, t in enumerate(cfg.attn_pattern) if t in (GLOBAL_ATTN, LOCAL_ATTN))


def _attn_layers(cfg) -> int:
    from repro_torch.models.config import GLOBAL_ATTN, LOCAL_ATTN
    return sum(cfg.attn_pattern[i % len(cfg.attn_pattern)] in (GLOBAL_ATTN, LOCAL_ATTN)
               for i in range(cfg.n_layers))


def _shard_params(cfg, device, par=None):
    """The case's fp32 parameters from seed 0, whole, or this rank's shards."""
    import torch
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import init_params
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg, torch.float32)
    if par is None:
        return params, None
    specs = sh.param_pspecs(cfg, params, par.tp)
    local = sh.shard_tree(params, specs, par)
    del params
    return local, specs


def _shard_serve(params, cfg, tokens, P, C, device, par=None, front=None):
    """Logits (K+1, B, V) of the prefill's last position and of decode steps
    fed tokens[:, P:-1] (teacher-forced), on one rank or sharded (``par``:
    each rank's rows and vocab block gathered), after the stub frontend's
    embeddings ``front`` if any, and the stats: the prefill's seconds, the
    median step's ms (the logits' gather included), the all_reduces of the
    last step (count, bytes) and, where the cache's positions split, the
    decode steps that attended this rank's block while it held no live
    slot."""
    import statistics
    import torch
    from repro_torch.models import sharding as sh
    from repro_torch.models.transformer import decode_step, forward
    B = tokens.shape[0]
    pb = par.for_batch(B) if par is not None else None
    covers = pb is not None and pb.batch_covers and pb.dp > 1
    toks = tokens.to(device)
    fe = front.to(device) if front is not None else None
    if covers:
        n = B // pb.dp
        toks = toks[pb.dp_rank * n:(pb.dp_rank + 1) * n]
        fe = fe[pb.dp_rank * n:(pb.dp_rank + 1) * n] if fe is not None else None

    def whole(lg):
        lg = sh.gather_vocab(lg, pb)
        return sh.gather_dim(lg.contiguous(), 0, pb.dp_axes, pb) if covers else lg

    sync(device)
    t0 = time.perf_counter()
    logits, st = forward(params, toks[:, :P], cfg, frontend_embeds=fe, make_state=True,
                         state_len=C, logits_slice=1, par=pb)
    rows = [whole(logits[:, -1])[:, : cfg.vocab_size]]
    sync(device)
    stats = {"prefill_s": time.perf_counter() - t0}
    split = pb is not None and not cfg.is_attention_free and pb.seq_axes is not None
    if split:
        stats["empty_steps"] = 0
        attn = _attn_index(cfg)
    steps = []
    for i in range(P, toks.shape[1] - 1):
        t0, calls, nbytes = time.perf_counter(), sh.all_reduce.calls, sh.all_reduce.bytes
        lg, st = decode_step(params, st, toks[:, i:i + 1], cfg, par=pb)
        rows.append(whole(lg)[:, : cfg.vocab_size])
        sync(device)
        steps.append(time.perf_counter() - t0)
        if split:      # the step wrote its slot, then attended the block as it is now
            stats["empty_steps"] += int(not bool((st["unit"][attn].k_pos >= 0).any()))
        stats["step_all_reduces"] = sh.all_reduce.calls - calls
        stats["step_all_reduce_bytes"] = sh.all_reduce.bytes - nbytes
    stats["step_ms"] = statistics.median(steps) * 1e3
    return torch.stack(rows), stats


def _shard_batch(cfg, B, S, device, par=None):
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    b = SyntheticTokenPipeline.batch_at(cfg, DataConfig(global_batch=B, seq_len=S, seed=0),
                                        0)
    if par is not None:
        n = B // par.dp
        b = {k: v[par.dp_rank * n:(par.dp_rank + 1) * n] for k, v in b.items()}
    return batch_to_torch(b, device)


def _shard_train_step(cfg, par=None):
    from repro_torch.models.api import make_train_step
    return make_train_step(cfg, peak_lr=TRAIN_LR, total_steps=TRAIN_STEPS, remat="unit",
                           par=par)


def shard_references(device, refs: str, tag: str = "18") -> None:
    """Each case on one rank, on this card, into ``refs``: serve logits, the
    train step's loss and parameters (and the gradients of SHARD_GRADS's
    leaves), moonshot's logits and routing."""
    import numpy as np
    import torch
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.models.api import loss_and_grads
    from repro_torch.models.transformer import forward
    from repro_torch.optim import adamw_init
    for case, (arch, _, _, work) in SHARD_CASES.items():
        if work == "zero1":                  # held against its own ranks' other step
            continue
        cfg = _shard_cfg(case)
        t0 = time.perf_counter()
        params, _ = _shard_params(cfg, device)
        ref = {}
        if work == "serve":
            B, P, K, C = SHARD_SERVE[case]
            rng = np.random.default_rng(int(case[2], 36))
            ref["tokens"] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, (B, P + K)).astype(np.int64))
            ref["front"] = _shard_front(cfg, B, case)
            logits, ref["times"] = _shard_serve(params, cfg, ref["tokens"], P, C, device,
                                                front=ref["front"])
            ref["logits"] = logits.cpu()
        elif work == "train":
            B, S = TRAIN_SHAPE
            batch, opt = _shard_batch(cfg, B, S, device), adamw_init(params)
            if case in SHARD_GRADS:
                grads = loss_and_grads(params, batch, cfg, remat="unit")[2]
                ref["grads"] = {k: v.cpu() for k, v in flatten_with_keys(grads)
                                if k.startswith(SHARD_GRADS[case])}
                del grads
            sync(device)
            t1 = time.perf_counter()
            new, _, m = _shard_train_step(cfg)(params, opt, batch, 0)
            sync(device)
            ref["times"] = {"step_s": time.perf_counter() - t1}
            ref["loss"] = float(m["loss"])
            ref["params"] = {k: v.cpu() for k, v in flatten_with_keys(new)}
            del new
        else:
            tokens = torch.randint(0, cfg.vocab_size, (1, SHARD_MOONSHOT_SEQ),
                                   generator=torch.Generator().manual_seed(28))
            sync(device)
            t1 = time.perf_counter()
            with RouteRecorder() as routes:
                logits = forward(params, tokens.to(device), cfg)
            sync(device)
            ref["times"] = {"forward_s": time.perf_counter() - t1}
            ref["logits"] = logits[:, :, : cfg.vocab_size].cpu()
            ref["tokens"] = tokens
            ref["routes"] = [(gt.cpu(), i.cpu()) for gt, i in routes.calls]
        sync(device)
        torch.save(ref, os.path.join(refs, f"{case}.pt"))
        log(f"[{case}] one-rank reference: {arch}, {cfg.n_layers} layers fp32, "
            f"{time.perf_counter() - t0:.1f} s; {json.dumps(ref.get('times', {}))}")
        del params, ref
        free_device(case)


def _rank_case(case: str, rank: int, device, refs: str) -> dict:
    """One case on this rank: the driven path counted, then its checks."""
    import torch
    from repro_torch.core.tree import TreeDef, flatten_with_keys, leaves
    from repro_torch.kernels.diag_recurrence.ops import plan_recurrence
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import sharding as sh
    from repro_torch.models.api import init_opt_state, loss_and_grads
    from repro_torch.models.transformer import forward
    from repro_torch.optim import adamw_init
    arch, _, mesh, work = SHARD_CASES[case]
    cfg = _shard_cfg(case)
    tp = mesh[-1]
    par = sh.Parallel.of(make_local_mesh(tp, device.type, pods=mesh[0] if len(mesh) == 3
                                         else 1), cfg)
    ref = (None if work == "zero1" else
           torch.load(os.path.join(refs, f"{case}.pt"), mmap=True, weights_only=False))
    kernels = kernel_fns()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params, specs = _shard_params(cfg, device, par)
    out = {"mesh": list(mesh), "seq_axes": None}
    n_sms = (torch.cuda.get_device_properties(device).multi_processor_count
             if device.type == "cuda" else 132)
    reset_counts(kernels.values())
    if work == "serve":
        B, P, K, C = SHARD_SERVE[case]
        if not cfg.is_attention_free:
            out["seq_axes"] = par.for_batch(B).seq_axes
        got, out["times"] = _shard_serve(params, cfg, ref["tokens"], P, C, device, par,
                                         front=ref["front"])
        counts = {k: v.launches for k, v in kernels.items()}
        want = ref["logits"].to(device)
        out["rel_err"] = float((got - want).abs().max()) / float(want.abs().max())
        channels = (cfg.d_inner // tp * cfg.ssm_state if cfg.ssm_state
                    else cfg.resolved_lru_width // tp if cfg.lru_width else 0)
        if channels:
            rows = B // par.dp if par.for_batch(B).batch_covers else B
            out["recurrence_plan"] = str(plan_recurrence(
                rows, min(P, 256) if cfg.ssm_state else P, channels, n_sms))
            out["recurrence_routes"] = dict(kernels["diag_recurrence"].launches_by_route)
    elif work == "train":
        B, S = TRAIN_SHAPE
        batch, opt = _shard_batch(cfg, B, S, device, par), adamw_init(params)
        if case in SHARD_GRADS:
            flat_specs = dict(flatten_with_keys(specs))
            grads = loss_and_grads(params, batch, cfg, remat="unit", par=par)[2]
            worst = 0.0
            for k, v in flatten_with_keys(grads):
                if k in ref["grads"]:
                    want = sh.shard_leaf(k, ref["grads"][k], flat_specs[k], par).to(device)
                    worst = max(worst, float((v - want).abs().max())
                                / max(float(want.abs().max()), 1e-30))
            out["grad_rel_err"], out["grads_held"] = worst, len(ref["grads"])
            del grads
            reset_counts(kernels.values())
        if cfg.lru_width:
            out["recurrence_plan"] = str(plan_recurrence(
                B // par.dp, S, cfg.resolved_lru_width // tp, n_sms))
        sync(device)
        t1, calls, nbytes = time.perf_counter(), sh.all_reduce.calls, sh.all_reduce.bytes
        new, _, m = _shard_train_step(cfg, par)(params, opt, batch, 0)
        sync(device)
        out["times"] = {"step_s": time.perf_counter() - t1,
                        "step_all_reduces": sh.all_reduce.calls - calls,
                        "step_all_reduce_bytes": sh.all_reduce.bytes - nbytes}
        counts = launch_counts(kernels)
        flash = kernels["flash_attention"]
        out["flash_per_step"] = {"forward": flash.launches_by_pass["forward"],
                                 "recompute": flash.launches_by_pass["recompute"],
                                 "backward": flash_attention_backward.launches}
        out["local_heads"] = (new["unit"][_attn_index(cfg)]["attn"]["wq"].shape[-1]
                              // cfg.resolved_head_dim)
        if cfg.lru_width:
            out["recurrence_routes"] = dict(kernels["diag_recurrence"].launches_by_route)
        out["loss"], out["ref_loss"] = float(m["loss"]), ref["loss"]
        flat_specs = dict(flatten_with_keys(specs))
        worst = 0.0
        for k, v in flatten_with_keys(new):
            want = sh.shard_leaf(k, ref["params"][k], flat_specs[k], par).to(device)
            worst = max(worst, float((v - want).abs().max()))
        out["param_err"] = worst
    elif work == "zero1":
        B, S = TRAIN_SHAPE
        batch = _shard_batch(cfg, B, S, device, par)
        whole = TreeDef.of(params).unflatten([t.clone() for t in leaves(params)])
        runs = {}
        for name, p, pp in (("whole", whole, par),
                            ("zero1", params, dataclasses.replace(par, zero1=True))):
            opt = init_opt_state(p, cfg, pp)
            moment_bytes = sum(t.numel() * t.element_size()
                               for t in leaves([opt["mu"], opt["nu"]]))
            reset_counts(kernels.values())
            sync(device)
            t1, calls = time.perf_counter(), sh.all_reduce.calls
            new, opt, m = _shard_train_step(cfg, pp)(p, opt, batch, 0)
            sync(device)
            runs[name] = {"params": new, "metrics": (m["loss"], m["grad_norm"]),
                          "moment_bytes": moment_bytes,
                          "step_s": time.perf_counter() - t1,
                          "all_reduces": sh.all_reduce.calls - calls}
            del opt
        counts = launch_counts(kernels)    # the ZeRO-1 step's
        flash = kernels["flash_attention"]
        out["flash_per_step"] = {"forward": flash.launches_by_pass["forward"],
                                 "recompute": flash.launches_by_pass["recompute"],
                                 "backward": flash_attention_backward.launches}
        w, z = runs["whole"], runs["zero1"]
        out["params_bitwise"] = all(torch.equal(_bits(a), _bits(b)) for a, b in
                                    zip(leaves(w["params"]), leaves(z["params"])))
        out["metrics_bitwise"] = all(torch.equal(_bits(a), _bits(b)) for a, b in
                                     zip(w["metrics"], z["metrics"]))
        out["loss"] = float(z["metrics"][0])
        out["moment_bytes"] = {n: r["moment_bytes"] for n, r in runs.items()}
        out["times"] = {"step_s": z["step_s"], "whole_step_s": w["step_s"],
                        "step_all_reduces": z["all_reduces"],
                        "extra_all_reduces": z["all_reduces"] - w["all_reduces"]}
        del whole, runs, w, z
    else:
        sync(device)
        t1, calls, nbytes = time.perf_counter(), sh.all_reduce.calls, sh.all_reduce.bytes
        with RouteRecorder() as routes:
            logits = forward(params, ref["tokens"].to(device), cfg, par=par)
        sync(device)
        out["times"] = {"forward_s": time.perf_counter() - t1,
                        "all_reduces": sh.all_reduce.calls - calls,
                        "all_reduce_bytes": sh.all_reduce.bytes - nbytes}
        counts = {k: v.launches for k, v in kernels.items()}
        got = sh.gather_vocab(logits, par)[:, :, : cfg.vocab_size]
        alike = torch.ones(got.shape[1], dtype=torch.bool, device=device)
        for (_, i), (_, ir) in zip(routes.calls, ref["routes"]):
            alike &= (i[0].sort(-1).values == ir[0].to(device).sort(-1).values).all(-1)
        want = ref["logits"].to(device)
        diff = (got[0] - want[0]).abs().amax(dim=-1)
        out["alike"], out["positions"] = int(alike.sum()), int(alike.numel())
        out["layers_routed"] = len(routes.calls)
        out["rel_err"] = (float(diff[alike].max()) / float(want.abs().max())
                          if bool(alike.any()) else float("inf"))
    out["counts"] = counts
    out["seconds"] = time.perf_counter() - t0
    out["peak_gb"] = (torch.cuda.max_memory_allocated(device) / 1e9
                      if device.type == "cuda" else 0.0)
    del params, ref
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def _bits(t):
    """A float tensor's bits, as integers of its width (bitwise comparison)."""
    import torch
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def shard_rank(rank: int, world: int, refs: str, device_type: str) -> dict:
    """One of the phase's ranks: every case in turn, each on its own mesh;
    returns the results. Any exception ends the rank with a non-zero code,
    which fails the phase."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import rank_device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = rank_device(device_type, rank)
    results = {"backend": dist.get_backend()}
    for case in SHARD_CASES:
        results[case] = _rank_case(case, rank, device, refs)
        r = results[case]
        log(f"[{case} r{rank}] {r['seconds']:.1f} s, peak {r['peak_gb']:.2f} GB, "
            f"launches {r['counts']}" + (f", recurrence {r['recurrence_plan']} "
                                          f"{r['recurrence_routes']}"
                                          if "recurrence_plan" in r else ""))
    return results


def phase_sharded(device, tmp: str, tag: str = "18") -> dict:
    """The cases of SHARD_CASES on SHARD_RANKS ranks sharing this card over
    gloo (NCCL refuses two ranks on one device; with a card a rank, as on a
    four-card host, the ranks take NCCL), each case on its own
    ("data", "model") or ("pod", "data", "model") mesh, fp32, held against
    the same config on one rank on this card: serving logits within
    SERVE_LOGIT_TOL of max |logit| (qwen3-1.7b at 1 x 4 with its kv heads
    split 8/4; at batch 1 on 2 x 2 with the cache's positions split over
    data, the lse merge on the card; fnbench-tiny at 1 x 4 with them split
    over model and its q heads gathered; in both a rank's block holds no live
    slot at first; falcon-mamba-7b at 2 of 64 layers, its recurrence over
    d_inner*N/4 channels a rank; recurrentgemma-2b at 1 x 4, 640 LRU
    channels a rank beside replicated attention; whisper-small at 1 x 4 over
    1,500 frames; internvl2-1b at 2 x 2 with 7 q heads and 1 kv head a rank
    after its 256 patches; qwen3-1.7b on the 2 x 1 x 2 multi-pod mesh), one
    train step each of qwen1.5-0.5b and recurrentgemma-2b (one pattern
    unit) at 2 x 2 (loss within SHARD_TRAIN_TOL relative, parameters within
    SHARD_PARAM_TOL, the RG-LRU's gradients within GRAD_TOL), and
    moonshot-v1-16b-a3b at 2 of 48 layers, 16 experts a rank, where its
    routing agrees. The times are collective round trips through the host
    (gloo), not a tensor-parallel speed."""
    import torch
    from repro_torch.launch.mesh import spawn_local_ranks
    refs = os.path.join(tmp, "sharded")
    os.makedirs(refs, exist_ok=True)
    t0 = time.perf_counter()
    shard_references(device, refs, tag)
    log(f"[{tag}] one-rank references {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    ranks = spawn_local_ranks(shard_rank, SHARD_RANKS, device.type,
                              args=(refs, device.type), timeout=SHARD_TIMEOUT)
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    log(f"[{tag}] {SHARD_RANKS} ranks, backend {ranks[0]['backend']}, on {cards} card(s): "
        f"{time.perf_counter() - t1:.1f} s from start to exit")
    return check_sharded(ranks, tag)


def check_sharded(ranks: list, tag: str = "18") -> dict:
    """The phase's checks, over every rank's results. Each case's summary
    holds its launches summed over the ranks (``counts``)."""
    counts, out = {}, {}
    for case, (arch, _, mesh, work) in SHARD_CASES.items():
        rs = [r[case] for r in ranks]
        r0 = rs[0]
        case_counts = {k: sum(r["counts"][k] for r in rs) for k in r0["counts"]}
        for k, v in case_counts.items():
            counts[k] = counts.get(k, 0) + v
        summary = {"mesh": r0["mesh"], "seq_axes": r0["seq_axes"],
                   "seconds": max(r["seconds"] for r in rs), "times": r0["times"],
                   "peak_gb": [round(r["peak_gb"], 3) for r in rs], "counts": case_counts}
        want = {"serve": ("flash_attention", "decode_attention"),
                "train": ("flash_attention", "flash_attention_backward"),
                "zero1": ("flash_attention", "flash_attention_backward"),
                "forward": ("flash_attention",)}[work]
        if arch == "falcon_mamba_7b":
            want = ("diag_recurrence", "ssm_terms")
        elif arch == "recurrentgemma_2b":
            want = (*want, "diag_recurrence")
        for k in want:
            expect(all(r["counts"][k] > 0 for r in rs),
                   f"[{case}] {k} was not launched on every rank: "
                   f"{[r['counts'][k] for r in rs]}")
        if work == "serve":
            summary["rel_err"] = r0["rel_err"]
            expect(r0["rel_err"] <= SERVE_LOGIT_TOL,
                   f"[{case}] sharded logits differ from one rank's by {r0['rel_err']} of "
                   f"max |logit| > {SERVE_LOGIT_TOL}")
            if case in SHARD_SEQ_AXES:
                summary["empty_steps"] = [r["times"]["empty_steps"] for r in rs]
                expect(list(r0["seq_axes"] or ()) == SHARD_SEQ_AXES[case],
                       f"[{case}] cache positions split over {r0['seq_axes']}, not "
                       f"{SHARD_SEQ_AXES[case]}")
                steps = SHARD_SERVE[case][2] - 1        # the last token is not fed
                expect(any(0 < n < steps for n in summary["empty_steps"]),
                       f"[{case}] no rank attended an empty block and then a live one: "
                       f"{summary['empty_steps']} of {steps} steps")
        if "recurrence_plan" in r0:
            summary["recurrence"] = [r["recurrence_plan"] for r in rs]
            summary["recurrence_routes"] = [r["recurrence_routes"] for r in rs]
            if arch == "recurrentgemma_2b":      # W / tp channels: the chunked route
                expect(all(r["recurrence_routes"]["chunked"] > 0 for r in rs),
                       f"[{case}] the LRU's recurrence never took the chunked route: "
                       f"{summary['recurrence_routes']}")
        if work == "train":
            n_layers = _attn_layers(_shard_cfg(case))
            rel = abs(r0["loss"] - r0["ref_loss"]) / abs(r0["ref_loss"])
            summary.update(loss=r0["loss"], ref_loss=r0["ref_loss"], loss_rel_err=rel,
                           param_err=max(r["param_err"] for r in rs),
                           flash=r0["flash_per_step"], local_heads=r0["local_heads"])
            expect(rel <= SHARD_TRAIN_TOL, f"[{case}] loss {r0['loss']} vs one rank's "
                   f"{r0['ref_loss']}: {rel} > {SHARD_TRAIN_TOL}")
            expect(summary["param_err"] <= SHARD_PARAM_TOL,
                   f"[{case}] parameters after the step differ by {summary['param_err']}")
            expect(r0["flash_per_step"] == dict.fromkeys(r0["flash_per_step"], n_layers),
                   f"[{case}] flash launches a rank {r0['flash_per_step']}, not "
                   f"{n_layers} each")
            if case in SHARD_GRADS:
                summary["grad_rel_err"] = max(r["grad_rel_err"] for r in rs)
                summary["grads_held"] = r0["grads_held"]
                expect(r0["grads_held"] > 0 and summary["grad_rel_err"] <= GRAD_TOL,
                       f"[{case}] gradients of {SHARD_GRADS[case]} differ from one rank's "
                       f"by {summary['grad_rel_err']} of their largest > {GRAD_TOL}")
        elif work == "zero1":
            n_layers = _attn_layers(_shard_cfg(case))
            summary.update(loss=r0["loss"], flash=r0["flash_per_step"],
                           moment_bytes=[r["moment_bytes"] for r in rs],
                           params_bitwise=[r["params_bitwise"] for r in rs],
                           metrics_bitwise=[r["metrics_bitwise"] for r in rs])
            expect(all(r["params_bitwise"] and r["metrics_bitwise"] for r in rs),
                   f"[{case}] the ZeRO-1 step's parameters or loss / grad_norm differ "
                   f"from the step with whole moments: {summary}")
            expect(all(r["moment_bytes"]["zero1"] < r["moment_bytes"]["whole"]
                       for r in rs), f"[{case}] ZeRO-1 did not cut the moments: "
                                     f"{summary['moment_bytes']}")
            expect(r0["times"]["extra_all_reduces"] == 1,
                   f"[{case}] ZeRO-1 added {r0['times']['extra_all_reduces']} "
                   f"all_reduces to the step, not 1")
            expect(r0["flash_per_step"] == dict.fromkeys(r0["flash_per_step"], n_layers),
                   f"[{case}] flash launches a rank {r0['flash_per_step']}")
        elif work == "forward":
            summary.update(alike=r0["alike"], positions=r0["positions"],
                           rel_err=r0["rel_err"])
            expect(r0["alike"] > 0 and r0["rel_err"] <= SERVE_LOGIT_TOL,
                   f"[{case}] moonshot sharded logits differ by {r0['rel_err']} of max "
                   f"|logit| where routed alike ({r0['alike']} positions)")
        axes = ("pod", "data", "model") if len(mesh) == 3 else ("data", "model")
        log(f"[{case}] {arch} on {' x '.join(f'{a} {n}' for a, n in zip(axes, mesh))}: "
            f"{json.dumps(summary)}")
        out[case] = summary
    out["counts"] = counts
    return out


# ---------------------------------------------------------------------------------
# 19. the simulation track: fleet_vec's cap=1 scan on the card
# ---------------------------------------------------------------------------------

@contextlib.contextmanager
def scan_switch(on: bool):
    """``REPRO_FLEET_VEC_SCAN`` set to 1 (the scan on the card) or 0 (the
    numpy solver) inside the block."""
    old = os.environ.get("REPRO_FLEET_VEC_SCAN")
    os.environ["REPRO_FLEET_VEC_SCAN"] = "1" if on else "0"
    try:
        yield
    finally:
        if old is None:
            del os.environ["REPRO_FLEET_VEC_SCAN"]
        else:
            os.environ["REPRO_FLEET_VEC_SCAN"] = old


@contextlib.contextmanager
def spying(module, name: str, record: list):
    """``module.name`` wrapped inside the block: each call appends
    ``(args, host seconds)`` to ``record``."""
    real = getattr(module, name)

    def spy(*args):
        t0 = time.perf_counter()
        out = real(*args)
        record.append((args, time.perf_counter() - t0))
        return out
    setattr(module, name, spy)
    try:
        yield
    finally:
        setattr(module, name, real)


def same_fleet(a, b, what: str) -> None:
    """Two fleet results bit for bit: sha256 of the sample buffers, == on
    every counter and float sum."""
    import numpy as np
    for f in SIM_SAMPLES:
        x, y = getattr(a, f), getattr(b, f)
        expect(x.dtype == y.dtype and x.shape == y.shape
               and hashlib.sha256(np.ascontiguousarray(x).tobytes()).digest()
               == hashlib.sha256(np.ascontiguousarray(y).tobytes()).digest(),
               f"{what}: {f} differs")
    for f in SIM_COUNTERS:
        expect(getattr(a, f) == getattr(b, f), f"{what}: {f} differs: "
               f"{getattr(a, f)!r} != {getattr(b, f)!r}")


def clock_max_hz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"], capture_output=True,
                         text=True, timeout=60)
    return float(smi.stdout.strip().splitlines()[0]) * 1e6


def check_fleet_scan(device, errs: dict) -> dict:
    """19a: fleet_scan against its plain version (run on the host, where it
    serves), bitwise on all six outputs, at the default segment and warm-up
    and at ``SCAN_SMALL_CUT``; pass 2's rewrites shown to run; the
    all-queued group within 2x the one-thread-a-group kernel; the SASS free
    of DFMA."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels.fleet_scan import fleet_scan, fleet_scan_plain
    from repro_torch.kernels.fleet_scan.ops import SEGMENT, WARMUP
    from repro_torch.kernels.sweep import (SCAN_CHECK, bound_ms, cuda_ms, fleet_scan_split,
                                           fleet_scan_work, scan_check_batch)

    out = {}
    for label, (ka, groups) in SCAN_CHECK.items():
        t, offsets, args = scan_check_batch(label)
        t_d, off_d = t.to(device), offsets.to(device)
        t0 = time.perf_counter()
        want = fleet_scan_plain(t, offsets, *args)
        plain_ms = (time.perf_counter() - t0) * 1e3
        cuts = {}
        for segment, warmup in ((SEGMENT, WARMUP), SCAN_SMALL_CUT):
            got = [o.cpu() for o in fleet_scan(t_d, off_d, *args, segment=segment,
                                               warmup=warmup)]
            for name, g, w in zip(SCAN_OUTPUTS, got, want):
                expect(g.dtype == w.dtype and torch.equal(g, w),
                       f"fleet_scan ({label}, segment {segment}, warm-up {warmup}): "
                       f"{name} differs from the plain version")
            cuts[f"{segment}/{warmup}"] = dict(fleet_scan.last)
        n_cold, n_queued = int(want[4].sum()), int(want[5].sum())
        n_warm = int(offsets[-1]) - n_cold - n_queued
        expect(n_queued > 0 and (n_warm > 0 and n_cold > len(groups) or label == "queued"),
               f"fleet_scan ({label}): {n_cold} cold starts, {n_queued} queued and "
               f"{n_warm} warm arrivals leave a branch untested")
        moved, ops, chain = fleet_scan_work(offsets)
        bound, by = bound_ms(moved, ops, torch.float64)

        def call():
            return fleet_scan(t_d, off_d, *args)

        ms = cuda_ms(call, iters=5, per=2, warmup=1)
        split = fleet_scan_split(call)
        longest = int(offsets.diff().max())
        lengths = [n for _, n in groups]
        log(f"[19a] fleet_scan, {label} batch, keep-alive {ka} min, groups {lengths}: "
            f"bitwise equal to the plain version on all six outputs ({n_cold} cold, "
            f"{n_queued} queued, {n_warm} warm) at segment/warm-up {list(cuts)}; "
            f"segments, rounds, repaired arrivals, launches: "
            + "; ".join(f"{c}: {v['segments']}, {v['rounds']}, {v['repaired']}, "
                        f"{v['launches']}" for c, v in cuts.items())
            + f"; call {ms:.4f} ms (pass 1 {split['pass1_ms']:.4f}, pass 2 "
            f"{split['pass2_ms']:.4f} ms on the device), plain (host CPU) "
            f"{plain_ms:.1f} ms, bound {bound:.5f} ms ({by}), longest segment's chain "
            f"{chain} steps (longest group {longest})")
        out[label] = {"lengths": lengths, "keep_alive_min": ka, "ms": ms, **split,
                      "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
                      "chain": chain, "longest": longest, "cuts": cuts}
    expect(any(v["repaired"] > 0 for o in out.values() for v in o["cuts"].values()),
           "fleet_scan's pass 2 rewrote no arrival on any batch: its repair never ran")
    queued = out["queued"]
    group_ms = GROUP_KERNEL_MS_PER_STEP * queued["longest"]
    log(f"[19a] all-queued group of {queued['longest']} arrivals: {queued['ms']:.4f} ms "
        f"against the one-thread-a-group kernel's {group_ms:.4f} ms from the record "
        f"({GROUP_KERNEL_MS_PER_STEP * 1e6:.2f} ns a step, row 5 of PERF.md): "
        f"{queued['ms'] / group_ms:.2f}x")
    expect(queued["ms"] <= 2 * group_ms,
           f"the all-queued group took {queued['ms']:.4f} ms, over twice the "
           f"one-thread-a-group kernel's {group_ms:.4f} ms")
    out["queued"]["group_kernel_ms"] = group_ms
    errs["fleet_scan"] = 0.0
    dfma = sass_count(build.library("fleet_scan"), "DFMA")
    dadd = sass_count(build.library("fleet_scan"), "DADD")
    log(f"[19a] fleet_scan SASS: {dfma} DFMA, {dadd} DADD instructions")
    expect(dfma == 0, f"fleet_scan's SASS holds {dfma} DFMA: a fused multiply-add "
                      f"rounds once where the reference rounds twice")
    out["dfma"] = dfma
    return out


def host_profile(fn, top: int = 10) -> dict:
    """``fn()`` under cProfile: the ``top`` entries with the most cumulative
    seconds and the ``top`` with the most own seconds, each as (function,
    calls, cumulative s, own s)."""
    import cProfile
    import pstats
    prof = cProfile.Profile()
    prof.runcall(fn)
    entries = [(f"{os.path.relpath(f, ROOT) if f.startswith(ROOT) else f}:{line}({name})",
                calls, cum, own)
               for (f, line, name), (_, calls, own, cum, _) in pstats.Stats(prof).stats.items()]
    return {"cumulative": sorted(entries, key=lambda e: e[2], reverse=True)[:top],
            "own": sorted(entries, key=lambda e: e[3], reverse=True)[:top]}


def phase_fleet_scale(device, tag: str = "19b") -> dict:
    """19b: azure_scale_xl (2,000 Zipf functions over 32 images, two weeks, 4
    workers, affinity) with every group capped at one instance, through
    ``scenario.run`` with ``engine="fleet_vec"``: the scan on the card against
    the numpy solver, bit for bit, for warmswap and prebaking; then one
    method's scan run again under cProfile (the host code's first profile)."""
    import numpy as np
    import torch
    from repro_torch.core import fleet_vec as fv
    from repro_torch.core.fleet import FleetConfig
    from repro_torch.core.scenario import RunOverrides, Scenario, run
    from repro_torch.core.simulator import COST_MODELS
    from repro_torch.core.traces import TRACE_GENERATORS
    from repro_torch.kernels.sweep import (bound_ms, cuda_ms, fleet_scan_split,
                                           fleet_scan_work)

    # the subpackage, whose attribute fleet_vec looks the wrapper up in at each call
    fs = importlib.import_module("repro_torch.kernels.fleet_scan")
    scn = Scenario.from_file(os.path.join(SCENARIOS, "azure_scale_xl.json")) \
        .with_overrides({"max_instances_per_fn": 1})
    t0 = time.perf_counter()
    traces = TRACE_GENERATORS.build(scn.traces.name, **scn.traces.kwargs)
    gen_s = time.perf_counter() - t0
    n_inv = sum(len(t.arrivals_min) for t in traces)
    cost = COST_MODELS.build(scn.cost.name, **scn.cost.kwargs)
    fleet = FleetConfig(n_workers=scn.n_workers, placement=scn.placement.name,
                        max_instances_per_fn=1, keep_alive_min=scn.keep_alive_min)
    for m in scn.methods:
        reason = fv.fast_path_reason(traces, m, cost, fleet)
        expect(reason is None, f"azure_scale_xl/{m} at cap 1 leaves the fast path: "
                               f"{reason}")
    ov = RunOverrides(traces=traces)
    kernel_calls, solver_calls = [], []
    reset_counts([fs.fleet_scan])
    with scan_switch(True), spying(fs, "fleet_scan", kernel_calls):
        t0 = time.perf_counter()
        on_card = run(scn, overrides=ov)
        scan_s = time.perf_counter() - t0
    counts = {"fleet_scan": fs.fleet_scan.launches}
    groups = fv.SCAN_STATS["groups"]
    expect(counts["fleet_scan"] == len(scn.methods),
           f"the scan run launched fleet_scan {counts['fleet_scan']} times, not once "
           f"per method")
    with scan_switch(False), spying(fv, "_solve_group", solver_calls):
        t0 = time.perf_counter()
        on_host = run(scn, overrides=ov)
        numpy_s = time.perf_counter() - t0
    expect(fv.SCAN_STATS["groups"] == 0, "the numpy run went through the scan")
    for m in scn.methods:
        same_fleet(on_card.raw[m], on_host.raw[m], f"azure_scale_xl/{m}: scan vs numpy")
    expect(on_card.to_dict() == on_host.to_dict(), "azure_scale_xl results differ")
    args = kernel_calls[0][0]               # warmswap's batch, as the path gave it
    offsets = args[1].cpu().numpy()
    lengths = np.diff(offsets)
    moved, ops, chain = fleet_scan_work(offsets)
    ms = cuda_ms(lambda: fs.fleet_scan(*args), iters=3, per=1, warmup=1)
    split = fleet_scan_split(lambda: fs.fleet_scan(*args), n=3)
    last = dict(fs.fleet_scan.last)
    kernel_ms = split["pass1_ms"] + split["pass2_ms"]
    bound, by = bound_ms(moved, ops, torch.float64)
    chain_ms = 2 * chain / clock_max_hz() * 1e3
    solver_ms = sum(dt for _, dt in solver_calls[:groups]) * 1e3
    n_groups = len(offsets) - 1
    worst = max(float(np.abs(on_card.raw[m].latency_samples_s
                             - on_host.raw[m].latency_samples_s).max())
                for m in scn.methods)
    sha = {m: hashlib.sha256(on_card.raw[m].latency_samples_s.tobytes()).hexdigest()[:16]
           for m in scn.methods}
    log(f"[{tag}] azure_scale_xl at cap 1: {n_inv} invocations of {len(traces)} "
        f"functions (generated in {gen_s:.1f} s), {n_groups} groups, the longest "
        f"{int(lengths.max())} arrivals; scan on the card == numpy solver for "
        f"{', '.join(scn.methods)} (latency sha256 {sha}, every counter ==)")
    log(f"[{tag}] wall: scan run {scan_s:.2f} s, numpy run {numpy_s:.2f} s "
        f"({len(scn.methods)} methods each); fleet_scan call {ms:.4f} ms on the card, "
        f"its kernels {kernel_ms:.4f} ms (pass 1 {split['pass1_ms']:.4f}, pass 2 "
        f"{split['pass2_ms']:.4f}; {n_inv / (ms * 1e-3):.3e} arrivals/s); bound "
        f"{bound:.4f} ms ({by}): {bound / ms:.2%} of the call, {bound / kernel_ms:.2%} "
        f"of the kernels; the longest segment's chain {chain} steps, floor {chain_ms:.5f} "
        f"ms; segments {last['segments']}, rounds {last['rounds']}, repaired "
        f"{last['repaired']}, launches {last['launches']}; numpy solver {solver_ms:.1f} "
        f"ms on the host over the same groups; wrapper calls {counts}")
    one = scn.with_overrides({"methods": scn.methods[:1]})
    with scan_switch(True):
        t0 = time.perf_counter()
        top = host_profile(lambda: run(one, overrides=ov))
        prof_s = time.perf_counter() - t0
    for order in ("cumulative", "own"):
        log(f"[{tag}] cProfile of the {scn.methods[0]} scan run ({prof_s:.2f} s under the "
            f"profiler), the ten entries with the most {order} seconds (cumulative s, own "
            f"s, calls):")
        for name, calls, cum, own in top[order]:
            log(f"[{tag}]   {cum:9.3f} {own:9.3f} {calls:>9} {name}")
    return {"counts": counts, "row": {
        "shape": f"azure_scale_xl cap=1 warmswap batch: {n_groups} groups, {int(offsets[-1])} "
                 f"arrivals, longest {int(lengths.max())}, {last['segments']} segments "
                 f"(ms: the wrapper's call; kernel_ms: its kernels' device time; "
                 f"plain_ms: the numpy solver, fleet_vec._solve_group, on the host "
                 f"over the same groups; max_abs_err: scan vs numpy solver samples)",
        "max_abs_err": worst, "ms": ms, "kernel_ms": kernel_ms, "plain_ms": solver_ms,
        "bound_ms": bound, "bound_by": by, "chain_floor_ms": chain_ms},
        "summary": {"invocations": n_inv, "groups": n_groups,
                    "longest": int(lengths.max()), "segment_chain": chain,
                    "scan_run_s": scan_s, "numpy_run_s": numpy_s, "trace_s": gen_s,
                    "call_ms": ms, **split, "bound_ms": bound, "chain_floor_ms": chain_ms,
                    "numpy_solver_ms": solver_ms, "fleet_scan_last": last,
                    "arrivals_per_s": n_inv / (ms * 1e-3),
                    "profile_s": prof_s, "profile_top": top}}


def phase_fleet_band(device, tag: str = "19c") -> dict:
    """19c: page_headline at smoke scale through ``fleet`` and through
    ``fleet_vec`` with the scan on the card (equal, and the paper's 2.2-3.2x
    dependency-loading band), and sharing_fig7's memory saving."""
    from repro_torch.core.fleet_vec import SCAN_STATS
    from repro_torch.core.scenario import Scenario, run
    from repro_torch.kernels import fleet_scan

    scn = Scenario.from_file(os.path.join(SCENARIOS, "page_headline.json")).smoke_scaled()
    event = run(scn.with_overrides({"engine": "fleet"}))
    reset_counts([fleet_scan])
    with scan_switch(True):
        vec = run(scn.with_overrides({"engine": "fleet_vec"}))
    counts = {"fleet_scan": fleet_scan.launches}
    expect(counts["fleet_scan"] > 0 and SCAN_STATS["groups"] > 0,
           "page_headline's fleet_vec run did not launch fleet_scan")
    for m in scn.methods:
        same_fleet(event.raw[m], vec.raw[m], f"page_headline/{m}: fleet vs fleet_vec")
    expect(event.summary == vec.summary, "page_headline summaries differ")
    speedup = vec.summary["dependency_loading_speedup"]
    expect(2.2 <= speedup <= 3.2, f"dependency_loading_speedup {speedup} outside 2.2-3.2")
    fig7 = run(Scenario.from_file(os.path.join(SCENARIOS, "sharing_fig7.json")))
    saving = fig7.summary["memory_saving_vs_prebaking"]
    log(f"[{tag}] page_headline (smoke): fleet == fleet_vec (scan on the card, "
        f"launches {counts}); dependency_loading_speedup {speedup!r}; sharing_fig7 "
        f"memory_saving_fraction {saving!r}")
    return {"counts": counts, "dependency_loading_speedup": speedup,
            "memory_saving_fraction": saving}


def phase_predicted(cfg, manager, tmp: str, tag: str = "19d") -> dict:
    """19d: the paper's page model (``PageCostModel``, tier ``local``) beside
    the measured cold-start totals of qwen1.5-0.5b on the card."""
    from repro_torch.core import COST_MODELS, PAGE_COST_MODELS
    from repro_torch.kernels import page_gather

    page = PAGE_COST_MODELS.build("default", cost=COST_MODELS.build("paper_table2"))
    reset_counts([page_gather])
    got = phase_coldstart(cfg, manager, tmp, tag, "qwen-19d", baseline_rounds=1,
                          page_model=page)
    counts = {"page_gather": page_gather.launches}
    expect(counts["page_gather"] > 0, "the warmswap restores launched no page_gather")
    pred = got.pop("predicted")
    table = {"warmswap": {"predicted_s": pred["warmswap"],
                          "measured_s": got["warmswap/bulk"]},
             "warmswap/no_pageserver": {"predicted_s": pred["warmswap"],
                                        "measured_s": got["warmswap/no_pageserver"]},
             "baseline": {"predicted_s": pred["baseline"],
                          "measured_s": got.get("baseline")}}
    for row in table.values():
        if row["measured_s"]:
            row["measured_over_predicted"] = row["measured_s"] / row["predicted_s"]
    log(f"[{tag}] predicted (paper page model, local tier, image "
        f"{manager.live_image_bytes(cfg.name)} B) against measured cold starts (s): "
        f"{json.dumps(table)}; launches {counts}")
    return {"counts": counts, "table": table}


# ---------------------------------------------------------------------------------
# 20. bf16 training (the bf16 flash backward), ZeRO-1 (20c runs in phase 18's
# ranks), the experiments layer with the scan on the card
# ---------------------------------------------------------------------------------

#: 20a: qwen1.5-0.5b's training attention, bf16: B, H, Hkv, S, d (causal)
BF16_GRAD = (4, 16, 16, 1024, 64)
BF16_GRAD_TOL = 2e-2       # of the largest |gradient| in each of dq, dk, dv: bf16's bar
#: 20b: peak rate of the bf16 run (one warm-up step). An Adam step moves a
#: weight by about the rate; a bf16 weight of magnitude 0.02 has an ulp of
#: 1.2e-4, so phase 14's 3e-5 .. 3e-4 would round most steps away
BF16_TRAIN_LR = 1e-3
#: 20d: the sweep over page_headline at smoke scale on the vectorized engine
#: (every group cap=1, so the scan takes them all), four trace seeds; not 3: it
#: draws a function of 112 M arrivals a day, and seeds 0-3 took 370 s with the
#: numpy solver and 66 s with the scan (one H100 host)
EXPERIMENT_AXES = ["--axis", "engine=fleet_vec", "--axis", "traces.kwargs.seed=0,1,2,4"]
EXAMPLES = os.path.join(ROOT, "examples")
#: the port's examples phase 21 runs, each at the reference example's default
#: flags: sub-phase -> (file in examples/, the kernels its run must launch)
EXAMPLE_RUNS = {
    "21a": ("quickstart_torch", ("page_gather", "flash_attention")),
    "21b": ("multi_tenant_fleet_torch", ("page_gather", "flash_attention")),
    "21c": ("train_small_torch", ("flash_attention", "flash_attention_backward")),
    "21d": ("serve_e2e_torch", ("page_gather", "flash_attention", "decode_attention")),
    "21e": ("fleet_sim_torch", ()),
}
MULTI_TENANT_POOL = 46_137_344     # bytes of model-tiny's image in the pool (the reference's)
SERVE_E2E_REQUESTS = 24            # examples/serve_e2e.py's default --requests


def check_bf16_backward(device, errs: dict, tag: str = "20a") -> dict:
    """20a: the tensor-core forward's rows' lse and the bf16 backward kernels
    at qwen1.5-0.5b's training shape against the plain version on the same
    bf16 inputs: lse within LSE_TOL of the plain logsumexp of the fp32
    logits; dq, dk, dv (bf16) each within BF16_GRAD_TOL of its largest
    |entry| of torch.autograd.grad through the plain version."""
    import torch
    from repro_torch.kernels.flash_attention.ops import (_plain_scores,
                                                         flash_attention_backward,
                                                         flash_attention_backward_plain)
    B, H, Hkv, S, d = BF16_GRAD
    gen = torch.Generator(device=device).manual_seed(41)
    q = torch.randn((B, H, S, d), generator=gen, device=device).to(torch.bfloat16)
    k, v = (torch.randn((B, Hkv, S, d), generator=gen, device=device).to(torch.bfloat16)
            for _ in range(2))
    dout = torch.randn(q.shape, generator=gen, device=device).to(torch.bfloat16)
    out, lse = torch.ops.repro_torch.flash_attention(q, k, v, True, None, None, d ** -0.5,
                                                     True)
    want = torch.logsumexp(_plain_scores(q, k, True, None, None, None), -1).reshape(lse.shape)
    lse_err = float((lse - want).abs().max())
    expect(lse_err <= LSE_TOL[0] + LSE_TOL[1] * float(want.abs().max()),
           f"[{tag}] tc_bf16 lse differs from the plain one by {lse_err}")
    before = flash_attention_backward.launches
    on_route = flash_attention_backward.launches_by_route[bwd_route("bfloat16")]
    got = flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    sync(device)
    expect(flash_attention_backward.launches == before + 1
           and flash_attention_backward.launches_by_route[bwd_route("bfloat16")]
           == on_route + 1,
           f"[{tag}] the bf16 backward did not launch its kernel on {bwd_route('bfloat16')}")
    ref = flash_attention_backward_plain(q, k, v, dout, causal=True)
    worst, rel = 0.0, []
    for name, g, r in zip("qkv", got, ref):
        scale = float(r.float().abs().max())
        err = float((g.float() - r.float()).abs().max())
        expect(g.dtype == torch.bfloat16 and bool(torch.isfinite(g).all())
               and err <= BF16_GRAD_TOL * scale,
               f"[{tag}] bf16 flash backward d{name}: {g.dtype}, max |err| {err:.3e} "
               f"against {BF16_GRAD_TOL} x {scale:.3e}")
        worst = max(worst, err)
        rel.append(err / scale)
    errs["flash_attention_backward:bf16"] = worst
    log(f"[{tag}] bf16 flash backward B{B} H{H}/{Hkv} S{S} d{d} causal: lse max |err| "
        f"{lse_err:.3e}; max |err| / max |g| dq {rel[0]:.3e} dk {rel[1]:.3e} dv "
        f"{rel[2]:.3e} (bar {BF16_GRAD_TOL}); max |err| {worst:.3e}")
    return {"lse_err": lse_err, "rel_err": rel, "max_abs_err": worst}


def phase_train_bf16(device, fp32: dict, tag: str = "20b") -> dict:
    """20b: qwen1.5-0.5b at full width and depth in bf16 (parameters bf16,
    AdamW moments fp32), B=4, S=1024, remat=unit, TRAIN_STEPS steps through
    ``models/api.make_train_step`` (the launcher trains in fp32, as the
    reference's does): every flash launch on the tensor-core route, 24
    forwards, recomputes and bf16 backwards a step, a finite falling loss;
    step time and tokens/s beside phase 14's fp32 run (``fp32``); then one
    profiled step (device busy share, the kernels that took the most)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves
    from repro_torch.data import DataConfig, SyntheticTokenPipeline, batch_to_torch
    from repro_torch.models.api import init_opt_state, make_train_step
    from repro_torch.models.transformer import init_params
    kernels = {k: v for k, v in kernel_fns().items()
               if k in ("flash_attention", "flash_attention_backward")}
    cfg = get_config("qwen1_5_0_5b")
    B, S = TRAIN_SHAPE
    params = init_params(torch.Generator(device=device).manual_seed(0), cfg, torch.bfloat16)
    opt = init_opt_state(params, cfg)
    step_fn = make_train_step(cfg, peak_lr=BF16_TRAIN_LR, warmup_steps=1, total_steps=100,
                              remat="unit")
    data = DataConfig(global_batch=B, seq_len=S, seed=0)
    batches = [batch_to_torch(SyntheticTokenPipeline.batch_at(cfg, data, s), device)
               for s in range(TRAIN_STEPS)]
    torch.cuda.reset_peak_memory_stats(device)
    reset_counts(kernels.values())
    losses, times = [], []
    for s, batch in enumerate(batches):
        sync(device)
        t0 = time.perf_counter()
        params, opt, m = step_fn(params, opt, batch, s)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)
    counts = launch_counts(kernels)
    flash = kernels["flash_attention"]
    per_step = {"forward": flash.launches_by_pass["forward"] / TRAIN_STEPS,
                "recompute": flash.launches_by_pass["recompute"] / TRAIN_STEPS,
                "backward": kernels["flash_attention_backward"].launches / TRAIN_STEPS}
    expect(per_step == dict.fromkeys(per_step, cfg.n_layers),
           f"[{tag}] {per_step} flash launches a step, not {cfg.n_layers} each")
    expect(flash.launches_by_route["tc_bf16"] == flash.launches,
           f"[{tag}] flash routes {flash.launches_by_route}: not all tc_bf16")
    expect(counts[f"flash_attention_backward:{bwd_route('bfloat16')}"]
           == counts["flash_attention_backward"],
           f"[{tag}] backward routes {counts}: not all {bwd_route('bfloat16')}")
    expect(all(p.dtype in (torch.bfloat16, torch.float32) for p in leaves(params))
           and any(p.dtype == torch.bfloat16 for p in leaves(params)),
           f"[{tag}] the parameters left bf16")
    expect(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
           f"[{tag}] bf16 training loss: {losses}")
    step_s = statistics.median(times[1:])
    peak = torch.cuda.max_memory_allocated(device) / 1e9
    prof = profile_step(step_fn, params, opt, batches[-1], TRAIN_STEPS, tag)
    log(f"[{tag}] qwen1.5-0.5b bf16 B{B} S{S} remat=unit, {TRAIN_STEPS} steps (peak rate "
        f"{BF16_TRAIN_LR}): loss {losses[0]:.4f} -> {losses[-1]:.4f}; step times (s, after "
        f"the first) {[round(t, 4) for t in times[1:]]}; median {step_s:.4f} s, "
        f"{B * S / step_s:.1f} tokens/s (with the backward on CUDA cores: "
        f"{CUDA_CORE_BWD_STEP_S[tag]} s; phase 14 fp32: {fp32['median_step_s']:.4f} s, "
        f"{fp32['tokens_per_s']:.1f} tokens/s); first step {times[0]:.3f} s; peak "
        f"{peak:.2f} GB; launches a step {per_step}")
    del params, opt, batches
    return {"counts": counts, "losses": losses, "median_step_s": step_s,
            "tokens_per_s": B * S / step_s, "first_step_s": times[0], "peak_gb": peak,
            "fp32_median_step_s": fp32["median_step_s"],
            "fp32_tokens_per_s": fp32["tokens_per_s"], "flash_per_step": per_step, **prof}


def phase_experiments(device, tmp: str, tag: str = "20d") -> dict:
    """20d: the experiments CLI (``python -m repro_torch.experiments``'s
    ``main``) with ``REPRO_FLEET_VEC_SCAN=1`` on the card: a sweep of
    page_headline (smoke, fleet_vec, 4 seeds) serially and on 2 spawned
    workers, each point's groups in one fleet_scan launch per method; both
    stores byte-equal, and equal to the store with the scan off (the numpy
    solver); then the smoke tournament (36 cells, the event engine) with
    every method's minimum oracle gaps finite and >= 0."""
    import io
    from repro_torch.experiments import main as experiments
    from repro_torch.kernels import fleet_scan
    spec = os.path.join(SCENARIOS, "page_headline.json")
    cli_log = io.StringIO()

    def cli(*argv) -> float:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cli_log), contextlib.redirect_stderr(cli_log):
            rc = experiments(list(argv))
        expect(rc == 0, f"[{tag}] experiments {argv[0]} exited {rc}")
        return time.perf_counter() - t0

    stores, secs = {}, {}
    for name, scan, extra in (("serial", True, ()), ("parallel", True, ("--parallel", "2")),
                              ("numpy", False, ())):
        path = os.path.join(tmp, f"sweep_{name}.jsonl")
        if name == "serial":
            reset_counts([fleet_scan])
        with scan_switch(scan):
            secs[name] = cli("sweep", spec, "--smoke", *EXPERIMENT_AXES, "--store", path,
                             "--device", "cuda", *extra)
        if name == "serial":
            counts = {"fleet_scan": fleet_scan.launches}
        with open(path, "rb") as f:
            stores[name] = f.read()
    n_points = len(EXPERIMENT_AXES[-1].split("=")[1].split(","))
    expect(counts["fleet_scan"] == 2 * n_points,
           f"[{tag}] the serial sweep launched fleet_scan {counts['fleet_scan']} times, "
           f"not once per point and method")
    expect(stores["serial"] == stores["parallel"] == stores["numpy"],
           f"[{tag}] the stores differ: serial, --parallel 2 and numpy")
    records = stores["serial"].decode().splitlines()[1:]
    expect(len(records) == n_points, f"[{tag}] {len(records)} records, not {n_points}")
    sha = hashlib.sha256(stores["serial"]).hexdigest()[:16]
    out = os.path.join(tmp, "tournament.json")
    secs["tournament"] = cli("tournament", os.path.join(SCENARIOS, "tournament.json"),
                             "--smoke", "--out", out)
    with open(out) as f:
        report = json.load(f)
    gaps = report["min_gaps"]
    expect(len(report["cells"]) == 36 and all(
        math.isfinite(g[k]) and g[k] >= 0 for g in gaps.values()
        for k in ("min_total_gap_s", "min_p99_gap_s")),
        f"[{tag}] tournament: {len(report['cells'])} cells, min gaps {gaps}")
    log(f"[{tag}] experiments sweep of page_headline (smoke, fleet_vec, {n_points} seeds): serial "
        f"{secs['serial']:.2f} s (scan on the card, launches {counts}), --parallel 2 "
        f"{secs['parallel']:.2f} s (scan on the card in 2 spawned workers), numpy "
        f"{secs['numpy']:.2f} s; the three stores byte-equal ({len(stores['serial'])} B, "
        f"sha256 {sha}); tournament (smoke, {len(report['cells'])} cells) "
        f"{secs['tournament']:.2f} s, min gaps {json.dumps(gaps)}")
    return {"counts": counts, "seconds": secs, "store_sha256": sha, "min_gaps": gaps}


# ---------------------------------------------------------------------------------
# 21. the port's examples
# ---------------------------------------------------------------------------------

def load_example(name: str):
    """``examples/<name>.py`` as a module (examples/ is not a package)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_example(tag: str, out: dict, by_route: dict, bwd: dict) -> str:
    """Checks one example's returned numbers; returns its ``[21x]`` line."""
    if tag == "21a":
        for tenant, t in out["tenants"].items():
            expect(t["classes"] == t["baseline_classes"],
                   f"[{tag}] {tenant}: warmswap classes differ from baseline")
        expect(out["builds"] == 1, f"[{tag}] image built {out['builds']} times, want 1")
        expect(by_route["tc_bf16"] > 0 and by_route["cuda_core"] == 0,
               f"[{tag}] flash_attention off the tensor-core route: {by_route}")
        return "; ".join(f"{tenant}: baseline {t['baseline_s']:.4f} s, warmswap "
                         f"{t['warmswap_s']:.4f} s, x{t['speedup']:.2f}"
                         for tenant, t in out["tenants"].items()) + \
            f"; scenario saving {out['scenario_saving']:.4f}"
    if tag == "21b":
        expect((out["cold"], out["warm"]) == (out["twin_cold"], out["twin_warm"]),
               f"[{tag}] live {out['cold']} cold / {out['warm']} warm, twin "
               f"{out['twin_cold']} / {out['twin_warm']}")
        expect(out["pool_bytes"] == MULTI_TENANT_POOL and out["builds"] == 1,
               f"[{tag}] pool {out['pool_bytes']} B, {out['builds']} builds")
        expect(by_route["tc_bf16"] > 0 and by_route["cuda_core"] == 0,
               f"[{tag}] flash_attention off the tensor-core route: {by_route}")
        return (f"{out['invocations']} invocations: {out['cold']} cold "
                f"({out['cold_ms']:.3f} ms avg), {out['warm']} warm ({out['warm_ms']:.3f} ms "
                f"avg) = the twin's; pool {out['pool_bytes']} B")
    if tag == "21c":
        expect(out["last_loss"] < out["first_loss"] and out["restores"] == 1,
               f"[{tag}] loss {out['first_loss']} -> {out['last_loss']}, "
               f"{out['restores']} restores")
        expect(by_route["cuda_core"] > 0 and bwd[bwd_route("float32")] > 0,
               f"[{tag}] the fp32 flash forward / backward routes: {by_route}, {bwd}")
        return (f"loss {out['first_loss']:.4f} -> {out['last_loss']:.4f}, restores "
                f"{out['restores']}, {out['steps_run']} steps, {out['step_s'] * 1e3:.3f} ms "
                f"a step (rollback and checkpoints included)")
    if tag == "21d":
        done = sum(m["completed"] for m in out["served"].values())
        expect(done == SERVE_E2E_REQUESTS and out["recovered_completed"] == 1,
               f"[{tag}] {done} of {SERVE_E2E_REQUESTS} requests, recovered replica "
               f"served {out['recovered_completed']}")
        expect(by_route["cuda_core"] > 0, f"[{tag}] flash_attention routes {by_route}")
        return (f"{done} requests, mean ttft {out['ttft_s'] * 1e3:.3f} ms, wall "
                f"{out['wall_s']:.3f} s; recovery via pool {out['recovery_warm_s']:.4f} s, "
                f"cold reload {out['recovery_cold_s']:.4f} s, x{out['recovery_ratio']:.2f}")
    expect(out["sweep_points"] == out["resumed_skipped"] == 2,
           f"[{tag}] sweep {out['sweep_points']} points, resume skipped "
           f"{out['resumed_skipped']}")
    return (f"degenerate avg {out['degenerate_ms']:.2f} ms, memory saving "
            f"{out['saving']:.4f}; the example's own asserts held")


def phase_examples(device, tag: str = "21") -> dict:
    """21: the port's five examples through their ``main`` on ``device`` at the
    reference examples' default flags, the launch counters set to 0 before
    each and read after it; each must launch its path's kernels."""
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    kernels = kernel_fns()
    result = {"counts": {}, "seconds": {}}
    for sub, (name, needed) in EXAMPLE_RUNS.items():
        mod = load_example(name)
        reset_counts(kernels.values())
        t0 = time.perf_counter()
        out = mod.main(["--device", str(device)])
        sync(device)
        result["seconds"][sub] = time.perf_counter() - t0
        counts = launch_counts(kernels)
        result["counts"][sub] = counts
        by_route = dict(flash_attention.launches_by_route)
        bwd = dict(flash_attention_backward.launches_by_route)
        for kernel in needed:
            expect(counts[kernel] > 0, f"[{sub}] {name} did not launch {kernel}")
        line = check_example(sub, out, by_route, bwd)
        if "store" in out:                              # fleet_sim's sweep store
            shutil.rmtree(os.path.dirname(out["store"]), ignore_errors=True)
        log(f"[{sub}] {name}: {line}; {result['seconds'][sub]:.2f} s; launches "
            f"{ {k: n for k, n in counts.items() if n} }")
    total = sum(result["seconds"].values())
    log(f"[{tag}] the five examples took {total:.1f} s")
    return result


def _flash_row(gen, device, dtype, B, H, Hkv, Sq, Sk, d, causal, window, label: str):
    """Times flash_attention at one shape beside its plain version and SDPA
    (given the explicit mask where a window cuts keys), with the bound from
    the unmasked (q, k) pairs. Returns the row's numbers."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention
    from repro_torch.kernels.flash_attention import flash_attention_plain
    from repro_torch.kernels.sweep import bound_ms, cuda_ms
    q = torch.randn((B, H, Sq, d), generator=gen, device=device).to(dtype)
    k = torch.randn((B, Hkv, Sk, d), generator=gen, device=device).to(dtype)
    v = torch.randn((B, Hkv, Sk, d), generator=gen, device=device).to(dtype)
    opts = dict(causal=causal, window=window)
    mask = None
    if window is not None and window < Sk:
        qi = torch.arange(Sq, device=device)[:, None]
        ki = torch.arange(Sk, device=device)[None, :]
        mask = (ki <= qi) & (qi - ki < window) if causal else (qi - ki < window)
    t_k = cuda_ms(lambda: flash_attention(q, k, v, **opts))
    t_p = cuda_ms(lambda: flash_attention_plain(q, k, v, **opts))
    t_l = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True))
    pairs = sum(min(i + 1 if causal else Sk, window or Sk) for i in range(Sq))
    ops = 4 * B * H * d * pairs
    moved = q.element_size() * (2 * B * H * Sq * d + 2 * B * Hkv * Sk * d)
    bound, by = bound_ms(moved, ops, dtype)
    log(f"[6] flash_attention {label} {str(dtype).split('.')[1]} B{B} H{H}/{Hkv} Sq{Sq} "
        f"Sk{Sk} d{d} causal={causal} window={window}: kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, sdpa {t_l:.4f} ms, bound {bound:.5f} ms ({by}), "
        f"{ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s")
    return {"ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
            "library_ms": t_l}


def _flash_backward_rows(gen, device, errs: dict, path_counts: dict) -> list:
    """Phase 6's rows of the flash_attention backward (BWD_TIMED): bf16 and
    fp32 at qwen1.5-0.5b's training shape (phases 20b and 14), fp32 at
    qwen3-1.7b's d=128 and recurrentgemma's local d=256 (phase 16's) training
    attention; from a forward that kept its rows' lse, beside the plain
    version (autograd through it, forward included) and SDPA's backward alone
    in the same dtype (the window as a boolean mask). Each row's launches are
    its route's on the main paths (every head dim); an fp32 row states the
    bound of the units it runs on (three TF32 products a product) and the
    CUDA cores' one."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention.ops import (flash_attention_backward,
                                                         flash_attention_backward_plain)
    from repro_torch.kernels.sweep import (PEAK_FLOPS, bound_ms, cuda_ms,
                                           flash_backward_bound_ms, flash_backward_work)
    rows = []
    for label, name, B in BWD_TIMED:
        H, Hkv, Sq, Sk, d, causal, window, cap = FLASH_GRAD[label]
        dtype, route = getattr(torch, name), bwd_route(name)
        q = torch.randn((B, H, Sq, d), generator=gen, device=device).to(dtype)
        k, v = (torch.randn((B, Hkv, Sk, d), generator=gen, device=device).to(dtype)
                for _ in range(2))
        dout = torch.randn(q.shape, generator=gen, device=device).to(dtype)
        opts = dict(causal=causal, window=window, softcap=cap)
        out, lse = torch.ops.repro_torch.flash_attention(q, k, v, causal, window, cap,
                                                         d ** -0.5, True)
        mask = None
        if window is not None and window < Sk:
            qi = torch.arange(Sq, device=device)[:, None]
            ki = torch.arange(Sk, device=device)[None, :]
            mask = (ki <= qi) & (qi - ki < window) if causal else (qi - ki < window)
        t_k = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse, dout, **opts))
        t_p = cuda_ms(lambda: flash_attention_backward_plain(q, k, v, dout, **opts),
                      iters=5, per=2, warmup=1)
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        with torch.enable_grad():
            o_l = F.scaled_dot_product_attention(
                *qkv, attn_mask=mask, is_causal=causal and mask is None, enable_gqa=True)
        t_l = cuda_ms(lambda: torch.autograd.grad(o_l, qkv, dout, retain_graph=True))
        t_k2 = cuda_ms(lambda: flash_attention_backward(q, k, v, out, lse, dout, **opts))
        moved, ops = flash_backward_work(q, k, causal, window)
        bound, by = flash_backward_bound_ms(moved, ops, dtype)
        if dtype == torch.float32:
            core = bound_ms(moved, ops, dtype)[0]
            also = {"bound_cuda_core_ms": core}
            units = (f"3xTF32 at {PEAK_FLOPS['tf32'] / 1e12} TFLOP/s; CUDA cores at "
                     f"{PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s {core:.5f} ms, "
                     f"{core / t_k:.4f} of it")
        else:
            also, units = {}, f"bf16 at {PEAK_FLOPS[dtype] / 1e12:.0f} TFLOP/s"
        n = sum(c.get(f"flash_attention_backward:{route}", 0) for c in path_counts.values())
        log(f"[6] flash_attention backward {label} {name} ({route}) B{B} H{H}/{Hkv} Sq{Sq} "
            f"Sk{Sk} d{d} causal={causal} window={window}: kernel {t_k:.4f} / {t_k2:.4f} ms "
            f"({ops / (t_k * 1e-3) / 1e12:.2f} TFLOP/s of the gradient's 5 products, "
            f"{bound / t_k:.4f} of the bound), plain (autograd through the plain forward) "
            f"{t_p:.4f} ms, sdpa backward {t_l:.4f} ms, bound {bound:.5f} ms ({by}, {units}); "
            f"launches on {route} {n}")
        rows.append({"name": "flash_attention_backward", "route": "cuda",
                     "source": "src/repro_torch/csrc/flash_attention.cu",
                     "replaces": "src/repro/models/attention.py:111",
                     "shape": f"{label} training {name} on {route} B{B} H{H}/{Hkv} Sq{Sq} "
                              f"d{d} causal window={window} (no TPU kernel: the reference "
                              f"differentiates jnp attention; launches: the {route} route's "
                              f"on the main paths, every head dim)",
                     "launches": n, "launches_by_route": {route: n},
                     "max_abs_err": errs["flash_attention_backward" if name == "float32"
                                         else "flash_attention_backward:bf16"],
                     "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                     **also, "library_ms": t_l})
        del q, k, v, dout, out, lse, qkv, o_l, mask
        torch.cuda.empty_cache()
    return rows


def phase_times(img, device, errs: dict, launches: dict, path_counts: dict,
                path_routes: dict, decode_inputs: dict, core_d64: int) -> list:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import (decode_attention, diag_recurrence, flash_attention,
                                     page_gather)
    from repro_torch.kernels.decode_attention import decode_attention_plain
    from repro_torch.kernels.diag_recurrence import diag_recurrence_plain
    from repro_torch.kernels.diag_recurrence.ops import plan_recurrence
    from repro_torch.kernels.page_gather import page_gather_plain
    from repro_torch.kernels.sweep import (HBM_BYTES_PER_S, bound_ms, cold_copies,
                                           cuda_ms, decode_work, l2_bytes,
                                           recurrence_work)

    rows = []
    kernels = kernel_fns()
    saved = {name: k.launches for name, k in kernels.items()}
    # page_gather at the NO_PAGESERVER shape: every 4 MiB page of the qwen image
    store = img.store
    K = store.shape[0]
    ids_host = torch.arange(K, dtype=torch.int32)      # as the page server passes them
    ids_dev = ids_host.to(device)
    ids_long = ids_dev.long()
    nbytes = 2 * K * store.shape[1]
    t_k = cuda_ms(lambda: page_gather(store, ids_host))
    t_d = cuda_ms(lambda: page_gather(store, ids_dev))
    t_p = cuda_ms(lambda: page_gather_plain(store, ids_long))
    t_l = cuda_ms(lambda: torch.index_select(store, 0, ids_long))
    t_k2 = cuda_ms(lambda: page_gather(store, ids_host))
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"[6] page_gather K={K} rows of {store.shape[1]} B: kernel {t_k:.4f} / "
        f"{t_k2:.4f} ms with host ids ({nbytes / (t_k * 1e-3) / 1e9:.1f} GB/s, "
        f"{bound / t_k:.4f} of the bound), {t_d:.4f} ms with device ids (range check "
        f"syncs), plain {t_p:.4f} ms, index_select {t_l:.4f} ms, bound {bound:.4f} ms "
        f"(bytes)")
    # the wrapper's host time per call with host ids, as the page server calls it
    # (device idle before each call; the call itself is not synchronized)
    span = torch.arange(5, 25, dtype=torch.int32)
    for label, ids in (("all pages", ids_host), ("a 20-page span", span)):
        log(f"[6] page_gather wrapper host time per call, {label}, host ids: "
            f"{host_us(lambda: page_gather(store, ids)):.2f} us (of it: id range check "
            f"{host_us(lambda: torch.aminmax(ids)):.2f} us; a pin_memory() copy per call, "
            f"as the earlier wrapper made, would cost "
            f"{host_us(lambda: ids.pin_memory().to(device, non_blocking=True)):.2f} us)")
    rows.append({"name": "page_gather", "route": "cuda",
                 "source": "src/repro_torch/csrc/page_gather.cu",
                 "replaces": "src/repro/kernels/page_gather/kernel.py:27",
                 "shape": f"qwen1.5 store, {K} rows of {store.shape[1]} B, host ids",
                 "launches": launches["page_gather"], "max_abs_err": errs["page_gather"],
                 "ms": t_k, "plain_ms": t_p, "bound_ms": bound, "bound_by": "bytes",
                 "library_ms": t_l})

    gen = torch.Generator(device=device).manual_seed(13)
    flash = {"name": "flash_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_attention.cu",
             "replaces": "src/repro/kernels/flash_attention/kernel.py:93"}
    for (B, H, Hkv, S, d) in FLASH_MAIN:
        row = _flash_row(gen, device, torch.bfloat16, B, H, Hkv, S, S, d, True, None,
                         "qwen1.5 prefill")
        if (H, Hkv, S) == (16, 16, 2048):                # the row: qwen prefill at S=2048
            rows.append({**flash, "shape": f"qwen1.5 prefill bf16 B{B} H{H}/{Hkv} S{S} "
                                           f"d{d} causal",
                         "launches": launches["flash_attention"],
                         "max_abs_err": errs["flash_attention"], **row})
    # the fp32 CUDA-core route at recurrentgemma-2b's local layer and qwen3-1.7b's
    # serving prefill
    B, H, Hkv, S, d, window = FLASH_GRIFFIN
    _flash_row(gen, device, torch.float32, B, H, Hkv, S, S, d, True, window,
               "recurrentgemma-2b local layer")
    B, H, Hkv, S, d = FLASH_QWEN3
    _flash_row(gen, device, torch.float32, B, H, Hkv, S, S, d, True, None,
               "qwen3-1.7b prefill")

    # flash_attention at this slice's shapes: h2o-danube3's d=120 windowed
    # prefill (bf16), whisper's encoder and its cross prefill (fp32); each
    # row's launches are its path's
    def flash_row(dtype, shape, causal, window, path, what):
        B, H, Hkv, Sq, Sk, d = shape
        row = _flash_row(gen, device, dtype, B, H, Hkv, Sq, Sk, d, causal, window, what)
        rows.append({**flash,
                     "shape": f"{what} {str(dtype).split('.')[1]} B{B} H{H}/{Hkv} Sq{Sq} "
                              f"Sk{Sk} d{d} (launches: the {path} path's)",
                     "launches": path_counts[path]["flash_attention"],
                     "max_abs_err": errs[f"flash_attention:{path}"], **row})

    B, H, Hkv, S, d, window = FLASH_H2O
    flash_row(torch.bfloat16, (B, H, Hkv, S, S, d), True, window, "h2o",
              "h2o-danube3 prefill, window 4096")
    B, H, Hkv, S, d = FLASH_ENCODER
    flash_row(torch.float32, (B, H, Hkv, S, S, d), False, None, "whisper",
              "whisper encoder, non-causal")
    flash_row(torch.float32, FLASH_CROSS, False, None, "whisper", "whisper cross prefill")

    rows += _flash_backward_rows(gen, device, errs, path_counts)
    # the fp32 cuda_core route at d=64 (granite-moe's, whisper's and internvl2's
    # fp32 prefills), at granite-moe's serving prefill
    B, H, Hkv, S, d = FLASH_GRANITE
    row = _flash_row(gen, device, torch.float32, B, H, Hkv, S, S, d, True, None,
                     "granite-moe prefill (cuda_core d=64)")
    rows.append({**flash, "shape": f"granite-moe prefill fp32 B{B} H{H}/{Hkv} S{S} d{d} "
                                   f"causal (cuda_core; launches: every fp32 d=64 path's)",
                 "launches": core_d64, "max_abs_err": errs["flash_attention:granite"], **row})
    qh = torch.randn((1, 16, 64, 64), generator=gen, device=device).to(torch.bfloat16)
    log(f"[6] flash_attention wrapper host time per call, qwen1.5 prefill S=64 bf16 (no "
        f"gradient): {host_us(lambda: flash_attention(qh, qh, qh)):.2f} us")

    # decode_attention at each path's decode (qwen3-1.7b, recurrentgemma-2b,
    # granite-moe's g=3, internvl2's g=7, whisper's cross attention over 1500
    # keys, h2o-danube3's d=120 ring), on the first attention layer's cache
    # and mask as each run left them, timed in turns. On the
    # main path each call reads its layer's cache after the other layers'
    # weights, so L2 is cold: `ms` rotates over copies of the cache that move
    # 4 L2 sizes between reuses; `warm_ms` calls one cache back to back. The
    # bound counts the valid slots.
    l2 = l2_bytes(device)

    def decode_case(inputs, H):
        kc, vc, valid = inputs
        q = torch.randn((kc.shape[0], H, kc.shape[3]), generator=gen, device=device,
                        dtype=kc.dtype)
        moved, ops = decode_work(q, kc, valid)
        copies = cold_copies(lambda: (kc.clone(), vc.clone()), moved, l2)
        return q, kc, vc, valid, moved, ops, copies

    def rotate(fn, copies):
        return [lambda c=c: fn(*c) for c in copies]

    cases = {name: decode_case(decode_inputs[name], shape[1])
             for name, (shape, _) in DECODE_TIMED.items()}
    t_dec = {name: {"warm": [], "cold": []} for name in cases}
    for _ in range(2):
        for name, (q, kc, vc, valid, _, _, copies) in cases.items():
            t_dec[name]["warm"].append(cuda_ms(lambda: decode_attention(q, kc, vc, valid)))
            t_dec[name]["cold"].append(cuda_ms(rotate(
                lambda k, v: decode_attention(q, k, v, valid), copies)))
    for name, (q, kc, vc, valid, moved, ops, copies) in cases.items():
        B, Hkv, C, d = kc.shape
        H = q.shape[1]
        (t_k, t_k2), (t_w, t_w2) = t_dec[name]["cold"], t_dec[name]["warm"]
        t_p = cuda_ms(rotate(lambda k, v: decode_attention_plain(q, k, v, valid), copies))
        mask = valid.expand(B, C)[:, None, None, :]
        t_l = cuda_ms(rotate(lambda k, v: F.scaled_dot_product_attention(
            q[:, :, None], k, v, attn_mask=mask, enable_gqa=True), copies))
        bound, by = bound_ms(moved, ops, kc.dtype)
        full = 2 * kc.numel() * kc.element_size() / HBM_BYTES_PER_S * 1e3
        log(f"[6] decode_attention {name} {str(kc.dtype).split('.')[1]} B{B} H{H}/{Hkv} "
            f"C{C} d{d}, {int(valid.expand(B, C).sum())} of {B * C} slots valid: kernel "
            f"cold L2 {t_k:.4f} / {t_k2:.4f} ms ({moved / (t_k * 1e-3) / 1e9:.1f} GB/s of "
            f"needed bytes, {bound / t_k:.4f} of the bound; {len(copies)} caches rotated), "
            f"warm L2 {t_w:.4f} / {t_w2:.4f} ms; plain {t_p:.4f} ms, sdpa {t_l:.4f} ms "
            f"(cold); bound {bound:.5f} ms ({by}); the whole cache would be {full:.5f} ms")
        rows.append({"name": "decode_attention", "route": "cuda",
                     "source": "src/repro_torch/csrc/decode_attention.cu",
                     "replaces": "src/repro/kernels/decode_attention/kernel.py:72",
                     "shape": f"{name} decode B{B} H{H}/{Hkv} C{C} d{d}",
                     "launches": path_counts[name]["decode_attention"],
                     "max_abs_err": errs[f"decode_attention:{name}"], "ms": t_k,
                     "warm_ms": t_w, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                     "library_ms": t_l})
    del cases

    # diag_recurrence at one falcon-mamba SSM chunk (sequential route) and at
    # recurrentgemma's RG-LRU prefill (chunked route), timed in turns, cold L2
    # (rotating over copies of a and b) and warm
    n_sms = torch.cuda.get_device_properties(device).multi_processor_count
    rec_in = {}
    for name, (B, S, C) in RECURRENCE_TIMED.items():
        a = torch.rand((B, S, C), generator=gen, device=device) * 0.5 + 0.5
        b = torch.randn((B, S, C), generator=gen, device=device)
        h0 = torch.randn((B, C), generator=gen, device=device)
        moved, ops = recurrence_work(a)
        rec_in[name] = (a, b, h0, moved, ops,
                        cold_copies(lambda: (a.clone(), b.clone(), h0), moved, l2))
    t_rec = {name: {"warm": [], "cold": []} for name in rec_in}
    for _ in range(2):
        for name, (a, b, h0, _, _, copies) in rec_in.items():
            t_rec[name]["warm"].append(cuda_ms(lambda: diag_recurrence(a, b, h0)))
            t_rec[name]["cold"].append(cuda_ms(rotate(diag_recurrence, copies)))
    for name, (a, b, h0, moved, ops, copies) in rec_in.items():
        B, S, C = a.shape
        (t_k, t_k2), (t_w, t_w2) = t_rec[name]["cold"], t_rec[name]["warm"]
        t_p = cuda_ms(lambda: diag_recurrence_plain(a, b, h0), iters=3, per=2, warmup=1)
        bound, by = bound_ms(moved, ops, a.dtype)
        plan = plan_recurrence(B, S, C, n_sms)
        log(f"[6] diag_recurrence {name} fp32 B{B} S{S} C{C} on {plan.route} (chunk "
            f"{plan.chunk}, {plan.n_chunks} chunks): kernel cold L2 {t_k:.4f} / "
            f"{t_k2:.4f} ms ({moved / (t_k * 1e-3) / 1e9:.1f} GB/s, {bound / t_k:.4f} of "
            f"the bound; {len(copies)} input sets rotated), warm L2 {t_w:.4f} / "
            f"{t_w2:.4f} ms; plain {t_p:.4f} ms, bound {bound:.5f} ms ({by}); no single "
            f"PyTorch call computes it")
        rows.append({"name": "diag_recurrence", "route": "cuda",
                     "source": "src/repro_torch/csrc/diag_recurrence.cu",
                     "replaces": "src/repro/kernels/diag_recurrence/kernel.py:47",
                     "shape": f"{name} B{B} S{S} C{C} ({plan.route})",
                     "launches": path_counts[name]["diag_recurrence"],
                     "launches_by_route": path_routes[name],
                     "max_abs_err": errs[f"diag_recurrence:{name}"], "ms": t_k,
                     "warm_ms": t_w, "plain_ms": t_p, "bound_ms": bound, "bound_by": by,
                     "library_ms": None})
    del rec_in
    for name, n in saved.items():                     # timing launches do not count
        kernels[name].launches = n
    return rows


# ---------------------------------------------------------------------------------

def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: this smoke test runs on the card only", file=sys.stderr)
        return 1
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"the port's package is missing under {src}", file=sys.stderr)
        return 1
    sys.path.insert(0, src)
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    card = timed("1", phase_environment)
    timed("2", phase_build)
    errs: dict = {}
    t0 = time.perf_counter()
    cfg, qmanager, qimg, qparams = phase_qwen_setup(device)
    check_page_gather(qimg.store, device, errs)
    check_flash(device, errs)
    check_decode(device, errs)
    check_decode_lse(device)
    check_diag_recurrence(device, errs)
    check_ssm_terms(device, errs)
    log(f"[3] phase {time.perf_counter() - t0:.1f} s")
    peaks = [free_device("3")]
    timed("3g", check_gradients, device, errs)
    peaks.append(free_device("3g"))
    path_counts: dict = {}           # each driven path's launches, by path
    with tempfile.TemporaryDirectory(prefix="repro-torch-smoke-") as tmp:
        path_counts["quickstart"] = timed("4", phase_quickstart, device, tmp)
        path_counts["qwen1.5"] = timed("5", phase_qwen, cfg, qmanager, qimg, qparams,
                                       device)
        del qparams
        peaks.append(free_device("5"))
        serving = timed("7", phase_serving, device, "qwen3_1_7b", "7")
        path_counts["qwen3"] = serving.pop("counts")
        peaks.append(free_device("7"))
        qwen_cold = timed("6", phase_coldstart, cfg, qmanager, tmp, "6", "qwen",
                          baseline_rounds=3)
        peaks.append(free_device("6"))
        falcon = timed("8", phase_falcon, device, tmp)
        path_counts["falcon"] = falcon.pop("counts")
        peaks.append(free_device("8"))
        griffin = timed("9", phase_serving, device, "recurrentgemma_2b", "9")
        path_counts["recurrentgemma"] = griffin.pop("counts")
        peaks.append(free_device("9"))
        granite = timed("10", phase_serving, device, "granite_moe_3b_a800m", "10")
        path_counts["granite"] = granite.pop("counts")
        peaks.append(free_device("10"))
        moonshot = timed("11", phase_moonshot, device)
        path_counts["moonshot"] = moonshot.pop("counts")
        peaks.append(free_device("11"))
        whisper = timed("12", phase_frontend, device, "whisper_small")
        path_counts["whisper"] = whisper.pop("counts")
        peaks.append(free_device("12"))
        internvl = timed("12", phase_frontend, device, "internvl2_1b")
        path_counts["internvl2"] = internvl.pop("counts")
        peaks.append(free_device("12"))
        h2o = timed("13", phase_h2o, device)
        path_counts["h2o"] = h2o.pop("counts")
        peaks.append(free_device("13"))
        train = timed("14", phase_train_qwen, device, tmp)
        path_counts["train-qwen1.5"] = train.pop("counts")
        peaks.append(free_device("14"))
        rollback = timed("15", phase_rollback, device, tmp)
        peaks.append(free_device("15"))
        griffin_train = timed("16", phase_train_griffin, device)
        path_counts["train-recurrentgemma"] = griffin_train.pop("counts")
        peaks.append(free_device("16"))
        aot = timed("17", phase_aot, device)
        peaks.append(free_device("17"))
        sharded = timed("18", phase_sharded, device, tmp)
        path_counts["sharded"] = sharded.pop("counts")
        peaks.append(free_device("18"))
        t19 = time.perf_counter()
        scan_check = timed("19a", check_fleet_scan, device, errs)
        scale = timed("19b", phase_fleet_scale, device)
        path_counts["azure_scale_xl"] = scale.pop("counts")
        band = timed("19c", phase_fleet_band, device)
        path_counts["page_headline"] = band.pop("counts")
        predicted = timed("19d", phase_predicted, cfg, qmanager, tmp)
        path_counts["predicted"] = predicted.pop("counts")
        log(f"[19] phase {time.perf_counter() - t19:.1f} s")
        peaks.append(free_device("19"))
        t20 = time.perf_counter()
        bf16_check = timed("20a", check_bf16_backward, device, errs)
        peaks.append(free_device("20a"))
        train_bf16 = timed("20b", phase_train_bf16, device, train)
        path_counts["train-bf16"] = train_bf16.pop("counts")
        peaks.append(free_device("20b"))
        experiments = timed("20d", phase_experiments, device, tmp)
        path_counts["experiments"] = experiments.pop("counts")
        log(f"[20] phase {time.perf_counter() - t20:.1f} s (20c ran in phase 18's ranks)")
        peaks.append(free_device("20"))
        examples = timed("21", phase_examples, device)
        for sub, counts in examples.pop("counts").items():
            path_counts[f"example-{sub}"] = counts
        peaks.append(free_device("21"))
    launches = {k: sum(c.get(k, 0) for c in path_counts.values()) for k in kernel_fns()}
    log(f"[6] launches on the main paths: {launches}")
    path_counts["whisper-cross"] = path_counts["whisper"]
    path_routes = {"falcon": falcon.pop("diag_routes"),
                   "recurrentgemma": griffin.pop("diag_routes")}
    for name, case in RECURRENCE_CASES.items():      # a sharded case's ranks, summed
        path_counts[name] = sharded[case]["counts"]
        path_routes[name] = {route: sum(r[route] for r in sharded[case]["recurrence_routes"])
                             for route in sharded[case]["recurrence_routes"][0]}
    # flash_attention's cuda_core launches by head dim: each fp32 path runs one
    core_by_d = {}
    for d, run in ((128, serving), (256, griffin), (64, granite), (64, whisper),
                   (64, internvl)):
        core_by_d[d] = core_by_d.get(d, 0) + run.pop("flash_routes")["cuda_core"]
    log(f"[6] flash_attention cuda_core launches on the main paths by head dim: "
        f"{core_by_d} (d=128: qwen3-1.7b; d=256: recurrentgemma-2b; d=64: granite-moe, "
        f"whisper-small, internvl2-1b)")
    h2o.pop("flash_routes")
    rows = timed("6", phase_times, qimg, device, errs, launches, path_counts, path_routes,
                 {"qwen3": serving.pop("decode_inputs"),
                  "recurrentgemma": griffin.pop("decode_inputs"),
                  "granite": granite.pop("decode_inputs"),
                  "internvl2": internvl.pop("decode_inputs"),
                  "whisper-cross": whisper.pop("decode_inputs"),
                  "h2o": h2o.pop("decode_inputs")},
                 core_by_d.get(64, 0))
    scan = {"name": "fleet_scan", "route": "cuda", "source": "src/repro_torch/csrc/fleet_scan.cu",
            "replaces": "src/repro/core/fleet_vec.py:208", "launches": launches["fleet_scan"],
            "library_ms": None}
    check = scan_check["loose"]
    rows.append({**scan, "shape": f"19a check batch: groups of {check['lengths']}, "
                                  f"keep-alive {check['keep_alive_min']} min (no TPU kernel: "
                                  f"the reference runs jax.lax.scan under XLA; plain_ms: the "
                                  f"plain version on the host CPU, where it serves)",
                 "max_abs_err": errs["fleet_scan"], "ms": check["ms"],
                 "kernel_ms": check["pass1_ms"] + check["pass2_ms"],
                 "plain_ms": check["plain_ms"], "bound_ms": check["bound_ms"],
                 "bound_by": check["bound_by"]})
    rows.append({**scan, **scale.pop("row")})
    log(f"[6] qwen1.5-0.5b cold start, median of 3 (s): {json.dumps(qwen_cold)}")
    log(f"[7] serving summary: {json.dumps(serving)}")
    log(f"[8] falcon-mamba-7b summary: {json.dumps(falcon)}")
    log(f"[9] serving summary: {json.dumps(griffin)}")
    log(f"[10] serving summary: {json.dumps(granite)}")
    log(f"[11] moonshot summary: {json.dumps(moonshot)}")
    log(f"[12] whisper-small summary: {json.dumps(whisper)}")
    log(f"[12] internvl2-1b summary: {json.dumps(internvl)}")
    log(f"[13] h2o-danube3-4b summary: {json.dumps(h2o)}")
    log(f"[14] qwen1.5-0.5b training summary: {json.dumps(train)}")
    log(f"[15] rollback summary: {json.dumps(rollback)}")
    log(f"[16] recurrentgemma-2b training summary: {json.dumps(griffin_train)}")
    log(f"[17] export summary: {json.dumps(aot)}")
    log(f"[18] sharded summary: {json.dumps(sharded)}")
    log(f"[19] simulation summary: {json.dumps({'scan_check': scan_check, **scale, **band, **predicted})}")
    log(f"[20] summary: {json.dumps({'20a': bf16_check, '20b': train_bf16, '20c': sharded['20c'], '20d': experiments})}")
    log(f"[21] examples summary: {json.dumps(examples)}")
    log(f"[6] total smoke time {time.perf_counter() - t_start:.1f} s; "
        f"peak device memory {max(peaks) / 1e9:.2f} GB")
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
