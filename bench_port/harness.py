"""The provider's control loop around the port, the window, and the check.

One ``DependencyManager`` holds the configuration's single live image,
registered once with weights the benchmark makes on the device from the
seed. N tenant functions share it, each with its own 16-class head drawn
from the seed at registration. Invocations are served one at a time, back
to back, in the order the traffic mix draws (``loadgen.py``): an invocation
whose function has a live instance is warm (``FunctionInstance.invoke``);
any other is a cold start (``ColdStartOrchestrator.cold_start_warmswap``
under the mix's restore policy, which serves the invocation as its first
request), after the least recently used instance has been dropped when the
configuration's live-instance cap is reached.

After the window the check holds what the window produced against the
plain fp32 reference (``reference/``), which makes the weights, prompts and
heads again from the seed: the leaves of every instance still live, bitwise,
and the class logits of a sample of the window's invocations.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import importlib.util
import itertools
import json
import subprocess
import sys
import time
import traceback
from collections import Counter, OrderedDict, defaultdict
from pathlib import Path
from types import ModuleType
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from bench_port import devtrace, loadgen
from bench_port.reference import common, weights

HERE = Path(__file__).resolve().parent
MANIFEST = HERE.parent / "BENCHMARK.json"
SPANS = ("traffic", "evict", "cold_start", "invoke")
N_CLASSES = 16
SAMPLE = 24            # invocations the check compares (see :func:`sample`)
TRACE_SECONDS = 8.0    # the traced part at the end of a --trace 1 window
_RUN_IDS = itertools.count()


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    family: ModuleType
    mix: dict
    metrics: List[dict]          # the cell's end-to-end metrics, then its per-layer
    data: Path                   # the folder holding traffic/ and metrics/
    chips: int = 1

    @property
    def cap(self) -> int:
        return int(self.config["live_instance_cap"])


def load_cell(workload: str, manifest: Path = MANIFEST, data: Path = HERE) -> Cell:
    """The cell ``workload`` of ``manifest``: its configuration file (the
    manifest's ``file``), the reference module its ``family`` names, its
    traffic mix ``data/traffic/<traffic>.json`` and its metrics."""
    with open(manifest) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    w = cells[workload]
    (centry,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    with open(manifest.parent / centry["file"]) as f:
        config = json.load(f)
    family = importlib.import_module(f"bench_port.reference.{config['family']}")
    mix = loadgen.load(data / "traffic" / f"{w['traffic']}.json")

    def mine(m):
        return workload in m.get("workloads", [workload])

    metrics = ([dict(m, kind="end_to_end") for m in bench["end_to_end"] if mine(m)]
               + [dict(m, kind="per_layer") for m in bench["per_layer"] if mine(m)])
    return Cell(workload, config, family, mix, metrics, data, int(w["chips"]))


def reader(data: Path, name: str) -> Callable:
    """``read(ctx)`` of ``data/metrics/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"bench_port_metric_{name}",
                                                  data / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Invocation:
    index: int
    fn: int
    length: int
    kind: str                     # "cold" or "warm"
    seconds: float                # the harness's clock around the call
    traced: bool = False
    phases: Optional[Dict[str, float]] = None      # PhaseTimes of a cold start
    migration: Optional[Dict[str, Any]] = None     # MigrationStats of a cold start


@dataclasses.dataclass
class Context:
    """What a metric reader reads (``metrics/<name>.py``)."""
    config: dict
    family: ModuleType
    window_s: float
    setup_s: float
    invocations: List[Invocation]
    trace: Optional[devtrace.Trace] = None

    def untraced(self, kind: Optional[str] = None) -> List[Invocation]:
        return [v for v in self.invocations
                if not v.traced and (kind is None or v.kind == kind)]

    def traced(self, kind: Optional[str] = None) -> List[Invocation]:
        return [v for v in self.invocations
                if v.traced and (kind is None or v.kind == kind)]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_handler(cfg, outbox: Dict[int, torch.Tensor]) -> Callable:
    """The tenants' user code: the prompt through the port's ``forward``
    (last position's logits only), then the tenant's 16-class head, whose
    arrays move to the device at the instance's first request. Returns the
    16 logits on the host and keeps them in ``outbox`` by invocation."""
    from repro_torch.models.transformer import forward

    def handler(params, hw, request, execs):
        with torch.no_grad():
            dev = params["embed"]["tok"].device
            tokens = torch.as_tensor(request["tokens"], device=dev)[None]
            logits = forward(params, tokens, cfg, logits_slice=1)[:, -1]
            if hw["w"].device != dev:
                hw["w"] = hw["w"].to(dev, non_blocking=True)
                hw["bias"] = hw["bias"].to(dev, non_blocking=True)
            out = (logits @ hw["w"] + hw["bias"])[0].cpu()
        outbox[request["id"]] = out
        return out
    return handler


def make_heads(c: dict, seed: int, n: int, device) -> torch.Tensor:
    """Every function's head ``(W (Vp, 16) | b (16,))`` flattened, one row
    per function, each from its own generator (see :func:`head`), on the
    host (pinned beside a card)."""
    vp = weights.padded_vocab(c)
    rows = torch.stack([_head_row(seed, k, vp, device) for k in range(n)])
    host = torch.empty(rows.shape, dtype=rows.dtype,
                       pin_memory=device.type == "cuda")
    host.copy_(rows)
    return host


def _head_row(seed: int, k: int, vp: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(weights.entropy(seed, "head", k))
    z = torch.randn(vp * N_CLASSES + N_CLASSES, generator=gen, device=device)
    z[: vp * N_CLASSES] /= vp ** 0.5
    z[vp * N_CLASSES:] *= 0.1
    return z


def head(c: dict, seed: int, k: int, device):
    """Function ``k``'s head ``(W (Vp, 16), b (16,))``, made again."""
    vp = weights.padded_vocab(c)
    z = _head_row(seed, k, vp, device)
    return z[: vp * N_CLASSES].view(vp, N_CLASSES), z[vp * N_CLASSES:]


class Provider:
    """One run: the pool, the functions, the live instances, the loop."""

    def __init__(self, cell: Cell, seed: int, device: torch.device,
                 t_start: Optional[float] = None):
        from repro_torch.core import (ColdStartConfig, ColdStartOrchestrator,
                                      DependencyManager, FunctionRegistry, RestorePolicy)
        from repro_torch.core import workloads as wl
        from repro_torch.models.config import ArchConfig

        self.cell, self.seed, self.device = cell, seed, device
        self.t_start = time.perf_counter() if t_start is None else t_start
        c = cell.config
        fields = cell.family.port_arch(c)
        fields["attn_pattern"] = tuple(fields["attn_pattern"])
        self.arch = ArchConfig(**fields)
        self.policy = RestorePolicy(cell.mix["restore_policy"])
        self.seq = loadgen.Sequence(cell.mix, cell.cap, seed)
        self.vocab = c["vocab_size"]
        tag = f"{cell.name}-{next(_RUN_IDS)}"
        self.image_id = f"{tag}-image"
        self.manager = DependencyManager(device=device)
        self.manager.register_image(
            self.image_id, c["name"],
            lambda: weights.make_params(cell.family, c, seed, device))
        self.log("weights and image made")
        self.outbox: Dict[int, torch.Tensor] = {}
        self.pending: Dict[str, Any] = {}
        handler = make_handler(self.arch, self.outbox)
        heads = make_heads(c, seed, self.seq.n_functions, device)
        self.log("heads made")
        vp = weights.padded_vocab(c)
        registry = FunctionRegistry()
        self.fn_ids = []
        for k in range(self.seq.n_functions):
            fn_id = f"{tag}-fn{k}"

            def package(row=heads[k]):
                return {"w": row[: vp * N_CLASSES].view(vp, N_CLASSES),
                        "bias": row[vp * N_CLASSES:]}
            registry.register(fn_id, self.image_id, package, handler,
                              write_baseline_checkpoint=False)
            wl.WORKLOADS.register(fn_id, wl.Workload(
                fn_id, self.image_id, handler, package, lambda: self.pending["req"]))
            self.fn_ids.append(fn_id)
        self.orch = ColdStartOrchestrator(self.manager, registry,
                                          ColdStartConfig(policy=self.policy))
        self.live: "OrderedDict[int, Any]" = OrderedDict()
        self.spans: List[devtrace.Interval] = []
        self.tracing = False

    def log(self, what: str) -> None:
        log(f"set-up: {what} at {time.perf_counter() - self.t_start:.2f} s")

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        ctx = (torch.profiler.record_function(name) if self.tracing
               else contextlib.nullcontext())
        with ctx:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def request(self, seq: loadgen.Sequence, i: int) -> Dict[str, Any]:
        return {"tokens": seq.tokens(i, self.vocab), "id": (seq.stream, i)}

    def serve(self, seq: loadgen.Sequence, i: int) -> Invocation:
        """Invocation ``i`` of ``seq``, warm or cold."""
        with self.span("traffic"):
            fn, length = seq[i]
            req = self.request(seq, i)
        if fn in self.live:
            self.live.move_to_end(fn)
            with self.span("invoke"):
                t0 = time.perf_counter()
                self.live[fn].invoke(req)
                dt = time.perf_counter() - t0
            return Invocation(i, fn, length, "warm", dt)
        if len(self.live) >= self.cell.cap:
            with self.span("evict"):
                self.live.popitem(last=False)
        self.pending["req"] = req
        with self.span("cold_start"):
            t0 = time.perf_counter()
            inst, pt = self.orch.cold_start_warmswap(self.fn_ids[fn], self.policy)
            dt = time.perf_counter() - t0
        self.live[fn] = inst
        return Invocation(i, fn, length, "cold", dt, phases=pt.as_dict(),
                          migration=dataclasses.asdict(inst.migration_stats))

    def warm_up(self) -> None:
        """The mix's start: each function started (``prestart``), or cap + 1
        cold starts, on the shortest prompt; a warm invocation on the
        longest; then every prompt length of the mix through one layer of the
        model (the shapes the window will use)."""
        from repro_torch.models.transformer import forward
        warm = loadgen.Sequence(self.cell.mix, self.cell.cap, self.seed, "warmup")
        warm.lengths = [min(self.seq.lengths)]
        if self.cell.mix["prestart"]:
            order = list(range(self.seq.n_functions))
        else:
            order = [warm[i][0] for i in range(self.cell.cap + 1)]
        for j, fn in enumerate(order):
            self.live.pop(fn, None)
            self._warm_start(warm, j, fn)
        self.log(f"{len(order)} cold starts")
        warm.lengths = [max(self.seq.lengths)]
        self.live[order[-1]].invoke(self.request(warm, len(order)))
        self.log("a warm invocation")
        one = dataclasses.replace(self.arch, n_layers=len(self.arch.attn_pattern))
        params = self.live[order[-1]].params
        with torch.no_grad():
            for length in sorted(set(self.seq.lengths)):
                forward(params, torch.zeros((1, length), dtype=torch.int64,
                                            device=self.device), one, logits_slice=1)
        self.outbox.clear()

    def _warm_start(self, seq, i, fn):
        if len(self.live) >= self.cell.cap:
            self.live.popitem(last=False)
        self.pending["req"] = self.request(seq, i)
        self.live[fn], _ = self.orch.cold_start_warmswap(self.fn_ids[fn], self.policy)

    def drop(self) -> None:
        self.live.clear()
        self.orch = self.manager = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip().splitlines()
        return out[0] if out else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def restore_mismatch(p: Provider) -> Dict[str, int]:
    """Bytes of the live instances' leaves that differ from the weights made
    again from the seed (every leaf, every layer), and the leaves read."""
    c, fam, dev = p.cell.config, p.cell.family, p.device
    insts = [inst.params for inst in p.live.values()]
    bad = seen = 0

    def count(got: torch.Tensor, want: torch.Tensor) -> int:
        if got.shape != want.shape or got.dtype != want.dtype:
            return want.numel() * want.element_size()
        return int((got.contiguous().view(torch.uint8)
                    != want.contiguous().view(torch.uint8)).sum())

    for tag, (path, *_rest) in weights.top_leaves(c):
        want = weights.top(c, p.seed, tag, dev)
        for params in insts:
            bad += count(params[path[0]][path[1]], want)
            seen += 1
    for i in range(c["num_hidden_layers"]):
        for path, want in weights.layer(fam, c, p.seed, i, dev).items():
            for params in insts:
                bad += count(weights.leaf_at(params, fam, c, i, path), want)
                seen += 1
    return {"bytes": bad, "leaves": seen, "instances": len(insts)}


def sample(invs: List[Invocation], seed: int, groups: Dict[int, int],
           k: int = SAMPLE) -> List[Invocation]:
    """``k`` of the window's invocations, drawn from the seed: the longest
    prompt; where both kinds occur, two of the rarer; one of each function
    where there are at most ``k // 3`` of them (every live instance of a hot
    mix); the rest dealt over the length groups (``groups``:
    ``loadgen.length_groups``) in turn, each group in an order drawn from the
    seed, so every group is in the sample."""
    if not invs:
        return []
    rng = np.random.default_rng(weights.entropy(seed, "sample"))
    order = [invs[j] for j in rng.permutation(len(invs))]
    chosen: Dict[int, Invocation] = {}

    def take(v: Invocation) -> None:
        if len(chosen) < k:
            chosen.setdefault(v.index, v)

    take(max(invs, key=lambda v: (v.length, -v.index)))
    kinds = Counter(v.kind for v in invs)
    if len(kinds) == 2:
        rare = min(kinds, key=kinds.get)
        for v in [v for v in order if v.kind == rare][:2]:
            take(v)
    fns = sorted({v.fn for v in invs})
    if len(fns) <= k // 3:
        for fn in fns:
            if all(v.fn != fn for v in chosen.values()):
                take(next(v for v in order if v.fn == fn))
    by_group: Dict[int, List[Invocation]] = defaultdict(list)
    for v in order:
        if v.index not in chosen:
            by_group[groups[v.length]].append(v)
    queues = [by_group[g] for g in sorted(by_group)]
    while len(chosen) < k and any(queues):
        for q in queues:
            if q:
                take(q.pop(0))
    return sorted(chosen.values(), key=lambda v: v.index)


def reference_answers(cell: Cell, seed: int, chosen: List[Invocation], device,
                      product: Callable = common.mm) -> Dict[Any, torch.Tensor]:
    """The reference's 16 class logits of each chosen invocation, made again
    from the seed (weights, prompt, head) and keyed as the handler keys its
    answers; ``product`` is the reference's matrix product (``common.mm``,
    or ``common.mm_fp8`` for the control)."""
    seq = loadgen.Sequence(cell.mix, cell.cap, seed)
    c = cell.config
    prompts = [torch.as_tensor(seq.tokens(v.index, c["vocab_size"]), device=device)
               for v in chosen]
    heads = [head(c, seed, v.fn, device) for v in chosen]
    ref = common.class_logits(cell.family, c, seed, prompts, heads, device, product)
    return {("window", v.index): r.cpu() for v, r in zip(chosen, ref)}


def check_logits(cell: Cell, seed: int, chosen: List[Invocation],
                 outbox: Dict, device) -> Dict[str, Any]:
    """The reference's class logits of each chosen invocation against the
    answer in ``outbox``: the gap of the whole sample (``common.rms_gap``,
    compared), each answer's RMS gap (its largest compared), each answer's
    widest gap (shown only), and the answers missing."""
    have = [v for v in chosen if ("window", v.index) in outbox]
    ref = list(reference_answers(cell, seed, have, device).values())
    got = [outbox[("window", v.index)] for v in have]
    return {"gap": common.rms_gap(got, ref),
            "gaps": [common.gap(g, r) for g, r in zip(got, ref)],
            "rms_gaps": [common.rms_gap([g], [r]) for g, r in zip(got, ref)],
            "missing": len(chosen) - len(have),
            "lengths": [v.length for v in have], "kinds": [v.kind for v in have]}


def halves(cell: Cell, ctx: "Context") -> Dict[str, List[Any]]:
    """Each end-to-end metric but ``setup_s`` read over the first and the
    second half of the window's invocations apart (shown only: how far a
    run's own halves differ, beside how far runs differ)."""
    n = len(ctx.invocations) // 2
    out = {}
    for m in cell.metrics:
        if m["kind"] == "end_to_end" and m["name"] != "setup_s":
            read = reader(cell.data, m["name"])
            out[m["name"]] = [
                read(dataclasses.replace(ctx, invocations=part,
                                         window_s=sum(v.seconds for v in part)))
                for part in (ctx.invocations[:n], ctx.invocations[n:])]
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, substitute: Optional[Callable] = None) -> Dict[str, Any]:
    """One run: set-up, the window, the check; the result line's object.
    ``substitute(cell, seed, chosen, device)``, where given, returns answers
    that replace the program's in the check (the precision control,
    ``control.py``); the benchmark's own runs give none."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    p = Provider(cell, seed, device, t_start)
    p.log(f"image and {len(p.fn_ids)} functions")
    p.warm_up()
    p.log("warm-up done")
    failed = 0
    invs: List[Invocation] = []
    # with --trace 1 the profiler covers the window's last TRACE_SECONDS (at
    # most half of it): its start is cheap, its stop parses the whole trace
    trace_from = seconds - min(TRACE_SECONDS, seconds / 2) if trace else float("inf")
    prof = None
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    i = 0
    while time.perf_counter() - t0 < seconds:
        if prof is None and time.perf_counter() - t0 >= trace_from:
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
            p.tracing = True
        try:
            v = p.serve(p.seq, i)
            v.traced = p.tracing
            invs.append(v)
        except Exception:               # a failed invocation counts; the run goes on
            failed += 1
            if failed <= 3:
                log(traceback.format_exc())
            if failed >= 20:
                break
        i += 1
    window_s = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
        p.tracing = False
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    alloc = ({k: torch.cuda.memory_stats(device)[k] for k in
              ("num_alloc_retries", "num_device_alloc", "num_device_free")}
             if cuda else {})
    tr = devtrace.collect(prof, SPANS) if prof is not None else None
    ctx = Context(cell.config, cell.family, window_s, setup_s, invs, tr)

    restore = restore_mismatch(p)
    outbox = p.outbox
    p.drop()
    del p
    gc.collect()
    chosen = sample(invs, seed, loadgen.length_groups(loadgen.strata_lengths(
        cell.mix["lengths"])))
    if substitute is not None:
        outbox.update(substitute(cell, seed, chosen, device))
    logit = check_logits(cell, seed, chosen, outbox, device)
    limits = cell.config["limits"]
    checks = {
        "failed": {"value": failed, "limit": 0},
        "restore_bytes_differing": {"value": restore["bytes"], "limit": 0},
        "answers_missing": {"value": logit["missing"], "limit": 0},
        "logit_rms_gap": {"value": logit["gap"], "limit": limits["logit_rms_gap"]},
        "answer_rms_gap_max": {"value": max(logit["rms_gaps"], default=float("inf")),
                               "limit": limits["answer_rms_gap_max"]},
    }
    correct = bool(invs) and all(v["value"] <= v["limit"] for v in checks.values())
    for name, v in checks.items():
        log(f"check {name}: {v['value']} (limit {v['limit']})")
    log(f"check detail: restore {restore}; widest gap of each answer {logit['gaps']}; "
        f"RMS gap of each {logit['rms_gaps']}; at lengths {logit['lengths']} "
        f"({logit['kinds']})")

    kinds = ("end_to_end",) if not trace else ("per_layer",)
    metrics = {}
    for m in cell.metrics:
        if m["kind"] not in kinds:
            continue
        value = reader(cell.data, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out: Dict[str, Any] = {"correct": correct, "attempted": len(invs) + failed,
                           "failed": failed, "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = devtrace.busy_s(tr)
        dev["window_s"] = tr.window_s
        gaps = sorted(devtrace.idle_gaps(tr).items(), key=lambda kv: -kv[1])
        out["breakdown"] = {"device_ops": devtrace.top_ops(tr),
                            "idle_gaps": [[k, v] for k, v in gaps[:10]]}
    n_cold = sum(v.kind == "cold" for v in invs)
    out["run"] = {"seconds": window_s, "setup_s": setup_s, "cold": n_cold,
                  "warm": len(invs) - n_cold,
                  "halves": halves(cell, ctx) if not trace else {},
                  "allocator": alloc, "card": _power() if cuda else "cpu"}
    out["checks"] = checks
    return out
