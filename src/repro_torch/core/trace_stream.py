"""Streaming, out-of-core trace ingestion (docs/TRACES.md).

Port of ``repro.core.trace_stream``: the same code with the imports pointed at the
port, so every sample, counter and float sum is bit-identical.

A :class:`TraceStream` presents an arrival workload as an ordered sequence of
:class:`TraceChunk` s — merged ``(time, fn)`` arrays covering disjoint time
windows — instead of a fully materialized ``List[Trace]``. The event engine
(``core/fleet.py``) consumes chunks natively, so a trace far larger than RAM
replays with peak arrival residency bounded by the largest chunk; the
vectorized engine falls back (``fleet_vec.fast_path_reason``) because static
routing cannot be proven from a stream prefix.

Contract (enforced by ``tests/test_stream_equiv.py``):

  * **Bit identity** — running an engine over ``stream.chunks()`` and over
    ``stream.materialize()`` produces byte-identical results (sha256 over the
    per-request sample arrays, exact counters). The merged order inside a
    chunk is the engines' own order (global stable argsort over per-function
    concatenation), chunks cover half-open ``[t0, t1)`` windows, so equal
    timestamps never straddle a chunk boundary and tie-breaks cannot drift.
  * **Chunk-size invariance** — all randomness is drawn from generators
    seeded per ``(seed, tag, block)`` (or per ``(seed, tag, fn, block)`` for
    the CSV reader), where a *block* is a fixed ``block_min``-minute window.
    A chunk is a grouping of whole blocks, so ``chunk_min`` changes how many
    arrivals are resident at once — never which arrivals exist. ``chunk_min``
    and ``stream`` are therefore non-semantic spec knobs
    (``NON_SEMANTIC_TRACE_KWARGS``): the executor's store key ignores them.

Generators registered here (all accept ``stream=True`` to return the stream
itself, default ``False`` materializes — same values either way):

  ``azure_csv``   hardened chunked reader for the Azure Functions per-minute
                  count schema: gzip auto-detection, malformed rows raise
                  with line numbers, per-window spill files keep ingestion
                  out-of-core (two sequential passes, never the whole trace).
  ``diurnal``     day/night sinusoidal rate modulation with per-function
                  phase jitter (time-of-day load waves).
  ``bursts``      correlated bursts: deploy storms / retry stampedes that
                  multiply every function of one image for a short window,
                  with decaying retry echoes.
  ``tenant_mix``  multi-tenant fleet: per-tenant function/image partitions
                  and Zipf-skewed tenant load shares — pair with a bounded
                  ``shared_cache_bytes`` to model per-tenant cache quotas
                  (each tenant's quota is its image-universe footprint).
  ``rollout``     image-version rollouts: functions migrate to a new image
                  version mid-trace (per-function canary jitter), modeled as
                  distinct revision rows so a rollout invalidates the shared
                  image exactly like a fresh deployment.
"""
from __future__ import annotations

import csv
import gzip
import math
import os
import shutil
import tempfile
import weakref
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.traces import (TRACE_GENERATORS, Trace, assign_images,
                               sample_rates, zipf_weights)

#: One RNG-block per day of trace time by default: big enough that per-block
#: vectorized draws stay cheap, small enough that a chunk (>= 1 block) keeps
#: peak arrival residency far below production trace sizes.
DEFAULT_BLOCK_MIN = 1440.0
DEFAULT_CHUNK_MIN = 1440.0

#: Trace-component kwargs that change HOW a spec executes but provably not
#: WHAT it computes (the bit-identity + chunk-invariance contract above).
#: The sweep store's content hash and seed derivation strip these, so a
#: resumed sweep re-uses results computed under a different chunking.
NON_SEMANTIC_TRACE_KWARGS = frozenset({"stream", "chunk_min"})

# Per-generator RNG stream tags: decouple the (seed, tag, block) block
# streams so two generators given the same seed never share draws.
_TAG_CSV = 1
_TAG_DIURNAL = 2
_TAG_BURSTS = 3
_TAG_TENANT = 4
_TAG_ROLLOUT = 5


def block_rng(seed: int, tag: int, *key: int) -> np.random.Generator:
    """Deterministic generator for one RNG block: seeded by the full
    ``(seed, tag, *key)`` tuple via ``SeedSequence``, so draws depend only on
    the block identity — never on which chunk grouping requested them."""
    if seed < 0:
        raise ValueError(f"stream seeds must be >= 0, got {seed}")
    return np.random.default_rng([int(seed), int(tag)] + [int(k) for k in key])


@dataclass
class TraceChunk:
    """One merged arrival window: times (minutes, sorted; ties in trace-list
    order — the engines' own merge order) and the function index per arrival."""
    t_min: np.ndarray
    fn: np.ndarray
    start_min: float
    end_min: float

    def __len__(self) -> int:
        return len(self.t_min)


@dataclass
class StreamStats:
    """Residency accounting for one stream (updated by ``chunks()``):
    ``peak_resident_arrivals`` is the high-water mark of arrivals held in
    memory at once — the out-of-core guarantee CI asserts against the total."""
    n_arrivals: int = 0
    n_chunks: int = 0
    peak_resident_arrivals: int = 0


class TraceStream:
    """Base class: a re-iterable chunked arrival source.

    Subclasses provide ``meta_traces()`` (per-function rate/image metadata,
    zero-length arrival arrays — bounded by fleet size, not trace length) and
    ``chunks()`` (a FRESH iterator per call; engines consume one stream
    several times, once per method). ``materialize()`` builds the equivalent
    ``List[Trace]`` — the in-memory half of the differential contract; only
    call it at test scale.
    """

    def __init__(self, *, n_functions: int, horizon_min: float,
                 block_min: float = DEFAULT_BLOCK_MIN,
                 chunk_min: float = DEFAULT_CHUNK_MIN):
        if n_functions < 1:
            raise ValueError(f"n_functions must be >= 1, got {n_functions}")
        if horizon_min <= 0:
            raise ValueError(f"horizon_min must be > 0, got {horizon_min}")
        if block_min <= 0:
            raise ValueError(f"block_min must be > 0, got {block_min}")
        if chunk_min <= 0:
            raise ValueError(f"chunk_min must be > 0, got {chunk_min}")
        self.n_functions = int(n_functions)
        self.horizon_min = float(horizon_min)
        self.block_min = float(block_min)
        self.chunk_blocks = max(1, math.ceil(chunk_min / block_min))
        self.n_blocks = max(1, math.ceil(self.horizon_min / self.block_min))
        self.stats = StreamStats()

    # -- subclass hooks -----------------------------------------------------
    def meta_traces(self) -> List[Trace]:
        raise NotImplementedError

    def _block_arrivals(self, block: int) -> List[Tuple[int, np.ndarray]]:
        """Per-function sorted arrival arrays for one block, in ascending
        function-index order, times in the half-open block window."""
        raise NotImplementedError

    # -- chunked iteration --------------------------------------------------
    def chunks(self) -> Iterator[TraceChunk]:
        """Yield merged chunks of ``chunk_blocks`` whole blocks each. Empty
        windows are skipped; every yielded chunk is non-empty and sorted."""
        n_seen = n_chunks = 0
        for b0 in range(0, self.n_blocks, self.chunk_blocks):
            b1 = min(b0 + self.chunk_blocks, self.n_blocks)
            parts_t: List[np.ndarray] = []
            parts_fn: List[np.ndarray] = []
            for b in range(b0, b1):
                for fn, t in self._block_arrivals(b):
                    parts_t.append(np.asarray(t, np.float64))
                    parts_fn.append(np.full(len(t), fn, np.int64))
            if not parts_t:
                continue
            t_all = np.concatenate(parts_t)
            fn_all = np.concatenate(parts_fn)
            # the engines' merge order: per-function concatenation + one
            # global stable argsort (ties break by trace order then position)
            order = np.argsort(t_all, kind="stable")
            n_seen += len(t_all)
            n_chunks += 1
            self.stats.peak_resident_arrivals = max(
                self.stats.peak_resident_arrivals, len(t_all))
            yield TraceChunk(t_all[order], fn_all[order],
                             start_min=b0 * self.block_min,
                             end_min=min(b1 * self.block_min,
                                         self.horizon_min))
        self.stats.n_arrivals = n_seen
        self.stats.n_chunks = n_chunks

    def materialize(self) -> List[Trace]:
        """The equivalent in-memory trace list (test scale only: holds every
        arrival at once). Bit-identical inputs to the chunked path."""
        meta = self.meta_traces()
        parts: Dict[int, List[np.ndarray]] = {m.fn_index: [] for m in meta}
        for b in range(self.n_blocks):
            for fn, t in self._block_arrivals(b):
                parts[fn].append(np.asarray(t, np.float64))
        return [Trace(m.fn_index, m.rate_per_min,
                      np.concatenate(parts[m.fn_index])
                      if parts[m.fn_index] else np.empty((0,), np.float64),
                      image_id=m.image_id)
                for m in meta]


def ensure_trace_list(traces) -> List[Trace]:
    """Accept either a trace list or a stream; return the list form."""
    return traces.materialize() if isinstance(traces, TraceStream) else traces


class ListTraceStream(TraceStream):
    """In-memory traces re-presented through the chunked interface — the
    differential-test adapter proving the engines' chunked consumption path
    is identical to their array path for ARBITRARY chunk boundaries (count
    slices may split equal-timestamp runs; the engine's merge rules make
    that safe, and the fuzz test pins it)."""

    def __init__(self, traces: Sequence[Trace], chunk_size: int = 4096):
        if chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self._traces = list(traces)
        all_t = (np.concatenate([np.asarray(t.arrivals_min, np.float64)
                                 for t in self._traces])
                 if self._traces else np.empty((0,)))
        all_fn = (np.concatenate([np.full(len(t.arrivals_min), t.fn_index,
                                          np.int64) for t in self._traces])
                  if self._traces else np.empty((0,), np.int64))
        order = np.argsort(all_t, kind="stable")
        self._all_t = all_t[order]
        self._all_fn = all_fn[order]
        self.chunk_size = int(chunk_size)
        horizon = float(self._all_t[-1]) if len(self._all_t) else 1.0
        super().__init__(n_functions=max(len(self._traces), 1),
                         horizon_min=max(horizon, 1e-9))

    def meta_traces(self) -> List[Trace]:
        return [Trace(t.fn_index, t.rate_per_min, np.empty((0,), np.float64),
                      image_id=t.image_id) for t in self._traces]

    def materialize(self) -> List[Trace]:
        return list(self._traces)

    def chunks(self) -> Iterator[TraceChunk]:
        n = len(self._all_t)
        n_seen = n_chunks = 0
        for lo in range(0, n, self.chunk_size):
            hi = min(lo + self.chunk_size, n)
            n_seen += hi - lo
            n_chunks += 1
            self.stats.peak_resident_arrivals = max(
                self.stats.peak_resident_arrivals, hi - lo)
            yield TraceChunk(self._all_t[lo:hi], self._all_fn[lo:hi],
                             start_min=float(self._all_t[lo]),
                             end_min=float(self._all_t[hi - 1]))
        self.stats.n_arrivals = n_seen
        self.stats.n_chunks = n_chunks


# ------------------------------------------------------------------------------
# Azure Functions CSV: hardened out-of-core reader
# ------------------------------------------------------------------------------

class CsvSchemaError(ValueError):
    """The CSV violates the Azure per-minute count schema; the message names
    the file, line and column so a bad row is a one-look fix."""


class AzureCsvStream(TraceStream):
    """Two-pass out-of-core reader for the Azure Functions trace schema
    (optionally leading id columns — ``HashOwner/HashApp/HashFunction`` — then
    one integer column per minute, named by minute number).

    Pass 1 (construction) streams the file row by row — gzip auto-detected
    from magic bytes — validating every cell (malformed rows raise
    :class:`CsvSchemaError` with the line number) and spilling nonzero
    ``(fn, minute, count)`` triples into one binary file per ``block_min``
    window, so peak memory is one ROW, never the trace. Pass 2
    (``chunks()``/``materialize()``) re-reads one window at a time and places
    each count uniformly inside its minute with a per-``(seed, fn, block)``
    generator — chunk-size invariant by construction.

    Functions sharing a ``HashApp`` share an image (dependency bundle);
    without id columns every row runs on image 0. ``rate_per_min`` is the
    in-horizon mean count per minute.
    """

    def __init__(self, path: str, n_functions: int, horizon_min: float,
                 seed: int = 0, block_min: float = DEFAULT_BLOCK_MIN,
                 chunk_min: float = DEFAULT_CHUNK_MIN):
        super().__init__(n_functions=n_functions, horizon_min=horizon_min,
                         block_min=block_min, chunk_min=chunk_min)
        if seed < 0:
            raise ValueError(f"stream seeds must be >= 0, got {seed}")
        self.path = path
        self.seed = int(seed)
        self.total_invocations = 0
        self._rates: List[float] = []
        self._images: List[int] = []
        self._spill_dir = tempfile.mkdtemp(prefix="repro-trace-spill-")
        self._cleanup = weakref.finalize(self, shutil.rmtree, self._spill_dir,
                                         True)
        try:
            self._ingest(max_rows=int(n_functions))
        except BaseException:
            self.close()
            raise
        # the file may hold fewer rows than the requested cap
        self.n_functions = len(self._rates)

    def close(self) -> None:
        """Drop the spill directory now (also runs at garbage collection)."""
        self._cleanup()

    def _open_text(self):
        with open(self.path, "rb") as probe:
            magic = probe.read(2)
        if magic == b"\x1f\x8b":
            return gzip.open(self.path, "rt", newline="")
        return open(self.path, newline="")

    def _ingest(self, max_rows: int) -> None:
        spill: Dict[int, object] = {}
        app_ids: Dict[str, int] = {}
        try:
            with self._open_text() as f:
                reader = csv.reader(f)
                try:
                    header = next(reader)
                except StopIteration:
                    raise CsvSchemaError(f"{self.path}: empty file (no header)")
                minute_cols = [i for i, h in enumerate(header)
                               if h.strip().isdigit()]
                if not minute_cols:
                    raise CsvSchemaError(
                        f"{self.path}: header has no per-minute count columns "
                        f"(integer-named), got {header[:8]!r}...")
                minutes = np.array([int(header[i]) for i in minute_cols],
                                   np.int64)
                if len(np.unique(minutes)) != len(minutes):
                    raise CsvSchemaError(
                        f"{self.path}: duplicate minute columns in header")
                minutes = minutes - minutes.min()   # minute origin -> 0
                in_h = minutes < self.horizon_min
                app_col = header.index("HashApp") if "HashApp" in header else None
                n_cols = len(header)
                for fi, row in enumerate(reader):
                    if fi >= max_rows:
                        break
                    line = reader.line_num
                    if len(row) != n_cols:
                        raise CsvSchemaError(
                            f"{self.path}, line {line}: expected {n_cols} "
                            f"columns, got {len(row)}")
                    counts = self._parse_counts(row, minute_cols, header, line)
                    counts = counts[in_h]
                    mins = minutes[in_h]
                    self.total_invocations += int(counts.sum())
                    self._rates.append(
                        float(counts.sum()) / max(float(in_h.sum()), 1.0))
                    if app_col is not None:
                        app = row[app_col]
                        self._images.append(
                            app_ids.setdefault(app, len(app_ids)))
                    else:
                        self._images.append(0)
                    nz = np.flatnonzero(counts)
                    if not len(nz):
                        continue
                    m_nz, c_nz = mins[nz], counts[nz]
                    ord_m = np.argsort(m_nz, kind="stable")
                    m_nz, c_nz = m_nz[ord_m], c_nz[ord_m]
                    blocks = (m_nz // self.block_min).astype(np.int64)
                    for b in np.unique(blocks):
                        sel = blocks == b
                        tri = np.column_stack([
                            np.full(int(sel.sum()), fi, np.int64),
                            m_nz[sel], c_nz[sel]])
                        fh = spill.get(int(b))
                        if fh is None:
                            fh = open(self._spill_path(int(b)), "wb")
                            spill[int(b)] = fh
                        fh.write(tri.tobytes())
        finally:
            for fh in spill.values():
                fh.close()

    def _parse_counts(self, row, minute_cols, header, line) -> np.ndarray:
        cells = [row[i].strip() for i in minute_cols]
        try:
            # the Azure schema writes absent minutes as empty cells
            counts = np.array([c if c else "0" for c in cells], np.int64)
        except ValueError:
            for i, c in zip(minute_cols, cells):
                if c:
                    try:
                        int(c)
                    except ValueError:
                        raise CsvSchemaError(
                            f"{self.path}, line {line}, column "
                            f"{header[i]!r}: invalid invocation count {c!r}")
            raise
        if (counts < 0).any():
            i = minute_cols[int(np.flatnonzero(counts < 0)[0])]
            raise CsvSchemaError(
                f"{self.path}, line {line}, column {header[i]!r}: negative "
                f"invocation count {row[i]!r}")
        return counts

    def _spill_path(self, block: int) -> str:
        return os.path.join(self._spill_dir, f"w{block:08d}.bin")

    def meta_traces(self) -> List[Trace]:
        return [Trace(i, r, np.empty((0,), np.float64), image_id=img)
                for i, (r, img) in enumerate(zip(self._rates, self._images))]

    def _block_arrivals(self, block: int) -> List[Tuple[int, np.ndarray]]:
        path = self._spill_path(block)
        if not os.path.exists(path):
            return []
        tri = np.fromfile(path, np.int64).reshape(-1, 3)
        fn, minute, count = tri[:, 0], tri[:, 1], tri[:, 2]
        # triples were appended row-major: fn ascending, minutes ascending
        starts = np.concatenate(([0], np.flatnonzero(np.diff(fn)) + 1,
                                 [len(fn)]))
        out = []
        for s, e in zip(starts[:-1], starts[1:]):
            f = int(fn[s])
            rng = block_rng(self.seed, _TAG_CSV, f, block)
            total = int(count[s:e].sum())
            t = (np.repeat(minute[s:e].astype(np.float64), count[s:e])
                 + rng.random(total))
            out.append((f, np.sort(t, kind="stable")))
        return out


@TRACE_GENERATORS.register("azure_csv")
def load_azure_csv(path: str, n_functions: int, horizon_min: float,
                   seed: int = 0, stream: bool = False,
                   block_min: float = DEFAULT_BLOCK_MIN,
                   chunk_min: float = DEFAULT_CHUNK_MIN):
    """Azure Functions per-minute count schema -> traces (see
    :class:`AzureCsvStream`). ``stream=True`` returns the chunked stream;
    the default materializes the identical trace list. ``n_functions`` caps
    the rows read."""
    st = AzureCsvStream(path, n_functions, horizon_min, seed=seed,
                        block_min=block_min, chunk_min=chunk_min)
    if stream:
        return st
    try:
        return st.materialize()
    finally:
        st.close()


# ------------------------------------------------------------------------------
# Adversarial generators: binned inhomogeneous-Poisson streams
# ------------------------------------------------------------------------------

class _BinnedPoissonStream(TraceStream):
    """Shared machinery for the synthetic adversarial generators: each block
    is sliced into ``resolution_min`` bins; a subclass supplies the per-row
    rate matrix for a block (rows are functions, or revisions for rollouts),
    and one per-``(seed, tag, block)`` generator draws Poisson counts plus
    uniform placement for the whole block in three vectorized calls."""

    def __init__(self, *, tag: int, seed: int, rows: int,
                 resolution_min: float, **kw):
        super().__init__(**kw)
        if resolution_min <= 0:
            raise ValueError(
                f"resolution_min must be > 0, got {resolution_min}")
        self._tag = int(tag)
        self.seed = int(seed)
        self._rows = int(rows)
        self.resolution_min = float(resolution_min)

    def _block_rates(self, block: int, starts: np.ndarray,
                     widths: np.ndarray) -> np.ndarray:
        """(rows, bins) arrival rate per minute inside each bin."""
        raise NotImplementedError

    def _row_fn(self, row: int) -> int:
        return row

    def _block_arrivals(self, block: int) -> List[Tuple[int, np.ndarray]]:
        lo = block * self.block_min
        hi = min(lo + self.block_min, self.horizon_min)
        edges = np.arange(lo, hi, self.resolution_min)
        widths = np.minimum(edges + self.resolution_min, hi) - edges
        lam = np.maximum(self._block_rates(block, edges, widths), 0.0)
        rng = block_rng(self.seed, self._tag, block)
        counts = rng.poisson(lam * widths)
        total = int(counts.sum())
        if not total:
            return []
        flat = counts.ravel()                      # row-major: bins per row
        u = rng.random(total)
        t = (np.repeat(np.broadcast_to(edges, counts.shape).ravel(), flat)
             + u * np.repeat(np.broadcast_to(widths, counts.shape).ravel(),
                             flat))
        row_tot = counts.sum(axis=1)
        bounds = np.concatenate(([0], np.cumsum(row_tot)))
        return [(self._row_fn(r),
                 np.sort(t[bounds[r]:bounds[r + 1]], kind="stable"))
                for r in np.flatnonzero(row_tot)]


def _base_rates(n: int, seed: int, rate_model: str, rate_skew: float,
                total_rate_per_min: float) -> np.ndarray:
    if rate_model == "azure":
        return sample_rates(n, seed)
    if rate_model == "zipf":
        return total_rate_per_min * zipf_weights(n, rate_skew)
    raise ValueError(f"unknown rate_model: {rate_model!r}")


class DiurnalTraceStream(_BinnedPoissonStream):
    """Day/night load waves: each function's rate is its base rate modulated
    by ``1 + amplitude * cos(2*pi*(t - peak)/period)`` with a per-function
    peak-time jitter, so the fleet breathes together but not in lockstep.
    Mean modulation over a period is 1 — base rates are preserved."""

    def __init__(self, n_functions: int, horizon_min: float, seed: int,
                 n_images: int, image_skew: float, rate_model: str,
                 rate_skew: float, total_rate_per_min: float,
                 amplitude: float, period_min: float, peak_min: float,
                 phase_jitter_min: float, resolution_min: float,
                 block_min: float, chunk_min: float):
        if not 0.0 <= amplitude <= 1.0:
            raise ValueError(f"amplitude must be in [0, 1], got {amplitude}")
        if period_min <= 0:
            raise ValueError(f"period_min must be > 0, got {period_min}")
        super().__init__(tag=_TAG_DIURNAL, seed=seed, rows=n_functions,
                         resolution_min=resolution_min,
                         n_functions=n_functions, horizon_min=horizon_min,
                         block_min=block_min, chunk_min=chunk_min)
        self.rates = _base_rates(n_functions, seed, rate_model, rate_skew,
                                 total_rate_per_min)
        self.images = assign_images(n_functions, n_images, image_skew, seed)
        self.amplitude = float(amplitude)
        self.period_min = float(period_min)
        setup = block_rng(seed, _TAG_DIURNAL, 0, 1)   # distinct from blocks
        self.peaks = peak_min + setup.uniform(
            -phase_jitter_min, phase_jitter_min, size=n_functions)

    def meta_traces(self) -> List[Trace]:
        return [Trace(i, float(r), np.empty((0,), np.float64),
                      image_id=int(img))
                for i, (r, img) in enumerate(zip(self.rates, self.images))]

    def _block_rates(self, block, starts, widths):
        mid = starts + widths / 2.0
        phase = 2.0 * np.pi * (mid[None, :] - self.peaks[:, None]) \
            / self.period_min
        return self.rates[:, None] * (1.0 + self.amplitude * np.cos(phase))


class BurstTraceStream(_BinnedPoissonStream):
    """Correlated bursts: each burst picks one image (Zipf-weighted, so hot
    images storm most) and multiplies the rate of EVERY function on it for
    ``burst_duration_min`` — a deploy storm — followed by decaying retry
    echoes at backoff offsets — a retry stampede. The burst schedule is drawn
    once from the seed (bounded state), so blocks stay independent."""

    def __init__(self, n_functions: int, horizon_min: float, seed: int,
                 n_images: int, image_skew: float, rate_model: str,
                 rate_skew: float, total_rate_per_min: float, n_bursts: int,
                 burst_duration_min: float, burst_multiplier: float,
                 retries: int, retry_backoff_min: float, retry_decay: float,
                 resolution_min: float, block_min: float, chunk_min: float):
        if n_bursts < 0:
            raise ValueError(f"n_bursts must be >= 0, got {n_bursts}")
        if burst_multiplier < 1.0:
            raise ValueError(
                f"burst_multiplier must be >= 1, got {burst_multiplier}")
        super().__init__(tag=_TAG_BURSTS, seed=seed, rows=n_functions,
                         resolution_min=resolution_min,
                         n_functions=n_functions, horizon_min=horizon_min,
                         block_min=block_min, chunk_min=chunk_min)
        self.rates = _base_rates(n_functions, seed, rate_model, rate_skew,
                                 total_rate_per_min)
        self.images = assign_images(n_functions, n_images, image_skew, seed)
        setup = block_rng(seed, _TAG_BURSTS, 0, 1)
        starts = np.sort(setup.uniform(0.0, horizon_min, size=n_bursts),
                         kind="stable")
        imgs = setup.choice(max(n_images, 1), size=n_bursts,
                            p=zipf_weights(max(n_images, 1), image_skew))
        # (start, end, image, extra-multiplier) windows incl. retry echoes
        self.windows: List[Tuple[float, float, int, float]] = []
        for s, img in zip(starts, imgs):
            boost = burst_multiplier - 1.0
            for j in range(retries + 1):
                off = s + j * retry_backoff_min
                self.windows.append(
                    (off, off + burst_duration_min, int(img),
                     boost * (retry_decay ** j)))

    def meta_traces(self) -> List[Trace]:
        return [Trace(i, float(r), np.empty((0,), np.float64),
                      image_id=int(img))
                for i, (r, img) in enumerate(zip(self.rates, self.images))]

    def _block_rates(self, block, starts, widths):
        lam = np.repeat(self.rates[:, None], len(starts), axis=1)
        lo, hi = starts[0], starts[-1] + widths[-1]
        for (s, e, img, boost) in self.windows:
            if e <= lo or s >= hi or boost <= 0.0:
                continue
            frac = np.clip(np.minimum(starts + widths, e)
                           - np.maximum(starts, s), 0.0, None) / widths
            rows = self.images == img
            lam[rows] += self.rates[rows, None] * boost * frac[None, :]
        return lam


class TenantMixTraceStream(_BinnedPoissonStream):
    """Multi-tenant mix: tenants own disjoint function and image partitions;
    tenant load shares are Zipf-skewed (tenant 0 is the noisy neighbor) and
    per-function rates are Zipf within each tenant. Pairing the partitioned
    image universes with a bounded ``shared_cache_bytes`` models per-tenant
    cache quotas: each tenant's quota is its own image footprint, and the
    noisy tenant's churn pressures everyone through the shared tier."""

    def __init__(self, n_tenants: int, fns_per_tenant: int,
                 images_per_tenant: int, horizon_min: float, seed: int,
                 tenant_rate_skew: float, rate_skew: float,
                 total_rate_per_min: float, noisy_multiplier: float,
                 resolution_min: float, block_min: float, chunk_min: float):
        if n_tenants < 1 or fns_per_tenant < 1 or images_per_tenant < 1:
            raise ValueError("n_tenants, fns_per_tenant and images_per_tenant "
                             "must all be >= 1")
        n_functions = n_tenants * fns_per_tenant
        super().__init__(tag=_TAG_TENANT, seed=seed, rows=n_functions,
                         resolution_min=resolution_min,
                         n_functions=n_functions, horizon_min=horizon_min,
                         block_min=block_min, chunk_min=chunk_min)
        shares = zipf_weights(n_tenants, tenant_rate_skew)
        shares = shares * np.where(np.arange(n_tenants) == 0,
                                   noisy_multiplier, 1.0)
        within = zipf_weights(fns_per_tenant, rate_skew)
        self.rates = (total_rate_per_min
                      * (shares[:, None] * within[None, :]).ravel())
        self.tenant_of_fn = np.repeat(np.arange(n_tenants, dtype=np.int64),
                                      fns_per_tenant)
        setup = block_rng(seed, _TAG_TENANT, 0, 1)
        imgs = []
        for ten in range(n_tenants):
            local = assign_images(fns_per_tenant, images_per_tenant,
                                  skew=1.2,
                                  seed=int(setup.integers(0, 2**31)))
            imgs.append(ten * images_per_tenant + local)
        self.images = np.concatenate(imgs)

    def meta_traces(self) -> List[Trace]:
        return [Trace(i, float(r), np.empty((0,), np.float64),
                      image_id=int(img))
                for i, (r, img) in enumerate(zip(self.rates, self.images))]

    def _block_rates(self, block, starts, widths):
        return np.repeat(self.rates[:, None], len(starts), axis=1)


class RolloutTraceStream(_BinnedPoissonStream):
    """Image-version rollouts: every function starts on version 0 of its
    image; at each rollout epoch it adopts the next version after a
    per-function canary jitter. A (function, version) pair is a distinct
    *revision* row with its own versioned image id, so the moment a function
    adopts v+1 its traffic cold-starts against an image nothing has built —
    the shared image is invalidated mid-trace exactly like a redeploy, while
    the stale version keeps occupying pool capacity until LRU reclaims it."""

    def __init__(self, n_functions: int, horizon_min: float, seed: int,
                 n_images: int, image_skew: float, rate_model: str,
                 rate_skew: float, total_rate_per_min: float,
                 n_rollouts: int, rollout_stagger_min: float,
                 resolution_min: float, block_min: float, chunk_min: float):
        if n_rollouts < 0:
            raise ValueError(f"n_rollouts must be >= 0, got {n_rollouts}")
        self.n_base_functions = int(n_functions)
        self.n_versions = int(n_rollouts) + 1
        super().__init__(tag=_TAG_ROLLOUT, seed=seed,
                         rows=n_functions * self.n_versions,
                         resolution_min=resolution_min,
                         n_functions=n_functions * self.n_versions,
                         horizon_min=horizon_min, block_min=block_min,
                         chunk_min=chunk_min)
        self.rates = _base_rates(n_functions, seed, rate_model, rate_skew,
                                 total_rate_per_min)
        self.base_images = assign_images(n_functions, n_images, image_skew,
                                         seed)
        self.n_images = int(n_images)
        setup = block_rng(seed, _TAG_ROLLOUT, 0, 1)
        # adoption[f, v]: when fn f starts running version v (v=0 at t=0);
        # epochs split the horizon evenly, canaries jitter per function
        epochs = horizon_min * (np.arange(1, self.n_versions)
                                / self.n_versions)
        jitter = setup.uniform(0.0, rollout_stagger_min,
                               size=(n_functions, max(n_rollouts, 1)))
        adoption = np.zeros((n_functions, self.n_versions))
        if n_rollouts:
            adoption[:, 1:] = np.minimum(epochs[None, :]
                                         + jitter[:, :n_rollouts],
                                         horizon_min)
        self.adoption = adoption

    def _rev(self, fn: int, version: int) -> int:
        return fn + version * self.n_base_functions

    def meta_traces(self) -> List[Trace]:
        out = []
        for v in range(self.n_versions):
            for f in range(self.n_base_functions):
                out.append(Trace(self._rev(f, v), float(self.rates[f]),
                                 np.empty((0,), np.float64),
                                 image_id=int(self.base_images[f])
                                 + v * self.n_images))
        out.sort(key=lambda t: t.fn_index)
        return out

    def _block_rates(self, block, starts, widths):
        n, v = self.n_base_functions, self.n_versions
        lam = np.zeros((n * v, len(starts)))
        ends = np.concatenate([self.adoption[:, 1:],
                               np.full((n, 1), self.horizon_min)], axis=1)
        for ver in range(v):
            a0 = self.adoption[:, ver][:, None]      # active window per fn
            a1 = ends[:, ver][:, None]
            frac = np.clip(np.minimum(starts[None, :] + widths[None, :], a1)
                           - np.maximum(starts[None, :], a0),
                           0.0, None) / widths[None, :]
            lam[ver * n:(ver + 1) * n] = self.rates[:, None] * frac
        return lam


# ------------------------------------------------------------------------------
# Registry entries
# ------------------------------------------------------------------------------

def _emit(st: TraceStream, stream: bool):
    return st if stream else st.materialize()


@TRACE_GENERATORS.register("diurnal")
def generate_diurnal_traces(
        n_functions: int, horizon_min: float = 7 * 24 * 60, seed: int = 0,
        n_images: int = 4, image_skew: float = 1.2,
        rate_model: str = "zipf", rate_skew: float = 1.1,
        total_rate_per_min: float = 2.0, amplitude: float = 0.8,
        period_min: float = 1440.0, peak_min: float = 14 * 60.0,
        phase_jitter_min: float = 120.0, resolution_min: float = 15.0,
        stream: bool = False, block_min: float = DEFAULT_BLOCK_MIN,
        chunk_min: float = DEFAULT_CHUNK_MIN):
    """Diurnal day/night cycles (see :class:`DiurnalTraceStream`)."""
    return _emit(DiurnalTraceStream(
        n_functions, horizon_min, seed, n_images, image_skew, rate_model,
        rate_skew, total_rate_per_min, amplitude, period_min, peak_min,
        phase_jitter_min, resolution_min, block_min, chunk_min), stream)


@TRACE_GENERATORS.register("bursts")
def generate_burst_traces(
        n_functions: int, horizon_min: float = 2 * 24 * 60, seed: int = 0,
        n_images: int = 4, image_skew: float = 1.2,
        rate_model: str = "zipf", rate_skew: float = 1.1,
        total_rate_per_min: float = 2.0, n_bursts: int = 8,
        burst_duration_min: float = 10.0, burst_multiplier: float = 30.0,
        retries: int = 2, retry_backoff_min: float = 5.0,
        retry_decay: float = 0.5, resolution_min: float = 5.0,
        stream: bool = False, block_min: float = DEFAULT_BLOCK_MIN,
        chunk_min: float = DEFAULT_CHUNK_MIN):
    """Correlated deploy storms / retry stampedes
    (see :class:`BurstTraceStream`)."""
    return _emit(BurstTraceStream(
        n_functions, horizon_min, seed, n_images, image_skew, rate_model,
        rate_skew, total_rate_per_min, n_bursts, burst_duration_min,
        burst_multiplier, retries, retry_backoff_min, retry_decay,
        resolution_min, block_min, chunk_min), stream)


@TRACE_GENERATORS.register("tenant_mix")
def generate_tenant_traces(
        n_tenants: int = 4, fns_per_tenant: int = 16,
        images_per_tenant: int = 2, horizon_min: float = 2 * 24 * 60,
        seed: int = 0, tenant_rate_skew: float = 1.0,
        rate_skew: float = 1.1, total_rate_per_min: float = 2.0,
        noisy_multiplier: float = 3.0, resolution_min: float = 15.0,
        stream: bool = False, block_min: float = DEFAULT_BLOCK_MIN,
        chunk_min: float = DEFAULT_CHUNK_MIN):
    """Multi-tenant mix with per-tenant image partitions
    (see :class:`TenantMixTraceStream`)."""
    return _emit(TenantMixTraceStream(
        n_tenants, fns_per_tenant, images_per_tenant, horizon_min, seed,
        tenant_rate_skew, rate_skew, total_rate_per_min, noisy_multiplier,
        resolution_min, block_min, chunk_min), stream)


@TRACE_GENERATORS.register("rollout")
def generate_rollout_traces(
        n_functions: int, horizon_min: float = 2 * 24 * 60, seed: int = 0,
        n_images: int = 2, image_skew: float = 1.2,
        rate_model: str = "zipf", rate_skew: float = 1.1,
        total_rate_per_min: float = 2.0, n_rollouts: int = 2,
        rollout_stagger_min: float = 120.0, resolution_min: float = 15.0,
        stream: bool = False, block_min: float = DEFAULT_BLOCK_MIN,
        chunk_min: float = DEFAULT_CHUNK_MIN):
    """Mid-trace image-version rollouts (see :class:`RolloutTraceStream`)."""
    return _emit(RolloutTraceStream(
        n_functions, horizon_min, seed, n_images, image_skew, rate_model,
        rate_skew, total_rate_per_min, n_rollouts, rollout_stagger_min,
        resolution_min, block_min, chunk_min), stream)
