"""Append-only JSONL results store for sweep runs (the executor's backend).

Port of ``repro.experiments.store``: the same code with the imports pointed at
the port. Keys, records and headers are the reference's byte for byte, so
either package reads and resumes the other's store.

One store file holds one sweep's results, one JSON line per completed grid
point, keyed by a **content hash of the fully resolved scenario spec** (post
overrides, post smoke scaling, post seed derivation) — so a store never
confuses results produced by different specs, an interrupted sweep resumes by
skipping keys already present, and a serial and a parallel run of the same
grid write byte-identical files (the executor appends in grid order).

File layout (``store_schema_version: 1``)::

    {"store_schema_version": 1, "result_schema_version": 1}      <- header
    {"key": "<sha256>", "name": "...", "result": {...}}          <- records
    ...

Durability contract:

  * every record line is flushed + fsynced before the executor counts the
    point as done, so a killed sweep loses at most the line being written;
  * a torn (partially written) **final** line — the signature of a kill mid
    append — is detected and dropped on load, then truncated away by the
    next append, so resume just recomputes that one point;
  * a corrupt line anywhere **else** means the file was edited or the disk
    misbehaved: that is never silently skipped (:class:`CorruptStoreError`);
  * headers written by a different store schema, or records carrying a
    result schema newer than this build, fail with
    :class:`StoreSchemaError` instead of being misread.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Iterator, List, Mapping, Optional

from repro_torch.core.scenario import RESULT_SCHEMA_VERSION
from repro_torch.core.trace_stream import NON_SEMANTIC_TRACE_KWARGS

#: Version of the store file layout this build reads and writes.
STORE_SCHEMA_VERSION = 1


class StoreError(ValueError):
    """Base class for results-store failures."""


class StoreSchemaError(StoreError):
    """The store was written by an incompatible store/result schema."""


class CorruptStoreError(StoreError):
    """A non-final line failed to parse — the store was damaged, not torn."""


def canonical_json(obj: Any) -> str:
    """Deterministic JSON encoding (sorted keys, no whitespace) — the
    hashing and storage form, so one spec always produces one byte string."""
    return json.dumps(obj, sort_keys=True, separators=(",", ":"))


def normalize_spec(spec: Mapping[str, Any]) -> Dict[str, Any]:
    """Deep copy of ``spec`` with non-semantic trace kwargs dropped
    (``traces.kwargs.stream`` / ``chunk_min`` — see
    :data:`repro_torch.core.trace_stream.NON_SEMANTIC_TRACE_KWARGS`). Streamed and
    in-memory execution of one spec are bit-identical by contract, so they
    must share a store key and a derived seed."""
    d = json.loads(canonical_json(spec))
    kwargs = d.get("traces", {}).get("kwargs", {})
    for k in NON_SEMANTIC_TRACE_KWARGS:
        kwargs.pop(k, None)
    return d


def spec_key(spec: Mapping[str, Any]) -> str:
    """Content hash (sha256 hex) of a resolved scenario spec dict.

    This is the store key: two grid points collide iff their fully resolved
    specs are identical *up to non-semantic trace kwargs*
    (:func:`normalize_spec`), in which case their results are identical too
    (the engines are deterministic functions of the spec, and the streaming
    contract makes ``stream``/``chunk_min`` invisible in the results)."""
    return hashlib.sha256(
        canonical_json(normalize_spec(spec)).encode()).hexdigest()


class ResultStore:
    """Append-only JSONL store of ``{key, name, result}`` records.

    ``path`` need not exist yet; the header is written with the first
    :meth:`append`. Reading (:meth:`records`, :meth:`completed_keys`)
    validates the header and every line per the module-docstring contract.
    """

    def __init__(self, path: str):
        self.path = path
        #: True when the last load found (and dropped) a torn final line.
        self.torn_tail = False
        self._valid_bytes: Optional[int] = None   # file prefix known good

    # ------------------------------------------------------------------ read
    def exists(self) -> bool:
        return os.path.exists(self.path)

    def _iter_lines(self) -> Iterator[Dict[str, Any]]:
        """Parsed records, header validated, torn tail dropped.

        A record is committed only once its terminating newline is on disk
        (the writer appends ``line + "\\n"`` atomically-enough and fsyncs), so
        *any* content after the file's last newline is a torn append — even
        content that happens to parse — and is dropped; the next
        :meth:`append` truncates it away. A line that fails to parse anywhere
        **before** the last newline is real damage and raises."""
        self.torn_tail = False
        self._valid_bytes = 0
        if not self.exists():
            return
        with open(self.path, "rb") as f:
            raw = f.read()
        if not raw.strip():
            return
        lines = raw.split(b"\n")
        if lines[-1].strip():
            self.torn_tail = True
        committed, torn = lines[:-1], lines[-1]
        offset = 0
        parsed_any = False
        for li, line in enumerate(committed):
            end = offset + len(line) + 1          # +1 for the newline
            if not line.strip():
                offset = end
                self._valid_bytes = end
                continue
            try:
                obj = json.loads(line)
                if not isinstance(obj, dict):
                    raise ValueError("line is not a JSON object")
            except ValueError as e:
                raise CorruptStoreError(
                    f"{self.path}: corrupt line {li + 1} (before the last "
                    f"newline, so not a torn append — refusing to skip): "
                    f"{e}") from e
            if not parsed_any:
                parsed_any = True
                self._check_header(obj, li + 1)
                self._valid_bytes = end
                offset = end
                continue
            if "key" not in obj or "result" not in obj:
                raise CorruptStoreError(
                    f"{self.path}: line {li + 1} is missing 'key'/'result'")
            self._valid_bytes = end
            offset = end
            yield obj

    def _check_header(self, obj: Mapping[str, Any], lineno: int) -> None:
        if "store_schema_version" not in obj:
            raise StoreSchemaError(
                f"{self.path}: line {lineno} is not a store header "
                f"(expected store_schema_version) — not a results store?")
        sv = obj["store_schema_version"]
        if sv != STORE_SCHEMA_VERSION:
            raise StoreSchemaError(
                f"{self.path}: store_schema_version {sv!r} != "
                f"{STORE_SCHEMA_VERSION} — refusing to mix store layouts")
        rv = obj.get("result_schema_version", RESULT_SCHEMA_VERSION)
        if not isinstance(rv, int) or rv > RESULT_SCHEMA_VERSION:
            raise StoreSchemaError(
                f"{self.path}: result_schema_version {rv!r} is newer than "
                f"this build supports (<= {RESULT_SCHEMA_VERSION})")

    def records(self) -> List[Dict[str, Any]]:
        """All good records, in file order (torn tail dropped; corrupt
        interior lines / schema mismatches raise)."""
        return list(self._iter_lines())

    def completed_keys(self) -> Dict[str, Dict[str, Any]]:
        """``key -> record`` for every stored point (last write wins)."""
        return {r["key"]: r for r in self._iter_lines()}

    # ----------------------------------------------------------------- write
    def append(self, key: str, result: Mapping[str, Any],
               name: str = "") -> None:
        """Append one record durably (flush + fsync before returning).

        The first append writes the header; any torn tail left by a previous
        kill is truncated away first, so the file stays one-line-per-record.
        """
        if self._valid_bytes is None:
            # establish the good prefix (validates header/schema as a side
            # effect; raises rather than appending to an incompatible file)
            for _ in self._iter_lines():
                pass
        new_file = self._valid_bytes == 0
        mode = "r+b" if (self.exists() and not new_file) else "wb"
        with open(self.path, mode) as f:
            if mode == "r+b":
                f.truncate(self._valid_bytes)
                f.seek(self._valid_bytes)
            if new_file:
                header = canonical_json({
                    "store_schema_version": STORE_SCHEMA_VERSION,
                    "result_schema_version": RESULT_SCHEMA_VERSION,
                })
                f.write(header.encode() + b"\n")
            record = canonical_json({"key": key, "name": name,
                                     "result": dict(result)})
            f.write(record.encode() + b"\n")
            f.flush()
            os.fsync(f.fileno())
            self._valid_bytes = f.tell()
        self.torn_tail = False
