"""Atomic, async checkpoints in the reference's on-disk format (port of
``repro.checkpoint.checkpointer``).

A checkpoint is a directory ``step_N`` with ``manifest.json`` and one
``.npy`` per leaf. The manifest lists, per saved tree, each leaf's key
(spelled as JAX's ``keystr``, through :func:`repro_torch.core.tree.
flatten_with_keys`), file, shape, dtype name and the crc32 of its bytes;
bf16 leaves are stored as their uint16 bits. So a checkpoint written by
either package restores in the other.

- atomic: the directory is written as ``step_N.tmp`` and renamed with
  ``os.replace``; a crash mid-save never leaves a partial ``step_N``;
- checked: each leaf's crc32 is verified on restore;
- async: the copy to host memory finishes inside :meth:`Checkpointer.save`
  (the optimizer updates the parameters in place, so the writer thread
  never holds a device tensor the next step overwrites); the files are
  written on a background thread, joined by :meth:`Checkpointer.wait`;
- keep-last-k: older step directories are deleted after each save.

:meth:`Checkpointer.restore` returns CPU tensors; the caller moves them to
its device.

:class:`ShardedCheckpointer` is the same format for a run sharded over a
mesh of ranks: a save gathers the global arrays (``models/sharding.
gather_tree``) and rank 0 writes them; a restore reads the global arrays on
every rank and cuts each rank's shard for the *current* mesh, so a run may
resume on another mesh shape (elastic restart).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.tree import TreeDef, flatten_with_keys


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str
    keep_last: int = 3
    async_save: bool = True
    verify_on_restore: bool = True


def _to_host(tree: Any) -> List[Tuple[str, np.ndarray, str]]:
    """``[(key, host copy, dtype name), ...]`` of a tree's leaves: copies in
    host memory, bf16 as its uint16 bits under the dtype name ``bfloat16``."""
    out = []
    for key, leaf in flatten_with_keys(tree):
        if not isinstance(leaf, torch.Tensor):
            arr = np.array(leaf)
            out.append((key, arr, arr.dtype.name))
            continue
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            out.append((key, t.view(torch.int16).numpy().view(np.uint16), "bfloat16"))
        else:
            arr = t.numpy()
            out.append((key, arr, arr.dtype.name))
    return out


def _save_tree(leaves: List[Tuple[str, np.ndarray, str]], path: str,
               manifest: Dict[str, Any], prefix: str) -> None:
    entries = []
    for i, (key, arr, dtype_name) in enumerate(leaves):
        fname = f"{prefix}_{i}.npy"
        np.save(os.path.join(path, fname), arr)
        entries.append({"key": key, "file": fname, "shape": list(arr.shape),
                        "dtype": dtype_name,
                        "crc32": zlib.crc32(arr.tobytes()) & 0xFFFFFFFF})
    manifest[prefix] = entries


def _load_tree(like: Any, path: str, manifest: Dict[str, Any], prefix: str,
               verify: bool) -> Any:
    entries = manifest[prefix]
    keys = [k for k, _ in flatten_with_keys(like)]
    if keys != [e["key"] for e in entries]:
        raise ValueError(f"checkpoint tree {prefix!r} does not match the structure "
                         f"asked for ({len(entries)} leaves stored, {len(keys)} asked)")
    out = []
    for e in entries:
        arr = np.load(os.path.join(path, e["file"]))
        if verify and zlib.crc32(arr.tobytes()) & 0xFFFFFFFF != e["crc32"]:
            raise IOError(f"checkpoint corruption: {e['key']} crc mismatch")
        if e["dtype"] == "bfloat16":
            out.append(torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16))
        else:
            out.append(torch.from_numpy(arr))
    return TreeDef.of(like).unflatten(out)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for d in os.listdir(directory)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


class Checkpointer:
    def __init__(self, cfg: CheckpointConfig):
        self.cfg = cfg
        os.makedirs(cfg.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        """``trees``: e.g. ``{'params': ..., 'opt_state': ...}``. The copy to
        host memory happens here, before the call returns; the disk writes
        happen on a background thread when ``async_save``."""
        self.wait()
        host = {name: _to_host(tree) for name, tree in trees.items()}
        if self.cfg.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write(self, step: int, trees: Dict[str, list], extra: Dict[str, Any]) -> None:
        try:
            final = os.path.join(self.cfg.directory, f"step_{step}")
            tmp = final + ".tmp"
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            manifest: Dict[str, Any] = {"step": step, "time": time.time(),
                                        "extra": extra}
            for name, tree in trees.items():
                _save_tree(tree, tmp, manifest, name)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.isdir(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
        except BaseException as e:  # surfaced on the next wait()
            self._error = e

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = sorted(int(m.group(1)) for d in os.listdir(self.cfg.directory)
                       if (m := re.fullmatch(r"step_(\d+)", d)))
        for s in steps[: -self.cfg.keep_last]:
            shutil.rmtree(os.path.join(self.cfg.directory, f"step_{s}"),
                          ignore_errors=True)

    def latest(self) -> Optional[int]:
        """The latest complete step in the directory, or None."""
        return latest_step(self.cfg.directory)

    def restore(self, step: Optional[int], like: Dict[str, Any]
                ) -> Optional[Dict[str, Any]]:
        """CPU tensor trees with the ``like`` structures, plus the manifest
        under ``__manifest__``; None when there is no checkpoint. ``step``
        None takes the latest."""
        self.wait()
        if step is None:
            step = latest_step(self.cfg.directory)
            if step is None:
                return None
        path = os.path.join(self.cfg.directory, f"step_{step}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        out = {name: _load_tree(tree, path, manifest, name, self.cfg.verify_on_restore)
               for name, tree in like.items()}
        out["__manifest__"] = manifest
        return out


class ShardedCheckpointer(Checkpointer):
    """Checkpoints of trees sharded over a mesh of ranks (``par``, a
    ``models.sharding.Parallel``), each tree named in ``specs`` with its
    PartitionSpec tree. Every method is collective: all ranks call it in the
    same order. On disk it is :class:`Checkpointer`'s format, global arrays
    written by rank 0, so either package restores it."""

    def __init__(self, cfg: CheckpointConfig, par: Any, specs: Dict[str, Any], device):
        import torch.distributed as dist
        super().__init__(cfg)
        self.par, self.specs, self.device = par, specs, device
        self.rank = dist.get_rank()

    def save(self, step: int, trees: Dict[str, Any],
             extra: Optional[Dict[str, Any]] = None) -> None:
        from repro_torch.models.sharding import gather_tree
        full = {name: gather_tree(tree, self.specs[name], self.par)
                for name, tree in trees.items()}
        if self.rank == 0:
            super().save(step, full, extra)

    def latest(self) -> Optional[int]:
        """Rank 0's answer, on every rank."""
        from repro_torch.models.sharding import broadcast_object
        self.wait()
        return broadcast_object(super().latest())

    def restore(self, step: Optional[int], like: Dict[str, Any]
                ) -> Optional[Dict[str, Any]]:
        """Each rank's shards of the global arrays (CPU tensors), cut for the
        current mesh, once rank 0's last write has finished."""
        from repro_torch.models.sharding import barrier, shard_tree
        self.wait()
        barrier(self.device)
        out = super().restore(step, like)
        if out is not None:
            for name in like:
                out[name] = shard_tree(out[name], self.specs[name], self.par)
        return out
