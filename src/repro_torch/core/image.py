"""Live dependency images: pre-initialized, shareable base-model bring-up state.

Port of ``repro.core.image``. A :class:`LiveDependencyImage` is the WarmSwap
unit of sharing: the provider builds it ONCE per (architecture, dtype) by
running the function-independent prefix of startup (init/load weights ->
paginate into the pool -> pre-build executables), and every endpoint that uses
that base model restores from it. ``ImageMetadata`` (small; the
*communication* phase) is split from the page store (large; streamed by the
page server), as CRIU splits process metadata from memory pages.

The page store is a ``(n_pages, page_size)`` uint8 tensor on the manager's
device. The disk tier (``dump_to_disk`` / ``from_disk``) writes the same
``.npz`` / ``.json`` pair as the JAX package, so either package revives the
other's images.
"""
from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.core.pages import DEFAULT_PAGE_SIZE, PageTable, materialize, paginate
from repro_torch.core.tree import TreeDef
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class ImageMetadata:
    image_id: str
    arch_name: str
    dtype: str
    page_table: PageTable
    treedef_repr: str                  # structural fingerprint (restore sanity check)
    compile_keys: tuple = ()           # executables warmed with the image
    created_at: float = 0.0
    content_hash: str = ""

    def nbytes(self) -> int:
        """The paper's 'process metadata size' (Table 3)."""
        return self.page_table.metadata_bytes() + len(self.treedef_repr) + 256


def content_hash(store: torch.Tensor, n_pages: int) -> str:
    """Cheap content fingerprint over the first pages' host bytes (the same
    digest the JAX package computes for the same store)."""
    h = hashlib.sha256()
    h.update(store[: min(len(store), 4)].cpu().numpy().tobytes())
    h.update(str(n_pages).encode())
    return h.hexdigest()[:16]


class LiveDependencyImage:
    """An in-memory dependency image: page store + metadata + warmed executables."""

    def __init__(self, metadata: ImageMetadata, store: torch.Tensor, treedef: TreeDef,
                 executables: Optional[Dict[str, Any]] = None):
        self.metadata = metadata
        self.store = store                     # (n_pages, page_size) uint8, pool device
        self.treedef = treedef
        self.executables = executables or {}   # key -> callable
        self.refcount = 0
        # Live-manager LRU clock.  # repro-lint: allow[wall-clock]
        self.last_used = time.monotonic()

    @property
    def image_bytes(self) -> int:
        """Page-store size in bytes (what the pool's CapacityLedger accounts)."""
        return int(self.store.numel())

    @property
    def n_pages(self) -> int:
        return int(self.metadata.page_table.n_pages)

    @property
    def metadata_bytes(self) -> int:
        """Serialized-metadata size in bytes (the 'communication' payload)."""
        return self.metadata.nbytes()

    def params(self) -> Any:
        """The parameter tree as views into the store (read-only use)."""
        return materialize(self.store, self.metadata.page_table, self.treedef)

    # -- disk tier (checkpoint images, paper §3.2) ---------------------------------
    def dump_to_disk(self, directory: str) -> str:
        os.makedirs(directory, exist_ok=True)
        path = os.path.join(directory, f"{self.metadata.image_id}.npz")
        tmp = os.path.join(directory, f"{self.metadata.image_id}.tmp.npz")
        np.savez(tmp, store=self.store.cpu().numpy())
        os.replace(tmp, path)
        meta = {
            "image_id": self.metadata.image_id,
            "arch_name": self.metadata.arch_name,
            "dtype": self.metadata.dtype,
            "page_table": self.metadata.page_table.to_json(),
            "treedef_repr": self.metadata.treedef_repr,
            "created_at": self.metadata.created_at,
            "content_hash": self.metadata.content_hash,
        }
        with open(os.path.join(directory, f"{self.metadata.image_id}.json"), "w") as f:
            json.dump(meta, f)
        return path

    @classmethod
    def from_disk(cls, directory: str, image_id: str,
                  treedef: Optional[TreeDef] = None,
                  device: Optional[torch.device] = None) -> "LiveDependencyImage":
        """Revive an image written by either package. ``treedef`` defaults to
        the structure recorded in the metadata; the store lands on ``device``
        (default: the CPU)."""
        with open(os.path.join(directory, f"{image_id}.json")) as f:
            meta = json.load(f)
        with np.load(os.path.join(directory, f"{image_id}.npz")) as z:
            store = torch.from_numpy(z["store"])
        if device is not None:
            store = store.to(device)
        md = ImageMetadata(
            image_id=meta["image_id"], arch_name=meta["arch_name"], dtype=meta["dtype"],
            page_table=PageTable.from_json(meta["page_table"]),
            treedef_repr=meta["treedef_repr"], created_at=meta["created_at"],
            content_hash=meta["content_hash"])
        if treedef is None:
            treedef = TreeDef.from_repr(md.treedef_repr)
        return cls(md, store, treedef)


def build_image(
    image_id: str,
    arch_name: str,
    params_builder: Callable[[], Any],
    *,
    page_size: int = DEFAULT_PAGE_SIZE,
    dtype: str = "bfloat16",
    executables: Optional[Dict[str, Any]] = None,
    device: DeviceLike = None,
) -> LiveDependencyImage:
    """Run the shareable bring-up prefix and dump it as a live image.

    ``params_builder`` is the dependency-initialization work being amortized;
    it runs exactly once per image, however many functions share it. The
    store is built on ``device`` (default ``cuda``; raises when there is no
    card unless ``device="cpu"``).
    """
    device = resolve_device(device)
    params = params_builder()
    store, table, treedef = paginate(params, page_size=page_size, device=device)
    md = ImageMetadata(
        image_id=image_id, arch_name=arch_name, dtype=dtype, page_table=table,
        # Provenance timestamp on the live image, not a simulated quantity.
        treedef_repr=str(treedef), created_at=time.time(),  # repro-lint: allow[wall-clock]
        content_hash=content_hash(store, table.n_pages),
        compile_keys=tuple(sorted((executables or {}).keys())),
    )
    return LiveDependencyImage(md, store, treedef, executables)
