"""Parameter paging: tree <-> fixed-size pages in one uint8 page store.

Port of ``repro.core.pages``. A dependency image's parameters become
fixed-size byte pages laid out in **layer order**, so bulk restore streams
pages in the order the forward pass consumes them. The page store is a
``(n_pages, page_size)`` uint8 tensor on the pool's device: on the card it is
the device buffer shared by every tenant that ``page_gather`` reads from.

The page table (leaf key -> page span) serializes to the same JSON as the JAX
package's, byte for byte, so either package restores the other's images.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.tree import TreeDef, flatten_with_keys, nest

DEFAULT_PAGE_SIZE = 1 << 22  # 4 MiB

#: dtype names as numpy spells them (what the page table stores) -> torch
_DTYPES: Dict[str, torch.dtype] = {
    "bfloat16": torch.bfloat16, "float16": torch.float16,
    "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    return _NAMES[dtype]


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


@dataclass
class LeafEntry:
    key: str                 # keystr path of the leaf
    shape: Tuple[int, ...]
    dtype: str               # numpy dtype name, e.g. 'bfloat16'
    nbytes: int
    first_page: int
    n_pages: int
    offset: int              # byte offset of this leaf inside its first page == 0 here
    layer_index: int         # streaming order group

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


@dataclass
class PageTable:
    page_size: int
    entries: Dict[str, LeafEntry]
    n_pages: int
    order: List[str] = field(default_factory=list)       # leaf keys in streaming order
    tree_order: List[str] = field(default_factory=list)  # leaf keys in tree-flatten order

    @property
    def nbytes_pages(self) -> int:
        return self.n_pages * self.page_size

    @property
    def nbytes_payload(self) -> int:
        return sum(e.nbytes for e in self.entries.values())

    def metadata_bytes(self) -> int:
        """Size of the serialized table — the paper's 'process metadata' size."""
        return len(self.to_json().encode())

    def to_json(self) -> str:
        return json.dumps({
            "page_size": self.page_size,
            "n_pages": self.n_pages,
            "order": self.order,
            "tree_order": self.tree_order,
            "entries": {k: e.to_json() for k, e in self.entries.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "PageTable":
        d = json.loads(s)
        entries = {k: LeafEntry(**{**v, "shape": tuple(v["shape"])})
                   for k, v in d["entries"].items()}
        return cls(page_size=d["page_size"], entries=entries,
                   n_pages=d["n_pages"], order=list(d["order"]),
                   tree_order=list(d.get("tree_order", [])))


def as_tensor(leaf: Any) -> torch.Tensor:
    """A leaf as a tensor: tensors pass through, numpy arrays are wrapped."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.ascontiguousarray(leaf))


def byte_view(t: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a tensor's bytes (C order, any dtype)."""
    flat = t.contiguous().reshape(-1)
    return flat if flat.dtype == torch.uint8 else flat.view(torch.uint8)


def view_bytes(raw: torch.Tensor, e: LeafEntry) -> torch.Tensor:
    """Reinterpret a flat uint8 tensor holding a leaf's bytes as that leaf;
    a view, no copy."""
    dt = torch_dtype(e.dtype)
    raw = raw[: e.nbytes]
    return (raw if dt == torch.uint8 else raw.view(dt)).reshape(e.shape)


def _streaming_order(keys: Sequence[str]) -> List[str]:
    """Embed first (needed at step start), then scanned units, remainder, the rest."""
    def rank(k: str) -> Tuple[int, str]:
        if "embed" in k and "tok" in k:
            return (0, k)
        if k.startswith("['unit']") or "['unit']" in k:
            return (1, k)
        if "['rem']" in k:
            return (2, k)
        if "enc" in k:
            return (3, k)
        if "final_norm" in k:
            return (4, k)
        return (5, k)
    return sorted(keys, key=rank)


def paginate(params: Any, page_size: int = DEFAULT_PAGE_SIZE,
             device: Optional[torch.device] = None
             ) -> Tuple[torch.Tensor, PageTable, TreeDef]:
    """Flatten ``params`` into (page_store (n_pages, page_size) uint8, table, treedef).

    Every leaf starts on a page boundary (pages are the transfer/sharing unit;
    sub-page packing would couple unrelated leaves into one fault). The store
    is allocated on ``device`` (default: the first leaf's device) and each
    leaf's bytes are copied into it in place.
    """
    flat = [(k, as_tensor(v)) for k, v in flatten_with_keys(params)]
    by_key = dict(flat)
    tree_order = [k for k, _ in flat]
    order = _streaming_order(tree_order)
    if device is None:
        device = flat[0][1].device if flat else torch.device("cpu")

    entries: Dict[str, LeafEntry] = {}
    page_cursor = 0
    for li, key in enumerate(order):
        t = by_key[key]
        nbytes = t.numel() * t.element_size()
        n_pages = max(1, -(-nbytes // page_size))
        entries[key] = LeafEntry(
            key=key, shape=tuple(t.shape), dtype=dtype_name(t.dtype),
            nbytes=nbytes, first_page=page_cursor, n_pages=n_pages,
            offset=0, layer_index=li)
        page_cursor += n_pages
    store = torch.zeros((page_cursor, page_size), dtype=torch.uint8, device=device)
    flat_store = store.view(-1)
    for key in order:
        e = entries[key]
        start = e.first_page * page_size
        flat_store[start: start + e.nbytes].copy_(byte_view(by_key[key]))
    table = PageTable(page_size=page_size, entries=entries,
                      n_pages=page_cursor, order=order, tree_order=tree_order)
    return store, table, TreeDef.of(params)


def materialize_leaf(store: torch.Tensor, table: PageTable, key: str) -> torch.Tensor:
    """One leaf as a view into ``store`` (pass a copy of the store if the
    caller may write to the leaf)."""
    e = table.entries[key]
    return view_bytes(store[e.first_page: e.first_page + e.n_pages].reshape(-1), e)


def materialize(store: torch.Tensor, table: PageTable, treedef: TreeDef,
                keys: Optional[Iterable[str]] = None) -> Any:
    """Rebuild the full tree (or, with ``keys``, a {key: tensor} subset)."""
    if keys is not None:
        return {k: materialize_leaf(store, table, k) for k in keys}
    return treedef.unflatten([materialize_leaf(store, table, k)
                              for k in table.tree_order])


def params_from_numpy(flat: Dict[str, np.ndarray],
                      device: Optional[torch.device] = None) -> Any:
    """The port's nested params from JAX parameters given as numpy arrays
    keyed by keystr. A bfloat16 leaf arrives as its uint16 view (numpy has no
    bfloat16) and is reinterpreted, bit for bit, as ``torch.bfloat16``."""
    def conv(a: np.ndarray) -> torch.Tensor:
        a = np.array(a)                       # a writable copy the tensor owns
        if a.dtype == np.uint16:
            t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(a)
        return t if device is None else t.to(device)
    return nest({k: conv(v) for k, v in flat.items()})
