"""Live migration of dependency images: the page server and restore policies.

Port of ``repro.core.migration``, all four prototypes of the paper's Table 2:

  * ``BULK``          — on the first page fault the page server streams ALL
                        remaining pages in the background, in layer order.
  * ``LAZY``          — every fault fetches exactly the pages of the faulting leaf.
  * ``NO_PAGESERVER`` — copy the whole image in one request, then restore.
  * ``NO_LAZY``       — transfer every page through the page server *before*
                        execution begins.

A page fetch is one ``page_gather`` over the page span: on the card the copy
out of the pool's device buffer is that kernel launch. Restored leaves are
views of the gathered bytes in the leaf's dtype and shape, with no further
copy. A remote pool adds the link model's per-request latency and bandwidth
as sleeps around the real copies.
"""
from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch import spans
from repro_torch.core.image import ImageMetadata, LiveDependencyImage
from repro_torch.core.pages import view_bytes
from repro_torch.core.tree import TreeDef
from repro_torch.kernels.page_gather import page_gather


class RestorePolicy(enum.Enum):
    BULK = "bulk"
    LAZY = "lazy"
    NO_PAGESERVER = "no_pageserver"
    NO_LAZY = "no_lazy"


@dataclass
class LinkModel:
    """Transport between a page source and a function container."""
    latency_s: float = 0.0          # seconds per page-server request (RTT)
    bandwidth_bps: Optional[float] = None  # bytes/second; None = infinite

    def delay_for(self, nbytes: int) -> float:
        """Seconds one request moving ``nbytes`` bytes takes on this link:
        ``latency_s`` + ``nbytes / bandwidth_bps``."""
        d = self.latency_s
        if self.bandwidth_bps:
            d += nbytes / self.bandwidth_bps
        return d


@dataclass
class MigrationStats:
    requests: int = 0
    pages_transferred: int = 0
    bytes_transferred: int = 0
    faults: int = 0
    fault_wait_s: float = 0.0        # time execution spent blocked on pages:
                                     # faults, and wait_all's join on the stream


class PageServer:
    """Provider-side server bound to one live image (one per target)."""

    def __init__(self, image: LiveDependencyImage,
                 link: Optional[LinkModel] = None):
        self._image = image
        self._link = link if link is not None else LinkModel()
        self.stats = MigrationStats()
        self._lock = threading.Lock()

    @property
    def table(self):
        return self._image.metadata.page_table

    def fetch_pages(self, first_page: int, n_pages: int) -> torch.Tensor:
        """Copy a page span out of the pool (the unit of transfer).

        Returns:
            ``(n_pages, page_size)`` uint8 tensor on the pool's device — a
            real copy made by ``page_gather``, delayed by the link model when
            one is configured. Stats are updated under the server lock.
        """
        delay = self._link.delay_for(n_pages * self.table.page_size)
        if delay > 0:
            time.sleep(delay)
        ids = torch.arange(first_page, first_page + n_pages, dtype=torch.int32)
        pages = page_gather(self._image.store, ids)
        with self._lock:
            self.stats.requests += 1
            self.stats.pages_transferred += n_pages
            self.stats.bytes_transferred += pages.numel()
        return pages


class RestoredImage:
    """Container-side restored dependency: leaves materialize through the chosen
    policy; ``wait_all()`` blocks until the image is fully resident."""

    def __init__(self, metadata: ImageMetadata, server: PageServer, treedef: TreeDef,
                 policy: RestorePolicy):
        self.metadata = metadata
        self.treedef = treedef
        self.policy = policy
        self._server = server
        self._table = metadata.page_table
        self._local: Dict[str, torch.Tensor] = {}  # leaf key -> materialized tensor
        self._events: Dict[str, threading.Event] = {k: threading.Event()
                                                    for k in self._table.order}
        self._claim_lock = threading.Lock()
        self._claimed: set = set()         # leaves some thread is installing
        self._install_error: Optional[BaseException] = None
        self._stream_thread: Optional[threading.Thread] = None
        self._streaming_started = False
        self.stats = server.stats

    # -- internals ---------------------------------------------------------------
    def _claim(self, key: str) -> bool:
        """Check-and-set: exactly one thread wins the right to install ``key``.

        ``fault()`` and the background stream can race on the same leaf;
        without the claim both would fetch its pages."""
        with self._claim_lock:
            if key in self._claimed:
                return False
            self._claimed.add(key)
            if key not in self._local and self._events[key].is_set():
                # stale marker from a failed install: re-arm so waiters block
                # on this retry instead of reading an absent leaf
                self._events[key].clear()
            return True

    def _install_leaf(self, key: str) -> None:
        """Fetch + materialize one leaf. Caller must have won ``_claim(key)``.

        On failure the claim is released and the event set anyway so waiters
        wake up and surface the error instead of blocking forever."""
        try:
            with spans.span("migration.install"):
                e = self._table.entries[key]
                pages = self._server.fetch_pages(e.first_page, e.n_pages)
                self._local[key] = view_bytes(pages.reshape(-1), e)
        except BaseException as exc:
            with self._claim_lock:
                self._claimed.discard(key)
                self._install_error = exc
            self._events[key].set()
            raise
        self._events[key].set()

    def _ensure_leaf(self, key: str) -> None:
        """Make ``key`` resident: install it if we win the claim, else wait for
        the thread that did (and surface its failure, if any)."""
        if self._events[key].is_set() and key in self._local:
            return
        if self._claim(key):
            self._install_leaf(key)
            return
        while True:
            self._events[key].wait()
            if key in self._local:
                return
            with self._claim_lock:
                installing = key in self._claimed
            if not installing:
                raise RuntimeError(
                    f"leaf {key!r} failed to install in another thread"
                ) from self._install_error

    def _stream_all(self, skip: Sequence[str] = ()) -> None:
        with spans.span("migration.stream"):
            for key in self._table.order:      # layer order == execution order
                if key in skip or key in self._local:
                    continue
                if self._claim(key):           # else: a concurrent fault owns it
                    try:
                        self._install_leaf(key)
                    except Exception:
                        # recorded in _install_error and the claim was released —
                        # keep streaming; wait_all()/fault() retry this leaf
                        continue

    def _start_background_stream(self, skip: Sequence[str] = ()) -> None:
        # Two first-faults must not both stream, and a caller that finds the
        # stream started (wait_all) must find it running: the thread is
        # started and published under the lock.
        with self._claim_lock:
            if self._streaming_started:
                return
            self._streaming_started = True
            thread = threading.Thread(
                target=spans.carry(self._stream_all), args=(tuple(skip),), daemon=True)
            thread.start()
            self._stream_thread = thread

    # -- the fault path ------------------------------------------------------------
    def fault(self, key: str) -> torch.Tensor:
        """First touch of a leaf by the executing function (userfaultfd
        analogue). Returns the materialized leaf; blocking time is accounted
        in ``stats.fault_wait_s``. Under ``BULK`` the first fault also starts
        the background stream for the remaining leaves."""
        if self._events[key].is_set() and key in self._local:
            return self._local[key]
        self.stats.faults += 1
        with spans.phase("migration.fault") as ph:
            if self.policy == RestorePolicy.LAZY:
                self._ensure_leaf(key)
            elif self.policy == RestorePolicy.BULK:
                self._ensure_leaf(key)
                self._start_background_stream(skip=(key,))
            else:
                # NO_LAZY / NO_PAGESERVER should have pre-installed everything
                self._events[key].wait()
        self.stats.fault_wait_s += ph.seconds
        return self._local[key]

    def wait_all(self) -> None:
        """Block until every leaf is resident container-side (join the BULK
        stream and retry dead leaves, fault everything under LAZY, no-op for
        the eager policies). The BULK block counts in ``stats.fault_wait_s``,
        as LAZY's faults do."""
        if self.policy == RestorePolicy.BULK:
            with spans.phase("migration.wait_all") as ph:
                self._start_background_stream()
                if self._stream_thread is not None:
                    self._stream_thread.join()
                for key in self._table.order:
                    self._ensure_leaf(key)
            self.stats.fault_wait_s += ph.seconds
        elif self.policy == RestorePolicy.LAZY:
            with spans.span("migration.wait_all"):
                for key in self._table.order:
                    self.fault(key)

    def resident_fraction(self) -> float:
        """Fraction of leaves materialized container-side, in [0, 1]."""
        return len(self._local) / max(len(self._events), 1)

    def as_pytree(self) -> Any:
        """Full parameter tree (blocks until resident)."""
        self.wait_all()
        return self.treedef.unflatten([self._local[k] for k in self._table.tree_order])


class MigrationClient:
    """Container-side orchestrator (paper Fig. 4c)."""

    def __init__(self, link: Optional[LinkModel] = None):
        self.link = link if link is not None else LinkModel()

    def migrate(self, image: LiveDependencyImage,
                policy: RestorePolicy = RestorePolicy.BULK) -> RestoredImage:
        """Step 1: metadata transfer. Step 2: page server attach. Step 3:
        policy-specific eager work; other pages move on fault / in the
        background."""
        md = image.metadata
        delay = self.link.delay_for(md.nbytes())
        if delay > 0:
            time.sleep(delay)
        server = PageServer(image, self.link)
        restored = RestoredImage(md, server, image.treedef, policy)
        if policy == RestorePolicy.NO_LAZY:
            restored._stream_all()            # all pages through the server, upfront
        elif policy == RestorePolicy.NO_PAGESERVER:
            # whole-image copy (one giant request), then views per leaf
            pages = server.fetch_pages(0, md.page_table.n_pages)
            for key in md.page_table.order:
                e = md.page_table.entries[key]
                span = pages[e.first_page: e.first_page + e.n_pages].reshape(-1)
                restored._local[key] = view_bytes(span, e)
                restored._events[key].set()
            restored._claimed.update(md.page_table.order)
        return restored
