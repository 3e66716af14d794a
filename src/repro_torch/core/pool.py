"""The provider-side Dependency Manager: a refcounted pool of live images.

Port of ``repro.core.pool`` (``PoolStats``, ``CapacityLedger``,
``ClusterImageCache``, ``DependencyManager``). The manager builds and owns
live dependency images, serves migration requests (metadata + page server),
dumps cold images to a **disk tier** and revives them without re-running
initialization, enforces a pool capacity with LRU eviction, and accounts
memory: pool cost is O(#images), not O(#functions). Its page stores live on one device (``cuda`` unless the
caller passes ``device="cpu"``), the buffer every tenant's restore gathers
from. ``ClusterImageCache`` is the fleet simulators' cluster-wide shared
image tier over a ``CapacityLedger``: pure bookkeeping, copied unchanged.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from repro_torch import spans
from repro_torch.core.image import LiveDependencyImage, build_image
from repro_torch.core.migration import (
    LinkModel,
    MigrationClient,
    RestoredImage,
    RestorePolicy,
)
from repro_torch.core.pages import DEFAULT_PAGE_SIZE
from repro_torch.device import DeviceLike, resolve_device


@dataclass
class PoolStats:
    builds: int = 0
    hits: int = 0
    misses: int = 0
    evictions: int = 0
    revivals: int = 0
    build_s: float = 0.0
    revive_s: float = 0.0


@dataclass
class LedgerEntry:
    nbytes: int
    last_used: float = 0.0
    refcount: int = 0
    pinned: bool = False


class CapacityLedger:
    """Pure capacity + LRU accounting over named residents.

    This is the pool's admission/eviction *decision logic* factored out of
    :class:`DependencyManager` so the fleet simulator (``core/fleet.py``) can
    model one per-worker pool with exactly the same semantics the real manager
    applies to live images: admit up to ``capacity_bytes``, evicting the
    least-recently-used unpinned entry with no in-flight references first.
    """

    def __init__(self, capacity_bytes: Optional[int] = None):
        self.capacity_bytes = capacity_bytes
        self.entries: Dict[str, LedgerEntry] = {}
        self.evictions = 0
        # incremental byte total, updated at every admit/evict/resize: the
        # eviction loop reads it per iteration, and the sanitizer's
        # books-balance check recomputes the sum to audit it
        self._used_bytes = 0

    def holds(self, key: str) -> bool:
        """True if ``key`` is resident."""
        return key in self.entries

    def used_bytes(self) -> int:
        """Total bytes of resident entries."""
        return self._used_bytes

    def touch(self, key: str, now: float) -> None:
        """Refresh ``key``'s LRU timestamp (``now``: any monotone clock —
        the fleet simulator passes minutes, the live manager passes
        ``time.monotonic()`` seconds; only the ordering matters)."""
        if key in self.entries:
            self.entries[key].last_used = now

    def acquire(self, key: str) -> None:
        """Take an in-flight reference on ``key``; referenced entries are
        never chosen as eviction victims."""
        if key in self.entries:
            self.entries[key].refcount += 1

    def release(self, key: str) -> None:
        """Drop one in-flight reference on ``key`` (floors at zero)."""
        if key in self.entries:
            self.entries[key].refcount = max(0, self.entries[key].refcount - 1)

    def _pick_victim(self, exclude: Optional[str] = None) -> Optional[str]:
        candidates = [(e.last_used, k) for k, e in self.entries.items()
                      if not e.pinned and e.refcount == 0 and k != exclude]
        return min(candidates)[1] if candidates else None

    def _reclaim(self, headroom: int, exclude: Optional[str] = None) -> list:
        """Evict LRU entries until ``headroom`` more bytes fit; returns the
        evicted keys. ``exclude`` protects the entry being (re-)admitted."""
        evicted = []
        if self.capacity_bytes is None:
            return evicted
        while self._used_bytes + headroom > self.capacity_bytes:
            victim = self._pick_victim(exclude)
            if victim is None:
                break
            self._used_bytes -= self.entries[victim].nbytes
            del self.entries[victim]
            self.evictions += 1
            evicted.append(victim)
        return evicted

    def admit(self, key: str, nbytes: int, now: float,
              pinned: bool = False) -> list:
        """Admit ``key``; returns the keys evicted to make room. The entry is
        admitted even if eviction cannot free enough space (the pool never
        refuses the image it was asked for — same as the manager).

        Re-admitting a resident key refreshes its size (a resized/reshared
        image must not keep its stale ``nbytes``) and re-runs eviction if it
        grew — the entry itself is never its own victim."""
        if key in self.entries:
            entry = self.entries[key]
            grew = nbytes > entry.nbytes
            self._used_bytes += nbytes - entry.nbytes
            entry.nbytes = nbytes
            entry.pinned = pinned          # refresh pin state, not just size
            self.touch(key, now)
            return self._reclaim(0, exclude=key) if grew else []
        evicted = self._reclaim(nbytes)
        self.entries[key] = LedgerEntry(nbytes=nbytes, last_used=now,
                                        pinned=pinned)
        self._used_bytes += nbytes
        return evicted

    def evict(self, key: str) -> None:
        entry = self.entries.pop(key, None)
        if entry is not None:
            self._used_bytes -= entry.nbytes

    def resize(self, key: str, nbytes: int) -> None:
        if key in self.entries:
            self._used_bytes += nbytes - self.entries[key].nbytes
            self.entries[key].nbytes = nbytes


class ClusterImageCache:
    """Cluster-wide shared image tier over :class:`CapacityLedger`.

    The fleet's workers each run a private pool, but the *cluster* holds each
    distinct pre-warmed image at most once per fetch from the source store:
    the first worker to need an image pays the source fetch, every later
    worker pulls the pages from a peer over the network (remote hit), and a
    worker whose own pool already holds it pays host-memcpy only (local hit).
    This class is the index that makes that sharing decidable: one
    capacity-bounded ledger of *distinct* images plus, per image, the set of
    workers currently holding it.

    Units: ``nbytes`` in bytes, ``now`` in simulation minutes (any monotone
    clock works — it only orders LRU decisions).

    Args:
        capacity_bytes: total bytes of distinct images the shared tier may
            hold cluster-wide; ``None`` = unbounded. Exceeding it evicts the
            least-recently-used image *everywhere* (``on_evict`` is called so
            the owner can drop per-worker residents too). An image larger
            than the whole capacity is **rejected** — it can never fit the
            shared tier, so every non-local access to it is a source miss.
        on_evict: callback ``(key) -> None`` fired for each cluster-wide
            eviction, before the holder set is cleared.
    """

    def __init__(self, capacity_bytes: Optional[int] = None,
                 on_evict: Optional[Callable[[str], None]] = None):
        self.ledger = CapacityLedger(capacity_bytes)
        self.holders: Dict[str, set] = {}
        self.on_evict = on_evict
        self.local_hits = 0
        self.remote_hits = 0
        self.misses = 0
        self.rejected = 0           # admits refused because nbytes > capacity
        self.peak_bytes = 0         # high-water mark of distinct-image bytes

    def classify(self, key: str, worker) -> str:
        """Pure read: ``'local'`` (``worker`` holds ``key``), ``'remote'``
        (some other worker does), or ``'miss'`` (nobody — the pages must
        come from the source store). No counters move."""
        held_by = self.holders.get(key)
        if held_by and worker in held_by:
            return "local"
        return "remote" if held_by else "miss"

    def count(self, tier: str) -> None:
        """Record one access at ``tier`` in the hit/miss counters. Split
        from :meth:`classify` so a caller that refines the classification
        (the fleet engine treats worker-pool residency as 'local' even when
        the bounded tier rejected the image) can still keep these counters
        truthful."""
        if tier == "local":
            self.local_hits += 1
        elif tier == "remote":
            self.remote_hits += 1
        else:
            self.misses += 1

    def lookup(self, key: str, worker) -> str:
        """:meth:`classify` + :meth:`count` in one step."""
        tier = self.classify(key, worker)
        self.count(tier)
        return tier

    def holds(self, key: str) -> bool:
        """True if any worker in the cluster holds ``key``."""
        return bool(self.holders.get(key))

    def used_bytes(self) -> int:
        """Bytes of *distinct* images resident anywhere (each counted once)."""
        return self.ledger.used_bytes()

    @property
    def evictions(self) -> int:
        """Cluster-wide evictions forced by ``capacity_bytes``."""
        return self.ledger.evictions

    def admit(self, key: str, nbytes: int, worker, now: float) -> list:
        """Record that ``worker`` now holds ``key`` (``nbytes`` bytes).

        Returns the keys evicted cluster-wide to make room (``on_evict`` has
        already run for each). An image larger than ``capacity_bytes`` is
        rejected (counted in ``rejected``) and nothing changes."""
        cap = self.ledger.capacity_bytes
        if cap is not None and nbytes > cap:
            self.rejected += 1
            return []
        evicted = self.ledger.admit(key, nbytes, now=now)
        for victim in evicted:
            if self.on_evict is not None:
                self.on_evict(victim)
            self.holders.pop(victim, None)
        self.holders.setdefault(key, set()).add(worker)
        self.peak_bytes = max(self.peak_bytes, self.used_bytes())
        return evicted

    def touch(self, key: str, now: float) -> None:
        """Refresh ``key``'s LRU timestamp (any-tier hit keeps it alive)."""
        self.ledger.touch(key, now)

    def worker_evicted(self, worker, key: str) -> None:
        """A worker's private pool dropped ``key``. When the last holder goes,
        the image leaves the shared tier too (the tier is the union of worker
        pools, not separate storage), without counting a capacity eviction."""
        held_by = self.holders.get(key)
        if held_by is None:
            return
        held_by.discard(worker)
        if not held_by:
            del self.holders[key]
            self.ledger.evict(key)

    def summary(self) -> Dict[str, Any]:
        return {
            "images": sorted(self.holders),
            "used_bytes": self.used_bytes(),
            "peak_bytes": self.peak_bytes,
            "local_hits": self.local_hits,
            "remote_hits": self.remote_hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "rejected": self.rejected,
        }


class DependencyManager:
    """The pool of live images on one device (default ``cuda``; raises when
    there is no card unless ``device="cpu"``)."""

    def __init__(
        self,
        capacity_bytes: Optional[int] = None,
        disk_dir: Optional[str] = None,
        link: Optional[LinkModel] = None,
        page_size: int = DEFAULT_PAGE_SIZE,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.capacity_bytes = capacity_bytes
        self.disk_dir = disk_dir
        # per-manager default link: a shared class-level instance would leak
        # latency/bandwidth mutations across managers
        self.link = link if link is not None else LinkModel()
        self.page_size = page_size
        # Shared manager state below is annotated for repro-lint's
        # lock-discipline checker (docs/ANALYSIS.md): every access outside
        # __init__ must sit inside `with self._lock` (or a method declared
        # `# requires-lock: _lock`), which CI verifies statically.
        self._images: Dict[str, LiveDependencyImage] = {}   # guarded-by: _lock
        self._ledger = CapacityLedger(capacity_bytes)       # guarded-by: _lock
        self._on_disk: Dict[str, bool] = {}                 # guarded-by: _lock
        self._builders: Dict[str, Callable[[], Any]] = {}   # guarded-by: _lock
        self._arch_names: Dict[str, str] = {}               # guarded-by: _lock
        self._executables: Dict[str, Dict[str, Any]] = {}   # guarded-by: _lock
        self._treedefs: Dict[str, Any] = {}                 # guarded-by: _lock
        self._pinned: set = set()                           # guarded-by: _lock
        self._lock = threading.RLock()
        self.stats = PoolStats()                            # guarded-by: _lock

    # ------------------------------------------------------------------ registry
    def register_image(
        self,
        image_id: str,
        arch_name: str,
        params_builder: Callable[[], Any],
        *,
        executables: Optional[Dict[str, Any]] = None,
        pin: bool = False,
        build_now: bool = True,
    ) -> None:
        with self._lock:
            self._builders[image_id] = params_builder
            self._arch_names[image_id] = arch_name
            self._executables[image_id] = executables or {}
            if pin:
                self._pinned.add(image_id)
        if build_now:
            self._ensure_live(image_id)

    def has_live(self, image_id: str) -> bool:
        """True if ``image_id`` is currently resident in the RAM tier."""
        with self._lock:
            return image_id in self._images

    def live_image_bytes(self, image_id: str) -> Optional[int]:
        """Page-store size (bytes) of a LIVE image, or ``None`` when the
        image is not resident — a pure read that never builds or revives
        (unlike ``_ensure_live``)."""
        with self._lock:
            img = self._images.get(image_id)
            return None if img is None else img.image_bytes

    def known(self, image_id: str) -> bool:
        """True if a builder for ``image_id`` has been registered."""
        with self._lock:
            return image_id in self._builders

    # ------------------------------------------------------------------ build/evict
    def _ensure_live(self, image_id: str) -> LiveDependencyImage:
        with self._lock:
            if image_id in self._images:
                self.stats.hits += 1
                img = self._images[image_id]
                # LRU recency clock for the live manager tier — not part of
                # any simulated result.  # repro-lint: allow[wall-clock]
                img.last_used = time.monotonic()
                self._ledger.touch(image_id, img.last_used)
                return img
            self.stats.misses += 1
            t0 = time.perf_counter()
            if self._on_disk.get(image_id) and self.disk_dir:
                img = LiveDependencyImage.from_disk(
                    self.disk_dir, image_id, self._treedefs[image_id],
                    device=self.device)
                img.executables = self._executables.get(image_id, {})
                self.stats.revivals += 1
                self.stats.revive_s += time.perf_counter() - t0
            else:
                img = build_image(
                    image_id, self._arch_names[image_id], self._builders[image_id],
                    page_size=self.page_size,
                    executables=self._executables.get(image_id), device=self.device)
                self._treedefs[image_id] = img.treedef
                self.stats.builds += 1
                self.stats.build_s += time.perf_counter() - t0
            self._admit(img)
            return img

    def _admit(self, img: LiveDependencyImage) -> None:  # requires-lock: _lock
        image_id = img.metadata.image_id
        evicted = self._ledger.admit(image_id, img.image_bytes, img.last_used,
                                     pinned=image_id in self._pinned)
        for victim in evicted:
            self._spill(victim)
        self._images[image_id] = img

    def evict(self, image_id: str) -> None:
        """RAM -> disk tier (or drop, if no disk dir; rebuildable via builder)."""
        with self._lock:
            self._ledger.evict(image_id)
            self._spill(image_id)

    def _spill(self, image_id: str) -> None:  # requires-lock: _lock
        img = self._images.pop(image_id, None)
        if img is None:
            return
        if self.disk_dir:
            img.dump_to_disk(self.disk_dir)
            self._on_disk[image_id] = True
        self.stats.evictions += 1

    # ------------------------------------------------------------------ migration
    def request_migration(
        self,
        image_id: str,
        policy: RestorePolicy = RestorePolicy.BULK,
        link: Optional[LinkModel] = None,
    ) -> RestoredImage:
        """Paper Fig. 4c: look up the image, hand metadata + a page server to the
        container's migration client (span ``pool.request``, the image's
        lookup inside it ``pool.ensure_live``)."""
        with spans.span("pool.request"):
            with spans.span("pool.ensure_live"):
                img = self._ensure_live(image_id)
            with self._lock:
                img.refcount += 1
                # Live-manager LRU clock.  # repro-lint: allow[wall-clock]
                img.last_used = time.monotonic()
                self._ledger.acquire(image_id)
                self._ledger.touch(image_id, img.last_used)
            client = MigrationClient(link or self.link)
            return client.migrate(img, policy)

    def release(self, image_id: str) -> None:
        with self._lock:
            if image_id in self._images:
                self._images[image_id].refcount = max(
                    0, self._images[image_id].refcount - 1)
                self._ledger.release(image_id)

    def executables_for(self, image_id: str) -> Dict[str, Any]:
        return self._ensure_live(image_id).executables

    # ------------------------------------------------------------------ elasticity
    def reshard_image(self, image_id: str,
                      transform: Callable[[Any], Any]) -> None:
        """Rebuild an image's pages under a new layout (elastic mesh change) without
        re-running the original initialization."""
        img = self._ensure_live(image_id)
        params = transform(img.params())
        def builder():
            return params
        new_img = build_image(image_id, img.metadata.arch_name, builder,
                              page_size=self.page_size, executables=img.executables,
                              device=self.device)
        with self._lock:
            self._treedefs[image_id] = new_img.treedef
            self._images[image_id] = new_img
            self._ledger.resize(image_id, new_img.image_bytes)

    # ------------------------------------------------------------------ accounting
    def pool_bytes(self) -> int:
        with self._lock:
            return sum(im.image_bytes for im in self._images.values())

    def metadata_bytes(self) -> int:
        with self._lock:
            return sum(im.metadata_bytes for im in self._images.values())

    def summary(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "live_images": sorted(self._images.keys()),
                "pool_bytes": self.pool_bytes(),
                "metadata_bytes": self.metadata_bytes(),
                "stats": self.stats.__dict__,
            }
