"""The port's pool and migration keep the invariants of tests/test_pages_pool.py
(lines 75-203): identical params under every policy, LAZY moves only touched
pages, BULK streams everything, NO_PAGESERVER is one request, a fault storm
fetches each leaf once, and a dead stream neither deadlocks nor hides its
error. The parameters come from the JAX package's own test tree."""
import tempfile
import threading

import jax
import jax.numpy as jnp
import pytest
import torch

from repro_torch.core import DependencyManager, LinkModel, RestorePolicy
from repro_torch.core.pages import byte_view
from repro_torch.core.tree import flatten_with_keys
from tests._torch_parity import tree_to_torch


def _params(seed=0, d=64):
    k = jax.random.PRNGKey(seed)
    return tree_to_torch({"a": jax.random.normal(k, (d, d)),
                          "b": {"w": jax.random.normal(k, (d, 4 * d)),
                                "scale": jnp.zeros((d,))}})


def _mgr(**kw):
    return DependencyManager(device="cpu", **kw)


def _assert_same(a, b):
    fa, fb = flatten_with_keys(a), flatten_with_keys(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (_, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(byte_view(x), byte_view(y))


@pytest.mark.parametrize("policy", list(RestorePolicy))
def test_all_policies_restore_identical_params(policy):
    mgr = _mgr()
    mgr.register_image("img", "test", lambda: _params())
    _assert_same(_params(), mgr.request_migration("img", policy).as_pytree())


def test_lazy_restore_transfers_only_touched_pages():
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params(d=128))
    restored = mgr.request_migration("img", RestorePolicy.LAZY)
    restored.fault(restored.metadata.page_table.order[0])
    assert restored.stats.pages_transferred < restored.metadata.page_table.n_pages
    assert restored.resident_fraction() < 1.0


def test_bulk_restore_streams_everything_after_first_fault():
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params(d=128))
    restored = mgr.request_migration("img", RestorePolicy.BULK)
    restored.fault(restored.metadata.page_table.order[0])
    restored.wait_all()
    assert restored.resident_fraction() == 1.0
    assert restored.stats.pages_transferred == restored.metadata.page_table.n_pages


def test_no_pageserver_is_one_big_request():
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params())
    restored = mgr.request_migration("img", RestorePolicy.NO_PAGESERVER)
    assert restored.stats.requests == 1
    assert restored.resident_fraction() == 1.0


@pytest.mark.parametrize("policy", [RestorePolicy.BULK, RestorePolicy.LAZY])
def test_restore_fault_storm_fetches_each_leaf_once(policy):
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params(d=128))
    restored = mgr.request_migration("img", policy)
    keys = list(restored.metadata.page_table.order)
    errors = []

    def storm(order):
        try:
            for k in order:
                restored.fault(k)
        except Exception as exc:       # pragma: no cover - failure path
            errors.append(exc)

    threads = [threading.Thread(target=storm, args=(keys[::d],))
               for d in (1, -1, 1, -1)]
    for th in threads:
        th.start()
    restored.wait_all()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    assert not errors
    assert restored.resident_fraction() == 1.0
    assert restored.stats.pages_transferred == restored.metadata.page_table.n_pages
    _assert_same(_params(d=128), restored.as_pytree())


def test_bulk_stream_death_does_not_deadlock_wait_all():
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params(d=128))
    restored = mgr.request_migration("img", RestorePolicy.BULK)
    orig = restored._server.fetch_pages
    state = {"calls": 0}

    def flaky(first_page, n_pages):
        state["calls"] += 1
        if state["calls"] == 2:            # first background-stream fetch
            raise IOError("link flap")
        return orig(first_page, n_pages)

    restored._server.fetch_pages = flaky
    restored.fault(restored.metadata.page_table.order[0])
    restored.wait_all()
    assert restored.resident_fraction() == 1.0


def test_restore_install_failure_surfaces_and_is_retryable():
    mgr = _mgr()
    mgr.register_image("img", "test", lambda: _params())
    restored = mgr.request_migration("img", RestorePolicy.LAZY)
    key = restored.metadata.page_table.order[0]
    orig = restored._server.fetch_pages
    state = {"fail": True}

    def flaky(first_page, n_pages):
        if state["fail"]:
            state["fail"] = False
            raise IOError("link down")
        return orig(first_page, n_pages)

    restored._server.fetch_pages = flaky
    with pytest.raises(IOError):
        restored.fault(key)
    assert restored.resident_fraction() == 0.0
    out = restored.fault(key)
    assert tuple(out.shape) == restored.metadata.page_table.entries[key].shape
    restored.wait_all()
    assert restored.resident_fraction() == 1.0


def test_pool_shares_one_image_across_functions():
    mgr = _mgr()
    mgr.register_image("shared", "test", lambda: _params(d=128))
    size_one = mgr.pool_bytes()
    for _ in range(10):
        mgr.request_migration("shared", RestorePolicy.BULK).as_pytree()
        mgr.release("shared")
    assert mgr.pool_bytes() == size_one
    assert mgr.stats.builds == 1


def test_pool_evict_to_disk_and_revive():
    with tempfile.TemporaryDirectory() as tmp:
        mgr = _mgr(disk_dir=tmp)
        mgr.register_image("img", "test", lambda: _params(seed=3))
        before = mgr.request_migration("img", RestorePolicy.BULK).as_pytree()
        mgr.release("img")
        mgr.evict("img")
        assert not mgr.has_live("img")
        after = mgr.request_migration("img", RestorePolicy.BULK).as_pytree()
        _assert_same(before, after)
        assert mgr.stats.revivals == 1
        assert mgr.stats.builds == 1


def test_pool_capacity_lru_eviction():
    with tempfile.TemporaryDirectory() as tmp:
        mgr = _mgr(capacity_bytes=1 << 20, disk_dir=tmp, page_size=4096)
        for i, name in enumerate("abcd"):
            mgr.register_image(name, "t", lambda i=i: _params(seed=i + 1, d=128))
        assert mgr.pool_bytes() <= 1 << 20
        assert mgr.stats.evictions >= 1


def test_reshard_image_preserves_values():
    mgr = _mgr()
    mgr.register_image("img", "test", lambda: _params(seed=5))
    orig = mgr.request_migration("img", RestorePolicy.BULK).as_pytree()
    mgr.release("img")
    mgr.reshard_image("img", lambda p: {k: v for k, v in p.items()})
    _assert_same(orig, mgr.request_migration("img", RestorePolicy.BULK).as_pytree())


def test_remote_link_adds_latency():
    import time
    mgr = _mgr()
    mgr.register_image("img", "test", lambda: _params(d=256))
    t0 = time.perf_counter()
    mgr.request_migration("img", RestorePolicy.NO_LAZY, LinkModel(latency_s=0.005))
    assert time.perf_counter() - t0 >= 0.005


def test_restored_leaves_do_not_alias_the_pool():
    """A tenant writing to its restored params must not corrupt the shared
    image (the JAX package gets this from immutable arrays)."""
    mgr = _mgr(page_size=1024)
    mgr.register_image("img", "test", lambda: _params())
    for policy in RestorePolicy:
        p = mgr.request_migration("img", policy).as_pytree()
        p["a"].add_(1.0)
    _assert_same(_params(), mgr.request_migration("img", RestorePolicy.BULK).as_pytree())
