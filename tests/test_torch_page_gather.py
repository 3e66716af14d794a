"""The port's page_gather against the JAX kernel (interpret mode) and its
plain version, and the persistent kernel's work-item plan; the CUDA kernel
itself is checked in tests/test_torch_kernels_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import page_gather as jax_page_gather
from repro_torch.kernels import page_gather, page_gather_plain
from repro_torch.kernels.page_gather.ops import (
    BLOCKS_PER_SM,
    BULK_ALIGN,
    block_items,
    bulk_bytes,
    item_span,
    plan_gather,
)
from tests._torch_parity import to_torch

DTYPES = {"float32": (jnp.float32, torch.float32), "int32": (jnp.int32, torch.int32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = [(64, 256, 20), (16, 128, 16), (8, 512, 1)]   # as tests/test_kernels.py


def _inputs(P, E, K, dtype, seed=0):
    rng = np.random.default_rng(seed)
    pool = jnp.asarray(rng.standard_normal((P, E)) * 10, jnp.float32).astype(
        DTYPES[dtype][0])
    ids = rng.integers(0, P, (K,), dtype=np.int32)
    return pool, ids


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("P,E,K", SHAPES)
def test_plain_equals_jax_kernel(P, E, K, dtype):
    pool, ids = _inputs(P, E, K, dtype)
    ref = np.asarray(jax_page_gather(pool, jnp.asarray(ids), interpret=True))
    tpool = to_torch(pool)
    out = page_gather_plain(tpool, torch.from_numpy(ids))
    assert out.dtype == DTYPES[dtype][1]
    assert torch.equal(out, to_torch(ref))
    assert torch.equal(page_gather(tpool, torch.from_numpy(ids)), out)  # CPU -> plain


def test_rejects_out_of_range_ids():
    pool = torch.zeros((4, 8), dtype=torch.uint8)
    for bad in ([4], [-1], [0, 7]):
        with pytest.raises(IndexError):
            page_gather(pool, torch.tensor(bad, dtype=torch.int32))
    with pytest.raises(TypeError):
        page_gather(pool, torch.tensor([0.0]))


def test_cpu_tensors_never_launch():
    before = page_gather.launches
    page_gather(torch.arange(12, dtype=torch.uint8).reshape(3, 4),
                torch.tensor([2, 0], dtype=torch.int32))
    assert page_gather.launches == before


# ---- the persistent kernel's plan ------------------------------------------------

SMEM_PER_SM = 232_448         # bytes of shared memory on an H100 SM (227 KB)
PLAN_CASES = [(228, 4 * 2**20, 132),         # the qwen1.5 store, all pages
              (3, 4 * 2**20 + 16, 132),      # a last bulk item of 16 B
              (40, 48, 132),                 # rows shorter than one bulk item
              (5, 4003, 132),                # chip_smoke's odd rows: a byte tail
              (7, 2**15 + 7, 4),             # a few SMs, many items per block
              (1, 1, 132)]


@pytest.mark.parametrize("K,row_bytes,n_sms", PLAN_CASES)
def test_plan_covers_every_byte_once(K, row_bytes, n_sms):
    p = plan_gather(K, row_bytes, n_sms)
    seen = np.zeros(p.n_items, np.int64)
    spans = {}
    for b in range(p.grid):
        for it in block_items(p, b):
            seen[it] += 1
            row, start, length = item_span(p, row_bytes, it)
            spans.setdefault(row, []).append((start, length))
    assert (seen == 1).all()                      # each item on exactly one block
    assert sorted(spans) == list(range(K))
    for row, parts in spans.items():              # each byte of each row exactly once
        end = 0
        for start, length in sorted(parts):
            assert start == end and length > 0
            end = start + length
        assert end == row_bytes


@pytest.mark.parametrize("K,row_bytes,n_sms", PLAN_CASES)
def test_plan_respects_bulk_copy_limits(K, row_bytes, n_sms):
    p = plan_gather(K, row_bytes, n_sms)
    assert p.chunk_bytes % BULK_ALIGN == 0 and 0 < p.chunk_bytes < 2**20  # mbarrier tx
    assert 2 <= p.stages <= 8
    assert BLOCKS_PER_SM * p.stages * p.chunk_bytes <= SMEM_PER_SM - 1024
    assert 1 <= p.grid <= min(p.n_items, BLOCKS_PER_SM * n_sms)
    assert p.n_items == K * p.n_chunks


@pytest.mark.parametrize("K,row_bytes,n_sms", PLAN_CASES)
def test_bulk_spans_are_aligned_with_a_byte_tail(K, row_bytes, n_sms):
    """With 16-byte aligned bases, every item's bulk part starts 16-byte
    aligned and is a multiple of 16; what is left (< 16 B) is the tail, and
    only a row's last item has one. A misaligned source or destination sends
    the whole item through the byte path."""
    p = plan_gather(K, row_bytes, n_sms)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, K, K)
    for it in range(p.n_items):
        row, start, length = item_span(p, row_bytes, it)
        src = int(ids[row]) * row_bytes + start
        dst = row * row_bytes + start
        bulk = bulk_bytes(src, dst, length)
        if (src | dst) % BULK_ALIGN == 0:
            assert bulk % BULK_ALIGN == 0 and 0 <= length - bulk < BULK_ALIGN
            assert bulk == length or start + length == row_bytes
        else:
            assert bulk == 0
        assert bulk_bytes(src + 1, dst, length) == 0
        assert bulk_bytes(src, dst + 8, length) == 0

