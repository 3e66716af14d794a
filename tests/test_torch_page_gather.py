"""The port's page_gather against the JAX kernel (interpret mode) and its
plain version; the CUDA kernel itself is checked in
tests/test_torch_kernels_gpu.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import page_gather as jax_page_gather
from repro_torch.kernels import page_gather, page_gather_plain
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

