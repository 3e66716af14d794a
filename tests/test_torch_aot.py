"""Serialized executables (``repro_torch.core.aot``): the two cases of
tests/test_aot.py ported, and a reduced prefill whose graph calls the
kernels as ``repro_torch::`` ops, round-tripped through bytes without a
re-trace of the Python function."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.models.transformer import init_params as jax_init
from repro_torch.configs import get_reduced
from repro_torch.core.aot import (
    deserialize_executables,
    executables_nbytes,
    serialize_executables,
)
from repro_torch.core.tree import leaves
from repro_torch.models.transformer import forward
from tests._torch_parity import tree_to_torch


def test_executable_roundtrip_no_recompile():
    calls = []

    def step(w, x):
        calls.append(1)
        return torch.tanh(x @ w).sum(dim=-1)

    gen = torch.Generator().manual_seed(0)
    w = torch.randn((16, 8), generator=gen)
    x = torch.randn((4, 16), generator=gen)
    expected = step(w, x)
    blobs = serialize_executables({"step": step}, {"step": (w, x)})
    assert executables_nbytes(blobs) > 0
    traced = len(calls)
    execs = deserialize_executables(blobs)
    out = execs["step"](w, x)
    assert len(calls) == traced                 # the stored graph ran, not step
    np.testing.assert_allclose(out.numpy(), expected.numpy(), rtol=1e-6)


def test_serialized_blob_is_portable_bytes():
    def f(x):
        return x * 2 + 1

    x = torch.arange(8.0)
    blobs = serialize_executables({"f": f}, {"f": (x,)})
    assert isinstance(blobs["f"], bytes)
    execs = deserialize_executables({"f": bytes(blobs["f"])})
    np.testing.assert_allclose(execs["f"](x).numpy(), f(x).numpy())


@pytest.mark.parametrize("arch,op", [("qwen1_5_0_5b", "flash_attention"),
                                     ("recurrentgemma_2b", "diag_recurrence")])
def test_prefill_roundtrip_through_the_kernel_ops(arch, op):
    """A reduced model's prefill (parameters as a dict of tensors) exported,
    saved to bytes and loaded: the graph calls the kernel op, the loaded
    program gives the eager logits bit for bit, on other tokens too, and
    never calls the Python function."""
    cfg = get_reduced(arch)
    params = tree_to_torch(jax_init(jax.random.PRNGKey(0), jax_reduced(arch), jnp.float32))
    calls = []

    def prefill_logits(p, tokens):
        calls.append(1)
        return forward(p, tokens, cfg, logits_slice=1)[:, -1]

    rng = np.random.default_rng(4)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))
    blobs = serialize_executables({"prefill": prefill_logits},
                                  {"prefill": (params, tokens)})
    traced = len(calls)
    param_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    assert executables_nbytes(blobs) < param_bytes     # the graph, not the weights
    run = deserialize_executables(blobs)["prefill"]
    assert f"repro_torch.{op}" in str(run.graph)
    for toks in (tokens, torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 64)))):
        out = run(params, toks)
        ref = forward(params, toks, cfg, logits_slice=1)[:, -1]
        assert out.shape == ref.shape and torch.equal(out, ref)
    assert len(calls) == traced
