"""The plain reference and the seeded weights against the port's plain CPU
path at a tiny size: the same parameter layout as the port's own init, the
port in fp32 equal to the reference to rounding, in bf16 close to it, and
the fp8 control far from it; for both families, and for a test-only hybrid
whose layers differ (``tiny_hybrid.py``)."""
import dataclasses

import pytest
import torch

from bench_port import harness, tiny_hybrid
from bench_port.conftest import TINY
from bench_port.reference import common, dense_gqa, mamba1, weights

FAMILIES = {"tiny-mamba": mamba1, "tiny-dense": dense_gqa}
#: every family a layout test runs, with its configuration
LAYOUTS = {name: (fam, TINY[name]) for name, fam in FAMILIES.items()}
LAYOUTS["tiny-hybrid"] = (tiny_hybrid, tiny_hybrid.CONFIG)
#: two whole pattern units and two remainder layers
LAYOUTS["tiny-hybrid-10"] = (tiny_hybrid, dict(tiny_hybrid.CONFIG, num_hidden_layers=10))
DEV = torch.device("cpu")


def _arch(fam, c):
    from repro_torch.models.config import ArchConfig
    f = fam.port_arch(c)
    f["attn_pattern"] = tuple(f["attn_pattern"])
    return ArchConfig(**f)


def _cast(tree, dtype):
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_cast(v, dtype) for v in tree)
    return tree.to(dtype)


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layout_is_the_ports(name):
    from repro_torch.core.tree import flatten_with_keys
    from repro_torch.models.transformer import init_params
    fam, c = LAYOUTS[name]
    ours = dict(flatten_with_keys(weights.make_params(fam, c, 3, DEV)))
    port = dict(flatten_with_keys(init_params(torch.Generator().manual_seed(0),
                                              _arch(fam, c), torch.bfloat16)))
    assert ours.keys() == port.keys()
    for k, v in port.items():
        assert (ours[k].shape, ours[k].dtype) == (v.shape, v.dtype), k


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layers_made_again_equal_the_whole(name):
    fam, c = LAYOUTS[name]
    params = weights.make_params(fam, c, 2**31 + 5, DEV)
    kinds = weights.layer_kinds(fam, c)
    for i in range(c["num_hidden_layers"]):
        made = weights.layer(fam, c, 2**31 + 5, i, DEV)
        assert {"ssm": "ssm", "local": "attn"}[kinds[i]] in {p[0] for p in made}, i
        for path, v in made.items():
            assert torch.equal(weights.leaf_at(params, fam, c, i, path), v), (i, path)
    assert torch.equal(params["embed"]["head"], weights.top(c, 2**31 + 5, "head", DEV))
    other = weights.layer(fam, c, 2**31 + 6, 0, DEV)
    assert not torch.equal(other[("ln1", "scale")],
                           weights.leaf_at(params, fam, c, 0, ("ln1", "scale")))


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_reference_against_the_ports_plain_path(name):
    from repro_torch.models.transformer import forward
    fam, c = LAYOUTS[name]
    arch, seed = _arch(fam, c), 11
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, c["vocab_size"], (L,), generator=gen) for L in (9, 40)]
    heads = [harness.head(c, seed, k, DEV) for k in range(2)]
    ref = common.class_logits(fam, c, seed, prompts, heads, DEV)
    ctl = common.class_logits(fam, c, seed, prompts, heads, DEV, common.mm_fp8)
    bf16 = weights.make_params(fam, c, seed, DEV)
    gaps = {}
    for label, params in (("fp32", _cast(bf16, torch.float32)), ("bf16", bf16)):
        with torch.no_grad():
            out = [(forward(params, p[None], arch, logits_slice=1)[:, -1].float() @ w + b)[0]
                   for p, (w, b) in zip(prompts, heads)]
        gaps[label] = common.rms_gap(out, ref)
    assert gaps["fp32"] < 1e-5
    assert gaps["bf16"] < c["limits"]["logit_rms_gap"] < common.rms_gap(ctl, ref)


def test_window_binds_in_the_dense_reference():
    c = dict(TINY["tiny-dense"], sliding_window=4)
    q = torch.randn(10, 4, 16)
    k, v = torch.randn(10, 2, 16), torch.randn(10, 2, 16)
    near = dense_gqa.attention(q, k, v, 4)
    far = dense_gqa.attention(q, k, v, 64)
    assert torch.allclose(near[:4], far[:4]) and not torch.allclose(near[6:], far[6:])
    assert dataclasses.is_dataclass(harness.Invocation) and c["sliding_window"] == 4


def test_diag_scan_is_the_recurrence():
    a, b = torch.rand(37, 5), torch.randn(37, 5)
    h, want = torch.zeros(5), []
    for t in range(37):
        h = a[t] * h + b[t]
        want.append(h)
    assert torch.allclose(mamba1.diag_scan(a, b), torch.stack(want), atol=1e-6)
