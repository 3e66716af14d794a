"""The seeded weights in the port's layout for a pattern, on the CPU at a
tiny size: the two families' trees are bitwise those of commit 38e97af,
which stacked every layer into one pattern unit, and the reference's logits
are that commit's arithmetic on them; the restore check reads every layer of
a model whose layers differ (``tiny_hybrid.py``), stacked or not."""
import copy
import hashlib
from types import SimpleNamespace

import pytest
import torch

from bench_port import harness, tiny_hybrid
from bench_port.conftest import TINY
from bench_port.reference import common, dense_gqa, mamba1, weights

DEV = torch.device("cpu")
SEED = 2**31 + 5
FAMILIES = {"tiny-mamba": mamba1, "tiny-dense": dense_gqa}

#: sha256 of the tree at SEED as commit 38e97af's code made it
GOLDEN = {
    "tiny-mamba": "68c577f8db6def6851caa6cc8baaaafd3aaaef287b8e1242666f330357e5e118",
    "tiny-dense": "443c59a03bbe3a70718d18c0bf57b2f77eb36fb394bcfb8ae2fb3eb1975375aa",
}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def digest(tree) -> str:
    """sha256 over every leaf's path, shape, dtype and bytes, in key order."""
    h = hashlib.sha256()
    for path, v in _leaves(tree):
        h.update(repr((path, tuple(v.shape), str(v.dtype))).encode())
        h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _parents_logits(fam, c, tree, prompts, heads, product):
    """The class logits as commit 38e97af's ``common.class_logits`` worked
    them out, with every weight read from ``tree`` in that commit's layout
    (layer ``i`` the row ``i`` of ``unit[0]``) instead of drawn again."""
    layers = dict(_leaves(tree["unit"][0]))
    with torch.no_grad():
        xs = [tree["embed"]["tok"].float()[p.long()] for p in prompts]
        for i in range(c["num_hidden_layers"]):
            w = {path: v[i].float() for path, v in layers.items()}
            xs = [fam.block(w, x, c, product, i) for x in xs]
        norm = tree["final_norm"]["scale"].float()
        head = tree["embed"]["head"].float()
        return [(product(common.rmsnorm(x[-1:], norm, fam.norm_eps(c)), head) @ cw + cb)[0]
                for x, (cw, cb) in zip(xs, heads)]


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_the_tiny_trees_and_logits_are_the_parents_bitwise(name):
    fam, c = FAMILIES[name], TINY[name]
    tree = weights.make_params(fam, c, SEED, DEV)
    assert digest(tree) == GOLDEN[name]
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, c["vocab_size"], (L,), generator=gen) for L in (9, 40)]
    heads = [harness.head(c, SEED, k, DEV) for k in range(2)]
    for product in (common.mm, common.mm_fp8):
        ours = common.class_logits(fam, c, SEED, prompts, heads, DEV, product)
        want = _parents_logits(fam, c, tree, prompts, heads, product)
        assert all(torch.equal(a, b) for a, b in zip(ours, want)), product.__name__


def _hybrid(n_layers):
    return dict(tiny_hybrid.CONFIG, num_hidden_layers=n_layers)


def _plant(tree, fam, c, i, path):
    """One byte of layer ``i``'s leaf ``path`` flipped, in place."""
    weights.leaf_at(tree, fam, c, i, path).view(torch.uint8).view(-1)[3] ^= 1


@pytest.mark.parametrize("n_layers", [6, 10])
def test_the_restore_check_reads_every_layer_of_the_pattern(n_layers):
    fam, c = tiny_hybrid, _hybrid(n_layers)
    tree = weights.make_params(fam, c, SEED, DEV)
    p = len(tiny_hybrid.PATTERN)
    last_unit = (n_layers // p - 1) * p + p - 1      # unit[p-1], its last row
    planted = [copy.deepcopy(tree) for _ in range(3)]
    _plant(planted[1], fam, c, last_unit, ("attn", "wk"))
    _plant(planted[2], fam, c, n_layers - 1, ("ssm", "dt_bias"))

    def check(*trees):
        live = {k: SimpleNamespace(params=t) for k, t in enumerate(trees)}
        provider = SimpleNamespace(cell=SimpleNamespace(config=c, family=fam),
                                   seed=SEED, device=DEV, live=live)
        return harness.restore_mismatch(provider)

    per_tree = 3 + sum(len(fam.layer_leaves(c, i)) for i in range(n_layers))
    assert check(planted[0], tree) == {"bytes": 0, "leaves": 2 * per_tree, "instances": 2}
    assert check(tree, planted[1])["bytes"] == 1
    assert check(planted[2])["bytes"] == 1
