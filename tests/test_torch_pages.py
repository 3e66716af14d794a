"""The port's page layer and image format against the JAX package's: key
paths, flatten order, page tables, stores and the disk tier interchange."""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import pages as jpages
from repro.core.image import LiveDependencyImage as JaxImage
from repro.core.image import build_image as jax_build_image
from repro.core import workloads as jwl
from repro_torch.core import pages as tpages
from repro_torch.core.image import LiveDependencyImage as TorchImage
from repro_torch.core.image import build_image as torch_build_image
from repro_torch.core.tree import TreeDef, flatten_with_keys, nest
from tests._torch_parity import pages_to_torch, to_torch, tree_to_torch

PAGE = 1 << 14


def _jax_tree(seed: int):
    rng = np.random.default_rng(seed)
    bf = jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)
    return {
        "z": {"w": jnp.asarray(rng.standard_normal((7, 3)), jnp.float32)},
        "a": (bf, {"k": jnp.asarray(rng.integers(-9, 9, (4,)), jnp.int32)}),
        "rem": (),
        "m": [jnp.asarray(rng.integers(0, 255, (33,)), jnp.uint8), None],
        "s": jnp.asarray(rng.standard_normal(()), jnp.float32),
    }


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flatten_keys_and_treedef_match_jax(seed):
    tree = _jax_tree(seed)
    jax_keys = [jax.tree_util.keystr(p)
                for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    ttree = tree_to_torch(tree)
    assert [k for k, _ in flatten_with_keys(ttree)] == jax_keys
    jdef = str(jax.tree_util.tree_structure(tree))
    assert str(TreeDef.of(ttree)) == jdef
    assert str(TreeDef.from_repr(jdef)) == jdef


@pytest.mark.parametrize("page_size", [128, 4096, 1 << 20])
def test_paginate_matches_jax_store_and_table(page_size):
    tree = _jax_tree(3)
    jstore, jtable, jdef = jpages.paginate(tree, page_size=page_size)
    ttree = tree_to_torch(tree)
    tstore, ttable, tdef = tpages.paginate(ttree, page_size=page_size)
    assert ttable.to_json() == jtable.to_json()
    assert np.array_equal(tstore.numpy(), jstore)
    out = tpages.materialize(tstore, ttable, tdef)
    for (ka, a), (kb, b) in zip(flatten_with_keys(ttree), flatten_with_keys(out)):
        assert ka == kb and a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(tpages.byte_view(a), tpages.byte_view(b))


@pytest.fixture(scope="module")
def jax_tiny_image():
    return jax_build_image("model-tiny", "model-tiny",
                           jwl.model_params_builder("model-tiny"), page_size=PAGE)


def test_jax_image_restores_and_repaginates_identically(jax_tiny_image):
    """A JAX-built image restores in the port and re-paginates to a
    byte-identical store with an equal page table and content hash."""
    jimg = jax_tiny_image
    table = tpages.PageTable.from_json(jimg.metadata.page_table.to_json())
    treedef = TreeDef.from_repr(jimg.metadata.treedef_repr)
    params = tpages.materialize(pages_to_torch(jimg.store), table, treedef)
    timg = torch_build_image("model-tiny", "model-tiny", lambda: params,
                             page_size=PAGE, device="cpu")
    assert timg.metadata.page_table.to_json() == jimg.metadata.page_table.to_json()
    assert np.array_equal(timg.store.numpy(), jimg.store)
    assert timg.metadata.treedef_repr == jimg.metadata.treedef_repr
    assert timg.metadata.content_hash == jimg.metadata.content_hash
    assert timg.metadata.nbytes() == jimg.metadata.nbytes()


def test_params_from_numpy_builds_the_jax_tree(jax_tiny_image):
    jparams = jax_tiny_image.params()
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jparams):
        arr = np.asarray(leaf)
        flat[jax.tree_util.keystr(path)] = (arr.view(np.uint16)
                                            if arr.dtype.name == "bfloat16" else arr)
    params = tpages.params_from_numpy(flat, device=torch.device("cpu"))
    assert params["embed"]["tok"].dtype == torch.bfloat16
    store, table, _ = tpages.paginate(params, page_size=PAGE)
    assert table.to_json() == jax_tiny_image.metadata.page_table.to_json()
    assert np.array_equal(store.numpy(), jax_tiny_image.store)


def test_nest_inverts_flatten():
    tree = tree_to_torch({"a": ({"x": np.ones(2)}, {"x": np.zeros(3)}), "b": np.ones(1)})
    back = nest(dict(flatten_with_keys(tree)))
    assert str(TreeDef.of(back)) == str(TreeDef.of(tree))


def test_port_reads_jax_disk_image(tmp_path, jax_tiny_image):
    jax_tiny_image.dump_to_disk(str(tmp_path))
    timg = TorchImage.from_disk(str(tmp_path), "model-tiny")
    assert np.array_equal(timg.store.numpy(), jax_tiny_image.store)
    assert (timg.metadata.page_table.to_json()
            == jax_tiny_image.metadata.page_table.to_json())
    assert str(timg.treedef) == str(jax_tiny_image.treedef)
    jleaves = jax.tree_util.tree_leaves(jax_tiny_image.params())
    tleaves = [leaf for _, leaf in flatten_with_keys(timg.params())]
    assert len(jleaves) == len(tleaves)
    for a, b in zip(jleaves, tleaves):
        assert torch.equal(tpages.byte_view(to_torch(a)), tpages.byte_view(b))


def test_jax_reads_port_disk_image(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"w": torch.randn((40, 30), generator=gen).to(torch.bfloat16),
              "b": (torch.arange(7, dtype=torch.int32),)}
    timg = torch_build_image("img", "test", lambda: params, page_size=256,
                             device="cpu")
    timg.dump_to_disk(str(tmp_path))
    with open(os.path.join(tmp_path, "img.json")) as f:
        assert json.load(f)["treedef_repr"] == "PyTreeDef({'b': (*,), 'w': *})"
    jdef = jax.tree_util.tree_structure({"b": (0,), "w": 0})
    jimg = JaxImage.from_disk(str(tmp_path), "img", jdef)
    assert np.array_equal(jimg.store, timg.store.numpy())
    jp = jimg.params()
    assert np.array_equal(np.asarray(jp["w"]).view(np.uint16),
                          params["w"].view(torch.int16).numpy().view(np.uint16))
    assert np.array_equal(np.asarray(jp["b"][0]), params["b"][0].numpy())
