"""The port's cold-start paths: the equivalents of tests/test_coldstart.py
(lines 38, 70, 84, 96), agreement with the JAX package's classes, and the
entry points' refusal to run without a card unless asked for the CPU."""
import tempfile

import numpy as np
import pytest
import torch

from repro.core import workloads as jwl
from repro.core.pages import paginate as jax_paginate
from repro_torch.core import (
    ColdStartConfig,
    ColdStartOrchestrator,
    DependencyManager,
    FunctionRegistry,
    PageTable,
    RestorePolicy,
    TreeDef,
    build_image,
    materialize,
)
from repro_torch.core import workloads as wl
from tests._torch_parity import pages_to_torch


def _jax_pages_builder(image_id):
    """The JAX package's image, restored through its page store."""
    store, table, treedef = jax_paginate(jwl.model_params_builder(image_id)(),
                                         page_size=1 << 16)
    tstore = pages_to_torch(store)
    ttable, tdef = PageTable.from_json(table.to_json()), TreeDef.from_repr(str(treedef))
    return lambda: materialize(tstore.clone(), ttable, tdef)


@pytest.fixture(scope="module")
def stack():
    tmp = tempfile.mkdtemp()
    mgr = DependencyManager(disk_dir=tmp + "/pool", device="cpu")
    reg = FunctionRegistry(store_dir=tmp + "/store")
    mgr.register_image("py-base", "py-base", wl.py_base_builder)
    builder = _jax_pages_builder("model-tiny")
    execs = wl.make_model_executables("model-tiny")
    wl.warm_executables(execs, builder(), "model-tiny")
    mgr.register_image("model-tiny", "model-tiny", builder, executables=execs)
    for fn in ["helloworld", "pyaes", "lr_serving"]:
        w = wl.WORKLOADS[fn]
        bb = builder if w.image_id in wl.IMAGE_CONFIGS else wl.py_base_builder
        reg.register(fn, w.image_id, w.handler_builder, w.handler_fn,
                     base_params_builder=bb, write_baseline_checkpoint=True)
    return mgr, reg, ColdStartOrchestrator(mgr, reg, ColdStartConfig())


def test_warmswap_and_baseline_agree_with_each_other_and_jax(stack):
    _, _, orch = stack
    inst_b, tb = orch.cold_start_baseline("lr_serving")
    inst_w, tw = orch.cold_start_warmswap("lr_serving")
    req = wl.WORKLOADS["lr_serving"].request_builder()
    rb, _ = inst_b.invoke(req)
    rw, _ = inst_w.invoke(req)
    assert np.array_equal(rb, rw)
    assert tb.dependency_init > 0 and tb.communication == 0
    assert tw.dependency_init == 0 and tw.migration > 0
    jw = jwl.WORKLOADS["lr_serving"]
    jparams = jwl.model_params_builder("model-tiny")()
    jexecs = jwl.make_model_executables("model-tiny")
    rj = jw.handler_fn(jparams, jw.handler_builder(), req, jexecs)
    assert np.array_equal(np.asarray(rj), rb)


def test_prebaking_memory_scales_with_functions(stack):
    mgr, _, orch = stack
    orch.prebake("helloworld")
    one = orch.prebaked_bytes()
    orch.prebake("pyaes")
    assert orch.prebaked_bytes() >= 2 * one * 0.9
    pool_before = mgr.pool_bytes()
    orch.cold_start_warmswap("helloworld")
    orch.cold_start_warmswap("pyaes")
    assert mgr.pool_bytes() == pool_before


def test_prebaked_cold_start_works(stack):
    _, _, orch = stack
    orch.prebake("lr_serving")
    inst, t = orch.cold_start_prebaked("lr_serving")
    r, _ = inst.invoke(wl.WORKLOADS["lr_serving"].request_builder())
    assert r is not None and t.migration > 0


@pytest.mark.parametrize("policy", list(RestorePolicy))
def test_all_policies_cold_start(stack, policy):
    _, _, orch = stack
    inst, t = orch.cold_start_warmswap("lr_serving", policy=policy)
    inst_b, _ = orch.cold_start_baseline("lr_serving")
    req = wl.WORKLOADS["lr_serving"].request_builder()
    r, _ = inst.invoke(req)
    assert np.array_equal(r, inst_b.invoke(req)[0])
    assert t.total > 0


ENTRY_POINTS = {
    "DependencyManager": lambda: DependencyManager(),
    "build_image": lambda: build_image("img", "t", lambda: {"w": torch.zeros(4)}),
    "model_params_builder": lambda: wl.model_params_builder("model-tiny"),
    "ColdStartOrchestrator": lambda: ColdStartOrchestrator(DependencyManager(),
                                                           FunctionRegistry()),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_points_default_to_the_card_and_raise_without_one(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
