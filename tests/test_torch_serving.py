"""The port's serving layer (engine, scheduler, replica recovery) against the
JAX package on the CPU, on the same weights carried across as numpy or pages.

fp32 greedy tokens must be equal token for token. Kept logits are held to
1e-4 (fp32). The bf16 image is held to the bf16 forward's bound from
tests/test_torch_models.py (0.125 on logits; the port keeps attention
probabilities in fp32 where JAX rounds them to bf16), with tokens equal
wherever the reference's top-2 gap is wider than twice that bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import workloads as jwl
from repro.core.disruption import DisruptionEvent, DisruptionSchedule
from repro.core.pages import paginate as jax_paginate
from repro.models.transformer import (
    decode_step as jax_decode_step,
    forward as jax_forward,
    init_params as jax_init,
)
from repro.runtime import ReplicaSet as JaxReplicaSet
from repro.runtime.fault_tolerance import replay_disruption as jax_replay
from repro.serving import FleetScheduler as JaxScheduler
from repro.serving import SchedulerConfig as JaxSchedulerConfig
from repro.serving import ServeConfig as JaxServeConfig
from repro.serving import ServingEngine as JaxEngine
from repro.serving import scheduler as jsched
from repro_torch.configs import get_reduced
from repro_torch.core import DependencyManager, RestorePolicy
from repro_torch.core.pages import PageTable, materialize, params_from_numpy
from repro_torch.core.tree import TreeDef
from repro_torch.runtime import ReplicaSet, replay_disruption
from repro_torch.serving import (
    FleetScheduler,
    SchedulerConfig,
    ServeConfig,
    ServingEngine,
)
from repro_torch.serving import scheduler as tsched
from tests._torch_parity import pages_to_torch, to_f32

LOGIT_TOL = 1e-4
BF16_BOUND = 0.125
JCFG = jax_reduced("qwen3_1_7b")
CFG = get_reduced("qwen3_1_7b")
PARAMS = jax_init(jax.random.PRNGKey(0), JCFG, jnp.float32)


def _port_params(params):
    flat = {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    return params_from_numpy(flat)


def _greedy_reference(prompt, n):
    """tests/test_serving_ft.py's JAX reference: prefill + decode_step."""
    toks = jnp.asarray(prompt[None])
    logits, _, st = jax_forward(PARAMS, toks, JCFG, make_state=True, state_len=64,
                                logits_slice=1)
    seq = [int(jnp.argmax(logits[0, -1, : JCFG.vocab_size]))]
    rows = [np.asarray(logits[0, -1, : JCFG.vocab_size])]
    for _ in range(n - 1):
        lg, st = jax_decode_step(PARAMS, st, jnp.asarray([[seq[-1]]], jnp.int32), JCFG)
        seq.append(int(jnp.argmax(lg[0, : JCFG.vocab_size])))
        rows.append(np.asarray(lg[0, : JCFG.vocab_size]))
    return seq, rows


def test_continuous_batching_tokens_equal_the_jax_engine():
    """tests/test_serving_ft.py:35-45 through both engines."""
    scfg = dict(max_slots=3, max_seq_len=64, max_new_tokens=5)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, CFG.vocab_size, n) for n in (4, 9, 6, 11, 5)]
    jeng = JaxEngine(JCFG, PARAMS, JaxServeConfig(**scfg))
    teng = ServingEngine(CFG, _port_params(PARAMS), ServeConfig(**scfg, keep_logits=True))
    jids = [jeng.submit(p) for p in prompts]
    tids = [teng.submit(p) for p in prompts]
    jeng.run_until_done()
    teng.run_until_done()
    assert teng.state["unit"][0].k.dtype == torch.float32
    assert len(teng.completed) == len(prompts) and teng.steps == jeng.steps
    for jid, tid, prompt in zip(jids, tids, prompts):
        req = teng.completed[tid]
        assert req.tokens == jeng.completed[jid].tokens
        seq, rows = _greedy_reference(prompt, 5)
        assert req.tokens == seq
        assert len(req.logits) == 5
        np.testing.assert_allclose(np.stack(req.logits), np.stack(rows),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    m = teng.metrics()
    assert m["completed"] == 5 and m["engine_steps"] == teng.steps


def test_slot_reuse_is_clean():
    """A slot that served request A must not leak cache state into B."""
    eng = ServingEngine(CFG, _port_params(PARAMS),
                        ServeConfig(max_slots=1, max_seq_len=64, max_new_tokens=4))
    rng = np.random.default_rng(1)
    p1, p2 = rng.integers(0, CFG.vocab_size, 8), rng.integers(0, CFG.vocab_size, 13)
    r1, r2 = eng.submit(p1), eng.submit(p2)
    eng.run_until_done()
    assert eng.completed[r1].tokens == _greedy_reference(p1, 4)[0]
    assert eng.completed[r2].tokens == _greedy_reference(p2, 4)[0]


# ---------------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------------

def _straggler_run(sched_cls, cfg_cls):
    sched = sched_cls(cfg_cls(straggler_factor=2.0, min_observations=2,
                              quarantine_after_flags=1))
    for n in ("a", "b"):
        sched.register_replica(n)
    lat = {"a": [0.01] * 4 + [0.5, 0.5, 0.01], "b": [0.012] * 12}
    idx = {"a": 0, "b": 0}

    def execute(name, item):
        v = lat[name][min(idx[name], len(lat[name]) - 1)]
        idx[name] += 1
        return v

    counts = sched.run([object()] * 10, execute)
    return sched, counts


def test_scheduler_straggler_redispatch_matches_reference():
    """tests/test_serving_ft.py:61-80 through both schedulers."""
    jsch, jcounts = _straggler_run(JaxScheduler, JaxSchedulerConfig)
    tsch, tcounts = _straggler_run(FleetScheduler, SchedulerConfig)
    assert any(e[0] == "redispatch" for e in tsch.dispatch_log)
    assert tsch.health["a"].quarantined and tsch.pick() == "b"
    assert tcounts == jcounts and tsch.dispatch_log == jsch.dispatch_log
    for n in ("a", "b"):
        assert dataclasses.asdict(tsch.health[n]) == dataclasses.asdict(jsch.health[n])


@pytest.mark.parametrize("seed", range(6))
def test_placement_matches_reference(seed):
    rng = np.random.default_rng(seed)
    workers = [f"w{i}" for i in range(int(rng.integers(1, 6)))]
    sig = {name: dict(zip(workers, vals)) for name, vals in (
        ("load", rng.integers(0, 4, len(workers))),
        ("warm", rng.random(len(workers)) < 0.3),
        ("holds", rng.random(len(workers)) < 0.5),
        ("queue", rng.integers(0, 3, len(workers))),
        ("cost", rng.choice([0.0, 0.5, 2.0], len(workers))))}
    for use in ("load", "warm", "holds", "cost"):
        def ctx(mod):
            return mod.PlacementContext(
                load=lambda w: int(sig["load"][w]),
                queue_depth=lambda w: int(sig["queue"][w]),
                has_warm=(lambda w: bool(sig["warm"][w])) if use == "warm" else None,
                holds_image=(lambda w: bool(sig["holds"][w])) if use == "holds" else None,
                start_cost=(lambda w: float(sig["cost"][w])) if use == "cost" else None,
                arrival_seq=seed)
        assert tsched.place_invocation(workers, ctx(tsched)) == \
            jsched.place_invocation(workers, ctx(jsched))
        for name in _reference_placements():
            assert tsched.PLACEMENTS.build(name)(workers, ctx(tsched)) == \
                jsched.PLACEMENTS.build(name)(workers, ctx(jsched))
    assert tsched.PLACEMENTS.names() == _reference_placements()


def _reference_placements():
    """The strategies the reference package defines: not those another test
    file registers on its registry at run time (tests/test_scenario.py adds
    one), which share this process when both files land on one worker."""
    return [n for n in jsched.PLACEMENTS.names()
            if jsched.PLACEMENTS.resolve(n).__module__.startswith("repro.")]


# ---------------------------------------------------------------------------------
# replica recovery through the port's pool
# ---------------------------------------------------------------------------------

def test_replica_failure_pool_recovery_on_cpu():
    """tests/test_serving_ft.py:110-136 on the port's pool: the replacement
    replica, re-warmed from the pool, serves the reference's tokens."""
    mgr = DependencyManager(device="cpu")
    mgr.register_image("base", CFG.name, lambda: _port_params(PARAMS))
    scfg = ServeConfig(max_slots=1, max_seq_len=64, max_new_tokens=4)

    def make_engine(manager, image_id, cfg, method):
        if method == "warmswap":
            return ServingEngine.from_pool(manager, image_id, cfg, scfg,
                                           policy=RestorePolicy.BULK)
        return ServingEngine(cfg, _port_params(PARAMS), scfg)    # cold load

    rs = ReplicaSet(mgr, "base", CFG, make_engine, n_replicas=2)
    assert set(rs.replicas) == {"replica-0", "replica-1"}
    prompt = np.random.default_rng(2).integers(0, CFG.vocab_size, 6)
    ref = _greedy_reference(prompt, 4)[0]
    for method in ("warmswap", "baseline"):
        rs.kill("replica-0")
        assert "replica-0" not in rs.replicas
        assert rs.recover("replica-0", method=method) > 0
        eng = rs.replicas["replica-0"]
        rid = eng.submit(prompt)
        eng.run_until_done()
        assert eng.completed[rid].tokens == ref
    assert [e.method for e in rs.events] == ["warmswap"] * 3 + ["baseline"]
    assert mgr.stats.builds == 1


def test_replay_disruption_matches_reference():
    """The simulator's schedule drives both ReplicaSets the same way."""
    sch = DisruptionSchedule(
        [DisruptionEvent(1.0, "worker_fail", 0),
         DisruptionEvent(2.0, "cache_flush"),
         DisruptionEvent(3.0, "worker_recover", 0),
         DisruptionEvent(4.0, "worker_fail", 1)], n_workers=2)
    built = {"jax": [], "port": []}
    sets = {}
    for name, cls in (("jax", JaxReplicaSet), ("port", ReplicaSet)):
        sets[name] = cls(None, "img", None,
                         lambda m, i, c, method, name=name: built[name].append(method)
                         or object(), n_replicas=2)
    jev = [(e.replica, e.method) for e in jax_replay(sets["jax"], sch)]
    tev = [(e.replica, e.method) for e in replay_disruption(sets["port"], sch)]
    assert tev == jev == [("replica-0", "warmswap")]
    assert built["port"] == built["jax"] == ["warmswap"] * 3
    assert set(sets["port"].replicas) == set(sets["jax"].replicas) == {"replica-0"}


# ---------------------------------------------------------------------------------
# bf16 images
# ---------------------------------------------------------------------------------

def test_reference_engine_cannot_serve_a_bf16_image():
    """The reference always builds an fp32 decode state
    (repro/serving/engine.py:73); with model-tiny's bf16 parameters the first
    layer promotes the residual stream to fp32 and lax.scan in decode_step
    (repro/models/transformer.py:373) refuses the changed carry."""
    cfg = jwl.IMAGE_CONFIGS["model-tiny"]
    eng = JaxEngine(cfg, jwl.model_params_builder("model-tiny")(),
                    JaxServeConfig(max_slots=2, max_seq_len=32, max_new_tokens=3))
    eng.submit(np.arange(5))
    with pytest.raises(TypeError, match="carry"):
        eng.run_until_done()


def test_bf16_image_engine_matches_jax_decode_on_a_bf16_state():
    """The port serves model-tiny from the JAX-built pages with a bf16 state;
    JAX's prefill + decode_step on the same pages, which keep a bf16 state,
    are fed the port's tokens and give the same logits within the bound."""
    cfg = jwl.IMAGE_CONFIGS["model-tiny"]
    params = jwl.model_params_builder("model-tiny")()
    store, table, treedef = jax_paginate(params, page_size=1 << 16)
    tparams = materialize(pages_to_torch(store), PageTable.from_json(table.to_json()),
                          TreeDef.from_repr(str(treedef)))
    eng = ServingEngine(cfg, tparams, ServeConfig(max_slots=2, max_seq_len=48,
                                                  max_new_tokens=6, keep_logits=True))
    assert eng.state["unit"][0].k.dtype == torch.bfloat16
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in (7, 12, 5)]
    rids = [eng.submit(p) for p in prompts]
    eng.run_until_done()
    clear_seen = 0
    for rid, prompt in zip(rids, prompts):
        req = eng.completed[rid]
        logits, _, st = jax_forward(params, jnp.asarray(prompt[None]), cfg,
                                    make_state=True, state_len=48, logits_slice=1)
        assert st["unit"][0].k.dtype == jnp.bfloat16
        rows = [to_f32(logits[0, -1, : cfg.vocab_size])]
        for tok in req.tokens[:-1]:
            lg, st = jax_decode_step(params, st, jnp.asarray([[tok]], jnp.int32), cfg)
            rows.append(to_f32(lg[0, : cfg.vocab_size]))
        ref, out = np.stack(rows), np.stack(req.logits)
        assert np.abs(out - ref).max() <= BF16_BOUND
        top2 = np.sort(ref, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > 2 * BF16_BOUND
        assert (np.asarray(req.tokens) == ref.argmax(-1))[clear].all()
        clear_seen += int(clear.sum())
    assert clear_seen > 0
