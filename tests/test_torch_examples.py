"""The port's examples (``examples/*_torch.py``) against the reference's on the
CPU: quickstart, train_small and serve_e2e, each run through its ``main`` beside
the reference's example; and for all five, the refusal to run without a card
unless given ``--device cpu`` and the absence of any JAX import.
(fleet_sim and multi_tenant_fleet: tests/test_torch_examples_fleet.py.)"""
import ast
import contextlib
import io
import re
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import coldstart as jcoldstart
from repro.core import workloads as jwl
from repro.models.transformer import init_params as jax_init_params
from repro_torch.core import workloads as wl
from tests._torch_parity import EXAMPLES, load_example, port_params, run_example

PORTED = ["quickstart", "serve_e2e", "train_small", "fleet_sim", "multi_tenant_fleet"]
THIRD_PARTY = {"torch", "numpy", "repro_torch"}   # all a port example may import
LOSS_RTOL = 1e-4      # every step's loss, relative, across the injected rollback


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's CPU ops on one thread: tier-1 runs six workers on a few
    cores, where each worker's full set of OpenMP threads fights the others'."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _temp_in_tmp_path(tmp_path, monkeypatch):
    """The examples' temp dirs go under the test's own directory."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))


def _line(lines, prefix: str) -> str:
    hits = [l for l in lines if l.startswith(prefix)]
    assert len(hits) == 1, (prefix, lines)
    return hits[0]


# ---------------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def quickstart_reference(tmp_path_factory):
    """The reference's stdout (``main`` and ``scenario_quickstart``, as its
    ``__main__`` runs them) and the classes each tenant's instances gave
    (every invoke on both start paths, the cold starts' first requests too)."""
    seen = {}
    invoke = jcoldstart.FunctionInstance.invoke

    def recording(self, request):
        out, dt = invoke(self, request)
        seen.setdefault(self.spec.fn_id, []).append(np.asarray(out))
        return out, dt

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcoldstart.FunctionInstance, "invoke", recording)
        mp.setattr(tempfile, "tempdir", str(tmp_path_factory.mktemp("quickstart")))
        mod = load_example("quickstart")
        _, lines = run_example(mod, [])
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.scenario_quickstart()
    return lines + buf.getvalue().splitlines(), seen


def test_quickstart_matches_the_reference(quickstart_reference):
    """Equal pool MB, builds and scenario saving; equal classes on both start
    paths in the port (the example asserts it, and returns both)."""
    ref_lines, _ = quickstart_reference
    out, lines = run_example(load_example("quickstart_torch"), ["--device", "cpu"])
    for prefix in ("pool:", "image initialized", "scenario 'quickstart'"):
        assert _line(lines, prefix) == _line(ref_lines, prefix)
    assert out["pool_bytes"] == 46_137_344 and out["builds"] == 1
    assert sorted(out["tenants"]) == ["tenant-a", "tenant-b"]
    for t in out["tenants"].values():
        assert t["classes"] == t["baseline_classes"]
        assert t["baseline_s"] > 0 and t["warmswap_s"] > 0


def test_quickstart_classes_match_the_reference_with_its_weights(
        quickstart_reference, monkeypatch):
    """With the port's builder giving the reference's model-small parameters,
    carried bit for bit, each tenant's classes equal the reference's."""
    _, seen = quickstart_reference

    def builder(image_id, seed=0, device=None):
        jparams = jwl.model_params_builder(image_id, seed)()
        return lambda: port_params(jparams, device)

    monkeypatch.setattr(wl, "model_params_builder", builder)
    out, _ = run_example(load_example("quickstart_torch"), ["--device", "cpu"])
    for tenant, t in out["tenants"].items():
        ref = seen[tenant]
        assert len(ref) == 4 and all(np.array_equal(r, ref[0]) for r in ref)
        assert t["classes"] == t["baseline_classes"] == ref[0].tolist()


# ---------------------------------------------------------------------------------
# train_small
# ---------------------------------------------------------------------------------

def test_train_small_losses_match_the_reference_across_the_rollback(monkeypatch):
    """``--steps 20`` (a failure injected at step 10, rolled back to the
    anchor at step 0): with the reference's fnbench_tiny parameters carried
    into the port, every step's loss is within 1e-4 relative of the
    reference's, the replayed steps included; one restore in both."""
    ref_mod = load_example("train_small")
    ref_losses = []

    class Recording(ref_mod.TrainSupervisor):
        def run(self, *args, on_metrics=None, **kwargs):
            def record(step, m):
                ref_losses.append((step, float(m["loss"])))
                on_metrics(step, m)
            return super().run(*args, on_metrics=record, **kwargs)

    monkeypatch.setattr(ref_mod, "TrainSupervisor", Recording)
    _, ref_lines = run_example(ref_mod, ["--steps", "20"])

    jparams = jax_init_params(jax.random.PRNGKey(0), jax_get_config("fnbench_tiny"),
                              jnp.float32)
    carried = port_params(jparams)
    port_mod = load_example("train_small_torch")
    monkeypatch.setattr(port_mod, "init_params", lambda gen, cfg, dtype: carried)
    out, lines = run_example(port_mod, ["--steps", "20", "--device", "cpu"])

    steps = [s for s, _ in ref_losses]
    assert steps == list(range(10)) + list(range(20))
    np.testing.assert_allclose(out["losses"], [l for _, l in ref_losses],
                               rtol=LOSS_RTOL, atol=0)
    assert out["restores"] == 1
    assert _line(ref_lines, "[train] loss").endswith("failures recovered: 1")
    assert _line(lines, "[train] fnbench-tiny") == _line(ref_lines, "[train] fnbench-tiny")
    assert out["last_loss"] < out["first_loss"]


# ---------------------------------------------------------------------------------
# serve_e2e
# ---------------------------------------------------------------------------------

def _completed(lines):
    return [int(m.group(1)) for l in lines
            if (m := re.match(r"\[serve\] replica-\d: (\d+) done", l))]


def test_serve_e2e_completes_what_the_reference_completes():
    """``--requests 4``: the same completed counts on each replica, both
    bring-ups by warmswap, and a recovered replica that serves. (Token-level
    parity stays with tests/test_torch_serving.py.)"""
    _, ref_lines = run_example(load_example("serve_e2e"), ["--requests", "4"])
    out, lines = run_example(load_example("serve_e2e_torch"),
                             ["--requests", "4", "--device", "cpu"])
    assert _completed(lines) == _completed(ref_lines) == [2, 2]
    assert [m["completed"] for m in out["served"].values()] == [2, 2]
    assert _line(lines, "[pool]") == _line(ref_lines, "[pool]")
    assert [(r, m) for r, m, _ in out["bringup"]] == [
        ("replica-0", "warmswap"), ("replica-1", "warmswap"),
        ("replica-0", "warmswap"), ("replica-0", "baseline")]
    assert out["recovered_completed"] == 1
    assert _line(lines, "[fault] recovered") == _line(ref_lines, "[fault] recovered")


# ---------------------------------------------------------------------------------
# all five: no card, no JAX
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name", PORTED)
def test_port_example_refuses_to_run_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = load_example(f"{name}_torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])


@pytest.mark.parametrize("name", PORTED)
def test_port_example_imports_no_jax(name):
    """Only the standard library, torch, numpy and repro_torch, at any depth
    of the file."""
    with open(f"{EXAMPLES}/{name}_torch.py") as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "repro"}
    assert roots - set(sys.stdlib_module_names) <= THIRD_PARTY, roots
    assert "repro_torch" in roots
