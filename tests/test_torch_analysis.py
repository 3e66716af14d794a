"""The reference's static checks over the port's simulation and experiments
code (``tools.analysis``, docs/ANALYSIS.md).

``tools/analysis/config.py`` scopes the determinism, float-determinism and
shared-state checkers to the JAX package's trees. Here the same checkers
walk the port's counterparts, ``src/repro_torch/core/`` and
``src/repro_torch/experiments/``, with the scopes (and the two declared
environment knobs) pointed at the port for the test's duration. Every
finding must be fixed or carry an inline ``# repro-lint: allow[rule]``
pragma, as in the reference; no pragma may be stale.
"""
from __future__ import annotations

import glob
import os

import pytest

from tools.analysis import config, determinism, float_determinism, shared_state
from tools.analysis.base import REPO_ROOT, SourceFile

PORT_SCOPE = ("src/repro_torch/core/", "src/repro_torch/experiments/")
CHECKERS = (determinism, float_determinism, shared_state)
FILES = sorted(os.path.relpath(p, REPO_ROOT) for scope in PORT_SCOPE
               for p in glob.glob(os.path.join(REPO_ROOT, scope, "*.py")))


@pytest.fixture
def port_scopes(monkeypatch):
    monkeypatch.setattr(config, "DETERMINISM_SCOPE", PORT_SCOPE)
    monkeypatch.setattr(config, "FLOAT_DETERMINISM_SCOPE", PORT_SCOPE)
    monkeypatch.setattr(config, "SHARED_STATE_SCOPE", PORT_SCOPE)
    monkeypatch.setattr(config, "SANCTIONED_ENVIRON", config.SANCTIONED_ENVIRON | {
        ("src/repro_torch/core/fleet_vec.py", "_scan_enabled"),
        ("src/repro_torch/core/sanitize.py", "sanitize_enabled")})


def test_the_scopes_cover_the_port():
    assert len(FILES) >= 25
    assert "src/repro_torch/core/fleet_vec.py" in FILES
    assert "src/repro_torch/experiments/executor.py" in FILES


@pytest.mark.parametrize("rel", FILES)
def test_port_module_is_clean_under_the_reference_checkers(rel, port_scopes):
    src = SourceFile.parse(os.path.join(REPO_ROOT, rel))
    assert src.rel == rel
    findings = [f for mod in CHECKERS for f in mod.check(src)]
    assert not findings, "\n".join(f"{f.path}:{f.line} {f.rule}: {f.message}"
                                   for f in findings)
    assert src.stale_pragmas() == []


def test_the_checkers_see_a_violation_in_the_port_scope(tmp_path, port_scopes):
    """The patched scopes are live: an unseeded draw and a wall clock in a
    fixture placed under the port's tree are findings."""
    p = tmp_path / "fixture.py"
    p.write_text("import time\nimport numpy as np\n\n"
                 "def f():\n    return np.random.rand(3), time.time()\n")
    src = SourceFile.parse(str(p))
    src.rel = "src/repro_torch/core/_fixture.py"
    assert sorted(f.rule for f in determinism.check(src)) == ["unseeded-rng", "wall-clock"]
