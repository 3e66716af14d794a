import importlib.util
import os
import sys

# tests/test_analysis_*.py and tests/test_ci_checks.py import the repo-root
# `tools` package; `python -m pytest` from the root already has cwd on
# sys.path, this keeps bare `pytest` / other cwds working too.
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# Smoke tests and benches must see the single real device; ONLY the dry-run launcher
# forces 512 host devices (and it does so in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

# Property tests use hypothesis when available; otherwise fall back to the
# deterministic seeded-fuzz shim so those modules still collect and run
# (see tests/_hypothesis_fallback.py).
try:
    import hypothesis  # noqa: F401
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "hypothesis",
        os.path.join(os.path.dirname(__file__), "_hypothesis_fallback.py"))
    _shim = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_shim)
    sys.modules["hypothesis"] = _shim
    sys.modules["hypothesis.strategies"] = _shim.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skips itself inside the test when "
        "there is none")
