"""The benchmark of the PyTorch/CUDA port (``repro_torch``) on one H100.

``run.py`` is the entry point. The harness is driven by data: a cell of
``BENCHMARK.json`` names a configuration (``configs/<name>.json`` and the
plain reference module its ``family`` names, ``reference/<family>.py``) and
a traffic mix (``traffic/<name>.json``, read by ``loadgen.py``); each
per-layer metric is a reader of its own, ``metrics/<name>.py``.
"""
