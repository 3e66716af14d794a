"""PyTorch/CUDA port of the HotSwap (WarmSwap) system for NVIDIA Hopper.

The package mirrors ``src/repro/`` module for module (``core/``, ``models/``,
``kernels/<name>/``, ``configs/``) so each module's counterpart is easy to find.
The JAX package is the reference; this package never imports it.

Each of the JAX package's four Pallas TPU kernels is hand-written CUDA C++ here
(``csrc/``), built with ``nvcc`` for ``sm_90a`` at first use and bound with
``ctypes``. Every entry point runs on ``cuda`` unless the caller passes
``device="cpu"``; on the CPU each kernel wrapper runs its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
