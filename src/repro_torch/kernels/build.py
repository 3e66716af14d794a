"""Build the CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its own
into ``build/lib<name>-<hash>.so`` at the root of the checkout, for
``sm_90a``. The build runs at first use, from the sources in the repository
only; :func:`build_all` starts one ``nvcc`` per source at once. The file name
carries a hash of the source and flags, so an edited source is rebuilt and a
stale library is never loaded.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


class KernelLaunchError(RuntimeError):
    """A CUDA kernel of the port could not be built or launched. A fault in
    the program or the card, not in the data: a training supervisor re-raises
    it instead of rolling back and retrying."""


_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}     # guarded-by: _lock
#: compiler output per source (``-Xptxas -v``: registers, shared memory, spills)
BUILD_LOG: Dict[str, str] = {}         # guarded-by: _lock


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelLaunchError("nvcc not found: the CUDA kernels need the CUDA "
                                "toolkit (nvcc on PATH or /usr/local/cuda/bin)")
    return path


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build_all(names: Iterable[str]) -> Dict[str, ctypes.CDLL]:
    """Compile (in parallel) and load the named kernel libraries."""
    with _lock:
        todo = [n for n in names if n not in _libs]
        if not todo:
            return dict(_libs)
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in todo:
            out = _target(name)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, out)
        failed = []
        for name, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            BUILD_LOG[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}:\n{log}")
            else:
                os.replace(tmp, out)
        if failed:
            raise KernelLaunchError("nvcc failed for " + "\n".join(failed))
        for name in todo:
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return dict(_libs)


def library(name: str) -> ctypes.CDLL:
    return build_all([name])[name]


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise KernelLaunchError(f"{what}: CUDA error {status} at launch")


def launch_pass() -> str:
    """``recompute`` while the autograd engine runs (a segment that
    ``torch.utils.checkpoint`` recomputes for its backward), else
    ``forward``: the pass a forward launch is counted under."""
    import torch
    return "recompute" if torch._C._current_graph_task_id() != -1 else "forward"


def refuse_grad(what: str, *tensors) -> None:
    """Raise if grad mode is on and a CUDA input of a kernel that has no
    backward requires a gradient: the kernel's output would be detached, and
    the gradient upstream of it silently lost."""
    import torch
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward on the card: call it under "
                           f"torch.no_grad() or on inputs that need no gradient")


def on_device(device):
    """A context that makes ``device`` current for a launch: a no-op when it
    already is (the common case, which skips a device switch per call)."""
    import torch
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
