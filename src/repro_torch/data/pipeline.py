"""Deterministic synthetic token pipeline with host sharding and prefetch
(port of ``repro.data.pipeline``).

Training data for the launchers: a seeded Zipf-like token stream that is
deterministic per ``(seed, step, host)`` (a restarted run replays the same
batches, which the supervisor's rollback relies on), host-sharded (each host
draws only its slice of the global batch) and prefetched by a background
thread. The draw is numpy's, in the reference's order, so the batches equal
the reference's bit for bit. Batches are numpy dicts, ``{'tokens': (B_local,
S) int32}`` plus the stub frontend embeddings of whisper (``frames``) or a
VLM (``patches``); :func:`batch_to_torch` moves one to a device.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.models.config import ArchConfig


@dataclass(frozen=True)
class DataConfig:
    global_batch: int
    seq_len: int
    seed: int = 0
    prefetch_depth: int = 2
    zipf_a: float = 1.2           # skewed token distribution (more LM-like than uniform)


def _batch_for_step(cfg: ArchConfig, data: DataConfig, step: int,
                    host_index: int, host_count: int) -> Dict[str, np.ndarray]:
    local_batch = data.global_batch // host_count
    rng = np.random.default_rng(
        np.random.SeedSequence([data.seed, step, host_index]))
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    seq = data.seq_len - n_front
    # Zipf draw folded into the vocabulary (modulo, no rejection)
    raw = rng.zipf(data.zipf_a, size=(local_batch, seq)).astype(np.int64)
    tokens = (raw % cfg.vocab_size).astype(np.int32)
    batch: Dict[str, np.ndarray] = {"tokens": tokens}
    if cfg.frontend == "audio_frames":
        batch["frames"] = rng.standard_normal(
            (local_batch, cfg.n_enc_positions, cfg.d_model)).astype(np.float32) * 0.02
    elif cfg.frontend == "vision_patches":
        batch["patches"] = rng.standard_normal(
            (local_batch, n_front, cfg.d_model)).astype(np.float32) * 0.02
    return batch


def make_batch_specs(cfg: ArchConfig, data: DataConfig) -> Dict[str, tuple]:
    """``{name: (shape, numpy dtype)}`` of one global batch."""
    n_front = cfg.n_frontend_tokens if cfg.frontend == "vision_patches" else 0
    specs = {"tokens": ((data.global_batch, data.seq_len - n_front), np.int32)}
    if cfg.frontend == "audio_frames":
        specs["frames"] = ((data.global_batch, cfg.n_enc_positions, cfg.d_model),
                           np.float32)
    elif cfg.frontend == "vision_patches":
        specs["patches"] = ((data.global_batch, n_front, cfg.d_model), np.float32)
    return specs


def batch_to_torch(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch as tensors on ``device`` (tokens int32, embeddings fp32)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


class SyntheticTokenPipeline:
    """Iterator over ``(step, batch)`` with background prefetch; call
    :meth:`close` to stop its thread."""

    def __init__(self, cfg: ArchConfig, data: DataConfig, *, start_step: int = 0,
                 host_index: int = 0, host_count: int = 1):
        if data.global_batch % host_count:
            raise ValueError(f"global batch {data.global_batch} does not split over "
                             f"{host_count} hosts")
        self.cfg = cfg
        self.data = data
        self.host_index = host_index
        self.host_count = host_count
        self._step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=data.prefetch_depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    def _producer(self) -> None:
        step = self._step
        while not self._stop.is_set():
            batch = _batch_for_step(self.cfg, self.data, step,
                                    self.host_index, self.host_count)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        return self._q.get()

    def peek_step(self) -> int:
        return self._step

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)

    @staticmethod
    def batch_at(cfg: ArchConfig, data: DataConfig, step: int,
                 host_index: int = 0, host_count: int = 1) -> Dict[str, np.ndarray]:
        """Random access (replay and verification)."""
        return _batch_for_step(cfg, data, step, host_index, host_count)
