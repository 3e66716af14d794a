"""Continuous-batching serving engine with WarmSwap-backed replica bring-up.

Port of ``repro.serving.engine``. The engine owns a fixed pool of decode slots
over one batched decode state:

  * ``submit()`` queues requests; admission prefills each (B=1, its own
    length, through the flash-attention kernel) and splices the resulting KV
    state into a free slot, so in-flight requests never stall behind a new
    prefill longer than one engine step;
  * ``step()`` runs one batched ``serve_step`` for ALL slots (parked slots
    decode garbage into their own ring slot, harmless and reset on admission)
    through the decode-attention kernel, and retires finished requests (EOS or
    token budget);
  * per-slot position streams come from the per-row ``k_pos``/``pos`` of the
    decode state, so slots at different depths share one step.

The engine runs eagerly: no jit and no CUDA graph. Sampling (greedy, or
temperature with a seeded numpy generator) runs on the host in numpy, as in
the reference.

Replica bring-up is WarmSwap's job: :meth:`ServingEngine.from_pool`
live-migrates the base-model image out of the ``DependencyManager`` instead of
cold-loading it; this is also the node-failure recovery path
(``runtime/fault_tolerance.py`` measures it).
"""
from __future__ import annotations

import collections
import itertools
import time
from dataclasses import dataclass, field
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.api import make_serve_step_with_logits
from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import forward, init_decode_state
from repro_torch.serving.state_utils import state_reset_slot, state_splice


@dataclass
class ServeConfig:
    max_slots: int = 4
    max_seq_len: int = 512
    max_new_tokens: int = 32
    eos_id: int = -1                # -1: disabled (synthetic vocab has no EOS)
    temperature: float = 0.0        # 0 = greedy
    seed: int = 0
    keep_logits: bool = False       # keep each token's logits on its Request


@dataclass
class Request:
    rid: int
    prompt: np.ndarray              # (S,) int32
    max_new_tokens: int
    submitted_at: float = field(default_factory=time.monotonic)
    prefilled_at: Optional[float] = None
    finished_at: Optional[float] = None
    tokens: List[int] = field(default_factory=list)
    logits: List[np.ndarray] = field(default_factory=list)   # with keep_logits

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.prefilled_at is None else self.prefilled_at - self.submitted_at

    @property
    def latency_s(self) -> Optional[float]:
        return None if self.finished_at is None else self.finished_at - self.submitted_at


class ServingEngine:
    """Continuous batching over ``max_slots`` decode slots on the parameters'
    device.

    The decode state has the parameters' dtype. For fp32 parameters that is
    the reference's fp32 state (``repro/serving/engine.py:73``). The reference
    always builds fp32 and so cannot serve a bf16 image (its ``lax.scan``
    carry changes dtype and raises); the port serves one with a bf16 state,
    which is ``init_decode_state``'s own default in the reference.
    """

    def __init__(self, cfg: ArchConfig, params: Any,
                 serve_cfg: Optional[ServeConfig] = None):
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg if serve_cfg is not None else ServeConfig()
        tok = params["embed"]["tok"]
        self.device = tok.device
        B = self.scfg.max_slots
        self.state = init_decode_state(cfg, B, self.scfg.max_seq_len, tok.dtype,
                                       self.device)
        self._serve_step = make_serve_step_with_logits(cfg)
        self._queue: Deque[Request] = collections.deque()
        self._slots: List[Optional[Request]] = [None] * B
        self._next_tok = np.zeros((B, 1), np.int32)
        self._rid = itertools.count()
        self.completed: Dict[int, Request] = {}
        self._rng = np.random.default_rng(self.scfg.seed)
        self.steps = 0

    # ------------------------------------------------------------------ intake
    def submit(self, prompt: np.ndarray, max_new_tokens: Optional[int] = None) -> int:
        req = Request(next(self._rid), np.asarray(prompt, np.int32),
                      max_new_tokens or self.scfg.max_new_tokens)
        self._queue.append(req)
        return req.rid

    # ------------------------------------------------------------------ admission
    def _admit(self) -> None:
        for slot in range(self.scfg.max_slots):
            if self._slots[slot] is not None or not self._queue:
                continue
            req = self._queue.popleft()
            tokens = torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                                     device=self.device)
            logits, single = forward(self.params, tokens, self.cfg, make_state=True,
                                     state_len=self.scfg.max_seq_len, logits_slice=1)
            row = logits[:, -1, : self.cfg.vocab_size].cpu().numpy()
            first = self._sample(row)
            req.prefilled_at = time.monotonic()
            req.tokens.append(int(first[0]))
            if self.scfg.keep_logits:
                req.logits.append(row[0])
            self.state = state_reset_slot(self.state, slot)
            self.state = state_splice(self.state, single, slot)
            self._slots[slot] = req
            self._next_tok[slot, 0] = first[0]

    def _sample(self, logits: np.ndarray) -> np.ndarray:
        if self.scfg.temperature <= 0:
            return np.argmax(logits, axis=-1).astype(np.int32)
        z = logits / self.scfg.temperature
        z = z - z.max(-1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(-1, keepdims=True)
        return np.array([self._rng.choice(len(row), p=row) for row in p], np.int32)

    # ------------------------------------------------------------------ one step
    def step(self) -> int:
        """Admit, decode one token for every active slot; returns #active."""
        self._admit()
        active = [i for i, r in enumerate(self._slots) if r is not None]
        if not active:
            return 0
        logits, self.state = self._serve_step(
            self.params, self.state, torch.from_numpy(self._next_tok).to(self.device))
        rows = logits.cpu().numpy()
        toks = self._sample(rows)
        self.steps += 1
        now = time.monotonic()
        for slot in active:
            req = self._slots[slot]
            req.tokens.append(int(toks[slot]))
            if self.scfg.keep_logits:
                req.logits.append(rows[slot])
            self._next_tok[slot, 0] = toks[slot]
            done = (len(req.tokens) >= req.max_new_tokens or
                    (self.scfg.eos_id >= 0 and toks[slot] == self.scfg.eos_id))
            if done:
                req.finished_at = now
                self.completed[req.rid] = req
                self._slots[slot] = None
        return len(active)

    @property
    def pending(self) -> int:
        """Requests submitted and not yet admitted to a slot."""
        return len(self._queue)

    def idle(self) -> bool:
        """True when no request is queued or decoding."""
        return not self._queue and all(s is None for s in self._slots)

    def run_until_done(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle():
                return
            self.step()

    # ------------------------------------------------------------------ bring-up
    @classmethod
    def from_pool(cls, manager, image_id: str, cfg: ArchConfig,
                  serve_cfg: Optional[ServeConfig] = None, policy=None):
        """WarmSwap replica bring-up: live-migrate the base image from the pool
        (onto the pool's device)."""
        from repro_torch.core.migration import RestorePolicy
        restored = manager.request_migration(image_id, policy or RestorePolicy.BULK)
        params = restored.as_pytree()
        manager.release(image_id)
        return cls(cfg, params, serve_cfg)

    # ------------------------------------------------------------------ metrics
    def metrics(self) -> Dict[str, float]:
        done = list(self.completed.values())
        if not done:
            return {"completed": 0}
        return {
            "completed": len(done),
            "mean_ttft_s": float(np.mean([r.ttft_s for r in done])),
            "mean_latency_s": float(np.mean([r.latency_s for r in done])),
            "engine_steps": self.steps,
        }
