"""Batch executors: the device-facing half of the serving engine.

The continuous-batching scheduler (:mod:`repro_torch.serving.engine`) is pure
host logic — slots, paged KV accounting, admission, preemption.  All
model work goes through a small executor interface so the scheduler can
be driven by the real model or by a cheap deterministic stub (the
property-test harness steps the scheduler thousands of times):

* ``init_state()``                  — the batch-wide decode state
  (one row per slot; rows are independent).
* ``prefill(prompt, slot)``         — run one request's prompt in
  isolation (batch 1), returning a single-row state fragment plus the
  first sampled token.  Never touches the batch state, so the DAG can
  overlap it with a decode step.
* ``insert(state, fragment, slot)`` — splice a fragment into a slot row.
* ``decode(state, tokens, occupied)`` — one synchronized token for every
  occupied slot.  Row ``i`` of the result depends only on row ``i`` of
  the state, which is what makes per-request outputs independent of how
  requests were interleaved into slots (tests/test_serving_props.py).
* ``cache_bytes(batch, seq)``       — KV footprint, for page sizing.

:class:`TorchExecutor` is the production implementation over
``repro_torch.models.forward`` (the port of the reference's
``JaxExecutor``); :class:`BatchExecutor` and :class:`StubExecutor`, the
deterministic pure-numpy one used by the scheduler tests, are copies of
the reference's.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.model import _cast, cache_logical_axes, forward, init_caches


class BatchExecutor:
    """Interface contract (see module docstring).  Subclasses must set
    ``batch_slots`` and ``max_seq``."""

    batch_slots: int
    max_seq: int

    def init_state(self) -> Any:
        raise NotImplementedError

    def prefill(self, prompt: np.ndarray, slot: int) -> Tuple[Any, int]:
        raise NotImplementedError

    def insert(self, state: Any, fragment: Any, slot: int) -> Any:
        raise NotImplementedError

    def decode(self, state: Any, tokens: np.ndarray,
               occupied: np.ndarray) -> Tuple[Any, np.ndarray]:
        raise NotImplementedError

    def cache_bytes(self, batch: int, seq: int) -> int:
        raise NotImplementedError

    def compile_stats(self) -> Dict[str, int]:
        return {}


# ---------------------------------------------------------------------------
# production executor over the torch model
# ---------------------------------------------------------------------------

class TorchExecutor(BatchExecutor):
    """Prefill / insert / decode over ``repro_torch.models.forward``: the
    counterpart of the reference's ``JaxExecutor``, run eagerly.

    * prefill: batch-1, prompt padded to a power-of-two bucket (floor
      ``prefill_bucket``) — the reference's bucketing, which keeps the
      shapes the kernels and the matmuls see to a handful.  Padding is
      exact: the prompt is left-aligned, the first token is read at the
      *true* last position, and the cache length is overridden to the
      true length, so junk K/V beyond it is masked out (and overwritten
      by decode).
    * insert: copies a batch-1 cache fragment into one row of the batch
      cache along each leaf's batch axis (from
      :func:`repro_torch.models.cache_logical_axes`), in place — the
      reference rebuilt the batch cache with ``dynamic_update_slice``.
    * decode: one token for the whole batch, writing the batch cache in
      place; empty slots are masked — their cache length is pinned to 0
      so they never grow or attend.

    The model runs on the device its parameters are on, under
    ``torch.inference_mode``.  The dense family takes no auxiliary
    inputs.  The compute-dtype view
    of the parameters (:func:`repro_torch.models.model._cast`) is made
    once here instead of on every forward.
    """

    def __init__(self, cfg, params, batch_slots: int, max_seq: int,
                 aux_inputs: Optional[Dict] = None, prefill_bucket: int = 8):
        if aux_inputs:
            raise NotImplementedError(
                "auxiliary model inputs belong to families that are not "
                "ported yet (ROADMAP A.8)")
        self.cfg = cfg
        self.batch_slots, self.max_seq = batch_slots, max_seq
        self.device = params["embed"].device
        self.params = _cast(params, cfg)
        self.prefill_bucket = max(1, prefill_bucket)
        self._axes = cache_logical_axes(cfg)
        self._prefill_shapes: set = set()
        self._calls = {"prefill": 0, "decode": 0, "insert": 0}
        self._lock = threading.Lock()

    def _batch_axis(self, key: str) -> int:
        ax = self._axes.get(key)
        if ax and "batch" in ax:
            return ax.index("batch")
        return 0          # "len" and any unannotated leaf: axis 0

    # -- interface -------------------------------------------------------------
    def init_state(self):
        return init_caches(self.cfg, self.batch_slots, self.max_seq,
                                 device=self.device)

    def bucket(self, prompt_len: int) -> int:
        """Padded prefill length for a prompt (pow2, floored, capped)."""
        b = max(self.prefill_bucket, 1 << (max(1, prompt_len) - 1)
                .bit_length())
        return min(b, self.max_seq)

    def prefill(self, prompt: np.ndarray, slot: int):
        plen = int(len(prompt))
        padded = self.bucket(plen)
        toks = np.zeros((1, padded), np.int64)
        toks[0, :plen] = prompt
        with self._lock:
            self._calls["prefill"] += 1
            self._prefill_shapes.add(padded)
        with torch.inference_mode():
            caches = init_caches(self.cfg, 1, self.max_seq,
                                       device=self.device)
            logits, _, caches = forward(
                self.params, torch.from_numpy(toks).to(self.device),
                self.cfg, caches=caches, mode="prefill")
            tok = int(torch.argmax(logits[0, plen - 1]))
            caches["len"] = torch.full_like(caches["len"], plen)
        return caches, tok

    def insert(self, state, fragment, slot: int):
        with self._lock:
            self._calls["insert"] += 1
        with torch.inference_mode():
            for key, leaf in state.items():
                ax = self._batch_axis(key)
                leaf.select(ax, slot).copy_(
                    fragment[key].select(ax, 0).to(leaf.dtype))
        return state

    def decode(self, state, tokens: np.ndarray, occupied: np.ndarray):
        with self._lock:
            self._calls["decode"] += 1
        with torch.inference_mode():
            toks = torch.as_tensor(np.asarray(tokens, np.int64),
                                   device=self.device)[:, None]
            logits, _, state = forward(self.params, toks, self.cfg,
                                             caches=state, mode="decode")
            tok = torch.argmax(logits[:, -1], dim=-1)
            occ = torch.as_tensor(np.asarray(occupied, bool),
                                  device=self.device)
            state["len"] = torch.where(occ, state["len"], 0)
            out = tok.to(torch.int32).cpu().numpy()
        return state, out

    def cache_bytes(self, batch: int, seq: int) -> int:
        cfg = self.cfg
        kv = cfg.n_layers * batch * cfg.n_kv * seq * cfg.hd
        return batch * 4 + 2 * kv * 2         # int32 lengths, bf16 K and V

    # -- bookkeeping -----------------------------------------------------------
    def compile_stats(self) -> Dict[str, int]:
        """Call counters, and the prefill shapes seen: the port runs
        eagerly, so nothing is traced or compiled per shape (the engine
        reports its compile counters as 0)."""
        with self._lock:
            return {"prefill_calls": self._calls["prefill"],
                    "decode_steps": self._calls["decode"],
                    "insert_calls": self._calls["insert"],
                    "prefill_shapes": len(self._prefill_shapes)}


# ---------------------------------------------------------------------------
# deterministic stub executor (property harness / fault injection)
# ---------------------------------------------------------------------------

class StubExecutor(BatchExecutor):
    """Pure-numpy deterministic executor.

    Token ``j`` of a request is a hash of (prompt, prompt length, j) —
    nothing else — so the expected output stream of any request is
    computable up front (:meth:`expected_tokens`) and *must* be
    independent of slot assignment, co-tenants, preemption, and arrival
    order.  The scheduler property harness leans on exactly that.

    ``delay_s`` adds a sleep per prefill/decode so DAG-overlap behaviour
    is observable in tests and scheduler-overhead benchmarks.
    """

    def __init__(self, batch_slots: int = 4, max_seq: int = 256,
                 vocab: int = 997, bytes_per_token: int = 64,
                 delay_s: float = 0.0):
        self.batch_slots, self.max_seq = batch_slots, max_seq
        self.vocab = vocab
        self.bytes_per_token = bytes_per_token
        self.delay_s = delay_s
        self.prefill_calls = 0
        self.decode_calls = 0
        self._lock = threading.Lock()

    # -- the deterministic token stream ----------------------------------------
    @staticmethod
    def _hash_prompt(prompt: np.ndarray) -> int:
        p = np.asarray(prompt, np.int64)
        return int(np.sum((p + 1) * (np.arange(p.size, dtype=np.int64) + 13))
                   % (1 << 31))

    @classmethod
    def token_at(cls, prompt_hash: int, prompt_len: int, j: int,
                 vocab: int = 997) -> int:
        return int((prompt_hash * 2654435761 + (prompt_len + j) * 40503
                    + j * 97 + 1) % vocab)

    @classmethod
    def expected_tokens(cls, prompt: np.ndarray, max_new: int,
                        eos_token: Optional[int] = None,
                        vocab: int = 997):
        """The oracle: the exact stream a request must produce no matter
        how the scheduler interleaved it."""
        h, plen = cls._hash_prompt(prompt), int(len(prompt))
        out = []
        for j in range(max_new):
            t = cls.token_at(h, plen, j, vocab)
            out.append(t)
            if eos_token is not None and t == eos_token:
                break
        return out

    # -- interface -------------------------------------------------------------
    def init_state(self):
        B = self.batch_slots
        return {"h": np.zeros(B, np.int64), "plen": np.zeros(B, np.int64),
                "emitted": np.zeros(B, np.int64)}

    def _sleep(self):
        if self.delay_s:
            import time
            time.sleep(self.delay_s)

    def prefill(self, prompt: np.ndarray, slot: int):
        with self._lock:
            self.prefill_calls += 1
        self._sleep()
        h, plen = self._hash_prompt(prompt), int(len(prompt))
        return (h, plen), self.token_at(h, plen, 0, self.vocab)

    def insert(self, state, fragment, slot: int):
        h, plen = fragment
        state["h"][slot] = h
        state["plen"][slot] = plen
        state["emitted"][slot] = 1       # prefill emitted token 0
        return state

    def decode(self, state, tokens: np.ndarray, occupied: np.ndarray):
        with self._lock:
            self.decode_calls += 1
        self._sleep()
        out = np.zeros(self.batch_slots, np.int64)
        for i in range(self.batch_slots):
            if not occupied[i]:
                continue
            out[i] = self.token_at(int(state["h"][i]), int(state["plen"][i]),
                                   int(state["emitted"][i]), self.vocab)
            state["emitted"][i] += 1
        return state, out

    def cache_bytes(self, batch: int, seq: int) -> int:
        return batch * seq * self.bytes_per_token

    def compile_stats(self) -> Dict[str, int]:
        with self._lock:
            return {"prefill_calls": self.prefill_calls,
                    "decode_steps": self.decode_calls,
                    "prefill_compiles": 0, "decode_compiles": 0}


__all__ = ["BatchExecutor", "StubExecutor", "TorchExecutor"]
