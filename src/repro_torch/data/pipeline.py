"""Deterministic synthetic LM data pipeline with background prefetch.

The port of ``repro.data.pipeline``, in numpy as the reference is: each
step's batch is generated deterministically from (seed, step), so a
restart at step k regenerates the same stream, and the batches are
bit-equal to the reference's for the same (seed, step).  A small
double-buffer thread prefetches the next batch while the current step
runs.  The batches stay numpy arrays: the trainer moves them to its
device.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..models.config import ModelConfig


def synth_batch(cfg: ModelConfig, batch: int, seq: int, step: int,
                seed: int = 0) -> Dict[str, np.ndarray]:
    """Markov-ish synthetic tokens: structured enough that a model can
    reduce loss, deterministic in (seed, step)."""
    rng = np.random.default_rng(np.uint64(seed) * 1_000_003 + np.uint64(step))
    # low-entropy stream: a small effective vocabulary with Zipf-ish mass
    # (so smoke-scale models show clear loss descent within tens of steps)
    # + copy structure in the second half (exercises attention/induction).
    v_eff = min(64, cfg.vocab)
    p = 1.0 / np.arange(1, v_eff + 1)
    p /= p.sum()
    base = rng.choice(v_eff, size=(batch, seq + 1), p=p)
    half = (seq + 1) // 2
    base[:, half:half * 2] = base[:, :half]
    toks = base.astype(np.int32)
    out = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    if cfg.family == "vlm":
        out["img_embeds"] = rng.standard_normal(
            (batch, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def data_iterator(cfg: ModelConfig, batch: int, seq: int, *,
                  start_step: int = 0, seed: int = 0,
                  prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
    """Background-threaded prefetching iterator."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            b = synth_batch(cfg, batch, seq, step, seed)
            while not stop.is_set():
                try:
                    q.put(b, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()


__all__ = ["data_iterator", "synth_batch"]
