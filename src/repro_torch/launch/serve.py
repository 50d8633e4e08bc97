"""Continuous-batching serving entry point on one card (or the CPU, for
tests).

The port of ``repro.launch.serve``.  Requests are submitted into the
engine's admission queue on a staggered arrival schedule and the loop
pumps ``step()`` until the queue drains — the submit()/step() loop a real
serving front-end runs, exercising per-step slot refill and paged KV.
The model is the architecture's full published config (any of the
reference's ten) with random weights from ``--seed`` (``--smoke`` for
the reduced one); a vlm's image embeddings and an encdec's audio frames
are drawn from the same seed, one row per slot.  It runs on the first
CUDA device unless ``--device`` names another (``--device cpu`` runs the
kernels' plain versions); with no card and no ``--device`` it raises
:class:`~repro_torch.runtime.DeviceNotFoundError`.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-135m \\
      --smoke --device cpu --requests 6 --max-new 16 [--trace OUT.JSON]

``--trace OUT.JSON`` records the run's event DAG (one slice a command on
the device's row) and a ``kv_pages_live`` counter track on the same row
through the context's :meth:`~repro_torch.runtime.context.Context.trace`,
and exports it as Chrome-trace JSON (open it in chrome://tracing).
"""

from __future__ import annotations

import argparse
import contextlib
import statistics
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import configs
from ..models import init_params
from ..runtime import ChromeTrace, Context, Platform
from ..serving import Request, ServingEngine


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=configs.ARCH_IDS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--batch-slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scheduler", choices=["continuous", "fixed"],
                    default="continuous")
    ap.add_argument("--arrival-every", type=int, default=1,
                    help="submit one request every N scheduler steps")
    ap.add_argument("--device", default=None,
                    help="torch device to serve on (default: the first "
                         "CUDA device); 'cpu' for tests")
    ap.add_argument("--trace", metavar="OUT.JSON", default=None,
                    help="export the run's event DAG as Chrome-trace "
                         "JSON (open in chrome://tracing, docs/mesh.md)")
    return ap.parse_args(argv)


def make_requests(cfg, rng: np.random.Generator, n: int, prompt_len=(4, 16),
                  new=(2, 16)) -> List[Request]:
    """``n`` requests with prompt lengths in ``prompt_len`` and token
    budgets in ``new`` (both inclusive), drawn from ``rng``."""
    return [Request(prompt=rng.integers(0, cfg.vocab,
                                        rng.integers(prompt_len[0],
                                                     prompt_len[1] + 1),
                                        dtype=np.int64).astype(np.int32),
                    max_new_tokens=int(rng.integers(new[0], new[1] + 1)))
            for _ in range(n)]


def make_aux_inputs(cfg, rng: np.random.Generator,
                    batch_slots: int) -> Dict[str, np.ndarray]:
    """The model's auxiliary inputs, one row per slot, drawn from ``rng``
    at the reference's shapes: a vlm's (stubbed) image patch embeddings
    ``img_embeds`` (batch_slots, n_img_tokens, d), an encdec's audio
    frame embeddings ``frames`` (batch_slots, enc_seq, d); none for the
    other families."""
    aux = {}
    if cfg.family == "vlm":
        aux["img_embeds"] = np.asarray(rng.standard_normal(
            (batch_slots, cfg.n_img_tokens, cfg.d_model)), np.float32)
    if cfg.family == "encdec":
        aux["frames"] = np.asarray(rng.standard_normal(
            (batch_slots, cfg.enc_seq, cfg.d_model)), np.float32)
    return aux


def make_engine(cfg, seed: int = 0, batch_slots: int = 4,
                max_seq: int = 128, scheduler: str = "continuous",
                device=None, aux_inputs=None, params=None) -> ServingEngine:
    """An engine over ``cfg`` with random weights from ``seed`` (or
    ``params``, already on the device) and ``aux_inputs`` (see
    :func:`make_aux_inputs`), on the first CUDA device unless ``device``
    names another.  Its dispatch queue and KV page pool come from a host
    Context whose first device is that one."""
    ctx = Context(platform=Platform(torch_device=device))
    if params is None:
        params = init_params(cfg, torch.Generator().manual_seed(seed),
                             device=ctx.devices[0].torch_device)
    return ServingEngine(cfg, params, batch_slots=batch_slots,
                         max_seq=max_seq, aux_inputs=aux_inputs, context=ctx,
                         scheduler=scheduler)


def serve(eng: ServingEngine, requests: List[Request],
          arrival_every: int = 1,
          trace: Optional[ChromeTrace] = None) -> Dict[str, object]:
    """Submit one request every ``arrival_every`` steps and pump the
    scheduler until it drains.  Returns the engine, the requests, the
    finished ones, the tokens served, the wall seconds, tok/s and the
    median wall milliseconds of the steps whose round ran a decode and no
    prefill (the decode steps).  With ``trace``, each step adds a
    ``kv_pages_live`` sample to it on the device's row."""
    done: List[Request] = []
    pending = list(requests)
    decode_ms: List[float] = []
    dev = eng.context.devices[0].torch_device
    row = eng.context.devices[0].info.name
    t0 = time.perf_counter()
    while pending or eng.scheduler_stats["waiting"] or \
            eng.scheduler_stats["running"]:
        if pending and eng.current_step % max(1, arrival_every) == 0:
            eng.submit(pending.pop(0))
        dag0 = eng.dag_stats
        ts = time.perf_counter()
        done.extend(eng.step())
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - ts) * 1e3
        if trace is not None:
            trace.counter("kv_pages_live", eng.kv_stats["pages_live"],
                          process=row)
        dag1 = eng.dag_stats
        if dag1["decode_events"] > dag0["decode_events"] and \
                dag1["prefill_events"] == dag0["prefill_events"]:
            decode_ms.append(ms)
    dt = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done if r.done)
    return {"engine": eng, "requests": list(requests), "done": done,
            "tokens": tokens, "wall_s": dt, "tok_s": tokens / max(dt, 1e-9),
            "device": str(dev), "decode_steps": len(decode_ms),
            "decode_step_ms_median": (statistics.median(decode_ms)
                                      if decode_ms else None)}


def report(run: Dict[str, object]) -> None:
    """Print the reference's summary lines for a :func:`serve` run."""
    eng, done = run["engine"], run["done"]
    print(f"served {len(done)} requests, {run['tokens']} tokens "
          f"in {run['wall_s']:.2f}s ({run['tok_s']:.1f} tok/s)")
    sched = eng.scheduler_stats
    print(f"  sched: {sched['steps']} steps, {sched['evictions']} "
          f"evictions, {sched['preemptions']} preemptions")
    dag = eng.dag_stats
    if dag["steps"]:
        print(f"  dag: {dag['events']} events over {dag['steps']} steps, "
              f"overlap {dag['overlap']:.2f}x")
    kv = eng.kv_stats
    print(f"  kv pool: {kv['hits']} hits / {kv['misses']} misses, "
          f"{kv['page_bytes']} B/page x {kv['pages_live']} live, "
          f"{kv['frees']} frees (context pools: "
          f"{list(eng.context.pool_stats())})")
    for r in done:
        tag = "FAILED " + type(r.error).__name__ if r.error else \
            f"{r.out_tokens}"
        print(f"  req{r.id}: prompt[:4]={r.prompt[:4].tolist()} -> {tag}")


def main(argv=None) -> Dict[str, object]:
    args = parse_args(argv)
    cfg = configs.get_smoke(args.arch) if args.smoke \
        else configs.get_config(args.arch)
    rng = np.random.default_rng(args.seed)
    aux = make_aux_inputs(cfg, rng, args.batch_slots)
    eng = make_engine(cfg, args.seed, args.batch_slots, args.max_seq,
                      args.scheduler, args.device, aux)
    reqs = make_requests(cfg, rng, args.requests, new=(2, args.max_new))
    with (eng.context.trace() if args.trace
          else contextlib.nullcontext()) as tr:
        run = serve(eng, reqs, args.arrival_every, trace=tr)
    if args.trace:
        doc = tr.export(args.trace)
        print(f"trace: {len(doc['traceEvents'])} events -> {args.trace} "
              f"(load in chrome://tracing)")
    report(run)
    return run


if __name__ == "__main__":
    main()
