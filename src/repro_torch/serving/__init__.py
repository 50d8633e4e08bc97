"""Continuous-batching serving on torch: `ServingEngine` schedules at
request granularity over fixed decode slots — submit()/step()/drain()
admission, per-step slot refill, paged KV from the context BufferPool,
preemption on OOM — dispatching each step's prefills and decode through
the runtime's event DAG; `TorchExecutor` runs the model.  The serving
mesh waits (ROADMAP A.9)."""

from .engine import Request, RequestState, ServingEngine
from .executor import BatchExecutor, StubExecutor, TorchExecutor

__all__ = ["ServingEngine", "Request", "RequestState",
           "BatchExecutor", "StubExecutor", "TorchExecutor"]
