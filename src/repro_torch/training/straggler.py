"""Straggler monitoring and elastic re-mesh planning.

The port's own copy of ``repro.training.straggler`` (which imports no
JAX; the port imports nothing of the reference package).  At 1000+
nodes the common failures are (a) a host that dies (handled by
checkpoint/restart) and (b) a host that runs slow — a straggler that
silently caps the whole synchronous step.  The monitor keeps an online
median/deviation of step times, flags persistent outliers, and the
elastic planner recomputes a (pod, data, model) factorization for the
surviving host count so the job restarts from the last checkpoint on a
smaller-but-healthy mesh (checkpoints are mesh-independent by design).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class StragglerConfig:
    window: int = 20              # step-time history window
    slow_factor: float = 1.5      # flagged when > factor x median
    persist_steps: int = 5        # consecutive flags before reporting


class StragglerMonitor:
    """Feed per-host step durations; yields persistent stragglers."""

    def __init__(self, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self._times: Dict[str, List[float]] = {}
        self._flags: Dict[str, int] = {}

    def record(self, host: str, seconds: float) -> None:
        h = self._times.setdefault(host, [])
        h.append(seconds)
        if len(h) > self.cfg.window:
            h.pop(0)

    def _median_all(self) -> float:
        allt = sorted(t for h in self._times.values() for t in h)
        return allt[len(allt) // 2] if allt else 0.0

    def check(self) -> List[str]:
        """Update flags; return hosts flagged persistently slow."""
        med = self._median_all()
        out = []
        for host, h in self._times.items():
            if not h:
                continue
            if med > 0 and h[-1] > self.cfg.slow_factor * med:
                self._flags[host] = self._flags.get(host, 0) + 1
            else:
                self._flags[host] = 0
            if self._flags[host] >= self.cfg.persist_steps:
                out.append(host)
        return out

    def forget(self, host: str) -> None:
        """Drop a host's history and flags — used when the host leaves
        the mesh (dead replica) or finishes draining and rejoins healthy
        (its stale slow samples must not re-flag it instantly)."""
        self._times.pop(host, None)
        self._flags.pop(host, None)


def plan_elastic_mesh(n_healthy_chips: int, model_axis: int = 16,
                      chips_per_pod: int = 256) -> Optional[Tuple]:
    """Largest (pod, data, model) mesh that fits the healthy chips,
    keeping the model axis fixed (param shardings stay valid) and the
    data axis a power of two (batch divisibility).

    Returns (pods, data, model) or None when no viable mesh remains."""
    if n_healthy_chips < model_axis:
        return None
    pods = max(1, n_healthy_chips // chips_per_pod)
    while pods >= 1:
        per_pod = n_healthy_chips // pods
        data = per_pod // model_axis
        # round data down to a power of two
        p2 = 1
        while p2 * 2 <= data:
            p2 *= 2
        if p2 >= 1 and pods * p2 * model_axis <= n_healthy_chips and p2 > 0:
            return (pods, p2, model_axis)
        pods -= 1
    return None


__all__ = ["StragglerConfig", "StragglerMonitor", "plan_elastic_mesh"]
