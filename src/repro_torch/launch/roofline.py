"""Roofline verdict of one DSL suite kernel on one compiled target.

The port of :class:`KernelRoofline` and :func:`kernel_report` from
``repro.launch.roofline``, which the scoreboard
(:mod:`repro_torch.suite.scoreboard`) prices each cell with.  The
reference module's HLO path, and the TPU table it reads, stay behind.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class KernelRoofline:
    """Roofline verdict for ONE DSL suite kernel on ONE compiled target.

    It takes *measured* per-target peaks, calibrated by DSL microkernels
    (an FMA chain for FLOP/s, a streaming copy for bandwidth,
    :func:`repro_torch.suite.scoreboard.calibrate`), so the numerator and
    the denominator go through the same compiler, runtime and launch
    overheads; the scoreboard prices each cell against the H100's data
    sheet with this same class too.  ``t_bound`` is the classic two-term
    roofline bound; ``fraction`` is achieved-vs-roofline, the Rupp-style
    performance-portability metric the scoreboard reports per cell.
    """
    kernel: str
    target: str
    flops: float          # analytic FLOPs executed by one launch
    bytes_moved: float    # analytic bytes moved by one launch
    time_s: float         # measured time of one launch
    peak_flops: float     # per-target peak, FLOP/s
    peak_bw: float        # per-target peak, B/s

    @property
    def t_compute(self) -> float:
        return self.flops / max(self.peak_flops, 1e-9)

    @property
    def t_memory(self) -> float:
        return self.bytes_moved / max(self.peak_bw, 1e-9)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def achieved_gflops(self) -> float:
        return self.flops / max(self.time_s, 1e-12) / 1e9

    @property
    def achieved_gbs(self) -> float:
        return self.bytes_moved / max(self.time_s, 1e-12) / 1e9

    @property
    def fraction(self) -> float:
        """Achieved-vs-roofline: the fraction of the binding resource's
        bound this launch actually reached (1.0 = at the roofline).  Not
        clamped — a value > 1 flags a mis-calibrated peak or timing
        noise, which the scoreboard should surface, not hide."""
        return self.t_bound / max(self.time_s, 1e-12)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_bound=self.t_bound, dominant=self.dominant,
                 achieved_gflops=self.achieved_gflops,
                 achieved_gbs=self.achieved_gbs,
                 fraction=self.fraction)
        return d


def kernel_report(*, kernel: str, target: str, flops: float,
                  bytes_moved: float, time_s: float, peak_flops: float,
                  peak_bw: float) -> KernelRoofline:
    """Build a :class:`KernelRoofline` for one (suite kernel, target)
    measurement.  All quantities must be positive and finite; a bad
    measurement raises rather than producing a silently-wrong fraction."""
    vals = {"flops": flops, "bytes_moved": bytes_moved, "time_s": time_s,
            "peak_flops": peak_flops, "peak_bw": peak_bw}
    for name, v in vals.items():
        if not (isinstance(v, (int, float)) and np.isfinite(v) and v > 0):
            raise ValueError(f"kernel_report: {name} must be a positive "
                             f"finite number, got {v!r}")
    return KernelRoofline(kernel=kernel, target=target, flops=float(flops),
                          bytes_moved=float(bytes_moved),
                          time_s=float(time_s),
                          peak_flops=float(peak_flops),
                          peak_bw=float(peak_bw))


__all__ = ["KernelRoofline", "kernel_report"]
