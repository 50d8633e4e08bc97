"""Per-target autotuning sweeps + roofline-validated reporting.

The port of ``repro.suite.scoreboard``.  The :class:`Scoreboard` runs
every suite kernel through the host API (``Context`` -> ``Program`` ->
``Kernel`` -> ``launch``) on each compiled target, sweeps the kernel's
tuning space, checks every configuration's output *bitwise* against the
NumPy oracle, persists the winning parameters in the
:class:`~repro_torch.core.autotune.TuningTable` (``sweeps`` section — a
warm run re-measures only the winner), and prices the winner against a
**measured** roofline: per-target peak FLOP/s and bandwidth calibrated by
two DSL microkernels (an ILP'd FMA chain and a streaming copy) run
through the same compiler and runtime — the Rupp-et-al. methodology,
applied to the paper's code-generation strategies (§4.4: loop
serialization, §4.5: SIMD lanes, and the ``cuda`` work-group target).

On the CPU the arithmetic and the report schema are the reference's: a
cell's ``time_us`` is the best host wall time of ``Context.launch``.  On
a CUDA device a launch is asynchronous and ``Context.launch`` copies the
host arrays to the card each time, so there:

* ``time_us`` is the device time of the bound binary on device-resident
  tensors: CUDA events, best of ``repeats`` after ``warmup`` launches
  (at least one for ``cuda`` and ``auto``: a kernel's first launch
  loads its module, the auto device's tunes), with the L2 flushed and
  the card kept busy until the launch is enqueued.  ``wall_us`` beside
  it is the host wall time of one ``Context.launch`` with the card
  synchronized, taken after those;
* the peaks are calibrated per target on the card at sizes that fill it
  (:data:`CARD_CAL_BW_N`, :data:`CARD_CAL_FLOPS_N`), each the best over
  the local sizes :data:`CARD_CAL_LSZ`, and every cell carries
  ``fraction_datasheet`` beside ``fraction``: the same roofline against
  the H100's data sheet (:data:`DATASHEET`).  The ``cuda`` target is
  built with ``-fmad=false``, so its FMA chain issues a multiply and an
  add and reaches about half of the data sheet's FP32 rate at most;
* a fraction above 1 is listed under the report's ``above_roofline``,
  never clamped.

Extra columns beyond the compiled targets:

* ``coexec2`` — the ``cuda`` winner (``vector`` on the CPU) co-executed
  over ``co_devices(2)`` of that driver, timed on the host (the
  co-executor returns merged host tensors).  Both co-devices share one
  torch device, so it is priced against that device's peaks counted once
  (the reference doubles the vector peaks: ROADMAP C.13);
* ``auto`` — the ``auto`` device, whose per-kernel target choice comes
  from the same tuning table the sweeps persist into; it is priced
  against the chosen target's peaks (the reference takes the vector
  target's whatever the choice).

The ``card`` shape set (:data:`CARD_SHAPES`, ``chip_smoke.py`` phase 5's
sizes) lives here; ``suite/kernels.py`` keeps the reference's ``full``
and ``ci`` sets.  The ``loop`` target steps work-items from the host
(ROADMAP C.12), so on a CUDA device it is a default column at the ``ci``
set only; elsewhere the report names it under ``absent``.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.autotune import TuningTable, set_default_table
from ..core.dsl import KernelBuilder
from ..core.errors import InvalidArgError
from ..core.targets.cuda_target import build_many
from ..launch.roofline import kernel_report
from ..runtime import Context
from . import oracles
from .kernels import SUITE, SuiteKernel, param_key

SCHEMA = "bench_scoreboard/v1"

# FMA-chain calibration: independent accumulator chains give the
# compiler ILP so the measured peak is a throughput, not a latency
_CAL_CHAINS = 4
_CAL_OPS = 32

# H100 SXM data sheet at 700 W: FP32 on the CUDA cores, HBM3 bytes/s
DATASHEET = {"peak_flops": 67e12, "peak_bw": 3.35e12}

# card-sized problems: chip_smoke.py phase 5's sizes
CARD_SHAPES = {
    "gemm": {"m": 2048, "n": 2048, "k": 2048},
    "spmv": {"m": 1 << 20, "n": 1 << 20, "max_nnz": 8},
    "stencil1d": {"n": 1 << 25},
    "stencil2d": {"h": 8192, "w": 8192},
    "scan": {"n": 1 << 24, "seg": 256},
    "hist": {"n": 1 << 24, "bins": 16},
}
_CAL_LSZ = 64
# calibration sizes on a CUDA device: a 256 MB copy, and 2**24 FMA chains
# (2**18 work-groups of 64 over 132 SMs)
CARD_CAL_BW_N = 1 << 26
CARD_CAL_FLOPS_N = 1 << 24
# the loop target's time grows with the work-items it steps from the host,
# so on a CUDA device it is calibrated over one work-group
CARD_CAL_LOOP_N = _CAL_LSZ
LOOP_ON_CARD = ("the loop target steps work-items from the host, "
                "0.13-10.6 s a launch at the ci shapes on the card "
                "(ROADMAP C.12); it is timed at the ci set only")
_L2_FLUSH_BYTES = 256 << 20
# cycles the card spins before each timed launch (~1 ms), so that the
# host has enqueued the launch before its start event fires
_SPIN_CYCLES = 2_000_000
# on a CUDA device the calibration kernels run at each of these local
# sizes, and each peak is the best of them (64-thread blocks alone keep
# the copy at a quarter of the card's bandwidth)
CARD_CAL_LSZ = (64, 256, 1024)


def _build_cal_flops():
    b = KernelBuilder("suite_cal_flops")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    accs = [b.var(x[g] * (0.5 + 0.25 * c), name=f"acc{c}")
            for c in range(_CAL_CHAINS)]
    for _ in range(_CAL_OPS):
        for a in accs:
            a.set(a.get() * 1.0009765625 + 0.0009765625)
    total = accs[0].get()
    for a in accs[1:]:
        total = total + a.get()
    y[g] = total
    return b.finish()


def _build_cal_copy():
    b = KernelBuilder("suite_cal_copy")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    g = b.global_id(0)
    y[g] = x[g] + 1.0
    return b.finish()


CAL_BUILDERS = {"peak_flops": _build_cal_flops, "peak_bw": _build_cal_copy}


def shape_for(sk: SuiteKernel, shape_set: str):
    """The problem shape of ``sk`` in ``shape_set`` (``card``, ``ci`` or
    ``full``; an unknown set falls back to ``full``, as the reference's
    does)."""
    if shape_set == "card":
        return dict(CARD_SHAPES[sk.name])
    return sk.shapes.get(shape_set, sk.shapes["full"])


def _time(fn, warmup: int, repeats: int):
    """Best-of-N wall time of ``fn()`` after ``warmup`` calls (at least
    one: the first call pays the build), and the last call's result."""
    for _ in range(max(warmup, 1)):
        fn()
    return _best_wall(fn, repeats)


def _best_wall(fn, repeats: int):
    best = float("inf")
    for _ in range(max(repeats, 1)):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


class _DeviceClock:
    """Device time of a launch on a CUDA device: CUDA events around it,
    best of ``repeats`` after ``warmup``.  Before each, the L2 is flushed
    and the card spins for ~1 ms, so the events time the card's work and
    not the host's time to enqueue the launch."""

    def __init__(self, device: torch.device):
        self.flush = torch.empty(_L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device=device)

    def __call__(self, launch, warmup: int, repeats: int) -> float:
        for _ in range(warmup):
            launch()
        best = float("inf")
        for _ in range(max(repeats, 1)):
            self.flush.zero_()
            torch.cuda._sleep(_SPIN_CYCLES)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        return best


def _resident(inputs, device: torch.device) -> Dict[str, torch.Tensor]:
    return {n: torch.tensor(v, device=device).reshape(-1)
            for n, v in inputs.items()}


def calibrate(ctx: Context, target: str, n: int = 1 << 14,
              lsz: int = _CAL_LSZ, warmup: int = 1, repeats: int = 3,
              flops_n: Optional[int] = None, clock=None
              ) -> Dict[str, float]:
    """Measured per-target peaks: ``peak_flops`` (FLOP/s, FMA chains over
    ``flops_n`` work-items, default ``n``) and ``peak_bw`` (B/s, a
    streaming copy over ``n`` float32), through the same Context/launch
    path the suite kernels use.  Sizes round up to a multiple of ``lsz``.
    With a ``clock`` (a :class:`_DeviceClock`), each is timed on the
    card on device-resident tensors; otherwise by the host's wall clock
    around ``Context.launch``."""
    device = ctx.devices[0]
    peaks: Dict[str, float] = {}
    for name, size, per_item in (
            ("peak_flops", flops_n or n,
             float(2 * _CAL_OPS * _CAL_CHAINS + _CAL_CHAINS)),
            ("peak_bw", n, 8.0)):
        size = -(-size // lsz) * lsz
        x = np.linspace(0.5, 1.5, size).astype(np.float32)
        kern = ctx.create_program(CAL_BUILDERS[name]).create_kernel()
        if clock is None:
            kern.set_args(x=x, y=np.zeros(size, np.float32))
            t, _ = _time(lambda: ctx.launch(kern, (size,), (lsz,),
                                            target=target),
                         warmup, repeats)
        else:
            binary = kern.bind(device, (lsz,), target=target)
            bufs = _resident({"x": x, "y": np.zeros(size, np.float32)},
                             device.torch_device)
            t = clock(lambda: binary.launch_ndrange(bufs, (size,)),
                      max(warmup, 1), repeats)
        peaks[name] = per_item * size / max(t, 1e-12)
    return peaks


def _subsample(space, max_configs: Optional[int]):
    """Evenly-spaced sub-space keeping the endpoints; never fewer than 2
    configurations (the beats-worst gate needs a sweep, not a point)."""
    if max_configs is None or max_configs >= len(space) or len(space) <= 2:
        return tuple(space)
    m = max(int(max_configs), 2)
    idx = np.linspace(0, len(space) - 1, m).round().astype(int)
    return tuple(space[i] for i in sorted(set(idx.tolist())))


def _gemm_expected(sk, inputs, shape, params):
    """GEMM's oracle through a float64 product where that is exact: with
    integer-valued operands every partial sum is an integer of magnitude
    below 2**24, so the float32 tile loop rounds nothing and equals the
    product bitwise."""
    a, b = inputs["A"], inputs["B"]
    exact = (np.array_equal(a, np.round(a)) and np.array_equal(b, np.round(b))
             and float(np.abs(a).max(initial=0.0))
             * float(np.abs(b).max(initial=0.0)) * shape["k"] < 2.0 ** 24)
    if not exact:
        return sk.oracle(inputs, shape, params)
    m, n, k = shape["m"], shape["n"], shape["k"]
    c = a.reshape(m, k).astype(np.float64) @ b.reshape(k, n).astype(
        np.float64)
    return {"C": c.astype(np.float32).reshape(-1)}


def _hist_expected(sk, inputs, shape, params):
    """The per-group partial histograms in one ``bincount`` over
    (group, bin) pairs: the oracle's counts without its loop over
    groups."""
    n, bins = shape["n"], shape["bins"]
    block = params["lsz"] * params["ipt"]
    ngrp = -(-n // block)
    b = np.clip((inputs["x"] * bins).astype(np.int32), 0, bins - 1)
    grp = np.arange(n) // block
    return {"out": np.bincount(grp * bins + b, minlength=ngrp * bins)
            .astype(np.int32)}


def _spmv_inputs(shape, params):
    """SpMV's inputs with the CSR structure built in array operations:
    the suite's generator builds it row by row (seconds at 2**20 rows)."""
    m, n, max_nnz = shape["m"], shape["n"], shape["max_nnz"]
    counts = (np.arange(m) % max_nnz) + 1
    rowptr = np.zeros(m + 1, np.int32)
    rowptr[1:] = np.cumsum(counts)
    rows = np.repeat(np.arange(m, dtype=np.int64), counts)
    slot = np.arange(len(rows)) - np.repeat(rowptr[:-1].astype(np.int64),
                                            counts)
    cols = ((rows * 3 + slot * 7) % n).astype(np.int32)
    rng = oracles._rng("spmv", shape)
    return {"rowptr": rowptr, "cols": cols,
            "vals": oracles._int_f32(rng, len(cols)),
            "x": oracles._int_f32(rng, n),
            "y": np.zeros(m, np.float32)}


# the suite's inputs and oracle results made faster at card sizes; each
# equals the suite's own bitwise (tests/test_torch_scoreboard.py)
FAST_INPUTS = {"spmv": _spmv_inputs}
FAST_ORACLES = {"gemm": _gemm_expected, "hist": _hist_expected}


def case_inputs(sk: SuiteKernel, shape, params):
    """The suite's inputs for one configuration."""
    return FAST_INPUTS.get(sk.name, sk.make_inputs)(shape, params)


def expected_outputs(sk: SuiteKernel, inputs, shape, params):
    """The oracle's outputs for one configuration's inputs."""
    fast = FAST_ORACLES.get(sk.name)
    if fast is None:
        return sk.oracle(inputs, shape, params)
    return fast(sk, inputs, shape, params)


class Scoreboard:
    """Sweep + verify + price the suite on every compiled target.

    ``table`` persists sweep winners: pass a path-backed
    :class:`TuningTable` and a later Scoreboard over the same table
    re-measures only each cell's winning configuration (``sweep_cached``
    in the cell marks this).  ``max_configs`` trims each tuning space
    (evenly, endpoints kept) for CI-sized runs.  ``targets`` defaults to
    ``loop`` and ``vector`` on the CPU, and ``vector`` and ``cuda`` (with
    ``loop`` at the ``ci`` set) on a CUDA device.  Peaks are calibrated
    at ``calibration_n`` (on a CUDA device at least :data:`CARD_CAL_BW_N`
    and :data:`CARD_CAL_FLOPS_N` for ``vector`` and ``cuda``, at most
    :data:`CARD_CAL_LOOP_N` for ``loop``)."""

    def __init__(self, ctx: Optional[Context] = None,
                 table: Optional[TuningTable] = None,
                 targets: Optional[Sequence[str]] = None,
                 shape_set: str = "full",
                 warmup: int = 1, repeats: int = 3,
                 max_configs: Optional[int] = None,
                 include_coexec: bool = True,
                 include_auto: bool = True,
                 coexec_mode: str = "static",
                 calibration_n: int = 1 << 14):
        self.ctx = ctx if ctx is not None else Context()
        self.table = table if table is not None else TuningTable()
        self.device = self.ctx.devices[0]
        self.on_card = self.device.torch_device.type == "cuda"
        self.absent: Dict[str, str] = {}
        if targets is None:
            targets = ("vector", "cuda") if self.on_card else \
                ("loop", "vector")
            if self.on_card and shape_set == "ci":
                targets = ("loop",) + targets
            elif self.on_card:
                self.absent["loop"] = LOOP_ON_CARD
        self.targets = tuple(targets)
        self.shape_set = shape_set
        self.warmup = int(warmup)
        self.repeats = int(repeats)
        self.max_configs = max_configs
        self.include_coexec = include_coexec
        self.include_auto = include_auto
        self.coexec_mode = coexec_mode
        self.calibration_n = int(calibration_n)
        # the column coexec2 and its peaks come from
        self.coexec_base = "cuda" if self.on_card else "vector"
        self._co = None          # lazy: created once, devices are appended
        self._clock = _DeviceClock(self.device.torch_device) \
            if self.on_card else None
        self._cases: Dict[str, tuple] = {}
        # by target; a target whose peaks are set before run() (another
        # board's, calibrated on the same device) is not calibrated again
        self.peaks: Dict[str, Dict[str, float]] = {}
        self.calibration: Dict[str, Dict[str, int]] = {}

    # -- internals ----------------------------------------------------------

    def _case(self, sk: SuiteKernel, shape, params):
        """(inputs, expected outputs) of one configuration, made once per
        kernel row and shared by its columns."""
        key = param_key(params)
        if key not in self._cases:
            inputs = case_inputs(sk, shape, params)
            self._cases[key] = (inputs, expected_outputs(sk, inputs, shape,
                                                         params))
        return self._cases[key]

    def _kernel_obj(self, sk: SuiteKernel, shape, params, inputs):
        prog = self.ctx.create_program(sk.build(shape, params))
        kern = prog.create_kernel()
        kern.set_args(**inputs)
        return kern

    def _bitwise(self, out, expected) -> bool:
        def host(v):
            return v.cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
        return all(host(out[name]).tobytes() == exp.tobytes()
                   for name, exp in expected.items())

    def _measure(self, sk: SuiteKernel, shape, params, *,
                 target: Optional[str] = None, device=None, co=None):
        """One configuration: build, launch, time, bitwise-check.
        Returns (time_s, wall_s, bitwise, kernel); on a CUDA device
        ``time_s`` is the device time of the binary (the co-executor's
        wall time for ``co``), elsewhere the wall time."""
        inputs, expected = self._case(sk, shape, params)
        kern = self._kernel_obj(sk, shape, params, inputs)
        gsz, lsz = sk.launch_dims(shape, params)
        if co is not None:
            run = lambda: co.launch(kern, gsz, lsz, mode=self.coexec_mode)
        else:
            def run():
                out = self.ctx.launch(kern, gsz, lsz, device=device,
                                      target=target)
                if self.on_card:
                    torch.cuda.synchronize(self.device.torch_device)
                return out
        if co is not None or not self.on_card:
            wall, out = _time(run, self.warmup, self.repeats)
            return wall, wall, self._bitwise(out, expected), kern
        # on the card: the binary specialized and its library loaded
        # before any timed launch; a cuda kernel's first launch loads its
        # module (CUDA loads modules lazily) and the auto device's tunes,
        # so those warm up at least once (the torch targets as asked)
        binary = kern.bind(device or self.device, lsz, target=target)
        load = getattr(getattr(binary, "prog", None), "load", None)
        if load is not None:
            load()
        bufs = _resident(inputs, self.device.torch_device)
        _, scalars = kern.launch_args()
        t = self._clock(lambda: binary.launch_ndrange(bufs, gsz, scalars),
                        max(self.warmup, 1) if target in ("cuda", None)
                        else self.warmup, self.repeats)
        del bufs
        # the device launches warmed the wall run up
        wall, out = _best_wall(run, 1)
        return t, wall, self._bitwise(out, expected), kern

    def _roofline(self, sk: SuiteKernel, shape, target: str, time_s: float,
                  peaks: Dict[str, float]):
        return kernel_report(
            kernel=sk.name, target=target,
            flops=sk.flops(shape), bytes_moved=sk.bytes_moved(shape),
            time_s=max(time_s, 1e-12),
            peak_flops=peaks["peak_flops"],
            peak_bw=peaks["peak_bw"]).to_dict()

    def _cell(self, sk, shape, target, params, t, wall, ok, peaks):
        """The keys every cell has: the reference's, and on a CUDA device
        the wall time and the data-sheet fraction."""
        cell = {
            "target": target,
            "params": dict(params),
            "config": param_key(params),
            "time_us": t * 1e6,
            "bitwise": bool(ok),
            "roofline": self._roofline(sk, shape, target, t, peaks),
        }
        if self.on_card:
            cell["wall_us"] = wall * 1e6
            cell["fraction_datasheet"] = self._roofline(
                sk, shape, target, t, DATASHEET)["fraction"]
        return cell

    def _sweep_cell(self, sk: SuiteKernel, shape, space, target: str):
        """Full sweep (or warm re-measure of the persisted winner) for
        one (kernel, target) cell."""
        key = TuningTable.make_sweep_key(sk.name, target, param_key(shape))
        space_keys = {param_key(p): p for p in space}
        cached = self.table.get_sweep(key)
        use_cache = (cached is not None
                     and param_key(cached["params"]) in space_keys
                     and set(cached["timings_us"]) == set(space_keys))
        if use_cache:
            params = space_keys[param_key(cached["params"])]
            timings = dict(cached["timings_us"])
            t, wall, bitwise, _ = self._measure(sk, shape, params,
                                                target=target)
        else:
            timings, results = {}, {}
            bitwise = True
            for params in space:
                t, wall, ok, _ = self._measure(sk, shape, params,
                                               target=target)
                timings[param_key(params)] = t * 1e6
                results[param_key(params)] = (t, wall, params)
                bitwise = bitwise and ok
            best_key = min(timings, key=timings.get)
            t, wall, params = results[best_key]
            self.table.record_sweep(key, params, timings)
        worst_us = max(timings.values())
        best_us = min(timings.values())
        cell = self._cell(sk, shape, target, params, t, wall, bitwise,
                          self.peaks[target])
        cell.update(timings_us=timings, best_us=best_us, worst_us=worst_us,
                    speedup_vs_worst=worst_us / max(best_us, 1e-9),
                    sweep_cached=bool(use_cache))
        return cell

    def coexec_peaks(self, devices) -> Dict[str, float]:
        """coexec2's peaks: the base column's, once per distinct torch
        device among ``devices`` (C.13: co-devices of one card or one
        CPU share its SMs or cores and its memory)."""
        n = len({d.torch_device for d in devices})
        return {k: n * v for k, v in self.peaks[self.coexec_base].items()}

    def _coexec_cell(self, sk: SuiteKernel, shape, base_cell):
        if self._co is None:
            devs = self.ctx.platform.co_devices(2, driver=self.coexec_base)
            self._co = self.ctx.create_co_executor(devs)
        params = base_cell["params"]
        t, wall, ok, _ = self._measure(sk, shape, params, co=self._co)
        cell = self._cell(sk, shape, "coexec2", params, t, wall, ok,
                          self.coexec_peaks(self._co.devices))
        cell[f"speedup_vs_{self.coexec_base}"] = \
            base_cell["time_us"] / max(t * 1e6, 1e-9)
        return cell

    def _auto_cell(self, sk: SuiteKernel, shape, space):
        autos = self.ctx.platform.get_devices("auto")
        if not autos:
            return None
        params = space[0]
        set_default_table(self.table)
        try:
            t, wall, ok, kern = self._measure(sk, shape, params,
                                              device=autos[0])
        finally:
            set_default_table(None)
        chosen = None
        for k, ent in getattr(self.table, "_winners", {}).items():
            if k.startswith(kern.ir_hash):
                chosen = ent.get("target")
                break
        base = self.peaks.get(chosen) or self.peaks.get("vector") \
            or next(iter(self.peaks.values()))
        cell = self._cell(sk, shape, "auto", params, t, wall, ok, base)
        cell["chosen_target"] = chosen
        return cell

    def _calibrate(self, target: str) -> None:
        n = flops_n = self.calibration_n
        sizes = (_CAL_LSZ,)
        if self.on_card and target == "loop":
            n = flops_n = min(n, CARD_CAL_LOOP_N)
        elif self.on_card:
            n, flops_n = max(n, CARD_CAL_BW_N), max(n, CARD_CAL_FLOPS_N)
            sizes = CARD_CAL_LSZ
        by_lsz = {lsz: calibrate(self.ctx, target, n=n, flops_n=flops_n,
                                 lsz=lsz, warmup=self.warmup,
                                 repeats=self.repeats, clock=self._clock)
                  for lsz in sizes}
        best = {k: max(by_lsz, key=lambda lsz: by_lsz[lsz][k])
                for k in ("peak_flops", "peak_bw")}
        self.peaks[target] = {k: by_lsz[lsz][k] for k, lsz in best.items()}
        self.calibration[target] = {
            "peak_bw_n": n, "peak_flops_n": flops_n,
            "local_size": best,
            "by_local_size": {str(l): p for l, p in by_lsz.items()}}

    # -- entry point --------------------------------------------------------

    def cuda_binaries(self, kernels: Optional[Sequence[str]] = None) -> List:
        """The ``cuda`` binaries a run over ``kernels`` launches (none
        when ``cuda`` is not a column), bound to this board's device, so
        that their libraries build in one parallel ``nvcc`` wave."""
        if "cuda" not in self.targets:
            return []
        sizes = CARD_CAL_LSZ if self.on_card else (_CAL_LSZ,)
        out = [self.ctx.create_program(b).create_kernel().bind(
            self.device, (lsz,), target="cuda")
            for b in CAL_BUILDERS.values() for lsz in sizes]
        for name in kernels or SUITE:
            sk = SUITE[name]
            shape = shape_for(sk, self.shape_set)
            for params in _subsample(sk.space(shape), self.max_configs):
                kern = self.ctx.create_program(
                    sk.build(shape, params)).create_kernel()
                out.append(kern.bind(self.device,
                                     sk.launch_dims(shape, params)[1],
                                     target="cuda"))
        return out

    def run(self, kernels: Optional[Sequence[str]] = None) -> Dict:
        names = list(kernels) if kernels else list(SUITE)
        for name in names:
            SUITE[name]                 # an unknown kernel raises KeyError
        if self.shape_set == "card" and not self.on_card:
            raise InvalidArgError("the card shape set needs a CUDA device")
        build_many(b.prog for b in self.cuda_binaries(names))
        for tgt in self.targets:
            if tgt not in self.peaks:
                self._calibrate(tgt)
        if self.include_coexec and self.coexec_base in self.targets \
                and self.coexec_base not in self.peaks:
            self._calibrate(self.coexec_base)
        report = {
            "schema": SCHEMA,
            "shape_set": self.shape_set,
            "repeats": self.repeats,
            "targets": list(self.targets),
            "peaks": {t: {"peak_flops": p["peak_flops"],
                          "peak_bw": p["peak_bw"],
                          "gflops": p["peak_flops"] / 1e9,
                          "gbs": p["peak_bw"] / 1e9}
                      for t, p in self.peaks.items()},
            "kernels": {},
        }
        if self.on_card:
            report.update(
                device=torch.cuda.get_device_name(self.device.torch_device),
                timing="time_us: CUDA events on device-resident tensors, "
                       "L2 flushed; wall_us: host clock around "
                       "Context.launch and a synchronize",
                datasheet={**DATASHEET,
                           "gflops": DATASHEET["peak_flops"] / 1e9,
                           "gbs": DATASHEET["peak_bw"] / 1e9},
                calibration=dict(self.calibration))
        if self.absent:
            report["absent"] = dict(self.absent)
        for name in names:
            sk = SUITE[name]
            shape = shape_for(sk, self.shape_set)
            space = _subsample(sk.space(shape), self.max_configs)
            self._cases = {}
            cells = {}
            for tgt in self.targets:
                cells[tgt] = self._sweep_cell(sk, shape, space, tgt)
            if self.include_coexec and self.coexec_base in cells:
                cells["coexec2"] = self._coexec_cell(sk, shape,
                                                     cells[self.coexec_base])
            if self.include_auto:
                auto = self._auto_cell(sk, shape, space)
                if auto is not None:
                    cells["auto"] = auto
            self._cases = {}
            report["kernels"][name] = {
                "shape": dict(shape),
                "space_size": len(space),
                "flops": sk.flops(shape),
                "bytes": sk.bytes_moved(shape),
                "cells": cells,
            }
        if self._co is not None:
            self._co.finish()
        report["above_roofline"] = [
            f"{name}/{tgt}: {cell['roofline']['fraction']:.4f}"
            for name, ent in report["kernels"].items()
            for tgt, cell in ent["cells"].items()
            if not cell["roofline"]["fraction"] <= 1.0]
        report["gates"] = check_gates(report)
        return report


def check_gates(report: Dict, min_fraction: float = 0.0,
                fraction_target: str = "vector") -> Dict:
    """The scoreboard's pass/fail verdicts.

    * ``bitwise`` — every cell's winner reproduced the NumPy oracle
      bitwise (conformance; always enforced);
    * ``winner_beats_worst`` — in every swept cell the autotuned
      configuration's time is the minimum of its sweep, strictly below
      the worst when the sweep measured more than one configuration;
    * ``min_fraction`` — every kernel's achieved-vs-roofline fraction on
      ``fraction_target`` reaches ``min_fraction`` (0 disables).
    """
    bitwise_bad, beats_bad, frac_bad = [], [], []
    for name, ent in report.get("kernels", {}).items():
        for tgt, cell in ent["cells"].items():
            if not cell.get("bitwise", False):
                bitwise_bad.append(f"{name}/{tgt}")
            timings = cell.get("timings_us")
            if timings:
                best = min(timings.values())
                worst = max(timings.values())
                if cell["best_us"] != best or \
                        (len(timings) > 1 and not best <= worst):
                    beats_bad.append(f"{name}/{tgt}")
        cell = ent["cells"].get(fraction_target)
        if min_fraction > 0 and cell is not None:
            frac = cell["roofline"]["fraction"]
            if not frac >= min_fraction:
                frac_bad.append(f"{name}: {frac:.4f} < {min_fraction}")
    return {
        "bitwise": not bitwise_bad,
        "bitwise_failures": bitwise_bad,
        "winner_beats_worst": not beats_bad,
        "winner_failures": beats_bad,
        "min_fraction": min_fraction,
        "fraction_target": fraction_target,
        "fraction_ok": not frac_bad,
        "fraction_failures": frac_bad,
        "ok": not (bitwise_bad or beats_bad or frac_bad),
    }


def render_markdown(report: Dict) -> str:
    """The (kernel x target) matrix as a GitHub-flavored markdown table:
    one row per kernel, one column per target, each cell showing the
    achieved-vs-roofline fraction, the winning time and configuration."""
    targets = list(report.get("targets", []))
    extras = []
    for ent in report.get("kernels", {}).values():
        for tgt in ent["cells"]:
            if tgt not in targets and tgt not in extras:
                extras.append(tgt)
    cols = targets + extras
    lines = [
        "# Performance-portability scoreboard",
        "",
        f"Shape set `{report.get('shape_set')}`; cells show "
        "achieved-vs-roofline fraction, winner time, winning config "
        "(docs/scoreboard.md).",
        "",
        "Calibrated peaks: " + "; ".join(
            f"{t} {p['gflops']:.2f} GFLOP/s / {p['gbs']:.2f} GB/s"
            for t, p in report.get("peaks", {}).items()),
        "",
        "| kernel | " + " | ".join(cols) + " |",
        "|---" * (len(cols) + 1) + "|",
    ]
    for name, ent in report.get("kernels", {}).items():
        row = [name]
        for tgt in cols:
            cell = ent["cells"].get(tgt)
            if cell is None:
                row.append("—")
                continue
            frac = cell["roofline"]["fraction"]
            mark = "" if cell.get("bitwise") else " ✗oracle"
            row.append(f"{frac:.3f} · {cell['time_us']:.0f}µs · "
                       f"`{cell['config']}`{mark}")
        lines.append("| " + " | ".join(row) + " |")
    gates = report.get("gates", {})
    lines += ["", f"Gates: bitwise={gates.get('bitwise')} "
                  f"winner_beats_worst={gates.get('winner_beats_worst')} "
                  f"fraction_ok={gates.get('fraction_ok')}"]
    return "\n".join(lines) + "\n"


__all__ = ["CARD_SHAPES", "DATASHEET", "SCHEMA", "Scoreboard", "calibrate",
           "case_inputs", "check_gates", "expected_outputs",
           "render_markdown", "shape_for"]
