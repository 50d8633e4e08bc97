"""Roofline terms of a whole step, and of one DSL suite kernel.

The port of ``repro.launch.roofline``.  The model half prices one step
of the dry-run (:mod:`.dryrun`) on one device of a mesh:

  compute    = FLOPs      / peak_FLOP/s
  memory     = bytes      / HBM_bw
  collective = coll_bytes / link_bw

against the H100's data sheet (:data:`.mesh.HW`).  Where the reference
read FLOPs and bytes from XLA's ``cost_analysis`` and parsed collective
bytes out of the partitioned HLO text, the port traces the step itself
on one device's shards with a dispatch mode of its own
(:class:`StepTrace`): each operator's FLOPs by
``torch.utils.flop_counter``'s formulas, the bytes it reads and writes,
and each collective's count and bytes.  The analytic model FLOPs
(:func:`model_flops`, :func:`executed_flops`), active parameters and
irreducible bytes (:func:`ideal_bytes`) are the reference's.

:class:`KernelRoofline` and :func:`kernel_report` price one DSL suite
kernel, as the scoreboard (:mod:`repro_torch.suite.scoreboard`) does
each cell.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict

import numpy as np
import torch
from torch._guards import active_fake_mode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary
from torch.utils._pytree import tree_flatten

from .mesh import HW

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the functional collectives DTensor issues, by the reference's kinds
_COLL_OPS = {"all_gather_into_tensor": "all-gather",
             "all_reduce": "all-reduce",
             "reduce_scatter_tensor": "reduce-scatter",
             "all_to_all_single": "all-to-all",
             "shard_dim_alltoall": "all-to-all"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


class StepTrace(TorchDispatchMode):
    """Counts what one device does in a step: the bytes it holds at its
    peak (each storage an operator makes, from its birth to its death,
    beside the ``held`` arguments), the FLOPs of each operator
    on its local tensors (by ``torch.utils.flop_counter``'s formulas, the
    table ``FlopCounterMode`` reads; that mode itself sees a DTensor's
    global shape), the bytes each operator reads and writes (its tensor
    inputs and outputs, once each; views move nothing and count
    nothing), and each functional collective's output bytes by kind: the
    counterparts of XLA's ``flops``, ``bytes accessed`` and the
    collective bytes the reference parsed out of the HLO.  A DTensor
    operator is left to DTensor, so the mode sees the local operators it
    turns into (as ``MemTracker`` does)."""

    def __init__(self, held=()):
        super().__init__()
        # DTensor's sharding propagation runs operators on fake tensors
        # of the global shapes in a fake mode of its own: those are
        # skipped by the fake mode that was active on entry
        self._fake_on_entry = active_fake_mode()
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVES}
        self.coll_count = {k: 0 for k in COLLECTIVES}
        self._live = WeakIdKeyDictionary()
        self.live_bytes = self.peak_bytes = 0
        for t in held:
            self._hold(t)

    def _hold(self, t) -> None:
        """Count ``t``'s storage as live until it is freed: the device's
        bytes in use, whose high mark is :attr:`peak_bytes`.  (PyTorch
        2.13's ``MemTracker`` skips the propagation's tensors the same
        way; 2.11's counts them, global shapes and all.)"""
        if not isinstance(t, torch.Tensor):
            return
        st = t.untyped_storage()
        if st in self._live:
            return
        n = st.nbytes()
        self._live[st] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live_bytes -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(t is DTensor for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake_on_entry:
            return out
        for o in tree_flatten(out)[0]:
            self._hold(o)
        packet = func.overloadpacket
        kind = _COLL_OPS.get(packet.__name__)
        if kind is not None:
            self.coll_bytes[kind] += sum(_nbytes(o)
                                         for o in tree_flatten(out)[0])
            self.coll_count[kind] += 1
            return out
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        if not func.is_view and packet.__name__ not in ("wait_tensor",
                                                         "detach"):
            ins = tree_flatten((args, kwargs))[0]
            self.bytes_accessed += sum(_nbytes(x) for x in ins) \
                + sum(_nbytes(o) for o in tree_flatten(out)[0])
        return out

    def collectives(self) -> Dict:
        return {"bytes": dict(self.coll_bytes),
                "count": dict(self.coll_count),
                "total_bytes": sum(self.coll_bytes.values())}


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


@dataclasses.dataclass
class RooflineReport:
    """One step of one cell on one device of the mesh.  The ``hlo_*``
    fields keep the reference's names; in the port they are the traced
    step's counts (:class:`StepTrace`), per device."""
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float             # per-chip
    hlo_gbytes: float             # per-chip
    coll_gbytes: float            # per-chip
    t_compute: float              # seconds
    t_memory: float
    t_collective: float
    model_gflops_per_chip: float  # 6ND useful flops, per chip per step
    bytes_per_device: float       # the traced step's peak (StepTrace)
    coll_counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    coll_bytes_by_kind: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    kind: str = "train"           # train | prefill | decode
    ideal_gbytes: float = 0.0     # per-chip: params + caches + tokens once
    executed_gflops_per_chip: float = 0.0   # useful + remat re-forward
    # the reference's CPU-backend bf16->f32 dot copies; the port lowers
    # nothing for a CPU (its trace is of the card's own operators), so
    # there is no such artifact to take out
    cpu_artifact_gbytes: float = 0.0

    @property
    def hlo_gbytes_adj(self) -> float:
        """Traced bytes, floored at the irreducible bytes."""
        return max(self.hlo_gbytes - self.cpu_artifact_gbytes,
                   self.ideal_gbytes, 0.0)

    @property
    def t_memory_adj(self) -> float:
        return self.hlo_gbytes_adj * 1e9 / HW["hbm_bw"]

    @property
    def t_compute_eff(self) -> float:
        """max(traced, EXECUTED) FLOPs over the peak: the analytic
        executed FLOPs (useful + remat re-forward + attention/SSD terms)
        floor the traced count, as in the reference."""
        t_model = self.executed_gflops_per_chip * 1e9 \
            / HW["peak_flops_bf16"]
        return max(self.t_compute, t_model)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute_eff, "memory": self.t_memory_adj,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute_eff, self.t_memory_adj,
                   self.t_collective)

    @property
    def useful_flop_ratio(self) -> float:
        return self.model_gflops_per_chip / max(self.hlo_gflops, 1e-9)

    @property
    def bw_fraction(self) -> float:
        """Fraction of HBM traffic that is irreducible (params + caches +
        tokens read exactly once)."""
        return min(1.0, self.ideal_gbytes / max(self.hlo_gbytes_adj, 1e-9))

    @property
    def roofline_fraction(self) -> float:
        """Compute-bound kinds (train/prefill): useful-compute time over
        the binding-resource time.  Memory-bound kinds (decode): fraction
        of the irreducible HBM traffic."""
        if self.kind == "decode":
            t_ideal = self.ideal_gbytes * 1e9 / HW["hbm_bw"]
            return min(1.0, t_ideal / max(self.t_bound, 1e-12))
        t_useful = self.model_gflops_per_chip * 1e9 / HW["peak_flops_bf16"]
        return t_useful / max(self.t_bound, 1e-12)

    def to_dict(self):
        d = dataclasses.asdict(self)
        d.update(dominant=self.dominant,
                 useful_flop_ratio=self.useful_flop_ratio,
                 roofline_fraction=self.roofline_fraction,
                 bw_fraction=self.bw_fraction,
                 t_compute_eff=self.t_compute_eff,
                 t_memory_adj=self.t_memory_adj,
                 hlo_gbytes_adj=self.hlo_gbytes_adj,
                 t_bound=self.t_bound)
        return d


def model_flops(cfg, shape, n_params_active: int, mode: str) -> float:
    """USEFUL model FLOPs per step: 6·N·D train / 2·N·D inference, plus
    the attention (and SSD) FLOPs that 6ND does not count.  ``mode``
    overrides the shape kind (the remat re-forward is a prefill-shaped
    pass over the train shape)."""
    if mode == "decode":
        tokens = shape.global_batch
        mult = 2.0
    else:
        tokens = shape.global_batch * shape.seq_len
        mult = 6.0 if mode == "train" else 2.0
    base = mult * n_params_active * tokens
    return base + _mixer_flops(cfg, shape, mode)


def _mixer_flops(cfg, shape, mode) -> float:
    """Attention score/value + SSD flops (not captured by 6ND)."""
    B, S = shape.global_batch, shape.seq_len
    fb = 3.0 if mode == "train" else 1.0    # fwd(+bwd=2x)
    H, hd = cfg.n_heads, cfg.hd
    total = 0.0
    if mode == "decode":
        # one query token against the full cache
        att_layers = _attn_layers(cfg)
        total += att_layers * 4.0 * B * S * H * hd
        return total
    att_layers = _attn_layers(cfg)
    # causal self-attention: 2 matmuls x 2 flops x half the S^2 triangle
    total += att_layers * 2.0 * B * S * S * H * hd * fb
    if cfg.family == "vlm":
        ncross = cfg.n_layers // cfg.cross_attn_every
        total += ncross * 4.0 * B * S * cfg.n_img_tokens * H * hd * fb
    if cfg.family == "encdec":
        total += cfg.enc_layers * 4.0 * B * cfg.enc_seq ** 2 * H * hd * fb
        total += cfg.n_layers * 4.0 * B * S * cfg.enc_seq * H * hd * fb
    if cfg.family in ("ssm", "hybrid"):
        Hs, P, N, ch = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state,
                        cfg.ssm_chunk)
        # per token per layer: intra-chunk (~2·ch·(N+P)) + states (~4·P·N)
        per_tok = 2.0 * ch * (N + P) + 4.0 * P * N
        total += cfg.n_layers * B * S * Hs * per_tok * fb
    return total


def _attn_layers(cfg) -> int:
    if cfg.family in ("dense", "moe", "vlm", "encdec"):
        return cfg.n_layers
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return 0


def executed_flops(cfg, shape, n_params_active: int) -> float:
    """EXECUTED compute: useful flops plus the remat re-forward (block
    remat recomputes the forward during backward: +2ND on top of 6ND)."""
    useful = model_flops(cfg, shape, n_params_active, shape.kind)
    if shape.kind == "train" and cfg.remat in ("block", "full"):
        refwd = model_flops(cfg, shape, n_params_active, "prefill")
        return useful + refwd
    return useful   # remat="dots" recomputes no matmuls


def active_params(cfg) -> int:
    """Parameter count with only top-k experts active (MoE)."""
    from ..models import model_defs
    from ..training.tree import leaves_with_paths

    total = 0
    for path, d in leaves_with_paths(model_defs(cfg)):
        n = int(np.prod(d.shape))
        keys = path.split("/")
        if cfg.family == "moe" and any(k in ("w_up", "w_gate", "w_down")
                                       for k in keys) \
                and "ffn" in keys:
            n = n * cfg.top_k // cfg.n_experts
        total += n
    return total


def ideal_bytes(cfg, shape, chips: int) -> float:
    """Irreducible per-chip HBM traffic for one step: every (active)
    parameter byte once (bf16 for serve, bf16 weights + f32 opt update
    traffic for train), plus KV/state caches read+written once (decode),
    plus the token activations once."""
    from ..models import init_caches, model_defs
    from ..models.params import count_params
    from ..training.tree import leaves_with_paths

    n = count_params(model_defs(cfg))
    B, S = shape.global_batch, shape.seq_len
    act = B * S * cfg.d_model * 2 if shape.kind != "decode" \
        else B * cfg.d_model * 2
    if shape.kind == "train":
        # fwd read (bf16 cast) + bwd read + grad write + opt read/write f32
        pbytes = n * (2 + 2 + 4 + 3 * 4)
        return (pbytes + 4 * act) / chips
    pbytes = n * 2
    cbytes = 0
    if shape.kind == "decode":
        caches = init_caches(cfg, B, S, device="meta")
        cbytes = sum(_nbytes(x) for _, x in leaves_with_paths(caches))
    return (pbytes + cbytes + act) / chips


def build_report(*, arch: str, shape, mesh_name: str, chips: int,
                 cost: Dict, mem_bytes: float, coll: Dict,
                 cfg) -> RooflineReport:
    """The step's report from its traced ``cost`` (``flops`` and ``bytes
    accessed``, per device), its peak bytes and its collectives
    (:meth:`StepTrace.collectives`)."""
    flops = float(cost.get("flops", 0.0))
    byts = float(cost.get("bytes accessed", 0.0))
    na = active_params(cfg)
    mf = model_flops(cfg, shape, na, shape.kind) / chips
    ef = executed_flops(cfg, shape, na) / chips
    return RooflineReport(
        arch=arch, shape=shape.name, mesh=mesh_name, chips=chips,
        hlo_gflops=flops / 1e9, hlo_gbytes=byts / 1e9,
        coll_gbytes=coll["total_bytes"] / 1e9,
        t_compute=flops / HW["peak_flops_bf16"],
        t_memory=byts / HW["hbm_bw"],
        t_collective=coll["total_bytes"] / HW["link_bw"],
        model_gflops_per_chip=mf / 1e9,
        executed_gflops_per_chip=ef / 1e9,
        bytes_per_device=mem_bytes,
        kind=shape.kind,
        ideal_gbytes=ideal_bytes(cfg, shape, chips) / 1e9,
        cpu_artifact_gbytes=0.0,
        coll_counts=coll["count"], coll_bytes_by_kind=coll["bytes"])


__all__ = ["COLLECTIVES", "KernelRoofline", "RooflineReport", "StepTrace",
           "active_params", "build_report", "executed_flops", "ideal_bytes",
           "kernel_report", "model_flops"]
