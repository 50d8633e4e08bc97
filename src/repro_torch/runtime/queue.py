"""Command queues over an explicit event dependency DAG (paper §2/§3).

The port of ``repro.runtime.queue``.  Commands (kernel launches, buffer
reads/writes and maps, native host functions) are enqueued with optional
``wait_for`` event lists and return an
:class:`~repro_torch.runtime.events.Event`.  In-order queues add an
implicit dependency on the previously enqueued command; out-of-order
queues execute any command whose dependencies are resolved.

Scheduling is **push-based**: ``flush()`` submits every flushed command
whose wait list is already resolved, and each event completion decrements
its dependents' outstanding-dependency counters, submitting newly-ready
commands from the completing thread — no polling loop.  A failing command
terminates its event with the error and every transitive dependent fails
with ``DependencyError`` without running.

Buffers live in device memory (:class:`~repro_torch.runtime.platform.
Buffer`), and kernel launches run **in place** on their tensors (a
sub-buffer's ``narrow`` view included) with no host round trip.  Work on
a CUDA device is asynchronous, so a command that touches one — a
transfer, a map or unmap, a kernel launch — records a CUDA event on the
worker thread's current stream of that device and waits for it before
its own :class:`Event` completes: ``Event.wait()``, cross-queue
``wait_for`` and ``end_ns`` all see work the card has finished.

``enqueue_nd_range`` specializes the work-group function at enqueue time
(paper §4.1) through the device's compilation cache — the first enqueue
compiles, every later enqueue of the same kernel/local-size is a hash
lookup.  ``self.stats`` counts launches, enqueue-time compiles and chains
that failed IR stitching.

``enqueue_map_buffer``/``enqueue_unmap_buffer`` put host access on the
same DAG through a host bounce (:class:`~repro_torch.runtime.memory.
MappedRegion`): the map copies the span to a host staging array and
publishes a numpy view of it, the unmap of a writable map copies it back
and publishes the write span to the residency tracker, and launches (or
device-side writes) over an allocation with *any* active map are
rejected with :class:`MapError`.

**Kernel fusion**: because the queue sees the whole pending DAG before
execution, ``flush()`` runs a graph optimizer over the enqueue window:
adjacent producer→consumer chains of elementwise kernels (same NDRange,
the consumer's only dependence on the producer a buffer it wrote, every
region ``wi_parallel``) are rewritten into ONE stitched command
(:mod:`repro_torch.core.fusion`), eliding intermediate buffers whose only
use was the stitched-away link.  On a ``cuda`` device the stitched
function goes through the ordinary plan tier and the ``cuda`` target:
one ``nvcc`` build per distinct chain, cached by digest.  The original
per-kernel events stay live — they complete (or fail) when the fused
command does, sharing its profiling counters — so dependents and
``finish()`` observe an unchanged DAG.  A chain that fails IR stitching
(:class:`FusionError`) runs unfused; a build or launch error of the
fused kernel fails the fused event and its originals.
``fusion="off"|"flush"|"eager"`` selects the mode per queue;
``REPRO_FUSE=0`` kills it process-wide.
"""

from __future__ import annotations

import os
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.api import CompiledKernel
from ..core.errors import InvalidArgError
from ..core.fusion import (ChainEdge, FusedSpec, FusionError,
                           build_fused_spec, make_fused_key)
from ..core.passes import KernelFusibility, kernel_fusibility
from ..core.program import Kernel
from .events import (CommandError, DependencyError, Event, EventStatus,
                     UserEvent, wait_for_events)
from .memory import MAP_READ_WRITE, MAP_WRITE_INVALIDATE, MapError, \
    MappedRegion
from .platform import Buffer, Device

#: queue fusion modes: "off" never rewrites, "flush" rewrites the window
#: at flush()/finish() time, "eager" additionally pre-stitches the
#: growing chain during the enqueue window (warm caches before flush)
FUSION_MODES = ("off", "flush", "eager")


def _fusion_enabled() -> bool:
    """The REPRO_FUSE kill-switch, read at fusion time (not import time)
    so tests and operators can flip it per call."""
    return os.environ.get("REPRO_FUSE", "1") != "0"


def _settle(device: torch.device) -> None:
    """Return once the card has finished the work this thread queued on
    ``device``'s current stream (nothing to wait for off CUDA)."""
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()


class _Command:
    """One node of the DAG: a host thunk plus its event and wait list."""

    __slots__ = ("fn", "event", "deps", "remaining", "submitted",
                 "failed_dep", "meta")

    def __init__(self, fn: Callable[[], None], event: Event,
                 deps: Sequence[Event], meta=None):
        self.fn = fn
        self.event = event
        self.deps: List[Event] = list(deps)
        self.remaining = 0            # unresolved deps (set when armed)
        self.submitted = False
        self.failed_dep: Optional[Event] = None
        # what the fusion matcher knows about this command: a
        # _KernelLaunch (fusible), a _BufferUse (transfer/map — names the
        # buffers it touches), or None (opaque: native/deprecated paths)
        self.meta = meta


class _KernelLaunch:
    """Fusion-matcher metadata for one enqueue_nd_range command: the
    argument snapshot plus the launch geometry, enough to re-stitch the
    kernel from its program's IR builder."""

    __slots__ = ("kernel", "buffers", "scalars", "global_size",
                 "local_size", "target", "group_range")

    def __init__(self, kernel: Kernel, buffers: Dict[str, object],
                 scalars: Dict[str, object], global_size, local_size,
                 target, group_range):
        self.kernel = kernel
        self.buffers = buffers
        self.scalars = scalars
        self.global_size = tuple(global_size)
        self.local_size = tuple(local_size)
        self.target = target
        self.group_range = group_range


class _BufferUse:
    """Fusion-matcher metadata for a non-kernel command that touches
    buffers (transfers, maps): elision legality needs to see *every*
    in-window observer of an intermediate."""

    __slots__ = ("buffers",)

    def __init__(self, *buffers):
        self.buffers = buffers


#: per-ir_hash fusibility facts (kernels are content-addressed, so the
#: facts are process-global); computed from the program's unmutated
#: signature IR — explicit barriers/loops/footprints are all visible
#: there, before normalize adds the implicit region barriers
_fusibility_facts: Dict[str, KernelFusibility] = {}


def _facts_for(kernel: Kernel) -> KernelFusibility:
    h = kernel.ir_hash
    facts = _fusibility_facts.get(h)
    if facts is None:
        facts = kernel_fusibility(kernel.program.function(kernel.name))
        _fusibility_facts[h] = facts
    return facts


class CommandQueue:
    """cl_command_queue analogue: a DAG scheduler over one device.

    Parameters
    ----------
    device:
        The :class:`~repro_torch.runtime.platform.Device` commands
        execute on (and whose compilation cache ``enqueue_nd_range``
        compiles through).
    out_of_order:
        ``False`` (default) chains every command after the previous one —
        clCreateCommandQueue without
        ``CL_QUEUE_OUT_OF_ORDER_EXEC_MODE_ENABLE``.  ``True`` runs any
        command whose ``wait_for`` list is resolved, concurrently up to
        ``workers``.
    workers:
        Size of the worker pool (pocl's pthread launcher threads).
    fusion:
        DAG-fusion mode: ``"off"`` (never rewrite), ``"flush"``
        (default — rewrite the window when it is flushed), or
        ``"eager"`` (also pre-stitch the growing chain at enqueue time,
        so the flush-time rewrite is pure cache hits).  The
        ``REPRO_FUSE=0`` environment kill-switch overrides all modes.
    """

    def __init__(self, device: Device, out_of_order: bool = False,
                 workers: int = 2, fusion: str = "flush"):
        if fusion not in FUSION_MODES:
            raise InvalidArgError(
                f"fusion mode {fusion!r} not in {FUSION_MODES}")
        self.device = device
        self.out_of_order = out_of_order
        self.fusion = fusion
        #: optional live event subscriber (duck-typed ``on_command(event,
        #: deps, queue)``) — the Chrome-trace collector
        #: (:class:`~repro_torch.runtime.trace.ChromeTrace`) attaches here;
        #: ``None`` keeps the enqueue path at zero extra cost
        self.trace_sink = None
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._lock = threading.Lock()
        self._pending: List[_Command] = []     # enqueued, not yet flushed
        self._armed: set = set()               # flushed, deps unresolved
        self._issued: List[Event] = []         # all live events (for finish)
        self._last_event: Optional[Event] = None
        self._ooo_barrier: Optional[Event] = None
        self._launches = 0
        self._compiles0 = device.compile_cache.stats.compiles
        self._fused_chains = 0
        self._commands_eliminated = 0
        self._bytes_elided = 0
        self._stitch_failures = 0

    # -- introspection -----------------------------------------------------------
    @property
    def stats(self) -> Dict[str, int]:
        """Kernel launches (a fused chain is one), pipeline compiles that
        hit this queue's *device* cache since queue creation, and fusion
        chains that failed IR stitching and ran unfused.  The compile
        counter is device-wide: other queues (or direct ``build_kernel``
        calls) on the same device contribute.  Compiles are
        single-flight, so for a single queue the steady state is exactly
        1 per distinct kernel/local-size."""
        with self._lock:
            launches = self._launches
            failures = self._stitch_failures
        return {"launches": launches,
                "enqueue_compiles":
                    self.device.compile_cache.stats.compiles
                    - self._compiles0,
                "stitch_failures": failures}

    def events(self) -> List[Event]:
        """Snapshot of live (not yet pruned) events, in enqueue order."""
        with self._lock:
            return list(self._issued)

    def dag_stats(self) -> Dict[str, object]:
        """Counters of the DAG fusion rewrite: chains stitched, commands removed from the executed DAG
        (original events still complete), and bytes of memory traffic
        elided — one avoided store plus one avoided load per elided
        intermediate buffer."""
        with self._lock:
            return {"mode": self.fusion,
                    "fused_chains": self._fused_chains,
                    "commands_eliminated": self._commands_eliminated,
                    "bytes_elided": self._bytes_elided}

    # -- enqueue APIs -------------------------------------------------------------
    def _enqueue(self, name: str, fn: Callable[[], None],
                 wait_for: Optional[Sequence[Event]],
                 kind: str = "command", meta=None) -> Event:
        """Core enqueue: record a command node and return its event.

        The full ``wait_for`` list is always preserved on the command (an
        in-order queue *adds* the previous command, it never replaces the
        explicit list)."""
        ev = Event(name, queue=self, kind=kind)
        deps = list(wait_for or [])
        with self._lock:
            if not self.out_of_order and self._last_event is not None:
                deps.append(self._last_event)
            if self.out_of_order and self._ooo_barrier is not None:
                if self._ooo_barrier.succeeded:
                    # a completed barrier gates nothing anymore; clearing
                    # it keeps long-lived queues at zero steady-state cost
                    # (a FAILED barrier stays: dependents must still fail)
                    self._ooo_barrier = None
                else:
                    deps.append(self._ooo_barrier)
            cmd = _Command(fn, ev, deps, meta=meta)
            self._pending.append(cmd)
            self._last_event = ev
            self._issued.append(ev)
        sink = self.trace_sink
        if sink is not None:
            sink.on_command(ev, cmd.deps, self)
        if self.fusion == "eager" and isinstance(meta, _KernelLaunch) \
                and _fusion_enabled():
            self._warm_eager()
        return ev

    def enqueue_native(self, fn: Callable[[], None],
                       wait_for: Optional[Sequence[Event]] = None,
                       name: str = "native", kind: str = "native") -> Event:
        """clEnqueueNativeKernel analogue: run a host function as a DAG
        node.  The serving engine builds its rounds out of these."""
        return self._enqueue(name, fn, wait_for, kind=kind)

    @staticmethod
    def _check_not_mapped(buf, what: str) -> None:
        """Reject a device-side write over any active mapped region of
        the buffer's root allocation: the unmap's copy back would
        overwrite it (the host/device race OpenCL leaves undefined is an
        error here, matching the launch guard)."""
        root = buf.root
        lo, hi = buf.origin, buf.origin + buf.nbytes
        with root._map_lock:
            for m in root._maps:
                if m.overlaps(lo, hi):
                    raise MapError(
                        f"{what} overlaps active map {m!r}; unmap before "
                        f"writing the buffer from the device side")

    def enqueue_write_buffer(self, buf: Buffer, host,
                             wait_for=None) -> Event:
        """clEnqueueWriteBuffer: copy ``host`` (an array or tensor of the
        buffer's element count) into the device buffer (for a
        sub-buffer, in place into the parent's span) and publish the
        write to the residency tracker.  ``host`` is read when the
        command runs."""
        def run():
            self._check_not_mapped(buf, "write_buffer")
            buf.data = host
            _settle(buf.device.torch_device)
            buf.mark_written()
        return self._enqueue("write", run, wait_for, kind="transfer",
                             meta=_BufferUse(buf))

    def enqueue_read_buffer(self, buf: Buffer, out: np.ndarray,
                            wait_for=None) -> Event:
        """clEnqueueReadBuffer: copy the device buffer into ``out``, a
        numpy array of its element count."""
        def run():
            out[...] = buf.data.cpu().numpy().reshape(out.shape)
        return self._enqueue("read", run, wait_for, kind="transfer",
                             meta=_BufferUse(buf))

    # -- host access through a bounce (clEnqueueMapBuffer, OpenCL §5.4.2) -------
    def enqueue_map_buffer(self, buf, flags: str = MAP_READ_WRITE,
                           offset: int = 0, nbytes: Optional[int] = None,
                           wait_for: Optional[Sequence[Event]] = None
                           ) -> MappedRegion:
        """clEnqueueMapBuffer: map ``[offset, offset + nbytes)`` of the
        buffer (or sub-buffer) for host access as a DAG command.

        Returns a :class:`~repro_torch.runtime.memory.MappedRegion` whose
        ``event`` completes when the mapping is established: the span has
        been copied into a host staging array (pinned for a CUDA device)
        and ``region.array``, a numpy view of it, is published
        (``region.get()`` waits and returns it).  Flags: ``"r"``,
        ``"w"``, ``"rw"``, or ``"wi"`` (CL_MAP_WRITE_INVALIDATE_REGION) —
        a write-invalidate map skips the read-back sync hook and the copy
        because its contents are undefined until the host writes them.

        Map rules (checked when the command runs, so violations
        propagate as failed events): any number of overlapping *read*
        maps may coexist; a *write* map must not overlap any other
        active map of the same root allocation."""
        region = MappedRegion(buf, offset,
                              buf.nbytes - offset if nbytes is None
                              else nbytes, flags)

        def run():
            root = buf.root
            lo, hi = region.abs_span
            with root._map_lock:
                for m in root._maps:
                    if m.overlaps(lo, hi) and (m.writable
                                               or region.writable):
                        raise MapError(
                            f"map {region.flags!r} [{lo}, {hi}) overlaps "
                            f"active map {m!r} of the same allocation")
                root._maps.append(region)
                region._active = True
            try:
                span = region.span()
                staging = torch.empty(span.numel(), dtype=span.dtype,
                                      pin_memory=span.is_cuda)
                if region.flags != MAP_WRITE_INVALIDATE:
                    if root.on_map_sync is not None:
                        # read-back: make the payload current before
                        # the copy (skipped for WRITE_INVALIDATE)
                        root.on_map_sync(lo, hi)
                    staging.copy_(span)
                    _settle(span.device)
                region._staging = staging
                region.array = staging.numpy()
            except BaseException:
                # roll the registration back: a failed map must not
                # leave a zombie region blocking the span forever
                with root._map_lock:
                    if region in root._maps:
                        root._maps.remove(region)
                    region._active = False
                raise

        region.event = self._enqueue(
            f"map:{flags}:{region.abs_span[0]}-{region.abs_span[1]}",
            run, wait_for, kind="map", meta=_BufferUse(buf))
        return region

    def enqueue_unmap_buffer(self, region: MappedRegion,
                             wait_for: Optional[Sequence[Event]] = None
                             ) -> Event:
        """clEnqueueUnmapMemObject: retire a mapped region as a DAG
        command.  A write-flagged map's staging array is copied back to
        the device, and then the span is published to the residency
        tracker (other device copies become stale over exactly the mapped
        span); the host array is invalidated.  The region stays
        registered, and so blocks launches, until its copy back is
        done."""
        def run():
            root = region.buf.root
            with root._map_lock:
                if not region._active:
                    raise MapError(f"unmap of inactive region {region!r}")
                region._active = False
            try:
                if region.writable:
                    span = region.span()
                    span.copy_(region._staging, non_blocking=True)
                    _settle(span.device)
                    region.buf.mark_written_span(
                        region.offset, region.offset + region.nbytes)
            finally:
                with root._map_lock:
                    root._maps.remove(region)
                region.array = None
                region._staging = None

        ev = self._enqueue(
            f"unmap:{region.abs_span[0]}-{region.abs_span[1]}",
            run, wait_for, kind="map", meta=_BufferUse(region.buf))
        region.unmap_event = ev
        return ev

    def enqueue_ndrange_kernel(self, kernel: CompiledKernel,
                               global_size: Sequence[int],
                               buffers: Dict[str, Buffer],
                               scalars: Optional[Dict[str, object]] = None,
                               wait_for=None,
                               group_range: Optional[Tuple[int, int]] = None
                               ) -> Event:
        """clEnqueueNDRangeKernel: launch a pre-compiled kernel.

        ``group_range=(lo, hi)`` restricts execution to a contiguous range
        of linearized work-groups of the *full* NDRange — the co-execution
        unit a multi-device scheduler fans out."""
        def run():
            self._launch(kernel, buffers, global_size, scalars, group_range)
        return self._enqueue(f"ndrange:{kernel.name}", run, wait_for,
                             kind="kernel")

    def enqueue_nd_range(self, kernel: Kernel,
                         global_size: Sequence[int],
                         local_size: Sequence[int],
                         wait_for: Optional[Sequence[Event]] = None,
                         group_range: Optional[Tuple[int, int]] = None,
                         target: Optional[str] = None) -> Event:
        """clEnqueueNDRangeKernel over a first-class
        :class:`~repro_torch.core.program.Kernel` object.

        Arguments were bound with ``kernel.set_arg``/``set_args`` and
        must be device-resident :class:`Buffer`/:class:`~repro_torch.
        runtime.memory.SubBuffer` objects; they are validated and *snapshotted
        now* (OpenCL: an enqueue captures the kernel's current
        arguments, so mutating or cloning the kernel afterwards never
        races the command).  Specialization for ``local_size`` on this
        queue's device happens when the command runs — the paper's
        enqueue-time work-group-function compilation (§4.1), memoized in
        the device cache, so only the first enqueue compiles."""
        buffers, scalars = kernel.launch_args(accept=("device",))
        meta = _KernelLaunch(kernel, buffers, scalars, global_size,
                             local_size, target, group_range)

        def run():
            binary = kernel.bind(self.device, local_size, target=target)
            self._launch(binary, buffers, global_size, scalars,
                         group_range)
        return self._enqueue(f"ndrange:{kernel.name}", run, wait_for,
                             kind="kernel", meta=meta)

    def enqueue_kernel(self, build, local_size: Sequence[int],
                       global_size: Sequence[int],
                       buffers: Dict[str, Buffer],
                       scalars: Optional[Dict[str, object]] = None,
                       wait_for=None, **opts) -> Event:
        """Deprecated host entry point: compile ``build`` at enqueue
        time and launch it.  Superseded by binding arguments on a
        :class:`~repro_torch.core.program.Kernel` and calling
        :meth:`enqueue_nd_range` — same enqueue-time specialization,
        same device cache, plus typed argument validation."""
        warnings.warn(
            "CommandQueue.enqueue_kernel() is deprecated; create a "
            "Program/Kernel via Context and use enqueue_nd_range",
            DeprecationWarning, stacklevel=2)

        def run():
            kernel = self.device.compile(build, local_size, **opts)
            self._launch(kernel, buffers, global_size, scalars, None)
        return self._enqueue("ndrange:<enqueue-compiled>", run, wait_for,
                             kind="kernel")

    def _launch(self, kernel, buffers: Dict[str, Buffer], global_size,
                scalars, group_range) -> None:
        """Run a compiled kernel in place over device buffers.

        Buffers may be root :class:`Buffer`\\ s or
        :class:`~repro_torch.runtime.memory.SubBuffer` views; each goes
        to the kernel as its tensor (a view's ``narrow`` of the parent's),
        which the launch updates in place: no copy in, no write-back.
        Launching over a buffer whose root allocation has *any* active
        mapped region is rejected: the unmap's copy back would race with
        the kernel's writes — undefined in OpenCL, an error here.
        Arguments that alias one allocation see each other's writes in
        the order the target runs its work-items (ROADMAP C.9)."""
        for name, b in buffers.items():
            self._check_not_mapped(b, f"kernel argument {name!r}")
            if b.device.torch_device != self.device.torch_device:
                raise InvalidArgError(
                    f"kernel argument {name!r} lives on "
                    f"{b.device.torch_device}; this queue's device "
                    f"{self.device.info.name!r} is on "
                    f"{self.device.torch_device}")
        tensors = {k: b.data for k, b in buffers.items()}
        with self._lock:
            self._launches += 1
        kernel.launch_ndrange(tensors, global_size, scalars, group_range)
        _settle(self.device.torch_device)
        # conservative write publication: without kernel-side access
        # metadata every buffer argument counts as written (OpenCL makes
        # the same assumption for cl_mem without read-only flags)
        for b in buffers.values():
            b.mark_written()

    def enqueue_marker(self, wait_for: Optional[Sequence[Event]] = None
                       ) -> Event:
        """clEnqueueMarkerWithWaitList: an empty command that completes
        when ``wait_for`` does — or, with no list, when everything
        enqueued so far has completed.  Markers do not block later
        commands; use them to hand one queue's progress to another."""
        if wait_for is None:
            with self._lock:
                # every live previously-enqueued command: still-pending,
                # flushed-but-running, or complete (resolves instantly)
                wait_for = list(self._issued)
        return self._enqueue("marker", lambda: None, wait_for,
                             kind="marker")

    def enqueue_barrier(self, wait_for: Optional[Sequence[Event]] = None
                        ) -> Event:
        """clEnqueueBarrierWithWaitList: like a marker, but on an
        out-of-order queue every *subsequently enqueued* command also
        waits for it — a synchronization point splitting the DAG into
        before/after."""
        ev = self.enqueue_marker(wait_for)
        ev.name = "queue-barrier"
        if self.out_of_order:
            with self._lock:
                self._ooo_barrier = ev
        return ev

    # -- DAG fusion (the flush-time graph optimizer) ------------------------------
    def _edge_chained(self, prod: _Command, cons: _Command
                      ) -> Optional[List[Tuple[str, str, object]]]:
        """Is ``prod → cons`` a legal fusion edge?  Returns the chained
        buffers as ``(prod_arg, cons_arg, buffer)`` triples (non-empty),
        or ``None`` if the pair must not fuse.

        Legality (the paper's framing — the consumer's only dependence
        on the producer is a buffer the producer wrote, and both are
        pure per-work-item maps):

        * both commands are ``enqueue_nd_range`` launches with identical
          NDRange geometry, target, build options, and no group_range;
        * both kernels are elementwise (:func:`~repro_torch.core.passes.
          kernel_fusibility`: 1-D, loop-free, barrier-free, every
          global access at ``global_id(0)`` — which also makes every
          region ``wi_parallel``);
        * the consumer waits on the producer, and its *other* deps are a
          subset of the producer's own deps (anything else could order
          between the two commands, or deadlock the fused node);
        * ≥1 chained buffer: the identical root Buffer object stored
          exactly once by the producer and only loaded by the consumer,
          unmapped, sized to the NDRange;
        * no cross-argument root aliasing (two distinct arg objects over
          one root allocation, e.g. sub-buffer views) when either kernel
          stores to that root — write-back interleaving would differ
          from the sequential schedule.
        """
        pm, cm = prod.meta, cons.meta
        if not (isinstance(pm, _KernelLaunch)
                and isinstance(cm, _KernelLaunch)):
            return None
        if (pm.global_size != cm.global_size
                or pm.local_size != cm.local_size
                or pm.target != cm.target
                or pm.group_range is not None
                or cm.group_range is not None
                or pm.kernel.program.options != cm.kernel.program.options
                or len(pm.global_size) != 1):
            return None
        if prod.event not in cons.deps:
            return None
        extra = [d for d in cons.deps if d is not prod.event]
        pdeps = set(id(d) for d in prod.deps)
        if any(id(d) not in pdeps for d in extra):
            return None
        pf, cf = _facts_for(pm.kernel), _facts_for(cm.kernel)
        if not (pf.elementwise and cf.elementwise):
            return None
        # root-aliasing audit across the pair
        stores_root = set()
        objs_per_root: Dict[int, set] = {}
        for m, facts in ((pm, pf), (cm, cf)):
            for arg, b in m.buffers.items():
                root = b.root
                objs_per_root.setdefault(id(root), set()).add(id(b))
                fp = facts.footprint(arg)
                if fp is not None and fp.stores:
                    stores_root.add(id(root))
        for rid, objs in objs_per_root.items():
            if len(objs) > 1 and rid in stores_root:
                return None
        chained: List[Tuple[str, str, object]] = []
        for parg, b in pm.buffers.items():
            pfp = pf.footprint(parg)
            if pfp is None or pfp.stores != 1 or not pfp.gid_only:
                continue
            if b.root is not b or b.map_count:
                continue
            if b.n_elems != pm.global_size[0]:
                continue
            for carg, cb in cm.buffers.items():
                if cb is not b:
                    continue
                cfp = cf.footprint(carg)
                if cfp is None or cfp.stores or not cfp.loads \
                        or not cfp.gid_only:
                    chained.clear()
                    return None   # consumer also writes/misuses it
                chained.append((parg, carg, b))
        return chained or None

    def _chain_runs(self, cmds: List[_Command]) -> List[Tuple[int, int]]:
        """Maximal runs ``[i, j]`` (inclusive) of adjacently-fusible
        commands in the window."""
        runs, i = [], 0
        while i < len(cmds):
            j = i
            while j + 1 < len(cmds) \
                    and self._edge_chained(cmds[j], cmds[j + 1]):
                j += 1
            if j > i:
                runs.append((i, j))
            i = j + 1
        return runs

    def _elidable(self, buf, prod_meta: _KernelLaunch,
                  window: List[_Command], chain: List[_Command],
                  seg: int) -> bool:
        """May the chained buffer be elided (never written, never
        allocated)?  Only when nothing else can observe it: it is a
        lazy, still-unmaterialized pool buffer, the producer never loads
        it, no *other* command in the window references its root, and no
        window command is opaque to the matcher (an unannotated native
        command could read anything)."""
        if not (isinstance(buf, Buffer) and buf._pool is not None
                and not buf.materialized):
            return False
        pfp = _facts_for(prod_meta.kernel).footprint(
            next(a for a, b in prod_meta.buffers.items() if b is buf))
        if pfp is None or pfp.loads:
            return False
        producer, consumer = chain[seg], chain[seg + 1]
        for cmd in window:
            if cmd is producer or cmd is consumer:
                continue
            m = cmd.meta
            if isinstance(m, _KernelLaunch):
                uses = m.buffers.values()
            elif isinstance(m, _BufferUse):
                uses = m.buffers
            elif cmd.event.kind == "marker":
                continue
            else:
                return False          # opaque command in the window
            if any(u.root is buf for u in uses):
                return False
        return True

    def _chain_spec(self, chain: List[_Command], window: List[_Command]
                    ) -> Tuple[FusedSpec, list]:
        """The fused spec of ``chain`` (≥2 adjacently-fusible commands of
        ``window``) from the device's fused tier, stitched on a miss, and
        the buffers it elides.  Raises ``FusionError`` where stitching
        fails."""
        metas: List[_KernelLaunch] = [c.meta for c in chain]
        # alias groups: one fused parameter per distinct buffer object
        groups: Dict[int, List[Tuple[int, str]]] = {}
        for i, m in enumerate(metas):
            for arg, b in m.buffers.items():
                groups.setdefault(id(b), []).append((i, arg))
        alias_groups = [g for g in groups.values() if len(g) > 1]
        edges: List[ChainEdge] = []
        elided_bufs = []
        for seg in range(len(chain) - 1):
            for parg, carg, b in self._edge_chained(chain[seg],
                                                    chain[seg + 1]):
                elide = self._elidable(b, metas[seg], window, chain, seg)
                edges.append(ChainEdge(seg, seg + 1, parg, carg, elide))
                if elide:
                    elided_bufs.append(b)
        options = metas[0].kernel.program.options
        spec = build_fused_spec(
            [m.kernel.program.builder(m.kernel.name) for m in metas],
            [m.kernel.name for m in metas], edges, alias_groups,
            cache=self.device.compile_cache,
            key=make_fused_key([m.kernel.ir_hash for m in metas], edges,
                               alias_groups, **options),
            **options)
        return spec, elided_bufs

    def _fuse_chain(self, chain: List[_Command],
                    window: List[_Command]) -> Optional[_Command]:
        """Rewrite ``chain`` (≥2 adjacently-fusible commands) into one
        stitched command, or ``None`` to fall back to unfused."""
        metas: List[_KernelLaunch] = [c.meta for c in chain]
        names = [m.kernel.name for m in metas]
        try:
            spec, elided_bufs = self._chain_spec(chain, window)
        except FusionError:
            with self._lock:
                self._stitch_failures += 1
            return None
        global_size = metas[0].global_size
        local_size = metas[0].local_size
        target = metas[0].target
        fev = Event("fused:" + "+".join(names), queue=self, kind="kernel")
        fev.fused_from = [c.event for c in chain]

        def run():
            binary = spec.program.binary_for(
                spec.kernel_name, local_size, device=self.device,
                target=target)
            fbufs, fscal = spec.bind_launch(
                [m.buffers for m in metas], [m.scalars for m in metas])
            self._launch(binary, fbufs, global_size, fscal, None)
            # an elided intermediate is never written, but residency
            # must read exactly as if the chain had run unfused
            for seg, arg in spec.elided:
                metas[seg].buffers[arg].mark_written()

        originals = [c.event for c in chain]

        def mirror(ev: Event) -> None:
            # the original per-kernel events complete with (and share
            # the profiling counters of) the fused command
            for o in originals:
                if ev.error is not None:
                    o.fail(ev.error)
                else:
                    o.complete()
                o.submit_ns = ev.submit_ns
                o.start_ns = ev.start_ns
                o.end_ns = ev.end_ns
        fev.add_callback(mirror)
        # deps: edge legality guarantees every later command's non-chain
        # deps are a subset of the head's, so the head's list is the
        # fused node's full wait list (and can never reach back into the
        # chain — no cycles through mirrored completions)
        fused_cmd = _Command(run, fev, chain[0].deps)
        sink = self.trace_sink
        if sink is not None:
            sink.on_command(fev, fused_cmd.deps, self)
        with self._lock:
            self._fused_chains += 1
            self._commands_eliminated += len(chain) - 1
            # one avoided write-back + one avoided read per elided edge
            self._bytes_elided += sum(2 * b.nbytes for b in elided_bufs)
        return fused_cmd

    def _fuse_window(self, cmds: List[_Command]) -> List[_Command]:
        """The flush-time graph optimizer: replace every maximal fusible
        chain in the window with one stitched command."""
        if self.fusion == "off" or not _fusion_enabled() \
                or len(cmds) < 2:
            return cmds
        runs = self._chain_runs(cmds)
        if not runs:
            return cmds
        out: List[_Command] = []
        pos = 0
        for i, j in runs:
            out.extend(cmds[pos:i])
            fused = self._fuse_chain(cmds[i:j + 1], cmds)
            if fused is not None:
                out.append(fused)
            else:
                out.extend(cmds[i:j + 1])
            pos = j + 1
        out.extend(cmds[pos:])
        return out

    def pending_chain_spec(self) -> Optional[FusedSpec]:
        """The fused spec of the pending window's tail chain, as the
        flush-time rewrite will find it in the device's fused tier
        (stitched now on a miss), or ``None`` when the window does not
        end in a chain.  Raises ``FusionError`` where stitching fails.
        A caller builds the fused kernel ahead of its first launch from
        it (``spec.program.binary_for``)."""
        with self._lock:
            window = list(self._pending)
        if len(window) < 2:
            return None
        j = len(window) - 1
        i = j
        while i > 0 and self._edge_chained(window[i - 1], window[i]):
            i -= 1
        if i == j:
            return None
        return self._chain_spec(window[i:j + 1], window)[0]

    def _warm_eager(self) -> None:
        """``fusion="eager"``: pre-stitch the growing pending tail chain
        during the enqueue window, so the flush-time rewrite (and its
        first launch) hits the fused tier instead of stitching."""
        try:
            self.pending_chain_spec()
        except FusionError:
            pass

    # -- DAG execution ------------------------------------------------------------
    def flush(self) -> None:
        """clFlush: submit the DAG built so far and return immediately.

        Every command enqueued before this call is *armed*: commands with
        resolved wait lists go to the worker pool now, the rest are
        submitted automatically (from the completing thread) as their
        dependencies finish.  Completion is observed with ``finish()`` or
        ``Event.wait()``.

        Before arming, the fusion rewrite runs over the window
        (:meth:`dag_stats`) — fused
        chains arm as one command; their original events complete with
        it."""
        with self._lock:
            armed, self._pending = self._pending, []
        armed = self._fuse_window(armed)
        with self._lock:
            # successfully completed events need no further tracking;
            # pruning keeps _issued bounded on long-lived queues.  Failed
            # events stay until the next finish() reports them.
            self._issued = [e for e in self._issued if not e.succeeded]
            self._issued.extend(c.event for c in armed)
        for cmd in armed:
            self._arm(cmd)

    def _arm(self, cmd: _Command) -> None:
        """Register dependency callbacks; submit if already ready."""
        cmd.remaining = len(cmd.deps)
        if cmd.remaining == 0:
            with self._lock:
                cmd.submitted = True
            self._submit(cmd)
            return
        with self._lock:
            # tracked so cancel_pending can abandon a command whose
            # dependencies will never resolve (e.g. a lost device)
            self._armed.add(cmd)
        for dep in cmd.deps:
            # fires immediately if the dep is already terminal
            dep.add_callback(lambda ev, c=cmd: self._dep_resolved(c, ev))

    def _dep_resolved(self, cmd: _Command, dep: Event) -> None:
        with self._lock:
            if dep.failed and cmd.failed_dep is None:
                cmd.failed_dep = dep
            cmd.remaining -= 1
            ready = cmd.remaining == 0 and not cmd.submitted
            if ready:
                cmd.submitted = True
                self._armed.discard(cmd)
        if ready:
            self._submit(cmd)

    def _submit(self, cmd: _Command) -> None:
        if cmd.event.done:
            return                # cancelled while waiting on deps
        cmd.event._transition(EventStatus.SUBMITTED)
        self._pool.submit(self._run_command, cmd)

    def _run_command(self, cmd: _Command) -> None:
        if cmd.event.done:
            return                # cancelled between submit and run
        if cmd.failed_dep is not None:
            cmd.event.fail(DependencyError(
                f"command {cmd.event.name!r} abandoned: dependency "
                f"{cmd.failed_dep.name!r} failed"))
            return
        cmd.event._transition(EventStatus.RUNNING)
        try:
            cmd.fn()
        except BaseException as e:  # noqa: BLE001 - must reach waiters
            cmd.event.fail(e)
        else:
            cmd.event.complete()

    def cancel_pending(self, error: Optional[BaseException] = None
                       ) -> List[Event]:
        """Abandon every command that cannot have started running: the
        still-unflushed enqueue window plus armed commands whose wait
        lists are unresolved.  Their events fail with ``error`` (default
        a :class:`~repro_torch.runtime.events.DependencyError`) without the
        command functions ever executing, so dependents fail typed and
        ``finish(timeout)`` observes them as *done*, never as stuck.

        This is the device-loss path: work migrated elsewhere must not
        leave ghost commands on the losing queue that a later
        ``finish(timeout)`` names as stuck.  Returns the cancelled
        events.  Commands already submitted to a worker are
        not cancellable and run (or fail) normally."""
        with self._lock:
            pending, self._pending = self._pending, []
            waiting = [c for c in self._armed
                       if not c.submitted and not c.event.done]
            for c in waiting:
                c.submitted = True     # dep callbacks must not submit
            self._armed.difference_update(waiting)
        victims = pending + waiting
        for c in victims:
            c.event.fail(error if error is not None else DependencyError(
                f"command {c.event.name!r} cancelled before execution"))
        return [c.event for c in victims]

    def finish(self, timeout: Optional[float] = None) -> None:
        """clFinish: flush and wait for completion of *every* issued
        command.  (Waiting only on the last event is wrong for
        out-of-order queues: the last-enqueued command can finish while
        earlier independent commands are still executing.)

        Raises :class:`CommandError` if any command failed, or
        ``RuntimeError`` if ``timeout`` (seconds) expires — e.g. a wait
        list references an event of a queue that was never flushed, or an
        incomplete :class:`~repro_torch.runtime.events.UserEvent`."""
        self.flush()
        with self._lock:
            issued = list(self._issued)
        try:
            if not wait_for_events(issued, timeout):
                # name stuck commands; a fused super-command expands to
                # its constituent kernels (Event.fused_from provenance)
                stuck = []
                for e in issued:
                    if e.done:
                        continue
                    if e.fused_from:
                        parts = ", ".join(o.name for o in e.fused_from)
                        stuck.append(f"{e.name} (fused from: {parts})")
                    else:
                        stuck.append(e.name)
                raise RuntimeError(
                    f"CommandQueue.finish timed out after {timeout}s; "
                    f"incomplete commands: {stuck[:8]}")
        finally:
            with self._lock:
                self._issued = [e for e in self._issued if not e.done]

    def __del__(self):  # pragma: no cover - interpreter shutdown ordering
        try:
            self._pool.shutdown(wait=False)
        except Exception:
            pass


__all__ = ["CommandQueue", "Event", "EventStatus", "UserEvent",
           "CommandError", "DependencyError", "FUSION_MODES", "MapError",
           "MappedRegion", "wait_for_events"]
