"""Serial loop target over torch tensors: the 'basic' CPU driver analogue
(paper §3).

The port of ``repro.core.targets.loop``.  Each parallel region runs as an
explicit loop over the work-items of one work-group (the literal "WI
loop" form of §4.3 before any vectorization), and work-groups run one
after another, as in the reference.  Semantically identical to the
vector target; it stays the portability baseline every device gets for
free.

The next-region decision is taken from work-item 0 — the "peeled first
iteration" of §4.4 that evaluates the (work-group-uniform) branch for the
rest of the work-items.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .vector import BUFFER_DTYPES, LaneExec, Lanes, Launch, WGProgram, \
    convert


class LoopWGProgram(WGProgram):
    def run_groups(self, launch: Launch, buffers: Dict[str, torch.Tensor],
                   lo: int, hi: int) -> None:
        dev = launch.device
        for g in range(lo, hi):
            bufs = dict(buffers)
            for a in self.wg.fn.buffer_args:
                if a.name in launch.locals:
                    bufs[a.name] = torch.zeros(
                        launch.locals[a.name],
                        dtype=BUFFER_DTYPES[np.dtype(a.dtype).name],
                        device=dev)
            self._run_wg(launch, bufs,
                         torch.tensor([g], dtype=torch.int32, device=dev))

    def _run_wg(self, launch: Launch, bufs: Dict[str, torch.Tensor],
                gl: torch.Tensor) -> None:
        dev = launch.device
        ctx = self._ctx_init(launch, self.L)
        zero = torch.zeros(1, dtype=torch.int32, device=dev)

        def run_region(bar: str, ctx):
            region = self.wg.regions[bar]
            rid = self.K
            for wi in range(self.L):
                lanes = Lanes(lids=torch.tensor([wi], dtype=torch.int32,
                                                device=dev),
                              gl=gl, gslot=zero, groups=1, per_group=1)
                ex = LaneExec(self, launch, lanes, bufs, {})
                # seed this work-item's context row
                for s, arr in zip(self.plan.slots, ctx):
                    v = arr if s.uniform else arr[wi:wi + 1].clone()
                    if s.kind == "val":
                        ex.env[s.key] = v
                    else:
                        ex.vregs[s.key] = v
                exits = ex.exec_region(region)
                new_ctx = []
                for s, arr in zip(self.plan.slots, ctx):
                    v = ex.env.get(s.key) if s.kind == "val" \
                        else ex.vregs.get(s.key)
                    if v is None:
                        new_ctx.append(arr)
                    elif s.uniform:
                        # LaneExec computes at lane-width 1, so a uniform
                        # value may come back shaped (1,); reshape to the
                        # slot's scalar shape
                        new_ctx.append(convert(v, arr.dtype)
                                       .reshape(arr.shape))
                    else:
                        row = convert(v, arr.dtype).expand(1)
                        arr = arr.clone()
                        arr[wi:wi + 1] = row
                        new_ctx.append(arr)
                ctx = new_ctx
                if wi == 0:
                    # peel: work-item 0 decides the next region
                    for tgt, pred in exits.items():
                        if tgt == "":
                            continue
                        if pred is None or bool(pred.reshape(-1)[0]):
                            rid = self.rid_of[tgt]
            return rid, ctx

        if self.wg.is_chain():
            for bar in self.wg.chain():
                _, ctx = run_region(bar, ctx)
            return
        rid = 0
        while rid < self.K:
            rid, ctx = run_region(self.order[rid], ctx)


__all__ = ["LoopWGProgram"]
