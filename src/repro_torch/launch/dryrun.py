"""Multi-pod dry-run: trace one step of every (arch × shape) cell on the
production mesh, with no real allocation.

The port of ``repro.launch.dryrun``.  Where the reference lowered and
compiled each cell for 512 placeholder host devices, the port runs the
cell's step once as rank 0 of the fake process group of the production
mesh (:func:`.mesh.make_production_mesh`) under ``FakeTensorMode``: the
parameters, optimizer state, caches and inputs are fake tensors placed
by the sharding rules as DTensors, the collectives return at once, and
the kernels give their outputs' shapes without launching
(:func:`repro_torch.kernels._cuda.is_fake`).  Nothing is allocated, so
the reference's ``XLA_FLAGS`` preamble has no counterpart.  Train and
prefill cells run; a decode cell raises, its KV cache cut over the mesh
waiting for ROADMAP A.14.

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
      --shape train_4k [--multi-pod] [--variant baseline] [--all] \\
      [--device cpu]

The fake tensors are CUDA tensors unless ``--device cpu`` (see
:func:`run_cell`); without a card and without ``--device cpu`` it raises
:class:`~repro_torch.runtime.DeviceNotFoundError`.

Per cell it records one device's peak bytes (the counterpart of
``memory_analysis()``: does the step fit the card?) and the traced
FLOPs, bytes and collective bytes (the counterpart of ``cost_analysis()``
and the parsed HLO), all from :class:`.roofline.StepTrace`, priced
against the H100 (:mod:`.roofline`).  The peak is the high mark of the
storages the step's local operators hold: what
``torch.distributed._tools.mem_tracker.MemTracker`` gives in PyTorch
2.13, whose ``MemTracker`` skips DTensor's sharding propagation; 2.11's
counts the propagation's fake tensors, global shapes and all (384.8 GiB
a device for two smollm-135m layers on the 16 x 16 mesh, on the card).  Records land in
``results/dryrun/<mesh>/<variant>/<arch>__<shape>.json`` with the
reference's keys.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import configs
from ..distributed.sharding import (BASELINE_RULES, DECODE_RULES,
                                    LONG_DECODE_RULES, adapt_rules_for,
                                    logical_to_sharding, prune_to_mesh)
from ..models import cache_logical_axes, model_defs
from ..models.config import ALL_SHAPES, shapes_for
from ..models.model import torch_dtype
from ..models.params import abstract_params, param_placements
from ..runtime import DeviceNotFoundError
from ..serving.steps import make_prefill_step
from ..training import TrainConfig, abstract_state, make_train_step
from ..training.trainer import batch_placements, state_shardings
from ..training.tree import leaves_with_paths, tree_map
from . import roofline as RL
from .mesh import HW, make_production_mesh
from .specs import input_specs




def batch_axes_size(mesh) -> int:
    names = mesh.mesh_dim_names
    n = mesh.size(names.index("data"))
    if "pod" in names:
        n *= mesh.size(names.index("pod"))
    return n


def rules_for(cfg, shape, mesh, variant: str):
    """Pick + adapt the sharding rule table for one cell."""
    if shape.kind == "decode":
        base = LONG_DECODE_RULES if shape.global_batch == 1 \
            else DECODE_RULES
    else:
        base = BASELINE_RULES
    if variant != "baseline":
        from .variants import VARIANTS
        for v in variant.split("+"):
            if v in VARIANTS:
                base = VARIANTS[v](base, cfg, shape, mesh)
    base = prune_to_mesh(base, mesh)
    rules = adapt_rules_for(base, mesh, n_kv=cfg.n_kv,
                            n_experts=cfg.n_experts, n_heads=cfg.n_heads,
                            d_ff=cfg.d_ff, vocab=cfg.padded_vocab)
    data = mesh.size(mesh.mesh_dim_names.index("data"))
    if shape.global_batch % batch_axes_size(mesh) != 0 \
            and rules.batch is not None:
        rules = rules.replace(batch=("data",)
                              if shape.global_batch % data == 0 else None)
    return rules


def lower_cell(arch: str, shape, mesh, variant: str = "baseline",
               cfg=None):
    """The cell's step and its inputs, as fake DTensors on ``mesh``
    placed by the rules.  Returns (cfg, rules, step, args, fake_mode):
    call ``step(*args)`` inside ``fake_mode``.  ``cfg`` replaces the
    architecture's published config (a test's small one)."""
    from .variants import CFG_OVERRIDES
    cfg = cfg if cfg is not None else configs.get_config(arch)
    for v in variant.split("+"):
        if v in CFG_OVERRIDES:
            cfg = dataclasses.replace(cfg, **CFG_OVERRIDES[v])
    rules = rules_for(cfg, shape, mesh, variant)
    specs = input_specs(cfg, shape)
    fake = FakeTensorMode(allow_non_fake_inputs=True)

    def place(meta, placements):
        t = torch.empty(meta.shape, dtype=meta.dtype,
                        device=mesh.device_type)
        return distribute_tensor(t, mesh, placements, src_data_rank=None)

    def by_logical(tree, axes):
        return {k: place(v, logical_to_sharding(mesh, rules, axes[k]))
                for k, v in tree.items()}

    with fake:
        if shape.kind == "train":
            step = make_train_step(cfg, TrainConfig(num_microbatches=1),
                                   rules)
            st_sh = state_shardings(cfg, mesh, rules)
            abs_state = abstract_state(cfg)
            state = {"params": tree_map(place, abs_state["params"],
                                        st_sh["params"]),
                     "opt": tree_map(place, abs_state["opt"], st_sh["opt"]),
                     "step": torch.zeros((), dtype=torch.int32,
                                         device=mesh.device_type)}
            b_pl = batch_placements(cfg, mesh, rules)
            batch = {k: place(v, b_pl[k]) for k, v in specs["batch"].items()}
            args = (state, batch)
        else:
            if shape.kind == "decode":
                raise NotImplementedError(
                    "dry-run of a decode cell: a KV cache cut over the "
                    "mesh (its per-row in-place writes, decode attention "
                    "over a cut sequence) waits for ROADMAP A.14; train and "
                    "prefill cells run")
            step = make_prefill_step(cfg, rules)
            params = tree_map(place, abstract_params(
                model_defs(cfg), torch_dtype(cfg.dtype)),
                param_placements(model_defs(cfg), mesh, rules))
            batch = by_logical(specs["batch"], {
                k: ("batch",) + (None,) * (v.dim() - 1)
                for k, v in specs["batch"].items()})
            caches = by_logical(specs["caches"], cache_logical_axes(cfg))
            args = (params, batch, caches)
    return cfg, rules, step, args, fake


def _local_bytes(tree) -> float:
    total = 0
    for _, t in leaves_with_paths(tree):
        t = t.to_local() if isinstance(t, DTensor) else t
        total += t.numel() * t.element_size()
    return float(total)


def trace_step(step, args, fake):
    """Run ``step(*args)`` once (its fake tensors carry ``fake``) under
    :class:`RL.StepTrace`; returns (peak bytes, argument bytes, output
    bytes, the trace), each of one device."""
    arg_bytes = sum(_local_bytes(a) for a in args)
    tracer = RL.StepTrace(held=[t.to_local() if isinstance(t, DTensor)
                                else t for a in args
                                for _, t in leaves_with_paths(a)])
    with tracer:
        out = step(*args)
    peak = tracer.peak_bytes
    out_bytes = _local_bytes(out[1]) if isinstance(out[1], dict) \
        else _local_bytes({"o": out[0]})
    return float(peak), arg_bytes, out_bytes, tracer


def run_cell(arch: str, shape, *, multi_pod: bool = False,
             variant: str = "baseline", out_dir: str = "results/dryrun",
             verbose: bool = True, mesh=None, mesh_name=None, cfg=None,
             device_type: str = "cuda"):
    """Trace one cell on the production mesh of ``device_type`` tensors
    (or on ``mesh``, named ``mesh_name``) and write its record.  Starts
    the fake process group if none is live, and destroys it again.

    ``"cuda"`` (fake tensors need PyTorch built for CUDA, no memory) is
    the card's path; on a ``"cpu"`` mesh DTensor moves a cut from one
    dim to another by an all-gather and a chunk (gloo has no all-to-all),
    which the peak then counts: the counterpart of the reference's
    CPU-backend artifact, kept out of a card's record."""
    created = not dist.is_initialized()
    if mesh is None:
        mesh = make_production_mesh(multi_pod=multi_pod,
                                    device_type=device_type)
        mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    try:
        chips = math.prod(mesh.shape)
        t0 = time.time()
        cfg, rules, step, args, fake = lower_cell(arch, shape, mesh,
                                                  variant, cfg)
        t_lower = time.time() - t0
        t0 = time.time()
        peak, arg_bytes, out_bytes, tr = trace_step(step, args, fake)
        t_trace = time.time() - t0
    finally:
        if created:
            dist.destroy_process_group()

    # the peak counts the arguments, which stay live through the step
    temp = max(peak - arg_bytes, 0.0)
    mem_bytes = arg_bytes + temp + out_bytes
    report = RL.build_report(
        arch=arch, shape=shape, mesh_name=mesh_name, chips=chips,
        cost={"flops": float(tr.flops),
              "bytes accessed": float(tr.bytes_accessed)},
        mem_bytes=mem_bytes, coll=tr.collectives(), cfg=cfg)
    rec = report.to_dict()
    rec.update(variant=variant, device_type=mesh.device_type,
               t_lower_s=t_lower, t_compile_s=t_trace,
               argument_bytes=arg_bytes, temp_bytes=temp,
               output_bytes=out_bytes,
               hbm_fraction=mem_bytes / HW["hbm_bytes"],
               rules=str(rules))

    path = os.path.join(out_dir, mesh_name, variant)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, f"{arch}__{shape.name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        print(f"[{mesh_name}/{variant}] {arch} x {shape.name}: "
              f"trace={t_trace:.1f}s "
              f"mem/dev={mem_bytes/2**30:.2f}GiB "
              f"t_comp={report.t_compute*1e3:.2f}ms "
              f"t_mem={report.t_memory*1e3:.2f}ms "
              f"t_coll={report.t_collective*1e3:.2f}ms "
              f"dominant={report.dominant} "
              f"roofline={report.roofline_fraction:.2%}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=configs.ARCH_IDS)
    ap.add_argument("--shape", default=None,
                    choices=[s.name for s in ALL_SHAPES])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device: the card's path "
                         "(default; needs a CUDA build and a card), or "
                         "'cpu', whose peak counts gloo's all-gathers")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise DeviceNotFoundError(
            "no CUDA device: the dry-run traces the card's path unless "
            "--device cpu is given")

    shape_by_name = {s.name: s for s in ALL_SHAPES}
    if args.all:
        cells = [(arch, s) for arch in configs.ARCH_IDS
                 for s in shapes_for(configs.get_config(arch))]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, shape_by_name[args.shape])]

    mesh_name = "pod2x16x16" if args.multi_pod else "pod16x16"
    failures = []
    for arch, s in cells:
        out_json = os.path.join(args.out, mesh_name, args.variant,
                                f"{arch}__{s.name}.json")
        if args.skip_existing and os.path.exists(out_json):
            print(f"skip {arch} x {s.name} (exists)")
            continue
        try:
            run_cell(arch, s, multi_pod=args.multi_pod,
                     variant=args.variant, out_dir=args.out,
                     device_type=args.device)
        except Exception as e:
            traceback.print_exc()
            failures.append((arch, s.name, repr(e)[:200]))
    if failures:
        print("FAILURES:")
        for f in failures:
            print(" ", f)
        sys.exit(1)
    print("dry-run OK")


if __name__ == "__main__":
    main()
