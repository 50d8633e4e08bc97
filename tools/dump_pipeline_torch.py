"""The stage-by-stage IR dumps of ``tools/dump_pipeline.py``, through the
PyTorch/H100 port, and what its ``cuda`` target makes of each kernel.

Drives ``repro_torch``'s compiler middle-end through the
:class:`PassManager` with its per-pass dump hook (the pass list is
enumerated from the manager), printing the canonical IR after every
CFG-mutating pass and each analysis pass's product, then the stitched
rmsnorm -> residual -> quantize chain: the same sections, in the same
words, as the reference tool prints.  Then, for the ``cuda`` work-group
target, each kernel's mapping decisions (``core/targets/cuda_mapping.py``:
direct region flow or the ``while (switch)`` schedule, each barrier kept
as ``__syncthreads()`` or dropped, the int32 bounds proven from the local
size) and its emitted CUDA source.  Emitting needs no ``nvcc`` and no
card.  It resolves the device as the port's entry points do: the first
CUDA device unless ``--device`` names another (on a card it also prints
the limits the mapping is checked against); with no card and no
``--device`` it raises ``DeviceNotFoundError``.

  PYTHONPATH=src python tools/dump_pipeline_torch.py               # a card
  PYTHONPATH=src python tools/dump_pipeline_torch.py --device cpu  # CPU
"""

import argparse

from repro_torch.core import canonical_ir
from repro_torch.core.api import _compile_kernel
from repro_torch.core.examples import (build_condbar, build_quantize,
                                       build_reduce2, build_residual_add,
                                       build_rmsnorm_ew)
from repro_torch.core.fusion import ChainEdge, stitch_functions
from repro_torch.core.passes import PassManager, kernel_fusibility
from repro_torch.core.targets.cuda_mapping import barrier_kind
from repro_torch.core.targets.cuda_target import device_limits
from repro_torch.runtime import Platform


def run_and_dump(fn, verbose_cfg: bool = True) -> None:
    """Run the default pipeline on ``fn``, printing after every pass."""
    last_ir = [canonical_ir(fn)]
    print("\n### input (KernelBuilder DSL lowering to SSA CFG)\n")
    print(last_ir[0])

    def on_pass(p, st) -> None:
        ref = f" ({p.paper})" if p.paper else ""
        if p.mutates_cfg:
            text = canonical_ir(st.fn)
            if text == last_ir[0]:
                print(f"\n### after {p.name}{ref}: no change\n")
                return
            last_ir[0] = text
            print(f"\n### after {p.name}{ref}\n")
            if verbose_cfg:
                print(text)
        else:
            print(f"\n### after {p.name}{ref}\n")
            if p.name == "form_regions":
                print(f"schedule (RPO, entry first): {st.wg.order}")
                print(f"linear chain: {st.wg.is_chain()}")
                for bar in st.wg.order:
                    r = st.wg.regions[bar]
                    print(f"region @{bar}: entry={r.entry} "
                          f"blocks={sorted(r.blocks) if r.blocks else []}")
            elif p.name == "context_planning":
                for s in st.ctx.slots:
                    print(f"slot {s.name}: {s.dtype} "
                          f"{'uniform (merged)' if s.uniform else 'per-WI'}")
                if not st.ctx.slots:
                    print("(no cross-region values: zero context slots)")
            elif p.name == "annotate_parallel_md":
                for bar in st.wg.order:
                    print(st.md[bar].describe())
            else:
                print("(analysis pass)")

    pm = PassManager(verify=True, on_pass=on_pass)
    print(f"\npipeline passes: {pm.pass_names()}")
    plan = pm.run(fn)
    print("\n### per-pass timings (ms)\n")
    for name, dt in plan.pass_times.items():
        print(f"  {name:22s} {dt * 1e3:7.3f}")


def stitch_chain(fns):
    """Stitch the rmsnorm -> residual -> quantize functions ``fns`` with
    both intermediates elided (the segments' blocks move into the fused
    function): (fused function, buffer map, scalar map)."""
    edges = [ChainEdge(0, 1, "y", "y", True), ChainEdge(1, 2, "z", "z", True)]
    aliases = [[(0, "y"), (1, "y")], [(1, "z"), (2, "z")]]
    return stitch_functions(fns, edges, aliases)


def dump_fusion() -> None:
    """Stitch the rmsnorm→residual→quantize chain and print the fused
    IR embedded in docs/compiler.md §Fusion."""
    builders = [build_rmsnorm_ew, build_residual_add, build_quantize]
    fns = [b() for b in builders]
    for fn in fns:
        facts = kernel_fusibility(fn)
        fps = ", ".join(f"{fp.name}(loads={fp.loads},stores={fp.stores})"
                        for fp in facts.footprints)
        print(f"segment {fn.name}: elementwise={facts.elementwise} [{fps}]")
    fused, bmap, smap = stitch_chain(fns)
    print("\n### stitched chain (both intermediates elided)\n")
    print(canonical_ir(fused))
    print(f"buffer map: {sorted(bmap.items())}")
    print(f"scalar map: {sorted(smap.items())}")


def build_fused_chain():
    """A fresh stitched chain (the function the queue's fusion rewrite
    launches)."""
    return stitch_chain([b() for b in (build_rmsnorm_ew, build_residual_add,
                                       build_quantize)])[0]


def dump_cuda(build, local_size) -> None:
    """The ``cuda`` target's decisions for ``build()`` at ``local_size``
    and the source it emits."""
    prog = _compile_kernel(build, local_size, target="cuda",
                           cache=False).prog
    m, fn = prog.mapping, prog.wg.fn
    print(f"\n### cuda mapping, local size {prog.lsz}: one thread block "
          f"of {prog.L} threads per work-group\n")
    print("region transitions: " + (
        "direct (every region's successor is work-group uniform; each "
        "thread jumps to it)" if m.direct else
        "while (switch): work-item 0 publishes the next region id"))
    print(f"barriers: {len(m.kept)} of {len(prog.wg.order)} kept as "
          f"__syncthreads()")
    for bar in prog.wg.order:
        state = "kept" if bar in m.kept else "dropped"
        print(f"  {bar}: {barrier_kind(fn, bar)}, {state}")
    print(f"int32 values bounded from the local size and literals: "
          f"{len(m.ranges)}")
    for vid, (lo, hi) in sorted(m.ranges.items()):
        print(f"  v{vid}: [{lo}, {hi}]")
    print(f"shared memory: {prog.smem_bytes} bytes a block")
    print(f"\n### emitted CUDA ({len(prog.source.splitlines())} lines)\n")
    print(prog.source)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device the cuda target is emitted for "
                         "(default: the first CUDA device); 'cpu' emits "
                         "without one")
    args = ap.parse_args(argv)
    platform = Platform(torch_device=args.device)

    print("=" * 72)
    print("tree-reduction kernel (b-loop, §4.5)")
    print("=" * 72)
    run_and_dump(build_reduce2())

    print("\n" + "=" * 72)
    print("conditional-barrier kernel (tail duplication, Alg. 2)")
    print("=" * 72)
    run_and_dump(build_condbar())

    print("\n" + "=" * 72)
    print("DAG-fused elementwise chain (docs/compiler.md §Fusion)")
    print("=" * 72)
    dump_fusion()

    print("\n" + "=" * 72)
    print("the cuda work-group target (core/targets/cuda_mapping.py, "
          "cuda_target.py)")
    print("=" * 72)
    td = platform.torch_devices[0]
    if td.type == "cuda":
        lim = device_limits(td)
        print(f"\ndevice {td}: at most {lim.max_threads} threads and "
              f"{lim.smem_optin} bytes of shared memory a block")
    else:
        print(f"\ndevice {td}: emitted only (no card)")
    for build, lsz in ((build_reduce2, (2,)), (build_condbar, (64,)),
                       (build_fused_chain, (256,))):
        dump_cuda(build, lsz)


if __name__ == "__main__":
    main()
