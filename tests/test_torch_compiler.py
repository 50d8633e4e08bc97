"""The port's compiler copies held against the reference (``repro.core``).

``repro_torch`` keeps its own copies of the reference's numpy-only
compiler modules (the DSL, IR, passes, region formation, cache, fiber
interpreter, examples and the kernel suite).  One builder source, run
through both packages' ``KernelBuilder``, must give equal canonical IR
after every pass, equal plan facts (context-slot stats, region counts,
``ParallelRegionMD``) and equal fiber-oracle outputs.  The copies must
differ from their originals in their imports only.
"""

import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core import PassManager as JPassManager  # noqa: E402
from repro.core import canonical_ir as j_canonical_ir  # noqa: E402
from repro.core.interp import run_ndrange as j_run_ndrange  # noqa: E402
from repro.suite import SUITE as J_SUITE  # noqa: E402

from repro_torch.core import KernelBuilder as TKB  # noqa: E402
from repro_torch.core import PassManager as TPassManager  # noqa: E402
from repro_torch.core import CompilationCache, canonical_ir, ir_hash  # noqa: E402
from repro_torch.core import examples as t_examples  # noqa: E402
from repro_torch.core.api import _compile_kernel  # noqa: E402
from repro_torch.core.cases import CASES, builder  # noqa: E402
from repro_torch.core.interp import run_ndrange as t_run_ndrange  # noqa: E402
from repro_torch.suite import SUITE as T_SUITE  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_DIR = os.path.join(ROOT, "tests", "golden")

COPIES = ["core/errors.py", "core/ir.py", "core/dsl.py", "core/regions.py",
          "core/uniformity.py", "core/horizontal.py", "core/context.py",
          "core/passes.py", "core/cache.py", "core/interp.py",
          "core/examples.py", "core/fusion.py", "suite/kernels.py",
          "suite/oracles.py", "runtime/trace.py"]


def pipeline_trace(build_fn, canon, pm_cls, **opts) -> str:
    """Canonical IR after the input and every CFG-mutating pass, then
    the plan summary (the reference's golden-snapshot surface)."""
    fn = build_fn()
    lines = ["== input ==", canon(fn)]

    def on_pass(p, st):
        if p.mutates_cfg:
            lines.append(f"== after {p.name} ==")
            lines.append(canon(st.fn))

    plan = pm_cls(verify=True, on_pass=on_pass).run(fn, **opts)
    lines.append("== plan ==")
    lines.append(plan.describe())
    return "\n".join(lines) + "\n", plan


def plan_facts(plan, local_size=8):
    md = {bar: (m.rid, m.wi_parallel, m.uniform_exits, m.lockstep,
                m.n_blocks) for bar, m in plan.md.items()}
    return {"stats": plan.ctx.stats(local_size),
            "regions": len(plan.wg.regions), "order": len(plan.wg.order),
            "chain": plan.wg.is_chain(), "md": sorted(md.values())}


def both(build):
    """(reference builder, port builder) of a KernelBuilder-generic
    source."""
    return builder(build, JKB), builder(build, TKB)


def suite_pairs(which):
    for name in sorted(T_SUITE):
        t_sk, j_sk = T_SUITE[name], J_SUITE[name]
        shape = t_sk.shapes[which]
        for params in t_sk.space(shape):
            yield (f"{name}-{which}-" + ",".join(
                f"{k}={v}" for k, v in sorted(params.items())),
                j_sk.build(shape, params), t_sk.build(shape, params))


KERNELS = ([(f"case-{c}", *both(CASES[c][0])) for c in CASES]
           + list(suite_pairs("ci")) + list(suite_pairs("full")))


# ---------------------------------------------------------------------------
# canonical IR and plan facts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["reduce2", "condbar", "dct"])
def test_golden_pipeline_matches_reference_snapshot(name):
    """The port's pipeline reproduces the reference's golden snapshots
    (tests/golden/<name>.txt) exactly, pass by pass."""
    got, _ = pipeline_trace(getattr(t_examples, f"build_{name}"),
                            canonical_ir, TPassManager)
    with open(os.path.join(GOLDEN_DIR, f"{name}.txt")) as f:
        assert got == f.read()


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("name,jb,tb", KERNELS, ids=[k[0] for k in KERNELS])
def test_pipeline_ir_and_plan_equal(name, jb, tb, horizontal):
    """Equal canonical IR after every pass, equal plan description,
    context-slot stats, region counts and ParallelRegionMD."""
    j_trace, j_plan = pipeline_trace(jb, j_canonical_ir, JPassManager,
                                     horizontal=horizontal)
    t_trace, t_plan = pipeline_trace(tb, canonical_ir, TPassManager,
                                     horizontal=horizontal)
    assert t_trace == j_trace
    assert plan_facts(t_plan) == plan_facts(j_plan)


@pytest.mark.parametrize("name,jb,tb", KERNELS, ids=[k[0] for k in KERNELS])
def test_ir_hash_equal(name, jb, tb):
    from repro.core import ir_hash as j_ir_hash
    assert ir_hash(tb()) == j_ir_hash(jb())


def test_compiled_kernel_introspection_matches_reference():
    """num_regions and context_stats of a compiled kernel agree with the
    reference's (tests/test_core_compiler.py region/context checks)."""
    from repro.core.api import _compile_kernel as j_compile
    for case in ("vecadd", "uncond", "condbar_taken", "bloop"):
        jb, tb = both(CASES[case][0])
        j = j_compile(jb, (8,), cache=False)
        t = _compile_kernel(tb, (8,), cache=False)
        assert t.num_regions == j.num_regions
        assert t.context_stats == j.context_stats


# ---------------------------------------------------------------------------
# the fiber oracle copy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_fiber_oracle_equal(case):
    build, mk, gsz, lsz, scalars = CASES[case]
    jb, tb = both(build)
    bufs = mk(np.random.default_rng(11))
    ref = j_run_ndrange(jb(), gsz, lsz,
                        {k: v.copy() for k, v in bufs.items()}, scalars)
    got = t_run_ndrange(tb(), gsz, lsz,
                        {k: v.copy() for k, v in bufs.items()}, scalars)
    for k in bufs:
        assert got[k].tobytes() == ref[k].tobytes(), (case, k)


@pytest.mark.parametrize("name", sorted(T_SUITE))
def test_suite_copy_inputs_oracle_and_fiber_equal(name):
    """Copied generators make the same inputs, the copied oracle gives
    the same answer, and the fiber oracle copy agrees with it."""
    t_sk, j_sk = T_SUITE[name], J_SUITE[name]
    shape = t_sk.shapes["ci"]
    params = t_sk.space(shape)[0]
    t_in, j_in = t_sk.make_inputs(shape, params), \
        j_sk.make_inputs(shape, params)
    assert sorted(t_in) == sorted(j_in)
    for k in t_in:
        assert t_in[k].tobytes() == j_in[k].tobytes()
    exp = j_sk.oracle(j_in, shape, params)
    got = t_sk.oracle(t_in, shape, params)
    gsz, lsz = t_sk.launch_dims(shape, params)
    fib = t_run_ndrange(t_sk.build(shape, params)(), gsz, lsz,
                        {k: v.copy() for k, v in t_in.items()})
    for o in t_sk.outputs:
        assert got[o].tobytes() == exp[o].tobytes()
        assert fib[o].tobytes() == exp[o].tobytes()
    assert t_sk.flops(shape) == j_sk.flops(shape)
    assert t_sk.bytes_moved(shape) == j_sk.bytes_moved(shape)
    assert t_sk.launch_dims(shape, params) == j_sk.launch_dims(shape, params)


# ---------------------------------------------------------------------------
# the copies themselves
# ---------------------------------------------------------------------------

_IMPORT = re.compile(r"^(from \S+ import|import )")


def _without_imports(text: str):
    return [ln for ln in text.splitlines() if not _IMPORT.match(ln)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_from_original_only_in_imports(rel):
    with open(os.path.join(ROOT, "src", "repro", rel)) as f:
        orig = _without_imports(f.read())
    with open(os.path.join(ROOT, "src", "repro_torch", rel)) as f:
        copy = _without_imports(f.read())
    if rel == "core/cache.py":
        # the disk tier tags its pickles with the package (see below)
        orig, copy = _drop_def(orig, "_disk_path"), _drop_def(copy,
                                                              "_disk_path")
    assert copy == orig


def test_tuning_table_is_a_copy():
    """``core/autotune.py``'s TuningTable and its process-default table
    are the reference's unchanged, so both packages read and write one
    table file with the same keys.  (Its AutotunedKernel differs: the
    port launches in place and its candidates are loop, vector, cuda.)"""
    import inspect
    from repro.core import autotune as j_autotune
    from repro_torch.core import autotune as t_autotune
    for name in ("TuningTable", "default_table", "set_default_table"):
        assert inspect.getsource(getattr(t_autotune, name)) == \
            inspect.getsource(getattr(j_autotune, name)), name


def _drop_def(lines, name):
    start = next(i for i, ln in enumerate(lines)
                 if ln.strip().startswith(f"def {name}("))
    end = next(i for i in range(start + 1, len(lines))
               if lines[i].strip().startswith("def "))
    return lines[:start] + lines[end:]


def test_disk_tier_keeps_its_own_pickles(tmp_path):
    """The reference and the port share REPRO_KERNEL_CACHE_DIR and key
    digests; the port's pickles carry a package tag, so neither package
    unpickles the other's kernels."""
    from repro.core.cache import CompilationCache as JCache
    tb = builder(CASES["vecadd"][0], TKB)
    cache = CompilationCache(disk_dir=str(tmp_path))
    k = _compile_kernel(tb, (8,), cache=cache)
    names = os.listdir(tmp_path)
    assert len(names) == 1 and names[0].startswith("repro_torch-")
    with open(tmp_path / names[0], "rb") as f:
        again = pickle.load(f)
    out = again({"A": np.ones(16, np.float32), "B": np.ones(16, np.float32),
                 "C": np.zeros(16, np.float32)}, (16,))
    assert out["C"].numpy().tolist() == [2.0] * 16
    assert k.name == again.name
    # the reference's tier finds nothing of the port's under its name
    key_path = JCache(disk_dir=str(tmp_path))._disk_path
    from repro.core.cache import CacheKey as JKey
    jkey = JKey.make(builder(CASES["vecadd"][0], JKB)(), (8,), "vector",
                     horizontal=True, merge_uniform=True, use_vml=False)
    assert not os.path.exists(key_path(jkey))


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def test_port_imports_neither_jax_nor_repro():
    """Importing every module of repro_torch pulls in neither jax nor the
    reference package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = []\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name); names.append(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.strip()) >= 20


PORT_ENTRY_POINTS = sorted(
    [os.path.join("examples", f) for f in os.listdir(
        os.path.join(ROOT, "examples")) if f.startswith("torch_")]
    + ["tools/dump_pipeline_torch.py"])


def test_port_entry_points_are_listed():
    assert PORT_ENTRY_POINTS == [
        "examples/torch_opencl_runtime.py", "examples/torch_quickstart.py",
        "examples/torch_serve_lm.py", "examples/torch_train_lm.py",
        "tools/dump_pipeline_torch.py"]


@pytest.mark.parametrize("rel", PORT_ENTRY_POINTS)
def test_port_entry_points_import_neither_jax_nor_repro(rel):
    """Loading an example or tool of the port (without running its main)
    pulls in neither jax nor the reference package."""
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('m', {rel!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert callable(mod.main)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n == 'repro' or n.startswith('repro.'))\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=120)
    assert r.returncode == 0, r.stderr


def test_chip_smoke_imports_neither_jax_nor_repro():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        text = f.read()
    mods = re.findall(r"^\s*(?:from|import) ([\w.]+)", text, re.M)
    assert mods, "no imports found"
    for m in mods:
        assert m.split(".")[0] not in ("jax", "repro"), m
