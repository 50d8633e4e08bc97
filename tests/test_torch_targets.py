"""The port's torch ``vector`` and ``loop`` targets held against the
reference's JAX targets on the same numpy inputs.

Tolerance: bitwise where the data is integer-valued or dyadic (the
suite's inputs, the ``divergent`` case); ``rtol=1e-5, atol=1e-6`` on
random-normal data, because XLA on the CPU may contract ``a*b + c``
into one fused multiply-add where torch rounds twice.
"""

import warnings

import numpy as np
import pytest

pytest.importorskip("jax")

from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core.api import _compile_kernel as j_compile  # noqa: E402
from repro.suite import SUITE as J_SUITE  # noqa: E402

from repro_torch.core import KernelBuilder as TKB  # noqa: E402
from repro_torch.core.api import _compile_kernel as t_compile  # noqa: E402
from repro_torch.core.cases import CASES, builder  # noqa: E402
from repro_torch.suite import SUITE as T_SUITE  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def _integral(bufs):
    return all(np.array_equal(v, np.round(v)) for v in bufs.values())


def assert_match(got, ref, exact, label):
    for k, r in ref.items():
        g = got[k].numpy()
        r = np.asarray(r)
        if exact:
            assert g.tobytes() == r.tobytes(), f"{label}: {k} not bitwise"
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{label}: {k}")


def run_both(build, lsz, target, bufs, gsz, scalars, horizontal=True,
             group_range=None):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jk = j_compile(builder(build, JKB), lsz, target=target,
                       horizontal=horizontal)
        ref = jk({k: v.copy() for k, v in bufs.items()}, gsz, scalars,
                 group_range=group_range)
    tk = t_compile(builder(build, TKB), lsz, target=target,
                   horizontal=horizontal)
    got = tk(bufs, gsz, scalars, group_range=group_range)
    return got, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("horizontal", [True, False])
@pytest.mark.parametrize("target", ["vector", "loop"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cases_match_reference(case, target, horizontal):
    build, mk, gsz, lsz, scalars = CASES[case]
    bufs = mk(np.random.default_rng(sorted(CASES).index(case)))
    got, ref = run_both(build, lsz, target, bufs, gsz, scalars, horizontal)
    assert_match(got, ref, _integral(bufs), f"{case}/{target}/hz={horizontal}")


def build_groups(KB):
    """Every group writes its own slice from LOCAL memory and reads its
    group and global ids: a sub-range must leave other groups alone."""
    b = KB("groups")
    x = b.arg_buffer("x", "float32")
    y = b.arg_buffer("y", "float32")
    tmp = b.local_array("tmp", "float32", 4)
    lid, gid, grp = b.local_id(0), b.global_id(0), b.group_id(0)
    tmp[lid] = x[gid] + grp.astype("float32")
    b.barrier()
    y[gid] = tmp[(lid + 1) % 4] * 2.0 + b.num_groups(0).astype("float32")
    return b.finish()


@pytest.mark.parametrize("target", ["vector", "loop"])
@pytest.mark.parametrize("grange", [(0, 0), (0, 1), (2, 5), (5, 6), (0, 6)])
def test_group_range_matches_reference(target, grange):
    bufs = {"x": np.arange(24, dtype=np.float32),
            "y": np.full(24, -1.0, np.float32)}
    got, ref = run_both(build_groups, (4,), target, bufs, (24,), None,
                        group_range=grange)
    assert_match(got, ref, True, f"groups/{target}/{grange}")


@pytest.mark.parametrize("target", ["vector", "loop"])
def test_group_range_reduction(target):
    build, mk, gsz, lsz, scalars = CASES["reduce"]
    bufs = {"inp": np.arange(64, dtype=np.float32),
            "out": np.zeros(8, np.float32)}
    for grange in ((1, 3), (3, 8)):
        got, ref = run_both(build, lsz, target, bufs, (64,), scalars,
                            group_range=grange)
        assert_match(got, ref, True, f"reduce/{target}/{grange}")


def _suite_cells():
    for name in sorted(T_SUITE):
        sk = T_SUITE[name]
        space = sk.space(sk.shapes["ci"])
        for i, params in enumerate(space):
            yield name, params, "vector"
            if i == 0:
                yield name, params, "loop"


SUITE_CELLS = list(_suite_cells())


@pytest.mark.parametrize(
    "name,params,target", SUITE_CELLS,
    ids=[f"{n}-{','.join(f'{k}={v}' for k, v in sorted(p.items()))}-{t}"
         for n, p, t in SUITE_CELLS])
def test_suite_ci_matches_reference_and_oracle(name, params, target):
    t_sk, j_sk = T_SUITE[name], J_SUITE[name]
    shape = t_sk.shapes["ci"]
    inputs = t_sk.make_inputs(shape, params)
    expected = t_sk.oracle(inputs, shape, params)
    gsz, lsz = t_sk.launch_dims(shape, params)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        ref = j_compile(j_sk.build(shape, params), lsz, target="vector")(
            {k: v.copy() for k, v in inputs.items()}, gsz)
    got = t_compile(t_sk.build(shape, params), lsz, target=target)(
        inputs, gsz)
    for o in t_sk.outputs:
        g = got[o].numpy()
        assert g.tobytes() == np.asarray(ref[o]).tobytes(), (name, o)
        assert g.tobytes() == expected[o].tobytes(), (name, o)


def test_inputs_untouched_and_outputs_fresh():
    build, mk, gsz, lsz, scalars = CASES["uncond"]
    x = np.arange(8, dtype=np.float32)
    keep = x.copy()
    out = t_compile(builder(build, TKB), lsz)({"x": x}, gsz, scalars)
    assert x.tobytes() == keep.tobytes()
    assert not np.shares_memory(out["x"].numpy(), x)


# ---------------------------------------------------------------------------
# the reference's semantics, one case per rule
# ---------------------------------------------------------------------------

def _load_kernel(idx):
    def build(KB):
        b = KB("sem_load")
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "float32")
        g = b.global_id(0)
        y[g] = x[g * 0 + idx]
        return b.finish()
    return build


def _store_kernel(idx):
    def build(KB):
        b = KB("sem_store")
        y = b.arg_buffer("y", "float32")
        g = b.global_id(0)
        with b.if_(g == 0):
            y[g * 0 + idx] = 9.0
        return b.finish()
    return build


def _int_kernel(op):
    """Operands come from a buffer: constant operands would let XLA fold
    the operation at compile time, where an integer division by zero
    traps."""
    def build(KB):
        b = KB(f"sem_{op}")
        x = b.arg_buffer("x", "int32")
        y = b.arg_buffer("y", "int32")
        g = b.global_id(0)
        lhs, rhs = x[g * 2], x[g * 2 + 1]
        y[g] = {"div": lambda: lhs / rhs, "rem": lambda: lhs % rhs,
                "shl": lambda: lhs << rhs, "shr": lambda: lhs >> rhs}[op]()
        return b.finish()
    return build


def _float_kernel(fn_name):
    def build(KB):
        b = KB(f"sem_{fn_name}")
        x = b.arg_buffer("x", "float32")
        y = b.arg_buffer("y", "int32" if fn_name == "convert" else "float32")
        g = b.global_id(0)
        if fn_name == "convert":
            y[g] = x[g].astype("int32")
        else:
            y[g] = b._un("rint", x[g])
        return b.finish()
    return build


def _ints(a, c):
    return {"x": np.array([a, c], np.int32), "y": np.zeros(1, np.int32)}


def _flt(v, out=np.int32):
    return {"x": np.array([v], np.float32), "y": np.zeros(1, out)}


_F = np.float32
_X4 = {"x": np.arange(4, dtype=_F), "y": np.zeros(1, _F)}
SEMANTICS = [
    # (id, builder, buffers, expected output)
    ("load-clamp-minus1", _load_kernel(-1), _X4, [0.0]),
    ("load-clamp-minus7", _load_kernel(-7), _X4, [0.0]),
    ("load-clamp-n", _load_kernel(4), _X4, [3.0]),
    ("load-clamp-n+5", _load_kernel(9), _X4, [3.0]),
    ("store-wrap-minus1", _store_kernel(-1), {"y": np.zeros(4, _F)},
     [0.0, 0.0, 0.0, 9.0]),
    ("store-wrap-minus4", _store_kernel(-4), {"y": np.zeros(4, _F)},
     [9.0, 0.0, 0.0, 0.0]),
    ("store-drop-minus5", _store_kernel(-5), {"y": np.zeros(4, _F)},
     [0.0] * 4),
    ("store-drop-n", _store_kernel(4), {"y": np.zeros(4, _F)}, [0.0] * 4),
    ("div-trunc", _int_kernel("div"), _ints(-7, 2), [-3]),
    ("div-by-zero", _int_kernel("div"), _ints(7, 0), [-1]),
    ("div-min-by-minus1", _int_kernel("div"), _ints(-2**31, -1), [-2**31]),
    ("rem-trunc", _int_kernel("rem"), _ints(-7, 2), [-1]),
    ("rem-by-zero", _int_kernel("rem"), _ints(7, 0), [7]),
    ("shl-32", _int_kernel("shl"), _ints(5, 32), [0]),
    ("shl-40", _int_kernel("shl"), _ints(5, 40), [0]),
    ("shr-32-negative", _int_kernel("shr"), _ints(-5, 32), [-1]),
    ("convert-saturate-high", _float_kernel("convert"), _flt(3e9),
     [2**31 - 1]),
    ("convert-saturate-low", _float_kernel("convert"), _flt(-3e9),
     [-2**31]),
    ("convert-nan", _float_kernel("convert"), _flt(float("nan")), [0]),
    ("convert-trunc", _float_kernel("convert"), _flt(-2.75), [-2]),
    ("rint-half-even-2.5", _float_kernel("rint"), _flt(2.5, _F), [2.0]),
    ("rint-half-even-3.5", _float_kernel("rint"), _flt(3.5, _F), [4.0]),
    ("rint-half-even-minus0.5", _float_kernel("rint"), _flt(-0.5, _F),
     [-0.0]),
]


@pytest.mark.parametrize("target", ["vector", "loop"])
@pytest.mark.parametrize("sid,build,bufs,expected", SEMANTICS,
                         ids=[s[0] for s in SEMANTICS])
def test_reference_semantics(sid, build, bufs, expected, target):
    """Each rule of the reference's observable semantics, held bitwise
    against the JAX target and against the expected value."""
    got, ref = run_both(build, (1,), target, bufs, (1,), None)
    assert_match(got, ref, True, sid)
    out = got["y"].numpy()
    want = np.asarray(expected, out.dtype)
    assert out.tobytes() == want.tobytes(), (sid, out, want)
