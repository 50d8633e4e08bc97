"""The port's Vecmathlib (``repro_torch.vml``) and the targets'
``use_vml=True`` path on the CPU, held against the reference.

* Functions: bitwise against ``repro.vml`` on the same float32 (and
  bfloat16) inputs, with ``torch.set_flush_denormal(True)`` because XLA's
  CPU backend flushes denormals.  The inputs are ``tests/test_vml.py``'s
  ranges, ±0, ±inf, NaN, denormals, x < -pi/4 for sin and cos, and exp
  at negative odd k (where ``_ldexp_f32``'s floor division matters).  A
  sin written with a truncating ``%`` must fail the same comparison.
* ``vml.ref``: the functions within ``tests/test_vml.py``'s tolerances of
  their torch oracles; the gradients of ``copysign``, ``erf`` and
  ``gelu_tanh`` against ``jax.grad`` of the reference's.
* Targets: a kernel ``y = op(x)`` for each op Vecmathlib serves, built
  with ``use_vml=True``, on the port's ``vector`` and ``loop`` targets:
  bitwise equal to the reference's vml functions applied to the same
  array.  The reference's own ``vector`` target runs its work-groups
  inside ``lax.fori_loop``, where XLA contracts multiply-adds into FMAs,
  so its ``use_vml=True`` results equal ``jax.jit`` of the vml function,
  not the function itself (ROADMAP C.14); the port is held to that target
  within ``tests/test_vml.py``'s tolerances, doubled, over those ranges.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import vml as jvml  # noqa: E402
from repro.core import KernelBuilder as JKB  # noqa: E402
from repro.core.api import compile_kernel as jcompile  # noqa: E402

from repro_torch import vml as tvml  # noqa: E402
from repro_torch.core import KernelBuilder as TKB  # noqa: E402
from repro_torch.core.api import _compile_kernel  # noqa: E402
from repro_torch.core.cases import VML_OPS, build_unary, vml_inputs  # noqa: E402
from repro_torch.core.targets.vector import _UN, _VML_OPS  # noqa: E402

# tests/test_vml.py's ranges and tolerances: (lo, hi, rtol, atol)
RANGES = {
    "exp": (-80.0, 80.0, 4e-6, 0.0),
    "log": (1e-30, 1e30, 4e-6, 1e-6),
    "sin": (-50.0, 50.0, 2e-5, 2e-7),
    "cos": (-50.0, 50.0, 2e-5, 2e-7),
    "sqrt": (0.0, 1e30, 2e-6, 0.0),
    "rsqrt": (1e-30, 1e30, 4e-6, 0.0),
    "reciprocal": (1e-30, 1e30, 4e-6, 0.0),
    "tanh": (-20.0, 20.0, 4e-5, 2e-7),
    "sigmoid": (-30.0, 30.0, 4e-5, 2e-7),
    "erf": (-5.0, 5.0, 1e-3, 1e-6),
}
NEW = ["sqrt", "reciprocal", "log", "sin", "cos", "tanh", "erf", "gelu_tanh",
       "exp"]


@pytest.fixture
def flush_denormals():
    assert torch.set_flush_denormal(True), "this CPU cannot flush denormals"
    try:
        yield
    finally:
        torch.set_flush_denormal(False)


def _range_draw(rng, lo, hi, n):
    if lo >= 0:    # log-uniform for positive-domain functions
        return np.exp(rng.uniform(np.log(max(lo, 1e-30)), np.log(hi), n))
    return rng.uniform(lo, hi, n)


def _inputs(name: str) -> np.ndarray:
    rng = np.random.default_rng(sorted(NEW).index(name))
    lo, hi = RANGES.get(name, (-10.0, 10.0))[:2]
    parts = [vml_inputs(rng, 4096), _range_draw(rng, lo, hi, 20_000)]
    if name in ("sin", "cos"):
        parts.append(rng.uniform(-50.0, -math.pi / 4, 4096))
    if name == "exp":
        # r = x - k ln2 with k odd and negative
        k = np.arange(-125, 0, 2, dtype=np.float64)
        parts += [k * math.log(2.0) + d for d in (-0.3, 0.0, 0.3)]
    return np.concatenate(parts).astype(np.float32)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bitwise(want: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Where two float32 arrays agree: equal bits, or both NaN."""
    return (want.view(np.int32) == got.view(np.int32)) | \
        (np.isnan(want) & np.isnan(got))


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vml_function_bitwise(flush_denormals, name, dtype):
    x = _inputs(name)
    want = _np(getattr(jvml, name)(jnp.asarray(x).astype(dtype)))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got_t = getattr(tvml, name)(tx)
    got = _np(got_t)
    same = _bitwise(want, got)
    assert same.all(), (name, dtype, x[~same][:5], want[~same][:5],
                        got[~same][:5])
    assert got_t.dtype == tx.dtype


def test_copysign_and_signbit_bitwise(flush_denormals):
    rng = np.random.default_rng(3)
    x = vml_inputs(rng, 2048)
    s = rng.permutation(x)
    want = _np(jvml.copysign(jnp.asarray(x), jnp.asarray(s)))
    got = _np(tvml.copysign(torch.from_numpy(x), torch.from_numpy(s)))
    assert want.tobytes() == got.tobytes()
    assert np.array_equal(np.asarray(jvml.signbit(jnp.asarray(x))),
                          tvml.signbit(torch.from_numpy(x)).numpy())
    # a scalar sign, and bfloat16 in and out
    xb = torch.from_numpy(x).to(torch.bfloat16)
    assert tvml.copysign(xb, -1.0).dtype == torch.bfloat16
    np.testing.assert_array_equal(
        _np(tvml.copysign(xb, -1.0)),
        _np(jvml.copysign(jnp.asarray(x).astype(jnp.bfloat16), -1.0)))


def test_float64_falls_back_to_torch():
    x = torch.linspace(0.1, 3.0, 64, dtype=torch.float64)
    for name in ("sqrt", "log", "sin", "cos", "tanh", "erf"):
        got = getattr(tvml, name)(x)
        assert got.dtype == torch.float64
        torch.testing.assert_close(got, getattr(tvml.ref, name)(x),
                                   rtol=0, atol=0)


def sin_truncating(x):
    """The port's sin with C's truncating ``%`` in place of floor modulo:
    the fault a CUDA translation makes by writing ``q % 4``."""
    r, q = tvml.core._sincos_reduce(x)
    sc = torch.where(torch.fmod(q, 2) == 0, tvml.core._sin_core(r),
                     tvml.core._cos_core(r))
    return tvml.core._sign(torch.fmod(q, 4) >= 2, x) * sc


def test_planted_truncating_modulo_fails(flush_denormals):
    x = _inputs("sin")
    want = _np(jvml.sin(jnp.asarray(x)))
    got = _np(sin_truncating(torch.from_numpy(x)))
    same = _bitwise(want, got)
    assert not same.all()
    # only arguments below -pi/4 (a negative quadrant) are wrong
    assert (x[~same] < -math.pi / 4).all()


# ---------------------------------------------------------------------------
# accuracy against the oracles, and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RANGES))
def test_vml_within_tolerance_of_ref(name):
    lo, hi, rtol, atol = RANGES[name]
    x = _range_draw(np.random.default_rng(42), lo, hi,
                    20_000).astype(np.float32)
    tx = torch.from_numpy(x)
    got = getattr(tvml, name)(tx).double().numpy()
    want = getattr(tvml.ref, name)(tx).double().numpy()
    err = np.abs(got - want) - (atol + rtol * np.abs(want))
    assert np.nanmax(err) <= 0, (name, x[np.nanargmax(err)])


def test_ref_matches_the_reference_oracles():
    from repro.vml import ref as jref
    x = np.linspace(-4.0, 4.0, 513, dtype=np.float32)
    for name in ("exp", "sin", "cos", "tanh", "erf", "fabs", "sigmoid",
                 "gelu_tanh", "silu", "reciprocal"):
        got = getattr(tvml.ref, name)(torch.from_numpy(x)).numpy()
        want = np.asarray(getattr(jref, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("name", ["copysign", "erf", "gelu_tanh"])
def test_gradients_match_jax_grad(name):
    x = np.linspace(-4.0, 4.0, 33, dtype=np.float32)
    s = np.where(np.arange(33) % 3 == 0, -1.0, 1.0).astype(np.float32)
    if name == "copysign":
        jf = lambda v, sv: jvml.copysign(v, sv)          # noqa: E731
        want = jax.vmap(jax.grad(jf))(jnp.asarray(x), jnp.asarray(s))
    else:
        want = jax.vmap(jax.grad(getattr(jvml, name)))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y = tvml.copysign(tx, torch.from_numpy(s)) if name == "copysign" \
        else getattr(tvml, name)(tx)
    (g,) = torch.autograd.grad(y.sum(), tx)
    np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6, err_msg=name)
    assert np.abs(g.numpy()).max() > 0.1    # not the silent zero gradient


# ---------------------------------------------------------------------------
# the targets' use_vml=True path
# ---------------------------------------------------------------------------

N_VEC, N_LOOP, LSZ = 4096, 128, 64


def _target_inputs(op):
    return vml_inputs(np.random.default_rng(VML_OPS.index(op)), N_VEC)


def _port(op, target, x, use_vml=True):
    k = _compile_kernel(lambda: build_unary(TKB, op), (LSZ,), target=target,
                        use_vml=use_vml)
    out = k({"x": torch.from_numpy(x.copy()),
             "y": torch.zeros(len(x))}, (len(x),))
    return out["y"].numpy()


def _reference_target(op, x):
    k = jcompile(lambda: build_unary(JKB, op), (LSZ,), target="vector",
                 use_vml=True)
    out = k({"x": jnp.asarray(x), "y": jnp.zeros(len(x), jnp.float32)},
            (len(x),))
    return np.asarray(out["y"])


def test_vml_ops_are_the_references():
    from repro.core.targets.vector import _VML_OPS as J_VML_OPS
    assert _VML_OPS == J_VML_OPS
    assert tuple(_VML_OPS) == VML_OPS


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("op", VML_OPS)
def test_use_vml_targets_equal_the_vml_functions(flush_denormals, op):
    x = _target_inputs(op)
    want = _np(getattr(jvml, op)(jnp.asarray(x)))
    for target, n in (("vector", N_VEC), ("loop", N_LOOP)):
        got = _port(op, target, x[:n])
        same = _bitwise(want[:n], got)
        assert same.all(), (op, target, x[:n][~same][:4])


@pytest.mark.filterwarnings("ignore::DeprecationWarning")
@pytest.mark.parametrize("op", VML_OPS)
def test_reference_target_contracts_and_the_port_stays_close(
        flush_denormals, op):
    x = _target_inputs(op)
    ref = _reference_target(op, x)
    # the reference target computes jax.jit of the vml function (C.14)
    jitted = np.asarray(jax.jit(getattr(jvml, op))(jnp.asarray(x)))
    assert _bitwise(jitted, ref).all(), op
    lo, hi, rtol, atol = RANGES[op]
    inside = (x >= lo) & (x <= hi)
    got = _port(op, "vector", x)
    err = np.abs(got[inside].astype(np.float64) - ref[inside]) \
        - 2 * (atol + rtol * np.abs(ref[inside].astype(np.float64)))
    assert err.max() <= 0, (op, x[inside][np.argmax(err)])


@pytest.mark.parametrize("op", VML_OPS)
def test_use_vml_false_keeps_torch_functions(op):
    x = np.abs(_target_inputs(op)[:512]) if op in ("log", "sqrt", "rsqrt") \
        else _target_inputs(op)[:512]
    got = _port(op, "vector", x, use_vml=False)
    want = _UN[op](torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes(), op
    if op == "rsqrt":   # and vml changes the result there
        assert got.tobytes() != _port(op, "vector", x).tobytes()


def test_use_vml_is_a_build_option_not_a_plan():
    from repro_torch.runtime import Context, Platform
    ctx = Context(platform=Platform(torch_device="cpu"))
    build = lambda: build_unary(TKB, "exp")      # noqa: E731
    x = _target_inputs("exp")[:256]
    outs = []
    for use_vml in (False, True):
        k = ctx.create_program(build, use_vml=use_vml).create_kernel()
        k.set_args(x=x, y=np.zeros(256, np.float32))
        outs.append(ctx.launch(k, (256,), (LSZ,))["y"].numpy())
    assert ctx.cache.stats.as_dict()["plan_misses"] == 1
    assert outs[0].tobytes() != outs[1].tobytes()
    # the exp polynomial stays within the vml tolerance of libm's exp
    inside = np.abs(x) <= 80
    np.testing.assert_allclose(outs[1][inside], outs[0][inside], rtol=4e-6)
