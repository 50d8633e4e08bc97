"""The arithmetic of the SSD scan's tensor-core redesign, on the CPU.

For bfloat16 inputs the kernel (``csrc/ssd_scan.cu``) runs the scan's
products on tensor cores, the chunks in parallel, and takes each float32
operand of a product (``W x``, ``C S``, ``Bᵀ (decay ∘ x)``) as three
bfloat16 parts, ``hi = bf16(v)``, ``lo = bf16(v - hi)`` and ``lo2 =
bf16(v - hi - lo)``.  Here, with :func:`_split` taking an operand as the
kernel does and :func:`_plain_with_parts` running the plain version with
every product's operands so taken:

* three parts give every float32 operand back exactly, so the plain
  version with three parts is ``ssd_scan_plain`` bit for bit, and the
  bfloat16 plain version is the float32 function: equal to the plain
  version run on float32 copies of the same inputs, with y rounded once;
* the plain version matches the Pallas kernel in interpret mode
  (``repro.kernels.ssd_scan``) at small sizes, y within one bfloat16 ulp
  (``rtol=2**-7``, ``atol=1e-6``) and the float32 state within
  ``rtol=atol=1e-5``, the tolerances of ``tests/test_torch_ssd.py`` and
  of the card's comparison (``SSD_*_TOL`` in ``chip_smoke.py``);
* a planted variant that drops the lo parts (one part, a bfloat16
  operand) fails the card's state tolerance, and one with two parts (16
  significant bits) moves a y near zero past ``atol=1e-6`` at
  :data:`TWO_PARTS_CASE`.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels.ssd_scan import ssd_scan as jpallas  # noqa: E402

from repro_torch.kernels import ssd_scan as ss  # noqa: E402

BF16_ULP = 2.0 ** -7
Y_BF16_TOL = dict(rtol=BF16_ULP, atol=1e-6)
STATE_TOL = dict(rtol=1e-5, atol=1e-5)

# b, s, h, p, g, n, chunk: s a multiple of the chunk (the Pallas kernel
# asserts it), one group and two, chunk 8 and 16
CASES = [
    (2, 40, 4, 16, 1, 16, 8),
    (2, 40, 4, 16, 2, 16, 8),
    (2, 64, 4, 16, 1, 32, 8),
    (2, 64, 4, 16, 2, 32, 16),
]
#: (b, s, h, p, g, n, chunk, seed) where two parts move a y past atol
TWO_PARTS_CASE = (2, 24, 6, 16, 3, 8, 8, 152)


def _split(v: torch.Tensor, parts: int) -> torch.Tensor:
    """A float32 operand as the tensor-core kernel multiplies it, in
    float32: the sum of its first ``parts`` bfloat16 parts, each the next
    8 significant bits of what is left.  Three give back v (every sum here
    is exact); two keep 16 significant bits; one is bf16(v)."""
    out = v.to(torch.bfloat16).to(v.dtype)
    rest = v - out
    for _ in range(parts - 1):
        part = rest.to(torch.bfloat16).to(v.dtype)
        out, rest = out + part, rest - part
    return out


def _plain_with_parts(args, chunk, parts):
    """``ssd_scan_plain`` with both operands of every product taken as
    :func:`_split` gives them.  x, B and C hold bfloat16 values, which any
    number of parts gives back, so this splits exactly the kernel's
    float32 operands W, S and decay ∘ x."""
    matmul = torch.matmul
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "matmul",
                   lambda a, b: matmul(_split(a, parts), _split(b, parts)))
        return ss.ssd_scan_plain(*args, chunk)


def _inputs(b, s, h, p, g, n, seed):
    """x, dt (softplus of a normal), A in [-1.5, -0.5], B and C scaled by
    1/sqrt(n), float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)) \
        .astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, A, B, C


def _torch(arrays, dtype):
    """x, dt, B and C in ``dtype``, A in float32 (as the model gives
    them)."""
    return [torch.from_numpy(a) if i == 2 else torch.from_numpy(a).to(dtype)
            for i, a in enumerate(arrays)]


def _pallas(arrays, chunk):
    """The Pallas kernel in interpret mode on the same bfloat16 inputs."""
    j = [jnp.asarray(a) if i == 2 else jnp.asarray(a).astype(jnp.bfloat16)
         for i, a in enumerate(arrays)]
    y, st = jpallas(*j, chunk=chunk, interpret=True)
    return (np.asarray(y.astype(jnp.float32)),
            np.asarray(st.astype(jnp.float32)))


def _close(got, want, tol):
    return np.allclose(got.to(torch.float32).numpy(), want, **tol)


@pytest.mark.parametrize("scale", [1e-20, 1e-3, 1.0, 1e3, 1e20])
def test_three_parts_give_back_float32(scale):
    g = torch.Generator().manual_seed(int(-np.log10(scale) + 30))
    v = torch.randn(1 << 16, generator=g) * scale
    assert torch.equal(_split(v, 3), v)
    two = _split(v, 2)
    rel = ((two - v).abs() / v.abs()).max().item()
    assert 0 < rel <= 2.0 ** -16            # 16 significant bits, not 24
    assert torch.equal(_split(v, 1), v.to(torch.bfloat16).float())


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_three_part_products_are_the_plain_version(b, s, h, p, g, n, chunk):
    """The kernel's operand split changes no product, so the plain version
    computes what the kernel computes without taking the parts itself."""
    args = _torch(_inputs(b, s, h, p, g, n, seed=s + n + g), torch.bfloat16)
    y, st = ss.ssd_scan_plain(*args, chunk)
    y3, st3 = _plain_with_parts(args, chunk, 3)
    assert torch.equal(y, y3) and torch.equal(st, st3)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_bf16_plain_is_the_float32_function(b, s, h, p, g, n, chunk):
    arrays = _inputs(b, s, h, p, g, n, seed=s + n + g)
    y, st = ss.ssd_scan_plain(*_torch(arrays, torch.bfloat16), chunk)
    # the same bfloat16 values as float32, through the float32 path
    y32, st32 = ss.ssd_scan_plain(
        *[t.float() for t in _torch(arrays, torch.bfloat16)], chunk)
    assert y.dtype == torch.bfloat16
    assert torch.equal(st, st32)
    assert torch.equal(y, y32.to(torch.bfloat16))


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_bf16_plain_matches_pallas_kernel(b, s, h, p, g, n, chunk):
    arrays = _inputs(b, s, h, p, g, n, seed=s * h + n + g)
    jy, jst = _pallas(arrays, chunk)
    y, st = ss.ssd_scan_plain(*_torch(arrays, torch.bfloat16), chunk)
    assert y.dtype == torch.bfloat16 and st.shape == (b, h, p, n)
    np.testing.assert_allclose(y.float().numpy(), jy, **Y_BF16_TOL)
    np.testing.assert_allclose(st.numpy(), jst, **STATE_TOL)


@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_dropping_the_lo_parts_fails_the_state_tolerance(b, s, h, p, g, n,
                                                        chunk):
    """One part, the operand rounded once to bfloat16: the state moves by
    ~1e-3, past the card's ``rtol=atol=1e-5``."""
    arrays = _inputs(b, s, h, p, g, n, seed=s * h + n + g)
    _, jst = _pallas(arrays, chunk)
    _, st = _plain_with_parts(_torch(arrays, torch.bfloat16), chunk, 1)
    assert not _close(st, jst, STATE_TOL)


def test_two_parts_move_a_y_near_zero_past_atol():
    b, s, h, p, g, n, chunk, seed = TWO_PARTS_CASE
    arrays = _inputs(b, s, h, p, g, n, seed)
    jy, _ = _pallas(arrays, chunk)
    args = _torch(arrays, torch.bfloat16)
    y, _ = ss.ssd_scan_plain(*args, chunk)
    assert _close(y, jy, Y_BF16_TOL)
    y2, _ = _plain_with_parts(args, chunk, 2)
    assert not _close(y2, jy, Y_BF16_TOL)
