"""The port's SSD scan (``repro_torch.kernels.ssd_scan``, ``ref.ssd_scan``,
``ref.ssd_decode_step``) held against ``repro.kernels`` on the CPU.

The same seeded numpy inputs go through the reference's Pallas
``ssd_scan`` (interpret mode) and ``repro.kernels.ref.ssd_scan(...,
return_state=True)``, and through the port's ``ssd_scan_plain`` (the
kernel's plain version, which follows the Pallas math) and
``ref.ssd_scan``.  Like is compared with like — the plain version with
the Pallas kernel, the port's ref with the reference's ref — on y *and*
the final state, which the reference's own kernel test drops (ROADMAP
C.4) but serving carries from prefill into decode.  Tolerances, and why:

* float32: ``rtol=atol=1e-5``.  The two frameworks sum the matmuls in
  other orders and their ``exp`` differ in the last ulp; the values are
  O(1).
* bfloat16 inputs: the state is float32 in every version, so it is held
  at the float32 tolerance.  y is computed in float32 and rounded once to
  bfloat16, so the two sides may land one bfloat16 ulp apart:
  ``rtol=2**-7`` with ``atol=1e-6``.
* The port's two paths (plain version and ref) are two formulations
  that round at other places (the ref's ``C Bᵀ`` is a bfloat16 product,
  as the reference's einsum makes it): ``tests/test_kernels.py``'s
  bfloat16 tolerance, ``atol=rtol=3e-2``, and the float32 one above.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan as jpallas  # noqa: E402

from repro_torch.core.errors import InvalidArgError  # noqa: E402
from repro_torch.kernels import KERNELS, ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.kernels.ssd_scan import (ssd_scan,  # noqa: E402
                                          ssd_scan_plain)

BF16_ULP = 2.0 ** -7
F32_TOL = dict(rtol=1e-5, atol=1e-5)
Y_BF16_TOL = dict(rtol=BF16_ULP, atol=1e-6)
PATHS_BF16_TOL = dict(rtol=3e-2, atol=3e-2)

# b, s, h, p, g, n, chunk: s a multiple of the chunk, s equal to it, one
# group and several
CASES = [
    (2, 16, 4, 8, 1, 16, 8),
    (1, 8, 4, 8, 2, 16, 8),
    (2, 24, 6, 16, 3, 8, 8),
    (1, 32, 2, 8, 1, 32, 16),
]


def _inputs(b, s, h, p, g, n, seed, dt_scale=1.0):
    """x, dt (softplus of a normal, so positive), A in [-1.5, -0.5], B
    and C scaled by 1/sqrt(n): float32 numpy arrays from ``seed``."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = (np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0))
          * dt_scale).astype(np.float32)
    A = (-rng.uniform(0.5, 1.5, h)).astype(np.float32)
    B = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    C = (rng.standard_normal((b, s, g, n)) / np.sqrt(n)).astype(np.float32)
    return x, dt, A, B, C


def _both(arrays, dtype):
    """The inputs for each package: x, dt, B and C in ``dtype``, A in
    float32 (as the model gives them)."""
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = getattr(torch, dtype)
    j, t = [], []
    for i, a in enumerate(arrays):
        if i == 2:
            j.append(jnp.asarray(a))
            t.append(torch.from_numpy(a))
        else:
            j.append(jnp.asarray(a).astype(jd))
            t.append(torch.from_numpy(a).to(td))
    return j, t


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, tol, what):
    np.testing.assert_allclose(_np(got), _np(want), err_msg=what, **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_plain_matches_pallas_kernel(b, s, h, p, g, n, chunk, dtype):
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(b, s, h, p, g, n, seed=s * h + n), dtype)
    jy, jst = jpallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    ty, tst = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    assert tst.shape == (b, h, p, n)
    _close(ty, jy, F32_TOL if dtype == "float32" else Y_BF16_TOL, "y")
    _close(tst, jst, F32_TOL, "final state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", CASES)
def test_ref_matches_reference_ref(b, s, h, p, g, n, chunk, dtype):
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(b, s, h, p, g, n, seed=s * h + n + 1), dtype)
    jy, jst = jref.ssd_scan(jx, jdt, jA, jB, jC, chunk=chunk,
                            return_state=True)
    ty, tst = tref.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk,
                            return_state=True)
    assert ty.dtype == tx.dtype and tst.dtype == torch.float32
    _close(ty, jy, F32_TOL if dtype == "float32" else Y_BF16_TOL, "y")
    _close(tst, jst, F32_TOL, "final state")
    assert torch.equal(tref.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk), ty)
    # the port's two paths agree with each other as well
    py, pst = ssd_scan_plain(tx, tdt, tA, tB, tC, chunk)
    _close(py, ty, F32_TOL if dtype == "float32" else PATHS_BF16_TOL, "y")
    _close(pst, tst, F32_TOL if dtype == "float32" else PATHS_BF16_TOL,
           "final state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("g", [1, 2])
def test_decode_step_matches_reference(dtype, g):
    b, h, p, n = 3, 4, 8, 16
    rng = np.random.default_rng(40 + g)
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x, dt, A, B, C = _inputs(b, 1, h, p, g, n, seed=41 + g)
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        (x[:, 0], dt[:, 0], A, B[:, 0], C[:, 0]), dtype)
    jy, jnew = jref.ssd_decode_step(jnp.asarray(state), jx, jdt, jA, jB, jC)
    ty, tnew = tref.ssd_decode_step(torch.from_numpy(state), tx, tdt, tA,
                                    tB, tC)
    assert ty.dtype == torch.float32 and tnew.dtype == torch.float32
    assert jy.dtype == jnp.float32 and tnew.shape == (b, h, p, n)
    _close(ty, jy, F32_TOL, "y")
    _close(tnew, jnew, F32_TOL, "new state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_initial_state_carries_over_two_halves(dtype):
    """The scan of the whole equals the scan of the second half started
    from the first half's final state, in both packages."""
    b, s, h, p, g, n, chunk = 2, 32, 4, 8, 2, 16, 8
    arrays = _inputs(b, s, h, p, g, n, seed=50)
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(arrays, dtype)
    half = s // 2
    ty, tst = tref.ssd_scan(tx, tdt, tA, tB, tC, chunk=chunk,
                            return_state=True)
    _, t1 = tref.ssd_scan(tx[:, :half], tdt[:, :half], tA, tB[:, :half],
                          tC[:, :half], chunk=chunk, return_state=True)
    ty2, tst2 = tref.ssd_scan(tx[:, half:], tdt[:, half:], tA, tB[:, half:],
                              tC[:, half:], chunk=chunk, initial_state=t1,
                              return_state=True)
    _, j1 = jref.ssd_scan(jx[:, :half], jdt[:, :half], jA, jB[:, :half],
                          jC[:, :half], chunk=chunk, return_state=True)
    jy2, jst2 = jref.ssd_scan(jx[:, half:], jdt[:, half:], jA, jB[:, half:],
                              jC[:, half:], chunk=chunk, initial_state=j1,
                              return_state=True)
    y_tol = F32_TOL if dtype == "float32" else Y_BF16_TOL
    _close(ty2, jy2, y_tol, "second half y vs reference")
    _close(tst2, jst2, F32_TOL, "second half state vs reference")
    _close(ty2, ty[:, half:], y_tol, "second half y vs whole")
    _close(tst2, tst, F32_TOL, "carried state vs whole")


@pytest.mark.parametrize("s,chunk", [(13, 8), (5, 64), (1, 8), (70, 64)])
def test_plain_takes_any_length_as_dt_zero_padding(s, chunk):
    """Steps past s are taken with dt = 0: the result equals the ref on
    inputs padded that way to a chunk multiple, and the Pallas kernel on
    the same padding."""
    b, h, p, g, n = 2, 4, 8, 2, 16
    x, dt, A, B, C = _inputs(b, s, h, p, g, n, seed=60 + s)
    L = min(chunk, s)
    pad = (-s) % L
    padded = [np.concatenate([a, np.zeros((b, pad) + a.shape[2:],
                                          np.float32)], 1)
              for a in (x, dt, B, C)]
    ty, tst = ssd_scan_plain(*[torch.from_numpy(a) for a in (x, dt, A, B,
                                                              C)], chunk)
    assert ty.shape == (b, s, h, p)
    px, pdt, pB, pC = [torch.from_numpy(a) for a in padded]
    ry, rst = tref.ssd_scan(px, pdt, torch.from_numpy(A), pB, pC, chunk=L,
                            return_state=True)
    _close(ty, ry[:, :s], F32_TOL, "y vs padded ref")
    _close(tst, rst, F32_TOL, "state vs padded ref")
    jy, jst = jpallas(*[jnp.asarray(a) for a in (padded[0], padded[1], A,
                                                  padded[2], padded[3])],
                      chunk=L, interpret=True)
    _close(ty, jy[:, :s], F32_TOL, "y vs padded Pallas")
    _close(tst, jst, F32_TOL, "state vs padded Pallas")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_state_tolerance_sees_one_step_short(dtype):
    """A scan given s - 1 steps fails the state tolerance against the
    Pallas kernel's state for s steps: the comparisons above would see a
    state taken one token short."""
    b, s, h, p, g, n, chunk = 2, 16, 4, 8, 1, 16, 8
    (jx, jdt, jA, jB, jC), (tx, tdt, tA, tB, tC) = _both(
        _inputs(b, s, h, p, g, n, seed=70), dtype)
    _, jst = jpallas(jx, jdt, jA, jB, jC, chunk=chunk, interpret=True)
    _, short = ssd_scan_plain(tx[:, :-1], tdt[:, :-1], tA, tB[:, :-1],
                              tC[:, :-1], chunk)
    with pytest.raises(AssertionError):
        _close(short, jst, F32_TOL, "state one step short")


def test_causal_mask_selects_so_large_decays_stay_finite():
    """With large dt the masked exponent cs_i - cs_j (i < j) reaches
    thousands: exp overflows there, and a mask multiplied in would give
    inf * 0 = NaN.  The plain version selects, as the Pallas kernel does."""
    b, s, h, p, g, n, chunk = 1, 64, 2, 8, 1, 16, 64
    x, dt, A, B, C = _inputs(b, s, h, p, g, n, seed=80, dt_scale=200.0)
    ty, tst = ssd_scan_plain(*[torch.from_numpy(a) for a in (x, dt, A, B, C)],
                             chunk)
    assert bool(torch.isfinite(ty).all()) and bool(torch.isfinite(tst).all())
    jy, jst = jpallas(*[jnp.asarray(a) for a in (x, dt, A, B, C)],
                      chunk=chunk, interpret=True)
    _close(ty, jy, F32_TOL, "y")
    _close(tst, jst, F32_TOL, "final state")


@pytest.mark.parametrize("kernels", [False, True])
def test_ops_dispatch(kernels):
    x, dt, A, B, C = [torch.from_numpy(a)
                      for a in _inputs(1, 16, 4, 8, 1, 16, seed=90)]
    y, st = tops.ssd_scan(x, dt, A, B, C, chunk=8, use_kernels=kernels)
    want = ssd_scan_plain(x, dt, A, B, C, 8) if kernels else \
        tref.ssd_scan(x, dt, A, B, C, chunk=8, return_state=True)
    assert torch.equal(y, want[0]) and torch.equal(st, want[1])


def test_wrapper_refuses_tensors_that_are_neither_cpu_nor_cuda():
    """The plain version is taken only for CPU tensors; nothing launches."""
    meta = [torch.zeros(shape, device="meta") for shape in
            ((1, 8, 4, 8), (1, 8, 4), (4,), (1, 8, 1, 16), (1, 8, 1, 16))]
    before = KERNELS[2].launches
    with pytest.raises(InvalidArgError, match="CUDA"):
        ssd_scan(*meta)
    assert KERNELS[2].launches == before and KERNELS[2].name == "ssd_scan"
