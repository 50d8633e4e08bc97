"""The model kernels of ``repro_torch`` on the card (marker ``cuda``).

Each hand-written CUDA kernel against its plain PyTorch version on the
same CUDA tensors, at the shapes the serving path gives it (smollm-135m:
d 576; 9 query heads over 3 KV heads of 64 dims, 8 slots, a 2048-token
bfloat16 cache; mamba2-780m: d 1536 and 3072, a 512-token prefill of 48
SSD heads of 64 with state 128) and at a few others that reach the
kernels' other code paths; the wrappers' refusals; and full-width
forwards through the kernels.  Everything here skips without a CUDA
device and ``nvcc``.

Tolerances: rmsnorm in float32 ``rtol=1e-5, atol=1e-6`` (the kernel and
torch sum the squares in other orders) and in bfloat16 one bfloat16 ulp
(``rtol=2**-7``).  Decode attention: the kernel and its plain version read
the same cache values, accumulate in float32 and round once to q's dtype,
so a float32 q is held at ``1e-5`` and a bfloat16 q at one bfloat16 ulp
(``rtol=2**-7``) with ``atol=1e-4`` for outputs near zero; a row with no
valid key must be exact zeros.  That tolerance is shown to be tight enough
to see a length off by one: the kernel's output must fail it against the
plain version given ``lengths - 1`` or ``lengths + 1``, row by row.
SSD scan: both sides compute in float32 from the same inputs and differ
in summation order and ``exp`` only, so the float32 state (and a float32
y) is held at :data:`SSD_F32_TOL` and a bfloat16 y, rounded once, at one
bfloat16 ulp (``rtol=2**-7``, ``atol=1e-6``); the kernel's final state
must fail the state tolerance against the plain version given s - 1
steps.

Flash attention: the kernel and its plain version both compute in f32
from the same inputs and differ in summation order and ``exp`` only, so a
float32 output and the lse are held at ``rtol=1e-5, atol=1e-5`` and a
bfloat16 output, rounded once, at one bfloat16 ulp (``rtol=2**-7``,
``atol=1e-5``); rows with no valid key must be exact zeros.  That
tolerance must fail against a dense attention whose causal mask is
shifted by one key either way.

On a machine with the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

import re

import numpy as np
import pytest
import torch

from repro_torch.core.errors import BuildError, InvalidArgError
from repro_torch.core.nvcc import build_parallel, find_nvcc
from repro_torch.kernels import KERNELS
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain,
                                                  split_plan)
from repro_torch.kernels.flash_attention import (flash_attention,
                                                 flash_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain

BF16_ULP = 2.0 ** -7
SSD_F32_TOL = dict(rtol=1e-5, atol=1e-5)
SSD_Y_BF16_TOL = dict(rtol=BF16_ULP, atol=1e-6)
FLASH_F32_TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_BF16_TOL = dict(rtol=BF16_ULP, atol=1e-5)


def _decode_tol(qdt):
    """(rtol, atol) of decode attention for an output in ``qdt``."""
    return (1e-5, 1e-5) if qdt == torch.float32 else (BF16_ULP, 1e-4)


@pytest.fixture(scope="module")
def dev():
    """The first CUDA device, with both kernels built (one nvcc each, in
    parallel); skips without a card or nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    try:
        find_nvcc()
    except BuildError:
        pytest.skip("needs nvcc")
    build_parallel(k.nvcc_job() for k in KERNELS)
    return torch.device("cuda", 0)


def _t(a, dtype, dev):
    return torch.tensor(a, dtype=torch.float32, device=dev).to(dtype)


#: rmsnorm at the models' widths (smollm d 576; mamba2 d 1536 and 3072),
#: at a decode step's rows, a prefill's and the training forward's, and
#: two widths that take no 16-byte vector (the scalar kernel); then zamba2's
#: d 3584 and gated 7168 and llama-3.2-vision's 4096 (14, 28 and 16
#: vectors a lane in bf16) at a decode step's rows and a prefill's
RMS_SHAPES = [(rows, d) for d in (576, 1536, 3072) for rows in (8, 512, 16384)] \
    + [(5, 20), (3, 7)] \
    + [(rows, d) for d in (3584, 4096, 7168) for rows in (8, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", RMS_SHAPES)
@pytest.mark.parametrize("xdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain(dev, rows, d, xdt, wdt):
    rng = np.random.default_rng(rows * d)
    x = _t(rng.normal(size=(rows, d)) * 3.0, xdt, dev)
    w = _t(rng.normal(size=(d,)), wdt, dev)
    before = KERNELS[0].launches
    got = rmsnorm(x, w)
    want = rmsnorm_plain(x, w)
    torch.cuda.synchronize()
    assert KERNELS[0].launches == before + 1
    assert got.dtype == xdt and got.shape == x.shape
    if xdt == torch.float32:
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(),
                                   rtol=BF16_ULP, atol=0)


DECODE_SHAPES = [
    # B, H, Hkv, D, S: the serving path's, then the reference tests', then
    # a ragged S and a D the 16-byte loads do not divide; then lengths on
    # the split boundaries, every length 0, and a group of 32 query heads
    (8, 9, 3, 64, 2048),
    (2, 8, 2, 64, 512),
    (4, 8, 1, 128, 256),
    (2, 4, 2, 20, 100),
    (5, 9, 3, 64, 1024),
    (3, 6, 2, 64, 300),
    (2, 32, 1, 64, 384),
    # the new families' decode steps: zamba2's shared attention (32 over
    # 32 heads of 112), granite-moe, llama-3.2-vision, whisper's decoder
    (8, 32, 32, 112, 2048),
    (8, 24, 8, 64, 2048),
    (8, 32, 8, 128, 2048),
    (8, 12, 12, 64, 448),
]
SPLIT_EDGES = (5, 9, 3, 64, 1024)    # lengths keys_per_split - 1, + 0, + 1
ALL_EMPTY = (3, 6, 2, 64, 300)       # every length 0


def _decode_lengths(lens, B, H, Hkv, D, S):
    """The lengths a case of DECODE_SHAPES runs with: ``lens`` (drawn
    from the seed), with rows 1-3 on the split boundaries of
    :data:`SPLIT_EDGES` or every row 0 for :data:`ALL_EMPTY`."""
    if (B, H, Hkv, D, S) == SPLIT_EDGES:
        _, kps = split_plan(B, Hkv, S)
        lens[1:4] = kps - 1, kps, kps + 1
    elif (B, H, Hkv, D, S) == ALL_EMPTY:
        lens[:] = 0
    return lens


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,D,S", DECODE_SHAPES)
@pytest.mark.parametrize("qdt,cdt", [(torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16),
                                     (torch.float32, torch.float32)])
def test_decode_attention_kernel_matches_plain(dev, B, H, Hkv, D, S, qdt,
                                               cdt):
    rng = np.random.default_rng(B * H * D + S)
    q = _t(rng.normal(size=(B, H, D)), qdt, dev)
    kc = _t(rng.normal(size=(B, Hkv, S, D)), cdt, dev)
    vc = _t(rng.normal(size=(B, Hkv, S, D)), cdt, dev)
    lens = rng.integers(0, S + 1, B).astype(np.int32)
    lens[0], lens[-1] = 0, S
    lengths = torch.tensor(_decode_lengths(lens, B, H, Hkv, D, S),
                           device=dev)
    before = KERNELS[1].launches
    got = decode_attention(q, kc, vc, lengths)
    want = decode_attention_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert KERNELS[1].launches == before + 1
    assert got.dtype == qdt and got.shape == (B, H, D)
    assert torch.all(got[lengths == 0] == 0), \
        "a row with no valid key returns zeros"
    rtol, atol = _decode_tol(qdt)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,D,S", DECODE_SHAPES)
@pytest.mark.parametrize("qdt", [torch.bfloat16, torch.float32])
def test_decode_attention_tolerance_sees_a_length_off_by_one(dev, B, H, Hkv,
                                                             D, S, qdt):
    """Every row the comparison above passes would fail it had the kernel
    attended over one key fewer or one key more."""
    rng = np.random.default_rng(B * H * D + S + 1)
    q = _t(rng.normal(size=(B, H, D)), qdt, dev)
    kc = _t(rng.normal(size=(B, Hkv, S, D)), torch.bfloat16, dev)
    vc = _t(rng.normal(size=(B, Hkv, S, D)), torch.bfloat16, dev)
    lens = rng.integers(2, S, B).astype(np.int32)
    lens[0], lens[-1] = 2, S
    lengths = torch.tensor(_decode_lengths(lens, B, H, Hkv, D, S),
                           device=dev)
    got = decode_attention(q, kc, vc, lengths).float()
    rtol, atol = _decode_tol(qdt)
    for shift in (-1, 1):
        moved = (lengths + shift).clamp(0, S)
        other = decode_attention_plain(q, kc, vc, moved).float()
        for b in range(B):
            if int(moved[b]) == int(lens[b]):
                continue                   # length S has no key past it
            assert not torch.allclose(got[b], other[b], rtol=rtol,
                                      atol=atol), (shift, b, int(lens[b]))


@pytest.mark.cuda
def test_decode_attention_counts_one_launch_per_call(dev):
    """The split kernel and the combine are one launch of the wrapper,
    so a decode step of smollm-135m counts one per layer."""
    q = torch.randn(8, 9, 64, device=dev, dtype=torch.bfloat16)
    kc = torch.randn(8, 3, 2048, 64, device=dev, dtype=torch.bfloat16)
    lengths = torch.arange(8, dtype=torch.int32, device=dev) * 250
    before = KERNELS[1].launches
    outs = [decode_attention(q, kc, kc, lengths) for _ in range(5)]
    torch.cuda.synchronize()
    assert KERNELS[1].launches == before + 5
    assert all(torch.equal(o, outs[0]) for o in outs), "not deterministic"


@pytest.mark.cuda
def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    x = torch.randn(8, 576, device=dev)
    w = torch.ones(576, device=dev)
    with pytest.raises(InvalidArgError, match="dtype"):
        rmsnorm(x.half(), w)
    with pytest.raises(InvalidArgError, match="contiguous"):
        rmsnorm(torch.randn(576, 8, device=dev).t(), w)
    with pytest.raises(InvalidArgError, match="shape"):
        rmsnorm(x, w[:100])
    with pytest.raises(InvalidArgError):
        rmsnorm(x, w.cpu())
    q = torch.randn(8, 9, 64, device=dev, dtype=torch.bfloat16)
    kc = torch.zeros(8, 3, 128, 64, device=dev, dtype=torch.bfloat16)
    lens = torch.ones(8, dtype=torch.int32, device=dev)
    with pytest.raises(InvalidArgError, match="dtype"):
        decode_attention(q, kc, kc, lens.long())
    with pytest.raises(InvalidArgError, match="dtype"):
        decode_attention(q.half(), kc, kc, lens)
    with pytest.raises(InvalidArgError, match="dtype"):
        decode_attention(q, kc.float(), kc.float(), lens)
    with pytest.raises(InvalidArgError, match="contiguous"):
        decode_attention(q.transpose(0, 1).contiguous().transpose(0, 1), kc,
                         kc, lens)
    with pytest.raises(InvalidArgError, match="shape"):
        decode_attention(q, kc, kc[:, :, :64], lens)
    counts = [k.launches for k in KERNELS]
    torch.cuda.synchronize()
    assert counts == [k.launches for k in KERNELS], "a refused call launched"


@pytest.mark.cuda
def test_full_width_forward_advances_both_counters(dev):
    from repro_torch import configs
    from repro_torch.models import forward, init_caches, init_params

    cfg = configs.get_config("smollm-135m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    caches = init_caches(cfg, 2, 64, device=dev)
    toks = torch.randint(0, cfg.vocab, (2, 16), device=dev)
    before = [k.launches for k in KERNELS]
    with torch.inference_mode():
        logits, _, caches = forward(params, toks, cfg, caches=caches,
                                    mode="prefill")
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits2, _, caches = forward(params, nxt, cfg, caches=caches,
                                     mode="decode")
    torch.cuda.synchronize()
    after = [k.launches for k in KERNELS]
    # rmsnorm: 2 per layer + the final norm, in each of the two forwards;
    # decode attention: once per layer in the decode step
    assert after[0] - before[0] == 2 * (2 * cfg.n_layers + 1)
    assert after[1] - before[1] == cfg.n_layers
    assert logits2.shape == (2, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits2.float()).all())
    assert caches["len"].tolist() == [17, 17]


SSD_SHAPES = [
    # b, s, h, p, g, n, chunk: the served prefill (mamba2-780m, a 512-token
    # prompt), a long batch (32 chunks of state hand-off), a ragged s with
    # two groups, a state wider than 128 with p not a multiple of 16, a
    # small chunk with three groups, p and n odd (no 16-byte row: the
    # tensor-core path's element-wise loads and stores), p over two
    # 64-column blocks
    (1, 512, 48, 64, 1, 128, 64),
    (4, 2048, 48, 64, 1, 128, 64),
    (2, 200, 8, 64, 2, 128, 64),
    (1, 130, 4, 20, 1, 256, 64),
    (3, 37, 6, 16, 3, 16, 8),
    (2, 70, 4, 13, 1, 21, 32),
    (1, 100, 2, 80, 2, 32, 16),
    (1, 512, 112, 64, 1, 64, 64),   # zamba2-7b's served prefill
]


def _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed):
    """x, dt (positive), A (float32, in [-1.5, -0.5]), B, C on ``dev``:
    x, dt, B and C in ``dtype``."""
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal((b, s, h, p)), dtype, dev)
    dt = _t(np.log1p(np.exp(rng.standard_normal((b, s, h)) - 1.0)), dtype,
            dev)
    A = _t(-rng.uniform(0.5, 1.5, h), torch.float32, dev)
    B = _t(rng.standard_normal((b, s, g, n)) / np.sqrt(n), dtype, dev)
    C = _t(rng.standard_normal((b, s, g, n)) / np.sqrt(n), dtype, dev)
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_kernel_matches_plain(dev, b, s, h, p, g, n, chunk, dtype):
    x, dt, A, B, C = _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=s + n)
    before = KERNELS[2].launches
    y, st = ssd_scan(x, dt, A, B, C, chunk)
    py, pst = ssd_scan_plain(x, dt, A, B, C, chunk)
    torch.cuda.synchronize()
    assert KERNELS[2].launches == before + 1
    assert y.dtype == dtype and y.shape == (b, s, h, p)
    assert st.dtype == torch.float32 and st.shape == (b, h, p, n)
    np.testing.assert_allclose(
        y.float().cpu().numpy(), py.float().cpu().numpy(),
        **(SSD_F32_TOL if dtype == torch.float32 else SSD_Y_BF16_TOL))
    np.testing.assert_allclose(st.cpu().numpy(), pst.cpu().numpy(),
                               **SSD_F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_tolerance_sees_one_step_short(dev, b, s, h, p, g, n, chunk,
                                                dtype):
    """The kernel's final state fails the state tolerance against the
    plain version given s - 1 steps."""
    x, dt, A, B, C = _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=s + n)
    _, st = ssd_scan(x, dt, A, B, C, chunk)
    _, short = ssd_scan_plain(x[:, :-1].contiguous(), dt[:, :-1].contiguous(),
                              A, B[:, :-1].contiguous(),
                              C[:, :-1].contiguous(), chunk)
    assert not torch.allclose(st, short, **SSD_F32_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,g,n,chunk", [(2, 1000, 48, 64, 1, 128, 64),
                                               (1, 100, 4, 16, 2, 32, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_scan_gradient_is_the_reference_scans(dev, b, s, h, p, g, n,
                                                  chunk, dtype):
    """``SSDScan`` on CUDA tensors: the kernel's forward (one counted
    launch), held to the plain version, and the gradients of x, dt, A, B
    and C through y and the final state equal to autograd of
    ``ssd_scan_reference`` on the same inputs (the backward is that
    function's gradient; the loss is linear, so both get the same
    incoming gradients): within ``1e-5`` relative and ``1e-6`` of the
    largest entry in float32, one bfloat16 ulp in bfloat16, since a
    group's gradient may be summed by atomics in another order."""
    from repro_torch.kernels.ssd_scan import ssd_scan_reference
    args = _ssd_inputs(dev, dtype, b, s, h, p, g, n, seed=s + 7)
    rng = np.random.default_rng(s)
    wy = _t(rng.standard_normal((b, s, h, p)), torch.float32, dev)
    ws = _t(rng.standard_normal((b, h, p, n)), torch.float32, dev)

    def grads(fn):
        ts = [t.clone().requires_grad_(True) for t in args]
        y, st = fn(*ts, chunk)
        loss = (y.float() * wy).sum() + (st * ws).sum()
        return y.detach(), st.detach(), torch.autograd.grad(loss, ts)
    before = KERNELS[2].launches
    y, st, got = grads(ssd_scan)
    torch.cuda.synchronize()
    assert KERNELS[2].launches == before + 1
    py, pst = ssd_scan_plain(*args, chunk)
    np.testing.assert_allclose(
        y.float().cpu().numpy(), py.float().cpu().numpy(),
        **(SSD_F32_TOL if dtype == torch.float32 else SSD_Y_BF16_TOL))
    np.testing.assert_allclose(st.cpu().numpy(), pst.cpu().numpy(),
                               **SSD_F32_TOL)
    _, _, want = grads(ssd_scan_reference)
    assert KERNELS[2].launches == before + 1
    for name, a, w in zip("x dt A B C".split(), got, want):
        assert a.dtype == w.dtype, name
        assert bool(torch.isfinite(a.float()).all()), name
        w = w.float().cpu().numpy()
        rtol = 1e-5 if a.dtype == torch.float32 else BF16_ULP
        np.testing.assert_allclose(
            a.float().cpu().numpy(), w, rtol=rtol,
            atol=(1e-6 if a.dtype == torch.float32 else BF16_ULP)
            * float(np.abs(w).max()), err_msg=name)


@pytest.mark.cuda
def test_ssd_scan_wrapper_refuses_what_the_kernel_does_not_take(dev):
    x, dt, A, B, C = _ssd_inputs(dev, torch.bfloat16, 1, 64, 4, 16, 2, 16,
                                 seed=1)
    before = KERNELS[2].launches
    with pytest.raises(InvalidArgError, match="dtype"):
        ssd_scan(x, dt.float(), A, B, C)            # bf16 x with f32 dt
    with pytest.raises(InvalidArgError, match="dtype"):
        ssd_scan(x, dt, A.to(torch.bfloat16), B, C)
    with pytest.raises(InvalidArgError, match="dtype"):
        ssd_scan(x.half(), dt.half(), A, B.half(), C.half())
    with pytest.raises(InvalidArgError, match="chunk"):
        ssd_scan(x, dt, A, B, C, chunk=65)
    with pytest.raises(InvalidArgError, match="h % g"):
        ssd_scan(x, dt, A, B[:, :, :1].expand(1, 64, 3, 16).contiguous(),
                 C[:, :, :1].expand(1, 64, 3, 16).contiguous())
    with pytest.raises(InvalidArgError, match="n <= 256"):
        wide = torch.zeros(1, 64, 2, 264, dtype=torch.bfloat16, device=dev)
        ssd_scan(x, dt, A, wide, wide)
    with pytest.raises(InvalidArgError, match="contiguous"):
        ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C)
    with pytest.raises(InvalidArgError, match="shape"):
        ssd_scan(x, dt[:, :32], A, B, C)
    with pytest.raises(InvalidArgError):
        ssd_scan(x, dt, A.cpu(), B, C)
    torch.cuda.synchronize()
    assert KERNELS[2].launches == before, "a refused call launched"


@pytest.mark.cuda
def test_full_width_mamba2_forward_launches_ssd_scan_in_prefill_only(dev):
    from repro_torch import configs
    from repro_torch.models import forward, init_caches, init_params

    cfg = configs.get_config("mamba2-780m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    caches = init_caches(cfg, 1, 256, device=dev)
    toks = torch.randint(0, cfg.vocab, (1, 100), device=dev)
    before = [k.launches for k in KERNELS]
    with torch.inference_mode():
        logits, _, caches = forward(params, toks, cfg, caches=caches,
                                    mode="prefill")
        mid = [k.launches for k in KERNELS]
        nxt = logits[:, -1].argmax(-1)[:, None]
        logits2, _, caches = forward(params, nxt, cfg, caches=caches,
                                     mode="decode")
    torch.cuda.synchronize()
    after = [k.launches for k in KERNELS]
    # rmsnorm: ln1 and the gated norm in each layer, and ln_f, per forward;
    # ssd_scan: once per layer in the prefill, never in decode
    assert mid[0] - before[0] == after[0] - mid[0] == 2 * cfg.n_layers + 1
    assert mid[2] - before[2] == cfg.n_layers and after[2] == mid[2]
    assert after[1] == before[1]
    assert logits2.shape == (1, 1, cfg.padded_vocab)
    assert bool(torch.isfinite(logits2.float()).all())
    assert caches["len"].tolist() == [101]


FLASH_SHAPES = [
    # B, H, Hkv, Sq, Sk, D: the training shape (smollm-135m, 8 x 2048),
    # D = 128 with GQA, Sq < Sk, Sq > Sk (rows with no valid key), ragged
    # lengths with no GQA, one query row
    (8, 9, 3, 2048, 2048, 64),
    (2, 8, 2, 300, 300, 128),
    (2, 4, 2, 100, 260, 64),
    (1, 6, 2, 200, 70, 64),
    (3, 2, 2, 77, 77, 64),
    (2, 4, 1, 1, 129, 128),
    (2, 4, 2, 77, 93, 128),     # D = 128, Sq and Sk not multiples of 16
    (2, 6, 3, 37, 50, 64),      # Sq < 64: one partial q tile
    (1, 32, 32, 512, 512, 112),  # zamba2's shared attention, D = 112
    (2, 4, 2, 77, 93, 112),     # D = 112, GQA, ragged
    (1, 12, 12, 1500, 1500, 64),  # whisper-small's encoder
]


def _flash_inputs(dev, dtype, B, H, Hkv, Sq, Sk, D, seed):
    rng = np.random.default_rng(seed)
    return (_t(rng.standard_normal((B, H, Sq, D)), dtype, dev),
            _t(rng.standard_normal((B, Hkv, Sk, D)), dtype, dev),
            _t(rng.standard_normal((B, Hkv, Sk, D)), dtype, dev))


def _dense_attention(q, k, v, shift):
    """Causal attention in f32 written densely, with the mask moved by
    ``shift`` keys (j <= i + Sk - Sq + shift); zeros for a row with no
    valid key.  The planted fault of the tolerance check."""
    B, H, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    kf = k.float().repeat_interleave(H // Hkv, dim=1)
    vf = v.float().repeat_interleave(H // Hkv, dim=1)
    s = torch.matmul(q.float() / D ** 0.5, kf.transpose(-1, -2))
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    ok = j <= i + (Sk - Sq) + shift
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.matmul(torch.nan_to_num(p, nan=0.0), vf)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(dev, B, H, Hkv, Sq, Sk, D,
                                              causal, dtype):
    q, k, v = _flash_inputs(dev, dtype, B, H, Hkv, Sq, Sk, D, Sq + Sk)
    o, lse = flash_attention(q, k, v, causal=causal)
    po, plse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    tol = FLASH_F32_TOL if dtype == torch.float32 else FLASH_BF16_TOL
    torch.testing.assert_close(o.float(), po.float(), **tol)
    torch.testing.assert_close(lse, plse, **FLASH_F32_TOL)
    if causal and Sq > Sk:
        assert torch.all(o[:, :, :Sq - Sk] == 0), "a row with no key"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,Hkv,Sq,Sk,D", FLASH_SHAPES[1:5])
def test_flash_tolerance_sees_a_causal_offset_off_by_one(dev, B, H, Hkv, Sq,
                                                         Sk, D):
    q, k, v = _flash_inputs(dev, torch.float32, B, H, Hkv, Sq, Sk, D, 3)
    o, _ = flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(o, _dense_attention(q, k, v, 0),
                               **FLASH_F32_TOL)
    for shift in (-1, 1):
        assert not torch.allclose(o, _dense_attention(q, k, v, shift),
                                  **FLASH_F32_TOL), shift


@pytest.mark.cuda
def test_flash_attention_builds_without_spills(dev, tmp_path):
    """``nvcc -Xptxas -v`` on the kernel's source, with the library's
    flags: every kernel of it, the tensor-core ones included, keeps its
    registers (no spill stores or loads)."""
    from repro_torch.kernels.flash_attention import KERNEL
    spills = ptxas_spills(KERNEL.source_path, tmp_path)
    assert spills and all(v == (0, 0) for v in spills.values()), spills


SPILL_LINE = re.compile(r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def ptxas_spills(source, tmp_path):
    """``nvcc -Xptxas -v`` on a kernel's source with the library's flags:
    {kernel function: (bytes of spill stores, bytes of spill loads)}, read
    from ptxas's line for each function.  A spill line that does not parse
    fails the test."""
    import subprocess
    from repro_torch.core.nvcc import CSRC_DIR, NVCC_FLAGS
    r = subprocess.run(
        [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC_DIR),
         "-o", str(tmp_path / "lib.so"), str(source)],
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    spills, name = {}, None
    for ln in (r.stdout + r.stderr).splitlines():
        if "Function properties for " in ln:
            name = ln.split("Function properties for ", 1)[1].strip()
        elif "spill" in ln:
            m = SPILL_LINE.search(ln)
            assert m and name is not None, ln
            spills[name] = (int(m.group(1)), int(m.group(2)))
    return spills


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["ssd_scan", "rmsnorm"])
def test_redesigned_kernels_build_without_spills(dev, tmp_path, kernel):
    """Every kernel function of the source keeps its registers: ssd_scan's
    bfloat16 kernels (the two on tensor cores and the hand-off's two
    widths), rmsnorm's one-pass kernel at its six vectors per lane and
    its scalar kernel, each in four dtype pairs (but 28 vectors a lane,
    not built for a bfloat16 x with a float32 w).  ssd_scan's float32 scan
    (``ssd_scan_kernel``) is the first design, kept as it was, and is not
    held to it."""
    source = {k.name: k for k in KERNELS}[kernel].source_path
    spills = ptxas_spills(source, tmp_path)
    checked = {f: v for f, v in spills.items()
               if kernel != "ssd_scan" or "ssd_scan_kernel" not in f}
    expect = 4 if kernel == "ssd_scan" else 4 * (6 + 1) - 1
    assert len(checked) == expect, sorted(spills)
    spilled = {f: v for f, v in checked.items() if v != (0, 0)}
    assert not spilled, spilled


@pytest.mark.cuda
def test_ssd_launch_plan(dev):
    """The grids ssd_scan's launcher launches, as its library reports
    them: a bfloat16 call's chunk kernels over (b, h, chunk, 64 columns of
    P), its hand-off over (b, h, 256 threads of four state entries, or of
    one where p * n is odd); a float32 call's one scan over (b, h, 16
    columns of P); none where the launcher would refuse."""
    from repro_torch.kernels.ssd_scan import cuda_launches
    bf16 = torch.bfloat16
    served = dict(cuda_launches(1, 512, 48, 64, 1, 128, 64, bf16))
    assert served == {"ssd_state_mma_kernel": 384, "ssd_pass_kernel": 384,
                      "ssd_output_mma_kernel": 384}
    odd = dict(cuda_launches(2, 70, 4, 13, 1, 21, 32, bf16))
    assert odd["ssd_pass_kernel"] == 2 * 4 * 2
    long = dict(cuda_launches(4, 2048, 48, 64, 1, 128, 64, bf16))
    assert long["ssd_state_mma_kernel"] == 4 * 48 * 32 == \
        long["ssd_output_mma_kernel"]
    ragged = dict(cuda_launches(2, 100, 4, 80, 2, 32, 64, bf16))
    assert ragged["ssd_output_mma_kernel"] == 2 * 4 * 2 * 2
    assert cuda_launches(1, 512, 48, 64, 1, 128, 64, torch.float32) == \
        [("ssd_scan_kernel", 192)]
    assert cuda_launches(1, 512, 48, 64, 5, 128, 64, bf16) == []


@pytest.mark.cuda
def test_flash_wrapper_refuses_what_the_kernel_does_not_take(dev):
    q, k, v = _flash_inputs(dev, torch.bfloat16, 2, 4, 2, 16, 16, 64, 0)
    before = KERNELS[3].launches
    with pytest.raises(InvalidArgError, match="dtype"):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(InvalidArgError, match="dtype"):
        flash_attention(q, k.float(), v)
    with pytest.raises(InvalidArgError, match="D in"):
        flash_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                        v[..., :32].contiguous())
    with pytest.raises(InvalidArgError, match="H % Hkv"):
        flash_attention(q[:, :3].contiguous(), k, v)
    with pytest.raises(InvalidArgError, match="contiguous"):
        flash_attention(q.transpose(2, 3).contiguous().transpose(2, 3), k, v)
    with pytest.raises(InvalidArgError, match="shape"):
        flash_attention(q, k, v[:, :, :8])
    with pytest.raises(InvalidArgError):
        flash_attention(q, k.cpu(), v)
    with pytest.raises(NotImplementedError, match="FlashAttention"):
        flash_attention(q.float().requires_grad_(True), k.float(), v.float())
    torch.cuda.synchronize()
    assert KERNELS[3].launches == before, "a refused call launched"


@pytest.mark.cuda
def test_full_width_training_launches_flash_per_layer_and_per_remat(dev):
    """smollm-135m at full width: a no-cache forward launches flash
    attention once per layer, and a training step with ``remat="block"``
    twice (the forward and its recompute in the backward), with a
    gradient for every parameter, the norm weights included."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.models import forward, init_params, loss_fn

    cfg = configs.get_config("smollm-135m")
    params = init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab, (1, 256), device=dev)
    fa = KERNELS[3]
    before = fa.launches
    with torch.no_grad():
        forward(params, toks, cfg)
    torch.cuda.synchronize()
    assert fa.launches - before == cfg.n_layers
    for remat, per_step in (("block", 2), ("none", 1)):
        c = dataclasses.replace(cfg, remat=remat)
        leaves = [params["embed"], params["ln_f"]["w"],
                  params["layers"]["ln1"]["w"], params["layers"]["attn"]["wq"]]
        for p in leaves:
            p.requires_grad_(True)
        before = fa.launches
        loss, _ = loss_fn(params, {"tokens": toks,
                                   "targets": torch.roll(toks, -1, 1)}, c)
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        assert fa.launches - before == per_step * cfg.n_layers, remat
        for g in grads:
            assert bool(torch.isfinite(g).all()) and bool((g != 0).any())
