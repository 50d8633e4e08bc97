"""The model kernels of ``repro_torch`` on the card (marker ``cuda``).

Each hand-written CUDA kernel against its plain PyTorch version on the
same CUDA tensors, at the shapes the serving path gives it (smollm-135m:
d 576; 9 query heads over 3 KV heads of 64 dims, 8 slots, a 2048-token
bfloat16 cache) and at a few others that reach the kernels' other code
paths; the wrappers' refusals; and a full-width forward through both
kernels.  Everything here skips without a CUDA device and ``nvcc``.

Tolerances: rmsnorm in float32 ``rtol=1e-5, atol=1e-6`` (the kernel and
torch sum the squares in other orders) and in bfloat16 one bfloat16 ulp
(``rtol=2**-7``).  Decode attention: the kernel and its plain version read
the same cache values, accumulate in float32 and round once to q's dtype,
so a float32 q is held at ``1e-5`` and a bfloat16 q at one bfloat16 ulp
(``rtol=2**-7``) with ``atol=1e-4`` for outputs near zero; a row with no
valid key must be exact zeros.  That tolerance is shown to be tight enough
to see a length off by one: the kernel's output must fail it against the
plain version given ``lengths - 1`` or ``lengths + 1``, row by row.

On a machine with the card:

  PYTHONPATH=src python -m pytest -q tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.core.errors import BuildError, InvalidArgError
from repro_torch.core.nvcc import build_parallel, find_nvcc
from repro_torch.kernels import KERNELS
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_plain)
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_plain

BF16_ULP = 2.0 ** -7


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


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(8, 576), (512, 576), (5, 20), (3, 7)])
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
    # a ragged S and a D the 16-byte loads do not divide
    (8, 9, 3, 64, 2048),
    (2, 8, 2, 64, 512),
    (4, 8, 1, 128, 256),
    (2, 4, 2, 20, 100),
]


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
    lengths = torch.tensor(lens, device=dev)
    before = KERNELS[1].launches
    got = decode_attention(q, kc, vc, lengths)
    want = decode_attention_plain(q, kc, vc, lengths)
    torch.cuda.synchronize()
    assert KERNELS[1].launches == before + 1
    assert got.dtype == qdt and got.shape == (B, H, D)
    assert torch.all(got[0] == 0), "a row with no valid key returns zeros"
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
    lengths = torch.tensor(lens, device=dev)
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
