"""The arithmetic of the attention kernels' redesigns, on the CPU.

Decode attention splits the cache across blocks (flash-decoding):
:func:`repro_torch.kernels.decode_attention.split_plan` cuts the cache
into whole 64-key tiles, and the plain version computes each split's
softmax state and combines them.  Here the plan covers the cache exactly
once and fills the card at the serving shape, and the split computation
equals the unsplit one (a dense masked softmax in float64, taken to
float32) within ``1e-6`` at lengths on the split boundaries and at 0:
both are the same function in float32 and differ in summation order only.

Flash attention's bfloat16 path multiplies P by V on tensor cores as two
bfloat16 parts, ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, and scales the
scores after the product; the plain version follows it.  Here it matches
the Pallas kernel in interpret mode within one bfloat16 ulp (``rtol=2**-7``,
``atol=1e-6``, the tolerance of ``tests/test_torch_flash.py``), and a P
rounded once to bfloat16, planted in its place, fails the card's one-ulp
tolerance (``rtol=2**-7``, ``atol=1e-5``, ``FLASH_BF16_TOL`` of
``chip_smoke.py`` and ``tests/test_torch_cuda_kernels.py``) at
:data:`PLANTED_SHAPE`.
"""

import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.flash_attention import flash_attention as jflash  # noqa: E402

from repro_torch.kernels import decode_attention as dec  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

BF16_ULP = 2.0 ** -7
BF16_TOL = dict(rtol=BF16_ULP, atol=1e-6)
FLASH_BF16_TOL = dict(rtol=BF16_ULP, atol=1e-5)
SPLIT_TOL = dict(rtol=1e-6, atol=1e-6)
#: (B, H, Hkv, Sq, Sk, D), causal, bfloat16: a shape where a
#: single-bfloat16 P moves outputs past the card's one-ulp tolerance
PLANTED_SHAPE = (1, 3, 1, 256, 256, 64)


@pytest.mark.parametrize("B,Hkv,S", [
    (8, 3, 2048), (1, 1, 1), (1, 1, 64), (1, 1, 65), (2, 4, 100),
    (4, 1, 256), (64, 8, 4096), (1, 2, 1 << 16), (3, 3, 0), (8, 3, 2047)])
def test_split_plan_covers_the_cache_once_in_whole_tiles(B, Hkv, S):
    n_split, kps = dec.split_plan(B, Hkv, S)
    assert kps % dec.TILE == 0 and kps >= dec.TILE
    assert n_split >= 1
    # every key of the cache in exactly one split, and no split past it
    assert n_split * kps >= S and (n_split - 1) * kps < max(S, 1)
    tiles = max(1, math.ceil(S / dec.TILE))
    if tiles * B * Hkv >= dec.TARGET_BLOCKS:
        assert B * Hkv * n_split >= dec.TARGET_BLOCKS


def test_split_plan_fills_the_card_at_the_serving_shape():
    """smollm-135m served with 8 slots and a 2048-token cache: 8 x 3 KV
    heads, at least two blocks for each of the H100's 132 SMs."""
    n_split, kps = dec.split_plan(8, 3, 2048)
    assert 8 * 3 * n_split >= 2 * 132
    assert n_split * kps == 2048


def _unsplit(q, kc, vc, lengths):
    """Decode attention as one masked softmax over the whole cache, in
    float64: zeros for a row with no valid key."""
    B, H, D = q.shape
    G = H // kc.shape[1]
    k = kc.double().repeat_interleave(G, dim=1)
    v = vc.double().repeat_interleave(G, dim=1)
    s = torch.einsum("bhd,bhsd->bhs", q.double() / math.sqrt(D), k)
    ok = torch.arange(kc.shape[2])[None, None, :] < lengths.long()[:, None,
                                                                    None]
    p = torch.softmax(s.masked_fill(~ok, float("-inf")), dim=-1)
    return torch.einsum("bhs,bhsd->bhd", torch.nan_to_num(p, nan=0.0), v)


@pytest.mark.parametrize("B,H,Hkv,D,S", [(8, 9, 3, 64, 2048),
                                         (2, 8, 2, 20, 300),
                                         (3, 32, 1, 64, 640)])
@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16])
def test_split_plain_equals_the_unsplit_softmax_on_split_boundaries(
        B, H, Hkv, D, S, cache):
    n_split, kps = dec.split_plan(B, Hkv, S)
    assert n_split > 1
    rng = np.random.default_rng(S + D)
    q = torch.tensor(rng.standard_normal((B, H, D)), dtype=torch.float32)
    kc = torch.tensor(rng.standard_normal((B, Hkv, S, D)),
                      dtype=torch.float32).to(cache)
    vc = torch.tensor(rng.standard_normal((B, Hkv, S, D)),
                      dtype=torch.float32).to(cache)
    edges = [0, kps - 1, kps, kps + 1, 2 * kps, S - 1, S, 1]
    lengths = torch.tensor([edges[i % len(edges)] for i in range(B)],
                           dtype=torch.int32)
    got = dec.decode_attention_plain(q, kc, vc, lengths)
    assert got.dtype == torch.float32
    want = _unsplit(q, kc, vc, lengths).float()
    torch.testing.assert_close(got, want, **SPLIT_TOL)
    assert torch.all(got[lengths == 0] == 0)


def test_split_plain_gives_zeros_when_every_length_is_zero():
    rng = np.random.default_rng(3)
    q = torch.tensor(rng.standard_normal((4, 6, 64)), dtype=torch.bfloat16)
    kc = torch.tensor(rng.standard_normal((4, 2, 512, 64)),
                      dtype=torch.bfloat16)
    got = dec.decode_attention_plain(q, kc, kc,
                                     torch.zeros(4, dtype=torch.int32))
    assert got.dtype == torch.bfloat16 and torch.all(got == 0)


def test_split_plain_matches_the_pallas_kernel_at_the_serving_shape():
    """The serving shape's split plan (16 splits of 128 keys) against the
    Pallas kernel's 256-key blocks, bfloat16 as served: both read the
    same cache values, compute in float32 and round once."""
    B, H, Hkv, D, S = 8, 9, 3, 64, 2048
    rng = np.random.default_rng(11)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    vc = rng.standard_normal((B, Hkv, S, D)).astype(np.float32)
    _, kps = dec.split_plan(B, Hkv, S)
    lens = np.array([0, kps - 1, kps, kps + 1, 1, 1000, S - 1, S], np.int32)
    want = jops.decode_attention(*(jnp.asarray(a, jnp.bfloat16)
                                   for a in (q, kc, vc)),
                                 jnp.asarray(lens), use_pallas=True)
    got = dec.decode_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, kc, vc)),
        torch.from_numpy(lens))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_ULP, atol=1e-4)


def _flash_pair(shape, causal=True, seed=0):
    """The bfloat16 plain version's output and the Pallas kernel's, in
    interpret mode, on the same inputs (float32 copies of both)."""
    B, H, Hkv, Sq, Sk, D = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    v = rng.standard_normal((B, Hkv, Sk, D)).astype(np.float32)
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)),
                  causal=causal, interpret=True)
    got, _ = fa.flash_attention_plain(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)), causal)
    assert got.dtype == torch.bfloat16
    return got.float(), torch.from_numpy(np.array(want.astype(jnp.float32)))


@pytest.mark.parametrize("shape,causal", [
    ((1, 3, 1, 256, 256, 64), True), ((2, 4, 2, 128, 128, 128), True),
    ((1, 4, 2, 64, 256, 64), True), ((2, 2, 1, 128, 64, 64), False)])
def test_hi_lo_plain_flash_matches_pallas_within_one_bf16_ulp(shape, causal):
    got, want = _flash_pair(shape, causal)
    torch.testing.assert_close(got, want, **BF16_TOL)


def test_a_single_bf16_p_fails_the_cards_one_ulp_tolerance(monkeypatch):
    """The hi/lo split is what keeps the tensor-core path within one ulp:
    with P rounded once to bfloat16 in its place, the same plain version
    fails ``FLASH_BF16_TOL`` at :data:`PLANTED_SHAPE`."""
    got, want = _flash_pair(PLANTED_SHAPE)
    torch.testing.assert_close(got, want, **FLASH_BF16_TOL)
    monkeypatch.setattr(fa, "_p_operand",
                        lambda p: p.to(torch.bfloat16).to(p.dtype))
    bad, _ = _flash_pair(PLANTED_SHAPE)
    assert not torch.allclose(bad, want, **FLASH_BF16_TOL)


def test_p_operand_keeps_sixteen_bits_of_p():
    p = torch.rand(4096, dtype=torch.float32)
    split = fa._p_operand(p)
    assert float(((split - p).abs() / p).max()) <= 2.0 ** -16
    assert float(((p.to(torch.bfloat16).float() - p).abs() / p).max()) \
        > 2.0 ** -10


@pytest.mark.parametrize("D", [64, 112, 128])
def test_bf16_plain_scales_the_scores_after_the_product(D):
    """sm_scale = 1/sqrt(D) on the f32 scores: the lse of a bfloat16 call
    is that of the float32 products of the same values, scaled after."""
    rng = np.random.default_rng(D)
    q, k, v = (torch.tensor(rng.standard_normal(s), dtype=torch.float32)
               .to(torch.bfloat16) for s in ((1, 2, 16, D), (1, 1, 16, D),
                                             (1, 1, 16, D)))
    _, lse = fa.flash_attention_plain(q, k, v, causal=False)
    s = torch.matmul(q.float(), k.float().repeat(1, 2, 1, 1)
                     .transpose(-1, -2)) * (1.0 / math.sqrt(D))
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("dtype,D,rows", [(torch.bfloat16, 64, 128),
                                          (torch.bfloat16, 112, 64),
                                          (torch.bfloat16, 128, 64),
                                          (torch.float32, 64, 64),
                                          (torch.float32, 112, 64),
                                          (torch.float32, 128, 64)])
def test_block_q_names_every_dtype_and_head_size_the_kernel_takes(dtype, D,
                                                                  rows):
    assert fa.BLOCK_Q[(dtype, D)] == rows
    assert set(fa.BLOCK_Q) == {(t, d) for t in (torch.bfloat16, torch.float32)
                               for d in fa.HEAD_DIMS}
