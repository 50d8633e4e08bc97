"""The port's dense model (``repro_torch.models``) held against
``repro.models`` on the CPU, at the smoke config of smollm-135m.

Parameters come from the reference's ``init_params`` and are carried
over with ``params_from_jax``; the same tokens go through both forwards:
a prefill, then four decode steps fed the reference's greedy tokens.
Logits, the KV caches and their lengths are compared for both settings of
the kernel switch — ``use_kernels=False`` against ``use_pallas=False``,
``use_kernels=True`` (the kernels' plain versions, on CPU tensors)
against ``use_pallas=True`` (the Pallas kernels in interpret mode).
Tolerances, and why:

* float32 model: logits within ``1e-5`` — the two frameworks sum the
  matmuls in other orders, and their ``exp``/``sin``/``cos`` differ in
  the last ulp.  The KV cache is bfloat16 even here (as in the
  reference), so a cached value may land one bfloat16 ulp away when the
  float32 projection behind it differs in its last bits: ``rtol=2**-7``
  with ``atol=1e-6`` for values that round to about zero.
* bfloat16 model: ``tests/test_kernels.py``'s bfloat16 tolerance,
  ``atol=rtol=3e-2``, for the logits and the caches alike.

The Mamba-2 (ssm) smoke model is held the same way, with its conv
windows and float32 SSD states in place of the KV caches, and at prompt
lengths the reference's cached prefill refuses (not a multiple of
``ssm_chunk``) against the reference's forward without a cache.  Its
bfloat16 logits (|logit| up to about 4, where one bfloat16 ulp is 2**-5)
are held at two bfloat16 ulps at their largest size, ``atol=2**-4``:
the reference's own jitted forward differs from the same forward run
eagerly by 0.043 there (XLA fuses bfloat16 ops and rounds at other
places), while the port follows the eager one op by op.
"""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import params as jparams  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import (forward, init_caches, init_params,  # noqa: E402
                                model_defs, params_from_jax)
from repro_torch.models import params as tparams  # noqa: E402

ARCH = "smollm-135m"
SSM_ARCH = "mamba2-780m"
BF16_ULP = 2.0 ** -7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _pair(dtype, kernels, seed=0):
    jcfg = jconfigs.get_smoke(ARCH, dtype=dtype, use_pallas=kernels)
    tcfg = tconfigs.get_smoke(ARCH, dtype=dtype, use_kernels=kernels)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _check(got, want, dtype, what):
    if dtype == "float32" and what == "logits":
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
    elif dtype == "float32":
        np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_ULP,
                                   atol=1e-6, err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=3e-2,
                                   atol=3e-2, err_msg=what)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, kernels):
    jcfg, tcfg, jp, tp = _pair(dtype, kernels)
    rng = np.random.default_rng(0)
    B, S, max_seq = 2, 10, 32
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jc = jinit_caches(jcfg, B, max_seq)
    tc = init_caches(tcfg, B, max_seq)
    assert tc["k"].dtype == torch.bfloat16, "the KV cache is always bf16"
    jl, _, jc = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                         caches=jc, mode="prefill")
    tl, _, tc = forward(tp, torch.from_numpy(toks).long(), tcfg,
                        caches=tc, mode="prefill")
    _check(tl, jl, dtype, "logits")
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, _, jc = jforward(jp, jnp.asarray(nxt[:, None]), jcfg,
                             BASELINE_RULES, caches=jc, mode="decode")
        tl, _, tc = forward(tp, torch.from_numpy(nxt[:, None]).long(), tcfg,
                            caches=tc, mode="decode")
        assert tl.dtype == getattr(torch, dtype)
        _check(tl, jl, dtype, "logits")
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [14, 14]
    _check(tc["k"], jc["k"], dtype, "k cache")
    _check(tc["v"], jc["v"], dtype, "v cache")


def test_per_row_lengths_in_one_decode_batch():
    """Rows at different cache lengths (continuous-batching slots) write
    and attend at their own positions."""
    jcfg, tcfg, jp, tp = _pair("float32", True, seed=1)
    rng = np.random.default_rng(1)
    B, max_seq = 3, 16
    jc = jinit_caches(jcfg, B, max_seq)
    tc = init_caches(tcfg, B, max_seq)
    kv = rng.normal(size=tuple(tc["k"].shape)).astype(np.float32)
    lens = np.array([0, 5, 15], np.int32)
    jc = dict(jc, k=jnp.asarray(kv).astype(jnp.bfloat16),
              v=jnp.asarray(-kv).astype(jnp.bfloat16), len=jnp.asarray(lens))
    tc = dict(tc, k=torch.from_numpy(kv).to(torch.bfloat16),
              v=torch.from_numpy(-kv).to(torch.bfloat16),
              len=torch.from_numpy(lens))
    toks = np.array([[1], [2], [3]], np.int32)
    jl, _, jc = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                         caches=jc, mode="decode")
    tl, _, tc = forward(tp, torch.from_numpy(toks).long(), tcfg, caches=tc,
                        mode="decode")
    _check(tl, jl, "float32", "logits")
    _check(tc["k"], jc["k"], "float32", "k cache")
    assert tc["len"].tolist() == [1, 6, 16]


def test_forward_without_cache():
    """The training forward (no cache) against the reference's with
    ``use_pallas=False``, for both settings of the kernel switch:
    ``use_kernels=False`` runs the blocked attention, ``use_kernels=True``
    the flash kernel's plain version (on CPU tensors) with q/k/v handed
    over in its (B, H, S, D) layout (ROADMAP §C.2).  It is not held to
    the reference's ``use_pallas=True``, whose call site reads the
    sequence axis as heads."""
    jcfg, tcfg, jp, tp = _pair("float32", False, seed=2)
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    jl, _, _ = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                        mode="train")
    tl, _, nc = forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert nc is None
    _check(tl, jl, "float32", "logits")
    with torch.no_grad():
        kl, _, _ = forward(tp, torch.from_numpy(toks).long(),
                           dataclasses.replace(tcfg, use_kernels=True))
    _check(kl, jl, "float32", "logits")


def test_compute_dtype_cast_follows_the_reference():
    """bf16 weights wherever the reference casts: every float32 leaf of
    two or more dims, which takes in the stacked per-layer norm weights;
    ``ln_f.w`` stays float32."""
    from repro_torch.models.model import _cast
    tcfg = tconfigs.get_smoke(ARCH)
    cp = _cast(init_params(tcfg, torch.Generator().manual_seed(0)), tcfg)
    assert cp["layers"]["ln1"]["w"].dtype == torch.bfloat16
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"].dtype == torch.bfloat16
    assert cp["ln_f"]["w"].dtype == torch.float32
    assert _cast(cp, tcfg)["embed"] is cp["embed"]


@pytest.mark.parametrize("smoke", [True, False])
def test_parameter_table_matches_reference(smoke):
    get = "get_smoke" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(ARCH), getattr(tconfigs, get)(ARCH)
    jdefs = jax.tree.leaves_with_path(
        jparams.model_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jparams.ParamDef))
    flat = {}

    def walk(t, path):
        if isinstance(t, tparams.ParamDef):
            flat[path] = t
            return
        for k, v in t.items():
            walk(v, path + (k,))
    walk(model_defs(tcfg), ())
    assert len(flat) == len(jdefs)
    for path, jd in jdefs:
        td = flat[tuple(p.key for p in path)]
        assert (td.shape, td.init, td.scale) == (jd.shape, jd.init, jd.scale)


def test_init_params_is_seeded_and_device_independent():
    tcfg = tconfigs.get_smoke(ARCH)
    a = init_params(tcfg, torch.Generator().manual_seed(3))
    b = init_params(tcfg, torch.Generator().manual_seed(3))
    c = init_params(tcfg, torch.Generator().manual_seed(4))
    assert torch.equal(a["embed"], b["embed"])
    assert not torch.equal(a["embed"], c["embed"])
    assert a["layers"]["attn"]["wq"].shape == (2, 64, 4, 16)
    assert a["embed"].dtype == torch.float32
    assert torch.all(a["ln_f"]["w"] == 1)


def test_params_from_jax_checks_the_tree():
    jcfg = jconfigs.get_smoke(ARCH)
    tcfg = tconfigs.get_smoke(ARCH)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    bad = dict(tree, embed=tree["embed"][:10])
    with pytest.raises(ValueError, match="embed"):
        params_from_jax(bad, tcfg)
    with pytest.raises(ValueError, match="keys"):
        params_from_jax({k: v for k, v in tree.items() if k != "ln_f"}, tcfg)
    got = params_from_jax(tree, tcfg)
    assert got["embed"].dtype == torch.float32
    np.testing.assert_array_equal(got["embed"].numpy(), tree["embed"])


def test_configs_registry():
    full = tconfigs.get_config(ARCH)
    ref = jconfigs.get_config(ARCH)
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv, full.hd,
            full.d_ff, full.vocab, full.tie_embeddings) == \
        (30, 576, 9, 3, 64, 1536, 49152, True)
    same = {f.name for f in dataclasses.fields(ref)} - {"use_pallas"}
    assert {f.name for f in dataclasses.fields(full)} - {"use_kernels"} \
        == same
    assert all(getattr(full, n) == getattr(ref, n) for n in same)
    assert full.use_kernels is True
    assert tconfigs.ARCH_IDS == [ARCH, SSM_ARCH]
    with pytest.raises(KeyError, match="ROADMAP A.8"):
        tconfigs.get_config("zamba2-7b")
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("gpt-9")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        model_defs(dataclasses.replace(full, act="gelu"))


# ---------------------------------------------------------------------------
# the ssm family: mamba2-780m at its smoke config
# ---------------------------------------------------------------------------

SSM_LOGITS_BF16_ATOL = 2.0 ** -4      # two bf16 ulps at |logit| in [2, 4)
SSM_CACHES = ("conv_x", "conv_B", "conv_C", "ssd")


def _ssm_pair(dtype, kernels, seed=0):
    jcfg = jconfigs.get_smoke(SSM_ARCH, dtype=dtype, use_pallas=kernels)
    tcfg = tconfigs.get_smoke(SSM_ARCH, dtype=dtype, use_kernels=kernels)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _ssm_logits_check(got, want, dtype):
    if dtype == "float32":
        _check(got, want, dtype, "logits")
    else:
        np.testing.assert_allclose(_np(got), _np(want), rtol=0,
                                   atol=SSM_LOGITS_BF16_ATOL, err_msg="logits")


def _ssm_cache_check(got, want, dtype):
    """The conv windows (in the model's dtype once a forward has written
    them, as the reference's scan returns them) and the float32 SSD
    states: at the logits' float32 tolerance, or the bfloat16 one."""
    for key in SSM_CACHES:
        assert got[key].dtype == getattr(torch, str(want[key].dtype)), key
        _check(got[key], want[key], dtype, "logits" if dtype == "float32"
               else key)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_prefill_and_decode_match_reference(dtype, kernels):
    """A cached prefill of 16 tokens (two chunks) and four decode steps fed
    the reference's greedy tokens: logits, conv windows, SSD states and
    lengths against ``repro.models.forward``."""
    jcfg, tcfg, jp, tp = _ssm_pair(dtype, kernels)
    rng = np.random.default_rng(3)
    B, S, max_seq = 2, 16, 32
    toks = rng.integers(0, tcfg.vocab, (B, S)).astype(np.int32)
    jc = jinit_caches(jcfg, B, max_seq)
    tc = init_caches(tcfg, B, max_seq)
    assert set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
    jl, _, jc = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                         caches=jc, mode="prefill")
    tl, _, tc = forward(tp, torch.from_numpy(toks).long(), tcfg,
                        caches=tc, mode="prefill")
    _ssm_logits_check(tl, jl, dtype)
    _ssm_cache_check(tc, jc, dtype)
    for step in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
        jl, _, jc = jforward(jp, jnp.asarray(nxt[:, None]), jcfg,
                             BASELINE_RULES, caches=jc, mode="decode")
        tl, _, tc = forward(tp, torch.from_numpy(nxt[:, None]).long(), tcfg,
                            caches=tc, mode="decode")
        assert tl.dtype == getattr(torch, dtype)
        _ssm_logits_check(tl, jl, dtype)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [20, 20]
    _ssm_cache_check(tc, jc, dtype)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("plen", [1, 2, 5, 13])
def test_mamba2_short_and_ragged_prefill_continue_the_sequence(plen, kernels):
    """A cached prefill of ``plen`` tokens (a ragged last chunk: taken as
    it is by the kernel, padded with dt = 0 for the ref; or shorter than
    the conv window) then three decode steps give
    the logits that the reference's forward without a cache gives over
    the whole sequence, position by position."""
    jcfg, tcfg, jp, tp = _ssm_pair("float32", kernels, seed=4)
    rng = np.random.default_rng(plen)
    seq = rng.integers(0, tcfg.vocab, (2, plen + 3)).astype(np.int32)
    want, _, _ = jforward(jp, jnp.asarray(seq), jcfg, BASELINE_RULES,
                          mode="train")
    tc = init_caches(tcfg, 2, 32)
    tl, _, tc = forward(tp, torch.from_numpy(seq[:, :plen]).long(), tcfg,
                        caches=tc, mode="prefill")
    _check(tl, want[:, :plen], "float32", "logits")
    for i in range(plen, plen + 3):
        tl, _, tc = forward(tp, torch.from_numpy(seq[:, i:i + 1]).long(),
                            tcfg, caches=tc, mode="decode")
        _check(tl, want[:, i:i + 1], "float32", "logits")
    assert tc["len"].tolist() == [plen + 3] * 2


@pytest.mark.parametrize("kernels", [False, True])
def test_mamba2_forward_without_cache(kernels):
    jcfg, tcfg, jp, tp = _ssm_pair("float32", kernels, seed=5)
    toks = np.random.default_rng(5).integers(0, 512, (2, 12)).astype(np.int32)
    jl, _, _ = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                        mode="train")
    tl, _, nc = forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert nc is None
    _check(tl, jl, "float32", "logits")


@pytest.mark.parametrize("smoke", [True, False])
def test_mamba2_parameter_table_matches_reference(smoke):
    get = "get_smoke" if smoke else "get_config"
    jcfg = getattr(jconfigs, get)(SSM_ARCH)
    tcfg = getattr(tconfigs, get)(SSM_ARCH)
    jdefs = jax.tree.leaves_with_path(
        jparams.model_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jparams.ParamDef))
    flat = {}

    def walk(t, path):
        if isinstance(t, tparams.ParamDef):
            flat[path] = t
            return
        for k, v in t.items():
            walk(v, path + (k,))
    walk(model_defs(tcfg), ())
    assert len(flat) == len(jdefs)
    for path, jd in jdefs:
        td = flat[tuple(p.key for p in path)]
        assert (td.shape, td.init, td.scale) == (jd.shape, jd.init, jd.scale)


def test_mamba2_init_params_draw_the_reference_distributions():
    tcfg = tconfigs.get_smoke(SSM_ARCH)
    a = init_params(tcfg, torch.Generator().manual_seed(3))
    b = init_params(tcfg, torch.Generator().manual_seed(3))
    mix = a["layers"]["mixer"]
    assert torch.equal(mix["w_x"], b["layers"]["mixer"]["w_x"])
    assert mix["A_log"].shape == (2, tcfg.ssm_heads)
    assert bool(((mix["A_log"] >= -1.5) & (mix["A_log"] <= -0.5)).all())
    dt = torch.nn.functional.softplus(mix["dt_bias"])
    assert bool(((dt >= 1e-3 - 1e-6) & (dt <= 1e-1 + 1e-6)).all())
    assert torch.all(mix["conv_x_b"] == 0) and torch.all(mix["D"] == 1)
    assert "unembed" in a and a["unembed"].shape == (64, 512)


def test_mamba2_config_and_cache_axes_are_the_reference_ones():
    from repro.models import cache_logical_axes as jaxes
    from repro_torch.models import cache_logical_axes as taxes
    full, ref = tconfigs.get_config(SSM_ARCH), jconfigs.get_config(SSM_ARCH)
    assert (full.family, full.n_layers, full.d_model, full.ssm_inner,
            full.ssm_heads, full.ssm_head_dim, full.ssm_state,
            full.ssm_groups, full.ssm_conv, full.ssm_chunk, full.vocab) == \
        ("ssm", 48, 1536, 3072, 48, 64, 128, 1, 4, 64, 50280)
    same = {f.name for f in dataclasses.fields(ref)} - {"use_pallas"}
    assert all(getattr(full, n) == getattr(ref, n) for n in same)
    smoke, jsmoke = tconfigs.get_smoke(SSM_ARCH), jconfigs.get_smoke(SSM_ARCH)
    assert all(getattr(smoke, n) == getattr(jsmoke, n) for n in same)
    assert taxes(smoke) == {k: tuple(v) for k, v in jaxes(jsmoke).items()}
