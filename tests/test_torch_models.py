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
    """``use_kernels=False`` runs the blocked attention and matches the
    reference's training forward; ``use_kernels=True`` asks for the flash
    kernel, which has no port yet, and raises."""
    jcfg, tcfg, jp, tp = _pair("float32", False, seed=2)
    toks = np.random.default_rng(2).integers(0, 512, (2, 12)).astype(np.int32)
    jl, _, _ = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                        mode="train")
    tl, _, nc = forward(tp, torch.from_numpy(toks).long(), tcfg)
    assert nc is None
    _check(tl, jl, "float32", "logits")
    with pytest.raises(NotImplementedError, match="ROADMAP §B.4"):
        forward(tp, torch.from_numpy(toks).long(),
                dataclasses.replace(tcfg, use_kernels=True))


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
    assert tconfigs.ARCH_IDS == [ARCH]
    with pytest.raises(KeyError, match="ROADMAP A.8"):
        tconfigs.get_config("mamba2-780m")
    with pytest.raises(KeyError, match="unknown"):
        tconfigs.get_config("gpt-9")
    with pytest.raises(NotImplementedError, match="ROADMAP A.8"):
        model_defs(dataclasses.replace(full, act="gelu"))
