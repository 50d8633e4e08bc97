"""The port's hybrid, moe, vlm and encdec families held against
``repro.models`` on the CPU, at the smoke configs of zamba2-7b,
granite-moe-3b-a800m, phi3.5-moe-42b-a6.6b, llama-3.2-vision-11b and
whisper-small; and the parameter tables, configs and caches of all ten
architectures.

Parameters come from the reference's ``init_params`` through
``params_from_jax``; tokens and the auxiliary inputs (image patch or
audio frame embeddings) are drawn with numpy from a seed.  The vlm's
cross-attention gates are zeros at init (the image would reach no
logit), so every vlm test here draws them from N(0, 1) on both sides.

Tolerances are those of ``tests/test_torch_models.py``: float32 logits
``rtol=atol=1e-5``, a bfloat16 cache (even in a float32 model) one
bfloat16 ulp (``rtol=2**-7, atol=1e-6``), bfloat16 logits and caches
``3e-2``; the hybrid's bfloat16 logits, mostly Mamba-2 layers, the ssm
family's ``2**-4`` (two bfloat16 ulps at |logit| up to 4: one-ulp flips
of a scan's or a norm's bfloat16 output carried through the stack), which
its bfloat16 caches, downstream of the same flips, take as ``atol``
beside ``rtol=3e-2`` (the shared attention's values, 0.045 apart at
most in the run with the kernels off).  Two
choices of the reference run make those tolerances hold:

* Cached steps start equal.  Before each decode step the port's caches
  are set to the reference's: a float32 key that differs from the
  reference's in its last bits may round to the neighbouring bfloat16 in
  the cache, which moves the next step's logits by ~5e-4 (one ulp of a
  cached key in zamba2's shared attention).  Every step's logits and
  every cache leaf are compared before that reset.
* The bfloat16 reference runs op by op (``jax.disable_jit``), as the port
  does.  Jitted, XLA keeps the bfloat16 elementwise chains of a scanned
  layer in float32 between its fusions, and the reference then differs
  from its own eager run by up to 0.09 in zamba2's logits (six bfloat16
  ulps); a MoE router fed those differences picks another expert.

The forward without a cache is held in float32 to the reference's
``use_pallas=False``: its Pallas call site there reads the sequence axis
as heads (ROADMAP §C.2), which the port's kernel path repairs.  So is
whisper's prefill, whose encoder takes that path.  Elsewhere
``use_kernels=True`` runs the kernels' plain versions here (CPU tensors)
against the reference's Pallas kernels in interpret mode.
"""

import contextlib
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.distributed.sharding import BASELINE_RULES  # noqa: E402
from repro.models import cache_logical_axes as jaxes  # noqa: E402
from repro.models import forward as jforward  # noqa: E402
from repro.models import init_caches as jinit_caches  # noqa: E402
from repro.models import init_params as jinit_params  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import params as jparams  # noqa: E402

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import (cache_logical_axes, forward,  # noqa: E402
                                init_caches, init_params, loss_fn,
                                model_defs, params_from_jax)
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import params as tparams  # noqa: E402

FAMILIES = {"zamba2-7b": "hybrid", "granite-moe-3b-a800m": "moe",
            "phi3.5-moe-42b-a6.6b": "moe", "llama-3.2-vision-11b": "vlm",
            "whisper-small": "encdec"}
BF16_ULP = 2.0 ** -7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _check(got, want, dtype, what, hybrid=False):
    """Logits (and float32 state) at 1e-5 in float32, a bfloat16 cache in
    a float32 model at one bfloat16 ulp, anything bfloat16 at 3e-2 (the
    hybrid's at the ssm family's 2**-4, see the module's docstring)."""
    g, w = _np(got), _np(want)
    if dtype == "float32" and ("logits" in what or
                               str(getattr(want, "dtype", "")) == "float32"):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5, err_msg=what)
    elif dtype == "bfloat16" and hybrid:
        np.testing.assert_allclose(g, w, rtol=0 if "logits" in what else 3e-2,
                                   atol=2.0 ** -4, err_msg=what)
    elif dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=BF16_ULP, atol=1e-6,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=3e-2, atol=3e-2, err_msg=what)


def _pair(arch, dtype, kernels, seed=0, **over):
    """(reference cfg, port cfg, reference params, port params); the
    reference takes its Pallas kernels where the port takes its
    kernels."""
    fam = FAMILIES.get(arch, "")
    jcfg = jconfigs.get_smoke(arch, dtype=dtype, use_pallas=kernels, **over)
    tcfg = tconfigs.get_smoke(arch, dtype=dtype, use_kernels=kernels, **over)
    jp = jinit_params(jcfg, jax.random.PRNGKey(seed))
    if fam == "vlm":
        jp["cross"]["gate"] = jnp.asarray(np.random.default_rng(seed + 99)
                                          .standard_normal(
                                              jp["cross"]["gate"].shape),
                                          jnp.float32)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), tcfg)
    return jcfg, tcfg, jp, tp


def _aux(cfg, B, seed):
    """The family's auxiliary inputs, numpy float32 from ``seed``."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        return {"img_embeds": rng.standard_normal(
            (B, cfg.n_img_tokens, cfg.d_model)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    return {}


def _both(aux):
    return ({k: jnp.asarray(v) for k, v in aux.items()},
            {k: torch.from_numpy(v) for k, v in aux.items()})


def _sync(tc, jc):
    """The port's caches set to copies of the reference's, leaf by leaf,
    in the port's dtypes (copies: the port writes its caches in place)."""
    return {k: torch.tensor(np.array(jnp.asarray(v).astype(jnp.float32)))
            .to(tc[k].dtype) if k != "len" else torch.tensor(np.array(v))
            for k, v in jc.items()}


def _eager(dtype):
    return jax.disable_jit() if dtype == "bfloat16" \
        else contextlib.nullcontext()


# ---------------------------------------------------------------------------
# the five smoke configs against the reference
# ---------------------------------------------------------------------------

def cached_case(arch, dtype, kernels):
    """A cached prefill of 16 tokens (two ssm chunks in zamba2) and four
    decode steps fed the reference's greedy tokens: logits and every
    cache leaf after each forward, lengths at the end.  The moe and the
    cross-attending families' cases run from
    ``tests/test_torch_families_moe.py`` and
    ``tests/test_torch_families_xattn.py``, so that a run that hands out
    whole files spreads them over its workers."""
    jcfg, tcfg, jp, tp = _pair(arch, dtype, kernels)
    B, S, max_seq = 2, 16, 32
    toks = np.random.default_rng(1).integers(0, tcfg.vocab, (B, S)) \
        .astype(np.int32)
    jaux, taux = _both(_aux(tcfg, B, 2))
    jc, tc = jinit_caches(jcfg, B, max_seq), init_caches(tcfg, B, max_seq)
    assert set(tc) == set(jc)
    for key in tc:
        assert tuple(tc[key].shape) == jc[key].shape, key
        assert tc[key].dtype == getattr(torch, str(jc[key].dtype)), key
    # whisper's encoder runs in the prefill: the reference's attention
    # without its Pallas call site there (ROADMAP §C.2)
    jpre = dataclasses.replace(jcfg, use_pallas=False) \
        if tcfg.family == "encdec" else jcfg
    with _eager(dtype), torch.inference_mode():
        jl, _, jc = jforward(jp, jnp.asarray(toks), jpre, BASELINE_RULES,
                             aux_inputs=jaux, caches=jc, mode="prefill")
        tl, _, tc = forward(tp, torch.from_numpy(toks).long(), tcfg,
                            aux_inputs=taux, caches=tc, mode="prefill")
        hyb = tcfg.family == "hybrid"
        _check(tl, jl, dtype, "prefill logits", hyb)
        for key in jc:
            _check(tc[key], jc[key], dtype, f"prefill {key}", hyb)
        for step in range(4):
            nxt = np.asarray(jnp.argmax(jl[:, -1], axis=-1)).astype(np.int32)
            tc = _sync(tc, jc)
            jl, _, jc = jforward(jp, jnp.asarray(nxt[:, None]), jcfg,
                                 BASELINE_RULES, aux_inputs=jaux, caches=jc,
                                 mode="decode")
            tl, _, tc = forward(tp, torch.from_numpy(nxt[:, None]).long(),
                                tcfg, aux_inputs=taux, caches=tc,
                                mode="decode")
            assert tl.dtype == getattr(torch, dtype)
            _check(tl, jl, dtype, f"step {step} logits", hyb)
            for key in jc:
                _check(tc[key], jc[key], dtype, f"step {step} {key}", hyb)
    assert tc["len"].tolist() == np.asarray(jc["len"]).tolist() == [20, 20]


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_reference(dtype, kernels):
    cached_case("zamba2-7b", dtype, kernels)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", list(FAMILIES))
def test_forward_without_cache_and_aux_loss(arch, kernels):
    """The training forward's logits and MoE aux loss (float32) against
    the reference's with ``use_pallas=False`` (ROADMAP §C.2); 12 tokens,
    under a MoE group of 16, so no group is padded."""
    jcfg, tcfg, jp, tp = _pair(arch, "float32", False, seed=3)
    tcfg = dataclasses.replace(tcfg, use_kernels=kernels)
    toks = np.random.default_rng(3).integers(0, tcfg.vocab, (2, 12)) \
        .astype(np.int32)
    jaux, taux = _both(_aux(tcfg, 2, 4))
    jl, ja, _ = jforward(jp, jnp.asarray(toks), jcfg, BASELINE_RULES,
                         aux_inputs=jaux, mode="train")
    with torch.no_grad():
        tl, ta, nc = forward(tp, torch.from_numpy(toks).long(), tcfg,
                             aux_inputs=taux)
    assert nc is None and ta.dtype == torch.float32
    _check(tl, jl, "float32", "logits")
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-5, atol=1e-6)
    assert (float(ta) > 0) == (tcfg.family == "moe")


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m",
                                  "llama-3.2-vision-11b", "whisper-small"])
def test_loss_fn_reads_the_batchs_auxiliary_inputs(arch):
    """``loss_fn`` over a synthetic batch (its image or frame embeddings
    included) equals the reference's, ce and aux."""
    from repro.data.pipeline import synth_batch as jsynth
    from repro.models import loss_fn as jloss
    from repro_torch.data import synth_batch

    jcfg, tcfg, jp, tp = _pair(arch, "float32", False, seed=5)
    batch = synth_batch(tcfg, 2, 12, step=3, seed=5)
    ref = jsynth(jcfg, 2, 12, step=3, seed=5)
    assert set(batch) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(batch[k], ref[k])
    jl, jm = jloss(jp, {k: jnp.asarray(v) for k, v in ref.items()}, jcfg,
                   BASELINE_RULES)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        tl, tm = loss_fn(tp, tb, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]), rtol=1e-5,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# hybrid: short and ragged prompts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("plen", [1, 2, 5, 13])
def test_hybrid_short_and_ragged_prefill_continue_the_sequence(plen,
                                                               kernels):
    """A cached prefill of ``plen`` tokens (a ragged last ssm chunk, or
    shorter than the conv window) then three decode steps give the
    logits of the reference's forward without a cache over the whole
    sequence, position by position: the shared attention's caches of
    both applications and the mamba states carry on.  The shared
    attention's caches are float32 here, so that the cached keys are
    those of the forward without a cache: a bfloat16 cache rounds them,
    which moves these logits by up to 6e-3."""
    jcfg, tcfg, jp, tp = _pair("zamba2-7b", "float32", False, seed=6)
    tcfg = dataclasses.replace(tcfg, use_kernels=kernels)
    seq = np.random.default_rng(plen).integers(0, tcfg.vocab, (2, plen + 3)) \
        .astype(np.int32)
    want, _, _ = jforward(jp, jnp.asarray(seq), jcfg, BASELINE_RULES,
                          mode="train")
    tc = init_caches(tcfg, 2, 32)
    assert tc["attn_k"].shape[0] == tcfg.n_layers // tcfg.attn_every == 2
    tc.update(attn_k=tc["attn_k"].float(), attn_v=tc["attn_v"].float())
    with torch.inference_mode():
        tl, _, tc = forward(tp, torch.from_numpy(seq[:, :plen]).long(),
                            tcfg, caches=tc, mode="prefill")
        _check(tl, want[:, :plen], "float32", "logits")
        for i in range(plen, plen + 3):
            tl, _, tc = forward(tp, torch.from_numpy(seq[:, i:i + 1]).long(),
                                tcfg, caches=tc, mode="decode")
            _check(tl, want[:, i:i + 1], "float32", "logits")
    assert tc["len"].tolist() == [plen + 3] * 2
    assert bool((tc["attn_k"][:, :, :, :plen + 3] != 0).any(-1).all())


# ---------------------------------------------------------------------------
# moe: capacity dropping, and the aux loss over padded groups (§C.16)
# ---------------------------------------------------------------------------

def _ref_route(x, router, cfg):
    """The reference ``moe``'s routing lines (layers.py:167-186), in jnp:
    (gate_idx, keep, valid) for x (B, S, d)."""
    B, S, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    g = min(cfg.moe_group, S)
    pad = (-S) % g
    x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
    Sp = S + pad
    G = (B * Sp) // g
    C = max(1, int(g * K * cfg.capacity_factor / E))
    valid = jnp.broadcast_to(jnp.arange(Sp) < S, (B, Sp)).reshape(G, g)
    probs = jax.nn.softmax(jnp.einsum("gsd,de->gse", x.reshape(G, g, d),
                                      router).astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, K)
    onehot = jax.nn.one_hot(idx, E, dtype=jnp.int32) * valid[..., None, None]
    pos = jnp.cumsum(onehot.reshape(G, g * K, E), axis=1).reshape(
        G, g, K, E) - 1
    pos = jnp.sum(pos * onehot, axis=-1)
    return np.asarray(idx), np.asarray(pos < C), np.asarray(valid)


def _moe_inputs(seed, S, d=64):
    x = np.random.default_rng(seed).standard_normal((2, S, d)) \
        .astype(np.float32)
    return x


def test_moe_drops_the_same_token_expert_pairs_as_the_reference():
    """granite-moe's smoke layer with capacity_factor 0.5: a group of 16
    tokens over 5 experts, top 2, keeps 3 tokens an expert, so pairs are
    dropped.  The port keeps and drops the same (token, k) pairs, and its
    output equals the reference's ``moe``; with room for every pair the
    output moves."""
    jcfg, tcfg, jp, tp = _pair("granite-moe-3b-a800m", "float32", False,
                               seed=7, capacity_factor=0.5)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    lp_t = {k: v[0] for k, v in tp["layers"]["ffn"].items()}
    x = _moe_inputs(7, 16)
    idx, keep, valid = _ref_route(jnp.asarray(x), lp_j["router"], jcfg)
    r = tlayers.moe_route(torch.from_numpy(x), lp_t["router"], tcfg)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert r["C"] == 3 and not keep[valid].all(), "no pair was dropped"
    jy, jaux = jlayers.moe(jnp.asarray(x), lp_j, jcfg, BASELINE_RULES)
    ty, taux = tlayers.moe(torch.from_numpy(x), lp_t, tcfg)
    _check(ty, jy, "float32", "logits")
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    roomy, _ = tlayers.moe(torch.from_numpy(x), lp_t,
                           dataclasses.replace(tcfg, capacity_factor=4.0))
    assert float((roomy - ty).abs().max()) > 1e-3


@pytest.mark.parametrize("S", [16, 32, 20, 27])
def test_moe_aux_loss_over_padded_groups(S):
    """ROADMAP §C.16.  Where S is a multiple of the group (16, 32) the
    port's aux loss is the reference's.  Where it is not (20, 27), the
    reference's padded zero tokens route uniformly (their router logits
    are 0) and enter its averages: its loss is not the Switch loss of the
    real tokens, which the port computes (the same formula over each
    group's real tokens), and the outputs still agree."""
    jcfg, tcfg, jp, tp = _pair("granite-moe-3b-a800m", "float32", False,
                               seed=8)
    lp_j = jax.tree.map(lambda a: a[0], jp["layers"]["ffn"])
    lp_t = {k: v[0] for k, v in tp["layers"]["ffn"].items()}
    x = _moe_inputs(S, S)
    jy, jaux = jlayers.moe(jnp.asarray(x), lp_j, jcfg, BASELINE_RULES)
    ty, taux = tlayers.moe(torch.from_numpy(x), lp_t, tcfg)
    _check(ty, jy, "float32", "logits")
    r = tlayers.moe_route(torch.from_numpy(x), lp_t["router"], tcfg)
    v = r["valid"].float()[..., None]
    E, K = tcfg.n_experts, tcfg.top_k
    me = (r["probs"] * v).sum(1) / v.sum(1)
    ce = (F.one_hot(r["gate_idx"], E).float().sum(2) * v).sum(1) \
        / v.sum(1) / K
    real = float(E * (me * ce).sum(-1).mean())
    np.testing.assert_allclose(float(taux), real, rtol=1e-6)
    if S % tcfg.moe_group == 0:
        np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    else:
        assert abs(float(jaux) - real) > 1e-3 * real, \
            "the reference's aux loss no longer sees its padding"


# ---------------------------------------------------------------------------
# vlm: the image reaches the logits
# ---------------------------------------------------------------------------

def test_vlm_image_moves_the_logits():
    """With nonzero gates, a zero image and another image give other
    logits; with the init's zero gates the image reaches none, in both
    packages alike."""
    jcfg, tcfg, jp, tp = _pair("llama-3.2-vision-11b", "float32", False,
                               seed=9)
    toks = torch.from_numpy(np.random.default_rng(9).integers(
        0, tcfg.vocab, (2, 8)))
    img = torch.from_numpy(_aux(tcfg, 2, 10)["img_embeds"])
    with torch.no_grad():
        a, _, _ = forward(tp, toks, tcfg, aux_inputs={"img_embeds": img})
        z, _, _ = forward(tp, toks, tcfg,
                          aux_inputs={"img_embeds": torch.zeros_like(img)})
        o, _, _ = forward(tp, toks, tcfg,
                          aux_inputs={"img_embeds": img.flip(0)})
        assert float((a - z).abs().max()) > 1e-2
        assert float((a - o).abs().max()) > 1e-2
        closed = dict(tp, cross=dict(tp["cross"],
                                     gate=torch.zeros_like(
                                         tp["cross"]["gate"])))
        c1, _, _ = forward(closed, toks, tcfg, aux_inputs={"img_embeds": img})
        c2, _, _ = forward(closed, toks, tcfg,
                           aux_inputs={"img_embeds": torch.zeros_like(img)})
    assert torch.equal(c1, c2)


# ---------------------------------------------------------------------------
# all ten architectures: registry, parameter tables, caches
# ---------------------------------------------------------------------------

def test_registry_lists_the_reference_architectures():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert len(tconfigs.ARCH_IDS) == 10


def _same_fields(t, j):
    names = {f.name for f in dataclasses.fields(j)} - {"use_pallas"}
    assert {f.name for f in dataclasses.fields(t)} - {"use_kernels"} == names
    return {n: (getattr(t, n), getattr(j, n)) for n in names
            if getattr(t, n) != getattr(j, n)}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_configs_equal_the_reference_field_by_field(arch):
    assert _same_fields(tconfigs.get_config(arch),
                        jconfigs.get_config(arch)) == {}
    assert _same_fields(tconfigs.get_smoke(arch),
                        jconfigs.get_smoke(arch)) == {}
    assert tconfigs.get_config(arch).use_kernels is True


def _flat_defs(defs):
    flat = {}

    def walk(t, path):
        if isinstance(t, tparams.ParamDef):
            flat[path] = t
            return
        for k, v in t.items():
            walk(v, path + (k,))
    walk(defs, ())
    return flat


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_parameter_tables_match_reference(arch, smoke):
    """Leaf by leaf: path, shape, init and scale.  Only the tables are
    built (nothing is allocated): phi3.5-moe and granite-34b are 42 B and
    47 B parameters at their published configs."""
    get = "get_smoke" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    jdefs = jax.tree.leaves_with_path(
        jparams.model_defs(jcfg),
        is_leaf=lambda x: isinstance(x, jparams.ParamDef))
    flat = _flat_defs(model_defs(tcfg))
    assert len(flat) == len(jdefs)
    for path, jd in jdefs:
        td = flat[tuple(p.key for p in path)]
        assert (td.shape, td.init, td.scale) == (jd.shape, jd.init, jd.scale)
    assert sum(int(np.prod(d.shape)) for d in flat.values()) == \
        jparams.count_params(jparams.model_defs(jcfg))


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_smoke_params_carry_over_and_draw_every_leaf(arch):
    """``params_from_jax`` takes the reference's smoke tree whole, and the
    port's own draw fills the same tree: layernorm biases zero, gates
    zero, every normal leaf nonzero."""
    jcfg, tcfg = jconfigs.get_smoke(arch), tconfigs.get_smoke(arch)
    tree = jax.tree.map(np.asarray, jinit_params(jcfg, jax.random.PRNGKey(0)))
    got = params_from_jax(tree, tcfg)
    mine = init_params(tcfg, torch.Generator().manual_seed(0))
    flat = _flat_defs(model_defs(tcfg))

    def leaf(t, path):
        for k in path:
            t = t[k]
        return t
    for path, d in flat.items():
        a, b = leaf(got, path), leaf(mine, path)
        assert tuple(a.shape) == tuple(b.shape) == d.shape, path
        if d.init == "zeros":
            assert not bool(b.any()), path
        elif d.init == "normal":
            assert bool(b.any()), path


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_caches_match_reference_shapes_dtypes_and_axes(arch, smoke):
    """``init_caches`` (on the meta device: nothing allocated) against the
    reference's abstract caches, and the logical axes the executor reads
    the batch axis from."""
    get = "get_smoke" if smoke else "get_config"
    jcfg, tcfg = getattr(jconfigs, get)(arch), getattr(tconfigs, get)(arch)
    tc = init_caches(tcfg, 3, 64, device="meta")
    jc = jinit_caches(jcfg, 3, 64, abstract=True)
    assert set(tc) == set(jc)
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        assert tc[k].dtype == getattr(torch, str(jc[k].dtype)), k
    assert cache_logical_axes(tcfg) == {
        k: tuple(v) for k, v in jaxes(jcfg).items()}
