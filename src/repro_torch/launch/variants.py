"""Named sharding-rule variants for the dry-run's hillclimb.

The port of ``repro.launch.variants``.  Each entry maps (base_rules,
cfg, shape, mesh) -> ShardingRules.  The baseline is paper-faithful 2D
DP x TP; variants are the beyond-paper optimizations.

``KERNEL_VARIANTS`` is the kernel-compiler analogue: named compile
policies (target pinning + cache policy).  The reference's
``cached_pallas`` pins its TPU work-group target; the port's
``cached_cuda`` pins the hand-written ``cuda`` target.
"""

VARIANTS = {}

# kernel-compiler execution variants: how compile_kernel is invoked per
# launch.  "uncached" is the seed behaviour (full pipeline per enqueue);
# "cached" is the steady-state hash-lookup path; "autotuned" additionally
# lets the tuning table choose the target per kernel shape.
KERNEL_VARIANTS = {
    "uncached": {"target": "vector", "cache": False},
    "cached": {"target": "vector", "cache": True},
    "cached_loop": {"target": "loop", "cache": True},
    "cached_cuda": {"target": "cuda", "cache": True},
    "autotuned": {"target": "auto", "cache": True},
}


def kernel_variant(name: str) -> dict:
    """Resolve a named kernel-compile policy to compile_kernel kwargs."""
    return dict(KERNEL_VARIANTS[name])


def variant(name):
    def deco(fn):
        VARIANTS[name] = fn
        return fn
    return deco


@variant("h1_cache_layout")
def h1_cache_layout(base, cfg, shape, mesh):
    """H1 iter 2: (B,KV,S,D)-native KV cache (code change; rules equal
    to baseline — the variant exists to record the measurement)."""
    return base


@variant("no_fsdp")
def no_fsdp(base, cfg, shape, mesh):
    """H2: drop FSDP weight sharding (kills per-layer weight all-gathers;
    viable when params*3*4B fit per model-rank)."""
    return base.replace(embed_fsdp=None)


@variant("no_sp")
def no_sp(base, cfg, shape, mesh):
    """Ablation: no sequence-parallel residuals (the pre-SP baseline)."""
    return base.replace(act_seq=None)


@variant("moe_data_dispatch")
def moe_data_dispatch(base, cfg, shape, mesh):
    """H3: experts sharded over the DATA axis instead of model (a2a moves
    to the data axis; model axis keeps pure TP)."""
    return base.replace(experts="data", expert_mlp="model")


@variant("ctl_f32")
def ctl_f32(base, cfg, shape, mesh):
    """Control: an all-f32 step (rules equal to baseline; the config
    override sets the dtype)."""
    return base


@variant("moe_token_parallel")
def moe_token_parallel(base, cfg, shape, mesh):
    """H2: token/capacity-parallel MoE.  Experts replicate on the model
    axis (FSDP over data keeps memory flat); the dispatch capacity dim
    shards over model.  No sharded contraction appears in the expert-FFN
    backward, killing the per-layer (E,G,C,d) dxin all-reduce that
    dominates the TP-of-experts fallback when n_experts % model != 0."""
    return base.replace(experts=None, expert_mlp=None,
                        moe_capacity="model")


# config-level overrides applied per variant name (composable via '+')
CFG_OVERRIDES = {
    "ctl_f32": {"dtype": "float32"},
    "remat_dots": {"remat": "dots"},
    "stream_ce": {"use_streaming_ce": True},
}


@variant("remat_dots")
def remat_dots(base, cfg, shape, mesh):
    """Selective remat: save dot outputs, recompute elementwise — trades
    activation memory for the 2ND re-forward FLOPs."""
    return base


@variant("moe_tp_fallback")
def moe_tp_fallback(base, cfg, shape, mesh):
    """The paper-faithful fallback for n_experts % model != 0: per-expert
    FFN tensor parallelism.  Experts and their FFN dim both name "model";
    the placements keep it on the experts
    (:func:`repro_torch.distributed.sharding.logical_to_sharding`)."""
    return base.replace(experts="model", expert_mlp="model",
                        moe_capacity=None)


@variant("stream_ce")
def stream_ce(base, cfg, shape, mesh):
    """Fused vocab-chunked cross-entropy: no (B,S,V) logits buffer."""
    return base
