"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base; hf].

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8.
40 experts do not divide the 16-way model axis, so the dry-run falls back
to per-expert tensor parallelism (see sharding.adapt_rules_for).
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv=8, head_dim=64,
    d_ff=512, vocab=49155, n_experts=40, top_k=8,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=32, vocab=512, n_experts=5, top_k=2, moe_group=16,
)
