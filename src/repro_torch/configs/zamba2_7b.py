"""zamba2-7b — Mamba2 backbone + shared attention block [arXiv:2411.15242].

81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000, ssm_state=64.
One SHARED attention+FFN block (parameters reused) is applied after every
6th mamba block — 13 applications over 81 layers, each with its own KV
cache instance.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, head_dim=112,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
    attn_every=6,
)

SMOKE = dataclasses.replace(
    CONFIG, name="zamba2-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8, attn_every=2,
)
