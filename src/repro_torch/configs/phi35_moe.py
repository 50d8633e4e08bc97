"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct; hf].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=6400, vocab=32064, n_experts=16, top_k=2,
)

SMOKE = dataclasses.replace(
    CONFIG, name="phi3.5-moe-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=96, vocab=512, n_experts=4, top_k=2, moe_group=16,
)
