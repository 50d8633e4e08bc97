"""smollm-135m — small llama-arch [hf:HuggingFaceTB/SmolLM-135M; hf].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.  9 heads / 3 KV heads
do not divide the 16-way model axis -> heads replicate, FFN/vocab still
shard (see sharding.adapt_rules_for).
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv=3, head_dim=64,
    d_ff=1536, vocab=49152, tie_embeddings=True,
)

SMOKE = dataclasses.replace(
    CONFIG, name="smollm-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
)
