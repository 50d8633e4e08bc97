"""llama-3.2-vision-11b [hf:meta-llama/Llama-3.2-11B-Vision; unverified].

40L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256, gated
cross-attention to image tokens every 5th layer.  The vision tower is a
STUB: input_specs() provides precomputed patch embeddings
(B, n_img_tokens=1600, d_model).
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, head_dim=128,
    d_ff=14336, vocab=128256,
    cross_attn_every=5, n_img_tokens=1600,
)

SMOKE = dataclasses.replace(
    CONFIG, name="llama-vision-smoke",
    n_layers=4, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512, cross_attn_every=2, n_img_tokens=16,
)
