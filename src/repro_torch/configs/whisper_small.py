"""whisper-small — enc-dec, conv frontend stubbed [arXiv:2212.04356].

12L d_model=768 12H (kv=12) d_ff=3072 vocab=51865.  The audio conv
frontend is a STUB: input_specs() provides precomputed frame embeddings
(B, enc_seq=1500, d_model).  LayerNorm + (non-gated) GELU, learned
positional embeddings (no RoPE).
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, d_model=768, n_heads=12, n_kv=12, head_dim=64,
    d_ff=3072, vocab=51865,
    enc_layers=12, enc_seq=1500, act="gelu", norm="layernorm",
)

SMOKE = dataclasses.replace(
    CONFIG, name="whisper-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
    d_ff=128, vocab=512, enc_layers=2, enc_seq=32,
)
