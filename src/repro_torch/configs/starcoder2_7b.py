"""starcoder2-7b — dense GQA + RoPE [arXiv:2402.19173; hf].

32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv=4, head_dim=128,
    d_ff=18432, vocab=49152,
)

SMOKE = dataclasses.replace(
    CONFIG, name="starcoder2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
)
