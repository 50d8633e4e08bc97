"""internlm2-20b — dense GQA [arXiv:2403.17297; hf].

48L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=92544.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, head_dim=128,
    d_ff=16384, vocab=92544,
)

SMOKE = dataclasses.replace(
    CONFIG, name="internlm2-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, head_dim=16,
    d_ff=128, vocab=512,
)
