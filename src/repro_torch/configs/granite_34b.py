"""granite-34b — llama-arch code model, MQA [arXiv:2405.04324; hf].

88L d_model=6144 48H (MQA kv=1) d_ff=24576 vocab=49152.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv=1, head_dim=128,
    d_ff=24576, vocab=49152,
)

SMOKE = dataclasses.replace(
    CONFIG, name="granite34-smoke",
    n_layers=2, d_model=64, n_heads=4, n_kv=1, head_dim=16,
    d_ff=128, vocab=512,
)
