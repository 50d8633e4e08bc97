"""mamba2-780m — SSD (state-space duality) [arXiv:2405.21060; unverified].

48L d_model=1536, attention-free, vocab=50280, ssm_state=128: 48 SSD heads
of 64 over an inner width of 3072, one B/C group, conv 4, chunk 64.
"""

import dataclasses

from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-780m", family="ssm",
    n_layers=48, d_model=1536, n_heads=1, n_kv=1, d_ff=0, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_conv=4, ssm_chunk=64,
)

SMOKE = dataclasses.replace(
    CONFIG, name="mamba2-smoke",
    n_layers=2, d_model=64, vocab=512,
    ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
)
