"""Model configuration shared by all 10 assigned architectures.

A copy of ``repro.models.config`` with one change: the kernel switch is
``use_kernels`` (default True), which selects the hand-written CUDA
kernels of :mod:`repro_torch.kernels` (their plain versions on CPU
tensors); ``use_kernels=False`` selects the torch refs."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None

    # MoE
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # SSM (Mamba-2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 64

    # hybrid (zamba2-style): one shared attention block applied every
    # ``attn_every`` SSM blocks
    attn_every: int = 0

    # VLM: decoder layer indices with interleaved cross-attention to the
    # (stubbed) image patch embeddings
    cross_attn_every: int = 0
    n_img_tokens: int = 0

    # enc-dec (whisper): encoder over stubbed audio-frame embeddings
    enc_layers: int = 0
    enc_seq: int = 0

    rope_theta: float = 10000.0
    act: str = "silu"             # silu (gated) | gelu (non-gated)
    norm: str = "rmsnorm"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"       # activation/compute dtype
    param_dtype: str = "float32"

    # implementation switches
    use_kernels: bool = True      # CUDA kernels for decode attention/rmsnorm
    use_vml_act: bool = True      # vml activations (paper §5 integration)
    remat: str = "block"          # none | block | full
    moe_group: int = 256          # token-group size for dropping MoE dispatch
    use_streaming_ce: bool = False  # fused vocab-chunked CE (no full logits)
    ce_chunk: int = 2048
    attn_block_q: int = 512       # flash-style blocked attention (XLA path)
    attn_block_k: int = 1024

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so the embedding table shards
        evenly over the model axis (padded logits are masked to -inf)."""
        return (self.vocab + 255) // 256 * 256

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None \
            else self.d_model // self.n_heads

    @property
    def ssm_heads(self) -> int:
        return (self.d_model * self.ssm_expand) // self.ssm_head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    def validate(self) -> None:
        assert self.n_heads % max(self.n_kv, 1) == 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm_state > 0
        if self.family == "moe":
            assert self.n_experts > 0 and self.top_k > 0
        if self.family == "hybrid":
            assert self.attn_every > 0
        if self.family == "vlm":
            assert self.cross_attn_every > 0
        if self.family == "encdec":
            assert self.enc_layers > 0 and self.enc_seq > 0


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

ALL_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """long_500k requires sub-quadratic attention: run only for SSM/hybrid
    families, skip (by assignment rule) for pure full-attention archs."""
    if cfg.family in ("ssm", "hybrid"):
        return ALL_SHAPES
    return (TRAIN_4K, PREFILL_32K, DECODE_32K)
