"""Architecture + run configuration dataclasses.

Every assigned architecture is an ``ArchConfig`` in its own module under
``repro/configs``; shapes are the four assigned input-shape cells.  The config
is deliberately a flat superset across families -- a single dataclass keeps
the launcher, dry-run, and sharding rules uniform.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm | lstm
    n_layers: int
    d_model: int
    vocab_size: int
    # attention
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_window: int = 0  # 0 = global
    # ffn
    d_ff: int = 0
    mlp_type: str = "swiglu"  # swiglu | geglu | gelu
    norm_type: str = "rmsnorm"  # rmsnorm | layernorm
    tie_embeddings: bool = False
    # moe
    n_experts: int = 0
    topk: int = 0
    n_shared_experts: int = 0
    n_dense_layers: int = 0
    moe_d_ff: int = 0
    dense_d_ff: int = 0
    capacity_factor: float = 1.25
    # ssm (mamba)
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    # hybrid (recurrentgemma): pattern unit, e.g. ("rec", "rec", "attn")
    block_pattern: Tuple[str, ...] = ()
    d_rnn: int = 0
    # lstm family: which QuantRecurrentCell the stack uses (lstm | gru)
    rnn_cell: str = "lstm"
    # enc-dec / multimodal frontend stubs
    enc_layers: int = 0
    n_frontend_tokens: int = 0  # audio frames / image patches (precomputed)
    # distribution
    shard_profile: str = "default"
    remat: str = "full"  # none | full | dots
    optimizer: str = "adamw"  # adamw | adafactor
    scan_layers: bool = True

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (attention-free or windowed attention)."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have an autoregressive decoder

    def dt_rank(self) -> int:
        return max(self.d_model // 16, 1)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def applicable_shapes(cfg: ArchConfig):
    """long_500k only for sub-quadratic archs (full-attention skip is noted
    in DESIGN.md); decode shapes skipped for encoder-only archs (none here)."""
    for s in SHAPES.values():
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        yield s
