"""All assigned architectures (10) + the paper's own LSTM RNN-T stack.

Every entry carries the exact table config from the assignment plus a
REDUCED smoke-test config of the same family.  ``head_dim`` follows the
family's published value where the assignment table omits it (noted inline).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from .base import ArchConfig


def _smoke(cfg: ArchConfig, **kw) -> ArchConfig:
    """Reduced same-family config: small widths/layers/experts/vocab."""
    base = dict(
        n_layers=2,
        d_model=64,
        vocab_size=256,
        n_heads=4 if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        head_dim=16 if cfg.head_dim else 0,
        d_ff=128 if cfg.d_ff else 0,
        n_experts=4 if cfg.n_experts else 0,
        topk=min(cfg.topk, 2) if cfg.topk else 0,
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        dense_d_ff=128 if cfg.dense_d_ff else 0,
        n_dense_layers=1 if cfg.n_dense_layers else 0,
        n_shared_experts=cfg.n_shared_experts and 1,
        d_state=cfg.d_state and 8,
        d_rnn=cfg.d_rnn and 64,
        enc_layers=cfg.enc_layers and 2,
        n_frontend_tokens=cfg.n_frontend_tokens and 16,
        attn_window=cfg.attn_window and 32,
        expand=cfg.expand,
        remat="none",
    )
    base.update(kw)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)


CONFIGS: Dict[str, ArchConfig] = {}

# --- dense LM family --------------------------------------------------------

CONFIGS["qwen3-4b"] = ArchConfig(
    name="qwen3-4b", family="dense", n_layers=36, d_model=2560,
    n_heads=32, n_kv_heads=8, head_dim=128,  # head_dim 128 per Qwen3 family
    d_ff=9728, vocab_size=151936, qk_norm=True, rope_theta=1e6,
    mlp_type="swiglu", norm_type="rmsnorm", shard_profile="dense_fsdp",
)

CONFIGS["stablelm-1.6b"] = ArchConfig(
    name="stablelm-1.6b", family="dense", n_layers=24, d_model=2048,
    n_heads=32, n_kv_heads=32, head_dim=64, d_ff=5632, vocab_size=100352,
    mlp_type="swiglu", norm_type="layernorm", shard_profile="dense_small",
)

CONFIGS["yi-34b"] = ArchConfig(
    name="yi-34b", family="dense", n_layers=60, d_model=7168,
    n_heads=56, n_kv_heads=8, head_dim=128, d_ff=20480, vocab_size=64000,
    mlp_type="swiglu", norm_type="rmsnorm", rope_theta=5e6,
    shard_profile="dense_fsdp", optimizer="adafactor",
)

CONFIGS["qwen1.5-0.5b"] = ArchConfig(
    name="qwen1.5-0.5b", family="dense", n_layers=24, d_model=1024,
    n_heads=16, n_kv_heads=16, head_dim=64, d_ff=2816, vocab_size=151936,
    qkv_bias=True, mlp_type="swiglu", norm_type="rmsnorm",
    tie_embeddings=True, shard_profile="dense_small",
)

# --- audio (enc-dec, frontend stub) ----------------------------------------

CONFIGS["whisper-tiny"] = ArchConfig(
    name="whisper-tiny", family="encdec", n_layers=4, enc_layers=4,
    d_model=384, n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536,
    vocab_size=51865, mlp_type="gelu", norm_type="layernorm",
    n_frontend_tokens=1500, shard_profile="tiny", scan_layers=False,
)

# --- hybrid recurrent -------------------------------------------------------

CONFIGS["recurrentgemma-9b"] = ArchConfig(
    name="recurrentgemma-9b", family="hybrid", n_layers=38, d_model=4096,
    n_heads=16, n_kv_heads=1, head_dim=256, d_ff=12288, vocab_size=256000,
    mlp_type="geglu", norm_type="rmsnorm", attn_window=2048,
    block_pattern=("rec", "rec", "attn"), d_rnn=4096,
    shard_profile="dense_fsdp", scan_layers=False,
)

# --- VLM (ViT stub + InternLM2 LM) ------------------------------------------

CONFIGS["internvl2-2b"] = ArchConfig(
    name="internvl2-2b", family="vlm", n_layers=24, d_model=2048,
    n_heads=16, n_kv_heads=8, head_dim=128, d_ff=8192, vocab_size=92553,
    mlp_type="swiglu", norm_type="rmsnorm", n_frontend_tokens=256,
    shard_profile="dense_small",
)

# --- MoE ---------------------------------------------------------------------

CONFIGS["grok-1-314b"] = ArchConfig(
    name="grok-1-314b", family="moe", n_layers=64, d_model=6144,
    n_heads=48, n_kv_heads=8, head_dim=128, d_ff=32768, vocab_size=131072,
    n_experts=8, topk=2, moe_d_ff=32768, mlp_type="gelu",
    norm_type="rmsnorm", shard_profile="moe_fsdp", optimizer="adafactor",
)

CONFIGS["kimi-k2-1t-a32b"] = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe", n_layers=61, d_model=7168,
    n_heads=64, n_kv_heads=8, head_dim=112, d_ff=2048, vocab_size=163840,
    n_experts=384, topk=8, n_shared_experts=1, n_dense_layers=1,
    moe_d_ff=2048, dense_d_ff=18432, mlp_type="swiglu", norm_type="rmsnorm",
    shard_profile="moe_fsdp", optimizer="adafactor",
)

# --- SSM ---------------------------------------------------------------------

CONFIGS["falcon-mamba-7b"] = ArchConfig(
    name="falcon-mamba-7b", family="ssm", n_layers=64, d_model=4096,
    vocab_size=65024, d_state=16, d_conv=4, expand=2, mlp_type="swiglu",
    norm_type="rmsnorm", shard_profile="dense_fsdp",
)

# --- the paper's own architecture (RNN-T encoder stack proxy) ---------------

CONFIGS["lstm-rnnt"] = ArchConfig(
    name="lstm-rnnt", family="lstm", n_layers=10, d_model=2048,
    d_ff=0, vocab_size=4096, d_rnn=2048, shard_profile="tiny",
)

# Same stack, GRU cell: 3 packed gates, single h carry, no projection
# (so the inter-layer width is d_rnn, not the LSTM's 640 projection).
CONFIGS["gru-rnnt"] = ArchConfig(
    name="gru-rnnt", family="lstm", n_layers=10, d_model=2048,
    d_ff=0, vocab_size=4096, d_rnn=2048, rnn_cell="gru",
    shard_profile="tiny",
)

SMOKE_CONFIGS: Dict[str, ArchConfig] = {
    k: _smoke(v) for k, v in CONFIGS.items()
}
# recurrentgemma's smoke must exercise the attention member of the pattern
SMOKE_CONFIGS["recurrentgemma-9b"] = _smoke(
    CONFIGS["recurrentgemma-9b"], n_layers=3)

# the paper-repro recurrent LMs (family="lstm": lstm-rnnt, gru-rnnt, ...)
# are not part of the assigned model set
ASSIGNED = tuple(k for k in CONFIGS if CONFIGS[k].family != "lstm")


def get_config(name: str, smoke: bool = False) -> ArchConfig:
    table = SMOKE_CONFIGS if smoke else CONFIGS
    if name not in table:
        raise KeyError(f"unknown arch '{name}'; have {sorted(table)}")
    return table[name]
