"""RecurrentGemma-9B style hybrid: the (RG-LRU, RG-LRU, local attention)
pattern (port of ``repro.models.recurrentgemma``).

38 layers are 12 x (rec, rec, attn) + (rec, rec).  Params keep the
reference's tree: two stacks, ``rec_layers`` (``n_rec`` recurrent blocks of
``layers/recurrent.py`` with their MLPs) and ``attn_layers`` (``n_attn``
layers of ``transformer._layers_init``), walked in pattern order.  The
attention layers are the dense transformer's blocks, with the window
``cfg.attn_window``: a prefill of more than 1024 positions runs
``flash_attention`` in each of them (kernel 5 at head_dim 256, 16 query
heads over one KV head); decode reads a ring buffer of ``min(window,
max_len)`` positions.  Decode state: ``{"rec": {"h": (n_rec, B, d_rnn)
float32, "conv": (n_rec, B, d_conv - 1, d_rnn)}, "attn": {"k", "v":
(n_attn, B, window, KVH, head_dim)}, "len"}``, written in place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..layers import embedding as emb
from ..layers import qmm
from ..layers import recurrent as rec
from ..layers.common import norm_apply, norm_init
from ..layers.mlp import mlp_init
from . import transformer as T

DEFAULT_PATTERN = ("rec", "rec", "attn")


def _layer_counts(cfg: ArchConfig) -> Tuple[int, int]:
    """(n_recurrent, n_attention) for the 1-attn:2-rec pattern."""
    pat = cfg.block_pattern or DEFAULT_PATTERN
    full = cfg.n_layers // len(pat)
    rem = cfg.n_layers - full * len(pat)
    n_attn = full * pat.count("attn") + sum(1 for p in pat[:rem]
                                            if p == "attn")
    return cfg.n_layers - n_attn, n_attn


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None
                ) -> Dict[str, Any]:
    """Random bf16 params from a seeded generator, placed on ``device``."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device,
                   tie=cfg.tie_embeddings)
    norm_init(cfg.norm_type, cfg.d_model, "norm_final", params, device=device)
    n_rec, n_attn = _layer_counts(cfg)
    R = (n_rec,)
    layers: Dict[str, Any] = {}
    norm_init(cfg.norm_type, cfg.d_model, "norm_mix", layers, device=device,
              stack=R)
    norm_init(cfg.norm_type, cfg.d_model, "norm_mlp", layers, device=device,
              stack=R)
    rec.rglru_init(generator, cfg.d_model, cfg.d_rnn, cfg.d_conv, layers,
                   device=device, stack=R)
    mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_type, layers,
             device=device, stack=R)
    params["rec_layers"] = layers
    params["attn_layers"] = T._layers_init(generator, cfg, device,
                                           n_layers=n_attn)
    return params


def _rec_block(p, cfg: ArchConfig, x, dt, state):
    h, new_state = rec.rglru_apply(
        p, norm_apply(cfg.norm_type, x, p, "norm_mix").to(dt), state)
    return T.residual_mlp(p, cfg, x, h, unrounded=True)[0], new_state


def _attn_block(p, cfg: ArchConfig, x, dt, positions, cache):
    h = T._attention_block(
        p, cfg, norm_apply(cfg.norm_type, x, p, "norm_attn").to(dt),
        positions, cache)
    return T.residual_mlp(p, cfg, x, h, unrounded=True)[0]


def _embed(params, tokens: torch.Tensor):
    """``(the embedding as the first norm reads it, the residual stream's
    dtype)``: an int8 table's row-times-scale product comes unrounded."""
    w = params["embedding"]
    dt = torch.bfloat16 if qmm.is_quant(w) else w.dtype
    return emb.embed_tokens(params, tokens, unrounded=True), dt


def _run_layers(params, cfg: ArchConfig, x: torch.Tensor, dt: torch.dtype,
                states: Optional[Dict] = None) -> torch.Tensor:
    """The layers in pattern order over the stream ``x`` of dtype ``dt``.
    With ``states`` (decode) each layer starts from its state and cache
    and overwrites them in place.

    The reference unrolls the layers, so XLA hands each block's residual
    sum to the next norm unrounded (ROADMAP Queue 3, F6): the stream is
    carried as that float32 sum, rounded to ``dt`` where a residual add
    reads it; the final norm's input is returned so."""
    n_rec, _ = _layer_counts(cfg)
    if states is None:
        positions = torch.arange(x.shape[1], device=x.device)
    else:
        positions = torch.full((1,), states["len"], dtype=torch.int32,
                               device=x.device)
    pat = cfg.block_pattern or DEFAULT_PATTERN
    ri = ai = 0
    for li in range(cfg.n_layers):
        if pat[li % len(pat)] == "rec" and ri < n_rec:
            p = T.layer_params(params["rec_layers"], ri)
            st = None
            if states is not None:
                st = {k: t[ri] for k, t in states["rec"].items()}
            x, nst = _rec_block(p, cfg, x, dt, st)
            if nst is not None:
                for k, t in nst.items():
                    st[k].copy_(t)
            ri += 1
        else:
            p = T.layer_params(params["attn_layers"], ai)
            cache = None
            if states is not None:
                cache = {"k": states["attn"]["k"][ai],
                         "v": states["attn"]["v"][ai], "pos": states["len"]}
            x = _attn_block(p, cfg, x, dt, positions, cache)
            ai += 1
    return x


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            states: Optional[Dict] = None
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) -> (logits (B, S, vocab), states with len + 1 or
    None)."""
    x, dt = _embed(params, tokens)
    x = _run_layers(params, cfg, x, dt, states)
    x = norm_apply(cfg.norm_type, x, params, "norm_final").to(dt)
    logits = emb.logits_head(params, x)
    if states is None:
        return logits, None
    return logits, dict(states, len=states["len"] + 1)


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"])
    return emb.cross_entropy(logits, batch["labels"])


def init_decode_state(cfg: ArchConfig, batch: int, window: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    n_rec, n_attn = _layer_counts(cfg)
    kv = (n_attn, batch, window, cfg.n_kv_heads, cfg.head_dim)
    return {
        "rec": {"h": torch.zeros((n_rec, batch, cfg.d_rnn),
                                 dtype=torch.float32, device=device),
                "conv": torch.zeros((n_rec, batch, cfg.d_conv - 1, cfg.d_rnn),
                                    dtype=dtype, device=device)},
        "attn": {"k": torch.zeros(kv, dtype=dtype, device=device),
                 "v": torch.zeros(kv, dtype=dtype, device=device)},
        "len": 0}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The prompt's last-position logits (B, vocab); the head runs on that
    position alone."""
    x, dt = _embed(params, tokens)
    x = _run_layers(params, cfg, x, dt)
    x = norm_apply(cfg.norm_type, x[:, -1:], params, "norm_final")
    return emb.logits_head(params, x.to(dt))[:, 0]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                states: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) + states -> (logits (B, vocab), states with len + 1)."""
    logits, new_states = forward(params, cfg, token, states)
    return logits[:, -1], new_states
