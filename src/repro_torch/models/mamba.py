"""Falcon-Mamba-7B: the attention-free Mamba-1 stack, 64 layers of
``layers/ssm.py`` (port of ``repro.models.mamba``).

Params keep the reference's tree: ``embedding`` (and the untied
``lm_head``), ``norm_final`` and one stacked ``layers`` dict whose leaves
carry a leading ``(n_layers,)`` axis.  The decode state is the reference's
``{"layers": {"h": (L, B, d_inner, d_state) float32, "conv": (L, B,
d_conv - 1, d_inner)}, "len"}``; ``decode_step`` writes each layer's new
state into those tensors in place (the reference returns new arrays) and
``len`` is a Python int.  No kernel runs: the products are plain PyTorch,
as the reference leaves them to XLA, and the scan is a loop.  Training
(``loss_fn``) recomputes each layer in the backward where ``cfg.remat`` is
``"full"`` (``torch.utils.checkpoint``), as the reference wraps its layer
step in ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..layers import embedding as emb
from ..layers import ssm as ssm_lib
from ..layers.common import norm_apply, norm_init
from .transformer import layer_params, remat_of


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None
                ) -> Dict[str, Any]:
    """Random bf16 params from a seeded generator, placed on ``device``."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device,
                   tie=cfg.tie_embeddings)
    norm_init(cfg.norm_type, cfg.d_model, "norm_final", params, device=device)
    L = (cfg.n_layers,)
    layers: Dict[str, Any] = {}
    norm_init(cfg.norm_type, cfg.d_model, "norm", layers, device=device,
              stack=L)
    ssm_lib.ssm_init(generator, cfg.d_model, cfg.d_inner, cfg.d_state,
                     cfg.d_conv, cfg.dt_rank(), layers, device=device,
                     stack=L)
    params["layers"] = layers
    return params


def _layer(p, cfg: ArchConfig, x, st):
    y, nst = ssm_lib.ssm_apply(p, norm_apply(cfg.norm_type, x, p, "norm"), st,
                               cfg.d_state, cfg.dt_rank())
    return x + y, nst


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            states: Optional[Dict] = None, train: bool = False
            ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """tokens (B, S) -> (logits (B, S, vocab), states with len + 1 or
    None).  With ``states`` every layer's scan and conv start from its
    state, which is then overwritten in place.  ``train`` recomputes each
    layer in the backward where ``remat_of(cfg, train)``."""
    x = emb.embed_tokens(params, tokens)
    remat = remat_of(cfg, train) and states is None
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        st = None
        if states is not None:
            st = {k: t[i] for k, t in states["layers"].items()}
        if remat:
            x, nst = checkpoint(_layer, p, cfg, x, None, use_reentrant=False)
        else:
            x, nst = _layer(p, cfg, x, st)
        if nst is not None:
            for k, t in nst.items():
                st[k].copy_(t)
    x = norm_apply(cfg.norm_type, x, params, "norm_final")
    logits = emb.logits_head(params, x)
    if states is None:
        return logits, None
    return logits, dict(states, len=states["len"] + 1)


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    logits, _ = forward(params, cfg, batch["tokens"], train=True)
    return emb.cross_entropy(logits, batch["labels"])


def init_decode_state(cfg: ArchConfig, batch: int, dtype=torch.bfloat16,
                      device=None) -> Dict[str, Any]:
    L = cfg.n_layers
    return {"layers": {
        "h": torch.zeros((L, batch, cfg.d_inner, cfg.d_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((L, batch, cfg.d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device)},
        "len": 0}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The prompt's last-position logits (B, vocab); the head runs on that
    position alone (the final norm is per position)."""
    x = emb.embed_tokens(params, tokens)
    for i in range(cfg.n_layers):
        p = layer_params(params["layers"], i)
        y, _ = ssm_lib.ssm_apply(p, norm_apply(cfg.norm_type, x, p, "norm"),
                                 None, cfg.d_state, cfg.dt_rank())
        x = x + y
    x = norm_apply(cfg.norm_type, x[:, -1:], params, "norm_final")
    return emb.logits_head(params, x)[:, 0]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                states: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) + states -> (logits (B, vocab), states with len + 1)."""
    logits, new_states = forward(params, cfg, token, states)
    return logits[:, -1], new_states
