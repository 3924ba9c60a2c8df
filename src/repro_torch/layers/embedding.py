"""Token embedding + logits head (port of ``repro.layers.embedding``)."""
from __future__ import annotations

from typing import Dict

import torch

from .qmm import emb_lookup, mm


def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               params: Dict, device=None) -> None:
    """bf16 embedding table, N(0, 0.02^2), drawn on ``generator``'s device."""
    emb = torch.randn((vocab, d_model), generator=generator,
                      device=generator.device) * 0.02
    params["embedding"] = emb.to(device=device, dtype=torch.bfloat16)


def embed_tokens(params: Dict, tokens: torch.Tensor) -> torch.Tensor:
    return emb_lookup(params["embedding"], tokens)


def logits_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" in params:
        return mm(x, params["lm_head"])
    return mm(x, params["embedding"].t())
