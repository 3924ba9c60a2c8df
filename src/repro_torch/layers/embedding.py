"""Token embedding + logits head (port of ``repro.layers.embedding``).

Both tables may be int8 dicts (``quant_transformer.quantize_param_tree``);
``qmm`` dequantizes them inside the lookup and the head.
``cross_entropy`` is the LM loss (the QAT graph's objective).
"""
from __future__ import annotations

from typing import Dict

import torch

from .qmm import emb_logits, emb_lookup, mm


def embed_init(generator: torch.Generator, vocab: int, d_model: int,
               params: Dict, device=None, tie: bool = True) -> None:
    """bf16 embedding table, N(0, 0.02^2), drawn on ``generator``'s device;
    with ``tie=False`` also an untied ``(d_model, vocab)`` head."""
    emb = torch.randn((vocab, d_model), generator=generator,
                      device=generator.device) * 0.02
    params["embedding"] = emb.to(device=device, dtype=torch.bfloat16)
    if not tie:
        head = torch.randn((d_model, vocab), generator=generator,
                           device=generator.device) * 0.02
        params["lm_head"] = head.to(device=device, dtype=torch.bfloat16)


def embed_tokens(params: Dict, tokens: torch.Tensor,
                 unrounded: bool = False) -> torch.Tensor:
    return emb_lookup(params["embedding"], tokens, unrounded)


def logits_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    if "lm_head" in params:
        return mm(x, params["lm_head"])
    return emb_logits(params["embedding"], x)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """Mean token cross-entropy in float32 over the labels that are not
    ``ignore_id``."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    mask = labels != ignore_id
    idx = torch.where(mask, labels, 0).to(torch.int64)
    ll = torch.gather(logits, -1, idx[..., None])[..., 0]
    maskf = mask.to(torch.float32)
    return ((lse - ll) * maskf).sum() / maskf.sum().clamp(min=1.0)
