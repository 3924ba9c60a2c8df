"""Serving functions of a model bundle (port of the serving part of
``repro.runtime.train_loop``).

``make_serve_fns`` mirrors the reference's ``make_serve_fns`` without a
mesh: there is no sharding and no jit, so the two functions run the
bundle's prefill and decode eagerly, without autograd, on ``device``.  The
training parts of the reference module come with training.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..models.model_zoo import ModelBundle


def make_serve_fns(bundle: ModelBundle, device, batch: int, max_len: int,
                   quantized_cache: bool = False
                   ) -> Tuple[Callable, Callable]:
    """``(prefill_fn, decode_fn)``.

    ``prefill_fn(params, b)`` takes ``{"tokens": (batch, S)}`` (and the
    VLM's ``"frontend_embeds"``) and returns the last-token logits;
    ``decode_fn(params, token, state)`` returns ``(logits, state)``, and
    with ``state=None`` starts from a fresh ``(batch, max_len)`` cache
    (int8 when ``quantized_cache``).  Inputs are moved to ``device``.
    """
    device = torch.device(device)

    @torch.no_grad()
    def prefill_fn(params, b):
        b = {k: v.to(device) for k, v in b.items()}
        return bundle.prefill(params, b)

    @torch.no_grad()
    def decode_fn(params, token, state=None):
        if state is None:
            state = bundle.init_state(batch, max_len,
                                      quantized=quantized_cache,
                                      device=device)
        return bundle.decode(params, token.to(device), state)

    return prefill_fn, decode_fn
