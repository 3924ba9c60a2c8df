"""Unified model API: build an architecture's serving functions from its
``ArchConfig`` (port of ``repro.models.model_zoo``).

``build(cfg)`` returns a ``ModelBundle`` of plain functions:

    init(generator, device="cuda")   -> params
    loss(params, batch)              -> mean next-token cross-entropy
    prefill(params, batch)           -> last-token logits (B, vocab)
    init_state(batch, max_len, quantized, device="cuda")
                                     -> decode cache
    decode(params, token, state)     -> (logits (B, vocab), state)

for the ``dense`` and ``vlm`` families (``batch`` is ``{"tokens": (B, S)}``,
plus ``"labels"`` for the loss and ``"frontend_embeds": (B, F, d)`` for the
VLM stub) and the ``lstm`` family, the float recurrent LM of every
``rnn_cell`` (``lstm-rnnt``, ``gru-rnnt``), whose state does not grow with
``max_len``.  Params and
state go to the card unless the caller passes another device.  The
dry-run's ``input_specs`` is not ported; the other families raise
(ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ArchConfig
from . import lstm_lm, transformer

PORTED = ("dense", "vlm", "lstm")


@dataclasses.dataclass
class ModelBundle:
    cfg: ArchConfig
    init: Callable
    loss: Callable
    prefill: Callable
    init_state: Callable
    decode: Callable


def build(cfg: ArchConfig) -> ModelBundle:
    if cfg.family not in PORTED:
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            f"(ported: {', '.join(PORTED)}; ROADMAP Queue 1)")
    if cfg.family == "lstm":
        # one registration serves every cell: lstm_lm dispatches on
        # cfg.rnn_cell, as the reference's does
        def init(generator, device="cuda"):
            return lstm_lm.init_params(generator, cfg, device)

        def loss(params, batch):
            return lstm_lm.loss_fn(params, cfg, batch)

        def prefill(params, batch):
            return lstm_lm.prefill(params, cfg, batch["tokens"])

        def init_state(batch, max_len, quantized=False, device="cuda"):
            return lstm_lm.init_decode_state(cfg, batch, device)

        def decode(params, token, state):
            return lstm_lm.decode_step(params, cfg, token, state)

        return ModelBundle(cfg, init, loss, prefill, init_state, decode)

    transformer.check_dense(cfg)

    def init(generator, device="cuda"):
        return transformer.init_params(generator, cfg, device)

    def loss(params, batch):
        return transformer.loss_fn(params, cfg, batch)

    def prefill(params, batch):
        return transformer.prefill(
            params, cfg, batch["tokens"],
            frontend_embeds=batch.get("frontend_embeds"))

    def init_state(batch, max_len, quantized=False, device="cuda"):
        return transformer.init_decode_cache(cfg, batch, max_len,
                                             quantized=quantized,
                                             device=device)

    def decode(params, token, state):
        return transformer.decode_step(params, cfg, token, state)

    return ModelBundle(cfg, init, loss, prefill, init_state, decode)
