"""Unified model API: build an architecture's serving functions from its
``ArchConfig`` (port of ``repro.models.model_zoo``).

``build(cfg)`` returns a ``ModelBundle`` of plain functions:

    init(generator, device="cuda")   -> params
    loss(params, batch)              -> mean next-token cross-entropy
    prefill(params, batch)           -> last-token logits (B, vocab)
    init_state(batch, max_len, quantized, device="cuda")
                                     -> decode cache
    decode(params, token, state)     -> (logits (B, vocab), state)

for the ``dense``, ``vlm`` and ``moe`` families (``batch`` is ``{"tokens":
(B, S)}``, plus ``"labels"`` for the loss and ``"frontend_embeds": (B, F,
d)`` for the VLM stub; the MoE models grok-1-314b and kimi-k2-1t-a32b
on one device, their ``loss`` with the auxiliary load-balancing loss),
the ``lstm`` family (the float recurrent LM of every
``rnn_cell``: ``lstm-rnnt``, ``gru-rnnt``), ``encdec`` (whisper-tiny: the
batch also holds ``"frontend_embeds": (B, N_FRAMES, d)``, the frontend
stub's frames), ``ssm`` (falcon-mamba-7b) and ``hybrid``
(recurrentgemma-9b, whose attention cache is clamped to its window).  Only
the transformer families' caches take ``quantized`` (int8 K/V); the others
keep their float state, as in the reference.  Params and state go to the
card unless the caller passes another device.  The dry-run's
``input_specs`` is not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

from ..configs.base import ArchConfig
from . import lstm_lm, mamba, recurrentgemma, transformer, whisper

PORTED = ("dense", "vlm", "moe", "lstm", "encdec", "ssm", "hybrid")


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
            f"(ported: {', '.join(PORTED)})")
    return _FAMILIES[cfg.family](cfg)


def _module_bundle(cfg: ArchConfig, mod, prefill, init_state
                   ) -> ModelBundle:
    """The bundle of a model module with the reference's ``init_params``,
    ``loss_fn`` and ``decode_step``; ``prefill(params, batch)`` and
    ``init_state(batch, max_len, quantized, device)`` are the family's
    own."""
    def init(generator, device="cuda"):
        return mod.init_params(generator, cfg, device)

    def loss(params, batch):
        return mod.loss_fn(params, cfg, batch)

    def state(batch, max_len, quantized=False, device="cuda"):
        return init_state(batch, max_len, quantized, device)

    def decode(params, token, st):
        return mod.decode_step(params, cfg, token, st)

    return ModelBundle(cfg, init, loss, prefill, state, decode)


def _dense(cfg: ArchConfig) -> ModelBundle:
    return _module_bundle(
        cfg, transformer,
        lambda p, b: transformer.prefill(
            p, cfg, b["tokens"], frontend_embeds=b.get("frontend_embeds")),
        lambda batch, max_len, quantized, device:
        transformer.init_decode_cache(cfg, batch, max_len,
                                      quantized=quantized, device=device))


_FAMILIES = {
    "dense": _dense,
    "vlm": _dense,
    "moe": _dense,  # layers/moe.py on one device
    # one registration serves every cell: lstm_lm dispatches on
    # cfg.rnn_cell, as the reference's does
    "lstm": lambda cfg: _module_bundle(
        cfg, lstm_lm, lambda p, b: lstm_lm.prefill(p, cfg, b["tokens"]),
        lambda batch, max_len, quantized, device:
        lstm_lm.init_decode_state(cfg, batch, device)),
    "encdec": lambda cfg: _module_bundle(
        cfg, whisper,
        lambda p, b: whisper.prefill(p, cfg, b["tokens"],
                                     b["frontend_embeds"]),
        lambda batch, max_len, quantized, device:
        whisper.init_decode_state(cfg, batch, max_len, device=device)),
    "ssm": lambda cfg: _module_bundle(
        cfg, mamba, lambda p, b: mamba.prefill(p, cfg, b["tokens"]),
        lambda batch, max_len, quantized, device:
        mamba.init_decode_state(cfg, batch, device=device)),
    "hybrid": lambda cfg: _module_bundle(
        cfg, recurrentgemma,
        lambda p, b: recurrentgemma.prefill(p, cfg, b["tokens"]),
        lambda batch, max_len, quantized, device:
        recurrentgemma.init_decode_state(
            cfg, batch, min(cfg.attn_window, max_len), device=device)),
}
