"""Stacked recurrent language model: float init + calibration + integer serving.

Port of the LSTM half of ``repro.models.lstm_lm``: 10 layers x 2048 hidden
with a 640-wide projection (the RNN-T encoder stack of the paper's Table
1), a bf16 embedding and a bf16 head.  ``quantize_stack`` calibrates the
float stack and applies the Table-2 recipe; ``quant_prefill`` and
``quant_decode_step`` then run the stack integer-only through the two
hand-written CUDA kernels (on CPU tensors, their plain versions).

The stacked decode state is ``{"h": [per-layer int8], "c": [per-layer
int16], "len": counter}``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..configs.base import ArchConfig
from ..core import cell as rc
from ..core import recipe as R
from ..core.calibrate import Stats, TapCollector
from ..layers import embedding as emb
from . import lstm as L
from . import quant_lstm as QL


def rnn_cell(cfg: ArchConfig) -> str:
    return getattr(cfg, "rnn_cell", "lstm")


def d_proj(cfg: ArchConfig) -> int:
    """Projection width: 2048 -> 640 (Sak et al. ratio 5/16)."""
    return max(cfg.d_rnn * 5 // 16, 8)


def layer_cfgs(cfg: ArchConfig) -> List[L.LSTMConfig]:
    if rnn_cell(cfg) != "lstm":
        raise NotImplementedError(
            f"this port serves the LSTM stack, not rnn_cell={rnn_cell(cfg)!r}")
    variant = L.LSTMVariant(use_layernorm=True, use_projection=True)
    return [L.LSTMConfig(cfg.d_model if i == 0 else d_proj(cfg), cfg.d_rnn,
                         d_proj(cfg), variant)
            for i in range(cfg.n_layers)]


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Dict[str, Any]:
    """Random float params from a seeded generator (bf16 embedding/head,
    float32 layers), placed on ``device``."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device)
    params["lstm"] = [L.init_lstm_params(generator, lc, device)
                      for lc in layer_cfgs(cfg)]
    head = torch.randn((d_proj(cfg), cfg.vocab_size), generator=generator,
                       device=generator.device) * 0.02
    params["lm_head"] = head.to(device=device, dtype=torch.bfloat16)
    return params


class _Prefixed:
    def __init__(self, collector, prefix):
        self.collector = collector
        self.prefix = prefix

    def tap(self, name, x):
        return self.collector.tap(self.prefix + name, x)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, collector=None
            ) -> torch.Tensor:
    """Float forward over ``(B, T)`` tokens -> bf16 logits ``(B, T, V)``."""
    x = emb.embed_tokens(params, tokens).to(torch.float32)
    for i, (p, lc) in enumerate(zip(params["lstm"], layer_cfgs(cfg))):
        col = _Prefixed(collector, f"l{i}/") if collector is not None else None
        x, _ = L.lstm_layer(p, lc, x, collector=col)
    return emb.logits_head(params, x.to(torch.bfloat16))


def calibration_stats(params, cfg: ArchConfig, calib_tokens) -> Stats:
    """Float forward over the calibration tokens with every tap recorded."""
    col = TapCollector()
    with torch.no_grad():
        forward(params, cfg, calib_tokens, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    return stats


def quantize_stack(params, cfg: ArchConfig, calib_tokens
                   ) -> List[Tuple[Dict[str, Any], R.QLSTMSpec]]:
    """Calibrate on ``calib_tokens`` and apply the Table-2 recipe per layer.

    Returns one ``(arrays, spec)`` pair per recurrent layer, the arrays on
    the params' device.
    """
    stats = calibration_stats(params, cfg, calib_tokens)
    return [R.quantize_lstm_layer(p, lc, stats, prefix=f"l{i}/")
            for i, (p, lc) in enumerate(zip(params["lstm"], layer_cfgs(cfg)))]


def _cell_state_keys(qlayers) -> Tuple[str, ...]:
    spec = qlayers[0][1]
    return rc.get_cell(spec).state_keys(spec)


def init_quant_decode_state(qlayers, batch: int, device=None
                            ) -> Dict[str, Any]:
    """Integer decode state: every leaf at its declared reset value."""
    if device is None:
        device = qlayers[0][0]["R_cat"].device
    keys = _cell_state_keys(qlayers)
    out: Dict[str, Any] = {k: [] for k in keys}
    for _, spec in qlayers:
        for k, leaf in zip(keys, QL.initial_recurrent_state(spec, batch,
                                                            device)):
            out[k].append(leaf)
    out["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def _quant_stack(params, qlayers, tokens: torch.Tensor, states,
                 valid_len=None):
    """Run the integer stack over a ``(B, T)`` token block.

    Each layer quantizes its float input with its calibrated (s_x, zp_x),
    runs the two-stage integer executor and dequantizes for the next layer.
    ``valid_len`` (int32 ``(B,)``) selects the ragged masked executor.
    Returns the float stack output ``(B, T, d_out)`` and the new states.
    """
    keys = _cell_state_keys(qlayers)
    x = emb.embed_tokens(params, tokens).to(torch.float32)
    new: Dict[str, Any] = {k: [] for k in keys}
    for i, (arrays, spec) in enumerate(qlayers):
        x_q = QL.quantize_input(x, spec.s_x, spec.zp_x)
        ys_q, layer = QL.quant_recurrent_layer(
            arrays, spec, x_q, tuple(states[k][i] for k in keys),
            valid_len=valid_len)
        x = QL.dequantize_output(ys_q, spec.s_h, spec.zp_h_out)
        for k, leaf in zip(keys, layer):
            new[k].append(leaf)
    new["len"] = states["len"] + (tokens.shape[1] if valid_len is None
                                  else valid_len)
    return x, new


def quant_forward(params, qlayers, cfg: ArchConfig, tokens, states,
                  valid_len=None):
    """Integer stack over ``tokens``: (B, T) -> bf16 logits (B, T, V)."""
    x, new_states = _quant_stack(params, qlayers, tokens, states, valid_len)
    return emb.logits_head(params, x.to(torch.bfloat16)), new_states


def quant_prefill(params, qlayers, cfg: ArchConfig, tokens, states):
    """Teacher-forced integer prefill: one pass over the whole prompt (one
    launch of each kernel per layer)."""
    logits, states = quant_forward(params, qlayers, cfg, tokens, states)
    return logits[:, -1], states


def quant_decode_step(params, qlayers, cfg: ArchConfig, token, states):
    logits, states = quant_forward(params, qlayers, cfg, token, states)
    return logits[:, -1], states
