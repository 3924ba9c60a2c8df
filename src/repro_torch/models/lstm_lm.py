"""Stacked recurrent language model: float serving, QAT, calibration and
integer serving.

Port of ``repro.models.lstm_lm``: 10 layers x 2048 hidden (the RNN-T
encoder stack of the paper's Table 1), a bf16 embedding and a bf16 head.
``cfg.rnn_cell`` selects the cell: ``"lstm"`` (LN + a 640-wide projection)
or ``"gru"`` (the LN reset-after GRU, no projection).  The float stack
(``forward``, ``prefill``, ``decode_step``; ``loss_fn`` with ``qat``) is
the paper's accuracy baseline and runs plain PyTorch products, as the
reference runs them outside any Pallas kernel.  ``quantize_stack``
calibrates it and applies the Table-2 recipe; the step programs below
then run the stack integer-only through the hand-written CUDA kernels (on
CPU tensors, their plain versions).

The stacked decode state (float leaves, or integer ones) is ``{<cell
state keys...>: [per-layer tensors], "len": counter}`` (LSTM ``{"h", "c",
"len"}``, GRU ``{"h", "len"}``), its keys in the cell's declared leaf
order.  Every helper iterates those keys,
so the serving engine and the state pool never name a leaf.  The helpers
return new tensors and leave their inputs as they were.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core import cell as rc
from ..core import recipe as R
from ..core.calibrate import Stats, TapCollector
from ..layers import embedding as emb
from . import gru as G
from . import lstm as L
from . import quant_lstm as QL


def rnn_cell(cfg: ArchConfig) -> str:
    return getattr(cfg, "rnn_cell", "lstm")


def state_keys(cfg: ArchConfig) -> Tuple[str, ...]:
    """Ordered state keys of the stack's cell (leaf 0 = output)."""
    return rc.CELLS[rnn_cell(cfg)].state_key_names


def d_proj(cfg: ArchConfig) -> int:
    """Projection width: 2048 -> 640 (Sak et al. ratio 5/16)."""
    return max(cfg.d_rnn * 5 // 16, 8)


def stack_d_out(cfg: ArchConfig) -> int:
    """Per-layer output width (what the LM head consumes)."""
    return d_proj(cfg) if rnn_cell(cfg) == "lstm" else cfg.d_rnn


def layer_cfgs(cfg: ArchConfig) -> list:
    out = []
    for i in range(cfg.n_layers):
        d_in = cfg.d_model if i == 0 else stack_d_out(cfg)
        if rnn_cell(cfg) == "gru":
            out.append(G.GRUConfig(d_in, cfg.d_rnn,
                                   G.GRUVariant(use_layernorm=True)))
        else:
            variant = L.LSTMVariant(use_layernorm=True, use_projection=True)
            out.append(L.LSTMConfig(d_in, cfg.d_rnn, d_proj(cfg), variant))
    return out


def init_params(generator: torch.Generator, cfg: ArchConfig,
                device="cuda") -> Dict[str, Any]:
    """Random float params from a seeded generator (bf16 embedding/head,
    float32 layers), placed on ``device``.  The layers sit under
    ``params["lstm"]`` for every cell, as in the reference."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device)
    init_layer = (G.init_gru_params if rnn_cell(cfg) == "gru"
                  else L.init_lstm_params)
    params["lstm"] = [init_layer(generator, lc, device)
                      for lc in layer_cfgs(cfg)]
    head = torch.randn((stack_d_out(cfg), cfg.vocab_size),
                       generator=generator, device=generator.device) * 0.02
    params["lm_head"] = head.to(device=device, dtype=torch.bfloat16)
    return params


class _Prefixed:
    def __init__(self, collector, prefix):
        self.collector = collector
        self.prefix = prefix

    def tap(self, name, x):
        return self.collector.tap(self.prefix + name, x)


def _float_layer(p, lc, x, layer_states, collector, qat):
    """One float layer over ``x`` -> ``(ys, per-layer state tuple)``.

    ``qat`` reaches only the LSTM (the QAT experiments target the paper's
    own topology); the GRU float graph is baseline + calibration only.
    """
    if isinstance(lc, G.GRUConfig):
        h0 = None if layer_states is None else layer_states[0]
        ys, h = G.gru_layer(p, lc, x, h0, collector=collector)
        return ys, (h,)
    h0, c0 = (None, None) if layer_states is None else layer_states
    ys, (h, c) = L.lstm_layer(p, lc, x, h0, c0, collector=collector, qat=qat)
    return ys, (h, c)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor, states=None,
            collector=None, qat: bool = False):
    """Float forward over ``(B, T)`` tokens -> ``(bf16 logits (B, T, V),
    new states)``; the new states are None unless ``states`` is given."""
    keys = state_keys(cfg)
    x = emb.embed_tokens(params, tokens).to(torch.float32)
    new_states = []
    for i, (p, lc) in enumerate(zip(params["lstm"], layer_cfgs(cfg))):
        col = _Prefixed(collector, f"l{i}/") if collector is not None else None
        layer_states = (None if states is None else
                        tuple(states[k][i] for k in keys))
        x, st = _float_layer(p, lc, x, layer_states, col, qat)
        new_states.append(st)
    logits = emb.logits_head(params, x.to(torch.bfloat16))
    if states is None:
        return logits, None
    out: Dict[str, Any] = {k: [s[j] for s in new_states]
                           for j, k in enumerate(keys)}
    out["len"] = states["len"] + tokens.shape[1]
    return logits, out


def loss_fn(params, cfg: ArchConfig, batch, qat: bool = False
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``{"tokens", "labels"}``,
    tensors on the params' device) under the float or QAT graph."""
    logits, _ = forward(params, cfg, batch["tokens"], qat=qat)
    return emb.cross_entropy(logits, batch["labels"])


def init_decode_state(cfg: ArchConfig, batch: int, device="cuda"
                      ) -> Dict[str, Any]:
    """Float decode state: every cell leaf zero (float32), ``len`` 0."""
    widths = {"h": stack_d_out(cfg), "c": cfg.d_rnn}
    out: Dict[str, Any] = {
        k: [torch.zeros((batch, widths[k]), device=device)
            for _ in range(cfg.n_layers)]
        for k in state_keys(cfg)}
    out["len"] = torch.zeros((), dtype=torch.int32, device=device)
    return out


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """Float forward over the prompt -> last-position logits ``(B, V)``."""
    logits, _ = forward(params, cfg, tokens)
    return logits[:, -1]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, states):
    """One float step: ``(logits (B, V), new states)``."""
    logits, new_states = forward(params, cfg, token, states=states)
    return logits[:, -1], new_states


def calibration_stats(params, cfg: ArchConfig, calib_tokens) -> Stats:
    """Float forward over the calibration tokens with every tap recorded."""
    col = TapCollector()
    with torch.no_grad():
        forward(params, cfg, calib_tokens, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    return stats


def quantize_layers(params, cfg: ArchConfig, stats: Stats) -> list:
    """Apply the Table-2 recipe to every layer from calibrated ``stats``.

    Returns one ``(arrays, spec)`` pair per recurrent layer, the arrays on
    the params' device; the cell's quantizer is picked by the config.
    """
    quantize_layer = (R.quantize_gru_layer if rnn_cell(cfg) == "gru"
                      else R.quantize_lstm_layer)
    return [quantize_layer(p, lc, stats, prefix=f"l{i}/")
            for i, (p, lc) in enumerate(zip(params["lstm"], layer_cfgs(cfg)))]


def quantize_stack(params, cfg: ArchConfig, calib_tokens) -> list:
    """Calibrate on ``calib_tokens`` and apply the Table-2 recipe per layer
    (``quantize_layers``)."""
    return quantize_layers(params, cfg,
                           calibration_stats(params, cfg, calib_tokens))


# ---------------------------------------------------------------------------
# Integer decode state helpers
# ---------------------------------------------------------------------------


def _cell_state_keys(qlayers) -> Tuple[str, ...]:
    """The cell's DECLARED state-leaf order (leaf 0 = output)."""
    spec = qlayers[0][1]
    return rc.get_cell(spec).state_keys(spec)


def _leaf_keys(states) -> Tuple[str, ...]:
    """State keys of a stacked decode state (all but ``len``), in the
    order the state was built in: the cell's declared order."""
    return tuple(k for k in states if k != "len")


def init_quant_decode_state(qlayers, batch: int, device=None,
                            per_slot_len: bool = False) -> Dict[str, Any]:
    """Integer decode state: every leaf at its declared reset value.

    ``per_slot_len=True`` tracks a per-row ``(batch,)`` token counter
    instead of one scalar, as the continuous-batching engine needs.
    """
    if device is None:
        device = qlayers[0][0]["R_cat"].device
    keys = _cell_state_keys(qlayers)
    out: Dict[str, Any] = {k: [] for k in keys}
    for _, spec in qlayers:
        for k, leaf in zip(keys, QL.initial_recurrent_state(spec, batch,
                                                            device)):
            out[k].append(leaf)
    out["len"] = torch.zeros((batch,) if per_slot_len else (),
                             dtype=torch.int32, device=device)
    return out


def reset_quant_slot(qlayers, states, slot: int) -> Dict[str, Any]:
    """Reset batch row ``slot`` of the stacked decode state to t=0."""
    keys = _cell_state_keys(qlayers)
    out: Dict[str, Any] = {k: [] for k in keys}
    for i, (_, spec) in enumerate(qlayers):
        layer = tuple(states[k][i] for k in keys)
        for k, leaf in zip(keys,
                           QL.reset_recurrent_state_rows(spec, layer, slot)):
            out[k].append(leaf)
    length = states["len"]
    if length.ndim:
        length = length.clone()
        length[slot] = 0
    out["len"] = length
    return out


def _on(x, like: torch.Tensor) -> torch.Tensor:
    """A host row (numpy or tensor) as a tensor on ``like``'s device."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    return x.to(like.device)


def write_quant_slot(states, slot: int, row_state) -> Dict[str, Any]:
    """Write a batch-1 state (host numpy from the pool, or tensors) into
    batch row ``slot`` of a stacked state: the resume half of preemption,
    bit-exact because every leaf is integer."""
    out: Dict[str, Any] = {}
    for k in _leaf_keys(states):
        col = []
        for leaf, r in zip(states[k], row_state[k], strict=True):
            leaf = leaf.clone()
            leaf[slot] = _on(r, leaf)[0]
            col.append(leaf)
        out[k] = col
    length = states["len"]
    if length.ndim:
        length = length.clone()
        length[slot] = _on(row_state["len"], length).reshape(-1)[0]
    out["len"] = length
    return out


def slice_state(states, row: int) -> Dict[str, Any]:
    """One stream's decode state as a batch-1 state (views of the rows).

    Rows are computed independently, so decoding the slice alone continues
    the stream bit-exactly.
    """
    sl = slice(row, row + 1)
    out = {k: [leaf[sl] for leaf in states[k]] for k in _leaf_keys(states)}
    length = states["len"]
    out["len"] = length[sl] if length.ndim else length
    return out


def stack_state(state_list) -> Dict[str, Any]:
    """Concatenate per-stream decode states along the batch axis; scalar
    ``len`` entries become one counter per stacked row."""
    keys = _leaf_keys(state_list[0])
    n_layers = len(state_list[0][keys[0]])
    out = {k: [torch.cat([s[k][i] for s in state_list], dim=0)
               for i in range(n_layers)] for k in keys}
    out["len"] = torch.cat([s["len"].reshape(-1) for s in state_list])
    return out


# ---------------------------------------------------------------------------
# Integer step programs
# ---------------------------------------------------------------------------


def _quant_stack(params, qlayers, tokens: torch.Tensor, states,
                 valid_len=None):
    """Run the integer stack over a ``(B, T)`` token block.

    Each layer quantizes its float input with its calibrated (s_x, zp_x),
    runs the two-stage integer executor and dequantizes for the next layer.
    ``valid_len`` (int32 ``(B,)``) selects the ragged masked executor: row
    b consumes its first ``valid_len[b]`` tokens and freezes its state (and
    ``len``) beyond them; outputs past that come from frozen state.
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


def quant_chunk_step(params, qlayers, cfg: ArchConfig, tokens, states,
                     valid_len):
    """Chunked-prefill step: ragged stack over a ``(B, K)`` block, the LM
    head evaluated ONLY at each row's last valid position (position 0 for
    ``valid_len == 0`` rows, whose logits the caller ignores).  Returns
    ``((B, V) logits, new states)``."""
    x, new_states = _quant_stack(params, qlayers, tokens, states, valid_len)
    idx = (valid_len.to(torch.long) - 1).clamp(min=0)
    last = x.gather(1, idx[:, None, None].expand(-1, 1, x.shape[-1]))[:, 0]
    return emb.logits_head(params, last.to(torch.bfloat16)), new_states


def quant_verify_step(params, qlayers, cfg: ArchConfig, tokens, states,
                      valid_len, draft_len):
    """Speculative verify step over a ``(B, W)`` block.

    Row b's first ``valid_len[b] - draft_len[b]`` positions are committed
    tokens and the next ``draft_len[b]`` draft candidates.  The step runs
    the masked stack once with an all-positions head, accepts each row's
    longest confirmed prefix (a draft at position j is consumed iff every
    earlier one was and the argmax at j-1 equals it), and re-advances the
    PRE-step state to exactly that length, so rejected positions never
    reach the state.  Returns ``(pred (B, W) int32, accepted (B,) int32,
    new_states)``.
    """
    x, _ = _quant_stack(params, qlayers, tokens, states, valid_len)
    logits = emb.logits_head(params, x.to(torch.bfloat16))
    pred = logits.argmax(dim=-1).to(torch.int32)
    base = valid_len - draft_len
    pos = torch.arange(tokens.shape[1], dtype=torch.int32,
                       device=tokens.device)[None, :]
    match = torch.cat([torch.ones_like(pred[:, :1], dtype=torch.bool),
                       pred[:, :-1] == tokens[:, 1:]], dim=1)
    ok = (pos < base[:, None]) | ((pos < valid_len[:, None]) & match)
    accepted = ok.to(torch.int32).cumprod(dim=1).sum(dim=1).to(torch.int32)
    _, new_states = _quant_stack(params, qlayers, tokens, states, accepted)
    return pred, accepted, new_states


def quant_chunk_advance(params, qlayers, cfg: ArchConfig, tokens, states,
                        valid_len):
    """Chunked-prefill advance: the ragged stack over ``(B, K)``, state
    only (no LM head, for steps where no row emits a token)."""
    _, new_states = _quant_stack(params, qlayers, tokens, states, valid_len)
    return new_states


def quant_prefill(params, qlayers, cfg: ArchConfig, tokens, states):
    """Teacher-forced integer prefill: one pass over the whole prompt (one
    launch of each kernel per layer)."""
    logits, states = quant_forward(params, qlayers, cfg, tokens, states)
    return logits[:, -1], states


def quant_decode_step(params, qlayers, cfg: ArchConfig, token, states):
    logits, states = quant_forward(params, qlayers, cfg, token, states)
    return logits[:, -1], states
