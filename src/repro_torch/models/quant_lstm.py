"""Integer-only recurrent layer execution (paper sec 3.2), any cell.

Port of ``repro.models.quant_lstm``: the serving layer
(``quant_recurrent_layer`` over the executors of ``kernels/ops.py``), the
per-gate reference executor ``quant_lstm_layer_ref`` and the float hybrid
baseline.  The only float touch points of the integer path are the
boundary helpers ``quantize_input`` and ``dequantize_output``; everything
between them is integer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import cell as rcell
from ..core import fixedpoint as fp
from ..core import integer_ops as iops
from ..kernels import ops as kops
from ..kernels.int_layernorm import int_layernorm


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 scalar on ``like``'s device, so CPU and CUDA run the same
    float32 operation (a Python scalar or a 0-d CPU tensor is a "CPU
    scalar" to PyTorch, which CUDA handles on its own terms)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def quantize_input(x: torch.Tensor, scale: float, zero_point: int
                   ) -> torch.Tensor:
    """round(x / s) + zp, as the reference computes it under ``jax.jit``.

    There the scale is a compile-time constant and XLA rewrites ``x / s``
    into ``x * f32(1 / f32(s))``, which rounds differently from true
    division for values within an ulp of a .5 boundary.  The port
    multiplies by that same float32 reciprocal.
    """
    inv = float(np.float32(1.0) / np.float32(scale))
    q = torch.round(x * _f32(inv, x)) + zero_point
    return q.clamp(-128, 127).to(torch.int8)


def dequantize_output(q: torch.Tensor, scale: float, zero_point: int
                      ) -> torch.Tensor:
    return (q.to(torch.float32) - zero_point) * _f32(scale, q)


def initial_recurrent_state(spec, batch: int, device
                            ) -> Tuple[torch.Tensor, ...]:
    """t=0 state tuple for any registered cell (``core/cell.py``)."""
    return rcell.get_cell(spec).init_state(spec, batch, device)


def reset_recurrent_state_rows(spec, state: Tuple[torch.Tensor, ...], row
                               ) -> Tuple[torch.Tensor, ...]:
    """Reset batch row ``row`` of one layer's state tuple to t=0 (a new
    tuple; the engine's slot reset)."""
    return rcell.get_cell(spec).reset_rows(spec, state, row)


def quant_recurrent_layer(
    arrays: Dict[str, Any], spec, xs_q: torch.Tensor,
    state0: Optional[Tuple[torch.Tensor, ...]] = None, *,
    valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Integer layer over time.  int8 (B, T, d_in) -> (B, T, d_out).

    Runs the two-stage hoisted executor of ``kernels/ops.py``; ``valid_len``
    (int32 ``(B,)``) selects the ragged masked form.
    """
    if state0 is None:
        state0 = initial_recurrent_state(spec, xs_q.shape[0], xs_q.device)
    if valid_len is not None:
        return kops.quant_recurrent_seq_masked(arrays, spec, xs_q, state0,
                                               valid_len)
    return kops.quant_recurrent_seq(arrays, spec, xs_q, state0)


# ---------------------------------------------------------------------------
# Per-gate reference executor (the readable ground truth the packed
# executors are held against bit for bit)
# ---------------------------------------------------------------------------


def _add32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int32 + int32 with the reference's two's-complement wrap."""
    return fp._wrap32(a.to(torch.int64) + b.to(torch.int64)).to(torch.int32)


def _gate_accumulators(arrays: Dict[str, Any], spec, g: str,
                       x_q: torch.Tensor, h_q: torch.Tensor,
                       c_q: Optional[torch.Tensor]) -> torch.Tensor:
    """Gate ``g``'s int16 pre-activation from its column block of the
    packed weights: ``sat16(mbqm(x W_g) sat+ mbqm(h R_g) [sat+ mbqm(P_g
    c)])``."""
    gs = spec.gate_spec(g)
    sl = spec.gate_block(g)
    acc_x = _add32(iops.matmul_i8_i32(x_q, arrays["W_cat"][:, sl]),
                   arrays["fold_x_cat"][sl])
    acc_h = _add32(iops.matmul_i8_i32(h_q, arrays["R_cat"][:, sl]),
                   arrays["fold_hb_cat"][sl])
    gate = fp.saturating_add_i32(
        fp.multiply_by_quantized_multiplier(acc_x, *gs.eff_x),
        fp.multiply_by_quantized_multiplier(acc_h, *gs.eff_h))
    if gs.eff_c is not None and c_q is not None:
        acc_c = iops.matmul_i16_elementwise(arrays["P"][g], c_q)
        gate = fp.saturating_add_i32(
            gate, fp.multiply_by_quantized_multiplier(acc_c, *gs.eff_c))
    return fp.saturate_i16(gate)


def _gate(arrays: Dict[str, Any], spec, g: str, x_q: torch.Tensor,
          h_q: torch.Tensor, c_q: Optional[torch.Tensor]) -> torch.Tensor:
    """Gate pre-activation in int16 after the optional integer LayerNorm
    (the LayerNorm kernel on CUDA tensors)."""
    gate16 = _gate_accumulators(arrays, spec, g, x_q, h_q, c_q)
    if spec.use_layernorm:
        gs = spec.gate_spec(g)
        gate16 = int_layernorm(gate16, arrays["L"][g], arrays["Lb"][g],
                               out_m0=gs.ln_out[0], out_shift=gs.ln_out[1])
    return gate16


def quant_lstm_cell(arrays: Dict[str, Any], spec, x_q: torch.Tensor,
                    h_q: torch.Tensor, c_q: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One integer LSTM step in the reference's per-gate order.  x_q: int8
    (B, d_in); h_q: int8; c_q: int16.  Returns (h_new int8, c_new int16)."""
    n_c = 15 - spec.cell_int_bits
    f_act = fp.sigmoid_q15(_gate(arrays, spec, "f", x_q, h_q, c_q), 3).to(
        torch.int32)
    z_act = fp.tanh_q15(_gate(arrays, spec, "z", x_q, h_q, None), 3).to(
        torch.int32)
    if spec.use_cifg:  # i = 1 - f in Q0.15, clamped into int16
        i_act = torch.clamp(32768 - f_act, max=32767)
    else:
        i_act = fp.sigmoid_q15(_gate(arrays, spec, "i", x_q, h_q, c_q), 3).to(
            torch.int32)
    c_new = fp.saturate_i16(fp.saturating_add_i32(
        fp.rounding_divide_by_pot(i_act * z_act, 30 - n_c),
        fp.rounding_divide_by_pot(f_act * c_q.to(torch.int32), 15)))
    o_act = fp.sigmoid_q15(_gate(arrays, spec, "o", x_q, h_q, c_new), 3).to(
        torch.int32)
    g_c = fp.tanh_q15(c_new, spec.cell_int_bits).to(torch.int32)
    m_q = fp.saturate_i8(fp._wrap32(
        fp.multiply_by_quantized_multiplier(o_act * g_c, *spec.eff_m).to(
            torch.int64) + spec.zp_m))
    if not spec.use_projection:
        return m_q, c_new
    acc = _add32(iops.matmul_i8_i32(m_q, arrays["W_proj"]),
                 arrays["fold_proj"])
    h_new = fp.multiply_by_quantized_multiplier(acc, *spec.eff_proj)
    return fp.saturate_i8(fp._wrap32(h_new.to(torch.int64) + spec.zp_h_out)), \
        c_new


def _initial_state(spec, B: int, h0_q: Optional[torch.Tensor],
                   c0_q: Optional[torch.Tensor], device
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(h0, c0)``, each missing leaf at the cell's t=0 value."""
    if h0_q is None or c0_q is None:
        h_init, c_init = initial_recurrent_state(spec, B, device)
        h0_q = h_init if h0_q is None else h0_q
        c0_q = c_init if c0_q is None else c0_q
    return h0_q, c0_q


def reset_state_rows(spec, h_q: torch.Tensor, c_q: torch.Tensor, row
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LSTM-shaped ``reset_recurrent_state_rows``: new tensors with batch
    row ``row`` back at t=0."""
    return reset_recurrent_state_rows(spec, (h_q, c_q), row)


def quant_lstm_layer(arrays: Dict[str, Any], spec, xs_q: torch.Tensor,
                     h0_q: Optional[torch.Tensor] = None,
                     c0_q: Optional[torch.Tensor] = None, *,
                     valid_len: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """LSTM-shaped wrapper over ``quant_recurrent_layer`` (bit-exact with
    the per-gate ``quant_lstm_layer_ref``)."""
    state0 = _initial_state(spec, xs_q.shape[0], h0_q, c0_q, xs_q.device)
    return quant_recurrent_layer(arrays, spec, xs_q, state0,
                                 valid_len=valid_len)


def quant_lstm_layer_ref(arrays: Dict[str, Any], spec, xs_q: torch.Tensor,
                         h0_q: Optional[torch.Tensor] = None,
                         c0_q: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Per-gate reference executor (8 gate matmuls per step)."""
    h, c = _initial_state(spec, xs_q.shape[0], h0_q, c0_q, xs_q.device)
    ys = []
    for t in range(xs_q.shape[1]):
        h, c = quant_lstm_cell(arrays, spec, xs_q[:, t], h, c)
        ys.append(h)
    if not ys:
        return h.new_zeros((xs_q.shape[0], 0, h.shape[-1])), (h, c)
    return torch.stack(ys, dim=1), (h, c)


# ---------------------------------------------------------------------------
# Hybrid baseline (dynamic-range quantization; the paper's Table 1 rows)
# ---------------------------------------------------------------------------


def hybrid_matmul(x: torch.Tensor, w_q: torch.Tensor, s_w: float
                  ) -> torch.Tensor:
    """Dynamic-range hybrid matmul: float32 activations quantized on the
    fly (per-tensor symmetric int8), int8 product, float dequantization."""
    max_abs = torch.clamp(x.abs().max(), min=1e-8)
    s_x = max_abs / 127.0
    x_q = torch.clamp(torch.round(x / s_x), -127, 127).to(torch.int8)
    acc = iops.matmul_i8_i32(x_q, w_q)
    return acc.to(torch.float32) * (s_x * s_w)


def hybrid_weights(params: Dict[str, Any]
                   ) -> Tuple[Dict[str, Any], Dict[str, float]]:
    """Quantize every matmul weight to symmetric int8 once (float64 numpy
    offline, as the reference does)."""

    def quantize(w):
        device = w.device if isinstance(w, torch.Tensor) else "cpu"
        w = (w.detach().to("cpu", torch.float64).numpy()
             if isinstance(w, torch.Tensor) else np.asarray(w, np.float64))
        s = max(np.abs(w).max(), 1e-8) / 127.0
        q = np.clip(np.round(w / s), -127, 127).astype(np.int8)
        return torch.from_numpy(q).to(device), float(s)

    wq: Dict[str, Any] = {"W": {}, "R": {}}
    scales: Dict[str, float] = {}
    for kind in ("W", "R"):
        for g, w in params[kind].items():
            wq[kind][g], scales[f"{kind}_{g}"] = quantize(w)
    if "W_proj" in params:
        wq["W_proj"], scales["W_proj"] = quantize(params["W_proj"])
    return wq, scales
