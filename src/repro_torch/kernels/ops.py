"""Integer recurrent executors, dispatched by tensor device.

Port of the executors of ``repro.kernels.ops``.  The hoisted executors
(``quant_recurrent_seq``, ``quant_recurrent_seq_masked``) run a layer in
two stages:

  1. ``quant_recurrent_input_proj``: the whole sequence's packed input
     product ``reshape(xs_q, (B*T, d_in)) @ W_cat + fold_x_cat`` as ONE
     int8 GEMM (``int8_matmul``); hoisting it out of the time loop is exact
     because integer accumulation is exact;
  2. the recurrent stage over time, the persistent sequence kernel
     (``quant_recurrent_seq_scan``).

The stepwise executor (``quant_recurrent_seq_stepwise``, the pre-hoist
baseline) loops ``quant_recurrent_step`` over time.  An LSTM step runs the
input and recurrent GEMMs, for an LN layer the gate pass that forms and
normalises its gates (``int_layernorm_gates``, one launch), the cell,
which forms any other gate itself (``quant_lstm_cell_step``), and the
projection (the GEMM's requantize epilogue): no PyTorch op between the
kernels.  A GRU step runs the input GEMM and the GRU sequence kernel over
one timestep.  Every path is bit-identical to the others.

There is no backend switch: CUDA tensors launch the kernels (or raise),
CPU tensors take the kernels' plain versions.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Tuple

import torch

from .int8_matmul import int8_matmul
from .int_layernorm import int_layernorm, int_layernorm_gates  # noqa: F401
from .quant_lstm_cell import (  # noqa: F401
    quant_lstm_cell, quant_lstm_cell_step)
from .quant_lstm_scan import quant_recurrent_seq_scan


def _empty_seq(xs_q: torch.Tensor, state0: Tuple[torch.Tensor, ...]):
    """T == 0 result: no outputs, the initial carry unchanged."""
    ys = state0[0].new_zeros((xs_q.shape[0], 0, state0[0].shape[-1]))
    return ys, tuple(state0)


def quant_recurrent_input_proj(arrays: Dict[str, Any],
                               xs_q: torch.Tensor) -> torch.Tensor:
    """Hoisted input stage: int8 ``(B, T, d_in)`` -> int32 ``(B, T, G*H)``."""
    B, T, d_in = xs_q.shape
    GH = arrays["W_cat"].shape[1]
    acc = int8_matmul(xs_q.reshape(B * T, d_in).contiguous(), arrays["W_cat"],
                      arrays["fold_x_cat"])
    return acc.reshape(B, T, GH)


quant_lstm_input_proj = quant_recurrent_input_proj


@functools.lru_cache(maxsize=None)
def _proj_multipliers(spec, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection's per-channel ``(m0, shift)``, all ``eff_proj``, built
    once per layer spec and device."""
    return tuple(torch.full((spec.d_out,), v, dtype=torch.int32,
                            device=device) for v in spec.eff_proj)


def _lstm_project(arrays: Dict[str, Any], spec, m_q: torch.Tensor
                  ) -> torch.Tensor:
    """``ref.lstm_project`` through the GEMM's requantize epilogue:
    ``sat8(mbqm(m @ W_proj + fold_proj, eff_proj) + zp_h_out)``, the same
    integers (the epilogue's plain version is that very sequence)."""
    if not spec.use_projection:
        return m_q
    m0, shift = _proj_multipliers(spec, m_q.device)
    return int8_matmul(m_q, arrays["W_proj"], arrays["fold_proj"], m0, shift,
                       out_dtype=torch.int8, zp_out=spec.zp_h_out)


def quant_lstm_recurrent_step(arrays: Dict[str, Any], spec,
                              acc_x_t: torch.Tensor, h_q: torch.Tensor,
                              c_q: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Recurrent stage of one LSTM timestep from the input accumulator
    slice: the recurrent GEMM, the gate pass (LN layers), the cell and the
    projection, each one launch on CUDA tensors.  Returns ``(h_new int8,
    c_new int16)``."""
    acc_h = int8_matmul(h_q, arrays["R_cat"], arrays["fold_hb_cat"])
    gates16 = (int_layernorm_gates(arrays, spec, acc_x_t, acc_h, c_q)
               if spec.use_layernorm else None)
    m_q, c_new = quant_lstm_cell_step(arrays, spec, acc_x_t, acc_h, c_q,
                                      gates16)
    return _lstm_project(arrays, spec, m_q), c_new


def _cell_recurrent_step(arrays: Dict[str, Any], spec, acc_x_t: torch.Tensor,
                         state: Tuple[torch.Tensor, ...]
                         ) -> Tuple[torch.Tensor, ...]:
    """One cell step from the input accumulator slice -> new state tuple.

    The LSTM runs its step kernels (``quant_lstm_recurrent_step``); any
    other cell runs its sequence kernel over one timestep, the function
    the reference's ``pallas`` lowering traces for it.
    """
    if getattr(spec, "cell", "lstm") == "lstm":
        return quant_lstm_recurrent_step(arrays, spec, acc_x_t, state[0],
                                         state[1])
    _, new = quant_recurrent_seq_scan(arrays, spec, acc_x_t[:, None], state)
    return new


def quant_recurrent_step(arrays: Dict[str, Any], spec, x_q: torch.Tensor,
                         state: Tuple[torch.Tensor, ...]
                         ) -> Tuple[torch.Tensor, ...]:
    """One integer timestep of any cell: int8 ``(B, d_in)`` -> the new
    state tuple (leaf 0 is the emitted output)."""
    acc_x = int8_matmul(x_q.contiguous(), arrays["W_cat"],
                        arrays["fold_x_cat"])
    return _cell_recurrent_step(arrays, spec, acc_x, tuple(state))


def quant_recurrent_seq(arrays: Dict[str, Any], spec, xs_q: torch.Tensor,
                        state0: Tuple[torch.Tensor, ...]
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Hoisted sequence executor: int8 (B, T, d_in) -> (B, T, d_out)."""
    state0 = tuple(state0)
    if xs_q.shape[1] == 0:
        return _empty_seq(xs_q, state0)
    acc_x_all = quant_recurrent_input_proj(arrays, xs_q)
    return quant_recurrent_seq_scan(arrays, spec, acc_x_all, state0)


def quant_recurrent_seq_stepwise(arrays: Dict[str, Any], spec,
                                 xs_q: torch.Tensor,
                                 state0: Tuple[torch.Tensor, ...]
                                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Pre-hoist executor: ``quant_recurrent_step`` per timestep, the input
    GEMM inside the loop.  The baseline the hoisted executors are held
    against; not on any serving path."""
    state = tuple(state0)
    if xs_q.shape[1] == 0:
        return _empty_seq(xs_q, state)
    steps = xs_q.transpose(0, 1).contiguous()  # step t's rows contiguous
    ys = []
    for x_t in steps:
        state = quant_recurrent_step(arrays, spec, x_t, state)
        ys.append(state[0])
    return torch.stack(ys, dim=1), state


def quant_recurrent_seq_masked(arrays: Dict[str, Any], spec,
                               xs_q: torch.Tensor,
                               state0: Tuple[torch.Tensor, ...],
                               valid_len: torch.Tensor
                               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Ragged executor: row b advances only for t < valid_len[b]; its state
    is frozen beyond that (bit-identical to feeding its prefix alone)."""
    state0 = tuple(state0)
    if xs_q.shape[1] == 0:
        return _empty_seq(xs_q, state0)
    acc_x_all = quant_recurrent_input_proj(arrays, xs_q)
    return quant_recurrent_seq_scan(arrays, spec, acc_x_all, state0,
                                    valid_len.to(torch.int32))


# -- LSTM-shaped wrappers: (h0, c0) threaded explicitly --


def quant_lstm_step(arrays, spec, x_q, h_q, c_q
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One integer LSTM timestep -> ``(h_new, c_new)``."""
    h, c = quant_recurrent_step(arrays, spec, x_q, (h_q, c_q))
    return h, c


def quant_lstm_seq(arrays, spec, xs_q, h0_q, c0_q):
    """Hoisted LSTM executor (``quant_recurrent_seq``)."""
    return quant_recurrent_seq(arrays, spec, xs_q, (h0_q, c0_q))


def quant_lstm_seq_stepwise(arrays, spec, xs_q, h0_q, c0_q):
    """Pre-hoist LSTM executor (``quant_recurrent_seq_stepwise``)."""
    return quant_recurrent_seq_stepwise(arrays, spec, xs_q, (h0_q, c0_q))


def quant_lstm_seq_masked(arrays, spec, xs_q, h0_q, c0_q, valid_len):
    """Ragged LSTM executor (``quant_recurrent_seq_masked``)."""
    return quant_recurrent_seq_masked(arrays, spec, xs_q, (h0_q, c0_q),
                                      valid_len)
