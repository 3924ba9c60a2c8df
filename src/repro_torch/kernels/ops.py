"""Two-stage integer recurrent executors, dispatched by tensor device.

Port of the sequence executors of ``repro.kernels.ops``.  A layer runs in
two stages:

  1. ``quant_recurrent_input_proj``: the whole sequence's packed input
     product ``reshape(xs_q, (B*T, d_in)) @ W_cat + fold_x_cat`` as ONE
     int8 GEMM (kernel 1, ``int8_matmul``); hoisting it out of the time
     loop is exact because integer accumulation is exact;
  2. the recurrent stage over time (kernel 2, ``quant_lstm_scan``).

There is no backend switch: CUDA tensors launch the kernels (or raise),
CPU tensors take the kernels' plain versions.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from .int8_matmul import int8_matmul
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


def quant_recurrent_seq(arrays: Dict[str, Any], spec, xs_q: torch.Tensor,
                        state0: Tuple[torch.Tensor, ...]
                        ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Hoisted sequence executor: int8 (B, T, d_in) -> (B, T, d_out)."""
    state0 = tuple(state0)
    if xs_q.shape[1] == 0:
        return _empty_seq(xs_q, state0)
    acc_x_all = quant_recurrent_input_proj(arrays, xs_q)
    return quant_recurrent_seq_scan(arrays, spec, acc_x_all, state0)


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
