"""Integer-only recurrent layer execution (paper sec 3.2), any cell.

Port of the serving half of ``repro.models.quant_lstm``.  The only float
touch points are the boundary helpers ``quantize_input`` and
``dequantize_output``; everything between them is integer.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..core import cell as rcell
from ..kernels import ops as kops


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
