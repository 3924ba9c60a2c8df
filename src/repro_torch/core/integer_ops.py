"""Integer-only tensor ops: matmul, zero-point folding, LayerNorm.

Port of ``repro.core.integer_ops``.  These are the plain PyTorch versions:
the CPU path, and the oracle each CUDA kernel is held against on the card.
LayerNorm statistics are exact int64 sums (the reference carries them as
uint32 limb pairs; the value is the same).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import fixedpoint as fp


def matmul_i8_i32(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """int8 x int8 -> int32 matmul (... k) @ (k, n), exact on any device.

    An int8 ``torch.matmul`` returns int8 and wraps silently, and CUDA has
    no integer matmul at all, so the product runs in float64: every
    partial sum is an integer below 2**53 for k < 2**38, hence exact.
    """
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise TypeError(f"matmul_i8_i32 takes int8 operands, got "
                        f"{x_q.dtype} and {w_q.dtype}")
    return (x_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.int32)


def matmul_i16_elementwise(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """int16 (x) int16 -> int32 elementwise product (peephole, sec 3.2.3)."""
    return a_q.to(torch.int32) * b_q.to(torch.int32)


def fold_zero_point(w_q_i8: torch.Tensor, x_zero_point: int,
                    bias_q: Optional[torch.Tensor]) -> torch.Tensor:
    """Fold the activation zero-point correction into the bias (sec 6):
    ``W(x_q - zp) + b == W x_q - colsum(W) * zp + b``."""
    col_sum = w_q_i8.to(torch.int64).sum(dim=0)
    folded = -col_sum * int(x_zero_point)
    if bias_q is not None:
        folded = folded + bias_q.to(torch.int64)
    return fp._wrap32(folded).to(torch.int32)


def row_stats(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum_q, sum_q2) int64 over the last axis; exact for n <= 2**14."""
    n = q.shape[-1]
    if n > (1 << 14):
        raise ValueError(f"integer norm supports rows up to 16384, got {n}")
    q64 = q.to(torch.int64)
    return q64.sum(dim=-1), (q64 * q64).sum(dim=-1)


def integer_layernorm(
    q: torch.Tensor,
    ln_w_q: torch.Tensor,
    ln_b_q: torch.Tensor,
    out_m0,
    out_shift,
    out_qmax: int = 32767,
) -> torch.Tensor:
    """Paper sec 3.2.6: integer-only LayerNorm (int16 rows -> int16).

    q' = round(1024 * (n*q - Sum q) * rsqrt(V)) with V = n*Sum q^2 -
    (Sum q)^2 exact; output round((q' * L + b) * out_multiplier).
    """
    n = q.shape[-1]
    sum_q, sum_q2 = row_stats(q)
    v = n * sum_q2 - sum_q * sum_q  # >= 0 by Cauchy-Schwarz, < 2**59
    m0, shift = fp.integer_rsqrt_multiplier(v, extra_pow2=10)
    dev = q.to(torch.int64) * n - sum_q[..., None]
    qprime = fp._mbqm64(dev, m0.to(torch.int64)[..., None],
                        shift.to(torch.int64)[..., None])
    qprime = torch.where((v == 0)[..., None], 0, qprime)
    qprime = qprime.clamp(-32768, 32767)
    acc = (qprime * ln_w_q.to(torch.int64) + ln_b_q.to(torch.int64)).clamp(
        fp.INT32_MIN, fp.INT32_MAX)
    out = fp.multiply_by_quantized_multiplier(acc, out_m0, out_shift)
    return out.clamp(-out_qmax - 1, out_qmax).to(torch.int16)
