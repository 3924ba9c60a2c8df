"""Integer-only tensor ops: matmul, zero-point folding, LayerNorm, RMSNorm,
softmax.

Port of ``repro.core.integer_ops``.  These are the plain PyTorch versions:
the CPU path, and the oracle each CUDA kernel is held against on the card.
LayerNorm statistics are exact int64 sums (the reference carries them as
uint32 limb pairs; the value is the same).
"""
from __future__ import annotations

import math
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


def integer_rmsnorm(q: torch.Tensor, w_q: torch.Tensor, out_m0, out_shift,
                    eps_guard: bool = True) -> torch.Tensor:
    """RMSNorm generalization of the paper's integer LayerNorm (beyond-paper).

    q / rms(q) = q * sqrt(n) * rsqrt(Sum q^2); sqrt(n) and the s' = 2**-10
    factor fold into the rsqrt multiplier, and 2**-10 * s_w / s_out into
    (out_m0, out_shift).  ``eps_guard`` maps an all-zero row to 0.
    """
    n = q.shape[-1]
    _, sum_q2 = row_stats(q)
    m0, shift = fp.integer_rsqrt_multiplier(sum_q2, extra_pow2=10)
    sn_m0, sn_shift = fp.quantize_multiplier(math.sqrt(n))
    m0 = fp.saturating_rounding_doubling_high_mul(m0, sn_m0)
    shift = shift.to(torch.int64) + sn_shift
    qprime = fp._mbqm64(q.to(torch.int64), m0.to(torch.int64)[..., None],
                        shift[..., None])
    if eps_guard:
        qprime = torch.where((sum_q2 == 0)[..., None], 0, qprime)
    qprime = qprime.clamp(-32768, 32767)
    acc = qprime * w_q.to(torch.int64)
    out = fp.multiply_by_quantized_multiplier(acc, out_m0, out_shift)
    return out.clamp(-32768, 32767).to(torch.int16)


def integer_softmax(logits_q: torch.Tensor, in_m0: int, in_shift: int,
                    axis: int = -1, mask: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """int16/int32 logits -> int16 Q0.15 probabilities (beyond-paper).

    TFLite-style 16-bit softmax from the paper's building blocks: integer
    max-subtraction, barrel-shifted exp to Q0.31, and the integer Newton
    reciprocal of the sum.  (in_m0, in_shift) rescales the logits' scale
    to Q5.26 for ``exp_on_negative_values``.
    """
    if axis != -1:
        raise ValueError("integer_softmax reduces over the last axis")
    x = logits_q.to(torch.int64)
    if mask is not None:
        x = torch.where(mask, x, fp.INT32_MIN // 2)
    diff = fp._wrap32(x - x.amax(dim=-1, keepdim=True))  # <= 0 unless wrapped
    scaled = fp._mbqm64(diff, fp._i64(in_m0, diff), fp._i64(in_shift, diff))
    scaled = scaled.clamp(min=-(1 << 31) + 1)
    e = fp._exp_on_negative_values64(scaled, 5)  # Q0.31
    if mask is not None:
        e = torch.where(mask, e, 0)
    n = logits_q.shape[-1]
    k = max(int(math.ceil(math.log2(max(n, 2)))), 1)
    e_s = e >> k
    denom = fp._wrap32(e_s.sum(dim=-1)).clamp(min=1)
    rm0, rshift = fp.integer_recip_multiplier(denom, extra_pow2=15)
    p = fp._mbqm64(e_s, rm0.to(torch.int64)[..., None],
                   rshift.to(torch.int64)[..., None])
    return p.clamp(0, 32767).to(torch.int16)
