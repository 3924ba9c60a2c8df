"""Quantization-aware training: straight-through fake quantization (sec 4).

Port of ``repro.core.fake_quant``.  The paper's QAT graph keeps the input
and recurrent matmuls un-concatenated so each carries its own fake-quant
scale; the float LSTM keeps W and R separate by construction, so QAT wraps
tensors in these functions at the recipe's tap points.  The straight-
through estimator ``x + (xq - x).detach()`` passes the identity gradient,
as ``jax.lax.stop_gradient`` does in the reference.

Parity (ROADMAP F9).  Each function equals the reference run eagerly bit
for bit: the same float32 operations in the same order.  Under
``jax.jit`` XLA rewrites the reference's arithmetic, and the jitted
results differ from the eager ones by up to an ulp of the quantized range
(t_max - t_min, or 2 max|x|), and by one quantization step where x/scale
lies exactly on a half-integer; the port holds to the jitted form by that
rule.  One deliberate difference: the POT ceiling ``2**ceil(log2(max_abs))``
takes the exact exponent (``frexp``), where the reference divides XLA's
float32 ``log`` by ``log(2)`` and can land on the wrong side of an integer
when ``max_abs`` is within a few ulps of a power of two.  Elsewhere the
two agree.

On the card each division takes a tensor divisor: PyTorch's CUDA division
by a Python number multiplies by its reciprocal instead, which can move a
scale by an ulp, so the card computes the CPU's bits only this way.
"""
from __future__ import annotations

from typing import Optional

import torch


def _ste(x: torch.Tensor, xq: torch.Tensor) -> torch.Tensor:
    """Straight-through estimator: forward xq, backward identity."""
    return x + (xq - x).detach()


def _pot_ceil(m: torch.Tensor) -> torch.Tensor:
    """2**ceil(log2(m)) for m > 0, exactly."""
    mant, e = torch.frexp(m)  # m = mant * 2**e, mant in [0.5, 1)
    return torch.where(mant == 0.5, m, torch.ldexp(torch.ones_like(m), e))


def fake_quant_symmetric(x: torch.Tensor, bits: int = 8,
                         per_channel_axis: Optional[int] = None,
                         pot: bool = False) -> torch.Tensor:
    """Symmetric fake quant with a dynamically observed max-abs (QAT)."""
    qmax = float(2 ** (bits - 1) - 1)
    if per_channel_axis is None:
        max_abs = x.abs().max()
    else:
        axes = tuple(i for i in range(x.ndim)
                     if i != per_channel_axis % x.ndim)
        max_abs = x.abs().amax(dim=axes, keepdim=True)
    max_abs = max_abs.clamp(min=1e-8)
    if pot:
        scale = _pot_ceil(max_abs) / (qmax + 1.0)
    else:
        scale = max_abs / max_abs.new_tensor(qmax)
    q = torch.round(x / scale).clamp(-qmax, qmax)
    return _ste(x, q * scale)


def fake_quant_asymmetric(x: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Asymmetric fake quant with a nudged zero point (paper sec 3.2.4)."""
    qmin = float(-(2 ** (bits - 1)))
    qmax = float(2 ** (bits - 1) - 1)
    t_min = x.min().clamp(max=0.0)
    t_max = x.max().clamp(min=0.0)
    scale = ((t_max - t_min) / t_max.new_tensor(qmax - qmin)).clamp(min=1e-8)
    zp = torch.round(qmin - t_min / scale).clamp(qmin, qmax)  # nudged
    q = (torch.round(x / scale) + zp).clamp(qmin, qmax)
    return _ste(x, (q - zp) * scale)


def fake_quant_q(x: torch.Tensor, fractional_bits: int,
                 bits: int = 16) -> torch.Tensor:
    """Fake quant onto a fixed Q_{m.n} grid (e.g. Q3.12 gate inputs)."""
    scale = 2.0 ** (-fractional_bits)
    qmax = float(2 ** (bits - 1) - 1)
    q = torch.round(x / scale).clamp(-qmax - 1, qmax)
    return _ste(x, q * scale)
