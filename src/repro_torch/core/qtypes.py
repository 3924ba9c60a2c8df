"""Quantization dtypes, specs and quantize/dequantize transforms (sec 3.1).

Port of ``repro.core.qtypes``: linear affine quantization with nudged zero
points, symmetric (weights) vs asymmetric (activations) ranges, and
power-of-two scales giving the cell state's Q_{m.n} format.  A ``QTensor``
is an integer tensor plus its static ``QuantSpec``.

The scale helpers run offline in Python floats.  ``quantize`` multiplies
by the float32 reciprocal of the scale, as the reference does, so values
on x/s = k + 0.5 round as there (ROADMAP F1); ``quantize_bias_i32``
divides in float64, as the reference does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from . import fixedpoint as fp

_DTYPES = {8: torch.int8, 16: torch.int16, 32: torch.int32}


@dataclasses.dataclass(frozen=True)
class QuantSpec:
    """Static description of a quantized tensor's arithmetic type."""

    bits: int  # 8, 16 or 32
    scale: float  # real value = scale * (q - zero_point)
    zero_point: int = 0
    symmetric: bool = True
    pot: bool = False  # scale is a power of two (Q_{m.n} interpretable)

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.bits]

    @property
    def qmin(self) -> int:
        return -(2 ** (self.bits - 1))

    @property
    def qmax(self) -> int:
        # symmetric quantization restricts to +/-(2^(n-1)-1) (paper: +/-127)
        return 2 ** (self.bits - 1) - 1

    @property
    def q_format(self) -> Tuple[int, int]:
        """(m, n) of Q_{m.n} for POT scales: scale == 2**-n, m = bits-1-n."""
        if not self.pot:
            raise ValueError("Q_{m.n} format only defined for POT scales")
        n = -int(round(math.log2(self.scale)))
        return self.bits - 1 - n, n


class QTensor:
    """Quantized tensor: integer ``values`` plus a static ``QuantSpec``."""

    __slots__ = ("values", "spec")

    def __init__(self, values: torch.Tensor, spec: QuantSpec):
        self.values = values
        self.spec = spec

    @property
    def shape(self) -> torch.Size:
        return self.values.shape

    def dequantize(self, dtype=torch.float32) -> torch.Tensor:
        v = self.values.to(dtype)
        if self.spec.zero_point:
            v = v - self.spec.zero_point
        return v * torch.tensor(self.spec.scale, dtype=dtype,
                                device=v.device)

    def __repr__(self):
        return f"QTensor(shape={tuple(self.values.shape)}, spec={self.spec})"


def symmetric_scale(max_abs: float, bits: int) -> float:
    """Paper: s = max(|T|) / (2**(bits-1) - 1); e.g. max/127, max/32767."""
    qmax = 2 ** (bits - 1) - 1
    max_abs = float(max_abs)
    if max_abs == 0.0:
        max_abs = 1e-8
    return max_abs / qmax


def asymmetric_scale_zp(t_min: float, t_max: float, bits: int
                        ) -> Tuple[float, int]:
    """Paper: s = range / (2**bits - 1) with nudged zero point [Jacob et al.].

    Guarantees float 0.0 maps exactly to an integer zero point.
    """
    t_min = min(float(t_min), 0.0)
    t_max = max(float(t_max), 0.0)
    if t_max == t_min:
        t_max = t_min + 1e-8
    qmin, qmax = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1
    scale = (t_max - t_min) / (qmax - qmin)
    zero_point = int(round(qmin - t_min / scale))
    return scale, max(qmin, min(qmax, zero_point))


def pot_scale_for(max_abs: float, bits: int = 16) -> float:
    """Extend |max| to the next power of two (paper sec 3.2.2, 'POT(max)').

    Returns scale = POT(max) / 2**(bits-1), a power of two, giving Q_{m.n}.
    """
    max_abs = float(max_abs)
    if max_abs <= 0:
        max_abs = 1.0
    pot = max(2.0 ** math.ceil(math.log2(max_abs)), 2.0 ** -20)
    return pot / (2 ** (bits - 1))


# ---------------------------------------------------------------------------
# Quantize (PTQ converters and tests)
# ---------------------------------------------------------------------------


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def quantize(x, spec: QuantSpec) -> QTensor:
    """round(x * f32(1/scale)) + zero_point, clipped to the spec's range
    (``-qmax`` below for symmetric specs), as the spec's integer dtype."""
    x = _tensor(x).to(torch.float32)
    inv = torch.tensor(1.0 / spec.scale, dtype=torch.float32,
                       device=x.device)
    q = torch.round(x * inv) + spec.zero_point
    lo = float(spec.qmin if not spec.symmetric else -spec.qmax)
    q = q.clamp(lo, float(spec.qmax))
    return QTensor(q.to(spec.dtype), spec)


def quantize_symmetric(x, bits: int, pot: bool = False) -> QTensor:
    x = _tensor(x)
    max_abs = float(x.abs().max()) if x.numel() else 0.0
    scale = pot_scale_for(max_abs, bits) if pot else symmetric_scale(
        max_abs, bits)
    return quantize(x, QuantSpec(bits=bits, scale=scale, zero_point=0,
                                 symmetric=True, pot=pot))


def quantize_asymmetric(x, bits: int) -> QTensor:
    x = _tensor(x)
    t_min = float(x.min()) if x.numel() else 0.0
    t_max = float(x.max()) if x.numel() else 0.0
    scale, zp = asymmetric_scale_zp(t_min, t_max, bits)
    return quantize(x, QuantSpec(bits=bits, scale=scale, zero_point=zp,
                                 symmetric=False))


def quantize_bias_i32(b, scale: float) -> QTensor:
    """Bias quantized to int32 at a derived scale (paper sec 3.2.4)."""
    spec = QuantSpec(bits=32, scale=scale, zero_point=0, symmetric=True)
    q = torch.round(_tensor(b).to(torch.float64) / scale).clamp(
        -(2**31 - 1), 2**31 - 1)
    return QTensor(q.to(torch.int32), spec)


def requantize_multiplier(s_in: float, s_out: float) -> Tuple[int, int]:
    """Effective rescale s_eff = s_in / s_out as (m0, shift) ints."""
    return fp.quantize_multiplier(s_in / s_out)
