"""Quantization scale computation (paper sec 3.1), offline and in Python.

Port of the scale helpers of ``repro.core.qtypes``: symmetric scales for
weights, nudged asymmetric (scale, zero point) for activations, and
power-of-two scales giving the cell state's Q_{m.n} format.
"""
from __future__ import annotations

import math
from typing import Tuple


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
