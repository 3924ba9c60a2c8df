"""Integer-only fixed-point arithmetic (gemmlowp semantics) in PyTorch.

Port of ``repro.core.fixedpoint``: SRDHM, rounding shifts, saturations,
``multiply_by_quantized_multiplier`` (MBQM), the gemmlowp transcendentals
and the integer Newton-Raphson rsqrt used by the integer LayerNorm.

Every function takes integer tensors (or Python ints for static operands)
and returns an int32 tensor bit-identical to the reference.  The
reference computes in int32 and relies on two's-complement wrap, and on
XLA's rule that a shift by 32 or more yields 0 (left) or the sign fill
(arithmetic right).  Here every intermediate is int64, exact by
construction, and ``_wrap32`` reproduces the int32 wrap where the
reference could wrap.  The reference's uint32 limb pairs become plain
int64 (torch has no uint32 ``>>`` on the CPU).
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

INT32_MAX = 2147483647
INT32_MIN = -2147483648
INT16_MAX = 32767
INT16_MIN = -32768

_I64 = torch.int64


def _i64(x, like: torch.Tensor = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(_I64)
    device = like.device if like is not None else None
    return torch.as_tensor(x, dtype=_I64, device=device)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """Two's-complement wrap of an int64 tensor into the int32 range."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _out(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


# ---------------------------------------------------------------------------
# gemmlowp core ops
# ---------------------------------------------------------------------------


def _srdhm64(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    overflow = (a == INT32_MIN) & (b == INT32_MIN)
    neg = (a < 0) ^ (b < 0)
    mag = (a * b).abs()  # |a*b| <= 2**62: exact in int64
    nudge = torch.where(neg, (1 << 30) - 1, 1 << 30)
    mag = (mag + nudge) >> 31
    res = torch.where(neg, -mag, mag)
    return torch.where(overflow, INT32_MAX, res)


def saturating_rounding_doubling_high_mul(a, b) -> torch.Tensor:
    """Bit-exact gemmlowp SRDHM: the rounded Q0.31 product, saturated."""
    a64 = _i64(a, b if isinstance(b, torch.Tensor) else None)
    return _out(_srdhm64(a64, _i64(b, a64)))


def _rdbpot64(x: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """RoundingDivideByPOT on int64-held int32 values, per-element exponent.

    Exponents of 32 or more follow the reference's XLA semantics: the mask
    shift yields 0 (mask -1) and the arithmetic shift yields the sign fill.
    """
    in_range = e < 32
    mask = torch.where(in_range, (1 << e.clamp(0, 31)) - 1, -1)
    remainder = x & mask
    threshold = (mask >> 1) + (x < 0).to(_I64)
    shifted = torch.where(e > 0, x >> e.clamp(0, 63), x)
    inc = (e > 0) & (remainder > threshold)
    return shifted + inc.to(_I64)


def rounding_divide_by_pot(x, exponent) -> torch.Tensor:
    """gemmlowp RoundingDivideByPOT: rounding arithmetic shift right."""
    x64 = _i64(x)
    if isinstance(exponent, int):
        if exponent == 0:
            return _out(x64)
        assert 0 < exponent < 32, exponent
    return _out(_rdbpot64(x64, _i64(exponent, x64)))


def _sat_lshift64(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """x << n with int32 saturation; n >= 32 saturates every nonzero x."""
    big = n >= 32
    shifted = x * (1 << n.clamp(0, 31))  # exact: |x| * 2**31 < 2**63
    sat = torch.where(x >= 0, INT32_MAX, INT32_MIN)
    bad = (shifted > INT32_MAX) | (shifted < INT32_MIN) | (big & (x != 0))
    return torch.where(bad, sat, torch.where(big, 0, shifted))


def saturating_left_shift(x, n) -> torch.Tensor:
    """x << n with int32 saturation (n: static int or int tensor >= 0)."""
    x64 = _i64(x)
    if isinstance(n, int):
        if n == 0:
            return _out(x64)
        assert 0 < n < 32
    return _out(_sat_lshift64(x64, _i64(n, x64)))


def saturating_add_i32(a, b) -> torch.Tensor:
    a64 = _i64(a, b if isinstance(b, torch.Tensor) else None)
    return _out((a64 + _i64(b, a64)).clamp(INT32_MIN, INT32_MAX))


def saturate_i16(x) -> torch.Tensor:
    return _i64(x).clamp(INT16_MIN, INT16_MAX).to(torch.int16)


def saturate_i8(x) -> torch.Tensor:
    return _i64(x).clamp(-128, 127).to(torch.int8)


def _rounding_half_sum64(a, b):
    return (a >> 1) + (b >> 1) + (((a & 1) + (b & 1) + 1) >> 1)


# ---------------------------------------------------------------------------
# Static (python-side) multiplier computation, as TFLite's QuantizeMultiplier.
# ---------------------------------------------------------------------------


def quantize_multiplier(real_multiplier: float) -> Tuple[int, int]:
    """Decompose real == m0/2**31 * 2**shift with m0 in [2**30, 2**31)."""
    if real_multiplier == 0.0:
        return 0, 0
    if real_multiplier < 0:
        raise ValueError("multipliers must be non-negative")
    mant, exp = math.frexp(real_multiplier)  # mant in [0.5, 1)
    m0 = int(round(mant * (1 << 31)))
    if m0 == (1 << 31):
        m0 //= 2
        exp += 1
    if exp > 31:
        raise ValueError(f"multiplier {real_multiplier} too large")
    if exp < -31:
        return 0, 0  # underflows to zero
    return m0, exp


def _mbqm64(x: torch.Tensor, m0: torch.Tensor, shift: torch.Tensor):
    left = shift.clamp(min=0)
    right = (-shift).clamp(min=0)
    return _rdbpot64(_srdhm64(_sat_lshift64(x, left), m0), right)


def multiply_by_quantized_multiplier(x, m0, shift) -> torch.Tensor:
    """TFLite MultiplyByQuantizedMultiplier: rescale int32 by m0/2**31 * 2**shift.

    ``m0``/``shift`` may be Python ints (static) or int tensors (per-channel).
    """
    x64 = _i64(x)
    if isinstance(shift, int):
        assert -32 < shift < 32, shift
    return _out(_mbqm64(x64, _i64(m0, x64), _i64(shift, x64)))


# ---------------------------------------------------------------------------
# Integer transcendentals (gemmlowp fixedpoint.h ports)
# ---------------------------------------------------------------------------

_EXP_CONSTANT_TERM = 1895147668  # exp(-1/8) in Q0.31
_EXP_ONE_THIRD = 715827883  # 1/3 in Q0.31
_EXP_BARREL = (  # (exponent, exp(-2**exponent) in Q0.31)
    (-2, 1672461947),
    (-1, 1302514674),
    (0, 790015084),
    (1, 290630308),
    (2, 39332535),
    (3, 720401),
    (4, 242),
)
_ONE_Q31 = INT32_MAX  # gemmlowp's F0::One()
_K48_OVER_17 = 1515870810  # 48/17 in Q2.29
_K_NEG32_OVER_17 = -1010580540  # -32/17 in Q2.29
_INV_SQRT2_Q31 = 1518500250  # 2**-0.5 in Q0.31
_RSQRT_SEED_A = int(round(1.7880 * (1 << 29)))  # Q2.29
_RSQRT_SEED_B = int(round(0.8047 * (1 << 29)))  # Q2.29


def _c(v: int, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=_I64, device=like.device)


def _exp_quarter64(a: torch.Tensor) -> torch.Tensor:
    """exp(a) for a in (-1/4, 0]; Q0.31 in and out (gemmlowp Taylor)."""
    srdhm = _srdhm64
    x = _wrap32(a + (1 << 28))  # t = a + 1/8
    x2 = srdhm(x, x)
    x3 = srdhm(x2, x)
    x4 = srdhm(x2, x2)
    x4_over_4 = _rdbpot64(x4, _c(2, a))
    tmp = _rdbpot64(
        _wrap32(srdhm(_wrap32(x4_over_4 + x3), _c(_EXP_ONE_THIRD, a)) + x2),
        _c(1, a))
    ct = _c(_EXP_CONSTANT_TERM, a)
    return _wrap32(ct + srdhm(ct, _wrap32(x + tmp)))


def _exp_on_negative_values64(a: torch.Tensor, integer_bits: int):
    assert 0 <= integer_bits <= 29
    frac_bits = 31 - integer_bits
    one_quarter = 1 << (frac_bits - 2)
    a_mod = (a & (one_quarter - 1)) - one_quarter
    result = _exp_quarter64(_wrap32(a_mod * (1 << integer_bits)))
    remainder = _wrap32(a_mod - a)
    for exponent, multiplier in _EXP_BARREL:
        if integer_bits > exponent:
            shift_amount = frac_bits + exponent
            if 0 <= shift_amount < 31:
                result = torch.where(
                    (remainder & (1 << shift_amount)) != 0,
                    _srdhm64(result, _c(multiplier, a)), result)
    if integer_bits > 5:
        result = torch.where(a < -(1 << (frac_bits + 5)), 0, result)
    return torch.where(a == 0, _ONE_Q31, result)


def exp_on_negative_values(a, integer_bits: int) -> torch.Tensor:
    """exp(a) for a <= 0 in Q_{m}.{31-m} (m = integer_bits); result Q0.31."""
    return _out(_exp_on_negative_values64(_i64(a), integer_bits))


def _one_over_one_plus_x64(a: torch.Tensor) -> torch.Tensor:
    half_den = _rounding_half_sum64(a, _c(_ONE_Q31, a))
    x = _wrap32(_K48_OVER_17 + _srdhm64(half_den, _c(_K_NEG32_OVER_17, a)))
    three = _c(2, a)
    for _ in range(3):
        one_minus_hdx = _wrap32((1 << 29) - _srdhm64(half_den, x))
        x = _wrap32(x + _sat_lshift64(_srdhm64(x, one_minus_hdx), three))
    return x >> 1


def _tanh_fp64(a: torch.Tensor, integer_bits: int) -> torch.Tensor:
    neg = a < 0
    abs_a = torch.where(neg, torch.where(a == INT32_MIN, INT32_MAX, -a), a)
    t = _exp_on_negative_values64(-abs_a, integer_bits + 1)
    inv = _one_over_one_plus_x64(t)
    result = _sat_lshift64(_srdhm64(_ONE_Q31 - t, inv), _c(2, a))
    return torch.where(neg, -result, result)


def _sigmoid_fp64(a: torch.Tensor, integer_bits: int) -> torch.Tensor:
    neg = a < 0
    t = _exp_on_negative_values64(torch.where(neg, a, -a), integer_bits)
    sig_neg = _sat_lshift64(_srdhm64(t, _one_over_one_plus_x64(t)), _c(2, a))
    result = torch.where(neg, sig_neg, _ONE_Q31 - sig_neg)
    return torch.where(a == 0, 1 << 30, result)


def tanh_q15(x, input_integer_bits: int = 3) -> torch.Tensor:
    """tanh: int16 Q_{m.15-m} in -> int16 Q0.15 out."""
    x64 = _i64(x) * (1 << 16)
    y = _tanh_fp64(x64, input_integer_bits)
    return saturate_i16(_rdbpot64(y, _c(16, x64)))


def sigmoid_q15(x, input_integer_bits: int = 3) -> torch.Tensor:
    """sigmoid: int16 Q_{m.15-m} in -> int16 Q0.15 out."""
    x64 = _i64(x) * (1 << 16)
    y = _sigmoid_fp64(x64, input_integer_bits)
    return saturate_i16(_rdbpot64(y, _c(16, x64)))


# ---------------------------------------------------------------------------
# Integer reciprocal square root / reciprocal (LayerNorm, RMSNorm, softmax)
# ---------------------------------------------------------------------------


def _rsqrt_normalized64(m: torch.Tensor) -> torch.Tensor:
    y = _wrap32(_RSQRT_SEED_A - _srdhm64(m, _c(_RSQRT_SEED_B, m)))
    three = _c(3, m)
    for _ in range(4):
        my2 = _srdhm64(m, _srdhm64(y, y))
        y = _sat_lshift64(_srdhm64(y, _wrap32((3 << 27) - my2)), three)
    return y


def bit_length(v: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative int64 values (0 for 0), vectorized."""
    n = torch.zeros_like(v)
    cur = v
    for shift in (32, 16, 8, 4, 2, 1):
        hi = cur >> shift
        take = hi != 0
        cur = torch.where(take, hi, cur)
        n = n + take.to(_I64) * shift
    return torch.where(v == 0, 0, n + 1)


def integer_rsqrt_multiplier(v, extra_pow2: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m0, shift) int32 with rsqrt(V)*2**extra_pow2 == m0/2**31 * 2**shift.

    ``v`` holds V >= 0 as int64 (the reference takes it as uint32 limbs
    ``hi, lo``; V = hi * 2**32 + lo).  V == 0 gives the reference's value
    for V == 0 (callers mask that row out).
    """
    v = _i64(v)
    e = bit_length(v)  # V = m * 2**e, m in [0.5, 1)
    # top 32 bits of V << (64 - e): the mantissa's MSB lands on bit 31
    top = torch.where(e >= 32, v >> (e - 32).clamp(min=0),
                      v << (32 - e).clamp(min=0))
    y = _rsqrt_normalized64(top >> 1)  # Q2.29 in (1, sqrt(2)]
    y = torch.where((e & 1) != 0, _srdhm64(y, _c(_INV_SQRT2_Q31, y)), y)
    return _out(y), _out(2 + extra_pow2 - (e >> 1))


def integer_recip_multiplier(x, extra_pow2: int = 0
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m0, shift) int32 with (1/x)*2**extra_pow2 ~= m0/2**31 * 2**shift.

    For int32 x > 0.  The reference reads x as uint32 to count its leading
    zeros and shifts in int32; the port does the same in int64 with the
    int32 wrap, so every input gives the reference's bits.
    """
    x = _i64(x)
    e = bit_length(x & 0xFFFFFFFF)  # x = m * 2**e, m in [0.5, 1)
    m_q31 = _wrap32(x << (31 - e).clamp(min=0))  # MSB to bit 30
    a = _wrap32((m_q31 - (1 << 30)) * 2)  # 2m - 1 in [0, 1), Q0.31
    inv = _one_over_one_plus_x64(a)  # Q2.29 of 1/(2m) in (0.5, 1]
    return _out(inv), _out(3 + extra_pow2 - e)
