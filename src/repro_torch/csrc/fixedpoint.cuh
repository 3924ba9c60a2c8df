// gemmlowp fixed-point arithmetic as device functions (port of
// repro/core/fixedpoint.py and the LayerNorm statistics of
// repro/core/integer_ops.py).  Shared by the two CUDA kernels of this
// package; the functions are also valid host C++ so the arithmetic can be
// compiled and checked without a GPU.
//
// The reference computes in int32 with two's-complement wrap and XLA shift
// rules (a shift by 32 or more gives 0 to the left and the sign fill to the
// right).  C++ leaves signed overflow and over-wide shifts undefined, so
// every intermediate here is int64_t and `wrap32` reproduces the int32 wrap
// where the reference could wrap.  Shift counts are clamped exactly as the
// reference's semantics dictate.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define FP_HD __host__ __device__ __forceinline__
#else
#define FP_HD inline
#endif

namespace fp {

constexpr int32_t kInt32Max = 2147483647;
constexpr int32_t kInt32Min = -2147483647 - 1;
constexpr int32_t kOneQ31 = kInt32Max;

FP_HD int32_t wrap32(int64_t v) {
  return (int32_t)(uint32_t)(uint64_t)v;
}

FP_HD int32_t clamp32(int64_t v) {
  return (int32_t)(v > kInt32Max ? (int64_t)kInt32Max
                                 : (v < kInt32Min ? (int64_t)kInt32Min : v));
}

FP_HD int16_t sat16(int64_t v) {
  return (int16_t)(v > 32767 ? 32767 : (v < -32768 ? -32768 : v));
}

FP_HD int8_t sat8(int64_t v) {
  return (int8_t)(v > 127 ? 127 : (v < -128 ? -128 : v));
}

// SaturatingRoundingDoublingHighMul.
FP_HD int32_t srdhm(int32_t a, int32_t b) {
  if (a == kInt32Min && b == kInt32Min) return kInt32Max;
  const bool neg = (a < 0) != (b < 0);
  int64_t ab = (int64_t)a * (int64_t)b;
  uint64_t mag = (uint64_t)(ab < 0 ? -ab : ab);  // <= 2**62
  mag = (mag + (neg ? (1u << 30) - 1u : (1u << 30))) >> 31;
  return neg ? (int32_t)(-(int64_t)mag) : (int32_t)mag;
}

// RoundingDivideByPOT; e >= 32 follows the reference's XLA shift rule.
FP_HD int32_t rdbpot(int32_t x, int e) {
  if (e <= 0) return x;
  if (e >= 32) return x >= 0 ? 1 : -1;
  const int32_t mask = (int32_t)((1u << e) - 1u);
  const int32_t remainder = x & mask;
  const int32_t threshold = (mask >> 1) + (x < 0 ? 1 : 0);
  return (x >> e) + (remainder > threshold ? 1 : 0);
}

// x << n with int32 saturation (n >= 0).
FP_HD int32_t sat_lshift(int32_t x, int n) {
  if (n <= 0) return x;
  if (n >= 32) return x == 0 ? 0 : (x > 0 ? kInt32Max : kInt32Min);
  return clamp32((int64_t)x * ((int64_t)1 << n));
}

FP_HD int32_t sat_add(int32_t a, int32_t b) {
  return clamp32((int64_t)a + (int64_t)b);
}

// MultiplyByQuantizedMultiplier.
FP_HD int32_t mbqm(int32_t x, int32_t m0, int32_t shift) {
  const int left = shift > 0 ? shift : 0;
  const int right = shift < 0 ? -shift : 0;
  return rdbpot(srdhm(sat_lshift(x, left), m0), right);
}

FP_HD int32_t rounding_half_sum(int32_t a, int32_t b) {
  return (a >> 1) + (b >> 1) + (((a & 1) + (b & 1) + 1) >> 1);
}

// exp(a) for a in (-1/4, 0], Q0.31 in and out (gemmlowp Taylor).
FP_HD int32_t exp_quarter(int32_t a) {
  const int32_t x = wrap32((int64_t)a + (1 << 28));
  const int32_t x2 = srdhm(x, x);
  const int32_t x3 = srdhm(x2, x);
  const int32_t x4 = srdhm(x2, x2);
  const int32_t x4_over_4 = rdbpot(x4, 2);
  const int32_t tmp = rdbpot(
      wrap32((int64_t)srdhm(wrap32((int64_t)x4_over_4 + x3), 715827883) + x2),
      1);
  const int32_t ct = 1895147668;  // exp(-1/8) in Q0.31
  return wrap32((int64_t)ct + srdhm(ct, wrap32((int64_t)x + tmp)));
}

// exp(a) for a <= 0 in Q_{m}.{31-m}, m = integer_bits in [0, 29]; Q0.31 out.
FP_HD int32_t exp_on_negative_values(int32_t a, int integer_bits) {
  const int frac_bits = 31 - integer_bits;
  const int32_t one_quarter = (int32_t)1 << (frac_bits - 2);
  const int32_t a_mod = (a & (one_quarter - 1)) - one_quarter;
  int32_t result = exp_quarter(wrap32((int64_t)a_mod * ((int64_t)1 << integer_bits)));
  const int32_t remainder = wrap32((int64_t)a_mod - a);
  const int32_t barrel[7] = {1672461947, 1302514674, 790015084, 290630308,
                             39332535, 720401, 242};
  for (int k = 0; k < 7; ++k) {
    const int exponent = k - 2;
    if (integer_bits > exponent) {
      const int shift_amount = frac_bits + exponent;
      if (shift_amount >= 0 && shift_amount < 31 &&
          (remainder & ((int32_t)1 << shift_amount)) != 0) {
        result = srdhm(result, barrel[k]);
      }
    }
  }
  if (integer_bits > 5) {
    const int64_t clamp_bound = -((int64_t)1 << (frac_bits + 5));
    if ((int64_t)a < clamp_bound) result = 0;
  }
  return a == 0 ? kOneQ31 : result;
}

// 1/(1+a) for a in [0, 1] as Q0.31; result Q2.29 (3 Newton steps).
FP_HD int32_t one_over_one_plus_x(int32_t a) {
  const int32_t half_den = rounding_half_sum(a, kOneQ31);
  int32_t x = wrap32((int64_t)1515870810 + srdhm(half_den, -1010580540));
  for (int i = 0; i < 3; ++i) {
    const int32_t one_minus_hdx = wrap32((int64_t)(1 << 29) - srdhm(half_den, x));
    x = wrap32((int64_t)x + sat_lshift(srdhm(x, one_minus_hdx), 2));
  }
  return x >> 1;
}

FP_HD int32_t tanh_fp(int32_t a, int integer_bits) {
  const bool neg = a < 0;
  const int32_t abs_a = neg ? (a == kInt32Min ? kInt32Max : -a) : a;
  const int32_t t = exp_on_negative_values(-abs_a, integer_bits + 1);
  const int32_t inv = one_over_one_plus_x(t);
  const int32_t result = sat_lshift(srdhm(kOneQ31 - t, inv), 2);
  return neg ? -result : result;
}

FP_HD int32_t sigmoid_fp(int32_t a, int integer_bits) {
  const bool neg = a < 0;
  const int32_t t = exp_on_negative_values(neg ? a : -a, integer_bits);
  const int32_t sig_neg = sat_lshift(srdhm(t, one_over_one_plus_x(t)), 2);
  const int32_t result = neg ? sig_neg : kOneQ31 - sig_neg;
  return a == 0 ? (1 << 30) : result;
}

// int16 Q_{m.15-m} in -> int16 Q0.15 out.
FP_HD int16_t tanh_q15(int32_t x16, int integer_bits) {
  return sat16(rdbpot(tanh_fp((int32_t)((uint32_t)x16 << 16), integer_bits), 16));
}

FP_HD int16_t sigmoid_q15(int32_t x16, int integer_bits) {
  return sat16(rdbpot(sigmoid_fp((int32_t)((uint32_t)x16 << 16), integer_bits), 16));
}

FP_HD int32_t rsqrt_normalized(int32_t m) {
  int32_t y = wrap32((int64_t)959925191 - srdhm(m, 432020023));  // Q2.29 seed
  for (int i = 0; i < 4; ++i) {
    const int32_t my2 = srdhm(m, srdhm(y, y));
    y = sat_lshift(srdhm(y, wrap32((int64_t)(3 << 27) - my2)), 3);
  }
  return y;
}

FP_HD int bit_length64(uint64_t v) {
#ifdef __CUDA_ARCH__
  return 64 - __clzll(static_cast<long long>(v));
#else
  int n = 0;
  while (v) {
    ++n;
    v >>= 1;
  }
  return n;
#endif
}

// (m0, shift) with rsqrt(V) * 2**extra_pow2 == m0 / 2**31 * 2**shift.
FP_HD void rsqrt_multiplier(uint64_t v, int extra_pow2, int32_t* m0,
                            int32_t* shift) {
  const int e = bit_length64(v);
  const uint64_t top = e >= 32 ? (v >> (e - 32)) : (v << (32 - e));
  int32_t y = rsqrt_normalized((int32_t)(top >> 1));
  if (e & 1) y = srdhm(y, 1518500250);  // 2**-0.5 in Q0.31
  *m0 = y;
  *shift = 2 + extra_pow2 - (e >> 1);
}

// Integer LayerNorm of one element given its row's exact statistics:
// q' = mbqm(n*q - Sum q, 1024 rsqrt V) (0 when V == 0), then
// int16(mbqm(q' * L sat+ b, out)).  (m0, shift) come from rsqrt_multiplier.
FP_HD int16_t layernorm_apply(int32_t q, int n, int32_t sum_q, bool degenerate,
                              int32_t m0, int32_t shift, int16_t lw, int32_t lb,
                              int32_t out_m0, int32_t out_shift) {
  int32_t qprime = degenerate ? 0 : mbqm(q * n - sum_q, m0, shift);
  qprime = qprime > 32767 ? 32767 : (qprime < -32768 ? -32768 : qprime);
  const int32_t acc = sat_add(qprime * (int32_t)lw, lb);
  return sat16(mbqm(acc, out_m0, out_shift));
}

}  // namespace fp
