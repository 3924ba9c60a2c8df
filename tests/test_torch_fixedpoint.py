"""Parity of the port's fixed-point core with the JAX reference.

Every integer result must be EQUAL (no tolerance): the same inputs, made
with numpy from a seed, go through ``repro.core`` and ``repro_torch.core``.
The reference's activations over every int16 input run as one compiled
program per function for all the formats the tests ask for.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import integer_ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import integer_ops as tops  # noqa: E402

I32_EDGES = np.array([
    -(2**31), 2**31 - 1, 0, 1, -1, 2**30, -(2**30), 2**30 - 1, 12345,
    -12345, 2**16, -(2**16) + 1], np.int64)


def _rand_i32(n, seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(-(2**31), 2**31, size=n, dtype=np.int64)
    small = rng.integers(-(2**16), 2**16, size=n // 4, dtype=np.int64)
    return np.concatenate([I32_EDGES, vals, small]).astype(np.int32)


def _j(x):
    return np.asarray(x).astype(np.int64)


def _t(x):
    return x.numpy().astype(np.int64)


def test_srdhm_matches_reference():
    a = _rand_i32(4000, 0)
    b = np.concatenate([_rand_i32(4000, 1)[: a.size - I32_EDGES.size],
                        I32_EDGES[::-1]])
    # every edge value against every edge value, plus the random pairs
    ea, eb = np.meshgrid(I32_EDGES, I32_EDGES)
    a = np.concatenate([a, ea.ravel().astype(np.int32)])
    b = np.concatenate([b, eb.ravel().astype(np.int32)])
    want = _j(jax.jit(jfp.saturating_rounding_doubling_high_mul)(a, b))
    got = _t(tfp.saturating_rounding_doubling_high_mul(
        torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("exponent", [0, 1, 2, 7, 15, 16, 30, 31])
def test_rounding_divide_by_pot_static(exponent):
    x = _rand_i32(3000, 2 + exponent)
    want = _j(jfp.rounding_divide_by_pot(jnp.asarray(x), exponent))
    got = _t(tfp.rounding_divide_by_pot(torch.from_numpy(x), exponent))
    np.testing.assert_array_equal(got, want)


def test_rounding_divide_by_pot_per_element_and_out_of_range():
    """Per-element exponents 0..31, and 32..40 where the reference follows
    XLA's shift-overflow rule."""
    x = _rand_i32(2000, 3)
    e = np.random.default_rng(4).integers(0, 41, size=x.size).astype(np.int32)
    want = _j(jax.jit(jfp.rounding_divide_by_pot)(x, e))
    got = _t(tfp.rounding_divide_by_pot(torch.from_numpy(x),
                                        torch.from_numpy(e)))
    np.testing.assert_array_equal(got, want)


def test_saturating_left_shift_and_add():
    x = _rand_i32(2000, 5)
    n = np.random.default_rng(6).integers(0, 36, size=x.size).astype(np.int32)
    want = _j(jax.jit(jfp.saturating_left_shift)(x, n))
    got = _t(tfp.saturating_left_shift(torch.from_numpy(x),
                                       torch.from_numpy(n)))
    np.testing.assert_array_equal(got, want)
    y = _rand_i32(2000, 7)[::-1].copy()
    want = _j(jax.jit(jfp.saturating_add_i32)(x, y))
    got = _t(tfp.saturating_add_i32(torch.from_numpy(x), torch.from_numpy(y)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shift", [-31, -17, -1, 0, 1, 5, 31])
def test_mbqm_static(shift):
    x = _rand_i32(3000, 8)
    for m0 in (0, 1 << 30, 1518500250, 2**31 - 1):
        want = _j(jfp.multiply_by_quantized_multiplier(
            jnp.asarray(x), m0, shift))
        got = _t(tfp.multiply_by_quantized_multiplier(
            torch.from_numpy(x), m0, shift))
        np.testing.assert_array_equal(got, want)


def test_mbqm_per_channel():
    x = _rand_i32(3000, 9)
    rng = np.random.default_rng(10)
    m0 = rng.integers(1 << 30, 2**31, size=x.size).astype(np.int32)
    shift = rng.integers(-31, 32, size=x.size).astype(np.int32)
    want = _j(jax.jit(jfp.multiply_by_quantized_multiplier)(x, m0, shift))
    got = _t(tfp.multiply_by_quantized_multiplier(
        torch.from_numpy(x), torch.from_numpy(m0), torch.from_numpy(shift)))
    np.testing.assert_array_equal(got, want)


ALL_I16 = np.arange(-32768, 32768, dtype=np.int16)
TANH_BITS = tuple(range(0, 16))
SIGMOID_BITS = (0, 3, 5, 6)


@functools.lru_cache(maxsize=None)
def _reference_activations(name, bits):
    """The reference's ``name`` (tanh_q15 / sigmoid_q15) on every int16
    input for each ``integer_bits`` in ``bits``: one compiled program for
    all of them.  ``{integer_bits: int64 array}``."""
    fn = getattr(jfp, name)
    outs = jax.jit(lambda x: [fn(x, m) for m in bits])(ALL_I16)
    return {m: _j(out) for m, out in zip(bits, outs)}


@pytest.mark.parametrize("integer_bits", list(TANH_BITS))
def test_tanh_q15_all_inputs(integer_bits):
    """tanh over every int16 input for each cell format Q_{m.15-m} the
    recipe can emit (cell_int_bits), and the gates' Q3.12."""
    want = _reference_activations("tanh_q15", TANH_BITS)[integer_bits]
    got = _t(tfp.tanh_q15(torch.from_numpy(ALL_I16), integer_bits))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("integer_bits", list(SIGMOID_BITS))
def test_sigmoid_q15_all_inputs(integer_bits):
    want = _reference_activations("sigmoid_q15", SIGMOID_BITS)[integer_bits]
    got = _t(tfp.sigmoid_q15(torch.from_numpy(ALL_I16), integer_bits))
    np.testing.assert_array_equal(got, want)


def test_integer_rsqrt_multiplier_edges():
    rng = np.random.default_rng(11)
    v = [0, 1, 2, 3, 4, 5, 2**31 - 1, 2**31, 2**32 - 1, 2**32, 2**32 + 1,
         2**40 + 12345, 2**58 + 3, 2**59 - 1, 2**62, 2**63 - 1]
    v += [1 << k for k in range(63)] + [(1 << k) - 1 for k in range(1, 63)]
    v = np.concatenate([np.array(v, np.uint64),
                        rng.integers(0, 2**59, size=500).astype(np.uint64)])
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    for extra in (0, 10):
        jm0, jsh = jax.jit(jfp.integer_rsqrt_multiplier,
                           static_argnums=2)(hi, lo, extra)
        tm0, tsh = tfp.integer_rsqrt_multiplier(
            torch.from_numpy(v.astype(np.int64)), extra)
        np.testing.assert_array_equal(_t(tm0), _j(jm0))
        np.testing.assert_array_equal(_t(tsh), _j(jsh))


@pytest.mark.parametrize("n,case", [(2048, "random"), (12, "random"),
                                    (16, "degenerate"), (16384, "random"),
                                    (64, "extreme")])
def test_integer_layernorm(n, case):
    rng = np.random.default_rng(n)
    B = 3
    q = rng.integers(-32768, 32768, size=(B, n)).astype(np.int16)
    if case == "degenerate":
        q[0] = 7  # V == 0
        q[1] = 0
    if case == "extreme":
        q[0] = np.where(np.arange(n) % 2, 32767, -32768)
        q[1, :] = -32768
        q[1, 0] = 32767
    lw = rng.integers(-32767, 32768, size=n).astype(np.int16)
    lb = rng.integers(-(2**31) + 1, 2**31, size=n).astype(np.int32)
    lb[:4] = [2**31 - 1, -(2**31) + 1, 0, 5]
    m0, shift = jfp.quantize_multiplier(2.0**-10 * 0.37 / 2.0**-12)
    want = _j(jax.jit(jops.integer_layernorm, static_argnums=(3, 4))(
        q, lw, lb, m0, shift))
    got = _t(tops.integer_layernorm(torch.from_numpy(q), torch.from_numpy(lw),
                                    torch.from_numpy(lb), m0, shift))
    np.testing.assert_array_equal(got, want)
    if case == "random":  # and against the int64 numpy oracle within 1 LSB
        oracle = jref.int_layernorm_np(q, lw, lb, m0, shift).astype(np.int64)
        assert np.abs(got - oracle).max() <= 1


def test_matmul_i8_i32_exact_at_full_depth():
    """The plain product must not wrap (T1): int8 extremes at K = 2048."""
    x = np.full((2, 2048), -128, np.int8)
    w = np.full((2048, 3), -128, np.int8)
    w[:, 1] = 127
    got = tops.matmul_i8_i32(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(
        got.numpy().astype(np.int64),
        x.astype(np.int64) @ w.astype(np.int64))
    with pytest.raises(TypeError):
        tops.matmul_i8_i32(torch.from_numpy(x).to(torch.int16),
                           torch.from_numpy(w))


def test_fold_zero_point():
    rng = np.random.default_rng(12)
    w = rng.integers(-127, 128, size=(40, 24)).astype(np.int8)
    b = rng.integers(-1000, 1000, size=24).astype(np.int32)
    want = _j(jops.fold_zero_point(jnp.asarray(w), -37, jnp.asarray(b)))
    got = _t(tops.fold_zero_point(torch.from_numpy(w), -37,
                                  torch.from_numpy(b)))
    np.testing.assert_array_equal(got, want)
