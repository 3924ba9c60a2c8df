"""The port's integer RMSNorm, integer softmax and integer reciprocal
multiplier against the JAX reference, bit for bit.

These are the integer ops no model calls yet (ROADMAP Queue 1 item 8).
Every case goes through the reference jitted (integer arithmetic is the
same eagerly) and through the port's plain PyTorch version; outputs must
be equal.  Cases: random rows, the int16 extremes, all-zero rows (with and
without ``eps_guard``), rows of length 1, masked softmax rows (fully
masked ones too), int32 logits far apart, and the reciprocal on every
shape of int32 input, negatives and 0 included.
"""
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.core import integer_ops as jops  # noqa: E402
from repro_torch.core import fixedpoint as tfp  # noqa: E402
from repro_torch.core import integer_ops as tops  # noqa: E402
from test_torch_recurrent import run_compiled  # noqa: E402

torch.set_num_threads(1)


def _eq(got, want):
    want = np.asarray(want)
    assert got.dtype == {np.dtype("int16"): torch.int16,
                         np.dtype("int32"): torch.int32}[want.dtype]
    np.testing.assert_array_equal(got.numpy(), want)


def _rows(n, seed, rows=12):
    """int16 rows: random at three magnitudes, both extremes, alternating
    extremes, constant, all zero, and one nonzero entry."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(-32768, 32768, size=(3, n)),
           rng.integers(-300, 300, size=(3, n)),
           rng.integers(-3, 4, size=(2, n)),
           np.full((1, n), 32767), np.full((1, n), -32768),
           np.where(np.arange(n) % 2, 32767, -32768)[None],
           np.full((1, n), 5), np.zeros((1, n)),
           np.eye(1, n, n // 2) * -7]
    return np.concatenate(out)[:rows].astype(np.int16)


def test_integer_recip_multiplier():
    rng = np.random.default_rng(0)
    p = 2 ** np.arange(31, dtype=np.int64)
    x = np.concatenate([
        np.arange(1, 300), p, p - 1, p + 1, (p * 3) // 2,
        rng.integers(1, 2**31, size=4000), [2**31 - 1, 0, -1, -7,
                                            -(2**31), -(2**30) - 3],
    ]).clip(-(2**31), 2**31 - 1).astype(np.int32)
    fn = jax.jit(jfp.integer_recip_multiplier, static_argnums=1)
    for extra in (0, 15, 29):
        jm, js = fn(jnp.asarray(x), extra)
        tm, ts = tfp.integer_recip_multiplier(torch.from_numpy(x), extra)
        _eq(tm, jm)
        _eq(ts, js)


def _in_multiplier(scale):
    """(m0, shift) taking logits of ``scale`` to Q5.26."""
    return jfp.quantize_multiplier(scale * 2.0**26)


@pytest.mark.parametrize("n", [1, 7, 2048, 16384])
def test_integer_rmsnorm(n):
    q = _rows(n, seed=n)
    rng = np.random.default_rng(n + 1)
    w = rng.integers(-32768, 32768, size=n).astype(np.int16)
    w[:2] = [32767, -32768][:min(n, 2)]
    per_ch = (rng.integers(2**30, 2**31, size=n).astype(np.int32),
              rng.integers(-20, 3, size=n).astype(np.int32))
    cases = [(m0, shift, guard) for guard in (True, False)
             for m0, shift in ((1518500250, -9), per_ch)]

    def job(m0, shift, guard):
        if isinstance(m0, int):  # static multiplier, as a model passes it
            return (jax.jit(functools.partial(
                jops.integer_rmsnorm, out_m0=m0, out_shift=shift,
                eps_guard=guard)), (q, w))
        return (jax.jit(functools.partial(jops.integer_rmsnorm,
                                          eps_guard=guard)),
                (q, w, m0, shift))

    wants = run_compiled([job(*case) for case in cases])
    for (m0, shift, guard), want in zip(cases, wants):
        if not isinstance(m0, int):
            m0, shift = torch.from_numpy(m0), torch.from_numpy(shift)
        _eq(tops.integer_rmsnorm(torch.from_numpy(q), torch.from_numpy(w),
                                 m0, shift, eps_guard=guard), want)


@pytest.mark.parametrize("n", [1, 1000])
def test_integer_softmax(n):
    """int16 rows (the extremes, zero and constant rows) and int32 rows
    far apart, unmasked and masked (one row fully masked), at three input
    scales."""
    rng = np.random.default_rng(n)
    x = np.concatenate([
        _rows(n, seed=n + 7).astype(np.int32),
        rng.integers(-(2**31), 2**31, size=(3, n)),
        np.full((1, n), 2**31 - 1), np.full((1, n), -(2**31)),
        rng.integers(-1000, 1000, size=(3, n))]).astype(np.int32)
    mask = rng.random(x.shape) < 0.6
    mask[0] = False
    mask[1] = True
    cases = [(_in_multiplier(scale), mk) for scale in (1 / 256, 2.0**-20, 0.5)
             for mk in (None, mask)]

    def softmax(m0, s):  # the multiplier static, as a model passes it
        return jax.jit(lambda x, mk=None: jops.integer_softmax(x, m0, s,
                                                               mask=mk))

    wants = run_compiled([(softmax(m0, s), (x,) if mk is None else (x, mk))
                          for (m0, s), mk in cases])
    for ((m0, s), mk), want in zip(cases, wants):
        _eq(tops.integer_softmax(
            torch.from_numpy(x), m0, s,
            mask=None if mk is None else torch.from_numpy(mk)), want)
    x16 = x[:12].astype(np.int16)  # an int16 input takes the same path
    _eq(tops.integer_softmax(torch.from_numpy(x16), *cases[0][0]),
        wants[0][:12])


def test_integer_softmax_rows_sum_to_one():
    """A sanity check beside the parity: Q0.15 rows sum to ~2**15."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(-4000, 4000, size=(16, 50)).astype(
        np.int16))
    m0, shift = _in_multiplier(1 / 256)
    p = tops.integer_softmax(x, m0, shift).to(torch.float64) / 2**15
    ref = torch.softmax(x.to(torch.float64) / 256, dim=-1)
    assert float((p - ref).abs().max()) < 2e-3
    assert float((p.sum(-1) - 1).abs().max()) < 50 * 2**-15
    assert math.isclose(float(p.sum()), 16, rel_tol=1e-2)
