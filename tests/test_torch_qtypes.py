"""The port's ``core.qtypes`` against the JAX reference, value for value.

``quantize`` multiplies by the float32 reciprocal of the scale, as the
reference does (ROADMAP F1), so inputs on x/s = k + 0.5 and their float32
neighbours round as there.  ``quantize_asymmetric`` equals the reference
also where float32 rounding breaks the reference's own scale/2 bound (8-bit
``[32.0, 64.0]``, where x/s lands on 127.5).  ``quantize_bias_i32``
divides in float64 on both sides.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import qtypes as JQ  # noqa: E402
from repro_torch.core import qtypes as TQ  # noqa: E402

torch.set_num_threads(1)

SPECS = [dict(bits=8, scale=0.0123, zero_point=-7, symmetric=False),
         dict(bits=8, scale=0.1, zero_point=0, symmetric=True),
         dict(bits=16, scale=2.0 ** -12, zero_point=0, symmetric=True,
              pot=True),
         dict(bits=16, scale=3.0517578125e-05, zero_point=12,
              symmetric=False),
         dict(bits=32, scale=1e-4, zero_point=0, symmetric=True)]


def _boundary_values(scale, seed, n=4000):
    """k + 0.5 grid points, their float32 neighbours, the grid itself and
    random values over the whole range (and past it)."""
    k = np.arange(-300, 300, dtype=np.float32)
    half = ((k + 0.5) * np.float32(scale)).astype(np.float32)
    rng = np.random.default_rng(seed)
    return np.concatenate([
        half, np.nextafter(half, np.float32(0)),
        np.nextafter(half, np.float32(np.inf)), k * np.float32(scale),
        rng.normal(0, 200 * scale, size=n)]).astype(np.float32)


def _check(tq, jq):
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert tq.values.dtype == {np.dtype("int8"): torch.int8,
                               np.dtype("int16"): torch.int16,
                               np.dtype("int32"): torch.int32}[
                                   np.asarray(jq.values).dtype]
    assert dict(vars(tq.spec)) == dict(vars(jq.spec))
    np.testing.assert_array_equal(tq.dequantize().numpy(),
                                  np.asarray(jq.dequantize()))


@pytest.mark.parametrize("i", range(len(SPECS)))
def test_quantize_on_rounding_boundaries(i):
    kw = SPECS[i]
    x = _boundary_values(kw["scale"], seed=i)
    _check(TQ.quantize(torch.from_numpy(x), TQ.QuantSpec(**kw)),
           JQ.quantize(x, JQ.QuantSpec(**kw)))


def test_quant_spec_properties():
    for kw in SPECS:
        t, j = TQ.QuantSpec(**kw), JQ.QuantSpec(**kw)
        assert (t.qmin, t.qmax) == (j.qmin, j.qmax)
        assert t.dtype == {8: torch.int8, 16: torch.int16,
                           32: torch.int32}[kw["bits"]]
        assert np.dtype(j.dtype).itemsize * 8 == kw["bits"]
        if kw.get("pot"):
            assert t.q_format == j.q_format == (3, 12)
        else:
            with pytest.raises(ValueError):
                t.q_format
    q = TQ.QTensor(torch.arange(-3, 4, dtype=torch.int8),
                   TQ.QuantSpec(8, 0.5, zero_point=2, symmetric=False))
    assert q.shape == (7,)
    np.testing.assert_array_equal(q.dequantize().numpy(),
                                  np.arange(-5, 2, dtype=np.float32) * 0.5)
    assert q.dequantize(torch.float64).dtype == torch.float64


@pytest.mark.parametrize("bits,pot", [(8, False), (16, False), (16, True),
                                      (8, True)])
def test_quantize_symmetric(bits, pot):
    rng = np.random.default_rng(bits + pot)
    for x in (rng.normal(0, 3, size=(64, 48)).astype(np.float32),
              rng.normal(0, 1e-3, size=(500,)).astype(np.float32),
              rng.normal(0, 1, size=(300,)),  # float64 input
              np.zeros(10, np.float32), np.zeros(0, np.float32)):
        _check(TQ.quantize_symmetric(x, bits, pot=pot),
               JQ.quantize_symmetric(x, bits, pot=pot))


@pytest.mark.parametrize("bits", [8, 16])
def test_quantize_asymmetric(bits):
    rng = np.random.default_rng(bits)
    cases = [rng.normal(0.5, 3, size=(64, 48)).astype(np.float32),
             rng.uniform(1.0, 5.0, size=400).astype(np.float32),  # > 0
             -rng.uniform(1.0, 5.0, size=400).astype(np.float32),  # < 0
             np.array([32.0, 64.0], np.float32),  # x/s lands on 127.5
             np.array([4.0, -36.0], np.float32),
             np.full(7, 2.5, np.float32), np.zeros(0, np.float32)]
    for x in cases:
        tq = TQ.quantize_asymmetric(torch.from_numpy(x), bits)
        _check(tq, JQ.quantize_asymmetric(x, bits))


def test_quantize_asymmetric_keeps_the_reference_rounding():
    """At 8-bit [32, 64] x = 32 lands on x/s = 127.5, which rounds to 128:
    it dequantizes to 32.12549, 0.1254921 off, just over scale/2 =
    0.1254902.  The port gives the same value rather than a tighter one."""
    x = np.array([32.0, 64.0], np.float32)
    tq = TQ.quantize_asymmetric(torch.from_numpy(x), 8)
    err = float(tq.dequantize()[0]) - 32.0
    assert err == pytest.approx(0.1254921, abs=1e-6)
    assert err > tq.spec.scale / 2


def test_quantize_bias_i32_and_requantize_multiplier():
    rng = np.random.default_rng(3)
    for scale in (1e-4, 3.0517578125e-05 * 0.0123, 2.0 ** -20):
        b = np.concatenate([rng.normal(0, 1, size=500),
                            (np.arange(-20, 20) + 0.5) * scale,
                            [1e9, -1e9]]).astype(np.float32)
        _check(TQ.quantize_bias_i32(torch.from_numpy(b), scale),
               JQ.quantize_bias_i32(b, scale))
    for s_in, s_out in ((0.0123 * 0.004, 2.0 ** -12), (1.0, 3.0),
                        (2.0 ** -30, 0.02), (0.0, 1.0), (5.0, 1e-9)):
        try:
            want = JQ.requantize_multiplier(s_in, s_out)
        except ValueError:
            with pytest.raises(ValueError):
                TQ.requantize_multiplier(s_in, s_out)
            continue
        assert TQ.requantize_multiplier(s_in, s_out) == want
