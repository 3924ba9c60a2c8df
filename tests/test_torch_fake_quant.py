"""The port's QAT pieces and PTQ helpers against the JAX reference.

* ``core.fake_quant``: each function equals the reference run eagerly, bit
  for bit (ROADMAP F9).  Under ``jax.jit`` XLA rewrites the reference's
  float32 arithmetic; the port holds to the jitted form within one float32
  ulp of the tensor's largest |x| (of the channel's, per channel), which is
  what the rewrite moves.  Gradients through the straight-through
  estimator equal ``jax.grad``'s.
* The POT ceiling: the port takes the exact exponent, the reference
  ``ceil(log(m) / log(2))`` in float32; they differ only where ``m`` lies
  within a few ulps of a power of two.
* ``lstm.sparsify_params``, ``recipe.recipe_table`` and
  ``cell.register_cell``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import cell as JC  # noqa: E402
from repro.core import fake_quant as JF  # noqa: E402
from repro.core import recipe as JR  # noqa: E402
from repro.core.calibrate import Stats as JStats  # noqa: E402
from repro.models import gru as JG  # noqa: E402
from repro.models import lstm as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import cell as TC  # noqa: E402
from repro_torch.core import fake_quant as TF  # noqa: E402
from repro_torch.core import recipe as TR  # noqa: E402
from repro_torch.core.calibrate import Stats as TStats  # noqa: E402
from repro_torch.models import gru as TG  # noqa: E402
from repro_torch.models import lstm as TL  # noqa: E402

torch.set_num_threads(1)

# (name, keyword arguments, per-channel axis); the functions take x first
CASES = [("asymmetric", dict(bits=8), None),
         ("asymmetric", dict(bits=16), None),
         ("symmetric", dict(bits=8), None),
         ("symmetric", dict(bits=16, pot=True), None),
         ("symmetric", dict(bits=8, per_channel_axis=1), 1),
         ("symmetric", dict(bits=8, per_channel_axis=-2, pot=True), 0),
         ("q", dict(fractional_bits=12), None),
         ("q", dict(fractional_bits=10, bits=8), None)]
IDS = [f"{n}-{'-'.join(f'{k}{v}' for k, v in kw.items())}"
       for n, kw, _ in CASES]


def _fns(name, kw):
    j = getattr(JF, f"fake_quant_{name}")
    t = getattr(TF, f"fake_quant_{name}")
    return (lambda x: j(x, **kw)), (lambda x: t(x, **kw))


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 3, size=(500, 400)).astype(np.float32),
            rng.normal(0.4, 0.05, size=(64, 48)).astype(np.float32),  # > 0
            (rng.standard_t(2, size=(30, 70)) * 0.1).astype(np.float32),
            np.zeros((3, 5), np.float32)]


def _ulp_of_range(name, x, axis):
    """One float32 ulp of the range a function quantizes: t_max - t_min
    for the asymmetric form, else 2 max|x|, over the tensor or (per
    channel) over every axis but ``axis``."""
    if name == "asymmetric":
        span = np.float32(max(x.max(), 0)) - np.float32(min(x.min(), 0))
    else:
        a = np.abs(x)
        span = 2 * (a.max() if axis is None else a.max(
            axis=tuple(i for i in range(x.ndim) if i != axis),
            keepdims=True))
    return np.spacing(np.maximum(span, np.float32(1e-8)).astype(np.float32))


def _scale(name, kw, x, axis):
    """The quantization step each function uses on ``x`` (float32)."""
    f32 = np.float32
    if name == "q":
        return f32(2.0 ** -kw["fractional_bits"])
    bits = kw["bits"]
    if name == "asymmetric":
        span = f32(max(x.max(), 0)) - f32(min(x.min(), 0))
        return max(f32(span / f32(2**bits - 1)), f32(1e-8))
    a = np.abs(x)
    m = a.max() if axis is None else a.max(
        axis=tuple(i for i in range(x.ndim) if i != axis), keepdims=True)
    m = np.maximum(m, f32(1e-8))
    if kw.get("pot"):
        return (2.0 ** np.ceil(np.log2(m.astype(np.float64)))
                / 2 ** (bits - 1)).astype(f32)
    return (m / f32(2 ** (bits - 1) - 1)).astype(f32)


@pytest.mark.parametrize("i", range(len(CASES)), ids=IDS)
def test_fake_quant_matches_eager_and_jit(i):
    name, kw, axis = CASES[i]
    jfn, tfn = _fns(name, kw)
    jitted = jax.jit(jfn)
    for x in _inputs(i):
        got = tfn(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jfn(jnp.asarray(x))))
        d = np.abs(got - np.asarray(jitted(jnp.asarray(x))))
        ulp = _ulp_of_range(name, x, axis)
        scale = _scale(name, kw, x, axis)
        r = x / scale
        tie = np.abs(np.abs(r - np.floor(r)) - 0.5) <= 4 * np.spacing(r)
        assert ((d <= ulp) | (tie & (d <= scale + ulp))).all()


@pytest.mark.parametrize("i", [0, 3, 4, 6], ids=[IDS[i] for i in (0, 3, 4,
                                                                   6)])
def test_fake_quant_gradient_is_straight_through(i):
    """d/dx sum(fq(x) * c + fq(x)**2) equals jax.grad's."""
    name, kw, _ = CASES[i]
    jfn, tfn = _fns(name, kw)
    rng = np.random.default_rng(10 + i)
    x = rng.normal(0, 2, size=(40, 30)).astype(np.float32)
    c = rng.normal(size=(40, 30)).astype(np.float32)

    def jloss(x):
        y = jfn(x)
        return jnp.sum(y * c + y * y)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    tx = torch.from_numpy(x).requires_grad_()
    y = tfn(tx)
    (y * torch.from_numpy(c) + y * y).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), want, rtol=1e-6, atol=1e-6)
    # the straight-through part: the gradient of fq is the identity
    tx.grad = None
    tfn(tx).sum().backward()
    np.testing.assert_array_equal(tx.grad.numpy(), np.ones_like(x))


def test_pot_ceiling_near_powers_of_two():
    """The port's 16-bit POT scale is the exact 2**ceil(log2 max|x|) / 2**15
    at and around every power of two; the reference's matches it except
    within a few ulps of a power of two, where its float32 log2 can
    misplace the ceiling."""
    rng = np.random.default_rng(0)
    body = rng.uniform(-0.4, 0.4, size=255).astype(np.float32)
    jfn = jax.jit(lambda x: JF.fake_quant_symmetric(x, 16, pot=True))
    differ = 0
    for k in range(-24, 24):
        p = np.float32(2.0 ** k)
        for m in (p, np.nextafter(p, np.float32(0)),
                  np.nextafter(p, np.float32(np.inf)), p * np.float32(0.75),
                  p * np.float32(1.25)):
            x = np.append(body * p, m).astype(np.float32)
            got = TF.fake_quant_symmetric(torch.from_numpy(x), 16, pot=True)
            exact = 2.0 ** np.ceil(np.log2(np.float64(m))) / 2**15
            q = np.clip(np.round(x / np.float32(exact)), -32767, 32767)
            np.testing.assert_array_equal(
                got.numpy(), x + (q * np.float32(exact) - x))
            want = np.asarray(JF.fake_quant_symmetric(jnp.asarray(x), 16,
                                                      pot=True))
            assert np.array_equal(np.asarray(jfn(jnp.asarray(x))), want)
            if not np.array_equal(got.numpy(), want):
                differ += 1
                assert abs(float(m) / 2.0 ** round(np.log2(float(m))) - 1) \
                    < 4 * 2.0**-23
    assert differ < 48  # far from powers of two the two always agree


def _tree_equal(t, j):
    if isinstance(j, dict):
        assert set(t) == set(j)
        for k in j:
            _tree_equal(t[k], j[k])
        return
    j = np.asarray(j)
    if t.dtype == torch.bfloat16:
        t, j = t.float(), j.astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), j)


@pytest.mark.parametrize("sparsity", [0.0, 0.3, 0.5, 0.9])
def test_sparsify_params(sparsity):
    """Ties at the threshold (weights on a coarse grid) are pruned together,
    as the reference prunes them; 1-D leaves stay."""
    variant = JL.LSTMVariant(True, True, True, False)
    cfg = JL.LSTMConfig(12, 16, 8, variant)
    params = JL.init_lstm_params(jax.random.PRNGKey(3), cfg)
    params = jax.tree_util.tree_map(lambda w: jnp.round(w * 8) / 8, params)
    params["emb"] = jnp.round(jax.random.normal(
        jax.random.PRNGKey(4), (20, 6)) * 8).astype(jnp.bfloat16) / 8
    want = JL.sparsify_params(params, sparsity)
    got = TL.sparsify_params(convert.params_from_numpy(
        jax.device_get(params)), sparsity)
    _tree_equal(got, jax.device_get(want))


def test_recipe_table_matches_reference():
    rng = np.random.default_rng(1)

    def ranges(names):
        return {n: tuple(float(v) for v in sorted(rng.normal(0, 2, size=2)))
                for n in names}

    for variant in (JL.ALL_VARIANTS[15], JL.ALL_VARIANTS[5]):
        cfg = JL.LSTMConfig(10, 12, 6 if variant.use_projection else 0,
                            variant)
        params = JL.init_lstm_params(jax.random.PRNGKey(7), cfg)
        stats = ranges(("x", "h", "h_out", "m", "c")
                       + tuple(f"g_{g}" for g in variant.gates))
        _, j_spec = JR.quantize_lstm_layer(params, cfg,
                                           JStats.from_dict(stats))
        t_cfg = TL.LSTMConfig(10, 12, cfg.d_proj, TL.LSTMVariant(
            *dataclasses.astuple(variant)))
        _, t_spec = TR.quantize_lstm_layer(
            convert.params_from_numpy(jax.device_get(params)), t_cfg,
            TStats.from_dict(stats))
        assert TR.recipe_table(t_spec) == JR.recipe_table(j_spec)
    cfg = JG.GRUConfig(10, 12, JG.GRUVariant(True))
    params = JG.init_gru_params(jax.random.PRNGKey(8), cfg)
    stats = ranges(("x", "h", "h_out", "g_r", "g_u", "g_n"))
    _, j_spec = JR.quantize_gru_layer(params, cfg, JStats.from_dict(stats))
    _, t_spec = TR.quantize_gru_layer(
        convert.params_from_numpy(jax.device_get(params)),
        TG.GRUConfig(10, 12, TG.GRUVariant(True)), TStats.from_dict(stats))
    assert TR.recipe_table(t_spec) == JR.recipe_table(j_spec)


def test_register_cell_resolves_a_new_cell():
    class Toy(TC.GRUCell):
        name = "toy"

    @dataclasses.dataclass(frozen=True)
    class Spec:
        cell: str = "toy"

    with pytest.raises(ValueError, match="unknown recurrent cell 'toy'"):
        TC.get_cell(Spec())
    toy = Toy()
    TC.register_cell(toy)
    try:
        assert TC.get_cell(Spec()) is toy
        assert TC.get_cell(Spec("gru")) is TC.CELLS["gru"]
    finally:
        del TC.CELLS["toy"]
    assert set(TC.CELLS) == set(JC.CELLS)
