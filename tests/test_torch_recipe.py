"""The port's Table-2 recipe and calibration against the JAX reference.

From the same float params and the same ``Stats`` the port's
``quantize_lstm_layer`` must emit identical integer arrays and an
identical spec, for every LSTM variant.  The port's own float32
calibration forward is compared with the reference's at rtol 1e-5: both
run float32 matmuls, which XLA and PyTorch sum in different orders, so
ranges agree to float32 rounding, not bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import recipe as JR  # noqa: E402
from repro.core.calibrate import Stats as JStats  # noqa: E402
from repro.core.calibrate import TapCollector as JTap  # noqa: E402
from repro.models import lstm as JL  # noqa: E402
from repro.models import lstm_lm as JLM  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import recipe as TR  # noqa: E402
from repro_torch.core.calibrate import Stats as TStats  # noqa: E402
from repro_torch.models import lstm as TL  # noqa: E402
from repro_torch.models import lstm_lm as TLM  # noqa: E402


def _stats_for(variant, seed):
    """Synthetic calibration ranges for every tap the recipe reads."""
    rng = np.random.default_rng(seed)
    ranges = {}
    for name in ("x", "h", "h_out", "m", "c") + tuple(
            f"g_{g}" for g in variant.gates):
        lo, hi = sorted(rng.normal(0, 2, size=2))
        ranges[name] = (float(lo), float(hi))
    return ranges


def _assert_arrays_equal(t_arrays, j_arrays):
    assert set(t_arrays) == set(j_arrays)
    for k, jv in j_arrays.items():
        if isinstance(jv, dict):
            _assert_arrays_equal(t_arrays[k], jv)
            continue
        jv = np.asarray(jv)
        tv = t_arrays[k].numpy()
        assert tv.dtype == jv.dtype, k
        np.testing.assert_array_equal(tv, jv, err_msg=k)


@pytest.mark.parametrize("variant", JL.ALL_VARIANTS, ids=lambda v: v.name)
def test_quantize_lstm_layer_matches_reference(variant):
    cfg = JL.LSTMConfig(10, 12, 6 if variant.use_projection else 0, variant)
    params = JL.init_lstm_params(jax.random.PRNGKey(7), cfg)
    if variant.use_layernorm:  # non-trivial LN weights and biases
        params["L"] = {g: 1.0 + 0.3 * jax.random.normal(
            jax.random.PRNGKey(i), (12,)) for i, g in enumerate(params["L"])}
        params["b"] = {g: 0.1 * jax.random.normal(
            jax.random.PRNGKey(9 + i), (12,)) for i, g in enumerate(params["b"])}
    ranges = _stats_for(variant, 3)
    j_arrays, j_spec = JR.quantize_lstm_layer(params, cfg,
                                              JStats.from_dict(ranges))
    t_params = convert.params_from_numpy(jax.device_get(params))
    t_cfg = TL.LSTMConfig(10, 12, cfg.d_proj, TL.LSTMVariant(
        *dataclasses.astuple(variant)))
    t_arrays, t_spec = TR.quantize_lstm_layer(t_params, t_cfg,
                                              TStats.from_dict(ranges))
    _assert_arrays_equal(t_arrays, j_arrays)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec == convert.spec_from_dict(dataclasses.asdict(j_spec))


def test_lm_calibration_and_recipe_match_reference():
    params, qlayers, cfg, _ = golden.build_lm_case()
    calib = np.array(jax.random.randint(jax.random.PRNGKey(2), (4, 8), 0,
                                          cfg.vocab_size))
    col = JTap()
    JLM.forward(params, cfg, jnp.asarray(calib), lambda x, logical=None: x,
                collector=col)
    j_stats = JStats()
    j_stats.merge(jax.device_get(col.snapshot()))

    t_params = convert.params_from_numpy(jax.device_get(params))
    t_stats = TLM.calibration_stats(t_params, cfg, torch.from_numpy(calib))
    assert set(t_stats.ranges) == set(j_stats.ranges)
    for name, (lo, hi) in j_stats.ranges.items():
        np.testing.assert_allclose(t_stats.ranges[name], (lo, hi), rtol=1e-5,
                                   atol=1e-7, err_msg=name)

    # from the reference's Stats the port rebuilds the reference's layers
    for i, (lc, (j_arrays, j_spec)) in enumerate(
            zip(TLM.layer_cfgs(cfg), qlayers)):
        t_arrays, t_spec = TR.quantize_lstm_layer(
            t_params["lstm"][i], lc, TStats.from_dict(j_stats.to_dict()),
            prefix=f"l{i}/")
        _assert_arrays_equal(t_arrays, jax.device_get(j_arrays))
        assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
