"""The port's per-gate reference executor and hybrid baseline against JAX.

For all 16 LSTM topology variants, the SAME quantized layer (the
reference's ``(arrays, spec)`` carried across by ``repro_torch.convert``)
and the same int8 input go through both packages: the port's per-gate
``quant_lstm_layer_ref`` must equal the reference's in ``ys`` and both
state leaves.  The cases come from the live builders in
``repro.testing.golden``, never from the committed golden files; the
reference's programs are traced and compiled together.  The hybrid
baseline is float and is held to a stated tolerance.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lstm as JL  # noqa: E402
from repro.models import quant_lstm as JQL  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import quant_lstm as TQL  # noqa: E402
from test_torch_recurrent import run_compiled  # noqa: E402

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _case(variant):
    """One built case per variant, shared by the tests below (read-only)."""
    xs_q, arrays, spec = golden.build_variant_case(variant)
    t_arrays, t_spec = convert.qlayers_from_numpy(
        [(jax.device_get(arrays), dataclasses.asdict(spec))])[0]
    return xs_q, arrays, spec, t_arrays, t_spec


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _references():
    """The reference's per-gate executor on every variant's case, its
    programs traced and compiled together (``run_compiled``)."""
    jobs = []
    for variant in JL.ALL_VARIANTS:
        xs_q, arrays, spec, _, _ = _case(variant)
        jobs.append((jax.jit(lambda a, x, spec=spec: JQL.quant_lstm_layer_ref(
            a, spec, x)), (arrays, xs_q)))
    return dict(zip(JL.ALL_VARIANTS, run_compiled(jobs)))


@pytest.mark.parametrize("variant", JL.ALL_VARIANTS, ids=lambda v: v.name)
def test_per_gate_layer_matches_reference(variant):
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    j_ys, j_state = _references()[variant]
    before = serve.launch_counts()
    ys, state = TQL.quant_lstm_layer_ref(t_arrays, t_spec,
                                         torch.from_numpy(np.array(xs_q)))
    assert serve.launch_counts() == before  # CPU tensors launch nothing
    _eq(ys, j_ys)
    assert len(state) == len(j_state) == 2
    for leaf, j_leaf in zip(state, j_state):
        _eq(leaf, j_leaf)


def test_reset_state_rows_and_empty_stepwise():
    xs_q, arrays, spec, t_arrays, t_spec = _case(JL.ALL_VARIANTS[13])
    x_t = torch.from_numpy(np.array(xs_q))
    _, (h, c) = TQL.quant_lstm_layer_ref(t_arrays, t_spec, x_t)
    h_r, c_r = TQL.reset_state_rows(t_spec, h, c, 1)
    j_h, j_c = JQL.reset_state_rows(spec, jnp.asarray(h.numpy()),
                                    jnp.asarray(c.numpy()), 1)
    _eq(h_r, j_h)
    _eq(c_r, j_c)
    assert torch.equal(h_r[0], h[0]) and not torch.equal(h_r, h)
    ys0, state0 = tops.quant_recurrent_seq_stepwise(t_arrays, t_spec,
                                                    x_t[:, :0], (h, c))
    assert ys0.shape == (2, 0, t_spec.d_out) and state0[0] is h


def test_hybrid_baseline_matches_reference():
    """The float hybrid baseline.  Its weights are numpy float64 in both
    packages, so they are EQUAL.  The product quantizes activations on the
    fly in float32 with the same operations in the same order as the
    reference, so eagerly it is EQUAL to the reference's (a wrong rounding
    of any activation moves its output by at least ``s_x * s_w``, far
    above float32 rounding).  Jitted, XLA may fold the two scale factors
    in another order, so there each output is held to 4 float32 ulps of
    itself (two roundings of the dequantization product, relative 2**-22)."""
    rng = np.random.default_rng(0)
    params = {"W": {g: rng.standard_normal((64, 32)) for g in "ifzo"},
              "R": {g: rng.standard_normal((32, 32)) for g in "ifzo"},
              "W_proj": rng.standard_normal((32, 16))}
    j_wq, j_scales = JQL.hybrid_weights(params)
    t_wq, t_scales = TQL.hybrid_weights(
        {k: ({g: torch.from_numpy(w) for g, w in v.items()}
             if isinstance(v, dict) else torch.from_numpy(v))
         for k, v in params.items()})
    assert t_scales == j_scales
    for kind in ("W", "R"):
        for g in "ifzo":
            _eq(t_wq[kind][g], j_wq[kind][g])
    _eq(t_wq["W_proj"], j_wq["W_proj"])
    j_matmul = jax.jit(JQL.hybrid_matmul, static_argnums=2)
    w_q, s_w = j_wq["W"]["i"], j_scales["W_i"]
    for seed in range(6):  # seeds 3 and 4 reach the jitted reordering
        x = np.random.default_rng(seed).standard_normal((8, 64)).astype(
            np.float32)
        got = TQL.hybrid_matmul(torch.from_numpy(x), t_wq["W"]["i"],
                                t_scales["W_i"]).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(JQL.hybrid_matmul(jnp.asarray(x), w_q, s_w)))
        np.testing.assert_allclose(
            got, np.asarray(j_matmul(jnp.asarray(x), w_q, s_w)),
            rtol=2.0**-22, atol=0)
        # and it stays a hybrid: close to the float product
        ref = x @ params["W"]["i"].astype(np.float32)
        assert np.abs(got - ref).max() < 0.02 * np.abs(ref).max() + 0.05
