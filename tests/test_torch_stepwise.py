"""The port's stepwise executor against the JAX reference.

For all 16 LSTM topology variants and both GRU variants, the SAME quantized
layer (the reference's ``(arrays, spec)`` carried across by
``repro_torch.convert``) and the same int8 input go through both packages:
the port's ``quant_recurrent_seq_stepwise`` must equal the reference's
(``backend="xla"``) in ``ys`` and every state leaf.  The cases come from
the live builders in ``repro.testing.golden``, never from the committed
golden files; the reference's programs are traced and compiled together.
The per-gate executor is ``test_torch_layer_ref.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import gru as JG  # noqa: E402
from repro.models import lstm as JL  # noqa: E402
from repro.models import quant_lstm as JQL  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import quant_lstm as TQL  # noqa: E402
from test_torch_recurrent import run_compiled  # noqa: E402

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _case(variant):
    """One built case per variant, shared by the tests below (read-only)."""
    if isinstance(variant, JG.GRUVariant):
        xs_q, arrays, spec = golden.build_gru_variant_case(variant)
    else:
        xs_q, arrays, spec = golden.build_variant_case(variant)
    t_arrays, t_spec = convert.qlayers_from_numpy(
        [(jax.device_get(arrays), dataclasses.asdict(spec))])[0]
    return xs_q, arrays, spec, t_arrays, t_spec


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _references():
    """The reference's stepwise executor on every variant's case, its
    programs traced and compiled together (``run_compiled``)."""
    variants = JL.ALL_VARIANTS + JG.ALL_VARIANTS
    jobs = []
    for variant in variants:
        xs_q, arrays, spec, _, _ = _case(variant)
        state0 = JQL.initial_recurrent_state(spec, xs_q.shape[0])
        jobs.append((jax.jit(
            lambda a, x, s, spec=spec: jops.quant_recurrent_seq_stepwise(
                a, spec, x, s, backend="xla")), (arrays, xs_q, state0)))
    return dict(zip(variants, run_compiled(jobs)))


def _stepwise(variant):
    """(port result, reference result) of the stepwise executor."""
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    x_t = torch.from_numpy(np.array(xs_q))
    want = _references()[variant]
    before = serve.launch_counts()
    got = tops.quant_recurrent_seq_stepwise(
        t_arrays, t_spec, x_t,
        TQL.initial_recurrent_state(t_spec, x_t.shape[0], "cpu"))
    assert serve.launch_counts() == before  # CPU tensors launch nothing
    return got, want


@pytest.mark.parametrize("variant", JL.ALL_VARIANTS + JG.ALL_VARIANTS,
                         ids=lambda v: v.name)
def test_stepwise_matches_reference(variant):
    (ys, state), (j_ys, j_state) = _stepwise(variant)
    _eq(ys, j_ys)
    assert len(state) == len(j_state)
    for leaf, j_leaf in zip(state, j_state):
        _eq(leaf, j_leaf)


@pytest.mark.parametrize("vi", [0, 6, 15])
def test_lstm_wrappers_and_projection_epilogue(vi):
    """The LSTM-shaped wrappers thread (h, c) through the same executors,
    and the projection through the GEMM's requantize epilogue equals
    ``ref.lstm_project``."""
    variant = JL.ALL_VARIANTS[vi]
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    x_t = torch.from_numpy(np.array(xs_q))
    h0, c0 = TQL._initial_state(t_spec, x_t.shape[0], None, None, "cpu")
    ys_s, (h_s, c_s) = tops.quant_lstm_seq_stepwise(t_arrays, t_spec, x_t,
                                                    h0, c0)
    ys_h, (h_h, c_h) = tops.quant_lstm_seq(t_arrays, t_spec, x_t, h0, c0)
    ys_l, (h_l, c_l) = TQL.quant_lstm_layer(t_arrays, t_spec, x_t)
    for a, b, c in ((ys_s, ys_h, ys_l), (h_s, h_h, h_l), (c_s, c_h, c_l)):
        assert torch.equal(a, b) and torch.equal(a, c)
    _, (h1, c1) = tops.quant_lstm_seq_stepwise(t_arrays, t_spec,
                                                x_t[:, :1], h0, c0)
    assert torch.equal(tops.quant_lstm_step(t_arrays, t_spec, x_t[:, 0], h0,
                                            c0)[0], h1)
    valid = torch.tensor([3, 0], dtype=torch.int32)
    ys_m, (h_m, _) = tops.quant_lstm_seq_masked(t_arrays, t_spec, x_t, h0, c0,
                                                valid)
    assert torch.equal(ys_m[0, :3], ys_s[0, :3])
    assert torch.equal(h_m[1], h0[1])
    m_q = torch.from_numpy(np.random.default_rng(vi).integers(
        -128, 128, (3, t_spec.cfg_d_hidden)).astype(np.int8))
    assert torch.equal(tops._lstm_project(t_arrays, t_spec, m_q),
                       tref.lstm_project(t_arrays, t_spec, m_q))
    if t_spec.use_projection:
        _eq(tref.lstm_project(t_arrays, t_spec, m_q),
            jref.lstm_project_jnp(arrays, spec, jnp.asarray(m_q.numpy())))
