"""The port's integer recurrent layer against the JAX reference.

For every LSTM topology variant the SAME quantized layer (the reference's
``(arrays, spec)`` carried across by ``qlayers_from_numpy``) and the same
int8 input go through both packages.  Outputs and every state leaf must be
equal.  The reference cases come from the live builders in
``repro.testing.golden``, never from the committed golden files.  The
reference's programs for the whole module are traced and compiled together
(``run_compiled``), the first test that needs one paying for all.
"""
import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.models import lstm as JL  # noqa: E402
from repro.models import quant_lstm as JQL  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import int8_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_lstm_scan as tscan  # noqa: E402
from repro_torch.models import quant_lstm as TQL  # noqa: E402


def _carry(arrays, spec):
    """Reference (arrays, spec) -> the port's, through numpy only."""
    return convert.qlayers_from_numpy(
        [(jax.device_get(arrays), dataclasses.asdict(spec))])[0]


@functools.lru_cache(maxsize=None)
def _case(variant):
    """One built case per variant, shared by the tests below (read-only)."""
    xs_q, arrays, spec = golden.build_variant_case(variant)
    t_arrays, t_spec = _carry(arrays, spec)
    return xs_q, arrays, spec, t_arrays, t_spec


def compile_all(jobs, threads=3):
    """The jitted ``fn``s of ``jobs`` (``(fn, example args)`` pairs),
    compiled: each traced and lowered here in turn while XLA compiles the
    ones before on a few threads (its compiles release the GIL), so a
    module's reference programs cost about their tracing, not tracing plus
    compiling."""
    with ThreadPoolExecutor(threads) as pool:
        pending = [pool.submit(fn.lower(*args).compile) for fn, args in jobs]
        return [future.result() for future in pending]


def run_compiled(jobs, threads=3):
    """``[fn(*args) for fn, args in jobs]``, compiled by ``compile_all``."""
    return [program(*args) for program, (_, args) in
            zip(compile_all(jobs, threads), jobs)]


MASKED = (JL.ALL_VARIANTS[0], JL.ALL_VARIANTS[7], JL.ALL_VARIANTS[15])
INTERPRET = (JL.ALL_VARIANTS[-1], JL.ALL_VARIANTS[12])


def _valid(xs_q):
    B, T = xs_q.shape[:2]
    return np.array([T - 2, 0][:B] + [T] * max(B - 2, 0), np.int32)


@functools.lru_cache(maxsize=None)
def _references():
    """The reference's results for the tests below, computed together:
    ``{("xla" | "interpret", variant): (ys, state)}`` of its layer and
    ``{("masked", variant): (ys, state)}`` of its masked executor."""
    keys, jobs = [], []
    for backend, variants in (("xla", JL.ALL_VARIANTS),
                              ("interpret", INTERPRET)):
        for variant in variants:
            xs_q, arrays, spec, _, _ = _case(variant)
            keys.append((backend, variant))
            jobs.append((jax.jit(
                lambda a, x, spec=spec, backend=backend:
                JQL.quant_recurrent_layer(a, spec, x, backend=backend)),
                (arrays, xs_q)))
    for variant in MASKED:
        xs_q, arrays, spec, _, _ = _case(variant)
        keys.append(("masked", variant))
        jobs.append((jax.jit(
            lambda a, x, s, v, spec=spec: jops.quant_recurrent_seq_masked(
                a, spec, x, s, v, backend="xla")),
            (arrays, xs_q, JQL.initial_recurrent_state(spec, xs_q.shape[0]),
             jnp.asarray(_valid(xs_q)))))
    return dict(zip(keys, run_compiled(jobs)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


@pytest.mark.parametrize("variant", JL.ALL_VARIANTS, ids=lambda v: v.name)
def test_variant_layer_matches_reference(variant):
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    ys, state = _references()[("xla", variant)]
    t_ys, t_state = TQL.quant_recurrent_layer(
        t_arrays, t_spec, torch.from_numpy(np.array(xs_q)))
    _eq(t_ys, ys)
    assert len(t_state) == len(state) == 2
    for tl, jl in zip(t_state, state):
        _eq(tl, jl)
    assert t_spec.variant.name == variant.name


@pytest.mark.parametrize("variant", INTERPRET, ids=lambda v: v.name)
def test_variant_layer_matches_interpret_kernel(variant):
    """Against the reference's own Pallas sequence kernel (interpret mode)."""
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    ys, (h, c) = _references()[("interpret", variant)]
    t_ys, (th, tc) = TQL.quant_recurrent_layer(
        t_arrays, t_spec, torch.from_numpy(np.array(xs_q)))
    _eq(t_ys, ys)
    _eq(th, h)
    _eq(tc, c)


@pytest.mark.parametrize("variant", MASKED, ids=lambda v: v.name)
def test_masked_matches_reference_and_prefix(variant):
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    B = xs_q.shape[0]
    valid = _valid(xs_q)
    ys, state = _references()[("masked", variant)]
    x_t = torch.from_numpy(np.array(xs_q))
    t_ys, t_state = TQL.quant_recurrent_layer(
        t_arrays, t_spec, x_t, valid_len=torch.from_numpy(valid))
    _eq(t_ys, ys)
    for tl, jl in zip(t_state, state):
        _eq(tl, jl)
    # each row's state equals feeding its valid prefix alone
    for b in range(B):
        pre_ys, pre_state = TQL.quant_recurrent_layer(
            t_arrays, t_spec, x_t[b:b + 1, :valid[b]])
        for tl, pl in zip(t_state, pre_state):
            assert torch.equal(tl[b:b + 1], pl)
        assert torch.equal(t_ys[b, :valid[b]], pre_ys[0])


def test_empty_sequence_returns_carry():
    xs_q, arrays, spec, t_arrays, t_spec = _case(JL.ALL_VARIANTS[12])
    x_t = torch.from_numpy(np.array(xs_q))
    _, state = TQL.quant_recurrent_layer(t_arrays, t_spec, x_t)
    ys0, state0 = tops.quant_recurrent_seq(t_arrays, t_spec, x_t[:, :0], state)
    assert ys0.shape == (x_t.shape[0], 0, t_spec.d_out)
    assert ys0.dtype == torch.int8
    assert all(a is b for a, b in zip(state0, state))
    ys1, state1 = tops.quant_recurrent_seq_masked(
        t_arrays, t_spec, x_t[:, :0], state, torch.zeros(2, dtype=torch.int32))
    assert ys1.shape[1] == 0 and all(a is b for a, b in zip(state1, state))


def test_cpu_tensors_take_plain_versions():
    """On the CPU the wrappers run the plain versions and count no launch."""
    xs_q, arrays, spec, t_arrays, t_spec = _case(JL.ALL_VARIANTS[13])
    before = (tmm.launches, tscan.launches)
    x_t = torch.from_numpy(np.array(xs_q))
    acc = tops.quant_recurrent_input_proj(t_arrays, x_t)
    state = TQL.initial_recurrent_state(t_spec, x_t.shape[0], "cpu")
    ys, st = tscan.quant_recurrent_seq_scan(t_arrays, t_spec, acc, state)
    ys_p, st_p = tscan.quant_recurrent_seq_scan_plain(t_arrays, t_spec, acc,
                                                      state)
    assert torch.equal(ys, ys_p) and all(
        torch.equal(a, b) for a, b in zip(st, st_p))
    assert (tmm.launches, tscan.launches) == before


def test_full_width_layer_step_on_cpu():
    """One step of a full-width LN+projection layer (H=2048, d_proj=640),
    so the plain version is checked at the shapes the kernel serves."""
    variant = JL.LSTMVariant(use_layernorm=True, use_projection=True)
    cfg = JL.LSTMConfig(640, 2048, 640, variant)
    params = JL.init_lstm_params(jax.random.PRNGKey(3), cfg)
    xs = 0.8 * jax.random.normal(jax.random.PRNGKey(4), (1, 2, 640))
    from repro.core import recipe as JR
    from repro.core.calibrate import Stats, TapCollector
    col = TapCollector()
    JL.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(jax.device_get(col.snapshot()))
    arrays, spec = JR.quantize_lstm_layer(params, cfg, stats)
    xs_q = JQL.quantize_input(xs, spec.s_x, spec.zp_x)
    ys, (h, c) = jax.jit(lambda a, x: JQL.quant_recurrent_layer(
        a, spec, x, backend="xla"))(arrays, xs_q)
    t_arrays, t_spec = _carry(arrays, spec)
    t_ys, (th, tc) = TQL.quant_recurrent_layer(
        t_arrays, t_spec, torch.from_numpy(np.array(xs_q)))
    _eq(t_ys, ys)
    _eq(th, h)
    _eq(tc, c)


def test_gru_spec_is_refused():
    """A cell the port does not have is refused, never run as an LSTM: its
    spec does not convert, and a spec naming it is refused by the sequence
    executor.  (The GRU itself is ported: see ``test_torch_gru.py``.)"""
    with pytest.raises(NotImplementedError):
        convert.spec_from_dict({"cfg_d_input": 8, "gates": ()})
    xs_q, arrays, spec, t_arrays, t_spec = _case(JL.ALL_VARIANTS[0])

    class OtherCellNamed:
        cell = "mgu"

    acc = tops.quant_recurrent_input_proj(t_arrays,
                                          torch.from_numpy(np.array(xs_q)))
    state = TQL.initial_recurrent_state(t_spec, acc.shape[0], "cpu")
    with pytest.raises(NotImplementedError):
        tscan.quant_recurrent_seq_scan(t_arrays, OtherCellNamed(), acc, state)
