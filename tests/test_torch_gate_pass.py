"""The plain versions of the stepwise LSTM step's two kernels against the
JAX reference: the gate pass (``int_layernorm_gates_plain``: every gate
but a peephole o formed from the step's int32 accumulators and normalised)
and the cell's step entry (``quant_lstm_cell_step_plain``: the cell forming
every gate the pass did not give it).

The plain versions are what a CPU tensor runs and what the CUDA kernels are
held against on the card, so they must EQUAL the reference's
``ref.lstm_gate_preacts`` and ``ops.quant_lstm_cell(backend="xla")`` on the
same accumulators, made with numpy: LN and no-LN layers, with and without
peephole and CIFG, at the golden cases' H = 12 and a ragged H = 37; rows
from the layer's own products, rows at the int32 extremes (every gate at
the int16 extremes), a constant row (V = 0 in every gate's LayerNorm) and
rows of huge random accumulators.  One compiled reference program per
layer, compiled together (``run_compiled``).  The whole CPU step is held
against the reference's stepwise executor by ``test_torch_stepwise.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import recipe as JR  # noqa: E402
from repro.core.calibrate import Stats, TapCollector  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.models import lstm as JL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.kernels import int_layernorm as tln  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_lstm_cell as tcell  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402
from test_torch_recurrent import run_compiled  # noqa: E402

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)

V = JL.LSTMVariant
CASES = {  # name: (variant, H); each JAX LN program takes ~9 s to compile
    "LN-PH-CIFG H37": (V(use_layernorm=True, use_peephole=True,
                         use_cifg=True), 37),
    "LN-Proj": (V(use_layernorm=True, use_projection=True), 12),
    "PH": (V(use_peephole=True), 12),
}
D_IN, D_P, ROWS = 8, 6, 8


@functools.lru_cache(maxsize=None)
def _layer(name):
    """The reference's quantized layer (calibrated on a seeded input) and
    the port's copy of it."""
    variant, H = CASES[name]
    cfg = JL.LSTMConfig(D_IN, H, D_P if variant.use_projection else 0,
                        variant)
    params = JL.init_lstm_params(jax.random.PRNGKey(H), cfg)
    xs = 0.8 * jax.random.normal(jax.random.PRNGKey(H + 1), (2, 5, D_IN))
    col = TapCollector()
    JL.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(jax.device_get(col.snapshot()))
    arrays, spec = JR.quantize_lstm_layer(params, cfg, stats)
    arrays = jax.device_get(arrays)
    t_arrays, t_spec = convert.qlayers_from_numpy(
        [(arrays, dataclasses.asdict(spec))])[0]
    return arrays, spec, t_arrays, t_spec


@functools.lru_cache(maxsize=None)
def _inputs(name):
    """``(acc_x, acc_h, c)`` of ROWS rows: 0-2 the layer's own products of
    random int8 x and h, 3 the int32 extremes alternating, 4 constant (V =
    0), 5-7 huge random accumulators; c random, at the int16 extremes
    (row 3) and constant (row 4)."""
    arrays, spec, _, _ = _layer(name)
    rng = np.random.default_rng(len(name))
    H, GH = spec.cfg_d_hidden, arrays["W_cat"].shape[1]
    x = rng.integers(-128, 128, (ROWS, D_IN)).astype(np.int64)
    h = rng.integers(-128, 128, (ROWS, spec.d_out)).astype(np.int64)
    acc_x = x @ np.asarray(arrays["W_cat"], np.int64) + np.asarray(
        arrays["fold_x_cat"], np.int64)
    acc_h = h @ np.asarray(arrays["R_cat"], np.int64) + np.asarray(
        arrays["fold_hb_cat"], np.int64)
    for acc in (acc_x, acc_h):
        acc[3, ::2], acc[3, 1::2] = 2**31 - 1, -(2**31)
        acc[4] = acc[4, 0]
        acc[5:] = rng.integers(-(2**31), 2**31, (ROWS - 5, GH))
    c = rng.integers(-20000, 20000, (ROWS, H)).astype(np.int16)
    c[3, ::2], c[3, 1::2] = 32767, -32768
    c[4] = 1234
    return acc_x.astype(np.int32), acc_h.astype(np.int32), c


def _reference_step(spec, vals, acc_x, acc_h, c):
    i16, f16, z16, o_in, o_kw = jref.lstm_gate_preacts(vals, spec, acc_x,
                                                       acc_h, c)
    m, c_new = jops.quant_lstm_cell(
        i16, f16, z16, o_in, c, backend="xla",
        cell_int_bits=spec.cell_int_bits, cifg=spec.use_cifg,
        eff_m=spec.eff_m, zp_m=spec.zp_m, **o_kw)
    return {"i": i16, "f": f16, "z": z16, "o": o_in}, m, c_new


@functools.lru_cache(maxsize=None)
def _references():
    """``{name: (gates, m, c_new)}`` of the reference's gate pre-activations
    and cell on every case's inputs, compiled together."""
    jobs = []
    for name in CASES:
        arrays, spec, _, _ = _layer(name)
        jobs.append((jax.jit(functools.partial(_reference_step, spec)),
                     (arrays, *(jnp.asarray(a) for a in _inputs(name)))))
    return dict(zip(CASES, run_compiled(jobs)))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


def _torch_inputs(name):
    return [torch.from_numpy(a) for a in _inputs(name)]


@pytest.mark.parametrize("name", sorted(CASES))
def test_gate_pass_plain_matches_reference(name):
    """Each gate the pass forms equals the reference's normalised gate; the
    block of a peephole o gate is 0; a layer without LN is refused."""
    _, _, t_arrays, t_spec = _layer(name)
    acc_x, acc_h, c = _torch_inputs(name)
    if not t_spec.use_layernorm:
        assert tln.pass_gates(t_spec) == ()
        with pytest.raises(ValueError):
            tops.int_layernorm_gates(t_arrays, t_spec, acc_x, acc_h, c)
        return
    want, _, _ = _references()[name]
    before = tln.launches
    got = tops.int_layernorm_gates(t_arrays, t_spec, acc_x, acc_h, c)
    assert tln.launches == before  # CPU tensors launch nothing
    H = t_spec.cfg_d_hidden
    gates = t_spec.variant.gates
    assert got.dtype == torch.int16 and got.shape == (ROWS, len(gates) * H)
    for k, g in enumerate(gates):
        block = got[:, k * H:(k + 1) * H]
        if g in tln.pass_gates(t_spec):
            _eq(block, want[g])
        else:
            assert g == "o" and t_spec.use_peephole
            assert not block.any()
    # what the rows are for: z (no peephole) before its LN is constant in
    # row 4 (V = 0) and reaches both int16 extremes in row 3
    k = gates.index("z")
    z16 = tref.lstm_gate_acc(t_arrays, t_spec, k, "z", acc_x, acc_h, c)
    z16 = z16.clamp(-32768, 32767)
    assert int(z16[4].min()) == int(z16[4].max())
    assert int(z16[3].min()) == -32768 and int(z16[3].max()) == 32767


@pytest.mark.parametrize("name", sorted(CASES))
def test_cell_step_plain_matches_reference(name):
    """The cell from the accumulators (and the gate pass's output for an LN
    layer) equals the reference's gate pre-activations and fused cell."""
    _, _, t_arrays, t_spec = _layer(name)
    acc_x, acc_h, c = _torch_inputs(name)
    _, want_m, want_c = _references()[name]
    gates16 = (tops.int_layernorm_gates(t_arrays, t_spec, acc_x, acc_h, c)
               if t_spec.use_layernorm else None)
    if t_spec.use_layernorm:
        with pytest.raises(ValueError):  # an LN layer needs the pass
            tops.quant_lstm_cell_step(t_arrays, t_spec, acc_x, acc_h, c)
    before = tcell.launches
    m, c_new = tops.quant_lstm_cell_step(t_arrays, t_spec, acc_x, acc_h, c,
                                         gates16)
    assert tcell.launches == before
    assert m.dtype == torch.int8 and c_new.dtype == torch.int16
    _eq(m, want_m)
    _eq(c_new, want_c)
