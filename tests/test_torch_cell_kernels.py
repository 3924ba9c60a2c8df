"""The plain versions of the fused LSTM cell and integer LayerNorm kernels
against the JAX reference.

The plain version is what a CPU tensor runs and what each CUDA kernel is
held against on the card, so it must EQUAL the reference's
``ops.quant_lstm_cell`` and ``ops.int_layernorm`` (``backend="xla"``, the
functions the Pallas kernels trace) on the same int16 inputs, made with
numpy: the cell at the shapes of ``tests/test_kernels.py`` with and without
CIFG for every cell format (the cell without peephole is elementwise, so
the reference runs once per format on all three shapes' inputs together,
one compiled program instead of three), and its peephole o-gate contract
with and without the in-fusion LayerNorm; the LayerNorm over row lengths
1..16384 with constant rows (V = 0) and rows at the int16 extremes.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int_layernorm as tln  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_lstm_cell as tcell  # noqa: E402
from test_torch_recurrent import run_compiled  # noqa: E402

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)

EFF_M = jfp.quantize_multiplier(2.0**-30 / 0.005)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy().astype(np.int64),
                                  np.asarray(j).astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_cell(**static):
    return jax.jit(lambda i, f, z, o, c, *vecs: jops.quant_lstm_cell(
        i, f, z, o, c, backend="xla",
        **dict(zip(("p_o", "lw_o", "lb_o"), vecs)), **static))


def _run_both(arrays, **static):
    """(port plain, JAX xla) results of one cell call on numpy inputs."""
    want = _jax_cell(**static)(*[jnp.asarray(a) for a in arrays])
    names = ("i16", "f16", "z16", "o_in", "c_q", "p_o", "lw_o", "lb_o")
    kw = dict(zip(names, [torch.from_numpy(a) for a in arrays]))
    before = tcell.launches
    got = tops.quant_lstm_cell(**kw, **static)
    assert tcell.launches == before  # CPU tensors launch nothing
    return got, want


def _gates(rng, B, H, o_dtype=np.int16):
    g = [rng.integers(-32768, 32768, (B, H)).astype(np.int16)
         for _ in range(3)]
    if o_dtype == np.int16:
        o = rng.integers(-32768, 32768, (B, H)).astype(np.int16)
    else:  # the int32 pre-peephole accumulator, past the int16 range
        o = rng.integers(-(2**20), 2**20, (B, H)).astype(np.int32)
    c = rng.integers(-20000, 20000, (B, H)).astype(np.int16)
    return [*g, o, c]


CELL_SHAPES = [(8, 256), (16, 1024), (4, 2048)]


@functools.lru_cache(maxsize=None)
def _cell_reference(cifg, m_c):
    """The reference cell (no peephole: elementwise) on every shape's
    inputs at once: one compiled program per static configuration, its
    output cut back into the shapes.  ``{(B, H): (inputs, (m, c))}``."""
    inputs = {(B, H): _gates(np.random.default_rng(B * H + m_c), B, H)
              for B, H in CELL_SHAPES}
    flat = [np.concatenate([inputs[s][k].reshape(-1) for s in CELL_SHAPES])
            for k in range(5)]
    jm, jc = _jax_cell(cell_int_bits=m_c, cifg=cifg, eff_m=EFF_M, zp_m=-4)(
        *[jnp.asarray(a[None]) for a in flat])
    out, pos = {}, 0
    for B, H in CELL_SHAPES:
        cut = slice(pos, pos + B * H)
        out[(B, H)] = (inputs[(B, H)],
                       (np.asarray(jm)[0, cut].reshape(B, H),
                        np.asarray(jc)[0, cut].reshape(B, H)))
        pos += B * H
    return out


@pytest.mark.parametrize("B,H", CELL_SHAPES)
@pytest.mark.parametrize("cifg", [False, True])
@pytest.mark.parametrize("m_c", [0, 2, 4])
def test_cell_plain_matches_reference(B, H, cifg, m_c):
    arrays, (jm, jc) = _cell_reference(cifg, m_c)[(B, H)]
    names = ("i16", "f16", "z16", "o_in", "c_q")
    before = tcell.launches
    m, c = tops.quant_lstm_cell(
        **dict(zip(names, [torch.from_numpy(a) for a in arrays])),
        cell_int_bits=m_c, cifg=cifg, eff_m=EFF_M, zp_m=-4)
    assert tcell.launches == before  # CPU tensors launch nothing
    assert m.dtype == torch.int8 and c.dtype == torch.int16
    _eq(m, jm)
    _eq(c, jc)


@pytest.mark.parametrize("ln", [False, True], ids=["peephole", "peephole+LN"])
@pytest.mark.parametrize("cifg", [False, True])
def test_cell_plain_peephole_o_gate_matches_reference(ln, cifg):
    """With a peephole the o gate is finished on c_new inside the cell, and
    with LN it is normalised over the whole row there."""
    B, H = 4, 2048
    rng = np.random.default_rng(17 + 2 * ln + cifg)
    arrays = _gates(rng, B, H, np.int32)
    arrays.append(rng.integers(-32767, 32768, H).astype(np.int16))  # p_o
    static = dict(cell_int_bits=2, cifg=cifg, eff_m=EFF_M, zp_m=3,
                  eff_c_o=jfp.quantize_multiplier(0.37))
    if ln:
        arrays += [rng.integers(100, 32767, H).astype(np.int16),
                   rng.integers(-100000, 100000, H).astype(np.int32)]
        static["ln_out_o"] = jfp.quantize_multiplier(2**-10 * 3e-5 / 2**-12)
    (m, c), (jm, jc) = _run_both(arrays, **static)
    _eq(m, jm)
    _eq(c, jc)


def test_cell_refuses_a_broken_o_gate_contract():
    rng = np.random.default_rng(0)
    i, f, z, o, c = [torch.from_numpy(a) for a in _gates(rng, 2, 8)]
    with pytest.raises(ValueError):  # peephole needs the int32 accumulator
        tops.quant_lstm_cell(i, f, z, o, c, cell_int_bits=0, cifg=False,
                             eff_m=EFF_M, zp_m=0, p_o=o[0],
                             eff_c_o=(1 << 30, 0))
    with pytest.raises(ValueError):  # in-fusion LN needs the peephole
        tops.quant_lstm_cell(i, f, z, o, c, cell_int_bits=0, cifg=False,
                             eff_m=EFF_M, zp_m=0, ln_out_o=(1 << 30, 0))


def _ln_rows(n, seed):
    """Random rows, a constant row (V = 0) and rows at the int16 extremes."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-32768, 32768, (6, n)).astype(np.int16)
    q[1] = 1234  # constant: V = 0
    q[2] = 32767
    q[3] = -32768
    q[4, ::2] = 32767
    q[4, 1::2] = -32768
    lw = rng.integers(100, 32767, n).astype(np.int16)
    lb = rng.integers(-100000, 100000, n).astype(np.int32)
    return q, lw, lb


LN_LENGTHS = [1, 3, 12, 640, 2048, 16384]
LN_OUT = jfp.quantize_multiplier(2**-10 * 3e-5 / 2**-12)


@functools.lru_cache(maxsize=None)
def _layernorm_references():
    """The reference LayerNorm at every row length, its programs traced and
    compiled together (``run_compiled``): ``{n: int16 array}``."""
    m0, sh = LN_OUT
    jobs = [(jax.jit(lambda a, w, b: jops.int_layernorm(
        a, w, b, out_m0=m0, out_shift=sh, backend="xla")),
        tuple(jnp.asarray(x) for x in _ln_rows(n, n))) for n in LN_LENGTHS]
    return {n: np.asarray(out)
            for n, out in zip(LN_LENGTHS, run_compiled(jobs))}


@pytest.mark.parametrize("n", LN_LENGTHS)
def test_layernorm_plain_matches_reference(n):
    q, lw, lb = _ln_rows(n, n)
    m0, sh = LN_OUT
    want = _layernorm_references()[n]
    before = tln.launches
    got = tops.int_layernorm(torch.from_numpy(q), torch.from_numpy(lw),
                             torch.from_numpy(lb), out_m0=m0, out_shift=sh)
    assert tln.launches == before
    assert got.dtype == torch.int16
    _eq(got, want)
    # the paper-exact int64 oracle (float rsqrt) agrees on the random rows
    # within the 2 LSB that tests/test_integer_ops.py allows the reference
    oracle = jref.int_layernorm_np(q[5:], lw, lb, m0, sh).astype(np.int64)
    assert np.abs(got[5:].numpy().astype(np.int64) - oracle).max() <= 2


def test_layernorm_flattens_leading_axes_and_refuses_long_rows():
    q, lw, lb = _ln_rows(12, 1)
    m0, sh = jfp.quantize_multiplier(0.37)
    t = [torch.from_numpy(a) for a in (q, lw, lb)]
    flat = tops.int_layernorm(*t, out_m0=m0, out_shift=sh)
    folded = tops.int_layernorm(t[0].reshape(2, 3, 12), t[1], t[2],
                                out_m0=m0, out_shift=sh)
    assert torch.equal(folded.reshape(6, 12), flat)
    with pytest.raises(ValueError):
        tops.int_layernorm(torch.zeros((1, 16385), dtype=torch.int16),
                           torch.zeros(16385, dtype=torch.int16),
                           torch.zeros(16385, dtype=torch.int32),
                           out_m0=m0, out_shift=sh)
