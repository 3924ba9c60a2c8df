"""The port's integer GRU against the JAX reference.

Both GRU variants (noLN, LN) and the ``gru-rnnt-smoke`` LM: the SAME
quantized layers (the reference's ``(arrays, spec)`` carried across by
``repro_torch.convert``) and the same inputs go through both packages.
Integer outputs and states must be equal.  The bf16 head keeps the rule of
``test_torch_lm.py`` (2 bf16 ulps of the row's largest |logit|; tokens
equal wherever the reference's top-2 margin exceeds that).  The reference
cases are built live by ``repro.testing.golden``, never read from the
committed golden files; the layer references' programs are traced and
compiled together.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import recipe as JR  # noqa: E402
from repro.core.calibrate import Stats as JStats  # noqa: E402
from repro.core.calibrate import TapCollector as JTap  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.models import gru as JG  # noqa: E402
from repro.models import lstm_lm as JLM  # noqa: E402
from repro.models import quant_lstm as JQL  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import recipe as TR  # noqa: E402
from repro_torch.core.calibrate import Stats as TStats  # noqa: E402
from repro_torch.core.calibrate import TapCollector as TTap  # noqa: E402
from repro_torch.kernels import int8_matmul as tmm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import quant_gru_scan as tgru  # noqa: E402
from repro_torch.kernels import quant_lstm_scan as tscan  # noqa: E402
from repro_torch.models import gru as TG  # noqa: E402
from repro_torch.models import lstm_lm as TLM  # noqa: E402
from repro_torch.models import quant_lstm as TQL  # noqa: E402
from test_torch_recurrent import compile_all, run_compiled  # noqa: E402

B, PROMPT, STEPS = 2, 6, 8

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)


def _carry(arrays, spec):
    """Reference (arrays, spec) -> the port's, through numpy only."""
    return convert.qlayers_from_numpy(
        [(jax.device_get(arrays), dataclasses.asdict(spec))])[0]


@functools.lru_cache(maxsize=None)
def _case(variant):
    """One built case per variant, shared by the tests below (read-only)."""
    xs_q, arrays, spec = golden.build_gru_variant_case(variant)
    t_arrays, t_spec = _carry(arrays, spec)
    return xs_q, arrays, spec, t_arrays, t_spec


def _valid(xs_q):
    Bx, T = xs_q.shape[:2]
    return np.array([T - 2, 0][:Bx] + [T] * max(Bx - 2, 0), np.int32)


@functools.lru_cache(maxsize=None)
def _references():
    """The reference's layer (``xla`` and ``interpret``) and masked
    executor on both variants' cases, their programs traced and compiled
    together (``run_compiled``): ``{(kind, variant): (ys, state)}``."""
    keys, jobs = [], []
    for variant in JG.ALL_VARIANTS:
        xs_q, arrays, spec, _, _ = _case(variant)
        for backend in ("xla", "interpret"):
            keys.append((backend, variant))
            jobs.append((jax.jit(
                lambda a, x, spec=spec, backend=backend:
                JQL.quant_recurrent_layer(a, spec, x, backend=backend)),
                (arrays, xs_q)))
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


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("variant", JG.ALL_VARIANTS, ids=lambda v: v.name)
def test_gru_variant_layer_matches_reference(variant, backend):
    """``ys`` and ``h`` equal the reference's scan executor and its Pallas
    sequence kernel (interpret mode)."""
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    ys, state = _references()[(backend, variant)]
    t_ys, t_state = TQL.quant_recurrent_layer(
        t_arrays, t_spec, torch.from_numpy(np.array(xs_q)))
    _eq(t_ys, ys)
    assert len(t_state) == len(state) == 1
    _eq(t_state[0], state[0])
    assert t_spec.cell == "gru" and t_spec.variant.name == variant.name


@pytest.mark.parametrize("variant", JG.ALL_VARIANTS, ids=lambda v: v.name)
def test_gru_masked_matches_reference_and_prefix(variant):
    xs_q, arrays, spec, t_arrays, t_spec = _case(variant)
    Bx = xs_q.shape[0]
    valid = _valid(xs_q)
    ys, state = _references()[("masked", variant)]
    x_t = torch.from_numpy(np.array(xs_q))
    t_ys, t_state = TQL.quant_recurrent_layer(
        t_arrays, t_spec, x_t, valid_len=torch.from_numpy(valid))
    _eq(t_ys, ys)
    _eq(t_state[0], state[0])
    for b in range(Bx):  # each row's state equals feeding its prefix alone
        pre_ys, pre_state = TQL.quant_recurrent_layer(
            t_arrays, t_spec, x_t[b:b + 1, :valid[b]])
        assert torch.equal(t_state[0][b:b + 1], pre_state[0])
        assert torch.equal(t_ys[b, :valid[b]], pre_ys[0])
        # frozen positions emit the unchanged h
        assert (t_ys[b, valid[b]:] == t_state[0][b]).all()


def _gru_stats(variant, seed):
    """Synthetic calibration ranges for every tap the GRU recipe reads."""
    rng = np.random.default_rng(seed)
    ranges = {}
    for name in ("x", "h", "h_out") + tuple(f"g_{g}" for g in variant.gates):
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


@pytest.mark.parametrize("variant", JG.ALL_VARIANTS, ids=lambda v: v.name)
def test_quantize_gru_layer_matches_reference(variant):
    """From the same float params and Stats, identical arrays and spec;
    and the port's float32 calibration taps agree to float32 rounding."""
    cfg = JG.GRUConfig(10, 12, variant)
    params = JG.init_gru_params(jax.random.PRNGKey(7), cfg)
    params["b"] = {g: 0.1 * jax.random.normal(jax.random.PRNGKey(9 + i),
                                              (12,))
                   for i, g in enumerate(params["b"])}
    if variant.use_layernorm:
        params["L"] = {g: 1.0 + 0.3 * jax.random.normal(
            jax.random.PRNGKey(i), (12,)) for i, g in enumerate(params["L"])}
    ranges = _gru_stats(variant, 3)
    j_arrays, j_spec = JR.quantize_gru_layer(params, cfg,
                                             JStats.from_dict(ranges))
    t_params = convert.params_from_numpy(jax.device_get(params))
    t_cfg = TG.GRUConfig(10, 12, TG.GRUVariant(variant.use_layernorm))
    t_arrays, t_spec = TR.quantize_gru_layer(t_params, t_cfg,
                                             TStats.from_dict(ranges))
    _assert_arrays_equal(t_arrays, j_arrays)
    assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)
    assert t_spec == convert.spec_from_dict(dataclasses.asdict(j_spec))

    # the float calibration forward: same taps, ranges to float32 rounding
    xs = np.array(0.8 * jax.random.normal(jax.random.PRNGKey(4), (2, 5, 10)),
                  np.float32)
    col = JTap()
    JG.gru_layer(params, cfg, jnp.asarray(xs), collector=col)
    j_stats = JStats()
    j_stats.merge(jax.device_get(col.snapshot()))
    tcol = TTap()
    TG.gru_layer(t_params, t_cfg, torch.from_numpy(xs), collector=tcol)
    t_stats = TStats()
    t_stats.merge(tcol.snapshot())
    assert set(t_stats.ranges) == set(j_stats.ranges)
    for name, (lo, hi) in j_stats.ranges.items():
        np.testing.assert_allclose(t_stats.ranges[name], (lo, hi), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


# ---------------------------------------------------------------------------
# The gru-rnnt-smoke LM
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def carried():
    params, qlayers, cfg, _ = golden.build_lm_case("gru-rnnt")
    t_params = convert.params_from_numpy(jax.device_get(params))
    t_qlayers = convert.qlayers_from_numpy(
        [(jax.device_get(a), dataclasses.asdict(s)) for a, s in qlayers])
    return params, qlayers, cfg, t_params, t_qlayers


def _head_bound(j_logits):
    """2 bf16 ulps of each row's largest |logit| (bf16 keeps 8 bits)."""
    top = np.abs(j_logits).max(axis=-1, keepdims=True)
    return 2.0 * 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7)


def _check_head(t_logits, j_logits):
    t = t_logits.to(torch.float32).numpy()
    j = np.asarray(j_logits, np.float32)
    bound = _head_bound(j)
    assert (np.abs(t - j) <= bound).all()
    srt = np.sort(j, axis=-1)
    clear = srt[:, -1] - srt[:, -2] > bound[:, 0]
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear])


def _check_state(t_state, j_state):
    assert list(t_state) == ["h", "len"]
    for tl, jl in zip(t_state["h"], j_state["h"], strict=True):
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(t_state["len"].numpy(),
                                  np.asarray(j_state["len"]))


def test_gru_lm_prefill_and_decode_match_reference(carried):
    params, qlayers, cfg, t_params, t_qlayers = carried
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg.vocab_size, size=(B, PROMPT)).astype(np.int32)
    forced = rng.integers(0, cfg.vocab_size, size=(STEPS, B, 1)).astype(
        np.int32)
    state0 = JLM.init_quant_decode_state(qlayers, B)
    prefill, decode = compile_all([
        (jax.jit(lambda p, t, s: JLM.quant_prefill(
            p, qlayers, cfg, t, s, backend="xla")),
         (params, jnp.asarray(prompt), state0)),
        (jax.jit(lambda p, t, s: JLM.quant_decode_step(
            p, qlayers, cfg, t, s, backend="xla")),
         (params, jnp.asarray(forced[0]), state0))])
    j_state = JLM.init_quant_decode_state(qlayers, B)
    t_state = TLM.init_quant_decode_state(t_qlayers, B)
    j_logits, j_state = prefill(params, jnp.asarray(prompt), j_state)
    t_logits, t_state = TLM.quant_prefill(
        t_params, t_qlayers, cfg, torch.from_numpy(prompt.copy()), t_state)
    _check_state(t_state, j_state)
    _check_head(t_logits, j_logits)
    for step in range(STEPS):  # teacher-forced, so a head tie cannot cascade
        j_logits, j_state = decode(params, jnp.asarray(forced[step]), j_state)
        t_logits, t_state = TLM.quant_decode_step(
            t_params, t_qlayers, cfg, torch.from_numpy(forced[step].copy()),
            t_state)
        _check_state(t_state, j_state)
        _check_head(t_logits, j_logits)


def test_gru_lm_calibration_and_recipe_match_reference(carried):
    """The port's float GRU stack records the reference's taps (to float32
    rounding), and from the reference's Stats it rebuilds the reference's
    quantized layers exactly."""
    params, qlayers, cfg, t_params, _ = carried
    calib = np.array(jax.random.randint(jax.random.PRNGKey(2), (4, 8), 0,
                                        cfg.vocab_size))
    col = JTap()
    JLM.forward(params, cfg, jnp.asarray(calib), lambda x, logical=None: x,
                collector=col)
    j_stats = JStats()
    j_stats.merge(jax.device_get(col.snapshot()))
    t_stats = TLM.calibration_stats(t_params, cfg, torch.from_numpy(calib))
    assert set(t_stats.ranges) == set(j_stats.ranges)
    for name, (lo, hi) in j_stats.ranges.items():
        np.testing.assert_allclose(t_stats.ranges[name], (lo, hi), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    assert TLM.stack_d_out(cfg) == cfg.d_rnn
    for i, (lc, (j_arrays, j_spec)) in enumerate(
            zip(TLM.layer_cfgs(cfg), qlayers, strict=True)):
        t_arrays, t_spec = TR.quantize_gru_layer(
            t_params["lstm"][i], lc, TStats.from_dict(j_stats.to_dict()),
            prefix=f"l{i}/")
        _assert_arrays_equal(t_arrays, jax.device_get(j_arrays))
        assert dataclasses.asdict(t_spec) == dataclasses.asdict(j_spec)


def test_gru_state_helpers_match_reference(carried):
    """reset / write / slice / stack of a stacked GRU state, as in the
    reference: the decode state after a prefill, row by row."""
    params, qlayers, cfg, t_params, t_qlayers = carried
    prompt = np.random.default_rng(2).integers(
        0, cfg.vocab_size, size=(3, 4)).astype(np.int32)
    j_state = JLM.init_quant_decode_state(qlayers, 3, per_slot_len=True)
    t_state = TLM.init_quant_decode_state(t_qlayers, 3, per_slot_len=True)
    _, j_state = jax.jit(lambda p, t, s: JLM.quant_prefill(
        p, qlayers, cfg, t, s, backend="xla"))(params, jnp.asarray(prompt),
                                               j_state)
    _, t_state = TLM.quant_prefill(t_params, t_qlayers, cfg,
                                   torch.from_numpy(prompt.copy()), t_state)
    _check_state(t_state, j_state)
    _check_state(TLM.reset_quant_slot(t_qlayers, t_state, 1),
                 JLM.reset_quant_slot(qlayers, j_state, 1))
    j_row = jax.device_get(JLM.slice_state(j_state, 2))
    t_row = TLM.slice_state(t_state, 2)
    _check_state(t_row, j_row)
    _check_state(TLM.write_quant_slot(t_state, 0, t_row),
                 JLM.write_quant_slot(j_state, 0, j_row))
    rows = [TLM.slice_state(t_state, r) for r in (2, 0, 1)]
    _check_state(TLM.stack_state(rows), JLM.stack_state(
        [jax.device_get(JLM.slice_state(j_state, r)) for r in (2, 0, 1)]))


def test_gru_cpu_tensors_take_plain_versions():
    """On the CPU the wrappers run the plain versions and count no launch;
    the GRU launcher itself refuses CPU tensors."""
    xs_q, arrays, spec, t_arrays, t_spec = _case(JG.ALL_VARIANTS[1])
    before = (tmm.launches, tscan.launches, tgru.launches)
    x_t = torch.from_numpy(np.array(xs_q))
    acc = tops.quant_recurrent_input_proj(t_arrays, x_t)
    state = TQL.initial_recurrent_state(t_spec, x_t.shape[0], "cpu")
    ys, st = tscan.quant_recurrent_seq_scan(t_arrays, t_spec, acc, state)
    ys_p, st_p = tscan.quant_recurrent_seq_scan_plain(t_arrays, t_spec, acc,
                                                      state)
    assert torch.equal(ys, ys_p) and torch.equal(st[0], st_p[0])
    assert (tmm.launches, tscan.launches, tgru.launches) == before
    with pytest.raises(ValueError, match="CUDA"):
        tgru.quant_gru_seq_scan(t_arrays, t_spec, acc, state)


def test_gru_full_width_layer_step_on_cpu():
    """Two steps of a full-width LN GRU layer (d_in = H = 2048), so the
    plain version is checked at the shapes the kernel serves."""
    variant = JG.GRUVariant(use_layernorm=True)
    cfg = JG.GRUConfig(2048, 2048, variant)
    params = JG.init_gru_params(jax.random.PRNGKey(3), cfg)
    xs = 0.8 * jax.random.normal(jax.random.PRNGKey(4), (1, 2, 2048))
    col = JTap()
    JG.gru_layer(params, cfg, xs, collector=col)
    stats = JStats()
    stats.merge(jax.device_get(col.snapshot()))
    arrays, spec = JR.quantize_gru_layer(params, cfg, stats)
    xs_q = JQL.quantize_input(xs, spec.s_x, spec.zp_x)
    ys, (h,) = jax.jit(lambda a, x: JQL.quant_recurrent_layer(
        a, spec, x, backend="xla"))(arrays, xs_q)
    t_arrays, t_spec = _carry(arrays, spec)
    t_ys, (th,) = TQL.quant_recurrent_layer(
        t_arrays, t_spec, torch.from_numpy(np.array(xs_q)))
    _eq(t_ys, ys)
    _eq(th, h)
