"""The port's integer LM stack at ``lstm-rnnt-smoke`` against the JAX package.

Params and quantized layers are carried across from the reference's live
builder.  Integer state leaves must be EQUAL at every step.  The bf16 head
is the one float op between the integer state and the token, and the two
frameworks may sum it in different orders, so the rule is: logits agree
within 2 bf16 ulps of the row's largest |logit|, and the argmax tokens
agree wherever the reference's top-2 margin exceeds that bound.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import lstm_lm as JLM  # noqa: E402
from repro.models import quant_lstm as JQL  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lstm_lm as TLM  # noqa: E402
from repro_torch.models import quant_lstm as TQL  # noqa: E402
from test_torch_recurrent import compile_all  # noqa: E402

B, PROMPT, STEPS = 2, 6, 8


@pytest.fixture(scope="module")
def carried():
    params, qlayers, cfg, _ = golden.build_lm_case()
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
    margin = srt[:, -1] - srt[:, -2]
    clear = margin > bound[:, 0]
    np.testing.assert_array_equal(t.argmax(-1)[clear], j.argmax(-1)[clear])


def _check_state(t_state, j_state):
    for key in ("h", "c"):
        for tl, jl in zip(t_state[key], j_state[key]):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    assert int(t_state["len"]) == int(j_state["len"])


def test_prefill_and_decode_match_reference(carried):
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


@pytest.mark.parametrize("scale,zp", [(0.0123, -7), (0.1, 0),
                                      (3.0517578125e-05, 12),
                                      (0.00787401574803, -128)])
def test_quantize_input_on_rounding_boundaries(scale, zp):
    """Values on and next to .5 of the quantization grid must round as the
    reference does in its jitted serving path (where XLA multiplies by the
    float32 reciprocal of the constant scale)."""
    k = np.arange(-140, 140, dtype=np.float32)
    half = ((k + 0.5) * np.float32(scale)).astype(np.float32)
    rng = np.random.default_rng(1)
    x = np.concatenate([
        half, np.nextafter(half, np.float32(0)),
        np.nextafter(half, np.float32(np.inf)), k * np.float32(scale),
        rng.normal(0, 150 * scale, size=4000)]).astype(np.float32)
    want = np.asarray(jax.jit(JQL.quantize_input, static_argnums=(1, 2))(
        x, scale, zp))
    got = TQL.quantize_input(torch.from_numpy(x), scale, zp).numpy()
    np.testing.assert_array_equal(got, want)
    q = np.arange(-128, 128, dtype=np.int8)
    np.testing.assert_array_equal(
        TQL.dequantize_output(torch.from_numpy(q), scale, zp).numpy(),
        np.asarray(jax.jit(JQL.dequantize_output, static_argnums=(1, 2))(
            q, scale, zp)))


def test_serve_entry_runs_on_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", "lstm-rnnt", "--smoke", "--quant", "int8-lstm",
                     "--batch", "2", "--prompt-len", "4", "--gen", "3",
                     "--device", "cpu"])
    text = out.getvalue()
    sample = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    assert len(sample) == 1 and len(eval(sample[0][len("sample:"):])) == 3
    assert "int8_matmul=0 quant_lstm_scan=0" in text  # plain versions on CPU
