"""The port's float recurrent LM (the paper's accuracy baseline) and its
PTQ/QAT pipeline at ``lstm-rnnt-smoke`` and ``gru-rnnt-smoke``, against
the JAX reference on the same weights (drawn by the reference's
``model_zoo.build(cfg).init``, carried across as numpy).

Rules:
* the stateful ``forward`` gives the jitted reference's bf16 logits bit
  for bit, and its float32 states within 1e-6 of their largest |value|;
* teacher-forced ``decode_step`` gives ``forward``'s last-position
  logits (ROADMAP F3: 2 bf16 ulps of the row's largest |logit|);
* ``loss_fn`` of the float graph equals the reference's within float32
  rounding (rtol 1e-5), and each parameter's gradient agrees with
  ``jax.grad``'s within 1e-4 of that parameter's largest |gradient|
  (2**-6 for the bf16 leaves, whose gradients round to bf16); measured
  ~1e-6;
* under QAT the float32 intermediates, which differ from XLA's by an ulp
  here and there, meet fake quantization's rounding ties: a tie that
  flips moves one activation by one quantization step (2**-12 at a Q3.12
  gate input).  So the QAT loss agrees within rtol 1e-4 and each gradient
  within 2 % of its largest |gradient| (measured: 7e-6 and 0.75 %);
* ``calibrate`` over ``SyntheticLM`` batches merges ranges as the
  reference does, bit for bit on taps both frameworks compute exactly (the
  embedding, the bf16 logits); the float taps inside the stack agree to
  float32 rounding (rtol 1e-5, as ``test_torch_recipe.py`` holds them);
  ``SyntheticLM`` gives the reference's batches array for array;
* the float serve CLI prints the reference CLI's ``sample:`` tokens.
"""
import contextlib
import dataclasses
import functools
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JRG  # noqa: E402
from repro.core import calibrate as JCAL  # noqa: E402
from repro.data import pipeline as JDATA  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import lstm_lm as JLM  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TRG  # noqa: E402
from repro_torch.core import calibrate as TCAL  # noqa: E402
from repro_torch.data import pipeline as TDATA  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import lstm_lm as TLM  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from test_torch_recurrent import compile_all  # noqa: E402

torch.set_num_threads(1)

NO_CONSTRAIN = lambda x, logical=None: x  # noqa: E731
ARCHS = ("lstm-rnnt", "gru-rnnt")
B, T = 2, 6
# (loss rtol, gradient bound as a share of each leaf's largest |gradient|
# by dtype), float graph and QAT graph
RULES = {False: (1e-5, {torch.float32: 1e-4, torch.bfloat16: 2.0**-6}),
         True: (1e-4, {torch.float32: 2e-2, torch.bfloat16: 2e-2})}


@functools.lru_cache(maxsize=None)
def _model(arch):
    """(reference cfg, reference params, the port's cfg, the port's params)
    on the reference's seed-0 weights."""
    cfg = JRG.get_config(arch, smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(0))
    t_params = convert.params_from_numpy(jax.device_get(params))
    return cfg, params, TRG.get_config(arch, smoke=True), t_params


def _batch(cfg, step=0):
    return TDATA.SyntheticLM(TDATA.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=T, global_batch=B)).batch_at(step)


@functools.lru_cache(maxsize=None)
def _programs(arch):
    """The reference's jitted programs for ``arch``, compiled together:
    the stateful forward over half the prompt, and the loss with its
    gradient, float and (LSTM) QAT."""
    cfg, params, _, _ = _model(arch)
    state = JLM.init_decode_state(cfg, B)
    half = jnp.zeros((B, T // 2), jnp.int32)
    batch = {k: jnp.asarray(v) for k, v in _batch(cfg).items()}
    jobs = [(jax.jit(lambda p, t, s: JLM.forward(p, cfg, t, NO_CONSTRAIN,
                                                 states=s)),
             (params, half, state))]
    for qat in (False, True) if arch == "lstm-rnnt" else (False,):
        jobs.append((jax.jit(jax.value_and_grad(
            lambda p, b, qat=qat: JLM.loss_fn(p, cfg, b, NO_CONSTRAIN,
                                              qat=qat))), (params, batch)))
    return compile_all(jobs)


def _tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=shape).astype(np.int32)


def _head_bound(logits):
    """2 bf16 ulps of each row's largest |logit| (ROADMAP F3)."""
    top = logits.abs().amax(dim=-1, keepdim=True)
    return 2.0 * 2.0 ** (torch.floor(torch.log2(top.clamp(min=1e-30))) - 7)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_states_matches_reference(arch):
    """Two halves of a prompt, the second from the first's states."""
    cfg, params, tcfg, t_params = _model(arch)
    fwd = _programs(arch)[0]
    toks = _tokens(cfg, 1)
    j_state = JLM.init_decode_state(cfg, B)
    t_state = TLM.init_decode_state(tcfg, B, device="cpu")
    for half in (toks[:, :T // 2], toks[:, T // 2:]):
        j_logits, j_state = fwd(params, jnp.asarray(half), j_state)
        with torch.no_grad():
            t_logits, t_state = TLM.forward(t_params, tcfg,
                                            torch.from_numpy(half),
                                            states=t_state)
        assert t_logits.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            t_logits.float().numpy(),
            np.asarray(j_logits).astype(np.float32))
        assert set(t_state) == set(j_state)
        for key in TLM.state_keys(tcfg):
            for tl, jl in zip(t_state[key], j_state[key], strict=True):
                jl = np.asarray(jl)
                np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                           atol=1e-6 * np.abs(jl).max())
        assert int(t_state["len"]) == int(j_state["len"])
    assert int(t_state["len"]) == T


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_step_equals_forward(arch):
    _, _, tcfg, t_params = _model(arch)
    toks = torch.from_numpy(_tokens(tcfg, 2))
    bundle = TZ.build(tcfg)
    state = bundle.init_state(B, 16, device="cpu")
    with torch.no_grad():
        want, _ = TLM.forward(t_params, tcfg, toks)
        for t in range(T):
            got, state = bundle.decode(t_params, toks[:, t:t + 1], state)
            w = want[:, t].float()
            assert ((got.float() - w).abs() <= _head_bound(w)).all()
        np.testing.assert_array_equal(
            bundle.prefill(t_params, {"tokens": toks}).float().numpy(),
            want[:, -1].float().numpy())
    assert int(state["len"]) == T
    assert state["h"][0].dtype == torch.float32


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("arch,qat", [("lstm-rnnt", False),
                                      ("lstm-rnnt", True),
                                      ("gru-rnnt", False)])
def test_loss_and_gradients_match_reference(arch, qat):
    cfg, params, tcfg, t_params = _model(arch)
    j_loss, j_grads = _programs(arch)[1 + qat](
        params, {k: jnp.asarray(v) for k, v in _batch(cfg).items()})
    loss_rtol, grad_rtol = RULES[qat]
    leaves = dict(_leaves(t_params))
    for p in leaves.values():
        p.requires_grad_(True)
    try:
        batch = {k: torch.from_numpy(v) for k, v in _batch(tcfg).items()}
        loss = TLM.loss_fn(t_params, tcfg, batch, qat=qat)
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(j_loss),
                                   rtol=loss_rtol)
        j_leaves = dict(_leaves(jax.device_get(j_grads)))
        assert set(j_leaves) == set(leaves)
        for name, p in leaves.items():
            jg = np.asarray(j_leaves[name]).astype(np.float32)
            tg = p.grad.float().numpy()
            bound = grad_rtol[p.dtype] * np.abs(jg).max()
            assert np.abs(tg - jg).max() <= bound, name
    finally:
        for p in leaves.values():
            p.requires_grad_(False)
            p.grad = None
    if arch == "gru-rnnt":  # QAT reaches only the LSTM
        with torch.no_grad():
            assert float(TLM.loss_fn(t_params, tcfg, batch, qat=True)) == \
                float(loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_calibrate_matches_reference(arch):
    cfg, params, tcfg, t_params = _model(arch)
    data = JDATA.SyntheticLM(JDATA.DataConfig(cfg.vocab_size, T, B))
    j_batches = [data.batch_at(s) for s in range(3)]
    tdata = TDATA.SyntheticLM(TDATA.DataConfig(tcfg.vocab_size, T, B))
    t_batches = [tdata.batch_at(s) for s in range(4)]

    def j_exact(p, b, col):  # taps both frameworks compute bit for bit
        col.tap("emb", JLM.emb.embed_tokens(p, b["tokens"]))
        col.tap("logits", JLM.forward(p, cfg, b["tokens"], NO_CONSTRAIN)[0])

    def t_exact(p, b, col):
        toks = torch.from_numpy(b["tokens"])
        col.tap("emb", TLM.emb.embed_tokens(p, toks))
        col.tap("logits", TLM.forward(p, tcfg, toks)[0])

    want = JCAL.calibrate(j_exact, params, j_batches).to_dict()
    assert TCAL.calibrate(t_exact, t_params, t_batches,
                          num_batches=3).to_dict() == want

    want = JCAL.calibrate(
        lambda p, b, col: JLM.forward(p, cfg, b["tokens"], NO_CONSTRAIN,
                                      collector=col),
        params, j_batches).to_dict()
    apply_fn = lambda p, b, col: TLM.forward(  # noqa: E731
        p, tcfg, torch.from_numpy(b["tokens"]), collector=col)
    got = TCAL.calibrate(apply_fn, t_params, t_batches, num_batches=3)
    assert set(got.ranges) == set(want)
    for name, lohi in want.items():
        np.testing.assert_allclose(got.range(name), lohi, rtol=1e-5,
                                   atol=1e-7, err_msg=name)
    one = TCAL.calibrate(apply_fn, t_params, t_batches[:1])
    assert one.to_dict() == TLM.calibration_stats(
        t_params, tcfg, torch.from_numpy(t_batches[0]["tokens"])).to_dict()


def test_synthetic_lm_matches_reference():
    for kw in (dict(vocab_size=4096, seq_len=32, global_batch=4),
               dict(vocab_size=50, seq_len=7, global_batch=3, seed=9,
                    noise=0.3, frontend_tokens=2, d_model=5)):
        j = JDATA.SyntheticLM(JDATA.DataConfig(**kw))
        t = TDATA.SyntheticLM(TDATA.DataConfig(**kw))
        for (js, jb), (ts, tb) in zip(j.iterate(3), t.iterate(3)):
            assert js == ts
            assert set(jb) == set(tb)
            for k in jb:
                assert tb[k].dtype == jb[k].dtype
                np.testing.assert_array_equal(tb[k], jb[k])
            if js == 6:
                break


def _sample(text):
    lines = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    assert len(lines) == 1, text
    return eval(lines[0][len("sample:"):])


@pytest.mark.parametrize("arch", ARCHS)
def test_float_serve_cli_matches_reference(arch, monkeypatch):
    """``--quant none`` on the smoke model: the port's CLI on the
    reference's weights and prompt prints the reference CLI's tokens."""
    cfg, _, tcfg, t_params = _model(arch)
    argv = ["--arch", arch, "--smoke", "--quant", "none", "--batch", "2",
            "--prompt-len", "5", "--gen", "4", "--max-len", "16"]
    out = io.StringIO()
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    with contextlib.redirect_stdout(out):
        jserve.main()
    want = _sample(out.getvalue())
    prompt = np.asarray(jax.random.randint(jax.random.PRNGKey(1), (2, 5), 0,
                                           cfg.vocab_size))
    build = TZ.build

    def carried(cfg):
        return dataclasses.replace(build(cfg),
                                   init=lambda gen, device: t_params)

    monkeypatch.setattr(TZ, "build", carried)
    monkeypatch.setattr(tserve, "random_prompt",
                        lambda *a, **k: torch.from_numpy(prompt.copy()))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(argv + ["--device", "cpu"])
    text = out.getvalue()
    assert _sample(text) == want
    assert "int8_matmul=0 quant_lstm_scan=0 quant_gru_scan=0" in text


def test_int8_on_the_recurrent_family_exits():
    for arch, cell in (("lstm-rnnt", "lstm"), ("gru-rnnt", "gru")):
        with pytest.raises(SystemExit, match=f"--quant int8-{cell}"):
            tserve.main(["--arch", arch, "--smoke", "--quant", "int8",
                         "--device", "cpu"])


def test_bundles_default_to_the_card(monkeypatch):
    """``model_zoo.build(cfg).init`` and ``init_state`` place tensors on
    ``cuda`` unless the caller passes a device."""
    seen = []
    monkeypatch.setattr(TLM, "init_params",
                        lambda g, cfg, device: seen.append(device))
    monkeypatch.setattr(TLM, "init_decode_state",
                        lambda cfg, b, device: seen.append(device))
    from repro_torch.models import transformer as TT
    monkeypatch.setattr(TT, "init_params",
                        lambda g, cfg, device: seen.append(device))
    monkeypatch.setattr(TT, "init_decode_cache",
                        lambda cfg, b, n, quantized, device: seen.append(
                            device))
    from repro_torch.models import quant_transformer as TQT
    for arch in ("lstm-rnnt", "qwen3-4b"):
        bundle = TZ.build(TRG.get_config(arch, smoke=True))
        for b in (bundle, TQT.quantize_bundle(bundle)) \
                if arch == "qwen3-4b" else (bundle,):
            b.init_state(1, 8)
            if b is bundle:
                b.init(None)
    assert seen == ["cuda"] * len(seen) and len(seen) == 5
