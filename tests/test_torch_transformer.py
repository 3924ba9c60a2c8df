"""The port's dense transformer against the JAX package, on the CPU.

Weights are drawn by the reference (``model_zoo.build(cfg).init``) and
carried across with ``repro_torch.convert``; inputs are drawn with numpy
from a seed.  Tolerances (``repro_torch.testing.attention_checks``):

* float32 modules: ``rtol 1e-5, atol 1e-6``;
* bf16 modules: 2 bf16 ulps of the row's largest ``|ref|`` (ROADMAP Queue
  3, F3);
* a whole bf16 model: every logit within 1 % of its row's largest
  ``|logit|``, the argmax equal wherever the reference's top-2 margin
  exceeds 2 % of it;
* ``quantize_param_tree``, ``quantize_weight`` and ``quantize_kv``: equal.

The smoke configs run the forward at S = 16 (``full_attention``) and at
S = 1100 (``flash_attention`` in every layer, the model's S > 1024 rule),
and teacher-forced ``decode_step`` with a bf16 and an int8 KV cache.
"""
import contextlib
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro.layers import common as JC  # noqa: E402
from repro.layers import mlp as JM  # noqa: E402
from repro.layers import qmm as JQ  # noqa: E402
from repro.layers import rotary as JROT  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro.models import quant_transformer as JQT  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.layers import common as TC  # noqa: E402
from repro_torch.layers import mlp as TM  # noqa: E402
from repro_torch.layers import qmm as TQ  # noqa: E402
from repro_torch.layers import rotary as TROT  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import quant_transformer as TQT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    check_close, check_logits)

torch.set_num_threads(1)

CONFIGS = ["qwen3-4b", "stablelm-1.6b", "qwen1.5-0.5b"]
NO_CONSTRAIN = lambda x, logical=None: x  # noqa: E731


def _t(a):
    """A JAX/numpy array -> a torch tensor of the same dtype."""
    return convert.tensor_from_numpy(jax.device_get(a))


def _bf16_pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, _t(j)


def _close_f32(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    cfg = JR.get_config(request.param, smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(0))
    t_params = convert.params_from_numpy(jax.device_get(params))
    return cfg, TR.get_config(request.param, smoke=True), params, t_params


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S,dtype", [(16, "bf16"), (16, "f32"),
                                     (1100, "f32")])
def test_forward_and_prefill_match_reference(model, S, dtype, monkeypatch):
    """The whole forward (every position's logits) and the prefill's last
    row; flash attention runs in every layer exactly when S > 1024.

    bf16 is held to the whole-model rule at S = 16.  At S = 1100 the rule
    is below the reference's own spread (its scanned and unrolled programs
    differ by up to 1.5 % of a row's largest |logit| there: XLA's float32
    summation order, amplified through attention; ROADMAP Queue 3, F7), so
    the whole model is held there with float32 weights, to the float32
    rule, where the point is the algorithm (flash in every layer)."""
    cfg, tcfg, params, t_params = model
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
        t_params = convert.params_from_numpy(jax.device_get(params))
    B = 2 if S <= 1024 else 1
    toks = _tokens(cfg, B, S, seed=S)
    want, _ = JT.forward(params, cfg, jnp.asarray(toks), NO_CONSTRAIN)
    calls = []
    real = FA.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(FA, "flash_attention", spy)
    with torch.no_grad():
        got = TT.forward(t_params, tcfg, torch.from_numpy(toks))
        last = TT.prefill(t_params, tcfg, torch.from_numpy(toks))
    # once per layer in each of the two passes, or never
    assert len(calls) == (2 * tcfg.n_layers if S > 1024 else 0)
    if dtype == "f32":
        _close_f32(got, want)
        _close_f32(last, np.asarray(want)[:, -1])
    else:
        want_t = _t(want)
        check_logits(f"{cfg.name} forward S={S}", got, want_t)
        check_logits(f"{cfg.name} prefill S={S}", last, want_t[:, -1])


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_matches_reference(model, quantized):
    """Teacher-forced ``decode_step`` over 6 tokens into a 16-position
    cache; with ``quantized`` the weights and the KV cache are int8 (the
    port quantizes the carried bf16 weights itself and must get the
    reference's int8 tree exactly)."""
    cfg, tcfg, params, t_params = model
    if quantized:
        jparams = JQT.quantize_param_tree(params)
        tparams = TQT.quantize_param_tree(t_params)
        _check_tree_equal(tparams, convert.params_from_numpy(
            jax.device_get(jparams)))
    else:
        jparams, tparams = params, t_params
    toks = _tokens(cfg, 2, 6, seed=3)
    decode = jax.jit(lambda p, t, s: JT.decode_step(p, cfg, t, s,
                                                    NO_CONSTRAIN))
    j_state = JT.init_decode_cache(cfg, 2, 16, quantized=quantized)
    t_state = TT.init_decode_cache(tcfg, 2, 16, quantized=quantized)
    for step in range(toks.shape[1]):
        tok = toks[:, step:step + 1]
        j_logits, j_state = decode(jparams, jnp.asarray(tok), j_state)
        with torch.no_grad():
            t_logits, t_state = TT.decode_step(tparams, tcfg,
                                               torch.from_numpy(tok), t_state)
        check_logits(f"{cfg.name} decode step {step}", t_logits,
                     _t(j_logits))
        assert t_state["len"] == int(j_state["len"])
    if not quantized:
        for key in ("k", "v"):
            check_close(f"{key} cache", t_state["main"][key],
                        _t(j_state["main"][key]))


def _check_tree_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        if isinstance(want[key], dict):
            _check_tree_equal(got[key], want[key])
        else:
            assert got[key].dtype == want[key].dtype, key
            assert torch.equal(got[key], want[key]), key


def test_make_serve_fns_prefill_and_decode(model):
    """The entry point of the prefill: ``make_serve_fns`` runs the bundle's
    prefill and a decode from a fresh cache of its (batch, max_len)."""
    cfg, tcfg, params, t_params = model
    bundle = TZ.build(tcfg)
    prefill_fn, decode_fn = train_loop.make_serve_fns(bundle, "cpu", 2, 8)
    toks = torch.from_numpy(_tokens(cfg, 2, 5, seed=4))
    got = prefill_fn(t_params, {"tokens": toks})
    want = JT.prefill(params, cfg, jnp.asarray(toks.numpy()), NO_CONSTRAIN)
    check_logits("prefill_fn", got, _t(want))
    logits, state = decode_fn(t_params, toks[:, :1])
    assert state["len"] == 1 and tuple(logits.shape) == (2, cfg.vocab_size)
    assert state["main"]["k"].shape == (cfg.n_layers, 2, 8, cfg.n_kv_heads,
                                        cfg.head_dim)


def test_vlm_prefill_with_frontend_embeds():
    """internvl2-2b-smoke: the patch embeddings are prepended (16 of them),
    then the prompt."""
    cfg = JR.get_config("internvl2-2b", smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(1))
    t_params = convert.params_from_numpy(jax.device_get(params))
    toks = _tokens(cfg, 2, 8, seed=5)
    jf, tf = _bf16_pair((2, cfg.n_frontend_tokens, cfg.d_model), 6)
    want = JT.prefill(params, cfg, jnp.asarray(toks), NO_CONSTRAIN,
                      frontend_embeds=jf)
    bundle = TZ.build(TR.get_config("internvl2-2b", smoke=True))
    prefill_fn, _ = train_loop.make_serve_fns(bundle, "cpu", 2, 32)
    got = prefill_fn(t_params, {"tokens": torch.from_numpy(toks),
                                "frontend_embeds": tf})
    check_logits("vlm prefill", got, _t(want))


def test_unported_families_raise():
    """Every family of the registry builds, and the MoE bundles train on
    one device: their ``loss`` is a finite scalar that holds ``0.01 *`` the
    auxiliary load-balancing loss over the cross-entropy (their parity
    with the reference is ``test_torch_moe.py``'s, as whisper-tiny,
    falcon-mamba-7b and recurrentgemma-9b have theirs).  What stays
    unported is the expert-parallel ``shard_map`` branch (ROADMAP Queue 1
    item 9), which no one-device path reaches."""
    for name in ("kimi-k2-1t-a32b", "grok-1-314b"):
        cfg = TR.get_config(name, smoke=True)
        bundle = TZ.build(cfg)
        params = bundle.init(torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(np.random.default_rng(1).integers(
            0, cfg.vocab_size, (2, 8)))
        with torch.no_grad():
            loss = bundle.loss(params, {"tokens": toks, "labels": toks})
            logits, aux = TT._forward(params, cfg, toks, None, True)
        assert loss.dim() == 0 and bool(torch.isfinite(loss))
        assert float(aux) > 0
        ce = TT.emb.cross_entropy(logits, toks)
        assert torch.equal(loss, ce + 0.01 * aux)


# --- modules -----------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_norms_match_reference(dtype):
    """RMSNorm and LayerNorm (with and without bias) compute in float32 and
    cast back to the input's dtype."""
    a = np.random.default_rng(7).standard_normal((3, 5, 64)).astype(
        np.float32) * 3 + 0.5
    w = np.random.default_rng(8).standard_normal(64).astype(np.float32)
    b = np.random.default_rng(9).standard_normal(64).astype(np.float32)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jx, jw, jb = (jnp.asarray(v).astype(jdt) for v in (a, w, b))
    tx, tw, tb = _t(jx), _t(jw), _t(jb)
    cases = [(JC.rmsnorm(jx, jw), TC.rmsnorm(tx, tw)),
             (JC.layernorm(jx, jw, jb), TC.layernorm(tx, tw, tb)),
             (JC.layernorm(jx, jw, None), TC.layernorm(tx, tw, None))]
    for want, got in cases:
        if dtype == "f32":
            _close_f32(got, want)
        else:
            check_close("norm", got, _t(want))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_matches_reference(dtype):
    """Angles up to position 4095 at theta 1e6 (qwen3-4b) and 1e4.  In
    float32 the tables agree within 1e-5 (rtol) / 1e-6 (atol), and in fact
    within 2**-23 absolute: sin/cos of angles up to 4095 rad differ
    between XLA and PyTorch by at most one float32 ulp of a value near 1.
    After the bf16 cast a few rotated elements differ, within 2 bf16
    ulps."""
    pos = np.arange(0, 4096, 7).astype(np.int32)
    for theta in (1e6, 1e4):
        js, jc = JROT.rope_angles(jnp.asarray(pos), 128, theta)
        ts, tc = TROT.rope_angles(torch.from_numpy(pos), 128, theta)
        _close_f32(ts, js)
        _close_f32(tc, jc)
        for got, want in ((ts, js), (tc, jc)):
            assert float((got - _t(want)).abs().max()) <= 2.0**-23
        jx = jnp.asarray(np.random.default_rng(10).standard_normal(
            (1, len(pos), 2, 128)).astype(np.float32))
        if dtype == "bf16":
            jx = jx.astype(jnp.bfloat16)
        want = JROT.apply_rope(jx, jnp.asarray(pos), theta)
        got = TROT.apply_rope(_t(jx), torch.from_numpy(pos), theta)
        if dtype == "f32":
            _close_f32(got, want)
        else:
            check_close("rope", got, _t(want))


def test_activations_equal_the_jitted_reference():
    """bf16 SiLU and tanh-GELU, written op by op, equal the jitted
    reference's on 400k values (XLA rounds after every op; ROADMAP Queue
    3, F5); in float32 they agree within the float32 rule."""
    a = np.random.default_rng(17).standard_normal(400_000).astype(
        np.float32) * 3
    for jdt, exact in ((jnp.bfloat16, True), (jnp.float32, False)):
        jx = jnp.asarray(a).astype(jdt)
        for jf, tf in ((jax.nn.silu, TM.silu), (jax.nn.gelu, TM.gelu)):
            want, got = jax.jit(jf)(jx), tf(_t(jx))
            if exact:
                assert torch.equal(got, _t(want))
            else:
                _close_f32(got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_silu_gradient_past_exp_overflow(dtype):
    """SiLU's gradient equals ``jax.grad`` of ``jax.nn.silu`` (the
    logistic's derivative ``s (1 - s)``) from -200 to 200: finite where
    ``exp(-x)`` overflows (x < -88), which autograd of ``1 / (1 +
    exp(-x))`` turns into NaN.  float32 within 1e-6 of the largest |ref|;
    bf16 within 2 bf16 ulps of it."""
    a = np.linspace(-200, 200, 4001).astype(np.float32)
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    jx = jnp.asarray(a).astype(jdt)
    want = _t(jax.jit(jax.vmap(jax.grad(jax.nn.silu)))(jx))
    x = _t(jx).requires_grad_(True)
    got, = torch.autograd.grad(TM.silu(x).sum(), x)
    assert got.dtype == want.dtype and bool(torch.isfinite(got).all())
    top = float(want.float().abs().max())
    bound = 1e-6 * top if dtype == "f32" else 2 * 2.0**(
        math.floor(math.log2(top)) - 7)
    assert float((got.float() - want.float()).abs().max()) <= bound


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_reference(kind):
    """bf16 MLP (GELU is the tanh approximation on both sides), plain and
    with int8 weights."""
    p, _ = {}, {}
    JM.mlp_init(jax.random.PRNGKey(2), 64, 128, kind, p, {})
    jx, tx = _bf16_pair((2, 5, 64), 11)
    tp = convert.params_from_numpy(jax.device_get(p))
    check_close(kind, TM.mlp_apply(tp, tx, kind), _t(JM.mlp_apply(p, jx, kind)))
    qp = {k: JQ.quantize_weight(v) for k, v in p.items()}
    tqp = {k: TQ.quantize_weight(v) for k, v in tp.items()}
    _check_tree_equal(tqp, convert.params_from_numpy(jax.device_get(qp)))
    check_close(kind + " int8", TM.mlp_apply(tqp, tx, kind),
                _t(JM.mlp_apply(qp, jx, kind)))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_decode_attention_matches_reference(quantized):
    """One query against a 40-position cache holding 29 valid positions,
    GQA 4:2; the int8 cache carries per-(pos, head) scales."""
    jq, tq = _bf16_pair((2, 1, 4, 32), 12)
    jk, tk = _bf16_pair((2, 40, 2, 32), 13, scale=2.0)
    jv, tv = _bf16_pair((2, 40, 2, 32), 14)
    if quantized:
        jk, jks = JA.quantize_kv(jk)
        jv, jvs = JA.quantize_kv(jv)
        tk, tks = TA.quantize_kv(tk)
        tv, tvs = TA.quantize_kv(tv)
        jks, jvs = jks.astype(jnp.float16), jvs.astype(jnp.float16)
        tks, tvs = _t(jks), _t(jvs)
        tk, tv = _t(jk), _t(jv)  # the same cache on both sides
    else:
        jks = jvs = tks = tvs = None
    for window in (0, 8):
        want = JA.decode_attention(jq, jk, jv, jnp.int32(29), window=window,
                                   k_scale=jks, v_scale=jvs)
        got = TA.decode_attention(tq, tk, tv, 29, window=window, k_scale=tks,
                                  v_scale=tvs)
        check_close(f"decode window={window}", got, _t(want))
        got = TA.decode_attention(tq, tk, tv, torch.tensor([29, 29]),
                                  window=window, k_scale=tks, v_scale=tvs)
        check_close(f"decode window={window} (B,) length", got, _t(want))


@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
def test_caches_match_reference_layout(quantized):
    """``attention.init_cache`` and ``transformer.init_decode_cache`` hold
    the reference's leaves, shapes, dtypes and initial values."""
    cfg = JR.get_config("qwen3-4b", smoke=True)
    spec = dict(max_len=12, kv_heads=2, head_dim=16, quantized=quantized)
    want = jax.device_get(JA.init_cache(3, 2, JA.CacheSpec(**spec)))
    got = TA.init_cache(3, 2, TA.CacheSpec(**spec))
    _check_tree_equal(got, convert.params_from_numpy(want))
    want = jax.device_get(JT.init_decode_cache(cfg, 3, 12,
                                               quantized=quantized))
    got = TT.init_decode_cache(TR.get_config("qwen3-4b", smoke=True), 3, 12,
                               quantized=quantized)
    assert got["len"] == int(want["len"]) == 0
    _check_tree_equal(got["main"], convert.params_from_numpy(want["main"]))


def test_quantize_kv_equals_the_jitted_reference():
    """Equal to the reference as its decode step runs it, under jit, where
    XLA turns ``max|k| / 127`` into ``max|k| * f32(1/127)`` (ROADMAP Queue
    3, F4); the eager reference divides and gives other scales."""
    jk, tk = _bf16_pair((4, 64, 8, 128), 15, scale=3.0)
    jq, js = jax.jit(JA.quantize_kv)(jk)
    tq, ts = TA.quantize_kv(tk)
    assert torch.equal(tq, _t(jq)) and torch.equal(ts, _t(js))
    _, es = JA.quantize_kv(jk)
    assert not torch.equal(ts, _t(es))  # the eager reference differs
    np.testing.assert_array_equal(
        TA.dequantize_kv(tq, ts).float().numpy(),
        np.asarray(JA.dequantize_kv(jq, js).astype(jnp.float32)))


def test_quantize_param_tree_and_emb_paths_equal_reference():
    """The whole qwen3-4b-smoke tree (stacked layers, untied head, the
    embedding per row) quantizes to the reference's int8 and scales
    exactly, as the reference launcher runs it (eagerly); the int8
    embedding lookup and tied logits then match."""
    cfg = JR.get_config("qwen3-4b", smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(3))
    jq = JQT.quantize_param_tree(params)
    tq = TQT.quantize_param_tree(convert.params_from_numpy(
        jax.device_get(params)))
    _check_tree_equal(tq, convert.params_from_numpy(jax.device_get(jq)))
    # at smoke widths the MLP, the embedding and the head reach 2**14
    # elements; wq (2 x 64 x 64) and the norms stay bf16
    assert TQ.is_quant(tq["layers"]["mlp_gate"]) and TQ.is_quant(
        tq["embedding"]) and TQ.is_quant(tq["lm_head"])
    assert not TQ.is_quant(tq["layers"]["wq"])
    ids = np.array([[0, 5, 255], [7, 7, 1]], np.int32)
    check_close("emb_lookup", TQ.emb_lookup(tq["embedding"],
                                            torch.from_numpy(ids)),
                _t(JQ.emb_lookup(jq["embedding"], jnp.asarray(ids))))
    jx, tx = _bf16_pair((2, 3, cfg.d_model), 16)
    check_close("emb_logits", TQ.emb_logits(tq["embedding"], tx),
                _t(JQ.emb_logits(jq["embedding"], jx)))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_cli_runs_on_cpu(quant):
    """``serve --arch qwen3-4b --smoke --device cpu``: the static path,
    no kernel launched (decode never reaches flash attention)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", "qwen3-4b", "--smoke", "--quant", quant,
                     "--batch", "2", "--prompt-len", "5", "--gen", "4",
                     "--max-len", "16", "--device", "cpu"])
    text = out.getvalue()
    assert "prompt tokens/s:" in text and "decode tokens/s:" in text
    assert "flash_attention=0" in text
    sample = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    assert len(sample) == 1 and len(eval(sample[0][len("sample:"):])) == 4


def _clear(logits):
    """Rows whose top-2 margin exceeds 2 % of the row's largest |logit|."""
    two = torch.topk(logits, 2, dim=-1).values
    return (two[:, 0] - two[:, 1]) > 0.02 * logits.abs().amax(-1)


def test_serve_matches_reference_greedy_loop():
    """The static serve (the prompt teacher-forced through decode, then 4
    greedy tokens) on the carried qwen3-4b-smoke weights, against the
    reference's decode run the same way: each row's tokens are equal as
    long as every greedy choice so far had a clear margin (2 % of the
    row's largest |logit|); where all did, the last logits match too."""
    cfg = JR.get_config("qwen3-4b", smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(0))
    t_params = convert.params_from_numpy(jax.device_get(params))
    tcfg = TR.get_config("qwen3-4b", smoke=True)
    prompt = _tokens(cfg, 2, 5, seed=8)
    res = tserve.serve_bundle(TZ.build(tcfg), t_params,
                              torch.from_numpy(prompt), 4, 16)
    decode = jax.jit(lambda p, t, s: JT.decode_step(p, cfg, t, s,
                                                    NO_CONSTRAIN))
    state = JT.init_decode_cache(cfg, 2, 16)
    for t in range(prompt.shape[1]):
        logits, state = decode(params, jnp.asarray(prompt[:, t:t + 1]), state)
    ok = _clear(_t(logits).float())
    tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    for i in range(4):
        logits, state = decode(params, tok, state)
        tok = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        ok = ok & _clear(_t(logits).float())
        assert torch.equal(res.tokens[:, i][ok], _t(tok)[:, 0].long()[ok])
    if bool(ok.all()):
        check_logits("last decode step", res.logits, _t(logits))
