"""The port's ssm family (falcon-mamba-7b, ``layers/ssm.py``,
``models/mamba.py``) and ``common.causal_conv1d`` against the JAX package,
on the CPU.

Weights are drawn by the reference (``model_zoo.build(cfg).init``) at
smoke width and carried across with ``repro_torch.convert``; inputs come
from numpy seeds; the reference runs jitted (XLA keeps a bf16 product
that is cast to float32 unrounded, ROADMAP Queue 3, F6).  Tolerances
(``repro_torch.testing.attention_checks``):

* float32 modules (the scan, the loss): ``rtol 1e-5, atol 1e-6``;
* bf16 modules: 2 bf16 ulps of the row's largest ``|ref|`` (F3);
* whole models: every logit within 1 % of its row's largest ``|logit|``,
  the argmax equal wherever the reference's top-2 margin exceeds 2 %;
* ``quantize_param_tree``: equal.

int8 is held at a widened config (d_model 512), where ``in_proj``,
``x_proj``, ``dt_proj``, ``out_proj``, the embedding and the head all
reach the 2**14 elements that ``quantize_param_tree`` asks for.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.layers import common as JC  # noqa: E402
from repro.layers import ssm as JS  # noqa: E402
from repro.models import mamba as JM  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.layers import common as TC  # noqa: E402
from repro_torch.layers import ssm as TS  # noqa: E402
from repro_torch.models import mamba as TM  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    check_close, check_logits)
from torch_family_checks import (  # noqa: E402
    NO_CONSTRAIN, bf16_pair, check_cli, check_decode, check_loss,
    check_loss_and_grads, check_round_trip, check_serve_bundle, close_f32,
    leaf_names, quantized_pair, reference_params, t, tokens, widened)

torch.set_num_threads(1)

ARCH = "falcon-mamba-7b"
INT8_NAMES = {"in_proj", "x_proj", "dt_proj", "out_proj", "embedding",
              "lm_head"}


@pytest.fixture(scope="module")
def model():
    cfg = JR.get_config(ARCH, smoke=True)
    params, t_params = reference_params(cfg)
    return cfg, TR.get_config(ARCH, smoke=True), params, t_params


@pytest.mark.parametrize("cached", [False, True], ids=["zero-pad", "cache"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_causal_conv1d_matches_reference(cached, dtype):
    """The depthwise causal conv (K 4) over 7 steps, from zeros or from a
    (B, K-1, D) decode cache; the returned cache is the last K-1 inputs."""
    jx, tx = bf16_pair((2, 7, 24), 1)
    jw, tw = bf16_pair((4, 24), 2, scale=0.5)
    jb, tb = bf16_pair((24,), 3)
    jc, tc = bf16_pair((2, 3, 24), 4)
    if dtype == "f32":
        jx, jw, jb, jc = (a.astype(jnp.float32) for a in (jx, jw, jb, jc))
        tx, tw, tb, tc = (a.float() for a in (tx, tw, tb, tc))
    want, want_cache = JC.causal_conv1d(jx, jw, jb, jc if cached else None)
    got, got_cache = TC.causal_conv1d(tx, tw, tb, tc if cached else None)
    assert torch.equal(got_cache, t(want_cache))
    if dtype == "f32":
        close_f32(got, want)
    else:
        assert torch.equal(got, t(want))


def test_ssm_scan_matches_reference():
    """``_ssm_scan`` in float32 over 300 steps (two of the port's chunks),
    from zeros and from a carried state."""
    rng = np.random.default_rng(5)
    Bt, T, Di, N = 2, 300, 32, 8
    u = rng.standard_normal((Bt, T, Di)).astype(np.float32)
    delta = np.log1p(np.exp(rng.standard_normal((Bt, T, Di)))).astype(
        np.float32) * 0.1
    A = -np.exp(rng.standard_normal((Di, N))).astype(np.float32)
    B = rng.standard_normal((Bt, T, N)).astype(np.float32)
    C = rng.standard_normal((Bt, T, N)).astype(np.float32)
    h0 = rng.standard_normal((Bt, Di, N)).astype(np.float32)
    scan = jax.jit(JS._ssm_scan)
    for init in (None, h0):
        want_y, want_h = scan(*(jnp.asarray(a) for a in (u, delta, A, B, C)),
                              None if init is None else jnp.asarray(init))
        got_y, got_h = TS._ssm_scan(
            *(torch.from_numpy(a) for a in (u, delta, A, B, C)),
            None if init is None else torch.from_numpy(init))
        close_f32(got_y, want_y)
        close_f32(got_h, want_h)


@pytest.mark.parametrize("stateful", [False, True], ids=["prefill", "decode"])
def test_ssm_apply_matches_reference(model, stateful):
    """Layer 0's block on bf16 inputs (5 steps), without a state and from
    a nonzero state and conv cache, which it returns advanced."""
    cfg, _, params, t_params = model
    p = jax.tree_util.tree_map(lambda a: a[0], params["layers"])
    tp = {k: v[0] for k, v in t_params["layers"].items()}
    jx, tx = bf16_pair((2, 5, cfg.d_model), 6)
    js = ts = None
    if stateful:
        jh, th = bf16_pair((2, cfg.d_inner, cfg.d_state), 7)
        jc, tc = bf16_pair((2, cfg.d_conv - 1, cfg.d_inner), 8)
        js = {"h": jh.astype(jnp.float32), "conv": jc}
        ts = {"h": th.float(), "conv": tc}
    want, want_st = jax.jit(
        lambda p, x, s: JS.ssm_apply(p, x, s, cfg.d_state, cfg.dt_rank()))(
            p, jx, js)
    got, got_st = TS.ssm_apply(tp, tx, ts, cfg.d_state, cfg.dt_rank())
    check_close("ssm_apply", got, t(want))
    if stateful:
        close_f32(got_st["h"], want_st["h"])
        assert torch.equal(got_st["conv"], t(want_st["conv"]))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_forward_and_prefill_match_reference(model, dtype):
    """The whole forward (every position's logits) at S 16 and the
    prefill's last row, against the jitted reference."""
    cfg, tcfg, params, t_params = model
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
        t_params = convert.params_from_numpy(jax.device_get(params))
    toks = tokens(cfg.vocab_size, 2, 16, seed=16)
    want = jax.jit(lambda p, tk: JM.forward(p, cfg, tk, NO_CONSTRAIN)[0])(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = TM.forward(t_params, tcfg, torch.from_numpy(toks))
        last = TM.prefill(t_params, tcfg, torch.from_numpy(toks))
    if dtype == "f32":
        close_f32(got, want)
        close_f32(last, np.asarray(want)[:, -1])
    else:
        check_logits("forward", got, t(want))
        check_logits("prefill", last, t(want)[:, -1])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_decode_matches_reference_and_prefill(model, quant):
    """Teacher-forced ``decode_step`` over 6 tokens against the jitted
    reference's, step by step, its states, and its last logits against
    the prefill of the same prompt; int8 at the widened config, where
    every listed weight is quantized."""
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        cfg = widened(cfg, d_model=512)
        tcfg = widened(tcfg, d_model=512)
        params, t_params = quantized_pair(*reference_params(cfg))
        assert leaf_names(t_params, quantized=True) == INT8_NAMES
    toks = tokens(cfg.vocab_size, 2, 6, seed=3)
    last, j_prefill, t_state, j_state = check_decode(
        cfg, tcfg, params, t_params, toks, max_len=16)
    check_logits("decode vs prefill", last, j_prefill)
    close_f32(t_state["layers"]["h"], j_state["layers"]["h"])
    assert torch.equal(t_state["layers"]["conv"],
                       t(j_state["layers"]["conv"]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_matches_reference(model, dtype):
    cfg, tcfg, params, _ = model
    check_loss(cfg, tcfg, params, dtype)


def test_loss_and_grads_match_reference(model):
    """The loss and every gradient through the selective scan, against
    ``jax.value_and_grad`` of the jitted reference on float32 weights."""
    cfg, tcfg, params, _ = model
    batch = {"tokens": tokens(cfg.vocab_size, 1, 16, seed=31),
             "labels": tokens(cfg.vocab_size, 1, 16, seed=32)}
    check_loss_and_grads(cfg, tcfg, params, batch)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_bundle_matches_reference_greedy(model, quant):
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        cfg, tcfg = widened(cfg, d_model=512), widened(tcfg, d_model=512)
        params, t_params = reference_params(cfg)
    check_serve_bundle(cfg, tcfg, params, t_params, quant)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_cli_runs_on_cpu(quant):
    check_cli(ARCH, quant)


def test_tree_round_trips_through_convert(model):
    _, _, params, t_params = model
    check_round_trip(params, t_params)
