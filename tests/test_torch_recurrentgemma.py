"""The port's hybrid family (recurrentgemma-9b: ``layers/recurrent.py``,
``models/recurrentgemma.py``) against the JAX package, on the CPU.

Weights are drawn by the reference (``model_zoo.build(cfg).init``) at
smoke width (3 layers: rec, rec, attn; window 32) and carried across with
``repro_torch.convert``; inputs come from numpy seeds; the reference runs
jitted.  The jitted reference unrolls the layers, and XLA then hands every
residual sum to the next norm unrounded and keeps the logistic's last
division and ``i * x`` unrounded where the scan casts them to float32
(ROADMAP Queue 3, F6): the port computes them so, and its smoke logits
equal the jitted reference's bit for bit.  Tolerances
(``repro_torch.testing.attention_checks``):

* float32 modules (the scan, the loss): ``rtol 1e-5, atol 1e-6``;
* bf16 modules: 2 bf16 ulps of the row's largest ``|ref|`` (F3);
* whole models: every logit within 1 % of its row's largest ``|logit|``,
  the argmax equal wherever the reference's top-2 margin exceeds 2 %;
* ``quantize_param_tree``: equal.

At S 1100 the attention layer runs ``flash_attention`` (more than 1024
positions), held there with float32 weights by the float32 rule, where the
point is the algorithm, as the dense transformer's test does (F7).  int8
is held at a widened config (d_model = d_rnn = 512, head_dim 32), where
every listed
weight (``rg_*``, ``wq``..``wo``, the MLP, the embedding and the head)
reaches the 2**14 elements that ``quantize_param_tree`` asks for.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.layers import recurrent as JREC  # noqa: E402
from repro.models import recurrentgemma as JRG  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.layers import recurrent as TREC  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import recurrentgemma as TRG  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    check_close, check_logits)
from torch_family_checks import (  # noqa: E402
    NO_CONSTRAIN, bf16_pair, check_cli, check_decode, check_loss,
    check_loss_and_grads, check_round_trip, check_serve_bundle, close_f32,
    leaf_names, quantized_pair, reference_params, t, tokens, widened)

torch.set_num_threads(1)

ARCH = "recurrentgemma-9b"
INT8_NAMES = {"rg_in", "rg_gate_r", "rg_gate_i", "rg_out", "wq", "wk", "wv",
              "wo", "mlp_gate", "mlp_up", "mlp_down", "embedding", "lm_head"}


@pytest.fixture(scope="module")
def model():
    cfg = JR.get_config(ARCH, smoke=True)
    params, t_params = reference_params(cfg)
    return cfg, TR.get_config(ARCH, smoke=True), params, t_params


def test_layer_counts_and_tree(model):
    """38 layers are 26 recurrent and 12 attention layers; the port's own
    init of the smoke config gives the reference's two stacks, with their
    keys, shapes and dtypes, and the reference's ``rg_lambda``."""
    assert TRG._layer_counts(TR.get_config(ARCH)) == JRG._layer_counts(
        JR.get_config(ARCH)) == (26, 12)
    _, tcfg, _, ref = model
    mine = TZ.build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    for stack in ("rec_layers", "attn_layers"):
        assert mine[stack].keys() == ref[stack].keys()
        for k, v in ref[stack].items():
            assert (mine[stack][k].shape, mine[stack][k].dtype) == (
                v.shape, v.dtype), k
    assert torch.equal(mine["rec_layers"]["rg_lambda"],
                       ref["rec_layers"]["rg_lambda"])


@pytest.mark.parametrize("stateful", [False, True], ids=["zero", "carried"])
def test_rglru_scan_matches_reference(stateful):
    """``_rglru_scan`` in float32 over 40 steps, from zeros and from a
    carried state; the gate inputs are bf16, as the block passes them."""
    jx, tx = bf16_pair((2, 40, 24), 1)
    jr, tr = bf16_pair((2, 40, 24), 2)
    ji, ti = bf16_pair((2, 40, 24), 3)
    jr, ji = jax.nn.sigmoid(jr), jax.nn.sigmoid(ji)
    tr, ti = t(jr), t(ji)
    lam = np.random.default_rng(0).uniform(0.9, 0.999, 24)
    la = np.log(lam / (1 - lam)).astype(np.float32)
    h0 = np.random.default_rng(4).standard_normal((2, 24)).astype(np.float32)
    want_y, want_h = jax.jit(JREC._rglru_scan)(
        jx, jr, ji, jnp.asarray(la), jnp.asarray(h0) if stateful else None)
    got_y, got_h = TREC._rglru_scan(
        tx, tr.float(), ti, torch.from_numpy(la),
        torch.from_numpy(h0) if stateful else None)
    close_f32(got_y, want_y)
    close_f32(got_h, want_h)


@pytest.mark.parametrize("stateful", [False, True], ids=["prefill", "decode"])
def test_rglru_apply_matches_reference(model, stateful):
    """Recurrent layer 0's RG-LRU block on bf16 inputs (5 steps), without
    a state and from a nonzero state and conv cache."""
    cfg, _, params, t_params = model
    p = jax.tree_util.tree_map(lambda a: a[0], params["rec_layers"])
    tp = {k: v[0] for k, v in t_params["rec_layers"].items()}
    jx, tx = bf16_pair((2, 5, cfg.d_model), 6)
    js = ts = None
    if stateful:
        jh, th = bf16_pair((2, cfg.d_rnn), 7)
        jc, tc = bf16_pair((2, cfg.d_conv - 1, cfg.d_rnn), 8)
        js = {"h": jh.astype(jnp.float32), "conv": jc}
        ts = {"h": th.float(), "conv": tc}
    want, want_st = jax.jit(JREC.rglru_apply)(p, jx, js)
    got, got_st = TREC.rglru_apply(tp, tx, ts)
    check_close("rglru_apply", got, t(want))
    if stateful:
        close_f32(got_st["h"], want_st["h"])
        assert torch.equal(got_st["conv"], t(want_st["conv"]))


@pytest.mark.parametrize("S,dtype", [(16, "bf16"), (16, "f32"),
                                     (1100, "f32")])
def test_forward_and_prefill_match_reference(model, S, dtype, monkeypatch):
    """The whole forward and the prefill's last row against the jitted
    reference; flash attention runs in the attention layer exactly when
    S > 1024, once in each pass."""
    cfg, tcfg, params, t_params = model
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
        t_params = convert.params_from_numpy(jax.device_get(params))
    B = 2 if S <= 1024 else 1
    toks = tokens(cfg.vocab_size, B, S, seed=S)
    want = jax.jit(lambda p, tk: JRG.forward(p, cfg, tk, NO_CONSTRAIN)[0])(
        params, jnp.asarray(toks))
    calls = []
    real = FA.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(FA, "flash_attention", spy)
    with torch.no_grad():
        got, _ = TRG.forward(t_params, tcfg, torch.from_numpy(toks))
        last = TRG.prefill(t_params, tcfg, torch.from_numpy(toks))
    n_attn = TRG._layer_counts(tcfg)[1]
    assert len(calls) == (2 * n_attn if S > 1024 else 0)
    if dtype == "f32":
        close_f32(got, want)
        close_f32(last, np.asarray(want)[:, -1])
    else:
        check_logits(f"forward S={S}", got, t(want))
        check_logits(f"prefill S={S}", last, t(want)[:, -1])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_decode_matches_reference_and_prefill(model, quant):
    """Teacher-forced ``decode_step`` over 6 tokens against the jitted
    reference step by step, its states and caches, and its last logits
    against the prefill of the same prompt; int8 at the widened config."""
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        cfg = widened(cfg, d_model=512, d_rnn=512, head_dim=32)
        tcfg = widened(tcfg, d_model=512, d_rnn=512, head_dim=32)
        params, t_params = quantized_pair(*reference_params(cfg))
        assert leaf_names(t_params, quantized=True) == INT8_NAMES
    toks = tokens(cfg.vocab_size, 2, 6, seed=3)
    last, j_prefill, t_state, j_state = check_decode(
        cfg, tcfg, params, t_params, toks, max_len=16)
    check_logits("decode vs prefill", last, j_prefill)
    close_f32(t_state["rec"]["h"], j_state["rec"]["h"])
    assert torch.equal(t_state["rec"]["conv"], t(j_state["rec"]["conv"]))
    for key in ("k", "v"):
        check_close(f"{key} cache", t_state["attn"][key],
                    t(j_state["attn"][key]))


def test_window_cache_wraps_like_reference(model):
    """``init_state`` clamps the attention cache to ``min(window,
    max_len)``: with max_len 4 the 6 decoded positions wrap the ring
    buffer, as the reference's do."""
    cfg, tcfg, params, t_params = model
    assert TZ.build(tcfg).init_state(2, 4, device="cpu")["attn"]["k"].shape[
        2] == 4
    assert TZ.build(tcfg).init_state(2, 4096, device="cpu")["attn"][
        "k"].shape[2] == tcfg.attn_window
    toks = tokens(cfg.vocab_size, 2, 6, seed=4)
    check_decode(cfg, tcfg, params, t_params, toks, max_len=4)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_matches_reference(model, dtype):
    cfg, tcfg, params, _ = model
    check_loss(cfg, tcfg, params, dtype)


def test_loss_and_grads_match_reference(model):
    """The loss and every gradient at S 1100, where the attention layer runs
    flash attention with its window through ``FlashAttention``, against
    ``jax.value_and_grad`` of the jitted reference on float32 weights."""
    cfg, tcfg, params, _ = model
    batch = {"tokens": tokens(cfg.vocab_size, 1, 1100, seed=31),
             "labels": tokens(cfg.vocab_size, 1, 1100, seed=32)}
    check_loss_and_grads(cfg, tcfg, params, batch)


def test_serve_fns_prefill_matches_reference(model):
    """``make_serve_fns``'s prefill, the bundle's entry point, by the
    whole-model rule."""
    cfg, tcfg, params, t_params = model
    toks = tokens(cfg.vocab_size, 2, 16, seed=11)
    prefill_fn, _ = train_loop.make_serve_fns(TZ.build(tcfg), "cpu", 2, 16)
    want = jax.jit(lambda p, tk: JRG.prefill(p, cfg, tk, NO_CONSTRAIN))(
        params, jnp.asarray(toks))
    check_logits("prefill_fn", prefill_fn(
        t_params, {"tokens": torch.from_numpy(toks)}), t(want))


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_bundle_matches_reference_greedy(model, quant):
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        cfg = widened(cfg, d_model=512, d_rnn=512, head_dim=32)
        tcfg = widened(tcfg, d_model=512, d_rnn=512, head_dim=32)
        params, t_params = reference_params(cfg)
    check_serve_bundle(cfg, tcfg, params, t_params, quant)


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_serve_cli_runs_on_cpu(quant):
    check_cli(ARCH, quant)


def test_tree_round_trips_through_convert(model):
    _, _, params, t_params = model
    check_round_trip(params, t_params)
