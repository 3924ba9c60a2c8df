"""The port's enc-dec family (whisper-tiny, ``models/whisper.py``) against
the JAX package, on the CPU.

Weights are drawn by the reference (``model_zoo.build(cfg).init``) at
smoke width and carried across with ``repro_torch.convert`` (the layers
are lists of dicts in both trees); frames and tokens come from numpy
seeds; the reference runs jitted.  ``N_FRAMES`` is 16 in both packages
here, as the reference's smoke test patches it.  The jitted reference
unrolls the layers and every residual sum reaches the next LayerNorm
unrounded (ROADMAP Queue 3, F6); the port computes it so.  Tolerances
(``repro_torch.testing.attention_checks``):

* float32 modules (the loss; the model with float32 weights):
  ``rtol 1e-5, atol 1e-6``;
* bf16 modules: 2 bf16 ulps of the row's largest ``|ref|`` (F3);
* whole models: every logit within 1 % of its row's largest ``|logit|``,
  the argmax equal wherever the reference's top-2 margin exceeds 2 %;
* ``quantize_param_tree``: equal.

Decode reads the cross-attention cache that ``init_decode_state`` makes
and never fills, zeros (R8), in both packages: decode is held against the
reference's decode, not against the prefill.  int8 is held at a widened
config (d_model 512), where the self- and cross-attention projections, the
MLP and the embedding all reach the 2**14 elements of the rule.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.models import whisper as JW  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import whisper as TW  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    check_close, check_logits)
from torch_family_checks import (  # noqa: E402
    NO_CONSTRAIN, bf16_pair, check_cli, check_decode, check_loss,
    check_round_trip, check_serve_bundle, close_f32, leaf_names,
    quantized_pair, reference_params, t, tokens, widened)

torch.set_num_threads(1)

ARCH = "whisper-tiny"
FRAMES = 16
INT8_NAMES = {f"{p}_{w}" for p in ("self", "cross")
              for w in ("wq", "wk", "wv", "wo")} | {"mlp_up", "mlp_down",
                                                     "embedding"}


@pytest.fixture(scope="module", autouse=True)
def short_frames():
    """Both packages' ``N_FRAMES`` at 16 for this module's tests."""
    saved = JW.N_FRAMES, TW.N_FRAMES
    JW.N_FRAMES = TW.N_FRAMES = FRAMES
    yield
    JW.N_FRAMES, TW.N_FRAMES = saved


@pytest.fixture(scope="module")
def model(short_frames):
    cfg = JR.get_config(ARCH, smoke=True)
    params, t_params = reference_params(cfg)
    return cfg, TR.get_config(ARCH, smoke=True), params, t_params


def _frames(cfg, B, seed, dtype=jnp.bfloat16):
    j, _ = bf16_pair((B, FRAMES, cfg.d_model), seed)
    j = j.astype(dtype)
    return j, t(j)


def test_init_tree_matches_reference(model):
    """The port's own init: the reference's keys, list lengths, shapes and
    dtypes, and the reference's sinusoidal encoder positions bit for
    bit."""
    _, tcfg, _, ref = model
    mine = TZ.build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    assert mine.keys() == ref.keys()
    for key in ("enc_layers", "dec_layers"):
        assert len(mine[key]) == len(ref[key])
        for a, b in zip(mine[key], ref[key]):
            assert a.keys() == b.keys()
            for k in b:
                assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype)
    for k in ("embedding", "pos_dec", "pos_enc"):
        assert (mine[k].shape, mine[k].dtype) == (ref[k].shape, ref[k].dtype)
    assert torch.equal(mine["pos_enc"], ref["pos_enc"])


@pytest.mark.parametrize("kind", ["self-causal", "self", "cross"])
def test_mha_matches_reference(model, kind):
    """Decoder layer 0's attention (no cache) on bf16 inputs: causal and
    bidirectional self-attention over 9 positions, cross-attention over
    the 16 frames."""
    cfg, _, params, t_params = model
    p, tp = params["dec_layers"][0], t_params["dec_layers"][0]
    jx, tx = bf16_pair((2, 9, cfg.d_model), 1)
    jkv, tkv = bf16_pair((2, FRAMES, cfg.d_model), 2)
    prefix = "cross" if kind == "cross" else "self"
    causal = kind == "self-causal"
    want, _ = jax.jit(lambda p, x, kv: JW._mha(
        p, prefix, x, kv, cfg.n_heads, causal))(
            p, jx, jkv if prefix == "cross" else None)
    got, _ = TW._mha(tp, prefix, tx, tkv if prefix == "cross" else None,
                     cfg.n_heads, causal)
    check_close(f"_mha {kind}", got, t(want))


def test_mha_takes_flash_past_2048_keys(model, monkeypatch):
    """Self-attention over 2100 positions runs ``flash_attention`` (the
    reference's own threshold: more than 2048 keys), held with float32
    weights by the float32 rule."""
    cfg, _, params, _ = model
    p = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                               params["dec_layers"][0])
    tp = convert.params_from_numpy(jax.device_get(p))
    x = np.random.default_rng(3).standard_normal(
        (1, 2100, cfg.d_model)).astype(np.float32)
    want, _ = jax.jit(lambda p, x: JW._mha(p, "self", x, None, cfg.n_heads,
                                           True))(p, jnp.asarray(x))
    calls = []
    real = FA.flash_attention

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(FA, "flash_attention", spy)
    got, _ = TW._mha(tp, "self", torch.from_numpy(x), None, cfg.n_heads,
                     True)
    assert len(calls) == 1
    close_f32(got, want)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_encode_decode_and_prefill_match_reference(model, dtype):
    """The encoder's output, the decoder's logits at S 16 and the
    prefill's last row (through ``make_serve_fns``) against the jitted
    reference."""
    cfg, tcfg, params, t_params = model
    fdt = jnp.bfloat16
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
        t_params = convert.params_from_numpy(jax.device_get(params))
        fdt = jnp.float32
    jf, tf = _frames(cfg, 2, 5, fdt)
    toks = tokens(cfg.vocab_size, 2, 16, seed=16)
    enc, logits = jax.jit(lambda p, tk, f: (
        JW.encode(p, cfg, f, NO_CONSTRAIN),
        JW.decode_train(p, cfg, tk, JW.encode(p, cfg, f, NO_CONSTRAIN),
                        NO_CONSTRAIN)))(params, jnp.asarray(toks), jf)
    prefill_fn, _ = train_loop.make_serve_fns(TZ.build(tcfg), "cpu", 2, 16)
    with torch.no_grad():
        t_enc = TW.encode(t_params, tcfg, tf)
        got = TW.decode_train(t_params, tcfg, torch.from_numpy(toks), t_enc)
    last = prefill_fn(t_params, {"tokens": torch.from_numpy(toks),
                                 "frontend_embeds": tf})
    if dtype == "f32":
        close_f32(t_enc, enc)
        close_f32(got, logits)
        close_f32(last, np.asarray(logits)[:, -1])
    else:
        check_close("encode", t_enc, t(enc))
        check_logits("decode_train", got, t(logits))
        check_logits("prefill", last, t(logits)[:, -1])


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_decode_matches_reference(model, quant):
    """Teacher-forced ``decode_step`` over 6 tokens against the jitted
    reference's step by step, and the self-attention caches it writes;
    int8 at the widened config."""
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        cfg, tcfg = widened(cfg, d_model=512), widened(tcfg, d_model=512)
        params, t_params = quantized_pair(*reference_params(cfg))
        assert leaf_names(t_params, quantized=True) == INT8_NAMES
    toks = tokens(cfg.vocab_size, 2, 6, seed=3)
    jf, _ = _frames(cfg, 2, 5)
    _, _, t_state, j_state = check_decode(cfg, tcfg, params, t_params, toks,
                                          max_len=16, frames=jf)
    for got, want in zip(t_state["self"], j_state["self"]):
        for key in ("k", "v"):
            check_close(f"self {key} cache", got[key], t(want[key]))
    for got in t_state["cross"]:  # never filled, as in the reference
        assert not got["k"].any() and not got["v"].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_loss_matches_reference(model, dtype):
    cfg, tcfg, params, _ = model
    jf, _ = _frames(cfg, 2, 5, jnp.float32 if dtype == "f32"
                    else jnp.bfloat16)
    check_loss(cfg, tcfg, params, dtype,
               extra={"frontend_embeds": np.asarray(jf)})


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
