"""The port's MoE family (grok-1-314b, kimi-k2-1t-a32b: ``layers/moe.py``,
``qmm.expert_einsum``, the transformer's MoE layers, kimi's shared expert
and dense prefix) against the JAX package, on the CPU.

Weights are drawn by the reference (``model_zoo.build(cfg).init``) at
smoke width and carried across with ``repro_torch.convert``; inputs come
from numpy seeds; the reference runs jitted, its programs traced once per
module.  Tolerances:

* the MoE layer in bf16: equal bit for bit (the same products, the
  gate-weighted outputs added in the reference's scatter order, rounded at
  each add); in float32: within 2e-5 + 2e-5 ``|ref|`` (``attention_checks.
  check_close``; the float32 router and expert products sum in another
  order);
* whole models: every logit within 1 % of its row's largest ``|logit|``,
  the argmax equal wherever the reference's top-2 margin exceeds 2 % (F3,
  ``attention_checks.check_logits``; equal bit for bit at these seeds, but
  XLA's CPU norm flips a bf16 rounding now and then, which a router can
  carry to another expert: ROADMAP F10); in float32 ``rtol 1e-5, atol
  1e-6``;
* ``quantize_param_tree``: equal.

The capacity trait of ROADMAP Watch R9: an expert has ``capacity // E``
slots.  Where ``capacity`` is not a multiple of E the reference raises and
the port equals the reference at a capacity factor that gives the same
slots; when ``T * k < E`` every expert gets 0 slots, the port returns
zeros, and a kimi decode at B 1 equals the reference's with its MoE layer
read so.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JR  # noqa: E402
from repro.layers import moe as JMOE  # noqa: E402
from repro.layers import qmm as JQ  # noqa: E402
from repro.models import quant_transformer as JQT  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.layers import moe as TMOE  # noqa: E402
from repro_torch.layers import qmm as TQ  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import quant_transformer as TQT  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.runtime import train_loop  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    check_close, check_logits)
from torch_family_checks import (  # noqa: E402
    NO_CONSTRAIN, check_cli, check_decode, check_loss_and_grads,
    check_round_trip, check_serve_bundle, close_f32, quantized_pair,
    reference_params, t, tokens)

torch.set_num_threads(1)

ARCHS = ["grok-1-314b", "kimi-k2-1t-a32b"]
E, K, D, F = 4, 2, 64, 64  # the smoke configs' experts, top-k and widths


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    cfg = JR.get_config(request.param, smoke=True)
    params, t_params = reference_params(cfg)
    return cfg, TR.get_config(request.param, smoke=True), params, t_params


@pytest.fixture(scope="module")
def moe_layer():
    """One MoE layer's weights (E 4, d 64, ff 64) in both packages, bf16
    and int8, and the jitted reference layer."""
    p = {}
    JMOE.moe_init(jax.random.PRNGKey(5), D, F, E, p, {})
    jq = JQT.quantize_param_tree(p)
    tp = convert.params_from_numpy(jax.device_get(p))
    tq = TQT.quantize_param_tree(tp)
    for name, out in (("moe_gate", F), ("moe_up", F), ("moe_down", D)):
        assert TQ.is_quant(tq[name]) and tuple(tq[name]["s"].shape) == (E,
                                                                       out)
        assert torch.equal(tq[name]["q"], t(jq[name]["q"]))
        assert torch.equal(tq[name]["s"], t(jq[name]["s"]))
    apply = jax.jit(lambda p_, x_: JMOE.moe_apply_local(
        p_, x_, n_experts=E, topk=K, capacity_factor=1.25,
        ep_rank=jnp.int32(0), ep_size=1, model_axis=None))
    return {"bf16": (p, tp), "int8": (jq, tq)}, apply


def _to_f32(tree):
    return jax.tree_util.tree_map(
        lambda a: a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a,
        tree)


def _routed_tokens(case, T, seed):
    """x ``(T, d)``: random, or with a router-aligned part on the first E
    axes that sends token i to experts i and i + 1 (mod E), every expert
    taking T k / E assignments (``balanced``), or sends every token to
    expert 0 first (``skewed``, which overflows its capacity)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)).astype(np.float32) * 0.1
    if case == "balanced":
        for i in range(T):
            x[i, i % E] += 4.0
            x[i, (i + 1) % E] += 3.0
    else:
        x[:, 0] += 4.0
    return x


def _aligned_router(p):
    """The router with a large identity block on the first E axes, so the
    aligned part of the tokens decides the top k."""
    r = np.asarray(p["moe_router"]).copy()
    r[:E] += 8.0 * np.eye(E, dtype=np.float32)
    return dict(p, moe_router=jnp.asarray(r))


@pytest.mark.parametrize("weights", ["bf16", "int8"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,dropped", [("balanced", False),
                                          ("skewed", True)])
def test_moe_apply_local_matches_reference(moe_layer, case, dropped, dtype,
                                           weights):
    """The single-device layer, T 16 x k 2 over 4 experts (capacity 32, 8
    slots an expert): with balanced routing no assignment is dropped;
    with every token sent to expert 0 first it overflows and drops 8.
    bf16: equal bit for bit; float32: within 2e-5 + 2e-5 |ref|."""
    trees, apply = moe_layer
    jp, tp = trees[weights]
    jp = _aligned_router(jp)
    tp = dict(tp, moe_router=t(jp["moe_router"]))
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    if dtype == "f32":
        jp = _to_f32(jp)
        tp = convert.params_from_numpy(jax.device_get(jp))
    jx = jnp.asarray(_routed_tokens(case, 16, seed=7)).astype(jdt)
    _, idx = TMOE.route(t(jx), tp["moe_router"], K)
    counts = torch.bincount(idx.reshape(-1), minlength=E)
    cap = TMOE.capacity_of(16, K, 1.25, E) // E
    assert cap == 8 and bool((counts > cap).any()) == dropped, counts
    want = t(apply(jp, jx))
    got = TMOE.moe_apply_local(tp, t(jx), n_experts=E, topk=K,
                               capacity_factor=1.25)
    if dtype == "bf16":
        assert torch.equal(got, want)
    else:
        check_close(f"moe {case} {weights}", got, want)


def test_moe_drops_everything_when_T_k_below_E(moe_layer):
    """T 1 x k 2 < E 4: the capacity formula gives every expert 0 slots.
    The reference raises (it reshapes 2 capacity rows into (4, 0, 64));
    the port drops every assignment and returns zeros (ROADMAP Watch
    R9)."""
    trees, apply = moe_layer
    jp, tp = trees["bf16"]
    jx = jnp.asarray(_routed_tokens("skewed", 1, seed=8)).astype(
        jnp.bfloat16)
    with pytest.raises(TypeError, match="reshape"):
        apply(jp, jx)
    assert TMOE.capacity_of(1, K, 1.25, E) // E == 0
    got = TMOE.moe_apply_local(tp, t(jx), n_experts=E, topk=K,
                               capacity_factor=1.25)
    assert got.dtype == torch.bfloat16 and not bool(got.any())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_moe_capacity_off_the_expert_grid(moe_layer, dtype):
    """T 15 x k 2 over 4 experts: capacity min(36, 30) = 30 is not a
    multiple of 4, and the reference raises (it reshapes 30 rows into (4,
    7, 64)); the port gives each expert 30 // 4 = 7 slots, which equals
    the reference at the capacity factor that gives it 7 slots too (1.0:
    capacity 28), bit for bit in bf16, within 2e-5 + 2e-5 |ref| in float32
    (ROADMAP Watch R9)."""
    trees, apply = moe_layer
    jp, tp = trees["bf16"]
    jdt = jnp.bfloat16
    if dtype == "f32":
        jp, jdt = _to_f32(jp), jnp.float32
        tp = convert.params_from_numpy(jax.device_get(jp))
    jx = jnp.asarray(_routed_tokens("skewed", 15, seed=12)).astype(jdt)
    with pytest.raises(TypeError, match="reshape"):
        apply(jp, jx)
    assert TMOE.capacity_of(15, K, 1.25, E) == 30
    want = jax.jit(lambda p_, x_: JMOE.moe_apply_local(
        p_, x_, n_experts=E, topk=K, capacity_factor=1.0,
        ep_rank=jnp.int32(0), ep_size=1, model_axis=None))(jp, jx)
    got = TMOE.moe_apply_local(tp, t(jx), n_experts=E, topk=K,
                               capacity_factor=1.25)
    if dtype == "bf16":
        assert torch.equal(got, t(want))
    else:
        check_close("moe 7 slots", got, t(want))


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_expert_einsum_matches_reference(moe_layer, weights):
    """The batched expert product ``ecd,edf->ecf`` (int8: the (E, out)
    scales over the capacity axis): equal bit for bit in bf16."""
    trees, _ = moe_layer
    jp, tp = trees[weights]
    a = np.random.default_rng(9).standard_normal((E, 5, D)).astype(
        np.float32)
    jx = jnp.asarray(a).astype(jnp.bfloat16)
    want = jax.jit(lambda x, w: JQ.expert_einsum("ecd,edf->ecf", x, w))(
        jx, jp["moe_gate"])
    assert torch.equal(TQ.expert_einsum(t(jx), tp["moe_gate"]), t(want))


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_forward_and_prefill_match_reference(model, dtype):
    """The whole forward (every position's logits) at S 16 and the
    prefill's last row against the jitted reference: grok's two MoE layers
    (SwiGLU experts though its mlp_type is gelu), kimi's dense layer and
    MoE layer with its shared expert."""
    cfg, tcfg, params, t_params = model
    if dtype == "f32":
        params = _to_f32(params)
        t_params = convert.params_from_numpy(jax.device_get(params))
    toks = tokens(cfg.vocab_size, 2, 16, seed=16)
    want = jax.jit(lambda p, tk: JT.forward(p, cfg, tk, NO_CONSTRAIN)[0])(
        params, jnp.asarray(toks))
    with torch.no_grad():
        got = TT.forward(t_params, tcfg, torch.from_numpy(toks))
        last = TT.prefill(t_params, tcfg, torch.from_numpy(toks))
    if dtype == "f32":
        close_f32(got, want)
        close_f32(last, np.asarray(want)[:, -1])
    else:
        check_logits(f"{cfg.name} forward", got, t(want))
        check_logits(f"{cfg.name} prefill", last, t(want)[:, -1])


def test_loss_and_grads_match_reference(model):
    """Training's loss (cross-entropy plus ``0.01 *`` the MoE layers'
    auxiliary load-balancing loss) and every gradient, through the experts,
    the router's softmax and the aux, against ``jax.value_and_grad`` of
    the jitted reference ``loss_fn`` on float32 weights; the aux is
    positive and enters the loss."""
    cfg, tcfg, params, t_params = model
    batch = {"tokens": tokens(cfg.vocab_size, 2, 16, seed=17),
             "labels": tokens(cfg.vocab_size, 2, 16, seed=18)}
    check_loss_and_grads(cfg, tcfg, params, batch)
    with torch.no_grad():
        logits, aux = TT._forward(t_params, tcfg,
                                  torch.from_numpy(batch["tokens"]), None,
                                  True)
        loss = TZ.build(tcfg).loss(t_params, {
            k: torch.from_numpy(v) for k, v in batch.items()})
    assert float(aux) > 0
    ce = loss - 0.01 * aux
    assert abs(float(ce) - float(TT.emb.cross_entropy(
        logits, torch.from_numpy(batch["labels"])))) <= 1e-6


@pytest.mark.parametrize("quant", ["bf16", "int8"])
def test_decode_matches_reference(model, quant):
    """Teacher-forced ``decode_step`` over 6 tokens (B 2: T k = E, one
    slot an expert) into both stacks' caches, step by step, by the
    whole-model rule; int8 weights (the 4-D expert stacks' scales ``(L, E,
    out)``) and an int8 KV cache, the int8 tree equal to the
    reference's."""
    cfg, tcfg, params, t_params = model
    if quant == "int8":
        params, t_params = quantized_pair(params, t_params)
        s = t_params["layers"]["moe_down"]["s"]
        assert tuple(s.shape) == (tcfg.n_layers - tcfg.n_dense_layers,
                                  tcfg.n_experts, tcfg.d_model)
    toks = tokens(cfg.vocab_size, 2, 6, seed=3)
    # (not held to the prefill: its capacity, so its drops, differ)
    _, _, t_state, j_state = check_decode(cfg, tcfg, params, t_params, toks,
                                          max_len=16,
                                          quantized=quant == "int8")
    assert set(t_state) == set(j_state)
    for stack in set(t_state) - {"len"}:
        for key in ("k", "v"):
            assert torch.equal(t_state[stack][key], t(j_state[stack][key]))


def test_decode_below_capacity_uses_the_shared_expert_alone(monkeypatch):
    """kimi at B 1: T k = 2 < E = 4, so its MoE layer drops every
    assignment and only the shared expert (and the dense layer) act.  The
    port's decode equals the reference's with its MoE layer read as the
    capacity formula says (zeros; the reference itself raises there)."""
    name = "kimi-k2-1t-a32b"
    cfg, tcfg = JR.get_config(name, smoke=True), TR.get_config(name,
                                                               smoke=True)
    params, t_params = reference_params(cfg, seed=1)
    real = JMOE.moe_apply_local

    def by_formula(p, x, *, n_experts, topk, **kw):
        if x.shape[0] * topk < n_experts:
            return jnp.zeros_like(x)
        return real(p, x, n_experts=n_experts, topk=topk, **kw)

    monkeypatch.setattr(JMOE, "moe_apply_local", by_formula)
    toks = tokens(cfg.vocab_size, 1, 4, seed=4)
    decode = jax.jit(lambda p, tk, s: JT.decode_step(p, cfg, tk, s,
                                                     NO_CONSTRAIN))
    j_state = JT.init_decode_cache(cfg, 1, 8)
    t_state = TT.init_decode_cache(tcfg, 1, 8)
    for step in range(toks.shape[1]):
        tok = toks[:, step:step + 1]
        j_logits, j_state = decode(params, jnp.asarray(tok), j_state)
        with torch.no_grad():
            t_logits, t_state = TT.decode_step(
                t_params, tcfg, torch.from_numpy(tok), t_state)
        check_logits(f"B1 decode step {step}", t_logits, t(j_logits))


def test_serve_fns_prefill_past_flash_threshold():
    """kimi through ``make_serve_fns``: a prefill of 1 x 1100 tokens (the
    flash path in both layers, its plain version on the CPU) against the
    jitted reference, in float32 (rtol 1e-5, atol 1e-6); a decode from the
    fresh cache of both stacks."""
    name = "kimi-k2-1t-a32b"
    cfg = JR.get_config(name, smoke=True)
    params, _ = reference_params(cfg)
    params = _to_f32(params)
    t_params = convert.params_from_numpy(jax.device_get(params))
    bundle = TZ.build(TR.get_config(name, smoke=True))
    prefill_fn, decode_fn = train_loop.make_serve_fns(bundle, "cpu", 1, 8)
    toks = tokens(cfg.vocab_size, 1, 1100, seed=11)
    launched = FA.launches
    got = prefill_fn(t_params, {"tokens": torch.from_numpy(toks)})
    assert FA.launches == launched  # the CPU takes the plain version
    want = jax.jit(lambda p, tk: JT.prefill(p, cfg, tk, NO_CONSTRAIN))(
        params, jnp.asarray(toks))
    close_f32(got, want)
    logits, state = decode_fn(t_params, torch.from_numpy(toks[:, :1]))
    assert state["len"] == 1 and set(state) == {"main", "dense", "len"}
    assert tuple(logits.shape) == (1, cfg.vocab_size)


def test_serve_bundle_matches_reference_greedy(model):
    """The static serve (the prompt teacher-forced through decode, then
    greedy tokens) against the reference launcher's loop: the same
    tokens, no kernel."""
    cfg, tcfg, params, t_params = model
    check_serve_bundle(cfg, tcfg, params, t_params, "none")


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, quant):
    check_cli(arch, quant)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_refuses_full_width(arch):
    """At full width the weights exceed any one device: the CLI says so
    before it allocates anything."""
    with pytest.raises(SystemExit, match="G parameters"):
        tserve.main(["--arch", arch, "--device", "cpu"])


def test_tree_round_trips_through_convert(model):
    """The nested ``dense_layers`` tree, the 4-D expert stacks and the
    float32 router carry over as they are; ``param_count`` counts the
    reference's init."""
    cfg, tcfg, params, t_params = model
    check_round_trip(params, t_params)
    assert TT.param_count(tcfg) == sum(
        int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(params))
    assert t_params["layers"]["moe_router"].dtype == torch.float32
    assert t_params["layers"]["moe_gate"].dim() == 4


def test_port_init_matches_reference_layout(model):
    """The port's own seeded init draws the reference's tree: the same
    keys, shapes and dtypes, the experts at the reference's scale."""
    cfg, tcfg, params, _ = model
    got = TZ.build(tcfg).init(torch.Generator().manual_seed(0), "cpu")
    want = convert.params_from_numpy(jax.device_get(params))

    def walk(g, w, path):
        assert set(g) == set(w), path
        for k in w:
            if isinstance(w[k], dict):
                walk(g[k], w[k], f"{path}/{k}")
            else:
                assert g[k].shape == w[k].shape and g[k].dtype == w[k].dtype, (
                    f"{path}/{k}")

    walk(got, want, "params")
    std = float(got["layers"]["moe_gate"].float().std())
    assert abs(std * np.sqrt(tcfg.n_experts) - 1) < 0.05
