"""Shared pieces of the parity tests of the port's recurrent and enc-dec
model families (``test_torch_mamba.py``, ``test_torch_recurrentgemma.py``,
``test_torch_whisper.py``); not a test module itself.

Each family is held against the reference's jitted programs: XLA drops
the bf16 rounding of a value that is cast to float32 next (ROADMAP Queue
3, F6), and the port computes those values as the jitted reference does,
so the eager reference is not the yardstick.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.launch import serve as jserve
from repro.layers import attention as JA
from repro.models import model_zoo as JZ
from repro.models import quant_transformer as JQT
from repro_torch import convert
from repro_torch import tree_util as tu
from repro_torch.launch import serve as tserve
from repro_torch.layers import qmm as TQ
from repro_torch.models import model_zoo as TZ
from repro_torch.models import quant_transformer as TQT
from repro_torch.models import transformer as TT
from repro_torch.testing.attention_checks import check_logits
from repro_torch.testing.train_checks import BF16_RTOL

NO_CONSTRAIN = lambda x, logical=None: x  # noqa: E731


def t(a):
    """A JAX/numpy array -> a torch tensor of the same dtype."""
    return convert.tensor_from_numpy(jax.device_get(a))


def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


def bf16_pair(shape, seed, scale=1.0):
    a = (np.random.default_rng(seed).standard_normal(shape) * scale
         ).astype(np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16)
    return j, t(j)


def close_f32(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6)


def check_tree_equal(got, want, path="params"):
    """Equal trees (dicts and lists), leaf dtypes and bits."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            check_tree_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            check_tree_equal(g, w, f"{path}/{i}")
    else:
        assert got.dtype == want.dtype, path
        assert torch.equal(got, want), path


def leaf_names(tree, quantized):
    """The last path names of the int8 ``{"q", "s"}`` leaves (or of the
    other leaves)."""
    names = set()

    def walk(node, name):
        if TQ.is_quant(node):
            if quantized:
                names.add(name)
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, k)
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v, name)
        elif not quantized:
            names.add(name)

    walk(tree, "")
    return names


def reference_params(cfg, seed=0):
    """The reference's init at ``cfg``, and the same weights in the port."""
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(seed))
    return params, convert.params_from_numpy(jax.device_get(params))


def widened(cfg, **kw):
    return dataclasses.replace(cfg, name=cfg.name + "-wide", **kw)


def quantized_pair(params, t_params):
    """Both packages' int8 trees of the same weights, checked equal."""
    jq = JQT.quantize_param_tree(params)
    tq = TQT.quantize_param_tree(t_params)
    check_tree_equal(tq, convert.params_from_numpy(jax.device_get(jq)))
    return jq, tq


def check_decode(cfg, tcfg, jparams, tparams, toks, max_len, frames=None,
                 quantized=False):
    """Teacher-force ``toks`` through both packages' ``decode`` (the
    reference's jitted) from fresh states of ``max_len`` (int8 KV caches
    with ``quantized``): every step's logits by the whole-model rule.  Returns the port's last logits and
    the reference's prefill logits of the same prompt (with ``frames``
    for the enc-dec family)."""
    jb, tb = JZ.build(cfg), TZ.build(tcfg)
    B = toks.shape[0]
    decode = jax.jit(lambda p, tk, s: jb.decode(p, tk, s, NO_CONSTRAIN))
    j_state = jb.init_state(B, max_len, quantized=quantized)
    t_state = tb.init_state(B, max_len, quantized=quantized, device="cpu")
    for step in range(toks.shape[1]):
        tok = toks[:, step:step + 1]
        j_logits, j_state = decode(jparams, jnp.asarray(tok), j_state)
        with torch.no_grad():
            t_logits, t_state = tb.decode(tparams, torch.from_numpy(tok),
                                          t_state)
        check_logits(f"{cfg.name} decode step {step}", t_logits,
                     t(j_logits))
        assert t_state["len"] == int(j_state["len"]) == step + 1
    batch = {"tokens": jnp.asarray(toks)}
    if frames is not None:
        batch["frontend_embeds"] = frames
    j_prefill = jax.jit(lambda p, b: jb.prefill(p, b, NO_CONSTRAIN))(
        jparams, batch)
    return t_logits, t(j_prefill), t_state, j_state


def reference_serve_tokens(cfg, params, prompt, n_gen, max_len):
    """The reference launcher's static path on the bundle: the prompt
    teacher-forced through its jitted decode in one scan, then the greedy
    loop."""
    jb = JZ.build(cfg)
    decode = jax.jit(lambda p, tk, s: jb.decode(p, tk, s, NO_CONSTRAIN))
    state = jb.init_state(prompt.shape[0], max_len)
    logits, state = jserve._scan_prefill(decode, params, jnp.asarray(prompt),
                                         state)
    return np.asarray(jserve._greedy_loop(decode, params, logits, state,
                                          n_gen))


def check_serve_bundle(cfg, tcfg, params, t_params, quant, n_gen=4,
                       max_len=16):
    """``serve.serve_bundle`` on the CPU against the reference's greedy
    loop from the same weights and prompt: the same tokens, no kernel."""
    if quant == "int8":
        params, t_params = quantized_pair(params, t_params)
    prompt = tokens(cfg.vocab_size, 2, 5, seed=9)
    want = reference_serve_tokens(cfg, params, prompt, n_gen, max_len)
    bundle = TZ.build(tcfg)
    if quant == "int8":
        bundle = TQT.quantize_bundle(bundle)
    res = tserve.serve_bundle(bundle, t_params, torch.from_numpy(prompt),
                              n_gen, max_len, quantized_cache=quant == "int8")
    assert all(n == 0 for n in res.launches.values()), res.launches
    np.testing.assert_array_equal(res.tokens.numpy(), want)


def check_cli(arch, quant):
    """``serve --arch <arch> --smoke --device cpu``: the static path, no
    kernel launched, a sample of ``--gen`` tokens."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tserve.main(["--arch", arch, "--smoke", "--quant", quant,
                     "--batch", "2", "--prompt-len", "4", "--gen", "3",
                     "--max-len", "16", "--device", "cpu"])
    text = out.getvalue()
    assert "prompt tokens/s:" in text and "decode tokens/s:" in text
    launches = [ln for ln in text.splitlines()
                if ln.startswith("kernel launches:")]
    assert len(launches) == 1 and all(
        kv.endswith("=0") for kv in launches[0].split()[2:]), launches
    sample = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    assert len(sample) == 1 and len(eval(sample[0][len("sample:"):])) == 3


def check_loss(cfg, tcfg, params, dtype, extra=None):
    """The bundle's ``loss`` (labels partly masked) against the jitted
    reference's: with float32 weights by the float32 rule; with bf16
    weights within ``train_checks.BF16_RTOL``, the repo's rule for a bf16
    model's loss (a float32 norm summed in another order can move one
    activation by a bf16 ulp, as F7 allows a whole pass 1 %)."""
    if dtype == "f32":
        params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                        params)
    t_params = convert.params_from_numpy(jax.device_get(params))
    batch = {"tokens": tokens(cfg.vocab_size, 2, 16, seed=11),
             "labels": tokens(cfg.vocab_size, 2, 16, seed=12)}
    batch["labels"][0, :3] = -1
    batch.update(extra or {})
    jb = JZ.build(cfg)
    want = float(jax.jit(lambda p, b: jb.loss(p, b, NO_CONSTRAIN))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}))
    with torch.no_grad():
        got = float(TZ.build(tcfg).loss(t_params, {
            k: t(v).to(t_params["embedding"].dtype) if k == "frontend_embeds"
            else torch.from_numpy(np.asarray(v)) for k, v in batch.items()}))
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    else:
        assert abs(got - want) <= BF16_RTOL * abs(want), (got, want)


def check_round_trip(params, t_params):
    """``convert.params_from_numpy`` keeps the reference's tree (dict keys,
    list items, stacks, dtypes, bits), and ``convert.model_to`` places it
    without copying a tensor already on the device."""
    flat, _ = jax.tree_util.tree_flatten_with_path(jax.device_get(params))
    got = dict(tu.leaves_with_paths(t_params))
    assert len(got) == len(flat)
    for path, leaf in flat:
        key = tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        assert torch.equal(got[key], t(leaf)), key
        assert got[key].dtype == t(leaf).dtype, key
    moved, qlayers = convert.model_to(t_params, [], "cpu")
    assert qlayers == []
    check_tree_equal(moved, t_params)
    assert all(a is b for a, b in zip(tu.leaves(moved), tu.leaves(t_params)))


def loss_and_grads(tcfg, t_params, batch):
    """The port's loss of ``batch`` (numpy) and ``torch.autograd.grad`` of
    it with respect to every leaf of ``t_params`` (in ``tree_util.leaves``
    order, which is ``jax.tree_util``'s)."""
    flat = [p.detach().requires_grad_(True) for p in tu.leaves(t_params)]
    loss = TZ.build(tcfg).loss(tu.unflatten(t_params, flat), {
        k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()})
    return loss, torch.autograd.grad(loss, flat)


def check_loss_and_grads(cfg, tcfg, params, batch, grad_tol=1e-4):
    """The bundle's loss and its gradients against ``jax.value_and_grad`` of
    the jitted reference loss, both on the float32 copy of ``params``: the
    loss within the float32 rule (rtol 1e-5), each leaf's gradient within
    ``grad_tol`` of that leaf's largest |ref| (the two sum the backward's
    float32 products in other orders).  Returns the largest such relative
    difference."""
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), params)
    t_params = convert.params_from_numpy(jax.device_get(params))
    jb = JZ.build(cfg)
    want, want_grads = jax.jit(jax.value_and_grad(
        lambda p, b: jb.loss(p, b, NO_CONSTRAIN)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    got, grads = loss_and_grads(tcfg, t_params, batch)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    worst = 0.0
    for g, w in zip(grads, jax.tree_util.tree_leaves(want_grads),
                    strict=True):
        w = torch.from_numpy(np.array(w))
        rel = float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
        assert rel <= grad_tol, (rel, tuple(w.shape))
        worst = max(worst, rel)
    return worst


def leaf_gaps(got, want):
    """Each leaf's largest |got - want| over its largest |want|."""
    return [float((g.float() - w.float()).abs().max()
                  / w.float().abs().max().clamp_min(1e-30))
            for g, w in zip(got, want, strict=True)]


def flash_full_grads(cfg, tcfg, jparams, t_params, batches):
    """The dense loss's gradients (float32 copies of the leaves', in
    ``tree_util.leaves`` order) at each of ``batches`` (numpy; S past 1024)
    on the params as they are (bf16), in the port and in the jitted
    reference, each through flash attention and through full attention:
    ``{(side, path): [leaves per batch]}`` with side ``"port"`` or
    ``"ref"`` and path ``"flash"`` or ``"full"``.  The port takes full
    attention with ``transformer.FLASH_MIN_SEQ`` raised past S, the
    reference with its ``flash_attention`` swapped for ``full_attention``
    while it traces (its own module is left as it was)."""
    jb = JZ.build(cfg)
    out = {}
    for path in ("flash", "full"):
        fn = jax.jit(jax.value_and_grad(
            lambda p, b: jb.loss(p, b, NO_CONSTRAIN)))
        flash, flash_min = JA.flash_attention, TT.FLASH_MIN_SEQ
        if path == "full":
            JA.flash_attention = (lambda q, k, v, causal=True, window=0:
                                  JA.full_attention(q, k, v, causal=causal,
                                                    window=window))
            TT.FLASH_MIN_SEQ = 10**9
        try:
            out["ref", path] = [
                [torch.from_numpy(np.array(g.astype(jnp.float32)))
                 for g in jax.tree_util.tree_leaves(fn(jparams, {
                     k: jnp.asarray(v) for k, v in b.items()})[1])]
                for b in batches]
            out["port", path] = [[g.float() for g in loss_and_grads(
                tcfg, t_params, b)[1]] for b in batches]
        finally:
            JA.flash_attention, TT.FLASH_MIN_SEQ = flash, flash_min
    return out


def worst_gaps(runs, a, b):
    """Per leaf, the largest ``leaf_gaps`` of run ``a`` against run ``b``
    over the batches of ``flash_full_grads``' ``runs``."""
    return [max(col) for col in zip(*(leaf_gaps(x, y) for x, y in zip(
        runs[a], runs[b], strict=True)))]


if __name__ == "__main__":
    # PYTHONPATH=src python tests/torch_family_checks.py [THREADS]: the
    # bf16 gaps of tests/test_torch_train.py's flash checks, batch by
    # batch, the port on THREADS CPU threads (1, as the tests run it)
    import sys

    from repro.configs import registry as JRG
    from repro_torch.configs import registry as TRG
    from repro_torch.data import pipeline as TDATA

    torch.set_num_threads(int(sys.argv[1]) if len(sys.argv) > 1 else 1)
    name, n_batches, seq = "qwen1.5-0.5b", 6, 1100
    cfg = JRG.get_config(name, smoke=True)
    jparams, _ = JZ.build(cfg).init(jax.random.PRNGKey(0))
    t_params = convert.params_from_numpy(jax.device_get(jparams))
    data = TDATA.SyntheticLM(TDATA.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=1))
    runs = flash_full_grads(cfg, TRG.get_config(name, smoke=True), jparams,
                            t_params, [data.batch_at(i)
                                       for i in range(n_batches)])
    paths = ["/".join(p) for p, _ in tu.leaves_with_paths(t_params)]
    pairs = ((("port", "flash"), ("port", "full")),
             (("ref", "flash"), ("ref", "full")),
             (("port", "flash"), ("ref", "flash")),
             (("port", "full"), ("ref", "full")))
    print(f"{name} smoke, bf16, S {seq}, the port on "
          f"{torch.get_num_threads()} threads: each leaf's largest |a - b| "
          f"over its largest |b|; batch by batch: embedding / worst other "
          f"leaf")
    for a, b in pairs:
        cells = []
        for x, y in zip(runs[a], runs[b]):
            g = leaf_gaps(x, y)
            cells.append(f"{g[0]:.4f} / {max(g[1:]):.4f}")
        print(f"{'-'.join(a)} vs {'-'.join(b)}: " + ", ".join(cells))
    for a, b in pairs[:2]:
        print(f"worst over the batches, {'-'.join(a)} vs {'-'.join(b)}: "
              + ", ".join(f"{p} {g:.4f}" for p, g in zip(
                  paths, worst_gaps(runs, a, b))))
