"""The port's train step and train CLI at ``lstm-rnnt-smoke`` (and the
dense transformer's loss), against the JAX reference on the same weights
and optimizer state (the reference's seed-0 init, carried across by
``convert``), on the same ``SyntheticLM`` batches.

Rules:
* the first step's loss and grad_norm equal the reference's jitted
  ``make_train_step(bundle, None, ...)`` within rtol 1e-5 (the float
  graph's float32 rounding; ``test_torch_float_lm.py``), 1e-4 under QAT
  (ROADMAP F9: float32 ulps meet fake quantization's rounding ties);
* the loss after 5 steps within rtol 1e-3.  Params updated by Adam are
  not compared elementwise: Adam's first step moves every parameter by
  about +-lr whatever its gradient's size, so a gradient below the
  1e-4 parity floor of the float graph can take either sign (ROADMAP T6);
* with one micro-batch a gradient keeps its leaf's dtype (bf16 for the
  embedding and the head), with more it is a float32 mean;
* training reduces the loss as ``test_system.py`` requires of the
  reference, from the reference's weights (the same test);
* ``launch/train.py --device cpu`` resumes from its checkpoint to the
  loss an uninterrupted run reaches, bit for bit;
* past S 1024 (flash attention, through ``layers.attention.
  FlashAttention``) the dense loss and every gradient equal
  ``jax.value_and_grad`` of the jitted reference on float32 weights
  (``torch_family_checks.check_loss_and_grads``); on the bf16 weights
  every gradient equals the reference's, and the port's flash gradients
  its full attention's, within 2 % of the leaf's largest |gradient| or
  the reference's own flash-vs-full gap where that is larger (ROADMAP
  F12); a bf16 train step's loss and grad_norm equal the reference's
  within ``train_checks.BF16_RTOL`` (the repo's rule for a bf16
  transformer step; ROADMAP T7: losses and norms, never Adam-updated
  params);
* per-layer remat (``cfg.remat="full"``) changes no bit of the loss or of
  any gradient.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as JRG  # noqa: E402
from repro.models import model_zoo as JZ  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.runtime import train_loop as JTL  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree_util as tu  # noqa: E402
from repro_torch.configs import registry as TRG  # noqa: E402
from repro_torch.data import pipeline as TDATA  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model_zoo as TZ  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.runtime import train_loop as TTL  # noqa: E402
from repro_torch.testing import train_checks as TCK  # noqa: E402
from test_torch_recurrent import compile_all  # noqa: E402
from torch_family_checks import (  # noqa: E402
    check_loss_and_grads, flash_full_grads, leaf_gaps, loss_and_grads,
    worst_gaps)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ARCH = "lstm-rnnt"
B, T, STEPS = 4, 8, 5
OPT = dict(lr=3e-3, warmup_steps=2, total_steps=10)
# (qat, microbatches, grad_compress_int8): each axis off and on once
CONFIGS = [(False, 1, False), (False, 2, False), (False, 1, True),
           (True, 1, False)]
FIRST_RTOL = {False: 1e-5, True: 1e-4}
LAST_RTOL = 1e-3


@functools.lru_cache(maxsize=None)
def _reference_init(arch):
    """The reference's seed-0 params (jax arrays) and the port's copy."""
    cfg = JRG.get_config(arch, smoke=True)
    params, _ = JZ.build(cfg).init(jax.random.PRNGKey(0))
    return params, convert.params_from_numpy(jax.device_get(params))


def _batches(cfg, n, batch=B, seq=T, vocab=None, **kw):
    data = TDATA.SyntheticLM(TDATA.DataConfig(
        vocab_size=vocab or cfg.vocab_size, seq_len=seq, global_batch=batch,
        **kw))
    return [data.batch_at(i) for i in range(n)]


def _jax_step(qat, mb, gc):
    cfg = JRG.get_config(ARCH, smoke=True)
    return JTL.make_train_step(JZ.build(cfg), None, JO.OptConfig(**OPT),
                               microbatches=mb, grad_compress_int8=gc,
                               qat=qat, donate=False)


@functools.lru_cache(maxsize=None)
def _reference_runs():
    """Each configuration's ``STEPS`` steps in the reference, compiled
    together: ``{config: ([(loss, grad_norm)], initial opt state)}``."""
    params, _ = _reference_init(ARCH)
    cfg = JRG.get_config(ARCH, smoke=True)
    batches = [{k: jnp.asarray(v) for k, v in b.items()}
               for b in _batches(cfg, STEPS)]
    arts = [_jax_step(*c) for c in CONFIGS]
    states = [a.init_opt(params) for a in arts]
    programs = compile_all([(a.step_fn, (params, s, batches[0]))
                            for a, s in zip(arts, states)])
    out = {}
    for config, program, state in zip(CONFIGS, programs, states):
        p, s, metrics = params, state, []
        for b in batches:
            p, s, m = program(p, s, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[config] = (metrics, jax.device_get(state))
    return out


@pytest.mark.parametrize("qat,mb,gc", CONFIGS)
def test_train_step_matches_reference(qat, mb, gc):
    want, state0 = _reference_runs()[(qat, mb, gc)]
    _, t_params = _reference_init(ARCH)
    tcfg = TRG.get_config(ARCH, smoke=True)
    art = TTL.make_train_step(TZ.build(tcfg), "cpu", TO.OptConfig(**OPT),
                              microbatches=mb, grad_compress_int8=gc,
                              qat=qat)
    opt = convert.opt_state_from_numpy(state0)
    fresh = art.init_opt(t_params)  # the port's own init: the same state
    assert all(torch.equal(a, b) for a, b in zip(
        tu.leaves(fresh), tu.leaves(opt), strict=True))
    p, got = t_params, []
    for b in _batches(tcfg, STEPS):
        p, opt, m = art.step_fn(p, opt, b)
        assert all(v.dtype == torch.float32 and v.dim() == 0
                   for v in m.values())
        got.append((float(m["loss"]), float(m["grad_norm"])))
    np.testing.assert_allclose(got[0], want[0], rtol=FIRST_RTOL[qat])
    np.testing.assert_allclose(got[-1][0], want[-1][0], rtol=LAST_RTOL)
    assert int(opt["inner"]["step"]) == STEPS
    assert set(opt) == ({"inner", "ef_residual"} if gc else {"inner"})
    # the step leaves its inputs as they were
    fresh = convert.params_from_numpy(jax.device_get(_reference_init(ARCH)[0]))
    assert all(torch.equal(a, b) for a, b in zip(
        tu.leaves(t_params), tu.leaves(fresh), strict=True))


@pytest.mark.parametrize("mb", [1, 2])
def test_grad_dtypes(mb, monkeypatch):
    """One micro-batch: bf16 grads for the bf16 leaves; more: float32."""
    seen = {}

    def spy(cfg):
        init, update = TO.make_optimizer(cfg)

        def upd(grads, state, params):
            seen.update({path: g.dtype
                         for path, g in tu.leaves_with_paths(grads)})
            return update(grads, state, params)
        return init, upd

    monkeypatch.setattr(TTL, "make_optimizer", spy)
    _, t_params = _reference_init(ARCH)
    tcfg = TRG.get_config(ARCH, smoke=True)
    art = TTL.make_train_step(TZ.build(tcfg), "cpu", TO.OptConfig(**OPT),
                              microbatches=mb)
    art.step_fn(t_params, art.init_opt(t_params), _batches(tcfg, 1)[0])
    for path, p in tu.leaves_with_paths(t_params):
        assert seen[path] == (p.dtype if mb == 1 else torch.float32), path
    assert seen[("embedding",)] == (torch.bfloat16 if mb == 1
                                    else torch.float32)


def _train(name, steps=40, lr=3e-3, data_vocab=None):
    """``test_system._train`` on the port, from the reference's weights."""
    cfg = TRG.get_config(name, smoke=True)
    art = TTL.make_train_step(TZ.build(cfg), "cpu", TO.OptConfig(
        lr=lr, warmup_steps=5, total_steps=steps + 20))
    params = _reference_init(name)[1]
    opt = art.init_opt(params)
    losses = []
    for b in _batches(cfg, steps, batch=8, seq=32, vocab=data_vocab,
                      noise=0.0):
        params, opt, m = art.step_fn(params, opt, b)
        losses.append(float(m["loss"]))
    return losses


def test_training_reduces_loss_lstm():
    # the tiny smoke LSTM (proj width 20) needs an easier rule: vocab 16
    losses = _train("lstm-rnnt", steps=120, lr=1e-2, data_vocab=16)
    assert losses[-1] < 0.7 * losses[0], (losses[0], losses[-1])


def test_training_reduces_loss_transformer():
    losses = _train("qwen1.5-0.5b", steps=120, lr=1e-2)
    assert losses[-1] < 0.8 * losses[0], (losses[0], losses[-1])


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "internvl2-2b"])
def test_dense_loss_matches_reference(name):
    """The transformer's loss (the VLM's with its frontend positions cut)
    equals the reference's within float32 rounding of the bf16 logits."""
    cfg = TRG.get_config(name, smoke=True)
    jparams, params = _reference_init(name)
    batch = _batches(cfg, 1, batch=2, seq=16,
                     frontend_tokens=cfg.n_frontend_tokens,
                     d_model=cfg.d_model)[0]
    assert ("frontend_embeds" in batch) == (cfg.family == "vlm")
    want = JZ.build(JRG.get_config(name, smoke=True)).loss(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()},
        lambda x, logical=None: x)
    with torch.no_grad():
        got = TZ.build(cfg).loss(params, {k: torch.from_numpy(v)
                                          for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


FLASH_S = 1100  # > 1024: every attention layer runs flash attention
# the bf16 flash checks' batches: the first six of the SyntheticLM stream
BF16_BATCHES = 6
# the bf16 flash checks' floor: 2 % of a leaf's largest |gradient|
BF16_GRAD_FLOOR = 0.02


@functools.lru_cache(maxsize=None)
def _bf16_flash_full():
    """``torch_family_checks.flash_full_grads`` of the smoke dense model
    from the reference's bf16 weights, at S 1100 over ``BF16_BATCHES``
    batches, and its paths' order."""
    name = "qwen1.5-0.5b"
    cfg = JRG.get_config(name, smoke=True)
    jparams, params = _reference_init(name)
    runs = flash_full_grads(cfg, TRG.get_config(name, smoke=True), jparams,
                            params, _batches(cfg, BF16_BATCHES, batch=1,
                                             seq=FLASH_S))
    return runs, [p for p, _ in tu.leaves_with_paths(params)]


def _bf16_bounds():
    """Each leaf's bf16 bound: the larger of ``BF16_GRAD_FLOOR`` and the
    reference's own largest gap between its flash and its full attention
    over the batches (bf16 rounding noise: the embedding's gradient, added
    position by position in bf16, turns a last-bit difference upstream
    into up to 2.4 % of its largest element; ROADMAP F12)."""
    runs, _ = _bf16_flash_full()
    return [max(BF16_GRAD_FLOOR, g) for g in worst_gaps(
        runs, ("ref", "flash"), ("ref", "full"))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_loss_differentiates_past_flash(dtype, monkeypatch):
    """At S 1100 (> 1024: every layer runs flash attention, whose
    gradient is ``FlashAttention``'s, the reference's VJP, on the CPU)
    the gradients equal those through full attention (autograd of the
    direct product).  On float32 weights, where the point is the
    algorithm: each leaf within 1e-4 of its largest |gradient|.  On the
    bf16 weights: each leaf, over ``BF16_BATCHES`` batches, within
    ``_bf16_bounds`` (2 % of its largest |gradient|, or the reference's own
    flash-vs-full gap where that is larger)."""
    name = "qwen1.5-0.5b"
    cfg = TRG.get_config(name, smoke=True)
    if dtype == "bfloat16":
        runs, paths = _bf16_flash_full()
        assert all(bool(torch.isfinite(g).all())
                   for leaves in runs["port", "flash"] for g in leaves)
        got = worst_gaps(runs, ("port", "flash"), ("port", "full"))
        for path, gap, bound in zip(paths, got, _bf16_bounds(), strict=True):
            assert gap <= bound, (path, gap, bound)
        return
    params = tu.tree_map(lambda t: t.float(), _reference_init(name)[1])
    b = {k: torch.from_numpy(v) for k, v in
         _batches(cfg, 1, batch=1, seq=FLASH_S)[0].items()}
    grads = {}
    for flash_min in (TT.FLASH_MIN_SEQ, 10**9):
        monkeypatch.setattr(TT, "FLASH_MIN_SEQ", flash_min)
        flat = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
        loss = TT.loss_fn(tu.unflatten(params, flat), cfg, b)
        grads[flash_min] = torch.autograd.grad(loss, flat)
    for g_flash, g_full in zip(*grads.values(), strict=True):
        assert bool(torch.isfinite(g_flash).all())
        assert (g_flash - g_full).abs().max() <= \
            1e-4 * g_full.abs().max()


def test_dense_bf16_grads_past_flash_match_reference():
    """S 1100 on the reference's bf16 weights: each leaf's gradient
    through ``FlashAttention`` against ``jax.value_and_grad`` of the jitted
    reference ``loss_fn`` (its custom VJP), batch by batch over
    ``BF16_BATCHES`` batches, within ``_bf16_bounds``: the port differs
    from the reference by no more than 2 % of the leaf's largest
    |gradient|, or than the reference's two attention paths differ from
    each other."""
    runs, paths = _bf16_flash_full()
    bounds = _bf16_bounds()
    for i, (got, want) in enumerate(zip(runs["port", "flash"],
                                        runs["ref", "flash"], strict=True)):
        for path, gap, bound in zip(paths, leaf_gaps(got, want), bounds,
                                    strict=True):
            assert gap <= bound, (i, path, gap, bound)


def test_dense_loss_and_grads_past_flash_match_reference():
    """S 1100: the loss and every gradient (the backward through
    ``FlashAttention`` in both layers) against ``jax.value_and_grad`` of
    the jitted reference ``loss_fn`` on the same float32 weights."""
    name = "qwen1.5-0.5b"
    cfg = JRG.get_config(name, smoke=True)
    batch = _batches(cfg, 1, batch=1, seq=FLASH_S)[0]
    check_loss_and_grads(cfg, TRG.get_config(name, smoke=True),
                         _reference_init(name)[0], batch)


def test_train_step_past_flash_matches_reference():
    """One AdamW step at S 1100 from the reference's bf16 weights: the
    loss and grad_norm against the reference's jitted step (T7)."""
    name = "qwen1.5-0.5b"
    cfg = JRG.get_config(name, smoke=True)
    jparams, params = _reference_init(name)
    batch = _batches(cfg, 1, batch=1, seq=FLASH_S)[0]
    jart = JTL.make_train_step(JZ.build(cfg), None, JO.OptConfig(**OPT),
                               donate=False)
    _, _, want = jax.jit(jart.step_fn)(
        jparams, jart.init_opt(jparams),
        {k: jnp.asarray(v) for k, v in batch.items()})
    art = TTL.make_train_step(TZ.build(TRG.get_config(name, smoke=True)),
                              "cpu", TO.OptConfig(**OPT))
    _, _, got = art.step_fn(params, art.init_opt(params), batch)
    for key in ("loss", "grad_norm"):
        g, w = float(got[key]), float(want[key])
        assert abs(g - w) <= TCK.BF16_RTOL * abs(w), (key, g, w)


@pytest.mark.parametrize("name,seq", [("qwen1.5-0.5b", FLASH_S),
                                      ("grok-1-314b", 32),
                                      ("falcon-mamba-7b", 16)])
def test_remat_changes_no_bit(name, seq):
    """``cfg.remat="full"`` (each layer under ``torch.utils.checkpoint``,
    recomputed in the backward) against ``"none"``: the loss and every
    gradient equal bit for bit (the dense model past S 1024, where the
    recomputed layers run flash attention again; the MoE model with its
    aux; the Mamba stack)."""
    cfg = TRG.get_config(name, smoke=True)
    params = _reference_init(name)[1]
    batch = _batches(cfg, 1, batch=1, seq=seq)[0]
    runs = [loss_and_grads(dataclasses.replace(cfg, remat=remat), params,
                           batch) for remat in ("none", "full")]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1, strict=True))
    with pytest.raises(NotImplementedError, match="dots"):
        loss_and_grads(dataclasses.replace(cfg, remat="dots"), params, batch)


def _cli(*args, ckpt):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--device", "cpu", "--batch", "2", "--seq", "8",
         "--ckpt-dir", str(ckpt), "--ckpt-every", "1", *args],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_train_cli_resumes_from_checkpoint(tmp_path):
    first = _cli("--steps", "3", ckpt=tmp_path)
    assert "final loss:" in first and "resumed" not in first
    assert sorted(os.listdir(tmp_path)) == ["step_1", "step_2", "step_3"]
    second = _cli("--steps", "5", "--resume", ckpt=tmp_path)
    assert "resumed from step 3" in second
    whole = ttrain.run(ttrain.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
         "--seq", "8", "--steps", "5"]))
    assert f"final loss: {whole.losses[-1]:.4f} (first: " \
        f"{whole.losses[3]:.4f})" in second
    assert sorted(os.listdir(tmp_path)) == ["step_3", "step_4", "step_5"]
