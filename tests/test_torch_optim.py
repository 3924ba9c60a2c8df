"""The port's optimizers, gradient compression, checkpoints and restart
driver against the JAX reference (``repro.optim``, ``repro.checkpoint``,
``repro.runtime.fault``), on the same inputs drawn from a numpy seed.

Rules (an ulp is float32's at the largest |value| of the leaf, bf16's for
a bf16 leaf):
* each update takes identical grads, state and params in both packages.
  Against the reference run eagerly: the schedule within 1 ulp (float32
  ``cos`` differs from XLA's now and then), the global norm within 1 ulp
  (the leaves' squares are summed in another order); without clipping
  AdamW's moments are bit-equal (the same elementwise ops in the same
  order) and its params within 1 ulp.  Against ``jax.jit`` of the update
  (XLA rewrites some divisions, ROADMAP F1) and wherever a reduction's
  order enters (clipping scales by the norm; Adafactor's factored means):
  params within 2 ulps (1 bf16 ulp) and state within 8 ulps (measured: 1.2
  and 6);
* ``ef_compress_tree`` equals the eager reference bit for bit (it divides
  by tensors, as the eager reference truly divides); under ``jax.jit``
  XLA rounds some quotients otherwise (ROADMAP F1), which moves an element
  by one quantization step (max |g + r| / 127) in the dequantized gradient
  and the residual;
* a checkpoint written by either package restores in the other with every
  leaf bit-equal.
"""
import os

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import manager as JCK  # noqa: E402
from repro.optim import grad_compress as JGC  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree_util as tu  # noqa: E402
from repro_torch.checkpoint import manager as TCK  # noqa: E402
from repro_torch.optim import grad_compress as TGC  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.runtime import fault as TF  # noqa: E402

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:  # pragma: no cover
    HAVE_HYPOTHESIS = False

torch.set_num_threads(1)

STEPS = 4
CLIPS = {"none": 1e6, "triggered": 0.5}


def _tree(rng, scale=1.0):
    """float32 leaves of 1, 2 and 3 dims and a bf16 matrix."""
    return {"w": (rng.standard_normal((33, 17)) * scale).astype(np.float32),
            "b": (rng.standard_normal((17,)) * 0.01 * scale
                  ).astype(np.float32),
            "emb": (rng.standard_normal((40, 8)) * scale
                    ).astype(ml_dtypes.bfloat16),
            "stack": [(rng.standard_normal((5, 6, 7)) * scale
                       ).astype(np.float32)]}


def _np_leaves(tree):
    """The leaves of a port's tree (bf16 as float32) or of a reference's
    tree, as numpy arrays in the reference's order."""
    if isinstance(tu.leaves(tree)[0], torch.Tensor):
        return [x.float().numpy() if x.dtype == torch.bfloat16 else x.numpy()
                for x in tu.leaves(tree)]
    return [np.asarray(x) for x in
            jax.tree_util.tree_leaves(jax.device_get(tree))]


def _ulps(got, want):
    """Largest |got - want| in ulps of the leaf's largest |want| (bf16
    ulps for a bf16 leaf)."""
    is_bf16 = want.dtype == ml_dtypes.bfloat16
    g = np.asarray(got, np.float64)
    w = np.asarray(want).astype(np.float64)
    top = max(float(np.abs(w).max()), 1e-30)
    ulp = 2.0 ** (np.floor(np.log2(top)) - (7 if is_bf16 else 23))
    return float(np.abs(g - w).max() / ulp)


def _compare(got, want):
    """Per-leaf ulps of the port's tree ``got`` against the reference's."""
    w = jax.tree_util.tree_leaves(jax.device_get(want))
    g = _np_leaves(got)
    assert len(g) == len(w)
    return [_ulps(a, np.asarray(b)) for a, b in zip(g, w)]


def _to_jax(tree):
    """The port's tree as jax arrays (bf16 stays bf16)."""
    def one(t):
        if t.dtype == torch.bfloat16:
            return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
        return jnp.asarray(t.numpy())
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_jax(v) for v in tree)
    return one(tree)


@pytest.mark.parametrize("clip", list(CLIPS))
@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_update_matches_reference(name, clip):
    rng = np.random.default_rng(0)
    cfg = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=8,
               clip_norm=CLIPS[clip])
    j_init, j_upd = JO.make_optimizer(JO.OptConfig(**cfg))
    t_init, t_upd = TO.make_optimizer(TO.OptConfig(**cfg))
    j_jit = jax.jit(j_upd)
    params = convert.params_from_numpy(_tree(rng))
    state = t_init(params)
    carried = convert.opt_state_from_numpy(
        {"inner": jax.device_get(j_init(_to_jax(params)))})["inner"]
    assert all(a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
        tu.leaves(state), tu.leaves(carried), strict=True))
    exact = name == "adamw" and clip == "none"
    for _ in range(STEPS):
        g_np = _tree(rng)
        jp, js = _to_jax(params), _to_jax(state)
        jg = jax.tree_util.tree_map(jnp.asarray, g_np)
        new_p, new_s, m = t_upd(convert.params_from_numpy(g_np), state,
                                params)
        for run, p_ulps, s_ulps, scalar_ulps in (
                (j_upd, 1 if exact else 2, 0 if exact else 8, 1),
                (j_jit, 2, 8, 2)):
            want_p, want_s, want_m = run(jg, js, jp)
            assert max(_compare(new_p, want_p)) <= p_ulps
            assert max(_compare(new_s, want_s)) <= s_ulps
            assert _ulps(m["lr"].numpy(), np.asarray(want_m["lr"])) <= \
                scalar_ulps
            assert _ulps(m["grad_norm"].numpy(),
                         np.asarray(want_m["grad_norm"])) <= 1
        assert new_p["emb"].dtype == torch.bfloat16
        # the update leaves its inputs as they were
        assert all(np.array_equal(a, b) for a, b in zip(
            _np_leaves(params), _np_leaves(jp)))
        params, state = new_p, new_s
    assert int(state["step"]) == STEPS


def test_schedule_matches_reference():
    j_cfg = JO.OptConfig(lr=3e-3, warmup_steps=5, total_steps=37)
    t_cfg = TO.OptConfig(lr=3e-3, warmup_steps=5, total_steps=37)
    steps = np.arange(0, 45, dtype=np.int32)
    want = np.stack([np.asarray(JO.schedule(j_cfg, jnp.int32(s)))
                     for s in steps])
    sched_jit = jax.jit(lambda s: JO.schedule(j_cfg, s))
    want_jit = np.stack([np.asarray(sched_jit(jnp.int32(s))) for s in steps])
    got = np.stack([TO.schedule(t_cfg, torch.tensor(int(s),
                                                    dtype=torch.int32))
                    .numpy() for s in steps])
    assert got.dtype == np.float32
    for g, w, wj in zip(got, want, want_jit):
        assert _ulps(g, w) <= 1 and _ulps(g, wj) <= 2
    assert float(got[5]) == pytest.approx(3e-3) and got[0] == 0
    assert float(got[-1]) == pytest.approx(3e-4)


def test_ef_compress_matches_reference():
    rng = np.random.default_rng(1)
    g = _tree(rng)
    r = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.01).astype(np.float32),
        g)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    jr = jax.tree_util.tree_map(jnp.asarray, r)
    deq, resid = TGC.ef_compress_tree(convert.params_from_numpy(g),
                                      convert.params_from_numpy(r))
    assert deq["emb"].dtype == torch.bfloat16
    assert resid["emb"].dtype == torch.float32
    want_deq, want_resid = JGC.ef_compress_tree(jg, jr)
    assert max(_compare(deq, want_deq)) == 0
    assert max(_compare(resid, want_resid)) == 0
    # under jit a quotient that XLA rounds otherwise can move q by one
    # step (scale = max |gf| / 127), the dequantized value and the residual
    # with it
    jit_deq, jit_resid = jax.jit(JGC.ef_compress_tree)(jg, jr)
    gf = [np.asarray(a).astype(np.float32) + b for a, b in zip(
        jax.tree_util.tree_leaves(g), jax.tree_util.tree_leaves(r))]
    for got, want, x in zip(_np_leaves(deq) + _np_leaves(resid),
                            _np_leaves(jit_deq) + _np_leaves(jit_resid),
                            gf + gf):
        step = np.abs(x).max() / 127
        assert np.abs(got - want.astype(np.float32)).max() <= 1.001 * step
    zero = TGC.ef_init(convert.params_from_numpy(g))
    assert all(t.dtype == torch.float32 and not t.any()
               for t in tu.leaves(zero))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_reduce_loss(name):
    opt_cfg = TO.OptConfig(name=name, lr=0.1, warmup_steps=1,
                           total_steps=100, weight_decay=0.0)
    init, update = TO.make_optimizer(opt_cfg)
    target = torch.from_numpy(
        np.random.default_rng(0).standard_normal((8, 8)).astype(np.float32))
    params = {"w": torch.zeros((8, 8))}
    state = init(params)

    def loss_fn(p):
        return torch.mean(torch.square(p["w"] - target))

    losses = []
    for _ in range(60):
        w = params["w"].clone().requires_grad_(True)
        (g,) = torch.autograd.grad(loss_fn({"w": w}), [w])
        params, state, _ = update({"w": g}, state, params)
        losses.append(float(loss_fn(params)))
    assert losses[-1] < 0.05 * losses[0], (name, losses[0], losses[-1])


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_donated_update_writes_the_same_bits_in_place(name):
    """``donate=True`` writes each leaf's new param and state into the
    tensors it was given (the reference's donated buffers): over 4 steps
    with clipping the same bits as the update that returns new tensors,
    and the returned trees hold the given tensors."""
    rng = np.random.default_rng(5)
    cfg = TO.OptConfig(name=name, lr=3e-3, warmup_steps=2, total_steps=9,
                       clip_norm=0.5)
    init, update = TO.make_optimizer(cfg)
    _, donated = TO.make_optimizer(cfg, donate=True)
    params = convert.params_from_numpy(_tree(rng))
    mine = tu.tree_map(torch.clone, params)
    state, my_state = init(params), init(mine)
    for _ in range(4):
        grads = convert.params_from_numpy(_tree(rng, 3.0))
        params, state, m = update(grads, state, params)
        given = dict(tu.leaves_with_paths((mine, my_state)))
        mine, my_state, my_m = donated(grads, my_state, mine)
        assert all(t is given[path] for path, t in tu.leaves_with_paths(
            (mine, my_state)) if "step" not in path)
        assert all(torch.equal(a, b) for a, b in zip(
            tu.leaves((params, state)), tu.leaves((mine, my_state)),
            strict=True))
        assert torch.equal(m["grad_norm"], my_m["grad_norm"])


def test_grad_compression_error_feedback_converges():
    opt_cfg = TO.OptConfig(name="adamw", lr=0.05, warmup_steps=1,
                           total_steps=200, weight_decay=0.0)
    init, update = TO.make_optimizer(opt_cfg)
    target = torch.from_numpy(
        np.random.default_rng(1).standard_normal((16, 16)).astype(
            np.float32))
    params = {"w": torch.zeros((16, 16))}
    state = init(params)
    resid = TGC.ef_init(params)
    for _ in range(100):
        g = 2 * (params["w"] - target) / target.numel()
        g, resid = TGC.ef_compress_tree({"w": g}, resid)
        params, state, _ = update(g, state, params)
    assert float(torch.mean(torch.square(params["w"] - target))) < 0.02


# --- checkpoints -------------------------------------------------------------


def _ckpt_tree(rng):
    """A ``(params, opt_state)``-shaped tree: bf16, float32 and an int32
    scalar, nested dicts and lists."""
    params = _tree(rng)
    return (params, {"inner": {"mu": _tree(rng), "nu": _tree(rng),
                               "step": np.int32(7)}})


def test_checkpoint_roundtrip_and_keepk(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path), keep_k=2, async_save=False)
    tree = {"a": torch.arange(8, dtype=torch.float32),
            "b": {"c": torch.ones((3, 3), dtype=torch.bfloat16)}}
    for step in (10, 20, 30):
        mgr.save(step, tree, extra_meta={"data_step": step})
    assert sorted(mgr.steps()) == [20, 30]  # keep_k GC'd step 10
    restored, meta = mgr.restore(30, tree)
    assert meta == {"step": 30, "data_step": 30}
    assert torch.equal(restored["a"], tree["a"])
    assert restored["b"]["c"].dtype == torch.bfloat16
    with pytest.raises(KeyError):
        mgr.restore(30, {"a": tree["a"], "z": tree["a"]})
    with pytest.raises(ValueError):
        mgr.restore(30, {"a": torch.zeros(9)})


def test_checkpoint_crash_safety(tmp_path):
    """A tmp dir left by a crashed save must not count as a checkpoint."""
    mgr = TCK.CheckpointManager(str(tmp_path), async_save=False)
    os.makedirs(tmp_path / "tmp_step_99")
    assert mgr.latest_step() is None
    mgr.save(5, {"x": torch.zeros(2)})
    assert mgr.latest_step() == 5


def test_async_save_copies_before_its_thread(tmp_path):
    mgr = TCK.CheckpointManager(str(tmp_path))
    x = torch.arange(1000, dtype=torch.float32)
    mgr.save(1, {"x": x})
    x.zero_()  # the caller goes on writing to the saved tensor
    mgr.wait()
    restored, _ = mgr.restore(1, {"x": x})
    assert torch.equal(restored["x"], torch.arange(1000,
                                                   dtype=torch.float32))


def _bit_equal(got, want):
    g = tu.leaves(got)
    w = jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == b.dtype.name, (a.dtype,
                                                             b.dtype)
        a = a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
        b = b.astype(np.float32) if b.dtype == ml_dtypes.bfloat16 else b
        assert a.tobytes() == np.ascontiguousarray(b).tobytes()


def test_checkpoint_written_by_reference_restores_in_port(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(3))
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    JCK.CheckpointManager(str(tmp_path), async_save=False).save(4, jtree)
    like = convert.params_from_numpy(_ckpt_tree(np.random.default_rng(4)))
    restored, meta = TCK.CheckpointManager(str(tmp_path)).restore(4, like)
    assert meta["step"] == 4
    _bit_equal(restored, tree)


def test_checkpoint_written_by_port_restores_in_reference(tmp_path):
    tree = _ckpt_tree(np.random.default_rng(5))
    mgr = TCK.CheckpointManager(str(tmp_path))
    mgr.save(6, convert.params_from_numpy(tree))  # async
    mgr.wait()
    like = jax.tree_util.tree_map(jnp.asarray,
                                  _ckpt_tree(np.random.default_rng(6)))
    restored, meta = JCK.CheckpointManager(str(tmp_path)).restore(6, like)
    assert meta["step"] == 6
    got = convert.params_from_numpy(jax.device_get(restored))
    _bit_equal(got, tree)


# --- run_with_restarts (tests/test_fault.py's restart tests) -----------------


class _Trainer:
    """Checkpoints every step; fails (with ``exc``) at the step indices in
    ``fail_at`` -- each index fires once."""

    def __init__(self, fail_at, exc=RuntimeError):
        self.fail_at = set(fail_at)
        self.exc = exc
        self.ckpt = None
        self.calls = 0

    def latest(self):
        return self.ckpt

    def chunk(self, start):
        self.calls += 1
        for step in range(start, start + 100):
            if step in self.fail_at:
                self.fail_at.remove(step)
                raise self.exc(f"injected at {step}")
            self.ckpt = step + 1
        return self.ckpt


def test_restarts_recover_and_count():
    tr = _Trainer(fail_at=[5, 105])
    stats = TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                                 total_steps=150, backoff_s=0.0)
    assert stats.restarts == 2
    assert stats.completed_steps >= 150
    assert stats.resumed_from == 0


def test_backoff_sequence_is_capped_exponential():
    pauses = []
    tr = _Trainer(fail_at=[1, 2, 3, 4, 5, 6])
    stats = TF.run_with_restarts(
        tr.chunk, ckpt_latest=tr.latest, total_steps=10,
        max_restarts=10, backoff_s=0.1, backoff_cap_s=1.0,
        sleep=pauses.append)
    # restart n sleeps min(0.1 * 2**(n-1), 1.0)
    assert pauses == pytest.approx([0.1, 0.2, 0.4, 0.8, 1.0, 1.0])
    assert stats.backoff_s_total == pytest.approx(sum(pauses))


def test_non_allowlisted_exception_propagates_immediately():
    tr = _Trainer(fail_at=[3], exc=ValueError)
    with pytest.raises(ValueError):
        TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                             total_steps=10, backoff_s=0.0)
    assert tr.calls == 1  # no retry burned on a deterministic failure


def test_custom_allowlist_overrides_default():
    tr = _Trainer(fail_at=[3], exc=KeyError)
    stats = TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                                 total_steps=10, restart_on=(KeyError,),
                                 backoff_s=0.0)
    assert stats.restarts == 1


def test_default_allowlist_covers_infra_failures():
    assert TF.RESTARTABLE_EXCEPTIONS == (RuntimeError, OSError,
                                         TimeoutError, ConnectionError)
    for exc in TF.RESTARTABLE_EXCEPTIONS:
        tr = _Trainer(fail_at=[2], exc=exc)
        stats = TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                                     total_steps=5, backoff_s=0.0)
        assert stats.restarts == 1, exc


def test_max_restarts_exceeded_reraises():
    tr = _Trainer(fail_at=[1, 2, 3])
    with pytest.raises(RuntimeError):
        TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                             total_steps=10, max_restarts=2, backoff_s=0.0)


def test_param_validation():
    tr = _Trainer(fail_at=[])
    with pytest.raises(ValueError):
        TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest, total_steps=5,
                             max_restarts=-1)
    with pytest.raises(ValueError):
        TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest, total_steps=5,
                             backoff_s=-0.1)


def test_restarts_resume_from_checkpoint_manager(tmp_path):
    """The driver over ``CheckpointManager``: simulated node failures
    resume from durable steps (``test_data_optim_ckpt.py``'s case)."""
    mgr = TCK.CheckpointManager(str(tmp_path), async_save=False)
    state = {"failures_left": 2}

    def train_chunk(start):
        for step in range(start, start + 10):
            if step == 15 and state["failures_left"] > 0:
                state["failures_left"] -= 1
                raise RuntimeError("node lost")
            if (step + 1) % 5 == 0:
                mgr.save(step + 1, {"p": torch.full((4,), float(step))})
        return start + 10

    stats = TF.run_with_restarts(train_chunk, ckpt_latest=mgr.latest_step,
                                 total_steps=30)
    assert stats.restarts == 2
    assert mgr.latest_step() >= 30  # recovered and finished the run


if HAVE_HYPOTHESIS:

    @settings(max_examples=40, deadline=None)
    @given(fail_at=st.sets(st.integers(min_value=0, max_value=299),
                           max_size=8),
           total=st.integers(min_value=1, max_value=300))
    def test_any_failure_schedule_within_budget_completes(fail_at, total):
        """For any schedule of <= max_restarts transient failures the
        driver reaches total_steps and never loses checkpointed work."""
        tr = _Trainer(fail_at=fail_at)
        stats = TF.run_with_restarts(tr.chunk, ckpt_latest=tr.latest,
                                     total_steps=total, max_restarts=8,
                                     backoff_s=0.0)
        assert (tr.ckpt or 0) >= total
        assert not any(f < total for f in tr.fail_at)
        assert stats.restarts <= 8
