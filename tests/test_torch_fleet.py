"""The port's fleet tier against the JAX reference's.

On ``lstm-rnnt-smoke``, with params and quantized layers from
``golden.build_lm_case`` carried across:

* the fault plane (``KillSpec``, ``FaultInjector``) and the shard placement
  (``fleet_device_groups``) answer as the reference's do, with no model;
* the acceptance case of ``tests/test_fleet.py`` (a hard kill of 1 of 2
  oversubscribed shards, so pooled streams migrate with their state and
  residents replay their prefix) runs through both routers once: every
  stream's tokens equal the reference router's and the port's
  ``decode_single``, and every step-counted statistic is the reference's;
* the router's other fault-plane paths (graceful drain, restart, backoff,
  fifo-reject, whole-fleet death, a hang) hold every completed stream to
  the port's ``decode_single`` with no JAX run;
* the serve CLI's ``--shards`` / ``--fault-spec`` path serves on the CPU.
"""
import argparse
import contextlib
import dataclasses
import functools
import io
import math
import re
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import engine as JE  # noqa: E402
from repro.launch import fleet as JF  # noqa: E402
from repro.runtime import sharding as JS  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import tree_util as tu  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch import fleet as TF  # noqa: E402
from repro_torch.launch import serve as TS  # noqa: E402
from repro_torch.runtime import sharding as TSH  # noqa: E402
from repro_torch.runtime.fault import StepWatchdog  # noqa: E402

ARCH = "lstm-rnnt"

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _built():
    """(reference params, qlayers, cfg, port params, port qlayers)."""
    params, qlayers, cfg, _ = golden.build_lm_case(ARCH)
    t_params = convert.params_from_numpy(jax.device_get(params))
    t_qlayers = convert.qlayers_from_numpy(
        [(jax.device_get(a), dataclasses.asdict(s)) for a, s in qlayers])
    return params, qlayers, cfg, t_params, t_qlayers


def _port():
    _, _, cfg, t_params, t_qlayers = _built()
    return t_params, t_qlayers, cfg


def _requests(spec, *, arrivals=None, mod=TE):
    """The workload of ``tests/test_fleet.py``: prompts drawn from
    ``default_rng(7)``, one ``(prompt_len, max_new)`` pair a request."""
    cfg = _built()[2]
    rng = np.random.default_rng(7)
    return [mod.Request(
        rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(p,)),
        max_new_tokens=g,
        arrival=float(arrivals[i]) if arrivals else 0.0)
        for i, (p, g) in enumerate(spec)]


@functools.lru_cache(maxsize=None)
def _single(prompt: tuple, n: int):
    params, qlayers, cfg = _port()
    return TE.decode_single(params, qlayers, cfg, np.asarray(prompt), n)


def _reference(requests):
    return {r.rid: _single(tuple(r.prompt.tolist()), r.max_new_tokens)
            for r in requests}


def _router(**kw):
    params, qlayers, cfg = _port()
    return TF.FleetRouter(params, qlayers, cfg, **kw)


# ---------------------------------------------------------------------------
# The fault plane and the placement against the reference's (no model)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(shard=0), dict(shard=0, at_step=3, at_frac=0.5),
    dict(shard=0, at_frac=1.5), dict(shard=1, at_frac=-0.1)],
    ids=["neither", "both", "above-1", "below-0"])
def test_killspec_rejects_what_the_reference_rejects(kw):
    with pytest.raises(ValueError) as want:
        JF.KillSpec(**kw)
    with pytest.raises(ValueError) as got:
        TF.KillSpec(**kw)
    assert str(got.value) == str(want.value)


def test_kills_fire_exactly_once_as_in_the_reference():
    kills = [dict(shard=0, at_step=5), dict(shard=1, at_frac=0.5),
             dict(shard=0, at_frac=0.9, graceful=True, restart_after=3)]
    clock = [(4, 0.0), (5, 0.0), (6, 0.4), (7, 0.6), (8, 0.95), (9, 1.0)]
    j, t = JF.FaultInjector(kills=kills), TF.FaultInjector(kills=kills)
    fired = []
    for step, frac in clock:
        want = [(k.shard, k.graceful) for k in j.kills_due(step, frac)]
        got = [(k.shard, k.graceful) for k in t.kills_due(step, frac)]
        assert got == want, (step, frac)
        fired += got
    assert fired == [(0, False), (1, False), (0, True)]


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_admission_failures_equal_the_reference(seed, rate):
    """The same (seed, rid, attempt) draws as the reference, so one seed
    gives one failure pattern in both packages."""
    fails = {4: 2, 9: 1}
    j = JF.FaultInjector(seed=seed, admission_fails=fails,
                         admission_fail_rate=rate)
    t = TF.FaultInjector(seed=seed, admission_fails=fails,
                         admission_fail_rate=rate)
    got = [[t.admission_fails_for(rid, a) for a in range(4)]
           for rid in range(64)]
    want = [[j.admission_fails_for(rid, a) for a in range(4)]
            for rid in range(64)]
    assert got == want
    assert got[4][:2] == [True, True] and got[9][0]
    share = sum(map(sum, got)) / (64 * 4)
    assert 0 < share < 1


def test_from_spec_rejects_unknown_keys_as_the_reference():
    for bad in ({"kils": []}, {"seed": 1, "hang": []}):
        with pytest.raises(ValueError) as want:
            JF.FaultInjector.from_spec(bad)
        with pytest.raises(ValueError) as got:
            TF.FaultInjector.from_spec(bad)
        assert str(got.value) == str(want.value)
    spec = {"seed": 1, "kills": [{"shard": 0, "at_frac": 0.5}],
            "hangs": [{"shard": 1, "at_step": 2, "sleep_s": 0.0}],
            "admission_fails": {"7": 2}, "admission_fail_rate": 0.25}
    j, t = JF.FaultInjector.from_spec(spec), TF.FaultInjector.from_spec(spec)
    assert t.seed == j.seed == 1
    assert t.admission_fails == j.admission_fails == {7: 2}
    assert t.admission_fail_rate == j.admission_fail_rate
    assert [dataclasses.asdict(k) for k in t.kills] == \
        [dataclasses.asdict(k) for k in j.kills]
    assert [dataclasses.asdict(h) for h in t.hangs] == \
        [dataclasses.asdict(h) for h in j.hangs]


def test_hook_only_for_targeted_shards_and_fires_as_the_reference():
    hangs = [dict(shard=1, at_step=2, sleep_s=0.25, repeat=2)]
    j, t = JF.FaultInjector(hangs=hangs), TF.FaultInjector(hangs=hangs)
    assert t.hook_for(0) is None and j.hook_for(0) is None
    slept = {"j": [], "t": []}
    j._sleep, t._sleep = slept["j"].append, slept["t"].append
    hj, ht = j.hook_for(1), t.hook_for(1)
    for step in range(6):
        hj(step)
        ht(step)
        assert slept["t"] == slept["j"], step
    assert slept["t"] == [0.25, 0.25]


@pytest.mark.parametrize("n_shards,n_devices",
                         [(1, 1), (2, 8), (3, 8), (4, 4), (9, 8), (2, 1)])
def test_fleet_device_groups_match_the_reference(n_shards, n_devices):
    """Contiguous, equal, disjoint groups with leftovers unused, or None
    below ``n_shards`` devices, as the reference partitions them."""
    devs = [torch.device("cuda", i) for i in range(n_devices)]
    got = TSH.fleet_device_groups(n_shards, devices=devs)
    want = JS.fleet_device_groups(n_shards, devices=list(range(n_devices)))
    if want is None:
        assert got is None
        return
    assert [[d.index for d in g] for g in got] == want
    flat = [d.index for g in got for d in g]
    assert len(set(flat)) == len(flat) == (n_devices // n_shards) * n_shards


def test_fleet_device_groups_defaults_and_errors():
    with pytest.raises(ValueError):
        TSH.fleet_device_groups(0, devices=[torch.device("cpu")])
    if not torch.cuda.is_available():  # the CPU: every shard co-located
        assert TSH.fleet_device_groups(1) is None


def test_model_to_shares_the_weights_on_their_own_device():
    params, qlayers, _ = _port()
    p, q = convert.model_to(params, qlayers, "cpu")
    got, want = tu.leaves((p, q)), tu.leaves((params, qlayers))
    assert len(got) == len(want)
    assert all(a is b for a, b in zip(got, want))
    assert all(a[1] is b[1] for a, b in zip(q, qlayers))  # the specs
    moved, _ = convert.model_to(params, qlayers, "meta")  # elsewhere: moved
    assert moved["embedding"].device.type == "meta"


# ---------------------------------------------------------------------------
# The acceptance case through both routers
# ---------------------------------------------------------------------------

ACCEPT_SPEC = [(3, 12), (3, 12), (3, 12), (3, 12), (2, 3), (2, 3)]
ACCEPT_ARRIVALS = [0, 0, 0, 0, 2, 2]
ACCEPT_ROUTER = dict(n_shards=2, slots_per_shard=2, oversubscribe=2.0,
                     policy="srf")
STAT_FIELDS = ("submitted", "completed", "rejected", "lost", "kills",
               "restarts", "migrated_streams", "replayed_streams",
               "rerouted_pending", "admit_retries", "fleet_steps",
               "generated_tokens")
SHARD_FIELDS = ("steps", "adopted", "generated_tokens", "preemptions")
STREAM_FIELDS = ("tokens", "arrival_step", "admit_step", "first_token_step",
                 "finished_step", "ttft_steps", "shard", "migrations",
                 "replays", "admit_attempts", "truncated", "rejected")


def _accept_run(mod, params, qlayers, cfg, **extra):
    inj = mod.FaultInjector(seed=0, kills=[dict(shard=0, at_step=5)])
    router = mod.FleetRouter(params, qlayers, cfg, injector=inj,
                             **ACCEPT_ROUTER, **extra)
    router.warmup()
    router.submit_all(_requests(ACCEPT_SPEC, arrivals=ACCEPT_ARRIVALS,
                                mod=JE if mod is JF else TE))
    return router.run()


@pytest.fixture(scope="module")
def accept():
    """``(reference (results, stats), port (results, stats))`` of the
    acceptance case; the reference router runs once for the module."""
    params, qlayers, cfg, t_params, t_qlayers = _built()
    want = _accept_run(JF, params, qlayers, cfg, backend="xla")
    got = _accept_run(TF, t_params, t_qlayers, cfg)
    return want, got


def test_acceptance_streams_equal_reference_router_and_decode_single(accept):
    (j_res, _), (t_res, t_stats) = accept
    reqs = _requests(ACCEPT_SPEC, arrivals=ACCEPT_ARRIVALS)
    ref = _reference(reqs)
    assert sorted(t_res) == sorted(j_res) == sorted(ref)
    for r in reqs:
        fr = t_res[r.rid]
        assert fr.tokens == j_res[r.rid].tokens, f"stream {r.rid}"
        assert fr.tokens == ref[r.rid], f"stream {r.rid} != decode_single"
        assert not fr.truncated and not fr.rejected
        assert len(fr.tokens) == r.max_new_tokens
    assert t_stats.completed == len(reqs) and t_stats.kills == 1
    # both recovery paths ran: a pooled stream migrated with its state and
    # a resident one replayed its prefix
    assert t_stats.migrated_streams >= 1, "no pooled stream migrated"
    assert t_stats.replayed_streams >= 1, "no resident stream replayed"


def test_acceptance_fleet_stats_equal_the_reference(accept):
    (_, j_stats), (_, t_stats) = accept
    for field in STAT_FIELDS:
        assert getattr(t_stats, field) == getattr(j_stats, field), field


def test_acceptance_shard_stats_equal_the_reference(accept):
    (_, j_stats), (_, t_stats) = accept
    assert len(t_stats.shards) == len(j_stats.shards) == 2
    for i, (t, j) in enumerate(zip(t_stats.shards, j_stats.shards)):
        for field in SHARD_FIELDS + ("kills", "restarts", "alive"):
            assert getattr(t, field) == getattr(j, field), (i, field)
    assert not t_stats.shards[0].alive and t_stats.shards[1].alive


def test_acceptance_stream_stamps_equal_the_reference(accept):
    (j_res, _), (t_res, _) = accept
    for rid, j in j_res.items():
        for field in STREAM_FIELDS:
            assert getattr(t_res[rid], field) == getattr(j, field), \
                (rid, field)
    assert sum(r.migrations for r in t_res.values()) >= 1
    assert sum(r.replays for r in t_res.values()) >= 1


# ---------------------------------------------------------------------------
# The router's other fault-plane paths against the port's decode_single
# ---------------------------------------------------------------------------


def _served(router, reqs):
    router.submit_all(reqs)
    return router.run()


def test_graceful_drain_migrates_everything():
    reqs = _requests([(2, 9), (3, 7), (5, 6), (2, 8)])
    inj = TF.FaultInjector(kills=[dict(shard=0, at_step=5, graceful=True)])
    router = _router(n_shards=2, slots_per_shard=2, injector=inj)
    router.warmup()
    results, stats = _served(router, reqs)
    assert stats.kills == 1
    assert stats.replayed_streams == 0  # graceful: nothing re-ingests
    assert stats.migrated_streams >= 1
    ref = _reference(reqs)
    for r in reqs:
        assert results[r.rid].tokens == ref[r.rid]


def test_kill_with_restart_rejoins_the_fleet():
    reqs = _requests([(2, 9), (3, 9), (2, 8), (3, 8), (2, 7), (3, 7)],
                     arrivals=[0, 0, 0, 8, 10, 12])
    inj = TF.FaultInjector(kills=[dict(shard=0, at_step=4,
                                       restart_after=4)])
    router = _router(n_shards=2, slots_per_shard=2, injector=inj)
    router.warmup()
    dead_engine = router.shards[0].engine
    results, stats = _served(router, reqs)
    assert stats.kills == 1 and stats.restarts == 1
    assert stats.shards[0].restarts == 1 and stats.shards[0].alive
    # the restart built a fresh engine (fresh slot tensors) that took work
    assert router.shards[0].engine is not dead_engine
    assert router.shards[0].engine._state is not dead_engine._state
    assert stats.shards[0].generated_tokens > 0
    ref = _reference(reqs)
    for r in reqs:
        assert results[r.rid].tokens == ref[r.rid]


def test_admission_retry_backoff_and_exhaustion():
    reqs = _requests([(2, 5), (3, 5), (2, 4)])
    inj = TF.FaultInjector(admission_fails={0: 2, 1: 99})
    router = _router(n_shards=1, slots_per_shard=2, injector=inj,
                     max_admit_attempts=3, backoff_steps=1,
                     backoff_cap_steps=4)
    results, stats = _served(router, reqs)
    ref = _reference(reqs)
    # rid 0: attempts 0 and 1 fail, attempt 2 lands after backing off
    # 1 then 2 fleet steps
    assert results[0].admit_attempts == 3 and results[0].admit_step == 3
    assert results[0].tokens == ref[0]
    # rid 1: budget exhausted -> rejected, no tokens
    assert results[1].rejected and results[1].tokens == []
    assert results[2].tokens == ref[2]
    assert stats.admit_retries == 4 and stats.rejected == 1


def test_saturated_fleet_degrades_to_fifo_reject():
    reqs = _requests([(2, 8), (2, 8), (2, 8), (2, 8)])
    router = _router(n_shards=1, slots_per_shard=1, max_queue=1)
    results, stats = _served(router, reqs)
    assert stats.rejected >= 1  # overflow bounced, fifo-reject style
    assert stats.completed >= 1
    assert stats.completed + stats.rejected == len(reqs)
    ref = _reference(reqs)
    for fr in results.values():
        if not fr.rejected:
            assert fr.tokens == ref[fr.rid]


def test_whole_fleet_death_surfaces_lost_streams_with_their_prefixes():
    reqs = _requests([(2, 8), (3, 8)])
    inj = TF.FaultInjector(kills=[dict(shard=0, at_step=4)])
    router = _router(n_shards=1, slots_per_shard=2, injector=inj)
    results, stats = _served(router, reqs)
    assert stats.lost == len(reqs)  # no survivor, no restart scheduled
    ref = _reference(reqs)
    for r in reqs:
        fr = results[r.rid]
        assert fr.truncated  # surfaced, not silently dropped
        # what the dead shard had generated survives as the prefix
        assert 0 < len(fr.tokens) < r.max_new_tokens
        assert fr.tokens == ref[r.rid][:len(fr.tokens)]


def test_duplicate_and_negative_rids_rejected():
    router = _router(n_shards=1, slots_per_shard=2)
    router.submit(TE.Request(rid=5, prompt=np.zeros(2, np.int32),
                             max_new_tokens=2))
    with pytest.raises(ValueError, match="duplicate"):
        router.submit(TE.Request(rid=5, prompt=np.ones(3, np.int32),
                                 max_new_tokens=3))
    with pytest.raises(ValueError, match=">= 0"):
        router.submit(TE.Request(rid=-3, prompt=np.zeros(2, np.int32),
                                 max_new_tokens=2))
    with pytest.raises(ValueError, match="devices"):
        _router(n_shards=2, slots_per_shard=2,
                devices=[torch.device("cpu")])


def test_hang_verdict_drains_shard():
    """An injected step hang trips shard 0's watchdog and ``on_hang="kill"``
    drains it gracefully; the streams finish on shard 1 bit-exactly.

    The verdict cannot depend on the host's load: the injected sleep is
    derived, when it fires, from shard 0's warmed watchdog (at least 30 x
    its EMA and at least 0.3 s), and the watchdog holds the step against
    that same EMA at a factor of 10.  Shard 1's watchdog never rules a step
    hung (an infinite factor), so a slow survivor step on a loaded host
    cannot take down the fleet."""
    reqs = _requests([(2, 9), (3, 7), (5, 6), (2, 8)])
    wds = iter([StepWatchdog(), StepWatchdog(timeout_factor=math.inf)])
    # warmup takes engine steps 0-2 (2 prompt tokens, 2 generated); the
    # hang fires on shard 0's third serving step, after two have seeded
    # the EMA
    inj = TF.FaultInjector(hangs=[dict(shard=0, at_step=5, sleep_s=0.3)])
    router = _router(n_shards=2, slots_per_shard=2, injector=inj,
                     on_hang="kill", watchdog_factory=lambda: next(wds))
    router.warmup()
    assert router.shards[0].engine._step == 3
    wd0 = router.shards[0].engine.watchdog
    slept = []

    def sleep(s):
        assert wd0.ema_s is not None, "the hang fired before a warm step"
        slept.append(max(s, 30 * wd0.ema_s))
        time.sleep(slept[-1])

    inj._sleep = sleep
    results, stats = _served(router, reqs)
    assert stats.hang_events >= 1
    assert stats.kills == 1 and stats.replayed_streams == 0
    assert not stats.shards[0].alive and stats.shards[1].alive
    ref = _reference(reqs)
    for r in reqs:
        assert results[r.rid].tokens == ref[r.rid]


# ---------------------------------------------------------------------------
# The serve CLI's fleet path on the CPU
# ---------------------------------------------------------------------------

CLI = ["--arch", ARCH, "--smoke", "--quant", "int8-lstm", "--device", "cpu",
       "--engine", "--shards", "2", "--slots", "2", "--requests", "6",
       "--prompt-len", "8", "--gen", "8"]


def test_fleet_cli_serves_through_a_kill_and_a_restart():
    spec = '{"kills": [{"shard": 0, "at_frac": 0.5, "restart_after": 4}]}'
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        TS.main(CLI + ["--fault-spec", spec])
    text = out.getvalue()
    assert "served 6/6 requests" in text, text
    assert "fault plane: 1 kills, 1 restarts" in text, text
    assert "devices=0/2" in text
    launches = re.search(r"kernel launches: (.*)", text).group(1).split()
    assert launches and all(kv.endswith("=0") for kv in launches)
    # the sample is the first request's stream: decode_single of it on the
    # model the CLI built (seeded) over the CLI's own workload
    cfg = get_config(ARCH, smoke=True)
    args = argparse.Namespace(trace=None, requests=6, prompt_len=8, gen=8)
    first = TS.engine_requests(args, cfg, arrival_span=3)[0]
    params, qlayers = TS.build_model(cfg, 4, 8, torch.device("cpu"))
    want = TE.decode_single(params, qlayers, cfg, first.prompt,
                            first.max_new_tokens)
    sample = re.search(r"sample: (\[.*\])", text).group(1)
    assert sample == str(want)


@pytest.mark.parametrize("argv,message", [
    (["--shards", "2"], "--shards requires --engine"),
    (["--engine", "--shards", "0"], "--shards must be >= 1"),
    (["--engine", "--fault-spec", "{}"], "--fault-spec requires --shards"),
], ids=["no-engine", "zero-shards", "spec-without-shards"])
def test_fleet_cli_argument_errors(argv, message, capsys):
    with pytest.raises(SystemExit) as exc:
        TS.main(["--arch", ARCH, "--smoke", "--quant", "int8-lstm",
                 "--device", "cpu"] + argv)
    assert exc.value.code == 2
    assert message in capsys.readouterr().err
