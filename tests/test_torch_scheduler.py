"""The port's scheduler, state pool and engine policies (host units).

The host-only units of ``tests/test_scheduler.py``, run against the port's
own copies (``repro_torch.launch.{state_pool,scheduler,engine}``): pool
paging, recycling and its misuse errors; each policy's elections on
fabricated views; and, on the port's own ``lstm-rnnt-smoke`` model (seeded
torch init on the CPU), FIFO reproducing the pre-split admission loop,
eviction through the pool, and every policy x oversubscription staying
bit-identical to ``decode_single``.  The request traces equal the
reference's for the same seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import SMOKE_CONFIGS  # noqa: E402
from repro_torch.launch import engine as E  # noqa: E402
from repro_torch.launch import scheduler as S  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.state_pool import StatePool  # noqa: E402

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# StatePool (pure host, no model)
# ---------------------------------------------------------------------------


def _fake_state(fill: int):
    return {
        "h": [np.full((1, 4), fill, np.int8),
              np.full((1, 6), fill + 1, np.int8)],
        "c": [np.full((1, 4), fill + 2, np.int16),
              np.full((1, 6), fill + 3, np.int16)],
        "len": np.asarray([fill], np.int32),
    }


def _assert_state_equal(a, b):
    for k in ("h", "c"):
        for x, y in zip(a[k], b[k]):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_array_equal(np.asarray(a["len"]),
                                  np.asarray(b["len"]))


def test_pool_pages_allocate_lazily_and_rows_recycle():
    pool = StatePool(page_size=2)
    assert pool.n_pages == 0 and pool.state_bytes_per_stream == 0
    pool.put("a", _fake_state(1))
    pool.put("b", _fake_state(2))
    assert pool.n_pages == 1 and pool.capacity == 2
    assert pool.location("a") == (0, 0) and pool.location("b") == (0, 1)
    pool.put("c", _fake_state(3))  # page 0 full -> page 1 allocates
    assert pool.n_pages == 2 and pool.location("c") == (1, 0)
    # rows recycle LIFO: freeing b makes (0, 1) the next allocation
    _assert_state_equal(pool.take("b"), _fake_state(2))
    pool.put("d", _fake_state(4))
    assert pool.location("d") == (0, 1)
    assert pool.n_pages == 2  # no growth while a row is free
    # round trips are bitwise: every parked stream reads back exactly
    _assert_state_equal(pool.take("a"), _fake_state(1))
    _assert_state_equal(pool.take("c"), _fake_state(3))
    _assert_state_equal(pool.take("d"), _fake_state(4))
    assert len(pool) == 0 and pool.peak_live == 3
    assert pool.state_bytes_per_stream == 4 + 6 + 2 * (4 + 6) + 4


def test_pool_misuse_raises_not_fabricates():
    pool = StatePool(page_size=2)
    pool.put("a", _fake_state(1))
    with pytest.raises(ValueError, match="double swap-out"):
        pool.put("a", _fake_state(1))
    with pytest.raises(ValueError, match="double resume"):
        pool.take("missing")
    pool.take("a")
    with pytest.raises(ValueError, match="double resume"):
        pool.take("a")
    with pytest.raises(ValueError, match="double free"):
        pool.free("a")
    with pytest.raises(ValueError, match="batch-1"):
        pool.put("bad", {"h": [np.zeros((2, 4), np.int8)],
                         "c": [np.zeros((2, 4), np.int16)],
                         "len": np.zeros((2,), np.int32)})
    with pytest.raises(ValueError, match="page_size"):
        StatePool(page_size=0)


# ---------------------------------------------------------------------------
# Scheduler policies (pure host, fabricated views)
# ---------------------------------------------------------------------------


def _view(rid, *, prio=0, arrival=0.0, sub=None, p_rem=0, g_rem=4,
          resident=False, slot=None, plen=4):
    return S.StreamView(
        rid=rid, priority=prio, arrival=arrival,
        submit_idx=rid if sub is None else sub, prompt_len=plen,
        prompt_remaining=p_rem, gen_remaining=g_rem, resident=resident,
        slot=slot)


def test_fifo_keeps_residents_then_pool_then_queue():
    sch = S.get_scheduler("fifo")
    resident = [_view(0, resident=True, slot=0)]
    pooled = [_view(1)]
    pending = [_view(2), _view(3), _view(4)]
    d = sch.schedule(0, resident, pooled, pending, 3, 5)
    assert d.run == [0, 1, 2] and d.reject == []
    # start budget caps NEW streams only; live (pooled) always placeable
    d = sch.schedule(0, resident, pooled, pending, 3, 0)
    assert d.run == [0, 1]


def test_fifo_reject_refuses_unplaced_arrivals():
    sch = S.get_scheduler("fifo-reject")
    d = sch.schedule(0, [_view(0, resident=True, slot=0)], [],
                     [_view(1), _view(2)], 2, 8)
    assert d.run == [0, 1] and d.reject == [2]


def test_priority_preempts_lowest_resident():
    sch = S.get_scheduler("priority")
    resident = [_view(0, prio=0, resident=True, slot=0),
                _view(1, prio=2, resident=True, slot=1)]
    d = sch.schedule(3, resident, [], [_view(2, prio=5)], 2, 2)
    assert d.run == [2, 1]  # prio 5 and 2 hold slots; prio 0 parks
    # equal priorities degrade to FIFO: both residents outrank the later
    # arrival (list order ranks by priority, residents keep their slots)
    d = sch.schedule(3, resident, [], [_view(2, prio=0)], 2, 2)
    assert d.run == [1, 0]


def test_srf_ranks_by_total_remaining_work():
    sch = S.get_scheduler("srf")
    resident = [_view(0, g_rem=9, resident=True, slot=0)]
    pending = [_view(1, p_rem=2, g_rem=2), _view(2, p_rem=1, g_rem=1)]
    d = sch.schedule(0, resident, [], pending, 2, 4)
    assert d.run == [2, 1]  # 2 and 4 tokens left beat the 9-token resident
    d = sch.schedule(0, resident, [], pending, 2, 0)  # no start budget
    assert d.run == [0]


def test_round_robin_rotates_on_quantum_expiry():
    sch = S.RoundRobinFairScheduler(quantum=2)
    # single slot, two streams: a runs its 2-step quantum, then b, then a...
    runs = []
    for step in range(6):
        av = _view(0, g_rem=9, resident=(runs and runs[-1] == [0]) or False,
                   slot=0 if runs and runs[-1] == [0] else None)
        bv = _view(1, g_rem=9, resident=bool(runs and runs[-1] == [1]),
                   slot=0 if runs and runs[-1] == [1] else None)
        resident = [v for v in (av, bv) if v.resident]
        others = [v for v in (av, bv) if not v.resident]
        # after first sight both are live (pooled when not resident)
        pooled = others if step else []
        pending = [] if step else others
        d = sch.schedule(step, resident, pooled, pending, 1, 2)
        runs.append(d.run)
    assert runs == [[0], [0], [1], [1], [0], [0]]
    with pytest.raises(ValueError, match="quantum"):
        S.RoundRobinFairScheduler(quantum=0)


def test_get_scheduler_registry():
    assert S.get_scheduler("srf").name == "srf"
    inst = S.FIFOScheduler()
    assert S.get_scheduler(inst) is inst
    with pytest.raises(ValueError, match="unknown scheduling policy"):
        S.get_scheduler("lifo")


# ---------------------------------------------------------------------------
# Engine integration (shared quantized smoke model)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def qlm():
    cfg = SMOKE_CONFIGS["lstm-rnnt"]
    params, qlayers = serve.build_model(cfg, 4, 8, torch.device("cpu"))
    return params, qlayers, cfg


def _requests(cfg, spec, *, seed=7):
    """spec: list of (prompt_len, gen[, priority[, arrival]])."""
    rng = np.random.default_rng(seed)
    out = []
    for i, entry in enumerate(spec):
        p, g = entry[0], entry[1]
        prio = entry[2] if len(entry) > 2 else 0
        arrival = entry[3] if len(entry) > 3 else 0
        out.append(E.Request(
            rid=i, prompt=rng.integers(0, cfg.vocab_size, size=(p,)),
            max_new_tokens=g, priority=prio, arrival=arrival))
    return out


def _reference(params, qlayers, cfg, requests):
    return {r.rid: E.decode_single(params, qlayers, cfg, r.prompt,
                                   r.max_new_tokens) for r in requests}


def _old_engine_admission_schedule(spec, n_slots):
    """Reference simulation of the PRE-SPLIT engine's admission loop: each
    step, slots are scanned in increasing index and every free slot pops the
    queue head.  A chunk=1 stream occupies its slot for exactly
    ``prompt_len - 1 + gen`` steps (one token fed per step; generation
    starts on the step consuming the last prompt token).  Returns the
    [(step, rid, slot)] admission trail the refactored engine must
    reproduce verbatim under the default FIFO policy.
    """
    queue = list(range(len(spec)))
    slots = [None] * n_slots  # rid or None
    left = {}  # rid -> resident steps remaining
    admissions = []
    step = 0
    while queue or any(r is not None for r in slots):
        for i in range(n_slots):
            if slots[i] is None and queue:
                rid = queue.pop(0)
                slots[i] = rid
                p, g = spec[rid][0], spec[rid][1]
                left[rid] = p - 1 + g
                admissions.append((step, rid, i))
        for i in range(n_slots):
            if slots[i] is not None:
                left[slots[i]] -= 1
                if left[slots[i]] == 0:
                    slots[i] = None
        step += 1
    return admissions


def test_fifo_reproduces_pre_split_admission_schedule(qlm):
    """The acceptance-criteria regression: default FIFO at oversubscribe=1
    makes the same step-by-step slot assignments as the monolithic engine's
    admission loop -- verified against a host-side simulation of that loop,
    and with zero preemptions/resumes/pool traffic."""
    params, qlayers, cfg = qlm
    spec = [(2, 4), (3, 2), (1, 6), (2, 2), (4, 3), (1, 1), (2, 5)]
    requests = _requests(cfg, spec)
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=3)
    eng.submit_all(requests)
    results, stats = eng.run()
    got = [(step, rid, slot) for step, ev, rid, slot in eng.schedule_log
           if ev == "admit"]
    assert got == _old_engine_admission_schedule(spec, 3)
    assert [ev for _, ev, _, _ in eng.schedule_log
            if ev != "admit"] == []  # FIFO never preempts/resumes/rejects
    assert stats.preemptions == 0 and stats.resumes == 0
    assert stats.rejected == 0 and len(eng.pool) == 0
    assert len(results) == len(spec)


def test_evict_preserve_resume_is_bitexact(qlm):
    """Satellite regression: user eviction routes through the pool.
    ``evict(preserve=True)`` records state_preserved and ``resume`` then
    continues the stream BIT-exactly (including its drafter-free partial
    output); ``preserve=False`` keeps the old discard semantics."""
    params, qlayers, cfg = qlm
    requests = _requests(cfg, [(2, 10), (3, 8)], seed=5)
    ref = _reference(params, qlayers, cfg, requests)
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2)
    eng.submit_all(requests)
    _, _ = eng.run(max_steps=5, keep_live=True)
    partial = eng.evict(0, preserve=True)
    assert partial.truncated and partial.state_preserved
    assert partial.tokens == ref[0][:len(partial.tokens)]
    assert len(partial.tokens) < len(ref[0])
    assert 0 in eng.pool  # the state physically lives in the pool
    with pytest.raises(ValueError, match="not live"):
        eng.evict(0)  # parked streams left the live set
    eng.resume(0)
    with pytest.raises(ValueError, match="double resume"):
        eng.resume(0)
    results, stats = eng.run()
    assert results[0].tokens == ref[0]  # resumed stream: full bit-exact
    assert results[1].tokens == ref[1]  # co-tenant undisturbed
    assert results[0].preemptions >= 1
    assert stats.resumes >= 1

    # preserve=False keeps the pre-split discard semantics, visibly
    eng2 = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2)
    eng2.submit_all(_requests(cfg, [(2, 10)], seed=5))
    eng2.run(max_steps=4, keep_live=True)
    dropped = eng2.evict(0, preserve=False)
    assert dropped.truncated and not dropped.state_preserved
    assert len(eng2.pool) == 0
    with pytest.raises(ValueError, match="not parked"):
        eng2.resume(0)


def test_priority_policy_preempts_and_stays_bitexact(qlm):
    """A high-priority arrival preempts a low-priority resident to the pool
    mid-generation; both still emit bit-exact tokens."""
    params, qlayers, cfg = qlm
    spec = [(2, 8, 0, 0), (3, 8, 0, 0), (2, 4, 5, 3)]
    requests = _requests(cfg, spec, seed=9)
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2,
                                     policy="priority", oversubscribe=2.0)
    eng.submit_all(requests)
    results, stats = eng.run()
    assert stats.policy == "priority"
    assert stats.preemptions >= 1 and stats.resumes >= 1
    assert stats.peak_live == 3  # lived over-subscribed: 3 streams, 2 slots
    ref = _reference(params, qlayers, cfg, requests)
    for r in requests:
        assert results[r.rid].tokens == ref[r.rid], f"stream {r.rid} drifted"
    # the preempted stream knows it bounced
    assert max(res.preemptions for res in results.values()) >= 1


def test_rr_policy_time_slices_one_slot_bitexact(qlm):
    """Round-robin on ONE slot with two long streams forces repeated
    preempt/resume swaps through the pool -- the stress case for bit-exact
    state round trips."""
    params, qlayers, cfg = qlm
    requests = _requests(cfg, [(2, 8), (2, 8)], seed=3)
    eng = E.ContinuousBatchingEngine(
        params, qlayers, cfg, n_slots=1,
        policy=S.RoundRobinFairScheduler(quantum=3), oversubscribe=2.0)
    eng.submit_all(requests)
    results, stats = eng.run()
    assert stats.preemptions >= 2 and stats.resumes >= 2
    ref = _reference(params, qlayers, cfg, requests)
    for r in requests:
        assert results[r.rid].tokens == ref[r.rid], f"stream {r.rid} drifted"
    assert stats.pool_state_bytes > 0


def test_fifo_reject_policy_drops_overflow_loudly(qlm):
    """The rejection baseline: arrivals that find no free slot are refused
    with an explicit rejected result, never silently dropped."""
    params, qlayers, cfg = qlm
    requests = _requests(cfg, [(2, 6), (2, 6), (2, 6)], seed=1)
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2,
                                     policy="fifo-reject")
    eng.submit_all(requests)
    results, stats = eng.run()
    assert stats.rejected == 1
    rej = [r for r in results.values() if r.rejected]
    assert len(rej) == 1 and rej[0].tokens == [] and rej[0].truncated
    served = [r for r in results.values() if not r.rejected]
    ref = _reference(params, qlayers, cfg, requests)
    for res in served:
        assert res.tokens == ref[res.rid]


def test_arrival_gates_admission(qlm):
    """A request with a future arrival step must not be admitted before it;
    the engine idles (empty steps) when nothing else is runnable."""
    params, qlayers, cfg = qlm
    requests = _requests(cfg, [(2, 2, 0, 4)], seed=2)
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2)
    eng.submit_all(requests)
    results, stats = eng.run()
    admit = [(s, rid) for s, ev, rid, _ in eng.schedule_log if ev == "admit"]
    assert admit == [(4, 0)]
    assert results[0].admitted_step == 4
    assert results[0].tokens == _reference(params, qlayers, cfg,
                                           requests)[0]


def test_trace_schema_priority_and_arrival(tmp_path, qlm):
    """Satellite: the shared trace schema carries priority/arrival, with
    loud ValueError validation in both load_trace and Request."""
    import json

    _, _, cfg = qlm
    path = tmp_path / "t.json"
    path.write_text(json.dumps([
        {"prompt_len": 3, "gen": 2, "priority": 2, "arrival": 5},
        {"prompt": [1, 2], "gen": 1},
    ]))
    reqs = E.load_trace(str(path), cfg.vocab_size)
    assert reqs[0].priority == 2 and reqs[0].arrival == 5.0
    assert reqs[1].priority == 0 and reqs[1].arrival == 0.0

    def write(payload):
        path.write_text(json.dumps(payload))
        return str(path)

    with pytest.raises(ValueError, match="'priority' must be an int"):
        E.load_trace(write([{"prompt_len": 2, "gen": 1,
                             "priority": "high"}]), cfg.vocab_size)
    with pytest.raises(ValueError, match="'arrival' must be a number"):
        E.load_trace(write([{"prompt_len": 2, "gen": 1, "arrival": -3}]),
                     cfg.vocab_size)
    with pytest.raises(ValueError, match="arrival"):
        E.Request(rid=0, prompt=np.array([1]), max_new_tokens=1,
                  arrival=-1.0)
    with pytest.raises(ValueError, match="oversubscribe"):
        E.ContinuousBatchingEngine(*qlm, n_slots=1, oversubscribe=0.5)
    # synthetic_trace threads the new fields through
    reqs = E.synthetic_trace(8, cfg.vocab_size, seed=0,
                             priority_levels=(0, 1, 2), arrival_span=6)
    assert any(r.arrival > 0 for r in reqs)
    assert {r.priority for r in reqs} <= {0, 1, 2}


@pytest.mark.parametrize("policy", ["fifo", "priority", "srf", "rr"])
@pytest.mark.parametrize("oversubscribe", [1.0, 2.0])
def test_policy_sweep_bitexact_deterministic(qlm, policy, oversubscribe):
    """Deterministic slice of the acceptance gate (runs even without
    hypothesis): a fixed mixed workload -- staggered arrivals, inverted
    priorities, short and long streams -- under every preempting policy x
    oversubscription must emit tokens bit-identical to decode_single AND to
    the FIFO/no-oversubscription engine.  Policies may only change WHEN
    tokens come out, never WHICH tokens."""
    params, qlayers, cfg = qlm
    spec = [(2, 5, 0, 0), (3, 2, 2, 0), (1, 6, 1, 1), (4, 3, 3, 4),
            (2, 1, 0, 4), (1, 4, 2, 9)]
    requests = _requests(cfg, spec, seed=11)
    ref = _reference(params, qlayers, cfg, requests)

    fifo = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=3)
    fifo.submit_all([E.Request(rid=r.rid, prompt=r.prompt,
                               max_new_tokens=r.max_new_tokens,
                               priority=r.priority, arrival=r.arrival)
                     for r in requests])
    fifo_results, _ = fifo.run()

    eng = E.ContinuousBatchingEngine(
        params, qlayers, cfg, n_slots=3, policy=policy,
        oversubscribe=oversubscribe)
    eng.submit_all(requests)
    results, stats = eng.run()

    assert len(results) == len(requests)
    for r in requests:
        assert results[r.rid].tokens == ref[r.rid], \
            f"{policy}@{oversubscribe}: stream {r.rid} drifted vs single"
        assert results[r.rid].tokens == fifo_results[r.rid].tokens, \
            f"{policy}@{oversubscribe}: stream {r.rid} drifted vs fifo"
    assert stats.peak_live <= eng.max_live
    assert len(eng.pool) == 0  # drained pool: nothing leaks across runs


def test_traces_equal_the_reference(tmp_path):
    """``synthetic_trace`` and ``load_trace`` draw the reference's requests
    from the same seed (both use numpy's ``default_rng``)."""
    import json

    pytest.importorskip("jax")
    from repro.launch import engine as JE

    def same(got, want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert (g.rid, g.max_new_tokens, g.priority, g.arrival) == (
                w.rid, w.max_new_tokens, w.priority, w.arrival)
            np.testing.assert_array_equal(g.prompt, w.prompt)

    kw = dict(seed=11, prompt_lens=(8, 16, 32), gen_lens=(4, 8, 16),
              priority_levels=(0, 1, 2), arrival_span=6)
    same(E.synthetic_trace(12, 4096, **kw), JE.synthetic_trace(12, 4096, **kw))
    path = tmp_path / "t.json"
    path.write_text(json.dumps([{"prompt_len": 5, "gen": 2, "arrival": 1},
                                {"prompt": [3, 1, 4], "gen": 4, "id": 9}]))
    same(E.load_trace(str(path), 4096, seed=1),
         JE.load_trace(str(path), 4096, seed=1))


@pytest.mark.parametrize("arch,extra", [
    ("gru-rnnt", ["--chunk", "4", "--speculate", "2", "--policy", "srf",
                  "--oversubscribe", "2.0"]),
    ("lstm-rnnt", [])], ids=["gru-srf-spec", "lstm-fifo"])
def test_engine_cli_runs_on_cpu(arch, extra):
    """``serve --engine`` on the CPU: every request served, the reference
    launcher's stats lines, no kernel launched (plain versions)."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", arch, "--smoke", "--quant",
                    "int8-" + arch.split("-")[0], "--engine", "--slots", "2",
                    "--requests", "5", "--prompt-len", "6", "--gen", "4",
                    "--device", "cpu", *extra])
    text = out.getvalue()
    assert "served 5/5 requests" in text
    assert "mean TTFT:" in text and "slot occupancy:" in text
    assert ("speculation: accept rate" in text) == ("--speculate" in extra)
    assert "int8_matmul=0 quant_lstm_scan=0 quant_gru_scan=0" in text
    sample = [ln for ln in text.splitlines() if ln.startswith("sample:")]
    assert len(sample) == 1


def test_serve_cli_refuses_mismatched_or_engine_only_flags():
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gru-rnnt", "--smoke", "--quant", "int8-lstm",
                    "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve.main(["--arch", "gru-rnnt", "--smoke", "--quant", "int8-gru",
                    "--speculate", "2", "--device", "cpu"])
