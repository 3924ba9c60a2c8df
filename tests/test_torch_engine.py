"""The port's continuous-batching engine against the JAX reference's.

On ``lstm-rnnt-smoke`` here and ``gru-rnnt-smoke`` in
``test_torch_engine_gru.py`` (which runs the cases defined below), with
params and quantized layers from ``golden.build_lm_case`` carried across,
the fixed workload of ``golden.engine_trace`` (8 requests, 4 slots) goes
through both engines.  Under ``(fifo, 1.0)`` and
the preempting ``(srf, 2.0)``, with chunked prefill K in {1, 4} and
speculation k in {0, 4}, every stream's tokens must equal the reference
engine's and the port's ``decode_single``, and both engines must make the
same schedule.  The parked state's bytes equal the reference's, and a
drained engine's streams continue bit-exactly in another engine
(``export_streams`` -> ``adopt_stream``).  The reference's own engine
tests hold its engine equal to its ``decode_single``.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.launch import engine as JE  # noqa: E402
from repro.launch.state_pool import StatePool as JPool  # noqa: E402
from repro.models import lstm_lm as JLM  # noqa: E402
from repro.testing import golden  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.launch import engine as TE  # noqa: E402
from repro_torch.launch.state_pool import StatePool as TPool  # noqa: E402
from repro_torch.models import lstm_lm as TLM  # noqa: E402

ARCH = "lstm-rnnt"

# The suite runs in several test processes that share the machine's cores;
# one intra-op thread per process keeps torch from oversubscribing them.
torch.set_num_threads(1)
CASES = [(policy, ratio, chunk, speculate)
         for policy, ratio in golden.ENGINE_GOLDEN_CASES
         for chunk in (1, 4) for speculate in (0, 4)]


def case_id(case) -> str:
    policy, ratio, chunk, speculate = case
    return f"{policy}-{ratio}-chunk{chunk}-spec{speculate}"


@functools.lru_cache(maxsize=None)
def _built(arch):
    """(reference params, qlayers, cfg, port params, port qlayers)."""
    params, qlayers, cfg, _ = golden.build_lm_case(arch)
    t_params = convert.params_from_numpy(jax.device_get(params))
    t_qlayers = convert.qlayers_from_numpy(
        [(jax.device_get(a), dataclasses.asdict(s)) for a, s in qlayers])
    return params, qlayers, cfg, t_params, t_qlayers


@functools.lru_cache(maxsize=None)
def _singles(arch):
    """Every request's tokens from the port's ``decode_single``."""
    _, _, cfg, t_params, t_qlayers = _built(arch)
    return {r.rid: TE.decode_single(t_params, t_qlayers, cfg, r.prompt,
                                    r.max_new_tokens)
            for r in golden.engine_trace(cfg)}


def _port_requests(cfg):
    return [TE.Request(rid=r.rid, prompt=r.prompt,
                       max_new_tokens=r.max_new_tokens, priority=r.priority,
                       arrival=r.arrival)
            for r in golden.engine_trace(cfg)]


def check_engine_case(arch, case):
    """Both engines over the fixed workload under one configuration."""
    policy, ratio, chunk, speculate = case
    params, qlayers, cfg, t_params, t_qlayers = _built(arch)
    j_eng = JE.ContinuousBatchingEngine(
        params, qlayers, cfg, n_slots=golden.ENGINE_SLOTS, backend="xla",
        chunk=chunk, speculate=speculate, policy=policy,
        oversubscribe=ratio)
    j_eng.submit_all(golden.engine_trace(cfg))
    j_res, j_stats = j_eng.run()
    t_eng = TE.ContinuousBatchingEngine(
        t_params, t_qlayers, cfg, n_slots=golden.ENGINE_SLOTS, chunk=chunk,
        speculate=speculate, policy=policy, oversubscribe=ratio)
    t_eng.submit_all(_port_requests(cfg))
    t_res, t_stats = t_eng.run()
    singles = _singles(arch)
    assert sorted(t_res) == sorted(j_res) == sorted(singles)
    for rid, want in singles.items():
        assert t_res[rid].tokens == j_res[rid].tokens, f"stream {rid}"
        assert t_res[rid].tokens == want, f"stream {rid} != decode_single"
        assert not t_res[rid].truncated
    # the same schedule, step for step, and the same accounting
    assert t_eng.schedule_log == j_eng.schedule_log
    for field in ("steps", "active_slot_steps", "generated_tokens",
                  "prompt_tokens", "preemptions", "resumes", "spec_steps",
                  "drafted_tokens", "accepted_draft_tokens",
                  "pool_state_bytes", "peak_live"):
        assert getattr(t_stats, field) == getattr(j_stats, field), field


def check_state_bytes(arch):
    """A parked stream costs the reference's bytes: every integer leaf of
    every layer plus the int32 ``len`` counter."""
    params, qlayers, cfg, t_params, t_qlayers = _built(arch)
    j_pool, t_pool = JPool(), TPool()
    j_state = JLM.init_quant_decode_state(qlayers, 2, per_slot_len=True)
    t_state = TLM.init_quant_decode_state(t_qlayers, 2, per_slot_len=True)
    j_pool.put(0, jax.device_get(JLM.slice_state(j_state, 1)))
    t_pool.put(0, TE._host(TLM.slice_state(t_state, 1)))
    width = {"h": TLM.stack_d_out(cfg), "c": 2 * cfg.d_rnn}
    want = cfg.n_layers * sum(width[k] for k in TLM.state_keys(cfg)) + 4
    assert t_pool.state_bytes_per_stream == j_pool.state_bytes_per_stream
    assert t_pool.state_bytes_per_stream == want
    back = t_pool.take(0)
    assert list(back) == list(TLM.state_keys(cfg)) + ["len"]


def check_export_adopt(arch):
    """Drain a busy engine mid-flight (some streams resident, some pooled,
    some pending) and continue every stream in a fresh engine: the adopted
    ones through the pool and a slot write, the pending ones resubmitted.
    Every stream still equals ``decode_single``."""
    _, _, cfg, t_params, t_qlayers = _built(arch)
    src = TE.ContinuousBatchingEngine(
        t_params, t_qlayers, cfg, n_slots=golden.ENGINE_SLOTS, chunk=4,
        policy="srf", oversubscribe=2.0)
    src.submit_all(_port_requests(cfg))
    done, _ = src.run(max_steps=5, keep_live=True)
    moved = src.export_streams(device_alive=True)
    assert src.live == 0 and src.pending == 0
    assert any(m.state_row is not None for m in moved)
    dst = TE.ContinuousBatchingEngine(
        t_params, t_qlayers, cfg, n_slots=golden.ENGINE_SLOTS, chunk=4,
        policy="fifo")
    for m in moved:
        if m.pending:
            dst.submit(m.request)
        else:
            dst.adopt_stream(m.request, state_row=m.state_row, fed=m.fed,
                             generated=m.generated, drafter=m.drafter,
                             preemptions=m.preemptions)
    rest, _ = dst.run()
    results = {**{k: v.tokens for k, v in done.items()},
               **{k: v.tokens for k, v in rest.items()}}
    assert results == _singles(arch)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_engine_matches_reference_and_decode_single(case):
    check_engine_case(ARCH, case)


def test_state_bytes_per_stream_match_reference():
    check_state_bytes(ARCH)


def test_export_adopt_round_trip_is_bitexact():
    check_export_adopt(ARCH)
