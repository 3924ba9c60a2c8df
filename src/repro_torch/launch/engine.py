"""Continuous-batching executor for the integer recurrent LM (LSTM or GRU).

Port of ``repro.launch.engine``.  The serving stack is a three-layer split,
cashing in the paper's
core deployment advantage -- an integer LSTM's whole recurrent state is two
small integer vectors per layer per stream, so parking and resuming a
stream is nearly free and bit-exact:

  * **scheduler** (``launch/scheduler.py``) -- a pluggable policy decides
    each step which streams occupy the S decode-batch slots: FIFO (the
    default, reproducing the pre-split engine's exact step-by-step slot
    assignments), strict priority, shortest-remaining-first, and
    round-robin-fair time slicing, plus a FIFO-with-rejection baseline for
    admission-control benchmarks.  Policies may **oversubscribe**: admit
    more live streams than slots and multiplex them by preemption.
  * **state pool** (``launch/state_pool.py``) -- preempted streams park
    their quantized per-cell state (plus ``len``) in host-side pages and resume
    later bit-exactly (integer state: the swap round trip re-rounds
    nothing).  The stream's drafter travels with its host bookkeeping, so
    speculation state survives preemption too.
  * **executor** (this module) -- owns ONLY the step programs
    (one-token / chunked-prefill / chunk-advance / verify) and the
    ``(S, ...)`` slot tensors, and applies the scheduler's decision each
    iteration: park evicted residents, restore elected pool streams into
    freed slots, reset slots for fresh admissions, then dispatch one fused
    integer step over all S rows.

The step programs are plain PyTorch functions over the ``(S, ...)`` slot
tensors on the params' device (no jit, no sharding): pending requests
prefill by teacher-forcing through the same fused decode step that
generates (``chunk=K > 1`` feeds up to K prompt tokens per slot per step
through the masked ragged executor), finished streams are evicted
mid-flight, an active-mask freezes empty rows, and ``speculate=k > 0``
verifies per-slot drafter proposals in one masked ``(S, k+1)`` block with
in-graph longest-confirmed-prefix acceptance.

Bit-exactness contract (what the test harness locks down): every row of the
fused integer step is computed independently of the other rows, integer
arithmetic is deterministic, and the pool round trip copies integers
verbatim.  Therefore the token sequence a stream produces inside a busy
engine batch is **bitwise identical** to decoding that stream alone
(``decode_single``) -- regardless of slot index, co-tenants, admission
order, scheduling policy, preemption schedule, or oversubscription ratio.
``tests/test_torch_engine.py`` asserts this per stream, and holds every
stream against the reference package's engine on carried weights.  The
host loop reads back from the device only what the reference reads back
each step: the greedy tokens of the steps that emit, never the state.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .. import tree_util as tu
from ..models import lstm_lm
from ..runtime.fault import StepWatchdog
from .scheduler import Scheduler, StreamView, get_scheduler
from .spec_decode import Drafter, NGramDrafter
from .state_pool import StatePool


@dataclasses.dataclass
class Request:
    """One generation request: a prompt, a generation budget, and optional
    scheduling attributes.

    ``priority`` (larger = more urgent) only matters to priority-aware
    policies; ``arrival`` is the engine step at which the request becomes
    schedulable (0 = immediately), letting one trace schema express the
    open-loop bursty workloads the scheduling benchmarks replay.
    """

    rid: int
    prompt: np.ndarray  # (P,) int32, P >= 1
    max_new_tokens: int  # >= 1
    priority: int = 0
    arrival: float = 0.0

    def __post_init__(self):
        # plain raises, not assert: engine invariants must survive python -O
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(
                f"request {self.rid}: max_new_tokens must be >= 1, "
                f"got {self.max_new_tokens}")
        self.priority = int(self.priority)
        self.arrival = float(self.arrival)
        if not math.isfinite(self.arrival) or self.arrival < 0:
            raise ValueError(
                f"request {self.rid}: arrival must be a finite step "
                f">= 0, got {self.arrival}")


@dataclasses.dataclass
class StreamResult:
    """Finished stream: generated tokens + admission/finish bookkeeping.

    ``truncated`` marks a stream cut off before its generation budget was
    spent -- by ``run(max_steps=...)``, by a user ``evict``, or (with the
    rejection policy) refused admission outright (``rejected=True``, no
    tokens).  ``state_preserved`` records whether the stream's decode state
    (and drafter) survived in the pool: a preserved stream can be
    ``resume``-d and continued bit-exactly; an unpreserved one is gone.
    ``preemptions`` counts how often the scheduler parked the stream
    mid-flight (0 under FIFO).

    Latency metrics (``None`` when the stream never emitted a token, i.e. it
    was truncated mid-prefill):

    * ``ttft_steps`` -- engine steps from first slot admission through the
      step that produced the first generated token, inclusive (so a
      1-prompt-token request has TTFT of 1 step).  Deterministic for a given
      workload/chunk/policy.
    * ``ttft_s``     -- wall-clock from admission to the first token.
    * ``tokens_per_s`` -- generated tokens over the stream's residency
      (admission wall-clock to finish wall-clock).

    Speculation metrics (both 0 when the engine ran with ``speculate=0`` or
    the stream never drafted): ``drafted_tokens`` counts draft candidates
    this stream's drafter proposed, ``accepted_draft_tokens`` how many of
    them verification confirmed (the stream additionally emits one
    model-corrected token per verify step, so its generated total can
    exceed its accepted drafts).
    """

    rid: int
    tokens: List[int]
    prompt_len: int
    admitted_step: int
    finished_step: int
    truncated: bool = False
    ttft_steps: Optional[int] = None
    ttft_s: Optional[float] = None
    tokens_per_s: Optional[float] = None
    drafted_tokens: int = 0
    accepted_draft_tokens: int = 0
    state_preserved: bool = False
    preemptions: int = 0
    rejected: bool = False

    @property
    def accept_rate(self) -> Optional[float]:
        """Fraction of this stream's drafts that verified (None if it
        never drafted)."""
        if not self.drafted_tokens:
            return None
        return self.accepted_draft_tokens / self.drafted_tokens


@dataclasses.dataclass
class EngineStats:
    steps: int
    n_slots: int
    active_slot_steps: int  # sum over steps of #active slots
    max_active: int  # peak concurrent streams in one step
    generated_tokens: int
    prompt_tokens: int
    wall_s: float
    chunk: int = 1  # prefill chunk size the engine ran with
    # request-level latency aggregates over streams that emitted >= 1 token
    mean_ttft_steps: float = 0.0
    mean_ttft_s: float = 0.0
    mean_stream_tokens_per_s: float = 0.0
    # speculative-decode accounting (all 0 when speculate=0)
    speculate: int = 0  # draft budget k the engine ran with
    spec_steps: int = 0  # engine steps that ran the verify program
    spec_slot_steps: int = 0  # (slot, step) pairs that speculated
    drafted_tokens: int = 0  # draft candidates proposed across all streams
    accepted_draft_tokens: int = 0  # drafts confirmed by verification
    # scheduling accounting (the scheduler/pool split)
    policy: str = "fifo"  # scheduling policy the engine ran with
    oversubscribe: float = 1.0  # max_live / n_slots admission headroom
    preemptions: int = 0  # resident streams parked to the pool this run
    resumes: int = 0  # pool streams restored into slots this run
    rejected: int = 0  # requests refused admission (rejection policies)
    peak_live: int = 0  # peak live streams (resident + pooled) in one step
    pool_state_bytes: int = 0  # host bytes one parked stream occupies
    # watchdog verdicts for THIS run call (both 0 when no watchdog is wired):
    # dispatched steps whose wall time exceeded straggler_factor x EMA /
    # timeout_factor x EMA (runtime.fault.StepWatchdog)
    stragglers: int = 0
    hung: int = 0

    @property
    def occupancy(self) -> float:
        denom = self.steps * self.n_slots
        return self.active_slot_steps / denom if denom else 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0

    @property
    def accept_rate(self) -> float:
        """Fraction of proposed draft tokens that verification confirmed."""
        if not self.drafted_tokens:
            return 0.0
        return self.accepted_draft_tokens / self.drafted_tokens

    @property
    def accepted_tokens_per_spec_step(self) -> float:
        """Mean tokens a SPECULATING slot emits on a verify step: its
        accepted drafts plus the model-corrected token, i.e.
        ``1 + accepted_draft_tokens / spec_slot_steps``.  The multi-token
        decode win per speculation opportunity -- 1.0 means no draft was
        ever accepted (greedy pace), ``speculate + 1`` is the ceiling.
        Deliberately per slot-step, NOT per engine step: co-tenant slots
        emitting in the same step must not inflate it."""
        if not self.spec_slot_steps:
            return 0.0
        return 1.0 + self.accepted_draft_tokens / self.spec_slot_steps


@dataclasses.dataclass
class _Stream:
    """Host-side bookkeeping for one live stream.

    Unlike the pre-split engine's per-SLOT record, this travels with the
    STREAM: preemption moves the tensors to the pool but leaves this object
    (fed counter, generated tokens, drafter, latency stamps) intact, so a
    resumed stream continues exactly where it stopped -- including its
    drafter's history, which must never die with the slot.
    """

    request: Request
    fed: int = 0  # tokens consumed so far (prompt + fed-back generations)
    generated: List[int] = dataclasses.field(default_factory=list)
    admitted_step: int = 0  # first step the stream held a slot
    admit_wall: float = 0.0
    first_token_step: Optional[int] = None
    first_token_wall: Optional[float] = None
    # speculation: this stream's drafter (fresh per stream start -- draft
    # history must never leak across streams, but DOES survive preemption)
    drafter: Optional[Drafter] = None
    drafted: int = 0  # draft tokens proposed for this stream
    accepted_drafts: int = 0  # drafts confirmed by verification
    # scheduling: residency + preemption accounting
    slot: Optional[int] = None  # decode-batch row, None while pooled
    resident_steps: int = 0  # consecutive steps of the current slot tenure
    preemptions: int = 0

    def next_token(self) -> int:
        """The token this stream feeds on the upcoming step."""
        p = self.request.prompt
        if self.fed < p.size:
            return int(p[self.fed])  # teacher-forced prefill
        return self.generated[self.fed - p.size]  # fed-back generation


@dataclasses.dataclass
class MigratedStream:
    """One stream drained out of an engine for re-admission elsewhere
    (the fleet tier's shard-kill recovery).

    ``state_row`` is the host-side batch-1 state pytree when it survived --
    the stream was parked in the host pool, or the drain ran with the device
    still alive -- and the receiving engine adopts it through the same
    ``pool.take -> slot write`` resume path user preemption uses, so
    continuation is bit-exact (integer state, nothing re-rounds).  ``None``
    means the device state died with the shard: the stream must be REPLAYED
    by teacher-forcing its prompt + already-generated prefix (bit-exact by
    determinism, at the cost of re-ingesting the prefix).  ``pending`` marks
    a request that never started (no state, no replay cost -- re-route it).
    """

    request: Request
    fed: int
    generated: List[int]
    state_row: Optional[Dict[str, Any]]
    drafter: Optional[Drafter]
    preemptions: int
    pending: bool = False


def _host(tree):
    """Host numpy copy of a (batch-1) state tree: what the pool parks."""
    return tu.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _engine_step_fns(qlayers, cfg):
    """The (step, chunk_step, chunk_advance, verify, reset, write) programs
    of the engine loop, as plain functions on the slot tensors."""

    def step(params, tokens, state, active):
        """One engine iteration: all slots advance one token.

        tokens: (S,) int32; active: (S,) bool.  Returns the per-slot
        greedy next token (argmax over the last-position logits -- the
        row-wise computation is identical to a batch-1 decode, so the
        argmax is too) and the new state with inactive rows frozen.
        """
        logits, new_state = lstm_lm.quant_forward(
            params, qlayers, cfg, tokens[:, None], state)
        greedy = logits[:, -1].argmax(dim=-1).to(torch.int32)
        mask = active[:, None]
        out = {k: [torch.where(mask, n, o)
                   for n, o in zip(new_state[k], state[k])]
               for k in state if k != "len"}
        out["len"] = state["len"] + active.to(torch.int32)
        return greedy, out

    def chunk_step(params, tokens, state, valid):
        """One chunked-prefill iteration: slot i advances valid[i] tokens.

        tokens: (S, K) int32; valid: (S,) int32 in [0, K].  The ragged
        masked executor freezes each row's per-layer state and its ``len``
        counter beyond its valid length (valid == 0 rows are frozen
        entirely), so every row's state after the block is bitwise
        identical to feeding its valid prefix one token at a time.  Returns
        the greedy argmax over each row's LAST VALID position.
        """
        logits, out = lstm_lm.quant_chunk_step(
            params, qlayers, cfg, tokens, state, valid)
        return logits.argmax(dim=-1).to(torch.int32), out

    def verify(params, tokens, state, valid, draft_len):
        """One speculative verify iteration over a ``(S, W)`` block (see
        ``lstm_lm.quant_verify_step``): per-position greedy argmax, per-row
        accepted input count, and the state advanced to exactly each row's
        accepted length."""
        return lstm_lm.quant_verify_step(
            params, qlayers, cfg, tokens, state, valid, draft_len)

    def chunk_advance(params, tokens, state, valid):
        """Chunked iteration where NO slot emits a token this step: advance
        state only, no LM head, no greedy output, no host read-back."""
        return lstm_lm.quant_chunk_advance(
            params, qlayers, cfg, tokens, state, valid)

    def reset(state, slot):
        return lstm_lm.reset_quant_slot(qlayers, state, slot)

    def write(state, slot, row_state):
        """Resume: restore a pool row into decode-batch row ``slot``."""
        return lstm_lm.write_quant_slot(state, slot, row_state)

    return step, chunk_step, chunk_advance, verify, reset, write


class ContinuousBatchingEngine:
    """Drives a fixed-slot decode batch over a queue of requests.

    ``policy``: scheduling policy name (``launch.scheduler.POLICIES``:
    ``fifo`` | ``priority`` | ``srf`` | ``rr`` | ``fifo-reject``) or a
    ``Scheduler`` instance.  The policy decides each step which streams
    occupy slots; everything else (state swaps, dispatch, bookkeeping) is
    the executor's job.  The default FIFO reproduces the pre-split engine's
    exact step-by-step slot assignments.

    ``oversubscribe``: admission headroom as a multiple of ``n_slots`` --
    up to ``ceil(oversubscribe * n_slots)`` streams may be live (holding a
    slot or parked in the state pool) at once.  With ``1.0`` (default) a
    stream only starts when a slot is free, like the pre-split engine;
    ratios > 1 let preempting policies time-multiplex more streams than
    slots, with every stream still bit-exact vs ``decode_single``.

    ``chunk``: prefill chunk size K.  With ``chunk > 1`` a second
    program teacher-forces up to K prompt tokens per slot per engine step as
    an ``(S, K)`` block with per-slot valid lengths (slots mid-generation
    feed 1 token in the same step), cutting time-to-first-token for long
    prompts by ~K dispatches while staying bit-exact with ``chunk=1`` and
    with ``decode_single``.  Steps where no slot has >= 2 prompt tokens left
    fall back to the one-token program, so pure generation never pays the
    K-wide block.

    ``speculate``: draft budget k for speculative decoding.  With ``k > 0``
    each generating stream's drafter (``drafter_factory``, default
    ``NGramDrafter``: a suffix cache over that stream's own tokens) proposes
    up to k continuation tokens per step, and steps where at least one slot
    drafts run the masked-chunk **verify** program over a
    ``(S, k+1)`` block: per-position argmax, longest-confirmed-prefix
    acceptance, and per-row state rollback to the accepted length, emitting
    1..k+1 tokens per slot per step.  Output tokens are bit-identical to
    ``speculate=0`` (and to ``decode_single``) by construction; the drafter
    belongs to the STREAM, so it survives preemption and resumes with its
    history intact.

    The engine runs on the device of its params (``params["embedding"]``):
    the slot state lives there, and the host copies the step's token block
    there once per step.

    ``watchdog``: optional ``runtime.fault.StepWatchdog`` -- every dispatched
    engine step's wall time is ``observe``-d and the resulting straggler /
    hung verdict counts surface in ``EngineStats`` (per ``run`` call).
    ``step_hook``: optional callable invoked with the engine step
    index at the top of every dispatched step, INSIDE the watchdog's timed
    window -- the fault-injection seam (a hook that sleeps simulates a hung
    device; the watchdog must flag it).
    """

    def __init__(self, params, qlayers, cfg, n_slots: int, *,
                 chunk: int = 1, speculate: int = 0,
                 drafter_factory=None, policy: Union[str, Scheduler] = "fifo",
                 oversubscribe: float = 1.0, pool_page_size: int = 8,
                 watchdog: Optional[StepWatchdog] = None, step_hook=None):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if speculate < 0:
            raise ValueError(f"speculate must be >= 0, got {speculate}")
        if not (isinstance(oversubscribe, (int, float))
                and math.isfinite(oversubscribe)) or oversubscribe < 1.0:
            raise ValueError(
                f"oversubscribe must be a finite ratio >= 1, "
                f"got {oversubscribe}")
        self.params = params
        self.qlayers = qlayers
        self.cfg = cfg
        self.n_slots = n_slots
        self.device = params["embedding"].device
        self.chunk = chunk
        self.speculate = speculate
        self.oversubscribe = float(oversubscribe)
        self.max_live = max(n_slots, int(math.ceil(n_slots * oversubscribe)))
        self.scheduler = get_scheduler(policy)
        self.pool = StatePool(page_size=pool_page_size)
        self._drafter_factory = (
            drafter_factory if drafter_factory is not None
            else NGramDrafter)
        self.watchdog = watchdog
        self._step_hook = step_hook
        # stream bookkeeping: pending queue (submission order), live streams
        # keyed by rid, slot -> rid map, pool parking order, parked (user-
        # evicted, resumable) streams
        self._queue: List[Request] = []
        self._submit_idx: Dict[int, int] = {}
        self._n_submitted = 0
        self._streams: Dict[int, _Stream] = {}
        self._slot_rid: List[Optional[int]] = [None] * n_slots
        self._pool_order: List[int] = []
        self._parked: Dict[int, _Stream] = {}
        self._step = 0  # global engine step, persistent across run() calls
        # (step, event, rid, slot) trail: admissions, preemptions, resumes,
        # rejections -- what the FIFO-equivalence regression test replays
        self.schedule_log: List[Tuple[int, str, int, int]] = []
        self._state = lstm_lm.init_quant_decode_state(
            qlayers, n_slots, self.device, per_slot_len=True)
        (self._step_fn, self._chunk_step, self._chunk_advance, self._verify,
         self._reset, self._write) = _engine_step_fns(qlayers, cfg)

    def _put(self, x: np.ndarray) -> torch.Tensor:
        """A host block of this step's inputs, on the engine's device."""
        return torch.from_numpy(x).to(self.device)

    # -- queue management ---------------------------------------------------

    def submit(self, request: Request) -> None:
        # results are keyed by rid; a duplicate would silently shadow a
        # stream's output, so reject it at the door
        taken = {r.rid for r in self._queue}
        taken.update(self._streams)
        taken.update(self._parked)
        if request.rid in taken:
            raise ValueError(f"duplicate request id {request.rid}")
        self._queue.append(request)
        self._submit_idx[request.rid] = self._n_submitted
        self._n_submitted += 1

    def submit_all(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.submit(r)

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def active(self) -> int:
        """Streams currently holding a decode-batch slot."""
        return sum(rid is not None for rid in self._slot_rid)

    @property
    def live(self) -> int:
        """Streams holding a slot OR parked in the pool (excludes
        user-evicted parked streams, which left the live set)."""
        return len(self._streams)

    # -- scheduling: views, decision application ----------------------------

    def _view(self, stream: _Stream) -> StreamView:
        req = stream.request
        return StreamView(
            rid=req.rid,
            priority=req.priority,
            arrival=req.arrival,
            submit_idx=self._submit_idx[req.rid],
            prompt_len=int(req.prompt.size),
            prompt_remaining=max(int(req.prompt.size) - stream.fed, 0),
            gen_remaining=req.max_new_tokens - len(stream.generated),
            resident=stream.slot is not None,
            slot=stream.slot,
            resident_steps=stream.resident_steps,
        )

    def _pending_view(self, req: Request) -> StreamView:
        return StreamView(
            rid=req.rid,
            priority=req.priority,
            arrival=req.arrival,
            submit_idx=self._submit_idx[req.rid],
            prompt_len=int(req.prompt.size),
            prompt_remaining=int(req.prompt.size),
            gen_remaining=req.max_new_tokens,
            resident=False,
        )

    def _preempt(self, rid: int) -> None:
        """Park a resident stream's state in the pool, freeing its slot."""
        s = self._streams[rid]
        row = lstm_lm.slice_state(self._state, s.slot)
        self.pool.put(rid, _host(row))
        self._slot_rid[s.slot] = None
        s.slot = None
        s.resident_steps = 0
        s.preemptions += 1
        self._pool_order.append(rid)
        self._n_preempts += 1
        self.schedule_log.append((self._step, "preempt", rid, -1))

    def _resume(self, rid: int, slot: int) -> None:
        """Restore a pooled stream's state into a free slot, bit-exactly."""
        s = self._streams[rid]
        self._state = self._write(self._state, slot, self.pool.take(rid))
        self._pool_order.remove(rid)
        self._slot_rid[slot] = rid
        s.slot = slot
        s.resident_steps = 0
        self._n_resumes += 1
        self.schedule_log.append((self._step, "resume", rid, slot))

    def _start(self, req: Request, slot: int, now: float) -> None:
        """First admission of a pending request: reset the slot, create the
        stream record (and its drafter, which lives with the STREAM)."""
        self._queue.remove(req)
        drafter = None
        if self.speculate:
            # a FRESH drafter per stream, reset() besides (the documented
            # lifecycle -- so pooled/shared factory instances also start
            # blank): another stream's history must never leak in
            drafter = self._drafter_factory()
            drafter.reset()
            drafter.observe(req.prompt.tolist())
        self._streams[req.rid] = _Stream(
            request=req, admitted_step=self._step, admit_wall=now,
            drafter=drafter, slot=slot)
        self._slot_rid[slot] = req.rid
        self._state = self._reset(self._state, slot)
        self.schedule_log.append((self._step, "admit", req.rid, slot))

    def _reject(self, req: Request, now: float,
                results: Dict[int, StreamResult]) -> None:
        self._queue.remove(req)
        results[req.rid] = StreamResult(
            rid=req.rid, tokens=[], prompt_len=int(req.prompt.size),
            admitted_step=-1, finished_step=self._step, truncated=True,
            rejected=True)
        self._n_rejects += 1
        self.schedule_log.append((self._step, "reject", req.rid, -1))

    def _apply_schedule(self, now: float,
                        results: Dict[int, StreamResult]) -> None:
        """Ask the policy for this step's slot occupancy and apply it:
        preempt, resume, admit, reject.  Malformed decisions raise -- a
        scheduler bug must never silently corrupt slot bookkeeping."""
        resident = [self._view(self._streams[rid])
                    for rid in self._slot_rid if rid is not None]
        pooled = [self._view(self._streams[rid])
                  for rid in self._pool_order]
        arrived = [r for r in self._queue if r.arrival <= self._step]
        pending = [self._pending_view(r) for r in arrived]
        start_budget = max(self.max_live - len(self._streams), 0)
        decision = self.scheduler.schedule(
            self._step, resident, pooled, pending, self.n_slots,
            start_budget)
        run = list(decision.run)
        pending_rids = {v.rid for v in pending}
        known = ({v.rid for v in resident} | {v.rid for v in pooled}
                 | pending_rids)
        name = self.scheduler.name
        if len(run) > self.n_slots or len(set(run)) != len(run):
            raise RuntimeError(
                f"scheduler {name!r} returned an invalid run list "
                f"(> n_slots or duplicates): {run}")
        if not set(run) <= known:
            raise RuntimeError(
                f"scheduler {name!r} scheduled unknown streams: "
                f"{sorted(set(run) - known)}")
        if sum(rid in pending_rids for rid in run) > start_budget:
            raise RuntimeError(
                f"scheduler {name!r} started more streams than the "
                f"oversubscription budget {start_budget} allows: {run}")
        bad_reject = [rid for rid in decision.reject
                      if rid not in pending_rids or rid in set(run)]
        if bad_reject:
            raise RuntimeError(
                f"scheduler {name!r} rejected non-pending or scheduled "
                f"streams: {bad_reject}")
        by_rid = {r.rid: r for r in arrived}
        for rid in decision.reject:
            self._reject(by_rid[rid], now, results)
        run_set = set(run)
        # 1) park residents the policy un-elected
        for rid in list(self._slot_rid):
            if rid is not None and rid not in run_set:
                self._preempt(rid)
        # 2) fill free slots (increasing index) with the remaining elected
        #    streams, in the order the policy listed them
        newcomers = [rid for rid in run
                     if rid in pending_rids
                     or self._streams[rid].slot is None]
        free_slots = [i for i, rid in enumerate(self._slot_rid)
                      if rid is None]
        for slot, rid in zip(free_slots, newcomers):
            if rid in self._streams:
                self._resume(rid, slot)
            else:
                self._start(by_rid[rid], slot, now)
        for rid in run_set:
            self._streams[rid].resident_steps += 1

    # -- user-initiated eviction / resume -----------------------------------

    def evict(self, rid: int, *, preserve: bool = True) -> StreamResult:
        """Evict a stream mid-flight (between ``run`` calls).

        With ``preserve=True`` (default) the stream's decode state is
        parked in the pool and its host bookkeeping -- including its
        drafter -- is retained, so ``resume(rid)`` can continue it later
        **bit-exactly**; the returned result records
        ``state_preserved=True``.  With ``preserve=False`` the state is
        discarded (the pre-split engine's only behavior), recorded as
        ``state_preserved=False``.  A still-pending request is simply
        removed from the queue (it never had state).
        """
        now = time.perf_counter()
        for r in self._queue:
            if r.rid == rid:
                self._queue.remove(r)
                return StreamResult(
                    rid=rid, tokens=[], prompt_len=int(r.prompt.size),
                    admitted_step=-1, finished_step=max(self._step - 1, 0),
                    truncated=True, state_preserved=False)
        s = self._streams.get(rid)
        if s is None:
            raise ValueError(
                f"stream {rid} is not live (finished, parked, or unknown)")
        if preserve:
            if s.slot is not None:
                row = lstm_lm.slice_state(self._state, s.slot)
                self.pool.put(rid, _host(row))
                s.preemptions += 1
        elif s.slot is None:
            self.pool.free(rid)  # pooled state dies with the eviction
        if s.slot is not None:
            self._slot_rid[s.slot] = None
            s.slot = None
        if rid in self._pool_order:
            self._pool_order.remove(rid)
        del self._streams[rid]
        res = self._result(s, max(self._step - 1, 0), now, truncated=True)
        res.state_preserved = preserve
        if preserve:
            self._parked[rid] = s
        return res

    def resume(self, rid: int) -> None:
        """Return a ``evict(preserve=True)``-parked stream to the live set;
        the scheduler will slot it back in on the next ``run`` step and it
        continues bit-exactly (state from the pool, drafter intact)."""
        s = self._parked.pop(rid, None)
        if s is None:
            raise ValueError(
                f"stream {rid} is not parked (evict(preserve=True) it "
                f"first); double resume?")
        self._streams[rid] = s
        self._pool_order.append(rid)

    # -- fleet migration: drain this engine / adopt another's streams -------

    def export_streams(self, *, device_alive: bool = True
                       ) -> List[MigratedStream]:
        """Drain every queued and live stream for re-admission elsewhere,
        leaving this engine empty (the fleet router calls this when a shard
        dies or is being retired).

        ``device_alive=True`` models a graceful drain (watchdog-flagged
        shard, planned retirement): resident streams' slot rows are sliced
        to host first, so EVERY stream migrates with its state.  With
        ``device_alive=False`` (hard kill: the accelerator died) resident
        streams lose their device state (``state_row=None`` -> replay);
        pooled streams still migrate -- their pages are host memory and
        survive the device.  User-parked streams (``evict(preserve=True)``)
        are NOT exported: the caller holds their handle and decides.
        """
        out: List[MigratedStream] = []
        for req in self._queue:
            out.append(MigratedStream(
                request=req, fed=0, generated=[], state_row=None,
                drafter=None, preemptions=0, pending=True))
        self._queue.clear()
        for rid, s in list(self._streams.items()):
            if s.slot is not None:
                row = (_host(lstm_lm.slice_state(self._state, s.slot))
                       if device_alive else None)
                self._slot_rid[s.slot] = None
                s.slot = None
            else:
                row = self.pool.take(rid)
            out.append(MigratedStream(
                request=s.request, fed=s.fed, generated=list(s.generated),
                state_row=row, drafter=s.drafter,
                preemptions=s.preemptions))
        self._streams.clear()
        self._pool_order.clear()
        return out

    def adopt_stream(self, request: Request, *, state_row, fed: int,
                     generated: Sequence[int] = (), drafter=None,
                     preemptions: int = 0) -> None:
        """Admit a mid-flight stream WITH its integer state (fleet migration
        after a shard death or drain).

        The state row enters the pool and the scheduler restores it into a
        free slot through the same ``pool.take -> slot write`` path
        preemption uses, so the stream continues bit-exactly as if it had
        never moved -- the recovery primitive only a
        constant-few-hundred-bytes integer state makes affordable.  Streams
        whose state died with their device are NOT adopted: replay them by
        folding the generated prefix into a fresh request's prompt
        (teacher-forcing reproduces the state bit-exactly).
        """
        taken = {r.rid for r in self._queue}
        taken.update(self._streams)
        taken.update(self._parked)
        if request.rid in taken:
            raise ValueError(f"duplicate request id {request.rid}")
        if state_row is None:
            raise ValueError(
                f"stream {request.rid}: adopt_stream needs a state row; "
                f"replay state-less streams via submit() with the generated "
                f"prefix folded into the prompt")
        gen = list(generated)
        if len(gen) >= request.max_new_tokens:
            raise ValueError(
                f"stream {request.rid}: already generated {len(gen)} of "
                f"{request.max_new_tokens} tokens -- nothing to adopt")
        if not 0 <= fed <= int(request.prompt.size) + max(len(gen) - 1, 0):
            raise ValueError(
                f"stream {request.rid}: fed={fed} inconsistent with "
                f"prompt_len={int(request.prompt.size)} + "
                f"{len(gen)} generated")
        if self.speculate and drafter is None:
            # a migrating stream entering a speculating engine without its
            # drafter rebuilds one from its full observed history
            drafter = self._drafter_factory()
            drafter.reset()
            drafter.observe(request.prompt.tolist() + gen)
        s = _Stream(
            request=request, fed=fed, generated=gen,
            admitted_step=self._step, admit_wall=time.perf_counter(),
            drafter=drafter, preemptions=preemptions)
        self._streams[request.rid] = s
        self._submit_idx[request.rid] = self._n_submitted
        self._n_submitted += 1
        self.pool.put(request.rid, state_row)
        self._pool_order.append(request.rid)
        self.schedule_log.append((self._step, "adopt", request.rid, -1))

    def live_progress(self) -> Dict[int, int]:
        """{rid: generated-token count} for every live stream -- the fleet
        router's cheap per-step poll for first-token (TTFT) stamping."""
        return {rid: len(s.generated) for rid, s in self._streams.items()}

    # -- the serving loop ---------------------------------------------------

    def _result(self, stream: _Stream, finished_step: int, now: float,
                truncated: bool) -> StreamResult:
        req = stream.request
        ttft_steps = ttft_s = tps = None
        if stream.generated and stream.first_token_step is not None:
            ttft_steps = stream.first_token_step - stream.admitted_step + 1
            ttft_s = stream.first_token_wall - stream.admit_wall
            span = now - stream.admit_wall
            tps = len(stream.generated) / span if span > 0 else float("inf")
        return StreamResult(
            rid=req.rid,
            tokens=list(stream.generated),
            prompt_len=int(req.prompt.size),
            admitted_step=stream.admitted_step,
            finished_step=finished_step,
            truncated=truncated,
            ttft_steps=ttft_steps,
            ttft_s=ttft_s,
            tokens_per_s=tps,
            drafted_tokens=stream.drafted,
            accepted_draft_tokens=stream.accepted_drafts,
            preemptions=stream.preemptions,
        )

    def run(self, max_steps: Optional[int] = None, *,
            keep_live: bool = False
            ) -> Tuple[Dict[int, StreamResult], EngineStats]:
        """Serve until the queue and all live streams drain.  Returns
        per-request results keyed by rid plus occupancy/throughput/latency/
        scheduling stats.

        ``max_steps`` bounds THIS call's engine steps.  By default streams
        still in flight at the bound are returned as truncated results and
        their state is discarded (``state_preserved=False``), like the
        pre-split engine; with ``keep_live=True`` they stay live instead
        (slots, pool entries, drafters intact) so a later ``run`` call
        continues them bit-exactly -- the stepwise-driving mode the
        scheduling benchmarks use.
        """
        results: Dict[int, StreamResult] = {}
        ran = 0
        active_slot_steps = 0
        max_active = 0
        prompt_tokens = 0
        generated = 0
        spec_steps = 0
        spec_slot_steps = 0
        peak_live = len(self._streams)
        self._n_preempts = 0
        self._n_resumes = 0
        self._n_rejects = 0
        wd = self.watchdog
        wd_before = (wd.stragglers, wd.hung) if wd is not None else (0, 0)
        t0 = time.perf_counter()
        while self._queue or self._streams:
            if max_steps is not None and ran >= max_steps:
                break
            self._apply_schedule(time.perf_counter(), results)
            peak_live = max(peak_live, len(self._streams))
            if not any(rid is not None for rid in self._slot_rid):
                # nothing runnable (all arrivals in the future): the step
                # passes idle -- no dispatch, no active accounting (and no
                # watchdog observation -- an idle step's wall time says
                # nothing about device health)
                self._step += 1
                ran += 1
                continue
            step_t0 = time.perf_counter()
            if self._step_hook is not None:
                # fault-injection seam: runs INSIDE the watchdog's timed
                # window, so an injected sleep reads as a hung device
                self._step_hook(self._step)
            # speculative drafts: ask each generating stream's drafter for
            # up to k candidates, capped so even a fully-accepted block
            # lands exactly on the stream's remaining budget (a stream one
            # token from done never drafts -- its drafts could never be
            # emitted)
            drafts: Dict[int, List[int]] = {}
            if self.speculate:
                for i, rid in enumerate(self._slot_rid):
                    if rid is None:
                        continue
                    s = self._streams[rid]
                    if s.fed < s.request.prompt.size:
                        continue
                    room = s.request.max_new_tokens - len(s.generated)
                    if room >= 2:
                        k = min(self.speculate, room - 1)
                        # clamp: a custom Drafter returning more than asked
                        # must not overflow the block or the stream budget
                        d = list(s.drafter.draft(k))[:k]
                        if d:
                            drafts[i] = d
            # pick this step's program: the (S, k+1) verify block when any
            # slot drafted; else chunked prefill when some slot still has
            # >= 2 prompt tokens to teacher-force; else the one-token step
            # -- so speculate=0 engines run exactly the pre-speculation
            # program sequence, and undraftable workloads never pay the
            # wide block
            slot_streams: List[Optional[_Stream]] = [
                self._streams[rid] if rid is not None else None
                for rid in self._slot_rid]
            chunk_pending = self.chunk > 1 and any(
                s is not None and s.request.prompt.size - s.fed >= 2
                for s in slot_streams)
            if drafts:
                # a mixed step (drafting slots + mid-prefill co-tenants)
                # widens to whichever program is larger: the verify step
                # handles arbitrary per-row valid/draft_len, so chunked
                # prefill must not be capped at k+1 when chunk > k+1
                width = max(self.speculate + 1,
                            self.chunk if chunk_pending else 1)
            elif chunk_pending:
                width = self.chunk
            else:
                width = 1
            tokens = np.zeros((self.n_slots, width), np.int32)
            valid = np.zeros((self.n_slots,), np.int32)
            draft_len = np.zeros((self.n_slots,), np.int32)
            fed_before = [s.fed if s is not None else 0
                          for s in slot_streams]
            for i, s in enumerate(slot_streams):
                if s is None:
                    continue
                rem = s.request.prompt.size - s.fed
                if rem >= 1:  # teacher-forced prefill: up to `width` tokens
                    n = min(width, rem)
                    tokens[i, :n] = s.request.prompt[s.fed:s.fed + n]
                else:  # mid-generation: feed back latest token (+ drafts)
                    d = drafts.get(i, ())
                    n = 1 + len(d)
                    tokens[i, 0] = s.next_token()
                    tokens[i, 1:n] = d
                    draft_len[i] = len(d)
                valid[i] = n
            n_active = int((valid > 0).sum())
            active_slot_steps += n_active
            max_active = max(max_active, n_active)
            # dispatch ONE program; afterwards ``consumed[i]`` is the
            # inputs row i advanced by and ``preds[i, p]`` the greedy token
            # following input position p (for every consumed position on
            # verify steps; only at a row's single emitting position on the
            # one-token / chunked paths, which emit at most one token)
            if drafts:
                pred, accepted, self._state = self._verify(
                    self.params, self._put(tokens), self._state,
                    self._put(valid), self._put(draft_len))
                preds = pred.cpu().numpy()
                consumed = accepted.cpu().numpy()
                spec_steps += 1
            elif width == 1:
                greedy, self._state = self._step_fn(
                    self.params, self._put(tokens[:, 0]), self._state,
                    self._put(valid > 0))
                preds = greedy.cpu().numpy()[:, None]
                consumed = valid
            else:
                # a slot emits a token this step iff it consumes its last
                # prompt token (0 < remaining <= chunk) or is generating
                # (remaining == 0).  When nothing emits, the logits would
                # never be read: run the head-free advance program and skip
                # the host sync so consecutive prefill chunks pipeline.
                emits = any(
                    s is not None and
                    s.request.prompt.size - s.fed <= width
                    for s in slot_streams)
                consumed = valid
                if emits:
                    greedy, self._state = self._chunk_step(
                        self.params, self._put(tokens), self._state,
                        self._put(valid))
                    # the chunked head reads each row's LAST VALID position,
                    # the only one the emission rule below can select
                    greedy = greedy.cpu().numpy()
                    preds = np.zeros((self.n_slots, width), np.int32)
                    for i in range(self.n_slots):
                        if valid[i]:
                            preds[i, valid[i] - 1] = greedy[i]
                else:
                    preds = None  # never read: no row emits this step
                    self._state = self._chunk_advance(
                        self.params, self._put(tokens), self._state,
                        self._put(valid))
            now = time.perf_counter()
            for i, s in enumerate(slot_streams):
                if s is None:
                    continue
                req = s.request
                n = int(consumed[i])
                fb = fed_before[i]
                # prompt tokens consumed this step (0 when mid-generation)
                prompt_tokens += min(n, max(int(req.prompt.size) - fb, 0))
                s.fed += n
                if draft_len[i]:
                    # accepted drafts = consumed inputs minus the committed
                    # fed-back token (draft capping keeps emissions within
                    # budget, so no accepted token is ever discarded); the
                    # engine-wide totals are summed from StreamResults at
                    # stats build -- every slot ends up in results
                    s.drafted += int(draft_len[i])
                    s.accepted_drafts += n - 1
                    spec_slot_steps += 1
                for p in range(n):
                    # consuming input position p yields a generated token
                    # iff p is the row's last prompt token or later
                    if fb + p + 1 < req.prompt.size:
                        continue
                    s.generated.append(int(preds[i, p]))
                    if s.drafter is not None:
                        s.drafter.observe([s.generated[-1]])
                    if len(s.generated) == 1:
                        s.first_token_step = self._step
                        s.first_token_wall = now
                if len(s.generated) >= req.max_new_tokens:
                    results[req.rid] = self._result(
                        s, self._step, now, truncated=False)
                    generated += len(s.generated)
                    self._slot_rid[i] = None  # evict mid-flight
                    del self._streams[req.rid]
            if wd is not None:
                wd.observe(time.perf_counter() - step_t0)
            self._step += 1
            ran += 1
        # hitting max_steps leaves streams in flight: by default return
        # their partial generations (marked truncated, state discarded)
        # instead of silently dropping them -- the step that actually ran
        # last is self._step - 1 (already advanced past it), matching
        # mid-flight eviction's stamps.  keep_live=True keeps them live
        # (slots + pool + drafters intact) for a later run() call.
        if not keep_live:
            now = time.perf_counter()
            for rid, s in list(self._streams.items()):
                results[rid] = self._result(
                    s, max(self._step - 1, 0), now, truncated=True)
                generated += len(s.generated)
                if s.slot is not None:
                    self._slot_rid[s.slot] = None
                else:
                    self.pool.free(rid)
                del self._streams[rid]
            self._pool_order.clear()
        wall = time.perf_counter() - t0
        ttfts = [r for r in results.values() if r.ttft_steps is not None]
        stats = EngineStats(
            steps=ran,
            n_slots=self.n_slots,
            active_slot_steps=active_slot_steps,
            max_active=max_active,
            generated_tokens=generated,
            prompt_tokens=prompt_tokens,
            wall_s=wall,
            chunk=self.chunk,
            speculate=self.speculate,
            spec_steps=spec_steps,
            spec_slot_steps=spec_slot_steps,
            drafted_tokens=sum(
                r.drafted_tokens for r in results.values()),
            accepted_draft_tokens=sum(
                r.accepted_draft_tokens for r in results.values()),
            mean_ttft_steps=(sum(r.ttft_steps for r in ttfts) / len(ttfts)
                             if ttfts else 0.0),
            mean_ttft_s=(sum(r.ttft_s for r in ttfts) / len(ttfts)
                         if ttfts else 0.0),
            mean_stream_tokens_per_s=(
                sum(r.tokens_per_s for r in ttfts) / len(ttfts)
                if ttfts else 0.0),
            policy=self.scheduler.name,
            oversubscribe=self.oversubscribe,
            preemptions=self._n_preempts,
            resumes=self._n_resumes,
            rejected=self._n_rejects,
            peak_live=peak_live,
            pool_state_bytes=self.pool.state_bytes_per_stream,
            stragglers=(wd.stragglers - wd_before[0]
                        if wd is not None else 0),
            hung=wd.hung - wd_before[1] if wd is not None else 0,
        )
        return results, stats


# ---------------------------------------------------------------------------
# Single-stream reference + request traces
# ---------------------------------------------------------------------------


def single_stream_fns(qlayers, cfg):
    """The (prefill, decode) pair for batch-1 serving."""

    def prefill_fn(params, tokens, state):
        return lstm_lm.quant_prefill(params, qlayers, cfg, tokens, state)

    def decode_fn(params, token, state):
        return lstm_lm.quant_decode_step(params, qlayers, cfg, token, state)

    return prefill_fn, decode_fn


def decode_single(params, qlayers, cfg, prompt, max_new_tokens: int, *,
                  prefill_fn=None, decode_fn=None) -> List[int]:
    """Decode ONE stream alone: one prefill pass + greedy loop, on the
    params' device.  The bit-exactness oracle for the engine."""
    device = params["embedding"].device
    prompt = torch.as_tensor(np.asarray(prompt, np.int32).reshape(1, -1),
                             device=device)
    if prefill_fn is None or decode_fn is None:
        pf, df = single_stream_fns(qlayers, cfg)
        prefill_fn = prefill_fn or pf
        decode_fn = decode_fn or df
    state = lstm_lm.init_quant_decode_state(qlayers, 1, device)
    with torch.no_grad():
        logits, state = prefill_fn(params, prompt, state)
        out = [int(logits.argmax(-1)[0])]
        for _ in range(max_new_tokens - 1):
            tok = torch.tensor([[out[-1]]], dtype=torch.int32, device=device)
            logits, state = decode_fn(params, tok, state)
            out.append(int(logits.argmax(-1)[0]))
    return out


def synthetic_trace(n_requests: int, vocab_size: int, *, seed: int = 0,
                    prompt_lens: Sequence[int] = (4, 6, 8, 12),
                    gen_lens: Sequence[int] = (4, 8, 12),
                    priority_levels: Sequence[int] = (0,),
                    arrival_span: int = 0) -> List[Request]:
    """A mixed-length request workload with deterministic token content.

    ``priority_levels`` draws each request's scheduling priority uniformly
    from the given set; ``arrival_span > 0`` scatters arrivals uniformly
    over engine steps ``[0, arrival_span]`` (0 keeps the closed-loop
    everything-arrives-at-once trace).  Both default to the pre-scheduling
    schema so existing workloads replay unchanged.
    """
    if arrival_span < 0:
        raise ValueError(f"arrival_span must be >= 0, got {arrival_span}")
    if not priority_levels:
        raise ValueError("priority_levels must be non-empty")
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n_requests):
        p = int(rng.choice(list(prompt_lens)))
        g = int(rng.choice(list(gen_lens)))
        toks = rng.integers(0, vocab_size, size=(p,), dtype=np.int64)
        prio = int(rng.choice(list(priority_levels)))
        arrival = float(rng.integers(0, arrival_span + 1)) \
            if arrival_span else 0.0
        out.append(Request(rid=rid, prompt=toks.astype(np.int32),
                           max_new_tokens=g, priority=prio,
                           arrival=arrival))
    return out


def load_trace(path: str, vocab_size: int, *, seed: int = 0) -> List[Request]:
    """Load a request trace: a JSON list of objects with either an explicit
    ``prompt`` token list or a ``prompt_len`` (tokens drawn from ``seed``),
    plus ``gen`` (generation budget), optional ``id``, and the optional
    scheduling fields ``priority`` (int, larger = more urgent) and
    ``arrival`` (engine step >= 0 the request becomes schedulable).

        [{"prompt_len": 12, "gen": 8, "priority": 1, "arrival": 16},
         {"prompt": [3, 1, 4], "gen": 4}]

    One schema serves the engine CLI, the policy benchmarks, and the future
    open-loop load generator.  Malformed entries (missing keys, empty
    prompts, non-positive lengths or budgets, non-numeric priority,
    negative arrival) raise ``ValueError`` naming the offending entry
    instead of failing deep inside the engine.
    """
    with open(path) as f:
        entries = json.load(f)
    if not isinstance(entries, list):
        raise ValueError(
            f"trace {path}: expected a JSON list of request objects, "
            f"got {type(entries).__name__}")
    rng = np.random.default_rng(seed)
    out = []
    for i, e in enumerate(entries):
        if not isinstance(e, dict):
            raise ValueError(
                f"trace {path} entry {i}: expected an object, "
                f"got {type(e).__name__}")
        if "gen" not in e:
            raise ValueError(f"trace {path} entry {i}: missing 'gen'")
        gen = int(e["gen"])
        if gen < 1:
            raise ValueError(
                f"trace {path} entry {i}: 'gen' must be >= 1, got {gen}")
        if "prompt" in e:
            toks = np.asarray(e["prompt"], np.int32).reshape(-1)
            if toks.size < 1:
                raise ValueError(
                    f"trace {path} entry {i}: 'prompt' is empty")
        elif "prompt_len" in e:
            plen = int(e["prompt_len"])
            if plen < 1:
                raise ValueError(
                    f"trace {path} entry {i}: 'prompt_len' must be >= 1, "
                    f"got {plen}")
            toks = rng.integers(0, vocab_size, size=(plen,)).astype(np.int32)
        else:
            raise ValueError(
                f"trace {path} entry {i}: needs 'prompt' or 'prompt_len'")
        priority = e.get("priority", 0)
        if isinstance(priority, bool) or not isinstance(priority, int):
            raise ValueError(
                f"trace {path} entry {i}: 'priority' must be an int, "
                f"got {priority!r}")
        arrival = e.get("arrival", 0)
        if isinstance(arrival, bool) or \
                not isinstance(arrival, (int, float)) or arrival < 0:
            raise ValueError(
                f"trace {path} entry {i}: 'arrival' must be a number >= 0, "
                f"got {arrival!r}")
        out.append(Request(rid=int(e.get("id", i)), prompt=toks,
                           max_new_tokens=gen, priority=priority,
                           arrival=float(arrival)))
    return out
