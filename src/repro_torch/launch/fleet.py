"""Fault-tolerant sharded serving tier: admission router over N engines
(port of ``repro.launch.fleet``).

``FleetRouter`` fronts N per-shard :class:`ContinuousBatchingEngine` s, each
on its own device when there are enough (``runtime.sharding.
fleet_device_groups``; a shard runs on the first device of its group),
with least-loaded admission, bounded retry/backoff on transient admission
failures, and graceful degradation to fifo-reject when every shard is
saturated.  The fault plane is injectable and fully deterministic: a seeded
:class:`FaultInjector` can

  * **kill a shard** mid-flight (``at_step`` / ``at_frac`` of total requested
    generation progress), hard or graceful, with an optional scheduled
    restart;
  * **hang an engine step** (a ``step_hook`` sleep inside the shard
    watchdog's timed window -- the wired-in ``runtime.fault.StepWatchdog``
    must flag it, and ``on_hang="kill"`` turns the verdict into a
    drain-and-migrate fault-plane event);
  * **fail an admission** (per-rid schedules and/or a hash-seeded rate),
    exercising the router's capped exponential backoff.

Recovery leans on the paper's deployment property: an integer LSTM stream's
whole recurrent state is a few hundred host bytes, slice/stackable and
bit-exact through the paged pool.  So when a shard dies the router drains it
(``engine.export_streams``) and

  * streams whose state survived (host pool pages; or any resident stream on
    a *graceful* drain) are **migrated**: re-admitted to a surviving shard
    WITH their state via ``engine.adopt_stream`` -- the same
    ``pool.take -> slot write`` path preemption uses, which puts the host
    row on the receiving shard's device -- so they continue bit-exactly as
    if the shard never died;
  * hard-killed residents (device state lost) are **replayed**: their
    generated prefix is folded into a fresh request's prompt and
    teacher-forced back (bit-exact by determinism: the chunked prefill
    equals feeding the tokens one at a time), the router stitching the
    prefix onto the continuation at finish;
  * never-started requests are simply re-routed.

Every completed stream -- migrated, replayed, or undisturbed -- is therefore
bit-identical to ``decode_single`` of its original request.  A killed
shard's engine is never read from the device or stepped again, and a
restart builds a fresh engine (fresh slot tensors) on the shard's device.

The router steps its shards one after another on the current CUDA stream
(no threads, no side streams): co-located shards share one card, and each
engine step launches the sequence kernel as a cooperative grid that must
not run beside another.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..convert import model_to
from ..runtime.fault import StepWatchdog
from .engine import (ContinuousBatchingEngine, MigratedStream, Request,
                     StreamResult)

__all__ = [
    "KillSpec", "HangSpec", "FaultInjector",
    "ShardStats", "FleetStats", "FleetStreamResult", "FleetRouter",
]


# ---------------------------------------------------------------------------
# Fault plane
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KillSpec:
    """Kill shard ``shard`` when the fleet clock passes ``at_step`` OR fleet
    generation progress (completed / total requested tokens) passes
    ``at_frac`` -- exactly one must be given.  ``graceful=False`` models an
    accelerator death (resident device state lost -> replay); ``True`` a
    planned drain (every stream migrates with state).  ``restart_after``
    (fleet steps) schedules a fresh engine on the same device; ``None``
    leaves the shard dead."""

    shard: int
    at_step: Optional[int] = None
    at_frac: Optional[float] = None
    graceful: bool = False
    restart_after: Optional[int] = None
    fired: bool = dataclasses.field(default=False, repr=False)

    def __post_init__(self):
        if (self.at_step is None) == (self.at_frac is None):
            raise ValueError(
                f"KillSpec(shard={self.shard}): give exactly one of "
                f"at_step / at_frac")
        if self.at_frac is not None and not 0.0 <= self.at_frac <= 1.0:
            raise ValueError(
                f"KillSpec(shard={self.shard}): at_frac must be in [0, 1], "
                f"got {self.at_frac}")


@dataclasses.dataclass
class HangSpec:
    """Sleep ``sleep_s`` inside shard ``shard``'s step timing window once its
    ENGINE step counter reaches ``at_step``, for ``repeat`` consecutive
    dispatched steps (fired at most ``repeat`` times total, so a restarted
    engine does not re-trigger it)."""

    shard: int
    at_step: int
    sleep_s: float = 0.05
    repeat: int = 1
    fired: int = dataclasses.field(default=0, repr=False)


def _spec_list(entries, cls):
    return [e if isinstance(e, cls) else cls(**e) for e in entries or ()]


class FaultInjector:
    """Deterministic, seeded fault plane for the fleet router.

    ``kills`` / ``hangs`` take :class:`KillSpec` / :class:`HangSpec`
    instances or plain dicts (the ``--fault-spec`` JSON schema).  Admission
    failures come from two deterministic sources: ``admission_fails`` maps
    ``rid -> k`` (that request's first ``k`` admission attempts fail --
    the targeted backoff test) and ``admission_fail_rate`` draws each
    (rid, attempt) from ``default_rng((seed, rid, attempt))``, so a given
    seed yields the same failure pattern on every run, every machine, and
    in both packages.
    """

    def __init__(self, *, seed: int = 0,
                 kills: Sequence[Any] = (),
                 hangs: Sequence[Any] = (),
                 admission_fails: Optional[Dict[int, int]] = None,
                 admission_fail_rate: float = 0.0):
        if not 0.0 <= admission_fail_rate < 1.0:
            raise ValueError(
                f"admission_fail_rate must be in [0, 1), "
                f"got {admission_fail_rate}")
        self.seed = int(seed)
        self.kills: List[KillSpec] = _spec_list(kills, KillSpec)
        self.hangs: List[HangSpec] = _spec_list(hangs, HangSpec)
        self.admission_fails = dict(admission_fails or {})
        self.admission_fail_rate = float(admission_fail_rate)
        self._sleep = time.sleep  # injectable for tests

    @classmethod
    def from_spec(cls, spec: Dict[str, Any]) -> "FaultInjector":
        """Build from the ``--fault-spec`` JSON object: ``{"seed": 0,
        "kills": [{"shard": 1, "at_frac": 0.5, ...}], "hangs": [...],
        "admission_fails": {"7": 2}, "admission_fail_rate": 0.1}``."""
        known = {"seed", "kills", "hangs", "admission_fails",
                 "admission_fail_rate"}
        extra = set(spec) - known
        if extra:
            raise ValueError(f"unknown fault-spec keys: {sorted(extra)}")
        fails = {int(k): int(v)
                 for k, v in (spec.get("admission_fails") or {}).items()}
        return cls(seed=spec.get("seed", 0), kills=spec.get("kills", ()),
                   hangs=spec.get("hangs", ()), admission_fails=fails,
                   admission_fail_rate=spec.get("admission_fail_rate", 0.0))

    # -- kills ---------------------------------------------------------------

    def kills_due(self, fleet_step: int, progress: float) -> List[KillSpec]:
        due = []
        for k in self.kills:
            if k.fired:
                continue
            if (k.at_step is not None and fleet_step >= k.at_step) or \
                    (k.at_frac is not None and progress >= k.at_frac):
                k.fired = True
                due.append(k)
        return due

    # -- hangs ---------------------------------------------------------------

    def hook_for(self, shard: int) -> Optional[Callable[[int], None]]:
        """The ``step_hook`` closure wired into shard ``shard``'s engine;
        ``None`` when no hang targets it (hot loop pays nothing)."""
        specs = [h for h in self.hangs if h.shard == shard]
        if not specs:
            return None

        def hook(engine_step: int) -> None:
            for h in specs:
                if h.fired < h.repeat and engine_step >= h.at_step:
                    h.fired += 1
                    self._sleep(h.sleep_s)

        return hook

    # -- admission failures ----------------------------------------------------

    def admission_fails_for(self, rid: int, attempt: int) -> bool:
        """True when admission ``attempt`` (0-based) of request ``rid``
        should fail transiently.  Stateless and deterministic."""
        if attempt < self.admission_fails.get(rid, 0):
            return True
        if self.admission_fail_rate > 0.0:
            r = np.random.default_rng((self.seed, rid, attempt)).random()
            return bool(r < self.admission_fail_rate)
        return False


# ---------------------------------------------------------------------------
# Stats + results
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ShardStats:
    """Per-shard accumulation across every ``run(max_steps=1)`` call."""

    steps: int = 0
    active_slot_steps: int = 0
    generated_tokens: int = 0
    preemptions: int = 0
    resumes: int = 0
    stragglers: int = 0
    hung: int = 0
    adopted: int = 0  # migrated streams this shard took in
    kills: int = 0
    restarts: int = 0
    alive: bool = True

    def occupancy(self, n_slots: int) -> float:
        denom = self.steps * n_slots
        return self.active_slot_steps / denom if denom else 0.0


@dataclasses.dataclass
class FleetStats:
    fleet_steps: int = 0
    n_shards: int = 0
    n_slots: int = 0  # per shard
    submitted: int = 0
    completed: int = 0
    rejected: int = 0
    lost: int = 0  # outstanding at an early stop / dead-fleet deadlock
    generated_tokens: int = 0
    admit_retries: int = 0
    migrated_streams: int = 0  # re-admitted WITH state (adopt path)
    replayed_streams: int = 0  # state lost -> prefix folded + teacher-forced
    rerouted_pending: int = 0  # never-started requests moved off a dead shard
    kills: int = 0
    restarts: int = 0
    hang_events: int = 0  # shard steps the watchdog ruled hung
    wall_s: float = 0.0
    shards: List[ShardStats] = dataclasses.field(default_factory=list)

    @property
    def goodput_tokens_per_step(self) -> float:
        """Generated tokens per fleet step: the deterministic goodput
        (wall-clock goodput moves with the host)."""
        return (self.generated_tokens / self.fleet_steps
                if self.fleet_steps else 0.0)

    @property
    def tokens_per_s(self) -> float:
        return self.generated_tokens / self.wall_s if self.wall_s else 0.0


@dataclasses.dataclass
class FleetStreamResult:
    """One request's fate through the fleet: final stitched tokens plus
    router-level latency stamps (fleet steps, arrival -> first token, so
    queueing and recovery delays are inside the number -- the open-loop
    convention)."""

    rid: int
    tokens: List[int]
    prompt_len: int
    arrival_step: int
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    finished_step: Optional[int] = None
    ttft_steps: Optional[int] = None
    ttft_s: Optional[float] = None
    shard: Optional[int] = None  # shard that finished the stream
    migrations: int = 0  # adopt-path moves (state travelled)
    replays: int = 0  # replay-path moves (prefix re-ingested)
    admit_attempts: int = 1
    rejected: bool = False
    truncated: bool = False


@dataclasses.dataclass
class _Shard:
    engine: ContinuousBatchingEngine
    stats: ShardStats
    alive: bool = True
    restart_at: Optional[int] = None


@dataclasses.dataclass
class _Track:
    """Router-side bookkeeping for one submitted request."""

    request: Request  # the ORIGINAL request (bit-exactness oracle input)
    arrival_step: int
    prefix: List[int] = dataclasses.field(default_factory=list)
    emitted: int = 0  # prefix + tokens generated on the current shard
    shard: Optional[int] = None
    admit_step: Optional[int] = None
    first_token_step: Optional[int] = None
    first_token_wall: Optional[float] = None
    migrations: int = 0
    replays: int = 0
    attempts: int = 0  # admission attempts so far
    retry_at: Optional[int] = None


# ---------------------------------------------------------------------------
# Router
# ---------------------------------------------------------------------------


class FleetRouter:
    """Admission router over ``n_shards`` continuous-batching engines.

    Admission is least-loaded (live + queued streams vs the shard's
    ``max_live``), ties to the lowest shard index so routing is
    deterministic.  A transiently failed admission (injected) retries with
    capped exponential backoff (``backoff_steps * 2**(attempt-1)``, capped
    at ``backoff_cap_steps``, at most ``max_admit_attempts`` attempts) before
    the request is rejected.  When every alive shard is saturated the
    request waits in the fleet queue up to ``max_queue`` waiters
    (``None`` = unbounded); beyond that the router degrades to fifo-reject.

    ``devices``: one ``torch.device`` a shard, or ``None`` (every shard on
    the device of ``params``).  A shard's engine runs on its device with the
    model placed there by ``convert.model_to``: shards on the model's own
    device share its weights.  There is no backend switch: the kernels or
    their plain versions run by the device of the tensors.

    ``on_hang``: what a shard-step hung verdict (its ``StepWatchdog``) does.
    ``"ignore"`` (default) only counts it; ``"kill"`` gracefully drains the
    shard -- every stream migrates with state to survivors -- and leaves it
    dead unless ``hang_restart_after`` schedules a restart.  Call
    :meth:`warmup` first when reacting to hangs: it runs a throwaway
    request per shard with the watchdog detached, so in-serving EMAs seed
    from warm step times instead of first-call spikes.

    The router drives shards in lockstep: each :meth:`run` iteration is one
    *fleet step* = at most one engine step per alive shard (``run(max_steps=1,
    keep_live=True)``), one shard after another, which keeps the fault
    clock, latency stamps, and the goodput deterministic for a given
    workload + injector seed.
    """

    def __init__(self, params, qlayers, cfg, *, n_shards: int,
                 slots_per_shard: int, chunk: int = 1,
                 speculate: int = 0, policy="fifo",
                 oversubscribe: float = 1.0, pool_page_size: int = 8,
                 injector: Optional[FaultInjector] = None,
                 devices: Optional[Sequence[Any]] = None,
                 watchdog_factory: Callable[[], StepWatchdog] = StepWatchdog,
                 on_hang: str = "ignore",
                 hang_restart_after: Optional[int] = None,
                 max_admit_attempts: int = 3, backoff_steps: int = 1,
                 backoff_cap_steps: int = 8,
                 max_queue: Optional[int] = None):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if on_hang not in ("ignore", "kill"):
            raise ValueError(
                f"on_hang must be 'ignore' or 'kill', got {on_hang!r}")
        if max_admit_attempts < 1:
            raise ValueError(
                f"max_admit_attempts must be >= 1, got {max_admit_attempts}")
        if backoff_steps < 1 or backoff_cap_steps < backoff_steps:
            raise ValueError(
                f"need 1 <= backoff_steps <= backoff_cap_steps, got "
                f"{backoff_steps}/{backoff_cap_steps}")
        if devices is not None and len(devices) != n_shards:
            raise ValueError(
                f"devices has {len(devices)} entries for {n_shards} shards")
        self._model = (params, qlayers, cfg)
        self._placed: Dict[torch.device, Tuple[Any, Any]] = {}
        self.n_shards = n_shards
        self.slots_per_shard = slots_per_shard
        self._engine_kw = dict(
            chunk=chunk, speculate=speculate, policy=policy,
            oversubscribe=oversubscribe, pool_page_size=pool_page_size)
        self._devices = (
            [torch.device(d) for d in devices] if devices is not None
            else [params["embedding"].device] * n_shards)
        self.injector = injector
        self._watchdog_factory = watchdog_factory
        self.on_hang = on_hang
        self.hang_restart_after = hang_restart_after
        self.max_admit_attempts = max_admit_attempts
        self.backoff_steps = backoff_steps
        self.backoff_cap_steps = backoff_cap_steps
        self.max_queue = max_queue
        self.stats = FleetStats(n_shards=n_shards, n_slots=slots_per_shard)
        self.shards: List[_Shard] = [
            _Shard(engine=self._make_engine(i), stats=ShardStats())
            for i in range(n_shards)]
        self._queue: List[int] = []  # rids waiting for capacity / arrival
        self._orphans: List[Tuple[int, MigratedStream]] = []  # (rid, ms)
        self._tracks: Dict[int, _Track] = {}
        self._results: Dict[int, FleetStreamResult] = {}
        self._all_rids: set = set()
        self._total_requested = 0  # sum of max_new over submitted requests
        self._fleet_step = 0
        self._warm_rid = -1  # negative rids: internal warmup streams

    # -- construction helpers -------------------------------------------------

    def _make_engine(self, i: int) -> ContinuousBatchingEngine:
        """A fresh engine (fresh slot tensors) for shard ``i`` on its
        device; the model is placed there once and shared by every engine
        the device ever holds."""
        params, qlayers, cfg = self._model
        dev = self._devices[i]
        if dev not in self._placed:
            self._placed[dev] = model_to(params, qlayers, dev)
        p, q = self._placed[dev]
        hook = self.injector.hook_for(i) if self.injector else None
        return ContinuousBatchingEngine(
            p, q, cfg, self.slots_per_shard,
            watchdog=self._watchdog_factory(), step_hook=hook,
            **self._engine_kw)

    def warmup(self) -> None:
        """Run one throwaway request per shard with the watchdog detached:
        the first calls of the step (and, with ``chunk > 1``, the chunked
        prefill) programs run here, and each watchdog's EMA stays unseeded
        until real serving steps -- so first-call spikes never become the
        hang baseline."""
        chunk = self._engine_kw["chunk"]
        plen = max(2 * chunk, 2)
        for sh in self.shards:
            if not sh.alive:
                continue
            wd, sh.engine.watchdog = sh.engine.watchdog, None
            hook, sh.engine._step_hook = sh.engine._step_hook, None
            try:
                sh.engine.submit(Request(
                    rid=self._warm_rid, prompt=np.zeros(plen, np.int32),
                    max_new_tokens=2))
                self._warm_rid -= 1
                sh.engine.run()
            finally:
                sh.engine.watchdog = wd
                sh.engine._step_hook = hook

    # -- submission ------------------------------------------------------------

    def submit(self, request: Request) -> None:
        """Queue a request; ``request.arrival`` is the FLEET step it becomes
        admissible (the engine-level arrival clock is not reused -- the
        router re-stamps shard submissions to arrive immediately)."""
        if request.rid < 0:
            raise ValueError(
                f"request ids must be >= 0 (negative rids are reserved "
                f"for router warmup), got {request.rid}")
        if request.rid in self._all_rids:
            raise ValueError(f"duplicate request id {request.rid}")
        self._all_rids.add(request.rid)
        self._tracks[request.rid] = _Track(
            request=request, arrival_step=int(request.arrival))
        self._queue.append(request.rid)
        self._total_requested += request.max_new_tokens
        self.stats.submitted += 1

    def submit_all(self, requests: Sequence[Request]) -> None:
        for r in requests:
            self.submit(r)

    # -- progress / placement ---------------------------------------------------

    def _progress(self) -> float:
        """Fraction of all requested generation tokens emitted so far --
        the ``at_frac`` kill clock."""
        if not self._total_requested:
            return 0.0
        done = sum(t.emitted for t in self._tracks.values())
        done += sum(len(r.tokens) for r in self._results.values())
        return done / self._total_requested

    def _alive(self) -> List[int]:
        return [i for i, sh in enumerate(self.shards) if sh.alive]

    def _load(self, i: int) -> int:
        eng = self.shards[i].engine
        return eng.live + eng.pending

    def _pick_shard(self, *, need_capacity: bool) -> Optional[int]:
        """Least-loaded alive shard; with ``need_capacity`` only shards
        below their admission ceiling qualify (recovery placement passes
        False: a migrated stream beats admission control)."""
        best, best_load = None, None
        for i in self._alive():
            load = self._load(i)
            if need_capacity and load >= self.shards[i].engine.max_live:
                continue
            if best_load is None or load < best_load:
                best, best_load = i, load
        return best

    # -- admission ----------------------------------------------------------------

    def _reject(self, rid: int) -> None:
        t = self._tracks.pop(rid)
        self._results[rid] = FleetStreamResult(
            rid=rid, tokens=[], prompt_len=int(t.request.prompt.size),
            arrival_step=t.arrival_step, finished_step=self._fleet_step,
            admit_attempts=t.attempts, rejected=True, truncated=True)
        self.stats.rejected += 1

    def _try_admissions(self) -> None:
        """FIFO pass over the fleet queue: place every arrived request that
        a shard has capacity for; inject transient failures; keep the rest
        queued (or fifo-reject past ``max_queue``)."""
        still: List[int] = []
        waiting = 0
        for rid in self._queue:
            t = self._tracks[rid]
            if t.arrival_step > self._fleet_step or \
                    (t.retry_at is not None and
                     t.retry_at > self._fleet_step):
                still.append(rid)
                if t.arrival_step <= self._fleet_step:
                    waiting += 1  # backing off counts against the queue cap
                continue
            target = self._pick_shard(need_capacity=True)
            if target is None:
                # saturated fleet: wait if the queue has room, else degrade
                # to fifo-reject (newest waiters bounce first)
                if self.max_queue is not None and waiting >= self.max_queue:
                    self._reject(rid)
                else:
                    still.append(rid)
                    waiting += 1
                continue
            attempt = t.attempts
            t.attempts += 1
            if self.injector is not None and \
                    self.injector.admission_fails_for(rid, attempt):
                # transient admission failure: capped exponential backoff,
                # then reject once the attempt budget is spent
                if t.attempts >= self.max_admit_attempts:
                    self._reject(rid)
                else:
                    pause = min(
                        self.backoff_steps * (2 ** (t.attempts - 1)),
                        self.backoff_cap_steps)
                    t.retry_at = self._fleet_step + pause
                    self.stats.admit_retries += 1
                    still.append(rid)
                    waiting += 1
                continue
            t.retry_at = None
            t.shard = target
            t.admit_step = self._fleet_step
            self.shards[target].engine.submit(
                dataclasses.replace(t.request, arrival=0.0))
        self._queue = still

    # -- fault plane: kills, restarts, hangs ------------------------------------

    def _kill_shard(self, idx: int, *, graceful: bool,
                    restart_after: Optional[int]) -> None:
        """Drain shard ``idx`` and mark it dead.  A hard kill reads none of
        its device state (``export_streams(device_alive=False)``), and a
        dead shard's engine is never stepped again."""
        sh = self.shards[idx]
        if not sh.alive:
            return
        exported = sh.engine.export_streams(device_alive=graceful)
        sh.alive = False
        sh.stats.alive = False
        sh.stats.kills += 1
        self.stats.kills += 1
        if restart_after is not None:
            sh.restart_at = self._fleet_step + max(int(restart_after), 0)
        for ms in exported:
            if ms.request.rid >= 0:  # warmup leftovers die with the shard
                self._orphans.append((ms.request.rid, ms))
        self._drain_orphans()

    def _drain_orphans(self) -> None:
        """Re-home drained streams onto alive shards.  Streams with state
        migrate (adopt path); hard-killed residents replay (prefix folded
        into a fresh prompt); pending requests re-queue.  Orphans stay
        parked here while no shard is alive -- a scheduled restart picks
        them up."""
        if not self._orphans:
            return
        left: List[Tuple[int, MigratedStream]] = []
        for rid, ms in self._orphans:
            t = self._tracks.get(rid)
            if t is None:
                continue  # rejected/finished while orphaned (should not occur)
            if ms.pending:
                # never started: plain re-route through normal admission
                t.shard = None
                if rid not in self._queue:
                    self._queue.append(rid)
                self.stats.rerouted_pending += 1
                continue
            target = self._pick_shard(need_capacity=False)
            if target is None:
                left.append((rid, ms))
                continue
            eng = self.shards[target].engine
            if ms.state_row is not None:
                # state survived (host arrays): bit-exact continuation via
                # the pool and a slot write on the target's device
                eng.adopt_stream(
                    ms.request, state_row=ms.state_row, fed=ms.fed,
                    generated=ms.generated, drafter=ms.drafter,
                    preemptions=ms.preemptions)
                t.shard = target
                t.migrations += 1
                self.shards[target].stats.adopted += 1
                self.stats.migrated_streams += 1
            else:
                # device state died: fold the generated prefix into the
                # prompt and teacher-force it back (deterministic integer
                # math makes the replayed state bitwise identical)
                t.prefix.extend(ms.generated)
                folded = Request(
                    rid=rid,
                    prompt=np.concatenate([
                        ms.request.prompt,
                        np.asarray(ms.generated, np.int32)]),
                    max_new_tokens=(ms.request.max_new_tokens
                                    - len(ms.generated)),
                    priority=ms.request.priority)
                eng.submit(folded)
                t.shard = target
                t.replays += 1
                self.stats.replayed_streams += 1
        self._orphans = left

    def _restarts_due(self) -> None:
        for i, sh in enumerate(self.shards):
            if not sh.alive and sh.restart_at is not None \
                    and sh.restart_at <= self._fleet_step:
                sh.engine = self._make_engine(i)
                sh.alive = True
                sh.stats.alive = True
                sh.restart_at = None
                sh.stats.restarts += 1
                self.stats.restarts += 1
        self._drain_orphans()

    # -- result plumbing -------------------------------------------------------

    def _finish(self, rid: int, r: StreamResult, shard: int,
                now: float) -> None:
        t = self._tracks.pop(rid)
        tokens = t.prefix + r.tokens
        if r.rejected:  # engine-level rejection (fifo-reject policies)
            self._results[rid] = FleetStreamResult(
                rid=rid, tokens=[], prompt_len=int(t.request.prompt.size),
                arrival_step=t.arrival_step, admit_step=t.admit_step,
                finished_step=self._fleet_step, admit_attempts=t.attempts,
                rejected=True, truncated=True)
            self.stats.rejected += 1
            return
        new = max(len(tokens) - t.emitted, 0)
        t.emitted = len(tokens)
        self.stats.generated_tokens += new
        self.shards[shard].stats.generated_tokens += new
        if t.first_token_step is None and tokens:
            t.first_token_step = self._fleet_step
            t.first_token_wall = now
        ttft_steps = ttft_s = None
        if t.first_token_step is not None:
            ttft_steps = t.first_token_step - t.arrival_step + 1
            ttft_s = t.first_token_wall - self._t_arrival_wall
        self._results[rid] = FleetStreamResult(
            rid=rid, tokens=tokens, prompt_len=int(t.request.prompt.size),
            arrival_step=t.arrival_step, admit_step=t.admit_step,
            first_token_step=t.first_token_step,
            finished_step=self._fleet_step,
            ttft_steps=ttft_steps, ttft_s=ttft_s, shard=shard,
            migrations=t.migrations, replays=t.replays,
            admit_attempts=max(t.attempts, 1), truncated=r.truncated)
        self.stats.completed += 1

    def _poll_first_tokens(self, now: float) -> None:
        """Per-step ``live_progress`` poll: stamp fleet-level TTFT the step a
        stream's emitted count first goes positive, and keep the per-stream
        emitted counters (the ``at_frac`` kill clock) current."""
        for i in self._alive():
            sh = self.shards[i]
            for rid, n_gen in sh.engine.live_progress().items():
                t = self._tracks.get(rid)
                if t is None:
                    continue
                total = len(t.prefix) + n_gen
                if total > t.emitted:
                    delta = total - t.emitted
                    t.emitted = total
                    self.stats.generated_tokens += delta
                    sh.stats.generated_tokens += delta
                if total > 0 and t.first_token_step is None:
                    t.first_token_step = self._fleet_step
                    t.first_token_wall = now

    # -- the fleet loop -----------------------------------------------------------

    def run(self, max_fleet_steps: Optional[int] = None
            ) -> Tuple[Dict[int, FleetStreamResult], FleetStats]:
        """Drive the fleet until every submitted request resolves (finished,
        rejected, or -- if the whole fleet dies with no scheduled restart --
        lost).  Returns per-request results keyed by rid plus fleet stats.
        Callable repeatedly; results accumulate across calls."""
        t0 = time.perf_counter()
        self._t_arrival_wall = t0  # wall anchor for ttft_s this run
        ran = 0
        while self._tracks:
            if max_fleet_steps is not None and ran >= max_fleet_steps:
                break
            if self.injector is not None:
                progress = self._progress()  # the kill clock
                self._restarts_due()
                for spec in self.injector.kills_due(self._fleet_step,
                                                    progress):
                    self._kill_shard(spec.shard, graceful=spec.graceful,
                                     restart_after=spec.restart_after)
            else:
                self._restarts_due()
            alive = self._alive()
            if not alive:
                if any(sh.restart_at is not None for sh in self.shards):
                    self._fleet_step += 1  # dead air until a restart lands
                    ran += 1
                    continue
                break  # whole fleet dead, no restart coming: bail out
            self._try_admissions()
            for i in alive:
                sh = self.shards[i]
                if not sh.alive:
                    continue  # killed earlier this same step
                eng = sh.engine
                if not (eng.live or eng.pending):
                    continue
                results, st = eng.run(max_steps=1, keep_live=True)
                s = sh.stats
                s.steps += st.steps
                s.active_slot_steps += st.active_slot_steps
                s.preemptions += st.preemptions
                s.resumes += st.resumes
                s.stragglers += st.stragglers
                s.hung += st.hung
                now = time.perf_counter()
                for rid, r in results.items():
                    if rid >= 0:  # negative rids: warmup stragglers
                        self._finish(rid, r, i, now)
                if st.hung:
                    self.stats.hang_events += st.hung
                    if self.on_hang == "kill":
                        # the watchdog ruled the device wedged: graceful
                        # drain (host can still read state), streams migrate
                        self._kill_shard(
                            i, graceful=True,
                            restart_after=self.hang_restart_after)
            self._poll_first_tokens(time.perf_counter())
            self._fleet_step += 1
            ran += 1
        # a bounded run that hit max_fleet_steps hands live streams back to
        # the next run() call; any other early exit means the whole fleet
        # died with no restart coming -- drain those streams to truncated
        # results (prefixes preserved) so callers never lose one silently
        hit_bound = max_fleet_steps is not None and ran >= max_fleet_steps
        if self._tracks and not hit_bound:
            self._drain_outstanding_as_lost()
        self.stats.fleet_steps += ran
        self.stats.wall_s += time.perf_counter() - t0
        for sh in self.shards:
            sh.stats.alive = sh.alive
        self.stats.shards = [sh.stats for sh in self.shards]
        return dict(self._results), self.stats

    def _drain_outstanding_as_lost(self) -> None:
        """The fleet died with streams in flight and no restart scheduled:
        surface them as truncated results (prefix + whatever a live export
        can still recover as token lists -- no state survives)."""
        for sh in self.shards:
            if not sh.alive:
                continue
            for ms in sh.engine.export_streams(device_alive=False):
                t = self._tracks.get(ms.request.rid)
                if t is not None:
                    t.prefix.extend(ms.generated)
        for rid, ms in self._orphans:
            t = self._tracks.get(rid)
            if t is not None and not ms.pending:
                t.prefix.extend(ms.generated)
        self._orphans.clear()
        self._queue.clear()
        for rid, t in list(self._tracks.items()):
            self._results[rid] = FleetStreamResult(
                rid=rid, tokens=list(t.prefix),
                prompt_len=int(t.request.prompt.size),
                arrival_step=t.arrival_step, admit_step=t.admit_step,
                first_token_step=t.first_token_step,
                finished_step=self._fleet_step, shard=t.shard,
                migrations=t.migrations, replays=t.replays,
                admit_attempts=max(t.attempts, 1), truncated=True)
            self.stats.lost += 1
            del self._tracks[rid]
