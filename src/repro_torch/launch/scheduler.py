"""Pluggable slot-scheduling policies for the continuous-batching engine.

The port's own copy of ``repro.launch.scheduler`` (host-only: no tensors).

The engine's executor (``launch/engine.py``) owns the step programs
and the ``(S, ...)`` slot tensors; *which* streams occupy those S slots each
step is a :class:`Scheduler`'s decision.  Because a preempted integer-LSTM
stream's whole state is two small integer vectors per layer (parked
bit-exactly in ``launch/state_pool.StatePool``), policies may preempt and
resume streams freely -- every policy produces bit-identical per-stream
tokens; they differ only in *when* each stream's tokens come out (TTFT,
completion latency, fairness) and how much swap traffic they generate.

Contract: ``schedule`` sees three disjoint, deterministically-ordered lists
of :class:`StreamView`s and returns a :class:`Decision` naming at most
``n_slots`` streams to run this step.  Views in ``resident`` currently hold
a slot; ``pooled`` are live but parked; ``pending`` have arrived but never
started (starting one consumes ``start_budget`` -- the oversubscription
headroom ``max_live - live``).  The executor keeps re-elected residents in
their slots, parks residents left off the list, and fills freed slots with
the remaining elected streams in the order the policy listed them -- so a
policy's list order IS its slot-assignment preference.  Schedulers may keep
internal state (one instance serves one engine); they must be deterministic
for a given call sequence, which keeps every workload replayable.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

__all__ = [
    "StreamView", "Decision", "Scheduler", "FIFOScheduler",
    "FIFORejectScheduler", "PriorityScheduler",
    "ShortestRemainingFirstScheduler", "RoundRobinFairScheduler",
    "POLICIES", "get_scheduler",
]


@dataclasses.dataclass(frozen=True)
class StreamView:
    """What a policy may observe about one stream (host bookkeeping only --
    never tensors, so scheduling cannot perturb the integer math)."""

    rid: int
    priority: int  # larger = more urgent (Request.priority)
    arrival: float  # engine step the request became schedulable
    submit_idx: int  # submission order, the final deterministic tie-break
    prompt_len: int
    prompt_remaining: int  # prompt tokens not yet fed
    gen_remaining: int  # generation budget not yet produced
    resident: bool  # currently occupies a slot
    slot: Optional[int] = None  # its slot when resident
    resident_steps: int = 0  # consecutive steps of the current slot tenure

    @property
    def remaining(self) -> int:
        """Total tokens of work left (the SRF key)."""
        return self.prompt_remaining + self.gen_remaining

    def order_key(self):
        """The shared deterministic tie-break: earlier arrival, then
        submission order."""
        return (self.arrival, self.submit_idx)


@dataclasses.dataclass
class Decision:
    """``run``: rids to occupy slots this step (<= n_slots, policy-ordered).
    ``reject``: arrived-pending rids to refuse admission forever (admission
    control -- e.g. :class:`FIFORejectScheduler`'s bounded behavior)."""

    run: List[int]
    reject: List[int] = dataclasses.field(default_factory=list)


class Scheduler:
    """Interface: decide which streams hold slots for one engine step."""

    name: str = "base"

    def schedule(self, step_idx: int, resident: Sequence[StreamView],
                 pooled: Sequence[StreamView], pending: Sequence[StreamView],
                 n_slots: int, start_budget: int) -> Decision:
        raise NotImplementedError

    @staticmethod
    def _select(ranked: Sequence[StreamView], pending_rids, n_slots: int,
                start_budget: int) -> List[int]:
        """Shared greedy walk over ranked candidates: take the first
        ``n_slots`` runnable views, skipping pending ones beyond the
        oversubscription start budget (live streams -- resident or pooled
        -- already hold pool/slot capacity and always remain runnable)."""
        run: List[int] = []
        starts = 0
        for v in ranked:
            if len(run) == n_slots:
                break
            if v.rid in pending_rids:
                if starts >= start_budget:
                    continue
                starts += 1
            run.append(v.rid)
        return run


class FIFOScheduler(Scheduler):
    """The pre-refactor engine's exact behavior: residents are never
    preempted; free slots admit pooled streams (only present after a user
    ``evict(preserve=True)`` / ``resume``) then pending requests in arrival
    order.  With ``oversubscribe=1`` this reproduces the monolithic
    engine's step-by-step slot assignments bit- and step-exactly
    (``tests/test_scheduler.py`` locks that against a reference simulation
    of the old admission loop)."""

    name = "fifo"

    def schedule(self, step_idx, resident, pooled, pending, n_slots,
                 start_budget) -> Decision:
        run = [v.rid for v in resident]
        free = n_slots - len(run)
        for v in pooled[:max(free, 0)]:
            run.append(v.rid)
            free -= 1
        n_admit = max(min(free, start_budget), 0)
        run.extend(v.rid for v in pending[:n_admit])
        return Decision(run=run)


class FIFORejectScheduler(FIFOScheduler):
    """FIFO **without a waiting room**: an arrived request that cannot be
    placed into a free slot this very step is rejected outright.  The
    loss-of-goodput baseline ``benchmarks/preempt_resume.py`` measures
    oversubscribed scheduling against -- rejected work is gone forever,
    where a pooled engine would have parked it."""

    name = "fifo-reject"

    def schedule(self, step_idx, resident, pooled, pending, n_slots,
                 start_budget) -> Decision:
        d = super().schedule(step_idx, resident, pooled, pending, n_slots,
                             start_budget)
        placed = set(d.run)
        d.reject = [v.rid for v in pending if v.rid not in placed]
        return d


class PriorityScheduler(Scheduler):
    """Strict priority: the ``n_slots`` highest-priority live-or-arrived
    streams hold the slots; a newly-arrived high-priority request preempts
    the lowest-priority resident (its state parks in the pool, bit-exactly).
    Ties break by arrival then submission order, so equal-priority traffic
    degrades to FIFO."""

    name = "priority"

    def schedule(self, step_idx, resident, pooled, pending, n_slots,
                 start_budget) -> Decision:
        ranked = sorted(
            list(resident) + list(pooled) + list(pending),
            key=lambda v: (-v.priority,) + v.order_key())
        pending_rids = {v.rid for v in pending}
        return Decision(run=self._select(ranked, pending_rids, n_slots,
                                         start_budget))


class ShortestRemainingFirstScheduler(Scheduler):
    """Shortest-remaining-first: slots go to the streams with the least
    total work left (prompt remaining + generation budget remaining).
    Short jobs cut ahead of long residents, which park in the pool --
    minimizing mean completion time on mixed-length traffic at the price of
    swap traffic for the long tail.  A resident's remaining work only
    shrinks, so SRF never thrashes between equals (ties break by arrival /
    submission order, which is stable)."""

    name = "srf"

    def schedule(self, step_idx, resident, pooled, pending, n_slots,
                 start_budget) -> Decision:
        ranked = sorted(
            list(resident) + list(pooled) + list(pending),
            key=lambda v: (v.remaining,) + v.order_key())
        pending_rids = {v.rid for v in pending}
        return Decision(run=self._select(ranked, pending_rids, n_slots,
                                         start_budget))


class RoundRobinFairScheduler(Scheduler):
    """Time-sliced fairness: every live stream gets ``quantum`` consecutive
    slot-steps, then rotates to the back of the ring while waiters (pooled
    or pending) take its slot.  No stream starves regardless of length or
    priority -- the per-tenant-fairness building block.  The ring is
    internal scheduler state; order of first sight (resident slot order,
    then pool order, then arrival order) seeds it deterministically."""

    name = "rr"

    def __init__(self, quantum: int = 8):
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.quantum = quantum
        self._ring: List[int] = []
        self._ran: Dict[int, int] = {}

    def schedule(self, step_idx, resident, pooled, pending, n_slots,
                 start_budget) -> Decision:
        views = {v.rid: v for v in
                 list(resident) + list(pooled) + list(pending)}
        # drop finished/evicted streams, enrol newly-seen ones at the tail
        self._ring = [r for r in self._ring if r in views]
        self._ran = {r: n for r, n in self._ran.items() if r in views}
        for v in list(resident) + list(pooled) + list(pending):
            if v.rid not in self._ran:
                self._ring.append(v.rid)
                self._ran[v.rid] = 0
        pending_rids = {p.rid for p in pending}
        run: List[int] = []
        starts = 0
        for rid in self._ring:
            if len(run) == n_slots:
                break
            if rid in pending_rids:
                if starts >= start_budget:
                    continue
                starts += 1
            run.append(rid)
        # account the slice; exhausted streams rotate to the tail when
        # someone is waiting (otherwise rotating is pointless churn)
        waiters = len(views) > len(run)
        for rid in run:
            self._ran[rid] += 1
        if waiters:
            expired = [r for r in run if self._ran[r] >= self.quantum]
            if expired:
                keep = [r for r in self._ring if r not in expired]
                self._ring = keep + expired
                for r in expired:
                    self._ran[r] = 0
        return Decision(run=run)


POLICIES = {
    "fifo": FIFOScheduler,
    "fifo-reject": FIFORejectScheduler,
    "priority": PriorityScheduler,
    "srf": ShortestRemainingFirstScheduler,
    "rr": RoundRobinFairScheduler,
}


def get_scheduler(policy, **kwargs) -> Scheduler:
    """Resolve a policy name (or pass through a Scheduler instance).

    Unknown names raise ``ValueError`` listing the registry -- scheduling is
    a correctness-adjacent knob and a typo must not silently serve FIFO.
    """
    if isinstance(policy, Scheduler):
        return policy
    if policy not in POLICIES:
        raise ValueError(
            f"unknown scheduling policy {policy!r}; "
            f"available: {sorted(POLICIES)}")
    return POLICIES[policy](**kwargs)
