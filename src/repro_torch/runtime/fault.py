"""Fault tolerance: the step watchdog and the restart-from-checkpoint
driver (port of ``repro.runtime.fault``; host-only).

``launch/engine.py`` wires a :class:`StepWatchdog` into its serving loop
and ``launch/train.py`` into its training loop: each step's wall time is
held against a running EMA, and the ``stragglers``/``hung`` verdicts are
counted.  ``run_with_restarts`` drives a training run to completion,
resuming from the latest durable checkpoint
(``checkpoint.manager.CheckpointManager``) after a failure a restart can
cure.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional, Tuple, Type

__all__ = ["StepWatchdog", "RestartStats", "run_with_restarts",
           "RESTARTABLE_EXCEPTIONS"]


class StepWatchdog:
    """Detects hung/straggling steps by wall-clock against a running EMA.

    * ``timeout_factor`` x EMA -> considered HUNG.
    * ``straggler_factor`` x EMA -> counted as a straggler.

    ``stragglers`` / ``hung`` count the verdicts so far; ``last_verdict``
    is the most recent classification.  A hung step still updates the EMA
    -- a genuinely slower regime stops alarming once the EMA catches up.
    """

    def __init__(self, timeout_factor: float = 10.0,
                 straggler_factor: float = 2.0, ema: float = 0.9):
        if timeout_factor <= straggler_factor:
            raise ValueError(
                f"timeout_factor ({timeout_factor}) must exceed "
                f"straggler_factor ({straggler_factor})")
        if not 0.0 <= ema < 1.0:
            raise ValueError(f"ema must be in [0, 1), got {ema}")
        self.timeout_factor = timeout_factor
        self.straggler_factor = straggler_factor
        self.ema_coef = ema
        self.ema_s: Optional[float] = None
        self.stragglers = 0
        self.hung = 0
        self.steps = 0
        self.last_verdict = "ok"

    def observe(self, seconds: float) -> str:
        self.steps += 1
        verdict = "ok"
        if self.ema_s is not None:
            if seconds > self.timeout_factor * self.ema_s:
                verdict = "hung"
                self.hung += 1
            elif seconds > self.straggler_factor * self.ema_s:
                verdict = "straggler"
                self.stragglers += 1
        self.ema_s = (seconds if self.ema_s is None
                      else self.ema_coef * self.ema_s
                      + (1 - self.ema_coef) * seconds)
        self.last_verdict = verdict
        return verdict


@dataclasses.dataclass
class RestartStats:
    restarts: int = 0
    completed_steps: int = 0
    resumed_from: Optional[int] = None
    backoff_s_total: float = 0.0  # wall spent backing off between restarts


# The default restart allowlist: infrastructure failures a restart can
# plausibly cure (lost node, preempted VM, flaky filesystem/network, a step
# that the watchdog timed out).  Programming errors -- TypeError, ValueError,
# KeyError, assertion failures -- propagate immediately: restarting them
# would deterministically re-fail and burn the restart budget for nothing.
RESTARTABLE_EXCEPTIONS: Tuple[Type[BaseException], ...] = (
    RuntimeError, OSError, TimeoutError, ConnectionError,
)


def run_with_restarts(
    train_chunk: Callable[[int], int],
    *,
    ckpt_latest: Callable[[], Optional[int]],
    total_steps: int,
    max_restarts: int = 10,
    restart_on: Tuple[Type[BaseException], ...] = RESTARTABLE_EXCEPTIONS,
    backoff_s: float = 0.05,
    backoff_cap_s: float = 5.0,
    sleep: Callable[[float], None] = time.sleep,
) -> RestartStats:
    """Drive ``train_chunk(start_step) -> reached_step`` to completion,
    restarting from the latest durable checkpoint on allowlisted exceptions.

    ``train_chunk`` is expected to checkpoint periodically and may raise at
    any point (node failure, preemption); restart resumes from disk.

    * Only the exceptions of ``restart_on`` restart; anything else (a
      ``ValueError`` from a bad config, a ``KeyError`` from a renamed
      param) propagates at once.
    * Restart ``n`` first sleeps ``min(backoff_s * 2**(n-1),
      backoff_cap_s)`` (``sleep`` is injectable for tests), so a persistent
      failure costs bounded wall time, not a busy loop over the checkpoint
      store.  Past ``max_restarts`` the failure propagates.
    """
    if max_restarts < 0:
        raise ValueError(f"max_restarts must be >= 0, got {max_restarts}")
    if backoff_s < 0 or backoff_cap_s < 0:
        raise ValueError(
            f"backoff_s/backoff_cap_s must be >= 0, got "
            f"{backoff_s}/{backoff_cap_s}")
    stats = RestartStats()
    start = ckpt_latest() or 0
    stats.resumed_from = start
    while start < total_steps:
        try:
            start = train_chunk(start)
            stats.completed_steps = start
        except restart_on:
            stats.restarts += 1
            if stats.restarts > max_restarts:
                raise
            pause = min(backoff_s * (2.0 ** (stats.restarts - 1)),
                        backoff_cap_s)
            if pause > 0:
                sleep(pause)
                stats.backoff_s_total += pause
            start = ckpt_latest() or 0
    return stats
