"""Step watchdog of the serving loop (the ``StepWatchdog`` of
``repro.runtime.fault``; host-only).

``launch/engine.py`` wires a :class:`StepWatchdog` into its serving loop:
each dispatched step's wall time is held against a running EMA, and the
``stragglers``/``hung`` verdict counts surface in ``EngineStats``.
"""
from __future__ import annotations

from typing import Optional

__all__ = ["StepWatchdog"]


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
