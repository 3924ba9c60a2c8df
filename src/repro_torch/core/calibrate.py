"""Statistics collection for post-training quantization (paper sec 4).

Port of ``repro.core.calibrate``: a ``TapCollector`` passed through the
float forward records the min/max of every Table-2 tensor under a stable
name, and ``Stats`` aggregates them as Python floats.  ``calibrate`` runs
a forward over a calibration set and merges every batch's ranges.

The reference jits its per-batch calibration program; the port runs it
eagerly, and the ranges are the same: a min or max is exact in any order.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch


class TapCollector:
    """Records the running min/max of named intermediates (float32)."""

    def __init__(self):
        self.taps: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = {}

    def tap(self, name: str, x: torch.Tensor) -> torch.Tensor:
        lo = x.min().to(torch.float32)
        hi = x.max().to(torch.float32)
        if name in self.taps:
            plo, phi = self.taps[name]
            lo, hi = torch.minimum(lo, plo), torch.maximum(hi, phi)
        self.taps[name] = (lo, hi)
        return x

    def snapshot(self) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        return dict(self.taps)


class Stats:
    """Running min/max aggregate keyed by tap name."""

    def __init__(self):
        self.ranges: Dict[str, Tuple[float, float]] = {}

    def merge(self, taps) -> None:
        for name, (lo, hi) in taps.items():
            lo, hi = float(lo), float(hi)
            if name in self.ranges:
                plo, phi = self.ranges[name]
                lo, hi = min(lo, plo), max(hi, phi)
            self.ranges[name] = (lo, hi)

    def range(self, name: str) -> Tuple[float, float]:
        if name not in self.ranges:
            raise KeyError(f"no calibration stats for tap '{name}'; "
                           f"have {sorted(self.ranges)}")
        return self.ranges[name]

    def max_abs(self, name: str) -> float:
        lo, hi = self.range(name)
        return max(abs(lo), abs(hi))

    def to_dict(self) -> Dict[str, Tuple[float, float]]:
        return dict(self.ranges)

    @classmethod
    def from_dict(cls, d: Dict[str, Tuple[float, float]]) -> "Stats":
        s = cls()
        s.ranges = {k: (float(v[0]), float(v[1])) for k, v in d.items()}
        return s


def calibrate(apply_fn: Callable, params, batches,
              num_batches: Optional[int] = None) -> Stats:
    """Run ``apply_fn(params, batch, collector)`` over a calibration set.

    ``apply_fn`` must route the collector's ``tap`` through the model; each
    batch gets a fresh ``TapCollector``, without autograd.  The paper's
    finding: a fixed ~100-sample set is enough for negligible loss.
    """
    stats = Stats()
    for i, batch in enumerate(batches):
        if num_batches is not None and i >= num_batches:
            break
        collector = TapCollector()
        with torch.no_grad():
            apply_fn(params, batch, collector)
        stats.merge(collector.snapshot())
    return stats
