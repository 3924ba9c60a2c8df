"""Statistics collection for post-training quantization (paper sec 4).

Port of ``repro.core.calibrate``: a ``TapCollector`` passed through the
float forward records the min/max of every Table-2 tensor under a stable
name, and ``Stats`` aggregates them as Python floats.
"""
from __future__ import annotations

from typing import Dict, Tuple

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
