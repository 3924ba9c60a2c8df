"""Deterministic synthetic data pipeline: seekable and restartable.

Port of the numpy part of ``repro.data.pipeline``.  Streams LM batches with
*learnable structure* (per-document affine next-token rule ``x_{t+1} = (a *
x_t + b) mod V`` with noise).  The iterator state is a single step counter,
and any step is reproducible from ``(seed, step)``.  Batches are numpy
arrays; the caller moves them to its device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    noise: float = 0.05
    frontend_tokens: int = 0  # emit stub frontend embeddings when > 0
    d_model: int = 0


class SyntheticLM:
    """Stateless-per-step batch source; ``state`` is just the step index."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed, step))
        B, S, V = cfg.global_batch, cfg.seq_len, cfg.vocab_size
        a = rng.integers(1, min(V - 1, 97), (B, 1))
        b = rng.integers(0, V, (B, 1))
        x0 = rng.integers(0, V, (B, 1))
        toks = np.zeros((B, S + 1), np.int64)
        toks[:, :1] = x0
        for t in range(S):
            toks[:, t + 1] = (a[:, 0] * toks[:, t] + b[:, 0]) % V
        flip = rng.random((B, S + 1)) < cfg.noise
        toks = np.where(flip, rng.integers(0, V, (B, S + 1)), toks)
        batch = {"tokens": toks[:, :-1].astype(np.int32),
                 "labels": toks[:, 1:].astype(np.int32)}
        if cfg.frontend_tokens:
            batch["frontend_embeds"] = rng.standard_normal(
                (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
        return batch

    def iterate(self, start_step: int = 0) -> Iterator[Tuple[int, Dict]]:
        step = start_step
        while True:
            yield step, self.batch_at(step)
            step += 1
