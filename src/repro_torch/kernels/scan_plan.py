"""The cooperative grid of the sequence kernels (kernel 4).

How one launch splits a layer's hidden units over the card's SMs, and the
shared memory and workspace that takes, is decided once, by ``scan::plan``
in ``csrc/recurrent_scan.cuh``.  Each kernel library exports it
(``quant_lstm_scan_plan``, ``quant_gru_scan_plan``); ``scan_plan`` reads it
there before every launch, so shapes that cannot fit raise here rather
than in the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import build

ERRORS = {1: "shapes the kernel does not take",
          2: "more shared memory than one SM holds (227 KB)"}


class ScanPlan(NamedTuple):
    """CTA n owns units ``[n u, min((n + 1) u, H))`` of ``nb`` CTAs; the
    batch rows pass ``rg`` at a time; ``smem`` bytes of shared memory a
    CTA, ``ws`` bytes of zeroed workspace a launch."""
    u: int
    nb: int
    rg: int
    smem: int
    ws: int


def scan_plan(kernel: str, *shape: int) -> ScanPlan:
    """The plan that library ``kernel`` exports as ``<kernel>_plan`` for
    ``shape`` (its arguments before the output block); raises
    ``ValueError`` where the plan refuses it."""
    fn = build.function(kernel, f"{kernel}_plan",
                        [ctypes.c_int] * len(shape) + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 5)()
    err = fn(*shape, ctypes.addressof(out))
    if err:
        raise ValueError(f"{kernel}: no cooperative grid for {shape}: "
                         f"{ERRORS.get(err, f'plan error {err}')}")
    return ScanPlan(*out)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
