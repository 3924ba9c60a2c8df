"""Exact integer LayerNorm over int16 rows: CUDA kernel + plain version.

Port of ``repro.kernels.int_layernorm.int_layernorm_pallas``.
``int_layernorm`` launches ``csrc/int_layernorm.cu`` (one thread block per
row) for CUDA tensors and takes ``int_layernorm_plain`` for CPU tensors;
there is no other fallback.  Rows are the last axis; leading axes are
flattened.  The TPU kernel's ``block_rows`` tiling knob has no counterpart.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import integer_ops as iops
from . import build

SOURCE = "src/repro_torch/csrc/int_layernorm.cu"
REPLACES = "src/repro/kernels/int_layernorm.py:34"
MAX_ROW = 1 << 14  # the exact statistics' limit (``integer_ops.row_stats``)

launches = 0  # kernel launches since the last reset (plain calls not counted)


def int_layernorm_plain(q, ln_w_q, ln_b_q, *, out_m0: int, out_shift: int
                        ) -> torch.Tensor:
    """``integer_layernorm`` over the last axis (int16 in, int16 out)."""
    return iops.integer_layernorm(q, ln_w_q, ln_b_q, out_m0, out_shift)


def int_layernorm(q: torch.Tensor, ln_w_q: torch.Tensor, ln_b_q: torch.Tensor,
                  *, out_m0: int, out_shift: int) -> torch.Tensor:
    """int16 ``(..., n)`` rows, int16 ``(n,)`` weights, int32 ``(n,)`` bias
    -> int16 ``(..., n)``.  CUDA tensors launch the kernel; CPU tensors take
    the plain version."""
    n = q.shape[-1]
    if n > MAX_ROW:
        raise ValueError(f"integer norm supports rows up to {MAX_ROW}, got {n}")
    if q.device.type != "cuda":
        return int_layernorm_plain(q, ln_w_q, ln_b_q, out_m0=out_m0,
                                   out_shift=out_shift)
    dev = q.device
    rows = q.numel() // n if n else 0
    build.require(q, "q", torch.int16, q.shape, dev)
    build.require(ln_w_q, "ln_w_q", torch.int16, (n,), dev)
    build.require(ln_b_q, "ln_b_q", torch.int32, (n,), dev)
    out = torch.empty_like(q)
    if rows == 0 or n == 0:
        return out
    fn = build.load("int_layernorm").int_layernorm_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), ln_w_q.data_ptr(), ln_b_q.data_ptr(),
                 out.data_ptr(), rows, n, int(out_m0), int(out_shift), stream)
    build.check(err, "int_layernorm")
    global launches
    launches += 1
    return out
