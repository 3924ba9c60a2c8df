"""int8 x int8 -> int32 GEMM with fused requantize: CUDA kernel + plain version.

Port of ``repro.kernels.int8_matmul.int8_matmul_pallas``.  ``int8_matmul``
launches ``csrc/int8_matmul.cu`` for CUDA tensors and takes
``int8_matmul_plain`` for CPU tensors; there is no other fallback.  Unlike
the TPU kernel it takes ragged M, N and K (masked inside the kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ..core import fixedpoint as fp
from ..core import integer_ops as iops
from . import build

SOURCE = "src/repro_torch/csrc/int8_matmul.cu"
REPLACES = "src/repro/kernels/int8_matmul.py:76"

launches = 0  # kernel launches since the last reset (plain calls not counted)

_OUT_KIND = {torch.int32: 0, torch.int8: 1, torch.int16: 2}


def int8_matmul_plain(x_q, w_q, fold, m0=None, shift=None, *,
                      out_dtype=torch.int32, zp_out: int = 0) -> torch.Tensor:
    """``x_q @ w_q + fold``, then int32 out, or per-channel MBQM(m0, shift)
    + zp_out clipped to int8/int16 (``repro.kernels.ref.int8_matmul_jnp``)."""
    acc = fp._wrap32(iops.matmul_i8_i32(x_q, w_q).to(torch.int64)
                     + fold.to(torch.int64))
    if out_dtype == torch.int32:
        return acc.to(torch.int32)
    y = fp._wrap32(fp._mbqm64(acc, m0.to(torch.int64), shift.to(torch.int64))
                   + zp_out)
    info = torch.iinfo(out_dtype)
    return y.clamp(info.min, info.max).to(out_dtype)


def int8_matmul(x_q: torch.Tensor, w_q: torch.Tensor, fold: torch.Tensor,
                m0: Optional[torch.Tensor] = None,
                shift: Optional[torch.Tensor] = None, *,
                out_dtype=torch.int32, zp_out: int = 0) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 + fold (N,) int32 -> (M, N) ``out_dtype``.

    For int8/int16 outputs, ``m0``/``shift`` (N,) int32 give the per-channel
    rescale.  CUDA tensors launch the kernel; CPU tensors take the plain
    version.
    """
    if out_dtype not in _OUT_KIND:
        raise ValueError(f"out_dtype must be int32, int8 or int16, got "
                         f"{out_dtype}")
    if out_dtype != torch.int32 and (m0 is None or shift is None):
        raise ValueError("an int8/int16 output needs m0 and shift")
    if x_q.device.type != "cuda":
        return int8_matmul_plain(x_q, w_q, fold, m0, shift,
                                 out_dtype=out_dtype, zp_out=zp_out)
    M, K = x_q.shape
    N = w_q.shape[1]
    dev = x_q.device
    build.require(x_q, "x_q", torch.int8, (M, K), dev)
    build.require(w_q, "w_q", torch.int8, (K, N), dev)
    build.require(fold, "fold", torch.int32, (N,), dev)
    if out_dtype != torch.int32:
        build.require(m0, "m0", torch.int32, (N,), dev)
        build.require(shift, "shift", torch.int32, (N,), dev)
    out = torch.empty((M, N), dtype=out_dtype, device=dev)
    if M == 0 or N == 0:
        return out
    lib = build.load("int8_matmul")
    fn = lib.int8_matmul_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def ptr(t):
        return None if t is None or out_dtype == torch.int32 else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), fold.data_ptr(), ptr(m0),
                 ptr(shift), out.data_ptr(), M, N, K, _OUT_KIND[out_dtype],
                 int(zp_out), stream)
    build.check(err, "int8_matmul")
    global launches
    launches += 1
    return out
