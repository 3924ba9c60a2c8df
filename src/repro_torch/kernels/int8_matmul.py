"""int8 x int8 -> int32 GEMM with fused requantize: CUDA kernel + plain version.

Port of ``repro.kernels.int8_matmul.int8_matmul_pallas``.  ``int8_matmul``
launches ``csrc/int8_matmul.cu`` for CUDA tensors and takes
``int8_matmul_plain`` for CPU tensors; there is no other fallback.  Unlike
the TPU kernel it takes ragged M, N and K (masked inside the kernel).

How a launch is laid out (the weight-streaming form for M <= 32, the
tensor-core form above; tiles, split of K, ring, shared memory) is decided
once, by ``gemm::plan`` in ``csrc/gemm_plan.cuh``; the library exports it
as ``int8_matmul_plan`` and ``gemm_plan`` reads it there, so a shape the
kernel cannot take raises here.
"""
from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from ..core import fixedpoint as fp
from ..core import integer_ops as iops
from . import build
from .scan_plan import sm_count

SOURCE = "src/repro_torch/csrc/int8_matmul.cu"
REPLACES = "src/repro/kernels/int8_matmul.py:76"

launches = 0  # kernel launches since the last reset (plain calls not counted)
# the same launches by (M, K, N, out dtype name); cleared with `launches`
# by ``launch.serve.reset_launch_counts``
launches_by_shape: collections.Counter = collections.Counter()

_OUT_KIND = {torch.int32: 0, torch.int8: 1, torch.int16: 2}


class GemmPlan(NamedTuple):
    """``form`` 0 weight-streaming, 1 tensor-core; output tiles of ``bm`` x
    ``bn`` on ``threads`` threads, a grid of ``split`` x ``tiles_m`` x
    ``tiles_n`` CTAs (the ``split`` CTAs of a tile share K's ``steps`` of
    64 and form one cluster), a ring of ``stages`` slabs, ``smem`` bytes of
    shared memory a CTA."""
    form: int
    bm: int
    bn: int
    threads: int
    tiles_m: int
    tiles_n: int
    split: int
    steps: int
    stages: int
    smem: int


PLAN_ERRORS = {1: "shapes the kernel does not take",
               2: "more shared memory than one SM holds (227 KB)"}


@functools.lru_cache(maxsize=None)
def gemm_plan(M: int, N: int, K: int, n_sm: int) -> GemmPlan:
    """The plan the kernel library exports for (M, N, K) on ``n_sm`` SMs;
    raises ``ValueError`` where it refuses the shape."""
    fn = build.function("int8_matmul", "int8_matmul_plan",
                        [ctypes.c_int] * 4 + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 10)()
    err = fn(M, N, K, n_sm, ctypes.addressof(out))
    if err:
        raise ValueError(f"int8_matmul: no plan for M={M} N={N} K={K}: "
                         f"{PLAN_ERRORS.get(err, f'plan error {err}')}")
    return GemmPlan(*out)


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
    n_sm = sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    gemm_plan(M, N, K, n_sm)  # raises where the kernel cannot take the shape
    fn = build.function("int8_matmul", "int8_matmul_launch",
                        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                        + [ctypes.c_void_p])

    def ptr(t):
        return None if t is None or out_dtype == torch.int32 else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x_q.data_ptr(), w_q.data_ptr(), fold.data_ptr(), ptr(m0),
                 ptr(shift), out.data_ptr(), M, N, K, _OUT_KIND[out_dtype],
                 int(zp_out), n_sm, stream)
    build.check(err, "int8_matmul")
    global launches
    launches += 1
    launches_by_shape[(M, K, N, str(out_dtype).removeprefix("torch."))] += 1
    return out
