"""Fused integer LSTM cell: CUDA kernel + plain version.

Port of ``repro.kernels.quant_lstm_cell.quant_lstm_cell_pallas``.
``quant_lstm_cell`` launches ``csrc/quant_lstm_cell.cu`` for CUDA tensors
and takes ``quant_lstm_cell_plain`` (``ref.quant_lstm_cell``, with its
``finish_o_gate``) for CPU tensors; there is no other fallback.

The o-gate contract is the TPU kernel's: without a peephole ``o_in`` is
the int16 gate; with one it is the int32 pre-peephole accumulator, which
the cell finishes on ``c_new`` (``p_o``, ``eff_c_o``) and, for an LN
layer, LayerNorms over the whole row (``lw_o``, ``lb_o``, ``ln_out_o``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import build
from . import ref
from .int_layernorm import MAX_ROW

SOURCE = "src/repro_torch/csrc/quant_lstm_cell.cu"
REPLACES = "src/repro/kernels/quant_lstm_cell.py:143"

launches = 0  # kernel launches since the last reset (plain calls not counted)


def quant_lstm_cell_plain(i16, f16, z16, o_in, c_q, **kw
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain cell, ``ref.quant_lstm_cell`` (same keywords)."""
    return ref.quant_lstm_cell(i16, f16, z16, o_in, c_q, **kw)


def _check_contract(o_in, p_o, eff_c_o, ln_out_o) -> None:
    if eff_c_o is not None:
        if p_o is None or o_in.dtype != torch.int32:
            raise ValueError("o-gate peephole fusion takes p_o and the int32 "
                             "pre-peephole accumulator")
    elif ln_out_o is not None:
        raise ValueError("in-fusion o-gate LN requires the peephole")


def quant_lstm_cell(i16: torch.Tensor, f16: torch.Tensor, z16: torch.Tensor,
                    o_in: torch.Tensor, c_q: torch.Tensor, *,
                    cell_int_bits: int, cifg: bool, eff_m: Tuple[int, int],
                    zp_m: int, p_o: Optional[torch.Tensor] = None,
                    eff_c_o: Optional[Tuple[int, int]] = None,
                    lw_o: Optional[torch.Tensor] = None,
                    lb_o: Optional[torch.Tensor] = None,
                    ln_out_o: Optional[Tuple[int, int]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell step on ``(B, H)`` gates -> ``(m int8, c_new int16)``.

    ``i16`` is ignored under CIFG.  CUDA tensors launch the kernel; CPU
    tensors take the plain version.
    """
    _check_contract(o_in, p_o, eff_c_o, ln_out_o)
    if f16.device.type != "cuda":
        return quant_lstm_cell_plain(
            i16, f16, z16, o_in, c_q, cell_int_bits=cell_int_bits, cifg=cifg,
            eff_m=eff_m, zp_m=zp_m, p_o=p_o, eff_c_o=eff_c_o, lw_o=lw_o,
            lb_o=lb_o, ln_out_o=ln_out_o)
    B, H = f16.shape
    dev = f16.device
    need = build.require
    ln = ln_out_o is not None
    if ln and H > MAX_ROW:
        raise ValueError(f"integer norm supports rows up to {MAX_ROW}, got {H}")
    if not cifg:
        need(i16, "i16", torch.int16, (B, H), dev)
    need(f16, "f16", torch.int16, (B, H), dev)
    need(z16, "z16", torch.int16, (B, H), dev)
    need(o_in, "o_in", torch.int32 if eff_c_o is not None else torch.int16,
         (B, H), dev)
    need(c_q, "c_q", torch.int16, (B, H), dev)
    if eff_c_o is not None:
        need(p_o, "p_o", torch.int16, (H,), dev)
    if ln:
        need(lw_o, "lw_o", torch.int16, (H,), dev)
        need(lb_o, "lb_o", torch.int32, (H,), dev)
    m_out = torch.empty((B, H), dtype=torch.int8, device=dev)
    c_out = torch.empty((B, H), dtype=torch.int16, device=dev)
    if B == 0 or H == 0:
        return m_out, c_out
    tensors = [None if cifg else i16, f16, z16, o_in, c_q,
               p_o if eff_c_o is not None else None, lw_o if ln else None,
               lb_o if ln else None, m_out, c_out]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    vals = (B, H, int(cifg), cell_int_bits, int(eff_c_o is not None), int(ln),
            *(eff_c_o or (0, 0)), *(ln_out_o or (0, 0)), *eff_m, zp_m)
    ints = (ctypes.c_int32 * len(vals))(*vals)
    fn = build.load("quant_lstm_cell").quant_lstm_cell_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(ints), stream)
    build.check(err, "quant_lstm_cell")
    global launches
    launches += 1
    return m_out, c_out
