"""Fused integer LSTM cell: CUDA kernel + plain versions.

Port of ``repro.kernels.quant_lstm_cell.quant_lstm_cell_pallas``.  One
kernel (``csrc/quant_lstm_cell.cu``), two entries:

* ``quant_lstm_cell`` -- the TPU kernel's contract: the int16 gates and
  cell state given.  Without a peephole ``o_in`` is the int16 gate; with one
  it is the int32 pre-peephole accumulator, which the cell finishes on
  ``c_new`` (``p_o``, ``eff_c_o``) and, for an LN layer, LayerNorms over the
  whole row (``lw_o``, ``lb_o``, ``ln_out_o``).  Plain version:
  ``ref.quant_lstm_cell`` with its ``finish_o_gate``.
* ``quant_lstm_cell_step`` -- the cell of one stepwise LSTM step: it reads
  the step's two int32 ``(B, G*H)`` accumulators and forms every gate the
  gate pass (``int_layernorm_gates``) did not give it -- all gates of a
  layer without LN, the peephole o gate's accumulator -- then runs the same
  cell.  Plain version: ``quant_lstm_cell_step_plain``.

CUDA tensors launch the kernel, CPU tensors take the plain versions; there
is no other fallback.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from ..core import fixedpoint as fp
from . import build
from . import ref
from .int_layernorm import MAX_ROW, NO_SCALE, gate_scale, pass_gates
from .scan_plan import sm_count

SOURCE = "src/repro_torch/csrc/quant_lstm_cell.cu"
REPLACES = "src/repro/kernels/quant_lstm_cell.py:143"
ROLES = ("i", "f", "z", "o")  # the kernel's gate roles, in its order

launches = 0  # kernel launches since the last reset (plain calls not counted)


def quant_lstm_cell_plain(i16, f16, z16, o_in, c_q, **kw
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain cell, ``ref.quant_lstm_cell`` (same keywords)."""
    return ref.quant_lstm_cell(i16, f16, z16, o_in, c_q, **kw)


def quant_lstm_cell_step_plain(arrays: Dict[str, Any], spec,
                               acc_x: torch.Tensor, acc_h: torch.Tensor,
                               c_q: torch.Tensor,
                               gates16: Optional[torch.Tensor] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell of one LSTM step from the packed accumulators: a gate of
    ``pass_gates`` is read from its block of ``gates16`` (the gate pass's
    output, required for an LN layer), any other is
    ``sat16(ref.lstm_gate_acc(...))`` (the peephole o its int32
    accumulator); then ``ref.quant_lstm_cell``."""
    if spec.use_layernorm and gates16 is None:
        raise ValueError("an LN layer's cell takes the gate pass's output")
    H = spec.cfg_d_hidden
    gates = spec.variant.gates
    given = pass_gates(spec)

    def gate(g):
        k = gates.index(g)
        if g in given:
            return gates16[..., k * H:(k + 1) * H]
        acc = ref.lstm_gate_acc(arrays, spec, k, g, acc_x, acc_h, c_q)
        return acc if g == "o" and spec.use_peephole else fp.saturate_i16(acc)

    f16 = gate("f")
    i16 = f16 if spec.use_cifg else gate("i")  # ignored under CIFG
    return ref.quant_lstm_cell(
        i16, f16, gate("z"), gate("o"), c_q, cell_int_bits=spec.cell_int_bits,
        cifg=spec.use_cifg, eff_m=spec.eff_m, zp_m=spec.zp_m,
        **ref.o_finisher_kw(arrays, spec))


def _check_contract(o_in, p_o, eff_c_o, ln_out_o) -> None:
    if eff_c_o is not None:
        if p_o is None or o_in.dtype != torch.int32:
            raise ValueError("o-gate peephole fusion takes p_o and the int32 "
                             "pre-peephole accumulator")
    elif ln_out_o is not None:
        raise ValueError("in-fusion o-gate LN requires the peephole")


def _launch(tensors, ints, dev) -> None:
    build.launch("quant_lstm_cell", tensors, ints,
                 sm_count(dev.index if dev.index is not None
                          else torch.cuda.current_device()), dev)
    global launches
    launches += 1


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
    peephole = eff_c_o is not None
    if ln and H > MAX_ROW:
        raise ValueError(f"integer norm supports rows up to {MAX_ROW}, got {H}")
    if not cifg:
        need(i16, "i16", torch.int16, (B, H), dev)
    need(f16, "f16", torch.int16, (B, H), dev)
    need(z16, "z16", torch.int16, (B, H), dev)
    need(o_in, "o_in", torch.int32 if peephole else torch.int16, (B, H), dev)
    need(c_q, "c_q", torch.int16, (B, H), dev)
    if peephole:
        need(p_o, "p_o", torch.int16, (H,), dev)
    if ln:
        need(lw_o, "lw_o", torch.int16, (H,), dev)
        need(lb_o, "lb_o", torch.int32, (H,), dev)
    m_out = torch.empty((B, H), dtype=torch.int8, device=dev)
    c_out = torch.empty((B, H), dtype=torch.int16, device=dev)
    if B == 0 or H == 0:
        return m_out, c_out
    tensors = [None if cifg else i16, f16, z16, None if peephole else o_in,
               o_in if peephole else None, None, None, None, None, None,
               None, c_q, p_o if peephole else None, lw_o if ln else None,
               lb_o if ln else None, m_out, c_out]
    ints = ((B, H, 1, int(cifg), cell_int_bits, int(peephole), int(ln))
            + (H,) * 4 + (0,) * 4 + NO_SCALE * 4
            + (*(eff_c_o or (0, 0)), *(ln_out_o or (0, 0)), *eff_m, zp_m))
    _launch(tensors, ints, dev)
    return m_out, c_out


@functools.lru_cache(maxsize=None)
def _step_layout(spec):
    """One layer spec's step entry, worked out once: ``(G, H, ln, roles,
    the scalar block)``.  ``roles`` lists ``(role, gate, slot, given,
    reads P)`` for each gate of the layer; the block is (B, H, G, cifg,
    cell_int_bits, peephole, ln) with B 0, then ld16[4] (by role), slot[4], the gate scales, eff_c_o, ln_out_o,
    eff_m, zp_m."""
    gates = spec.variant.gates
    given = pass_gates(spec)
    H, G = spec.cfg_d_hidden, len(gates)
    ln = spec.use_peephole and spec.use_layernorm
    lds, slots, scales, roles = [], [], [], []
    for r, g in enumerate(ROLES):
        formed = g in gates and g not in given
        lds.append(G * H if g in given else 0)
        slots.append(gates.index(g) if g in gates else 0)
        scales.extend(gate_scale(spec, g) if formed else NO_SCALE)
        if g in gates:
            roles.append((r, g, gates.index(g), g in given,
                          formed and bool(gate_scale(spec, g)[-1])))
    o = spec.gate_spec("o")
    ints = ((0, H, G, int(spec.use_cifg), spec.cell_int_bits,
             int(spec.use_peephole), int(ln))
            + (*lds, *slots, *scales,
               *(o.eff_c if spec.use_peephole else (0, 0)),
               *(o.ln_out if ln else (0, 0)), *spec.eff_m, spec.zp_m))
    return G, H, ln, tuple(roles), ints


def quant_lstm_cell_step(arrays: Dict[str, Any], spec, acc_x: torch.Tensor,
                         acc_h: torch.Tensor, c_q: torch.Tensor,
                         gates16: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cell of one LSTM step: int32 ``(B, G*H)`` accumulators, the int16
    ``(B, H)`` cell state and, for an LN layer, the gate pass's int16
    ``(B, G*H)`` output -> ``(m int8, c_new int16)``
    (``quant_lstm_cell_step_plain``).  One launch on CUDA tensors; CPU
    tensors take the plain version."""
    if acc_x.device.type != "cuda":
        return quant_lstm_cell_step_plain(arrays, spec, acc_x, acc_h, c_q,
                                          gates16)
    if spec.use_layernorm and gates16 is None:
        raise ValueError("an LN layer's cell takes the gate pass's output")
    G, H, ln, roles, ints = _step_layout(spec)
    B = acc_x.shape[0]
    dev = acc_x.device
    need = build.require
    if ln and H > MAX_ROW:
        raise ValueError(f"integer norm supports rows up to {MAX_ROW}, got {H}")
    need(acc_x, "acc_x", torch.int32, (B, G * H), dev)
    need(acc_h, "acc_h", torch.int32, (B, G * H), dev)
    need(c_q, "c_q", torch.int16, (B, H), dev)
    if spec.use_layernorm:
        need(gates16, "gates16", torch.int16, (B, G * H), dev)
    g16, P = [None] * 4, [None] * 4
    for r, g, slot, given, reads_p in roles:
        if given:
            g16[r] = gates16[:, slot * H:]  # row stride G*H
        elif reads_p:
            P[r] = need(arrays["P"][g], f"P[{g}]", torch.int16, (H,), dev)
    p_o = lw_o = lb_o = None
    if spec.use_peephole:
        p_o = need(arrays["P"]["o"], "P[o]", torch.int16, (H,), dev)
    if ln:
        lw_o = need(arrays["L"]["o"], "L[o]", torch.int16, (H,), dev)
        lb_o = need(arrays["Lb"]["o"], "Lb[o]", torch.int32, (H,), dev)
    m_out = torch.empty((B, H), dtype=torch.int8, device=dev)
    c_out = torch.empty((B, H), dtype=torch.int16, device=dev)
    if B == 0:
        return m_out, c_out
    _launch([*g16, None, acc_x, acc_h, *P, c_q, p_o, lw_o, lb_o, m_out,
             c_out], (B,) + ints[1:], dev)
    return m_out, c_out
