"""Exact integer LayerNorm over int16 rows, and the stepwise LSTM step's
gate pass: CUDA kernel + plain versions.

Port of ``repro.kernels.int_layernorm.int_layernorm_pallas``.  One kernel
(``csrc/int_layernorm.cu``), two entries:

* ``int_layernorm`` -- the TPU kernel's contract: int16 rows (the last
  axis; leading axes are flattened) normalised with one weight, bias and
  output multiplier.  Its plain version is ``integer_layernorm``.  The TPU
  kernel's ``block_rows`` tiling knob has no counterpart.
* ``int_layernorm_gates`` -- the gate pass of one stepwise LSTM step of an
  LN layer: every gate but a peephole o formed from the step's two int32
  accumulators (``ref.lstm_gate_acc``, then sat16) and normalised with its
  own LN, in one launch, into one ``(B, G*H)`` int16 tensor in the packed
  gate order (the peephole o gate's block is 0: the cell finishes it).

CUDA tensors launch the kernel, CPU tensors take the plain versions; there
is no other fallback.  Each row (gate) is split over a thread-block cluster
of CTAs (``csrc/ln_plan.cuh``, read by ``ln_plan``).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..core import fixedpoint as fp
from ..core import integer_ops as iops
from . import build
from . import ref
from .scan_plan import sm_count

SOURCE = "src/repro_torch/csrc/int_layernorm.cu"
REPLACES = "src/repro/kernels/int_layernorm.py:34"
MAX_ROW = 1 << 14  # the exact statistics' limit (``integer_ops.row_stats``)
NO_SCALE = (0,) * 7  # a cell::GateScale that no gate reads

launches = 0  # kernel launches since the last reset (plain calls not counted)


class LNPlan(NamedTuple):
    """A row of n columns over a cluster of ``C`` CTAs of ``threads``
    threads, CTA r owning columns ``[r W, min((r + 1) W, n))``, one a
    thread at a time; ``ctas`` CTAs in all."""
    C: int
    W: int
    threads: int
    smem: int
    ctas: int


def ln_plan(rows: int, G: int, n: int, n_sm: int, slices: int = 1
            ) -> LNPlan:
    """The plan the kernel library exports (``lnp::plan``; ``slices`` int16
    vectors of its columns a CTA keeps: 1 for the gate pass, 2 for the
    cell's LN form); raises ``ValueError`` where it refuses the shape."""
    fn = build.function("int_layernorm", "int_layernorm_plan",
                        [ctypes.c_longlong] + [ctypes.c_int] * 4
                        + [ctypes.c_void_p])
    out = (ctypes.c_longlong * 6)()
    err = fn(rows, G, n, n_sm, slices, ctypes.addressof(out))
    if err:
        raise ValueError(f"int_layernorm: no plan for rows={rows} G={G} "
                         f"n={n} slices={slices} (error {err})")
    return LNPlan(*out[1:])


def gate_scale(spec, g: str) -> Tuple[int, ...]:
    """Gate ``g``'s ``cell::GateScale``: eff_x, eff_h, and eff_c with its
    flag where the gate reads the previous cell state (an i/f peephole)."""
    gs = spec.gate_spec(g)
    has_c = gs.eff_c is not None and g != "o"
    return (*gs.eff_x, *gs.eff_h, *(gs.eff_c if has_c else (0, 0)),
            int(has_c))


def pass_gates(spec) -> Tuple[str, ...]:
    """The gates the gate pass forms and normalises: every gate of an LN
    layer but a peephole o (which the cell finishes on the new state)."""
    if not spec.use_layernorm:
        return ()
    return tuple(g for g in spec.variant.gates
                 if not (g == "o" and spec.use_peephole))


def int_layernorm_plain(q, ln_w_q, ln_b_q, *, out_m0: int, out_shift: int
                        ) -> torch.Tensor:
    """``integer_layernorm`` over the last axis (int16 in, int16 out)."""
    return iops.integer_layernorm(q, ln_w_q, ln_b_q, out_m0, out_shift)


def int_layernorm_gates_plain(arrays: Dict[str, Any], spec,
                              acc_x: torch.Tensor, acc_h: torch.Tensor,
                              c_q: torch.Tensor) -> torch.Tensor:
    """Each gate of ``pass_gates`` as ``ref.lstm_gate_preacts`` forms it:
    ``integer_layernorm(sat16(lstm_gate_acc(...)))`` into its block of a
    ``(B, G*H)`` int16 tensor; the other blocks are 0."""
    H = spec.cfg_d_hidden
    gates = spec.variant.gates
    out = torch.zeros(acc_x.shape[:-1] + (len(gates) * H,),
                      dtype=torch.int16, device=acc_x.device)
    for g in pass_gates(spec):
        k = gates.index(g)
        gate16 = fp.saturate_i16(ref.lstm_gate_acc(arrays, spec, k, g, acc_x,
                                                   acc_h, c_q))
        out[..., k * H:(k + 1) * H] = iops.integer_layernorm(
            gate16, arrays["L"][g], arrays["Lb"][g],
            *spec.gate_spec(g).ln_out)
    return out


def _launch(tensors, ints, dev) -> None:
    build.launch("int_layernorm", tensors, ints,
                 sm_count(dev.index if dev.index is not None
                          else torch.cuda.current_device()), dev)
    global launches
    launches += 1


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
    tensors = [q, None, None, None, None, None, None, None,
               ln_w_q, None, None, None, ln_b_q, None, None, None, out]
    ints = ((rows, 1, n, 1, 0, 0, 0) + NO_SCALE * 4
            + (int(out_m0), int(out_shift)) + (0,) * 6)
    _launch(tensors, ints, dev)
    return out


@functools.lru_cache(maxsize=None)
def _pass_layout(spec):
    """One layer spec's gate pass, worked out once: ``(G, H, [(slot, gate,
    reads P), ...] of the gates it forms, the scalar block after (rows, G,
    n): normalise[4], the gate scales, ln_out[4][2])``."""
    gates = spec.variant.gates
    formed = pass_gates(spec)
    norm, scales, outs, slots = [], [], [], []
    for k in range(4):
        g = gates[k] if k < len(gates) else None
        on = g in formed
        norm.append(int(on))
        scales.extend(gate_scale(spec, g) if on else NO_SCALE)
        outs.extend(spec.gate_spec(g).ln_out if on else (0, 0))
        if on:
            slots.append((k, g, bool(gate_scale(spec, g)[-1])))
    return (len(gates), spec.cfg_d_hidden, tuple(slots),
            (*norm, *scales, *outs))


def int_layernorm_gates(arrays: Dict[str, Any], spec, acc_x: torch.Tensor,
                        acc_h: torch.Tensor, c_q: torch.Tensor
                        ) -> torch.Tensor:
    """The gate pass of one LSTM step of an LN layer: int32 ``(B, G*H)``
    accumulators and the int16 ``(B, H)`` cell state -> int16 ``(B, G*H)``
    normalised gates (``int_layernorm_gates_plain``).  One launch on CUDA
    tensors; CPU tensors take the plain version."""
    if not spec.use_layernorm:
        raise ValueError("the gate pass is for a layer with LayerNorm")
    if acc_x.device.type != "cuda":
        return int_layernorm_gates_plain(arrays, spec, acc_x, acc_h, c_q)
    G, H, slots, ints = _pass_layout(spec)
    B = acc_x.shape[0]
    dev = acc_x.device
    need = build.require
    need(acc_x, "acc_x", torch.int32, (B, G * H), dev)
    need(acc_h, "acc_h", torch.int32, (B, G * H), dev)
    need(c_q, "c_q", torch.int16, (B, H), dev)
    P, Lw, Lb = [None] * 4, [None] * 4, [None] * 4
    for k, g, reads_p in slots:
        Lw[k] = need(arrays["L"][g], f"L[{g}]", torch.int16, (H,), dev)
        Lb[k] = need(arrays["Lb"][g], f"Lb[{g}]", torch.int32, (H,), dev)
        if reads_p:
            P[k] = need(arrays["P"][g], f"P[{g}]", torch.int16, (H,), dev)
    out = torch.empty((B, G * H), dtype=torch.int16, device=dev)
    if B == 0:
        return out
    _launch([None, acc_x, acc_h, c_q, *P, *Lw, *Lb, out],
            (B, G, H) + ints, dev)
    return out
