"""Cooperative integer sequence kernels: CUDA dispatch + plain version.

Port of ``repro.kernels.quant_lstm_scan.quant_recurrent_seq_scan_pallas``:
the recurrent stage of a whole sequence in ONE launch per layer, the time
loop inside the kernel.  CUDA tensors launch the kernel of the layer's
cell: ``csrc/quant_lstm_scan.cu`` (here) for an LSTM,
``csrc/quant_gru_scan.cu`` (``quant_gru_scan``) for a GRU.  Each launch is
one cooperative grid whose CTAs split the layer's hidden units and hold
their slice of the recurrent weights in shared memory for the whole
sequence (``scan_plan``).  CPU tensors take
``quant_recurrent_seq_scan_plain``, a Python loop over
``ref.recurrent_step``.  The masked form (``valid_len``) freezes row b for
t >= valid_len[b] and still emits its unchanged h at ys[b, t].
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import build
from . import quant_gru_scan
from . import ref
from .scan_plan import scan_plan, sm_count

SOURCE = "src/repro_torch/csrc/quant_lstm_scan.cu"
REPLACES = "src/repro/kernels/quant_lstm_scan.py:108"

launches = 0  # kernel launches since the last reset (plain calls not counted)

def quant_recurrent_seq_scan_plain(
    arrays: Dict[str, Any], spec, acc_x_all: torch.Tensor,
    state0: Tuple[torch.Tensor, ...], valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Plain version: ``ref.recurrent_step`` per timestep, rows past their
    ``valid_len`` frozen.  Returns ``(ys int8 (B, T, d_out), state)``."""
    state = tuple(state0)
    ys = []
    for t in range(acc_x_all.shape[1]):
        new = ref.recurrent_step(arrays, spec, acc_x_all[:, t], state)
        if valid_len is not None:
            live = (valid_len > t)[:, None]
            new = tuple(torch.where(live, n, o) for n, o in zip(new, state))
        state = new
        ys.append(state[0])
    return torch.stack(ys, dim=1), state


@functools.lru_cache(maxsize=None)
def _spec_ints(spec) -> Tuple[int, ...]:
    """The kernel's scalar block for one layer spec (T filled per call)."""
    gates = spec.variant.gates
    slot = {g: (gates.index(g) if g in gates else -1) for g in "ifzo"}
    pairs = {"eff_x": [], "eff_h": [], "eff_c": [], "ln_out": []}
    for k in range(4):
        gs = spec.gate_spec(gates[k]) if k < len(gates) else None
        for name, vals in pairs.items():
            vals.extend((getattr(gs, name) or (0, 0)) if gs else (0, 0))
    return (
        spec.cfg_d_hidden, spec.d_out, len(gates), int(spec.use_layernorm),
        int(spec.use_projection), int(spec.use_peephole), int(spec.use_cifg),
        slot["i"], slot["f"], slot["z"], slot["o"],
        *pairs["eff_x"], *pairs["eff_h"], *pairs["eff_c"], *pairs["ln_out"],
        *spec.eff_m, *(spec.eff_proj or (0, 0)), spec.zp_m, spec.zp_h_out,
        spec.cell_int_bits)


def quant_recurrent_seq_scan(
    arrays: Dict[str, Any], spec, acc_x_all: torch.Tensor,
    state0: Tuple[torch.Tensor, ...], valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Run the recurrent stage for a whole sequence.

    ``acc_x_all`` is the hoisted int32 ``(B, T, G*H)`` input accumulator,
    ``state0`` the cell's state tuple.  Returns ``(ys, state_final)``.
    """
    if acc_x_all.device.type != "cuda":
        return quant_recurrent_seq_scan_plain(arrays, spec, acc_x_all, state0,
                                              valid_len)
    cell = getattr(spec, "cell", "lstm")
    if cell == "gru":
        return quant_gru_scan.quant_gru_seq_scan(arrays, spec, acc_x_all,
                                                 state0, valid_len)
    if cell != "lstm":
        raise NotImplementedError(f"no CUDA sequence kernel for cell {cell!r}")
    B, T, GH = acc_x_all.shape
    H, d_out = spec.cfg_d_hidden, spec.d_out
    gates = spec.variant.gates
    G = len(gates)
    dev = acc_x_all.device
    need = build.require
    need(acc_x_all, "acc_x_all", torch.int32, (B, T, G * H), dev)
    h0 = need(state0[0], "h0", torch.int8, (B, d_out), dev)
    c0 = need(state0[1], "c0", torch.int16, (B, H), dev)
    R = need(arrays["R_cat"], "R_cat", torch.int8, (d_out, G * H), dev)
    fold_hb = need(arrays["fold_hb_cat"], "fold_hb_cat", torch.int32,
                   (G * H,), dev)
    per_gate = {"P": [None] * 4, "L": [None] * 4, "Lb": [None] * 4}
    dtypes = {"P": torch.int16, "L": torch.int16, "Lb": torch.int32}
    for key, slots in per_gate.items():
        for k, g in enumerate(gates):
            if g in arrays.get(key, {}):
                slots[k] = need(arrays[key][g], f"{key}[{g}]", dtypes[key],
                                (H,), dev)
    W_proj = fold_proj = None
    if spec.use_projection:
        W_proj = need(arrays["W_proj"], "W_proj", torch.int8, (H, d_out), dev)
        fold_proj = need(arrays["fold_proj"], "fold_proj", torch.int32,
                         (d_out,), dev)
    if valid_len is not None:
        valid_len = need(valid_len, "valid_len", torch.int32, (B,), dev)
    ys = torch.empty((B, T, d_out), dtype=torch.int8, device=dev)
    h_out = torch.empty((B, d_out), dtype=torch.int8, device=dev)
    c_out = torch.empty((B, H), dtype=torch.int16, device=dev)
    if B == 0 or T == 0:
        return ys, (h0.clone(), c0.clone())
    n_sm = sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    plan = scan_plan("quant_lstm_scan", H, d_out, G, B,
                     int(spec.use_projection), n_sm)
    ws = torch.zeros(plan.ws, dtype=torch.uint8, device=dev)

    tensors = [acc_x_all, R, fold_hb, *per_gate["P"], *per_gate["L"],
               *per_gate["Lb"], W_proj, fold_proj, h0, c0, valid_len, ys,
               h_out, c_out, ws]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    vals = (T,) + _spec_ints(spec)
    ints = (ctypes.c_int32 * len(vals))(*vals)
    fn = build.function("quant_lstm_scan", "quant_lstm_scan_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(ints), B, n_sm,
                 stream)
    build.check(err, "quant_lstm_scan")
    global launches
    launches += 1
    return ys, (h_out, c_out)
