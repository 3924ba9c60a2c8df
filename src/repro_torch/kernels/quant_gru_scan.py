"""Cooperative integer GRU sequence kernel: the CUDA launch.

Port of the GRU form of ``repro.kernels.quant_lstm_scan.
quant_recurrent_seq_scan_pallas``: the recurrent stage of a whole GRU
sequence in ONE launch per layer, the time loop inside the kernel
(``csrc/quant_gru_scan.cu``), on the cooperative grid that ``scan_plan``
reads from the library.  ``quant_lstm_scan.quant_recurrent_seq_scan``
dispatches a CUDA GRU layer here; its plain version is the cell-generic
``quant_lstm_scan.quant_recurrent_seq_scan_plain``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, Optional, Tuple

import torch

from . import build
from .scan_plan import scan_plan, sm_count

SOURCE = "src/repro_torch/csrc/quant_gru_scan.cu"
REPLACES = "src/repro/kernels/quant_lstm_scan.py:108"

launches = 0  # kernel launches since the last reset (plain calls not counted)


@functools.lru_cache(maxsize=None)
def _spec_ints(spec) -> Tuple[int, ...]:
    """The kernel's scalar block for one GRU layer spec (T filled per
    call); gate slots follow ``spec.gate_names``."""
    gates = spec.gate_names
    pairs = {"eff_x": [], "eff_h": [], "ln_out": []}
    for g in gates:
        gs = spec.gate_spec(g)
        for name, vals in pairs.items():
            vals.extend(getattr(gs, name) or (0, 0))
    return (spec.cfg_d_hidden, int(spec.use_layernorm), gates.index("r"),
            gates.index("u"), gates.index("n"), *pairs["eff_x"],
            *pairs["eff_h"], *pairs["ln_out"], *spec.eff_carry, *spec.eff_n,
            spec.zp_h, spec.zp_h_out)


def quant_gru_seq_scan(
    arrays: Dict[str, Any], spec, acc_x_all: torch.Tensor,
    state0: Tuple[torch.Tensor, ...], valid_len: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Tuple[torch.Tensor]]:
    """Launch the GRU sequence kernel on CUDA tensors (raises otherwise).

    ``acc_x_all`` is the hoisted int32 ``(B, T, 3H)`` input accumulator,
    ``state0`` the ``(h,)`` carry.  Returns ``(ys, (h_final,))``.
    """
    B, T, _ = acc_x_all.shape
    H = spec.cfg_d_hidden
    dev = acc_x_all.device
    if dev.type != "cuda":
        raise ValueError(f"the GRU sequence kernel runs on CUDA tensors, "
                         f"got {dev}")
    if len(spec.gate_names) != 3:
        raise ValueError(f"a GRU layer has 3 gates, got {spec.gate_names}")
    need = build.require
    need(acc_x_all, "acc_x_all", torch.int32, (B, T, 3 * H), dev)
    h0 = need(state0[0], "h0", torch.int8, (B, H), dev)
    R = need(arrays["R_cat"], "R_cat", torch.int8, (H, 3 * H), dev)
    fold_hb = need(arrays["fold_hb_cat"], "fold_hb_cat", torch.int32,
                   (3 * H,), dev)
    L = [None] * 3
    Lb = [None] * 3
    if spec.use_layernorm:
        for k, g in enumerate(spec.gate_names):
            L[k] = need(arrays["L"][g], f"L[{g}]", torch.int16, (H,), dev)
            Lb[k] = need(arrays["Lb"][g], f"Lb[{g}]", torch.int32, (H,), dev)
    if valid_len is not None:
        valid_len = need(valid_len, "valid_len", torch.int32, (B,), dev)
    ys = torch.empty((B, T, H), dtype=torch.int8, device=dev)
    h_out = torch.empty((B, H), dtype=torch.int8, device=dev)
    if B == 0 or T == 0:
        return ys, (h0.clone(),)
    n_sm = sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    plan = scan_plan("quant_gru_scan", H, B, n_sm)
    ws = torch.zeros(plan.ws, dtype=torch.uint8, device=dev)

    tensors = [acc_x_all, R, fold_hb, *L, *Lb, h0, valid_len, ys, h_out, ws]
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    vals = (T,) + _spec_ints(spec)
    ints = (ctypes.c_int32 * len(vals))(*vals)
    fn = build.function("quant_gru_scan", "quant_gru_scan_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(ints), B, n_sm,
                 stream)
    build.check(err, "quant_gru_scan")
    global launches
    launches += 1
    return ys, (h_out,)
