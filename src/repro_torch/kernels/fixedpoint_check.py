"""Check of the kernels' fixed-point header against the PyTorch port.

``csrc/fixedpoint.cuh`` holds the gemmlowp arithmetic both CUDA kernels
use; the kernels reach it only through the values their data produces.
This module builds inputs that cover it (every int16 input of tanh_q15 and
sigmoid_q15 for each ``integer_bits``, edge variances for the LayerNorm
rsqrt multiplier, random and edge MBQM triples), evaluates them with
``core/fixedpoint.py`` (``expected``) and with the header's device
functions (``on_card``, ``csrc/fixedpoint_check.cu``).  No serving path
calls it; ``chip_smoke.py`` and the tests do.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from ..core import fixedpoint as fp
from . import build

INTEGER_BITS = tuple(range(16))
RSQRT_EXTRA_POW2 = 10  # as the sequence kernel's LayerNorm calls it


def cases(seed: int = 0) -> Dict[str, np.ndarray]:
    """Inputs: ``bits`` int32, ``v`` int64 >= 0, ``x``/``m0``/``shift`` int32."""
    rng = np.random.default_rng(seed)
    pows = [(1 << k) + d for k in range(1, 63) for d in (-1, 0, 1)]
    v = np.concatenate([
        np.array([0, 1, 2, 3] + pows, np.int64),
        rng.integers(0, 1 << 58, 4096, dtype=np.int64),
        rng.integers(0, 1 << 40, 4096, dtype=np.int64)])
    i32 = np.iinfo(np.int32)
    edges = np.array([i32.min, i32.max, 0, 1, -1, 1 << 30, -(1 << 30)],
                     np.int64)
    n = 1 << 16
    x = np.concatenate([np.repeat(edges, len(edges) * 3),
                        rng.integers(i32.min, i32.max, n, dtype=np.int64,
                                     endpoint=True)])
    m0 = np.concatenate([np.tile(np.repeat(edges, 3), len(edges)),
                         rng.integers(i32.min, i32.max, n, dtype=np.int64,
                                      endpoint=True)])
    shift = np.concatenate([np.tile([-40, 0, 40], len(edges) ** 2),
                            rng.integers(-40, 41, n, dtype=np.int64)])
    return {"bits": np.array(INTEGER_BITS, np.int32), "v": v,
            "x": x.astype(np.int32), "m0": m0.astype(np.int32),
            "shift": shift.astype(np.int32)}


def expected(c: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The PyTorch port's results for ``cases`` on ``device``."""
    q = torch.arange(-32768, 32768, dtype=torch.int32, device=device)
    m0, shift = fp.integer_rsqrt_multiplier(
        torch.from_numpy(c["v"]).to(device), RSQRT_EXTRA_POW2)
    x, mm, sh = (torch.from_numpy(c[k]).to(device) for k in ("x", "m0",
                                                               "shift"))
    return {
        "tanh": torch.stack([fp.tanh_q15(q, int(b)) for b in c["bits"]]),
        "sigmoid": torch.stack([fp.sigmoid_q15(q, int(b)) for b in c["bits"]]),
        "rsqrt_m0": m0, "rsqrt_shift": shift,
        "mbqm": fp.multiply_by_quantized_multiplier(x, mm, sh)}


def on_card(c: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """The header's device functions on ``cases`` (one launch of each)."""
    if torch.device(device).type != "cuda":
        raise ValueError("the header's device check needs a CUDA device")
    t = {k: torch.from_numpy(a).to(device) for k, a in c.items()}
    nb, nv, nm = len(c["bits"]), len(c["v"]), len(c["x"])
    out = {
        "tanh": torch.empty((nb, 65536), dtype=torch.int16, device=device),
        "sigmoid": torch.empty((nb, 65536), dtype=torch.int16, device=device),
        "rsqrt_m0": torch.empty(nv, dtype=torch.int32, device=device),
        "rsqrt_shift": torch.empty(nv, dtype=torch.int32, device=device),
        "mbqm": torch.empty(nm, dtype=torch.int32, device=device)}
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = build.function("fixedpoint_check", "fixedpoint_check_launch",
                        [p, i, p, p, p, i, i, p, p, p, p, p, i, p, p])
    with torch.cuda.device(device):
        err = fn(t["bits"].data_ptr(), nb, out["tanh"].data_ptr(),
                 out["sigmoid"].data_ptr(), t["v"].data_ptr(), nv,
                 RSQRT_EXTRA_POW2, out["rsqrt_m0"].data_ptr(),
                 out["rsqrt_shift"].data_ptr(), t["x"].data_ptr(),
                 t["m0"].data_ptr(), t["shift"].data_ptr(), nm,
                 out["mbqm"].data_ptr(),
                 torch.cuda.current_stream(device).cuda_stream)
    build.check(err, "fixedpoint_check")
    return out
