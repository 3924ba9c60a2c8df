"""The cases on which the cell and LayerNorm kernels are held against
their plain versions, one list for ``chip_smoke.py`` and the ``gpu`` tests.

Every case is ``(label, kwargs)``; ``kwargs`` call the kernel's wrapper and
its plain version alike (the step entries: ``int_layernorm_gates`` and
``quant_lstm_cell_step``).  Inputs are drawn from a ``torch.Generator`` on
the device under test.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..core import fixedpoint as fp

Case = Tuple[str, Dict[str, Any]]

CELL_SHAPES = ((8, 256), (16, 1024), (4, 2048))  # (B, H), as the reference's kernel tests
# (B, H) of the step entries: the reference's kernel tests, a width that no
# vector or slice divides, and the longest LN row at two rows
STEP_SHAPES = CELL_SHAPES + ((4, 1001), (2, 16384))
# (B, H) of the LN + peephole layer only, at which the row plan (ln_plan.cuh)
# splits a row over 2, 4, 5, 6 and 7 CTAs (STEP_SHAPES reach 1, 3, 4 and 8),
# and one row a CTA at the longest row, past the default shared memory
CLUSTER_SHAPES = ((2, 600), (2, 1100), (2, 1300), (2, 1600), (2, 1900),
                  (132, 16384))
LN_LENGTHS = (1, 3, 12, 640, 2048, 16384)

EFF_M = fp.quantize_multiplier(2.0**-30 / 0.005)  # o * tanh(c) -> int8 m
LN_OUT = fp.quantize_multiplier(2**-10 * 3e-5 / 2**-12)
EFF_C_O = fp.quantize_multiplier(0.37)  # peephole p_o * c_new -> o gate


def _ints(gen: torch.Generator, shape, lo: int, hi: int,
          dtype=torch.int16) -> torch.Tensor:
    return torch.randint(lo, hi, shape, generator=gen, device=gen.device,
                         dtype=dtype)


def cell_cases(B: int, H: int, gen: torch.Generator) -> List[Case]:
    """CIFG on and off x cell formats Q0/Q2/Q4 with an int16 o gate, then
    the peephole o gate (int32 pre-peephole accumulator, finished on
    ``c_new``) with and without the in-fusion LayerNorm."""
    i16, f16, z16, o16 = (_ints(gen, (B, H), -32768, 32768) for _ in range(4))
    common = dict(i16=i16, f16=f16, z16=z16,
                  c_q=_ints(gen, (B, H), -20000, 20000), eff_m=EFF_M,
                  zp_m=-4)
    o32 = _ints(gen, (B, H), -(2**20), 2**20, torch.int32)
    p_o, lw = _ints(gen, (H,), -32767, 32768), _ints(gen, (H,), 100, 32767)
    lb = _ints(gen, (H,), -100000, 100000, torch.int32)
    cases = [(f"B={B} H={H} cifg={cifg} m_c={m_c}",
              dict(common, o_in=o16, cifg=cifg, cell_int_bits=m_c))
             for cifg in (False, True) for m_c in (0, 2, 4)]
    cases += [(f"B={B} H={H} cifg={cifg} peephole LN={bool(ln)}",
               dict(common, o_in=o32, cifg=cifg, cell_int_bits=2, p_o=p_o,
                    eff_c_o=EFF_C_O, **ln))
              for cifg in (False, True)
              for ln in ({}, dict(lw_o=lw, lb_o=lb, ln_out_o=LN_OUT))]
    return cases


def layernorm_case(n: int, gen: torch.Generator) -> Case:
    """Eight rows of length ``n``: random rows, a constant row (V = 0), rows
    at 32767, -32768 and -32767, and a row alternating the extremes."""
    q = _ints(gen, (8, n), -32768, 32768)
    q[1] = 1234
    q[2] = 32767
    q[3] = -32768
    q[4, ::2] = 32767
    q[4, 1::2] = -32768
    q[5] = -32767
    return (f"n={n}",
            dict(q=q, ln_w_q=_ints(gen, (n,), 100, 32767),
                 ln_b_q=_ints(gen, (n,), -100000, 100000, torch.int32),
                 out_m0=LN_OUT[0], out_shift=LN_OUT[1]))


def step_layer(variant, B: int, H: int, dev, seed: int, d_in: int = 8):
    """A layer quantized by the port's calibration and recipe on ``dev``
    (its LN weights spread around 1), and the accumulators, cell state and
    gate-pass output of one step: rows from the layer's own products of
    random int8 x and h, row 1 at the int32 extremes alternating (every
    gate at the int16 extremes) and c at the int16 extremes there, row 2
    (where B > 2) constant (V = 0 in every LN row without a peephole).
    Returns
    ``(arrays, spec, step kwargs)``."""
    from ..core import recipe as R
    from ..core.calibrate import Stats, TapCollector
    from ..kernels import int8_matmul as K1
    from ..kernels import int_layernorm as KL
    from ..models import lstm as L

    d_p = 8 if variant.use_projection else 0
    cfg = L.LSTMConfig(d_in, H, d_p, variant)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = L.init_lstm_params(gen, cfg, dev)
    if variant.use_layernorm:
        for g in params["L"]:
            params["L"][g] = 1.0 + 0.3 * torch.randn(H, generator=gen,
                                                     device=dev)
    col = TapCollector()
    with torch.no_grad():
        L.lstm_layer(params, cfg, 0.8 * torch.randn(
            (2, 3, d_in), generator=gen, device=dev), collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_lstm_layer(params, cfg, stats)
    x = _ints(gen, (B, d_in), -128, 128, torch.int8)
    h = _ints(gen, (B, spec.d_out), -128, 128, torch.int8)
    acc_x = K1.int8_matmul_plain(x, arrays["W_cat"], arrays["fold_x_cat"])
    acc_h = K1.int8_matmul_plain(h, arrays["R_cat"], arrays["fold_hb_cat"])
    c_q = _ints(gen, (B, H), -20000, 20000)
    for t, hi, lo in ((acc_x, 2**31 - 1, -(2**31)),
                      (acc_h, 2**31 - 1, -(2**31)), (c_q, 32767, -32768)):
        t[1, ::2], t[1, 1::2] = hi, lo
        if B > 2:
            t[2] = t[2, 0].item()
    kw = dict(arrays=arrays, spec=spec, acc_x=acc_x, acc_h=acc_h, c_q=c_q)
    gates16 = (KL.int_layernorm_gates_plain(**kw) if variant.use_layernorm
               else None)
    return arrays, spec, dict(kw, gates16=gates16)


def step_cases(dev, seed: int = 0) -> Tuple[List[Case], List[Case]]:
    """``(gate-pass cases, cell-step cases)``: at every ``STEP_SHAPES``
    (B, H), every LN x peephole x CIFG layer (LN only, and projected to 8
    so R stays small, at H 16384), then the LN + peephole layer at every
    ``CLUSTER_SHAPES`` (B, H); the cell reads the gate pass's plain output,
    so each kernel is held on its own."""
    from ..models import lstm as L

    layers = [(B, H, ln, ph, cifg) for B, H in STEP_SHAPES
              for ln in (False, True) for ph in (False, True)
              for cifg in (False, True) if H <= 4096 or ln]
    layers += [(B, H, True, True, False) for B, H in CLUSTER_SHAPES]
    gate_cases, cell_cases_ = [], []
    for B, H, ln, ph, cifg in layers:
        v = L.LSTMVariant(use_layernorm=ln, use_peephole=ph, use_cifg=cifg,
                          use_projection=H > 4096)
        seed += 1
        _, _, kw = step_layer(v, B, H, dev, seed)
        label = f"B={B} H={H} {v.name}"
        if ln:
            gate_cases.append((label, {k: kw[k] for k in (
                "arrays", "spec", "acc_x", "acc_h", "c_q")}))
        cell_cases_.append((label, kw))
    return gate_cases, cell_cases_
