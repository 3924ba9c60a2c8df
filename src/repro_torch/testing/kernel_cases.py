"""The cases on which the cell and LayerNorm kernels are held against
their plain versions, one list for ``chip_smoke.py`` and the ``gpu`` tests.

Every case is ``(label, kwargs)``; ``kwargs`` call the kernel's wrapper and
its plain version alike.  Inputs are drawn from a ``torch.Generator`` on the
device under test.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from ..core import fixedpoint as fp

Case = Tuple[str, Dict[str, Any]]

CELL_SHAPES = ((8, 256), (16, 1024), (4, 2048))  # (B, H), as the reference's kernel tests
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
