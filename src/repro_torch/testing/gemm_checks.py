"""The int8 GEMM's exactness cases, shared by ``chip_smoke.py`` and the
``gpu`` tests: each is held bit for bit against ``int8_matmul_plain``.

The list reaches every kernel instance and split of K that the plan
(``csrc/gemm_plan.cuh``) picks on a 132-SM card
(``tests/test_torch_gemm_plan_cuh.py`` checks that on the host), the three
epilogues under a split, ragged M, N and K (K not divisible by the split,
rows of x or w not 16-byte aligned, so the byte copies run), the M at the
forms' edges (1, 16, 17, 20, 32, 33, 128, 129) and every shape the serving
paths launch.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

I32, I8, I16 = torch.int32, torch.int8, torch.int16

# (M, K, N, out dtype): what the serving paths launch (lstm-rnnt's input
# stages at K 2048 and 640, its recurrent product and int8 projection;
# gru-rnnt's K 2048 N 6144; decode and stepwise M 4, engine chunk 16, GRU
# verify 20, static prefill 128)
SERVING = [(4, 2048, 8192, I32), (4, 640, 8192, I32), (4, 2048, 640, I8),
           (4, 2048, 6144, I32), (16, 2048, 8192, I32), (16, 640, 8192, I32),
           (16, 2048, 6144, I32), (20, 2048, 6144, I32),
           (128, 2048, 8192, I32), (128, 640, 8192, I32),
           (128, 2048, 6144, I32)]
# one case per (instance, split) the plan picks, the epilogues in turn; K
# of 100 / 200 / 512 / 641 gives 2 / 4 / 8 / 8 splits of 2 / 4 / 8 / 11 steps
BRANCHES = [
    (1, 37, 5, I32), (3, 100, 5, I8), (5, 200, 37, I16), (16, 641, 100, I32),
    (1, 100, 8191, I8), (2, 200, 4096, I16), (4, 512, 2048, I32),
    (1, 64, 61, I16), (7, 100, 61, I32), (9, 200, 100, I8),
    (13, 641, 61, I16),
    (17, 37, 5, I8), (20, 100, 7, I16), (32, 200, 5, I32), (17, 641, 30, I8),
    (17, 100, 8191, I16), (20, 200, 6144, I32), (32, 512, 2048, I8),
    (17, 64, 61, I32), (24, 100, 61, I16), (31, 200, 100, I32),
    (32, 641, 61, I8),
    (33, 37, 5, I16), (33, 100, 5, I32), (129, 200, 3000, I8),
    (65, 200, 5, I16), (129, 37, 6144, I32), (129, 100, 3000, I16),
    (129, 200, 2048, I8),
]
# the forms' edges and ragged shapes: byte copies where K or N is not a
# multiple of 16, the int8 / int16 epilogues at the serving widths, every
# split under int8 and int16 outputs
EDGES = [(1, 1, 1, I32), (1, 2048, 8192, I16), (16, 2048, 8192, I8),
         (17, 2047, 8191, I32), (20, 2048, 6144, I16), (32, 640, 8192, I8),
         (33, 2047, 100, I32), (128, 640, 8192, I8), (129, 641, 8191, I32),
         (129, 640, 8192, I16), (5, 37, 130, I32), (7, 99, 61, I8),
         (65, 70, 129, I16), (4, 48, 80, I16), (100, 272, 208, I32),
         (13, 2048, 8192, I8), (4, 2048, 8192, I16), (4, 2048, 6144, I8)]
CASES: List[Tuple[int, int, int, torch.dtype]] = SERVING + BRANCHES + EDGES


def extreme_operands(M: int, K: int, N: int, dev: torch.device):
    """x and w all -128, fold 0: every sum is K * 2**14 (2**25 at K 2048),
    the most a full-depth int8 product reaches."""
    x = torch.full((M, K), -128, dtype=torch.int8, device=dev)
    w = torch.full((K, N), -128, dtype=torch.int8, device=dev)
    return x, w, torch.zeros(N, dtype=torch.int32, device=dev)
