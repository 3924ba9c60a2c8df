"""int8 gradient compression with error feedback.

Port of the optimizer-level transform of ``repro.optim.grad_compress``:
each gradient leaf plus its residual is quantized symmetrically to int8
with the leaf's own scale (max |g| / 127) and dequantized, and the
quantization error is kept as the residual for the next step (error
feedback preserves convergence).  This simulates the wire quantization of
an int8 all-reduce where the framework owns the all-reduce.

The on-wire form over a process group (the reference's ``compressed_psum``,
a ``shard_map`` body) is not ported yet: it comes with the sharded train
step (ROADMAP Queue 1).

Rounding: the port divides by tensors (true division on the CPU and on the
card), so it equals the reference's ``ef_compress_tree`` run eagerly bit
for bit; under ``jax.jit`` XLA may rewrite the divisions (ROADMAP F1).
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from .. import tree_util as tu


def ef_init(params) -> Any:
    """A zero float32 residual for every leaf of ``params``."""
    return tu.tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)


@torch.no_grad()
def ef_compress_tree(grads, residuals) -> Tuple[Any, Any]:
    """``(dequantized grads in their dtypes, new float32 residuals)``."""

    def one(g, r):
        gf = g.to(torch.float32) + r
        scale = (torch.clamp(torch.max(torch.abs(gf)), min=1e-20)
                 / gf.new_tensor(127.0))
        q = torch.clamp(torch.round(gf / scale), -127, 127)
        deq = q * scale
        return deq.to(g.dtype), gf - deq

    out = [one(g, r) for g, r in zip(tu.leaves(grads), tu.leaves(residuals),
                                     strict=True)]
    return (tu.unflatten(grads, [o[0] for o in out]),
            tu.unflatten(grads, [o[1] for o in out]))
