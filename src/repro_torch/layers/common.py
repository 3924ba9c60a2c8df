"""Shared layer primitives (port of ``repro.layers.common``).

Initializers draw from an explicit ``torch.Generator`` on the target
device and return the tensor alone: the reference's logical sharding specs
have no counterpart here.  Both norms compute in float32 and cast back to
the input's dtype, as the reference does.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

Params = Dict[str, Any]


def dense_init(generator: torch.Generator, shape: Sequence[int],
               dtype=torch.bfloat16, scale: Optional[float] = None,
               device=None) -> torch.Tensor:
    """Variance-scaling dense init: N(0, 1/fan_in), fan_in = shape[0]
    (the second-to-last axis of a stacked ``(L, in, out)`` weight)."""
    fan_in = shape[-2] if len(shape) > 1 else 1
    s = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    w = torch.randn(tuple(shape), generator=generator,
                    device=generator.device) * s
    return w.to(device=device or generator.device, dtype=dtype)


def zeros_init(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def ones_init(shape, dtype=torch.bfloat16, device=None) -> torch.Tensor:
    return torch.ones(tuple(shape), dtype=dtype, device=device)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * w.float()).to(dt)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
              eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps) * w.float()
    if b is not None:
        y = y + b.float()
    return y.to(dt)


def norm_apply(kind: str, x: torch.Tensor, params: Params, name: str
               ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params[name])
    return layernorm(x, params[name], params.get(name + "_b"))


def norm_init(kind: str, d: int, name: str, params: Params,
              dtype=torch.bfloat16, device=None, stack: Sequence[int] = ()
              ) -> None:
    """Ones (and, for LayerNorm, zero biases) of shape ``(*stack, d)``."""
    params[name] = ones_init((*stack, d), dtype, device)
    if kind == "layernorm":
        params[name + "_b"] = zeros_init((*stack, d), dtype, device)
