"""Shared layer primitives (port of ``repro.layers.common``).

Initializers draw from an explicit ``torch.Generator`` on the target
device and return the tensor alone: the reference's logical sharding specs
have no counterpart here.  Both norms compute in float32 and cast back to
the input's dtype, as the reference does.  ``causal_conv1d`` is the
depthwise time convolution of the recurrent layers (ssm, RG-LRU).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

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


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                  cache: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv over time.  x ``(B, T, D)``; w ``(K, D)``.

    With ``cache`` ``(B, K-1, D)`` (decode) the cache's inputs precede x;
    otherwise zeros do (train/prefill).  Returns ``(y, the last K-1
    inputs)``, the new cache.  The taps add in order, each product and sum
    rounded in x's dtype, as the reference's loop computes them.
    """
    K = w.shape[0]
    if cache is None:
        pad = x.new_zeros(x.shape[:1] + (K - 1,) + x.shape[2:])
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # (B, T+K-1, D)
    T = x.shape[1]
    y = torch.zeros_like(x)
    for k in range(K):
        y = y + xp[:, k:k + T] * w[k]
    if b is not None:
        y = y + b
    new_cache = xp[:, xp.shape[1] - (K - 1):] if K > 1 else xp[:, :0]
    return y, new_cache
