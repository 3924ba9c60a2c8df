"""MLP variants: SwiGLU, GeGLU and GELU (port of ``repro.layers.mlp``).

The activations are written op by op in the input's dtype, as the
reference computes them: ``jax.nn.silu`` is ``x * sigmoid(x)`` with the
logistic expanded to ``1 / (1 + exp(-x))``, and ``jax.nn.gelu`` is the
tanh approximation with its constants in the input's dtype; in bf16 every
op rounds.  ``F.silu``/``F.gelu`` round once and move a smoke model's
logits by ~2 % of the row's largest (ROADMAP Queue 3, F5).  ``sigmoid``
and ``softplus`` (``jax.nn.softplus`` is ``logaddexp(x, 0)``) serve the
recurrent layers (``layers/ssm.py``, ``layers/recurrent.py``) by the same
rule.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .common import dense_init
from .qmm import mm


def mlp_init(generator: torch.Generator, d_model: int, d_ff: int, kind: str,
             params: Dict, prefix: str = "mlp", dtype=torch.bfloat16,
             device=None, stack: Sequence[int] = ()) -> None:
    """The MLP's weights, each of shape ``(*stack, in, out)``."""
    stack = tuple(stack)
    if kind in ("swiglu", "geglu"):
        params[f"{prefix}_gate"] = dense_init(
            generator, stack + (d_model, d_ff), dtype, device=device)
    params[f"{prefix}_up"] = dense_init(
        generator, stack + (d_model, d_ff), dtype, device=device)
    params[f"{prefix}_down"] = dense_init(
        generator, stack + (d_ff, d_model), dtype, device=device)


class _Logistic(torch.autograd.Function):
    """``sigmoid`` under autograd: the same forward, and the reference's
    derivative of the logistic, ``g * (s * (1 - s))`` from its output (the
    jvp of ``lax.logistic``).  Autograd of the formula itself multiplies
    ``exp(-x) = inf`` by 0 where x < -88 and gives NaN (a full-width grok
    expert's gate, whose weights are drawn at 1/sqrt(E), reaches it)."""

    @staticmethod
    def forward(ctx, x, f32_division):
        s = _logistic(x, f32_division)
        ctx.save_for_backward(s)
        ctx.dtype = x.dtype
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return (g * (s * (1 - s))).to(ctx.dtype), None


def _logistic(x: torch.Tensor, f32_division: bool) -> torch.Tensor:
    e = 1 + torch.exp(-x)
    return 1 / (e.float() if f32_division else e)


def sigmoid(x: torch.Tensor, f32_division: bool = False) -> torch.Tensor:
    """``1 / (1 + exp(-x))`` op by op in x's dtype (the division in
    float32 with ``f32_division``); under autograd through ``_Logistic``."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _Logistic.apply(x, f32_division)
    return _logistic(x, f32_division)


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * sigmoid(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``max(x, 0) + log1p(exp(-|x|))``, op by op in x's dtype."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _in_dtype(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float (no device copy)."""
    return float(torch.tensor(value, dtype=dtype))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, ``jax.nn.gelu(x, approximate=True)``."""
    c = _in_dtype(np.sqrt(2 / np.pi), x.dtype)
    k = _in_dtype(0.044715, x.dtype)
    cdf = 0.5 * (1.0 + torch.tanh(c * (x + k * (x * (x * x)))))
    return x * cdf


def mlp_apply(params: Dict, x: torch.Tensor, kind: str, prefix: str = "mlp"
              ) -> torch.Tensor:
    if kind in ("swiglu", "geglu"):
        act = silu if kind == "swiglu" else gelu
        h = act(mm(x, params[f"{prefix}_gate"])) * mm(x, params[f"{prefix}_up"])
    else:
        h = gelu(mm(x, params[f"{prefix}_up"]))
    return mm(h, params[f"{prefix}_down"])
