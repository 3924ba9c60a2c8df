"""RG-LRU recurrent block, the temporal mixing of RecurrentGemma / Griffin
(port of ``repro.layers.recurrent``).

    r_t = sigmoid(W_r x_t);  i_t = sigmoid(W_i x_t)
    a_t = exp(-c * softplus(Lambda) * r_t)          (c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

inside the Griffin block: conv1d(4) -> RG-LRU, gated by GELU of the second
half of the input projection.  Decode carries ``{"h", "conv"}``.
``_rglru_scan`` is the reference's ``lax.scan``, not a TPU kernel: a plain
PyTorch loop over T in float32 here, one launch a step on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import causal_conv1d, dense_init
from .mlp import gelu, sigmoid, softplus
from .qmm import mm

_C = 8.0  # Griffin's fixed recurrence sharpness constant


def rglru_init(generator: torch.Generator, d_model: int, d_rnn: int,
               d_conv: int, params: Dict, dtype=torch.bfloat16, device=None,
               stack: Sequence[int] = ()) -> None:
    """The block's weights, each of shape ``(*stack, ...)``; ``rg_lambda``
    is the reference's numpy draw (``default_rng(0)``, so that a =
    sigmoid(Lambda) lies in [0.9, 0.999]), the same for every layer."""
    stack = tuple(stack)
    params["rg_in"] = dense_init(generator, stack + (d_model, 2 * d_rnn),
                                 dtype, device=device)
    params["conv_w"] = dense_init(generator, stack + (d_conv, d_rnn), dtype,
                                  scale=0.5, device=device)
    params["conv_b"] = torch.zeros(stack + (d_rnn,), dtype=dtype,
                                   device=device)
    params["rg_gate_r"] = dense_init(generator, stack + (d_rnn, d_rnn), dtype,
                                     device=device)
    params["rg_gate_i"] = dense_init(generator, stack + (d_rnn, d_rnn), dtype,
                                     device=device)
    lam = np.random.default_rng(0).uniform(0.9, 0.999, d_rnn)
    lam = torch.as_tensor(np.log(lam / (1 - lam)).astype(np.float32),
                          device=device)
    params["rg_lambda"] = lam.expand(stack + lam.shape).clone()
    params["rg_out"] = dense_init(generator, stack + (d_rnn, d_model), dtype,
                                  device=device)


def _rglru_scan(x: torch.Tensor, r: torch.Tensor, i: torch.Tensor,
                log_a: torch.Tensor, h0: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, r, i ``(B, T, D)``; log_a ``(D,)``; returns ``(y (B, T, D)
    float32, h_T)``."""
    B, T, D = x.shape
    h = (torch.zeros((B, D), dtype=torch.float32, device=x.device)
         if h0 is None else h0.float())
    log_a_t = (-_C) * softplus(log_a)[None, None] * r.float()
    a_t = torch.exp(log_a_t)  # (B, T, D) in (0, 1)
    # i * x in float32: under jit XLA drops the bf16 rounding of the
    # product that the reference casts to float32 (ROADMAP Queue 3, F6)
    gated_x = i.float() * x.float()
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.square(a_t), 1e-12))
    # (T, B, D) so that each step's slices are contiguous
    a_s = a_t.transpose(0, 1).contiguous()
    bx = (beta * gated_x).transpose(0, 1).contiguous()
    # one fused multiply-add a step, as XLA contracts a_t * h + bx_t
    steps = []
    for a, b in zip(a_s.unbind(0), bx.unbind(0)):
        h = torch.addcmul(b, a, h)
        steps.append(h)
    return torch.stack(steps, dim=1), h


def rglru_apply(params: Dict, x: torch.Tensor,
                state: Optional[Dict[str, torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x ``(B, T, d_model)`` -> ``(out, new state or None)``."""
    xz = mm(x, params["rg_in"])
    d_rnn = xz.shape[-1] // 2
    xs, z = xz[..., :d_rnn], xz[..., d_rnn:]
    conv_cache = state["conv"] if state is not None else None
    xs, new_conv = causal_conv1d(xs, params["conv_w"], params["conv_b"],
                                 conv_cache)
    # r reaches the scan only as float32: under jit XLA drops the bf16
    # rounding of the logistic's last op, the division (ROADMAP Queue 3, F6)
    r = sigmoid(mm(xs, params["rg_gate_r"]), f32_division=True)
    i = sigmoid(mm(xs, params["rg_gate_i"]))
    h0 = state["h"] if state is not None else None
    y, h_T = _rglru_scan(xs, r, i, params["rg_lambda"], h0)
    y = y.to(x.dtype) * gelu(z)
    out = mm(y, params["rg_out"])
    new_state = {"h": h_T, "conv": new_conv} if state is not None else None
    return out, new_state
