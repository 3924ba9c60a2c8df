"""Mamba-1 selective SSM block, the falcon-mamba-7b backbone (port of
``repro.layers.ssm``).

Train/prefill runs the sequential scan over time (carry ``(B, d_inner,
d_state)`` in float32); decode is one step of it with the carried state
and the conv cache.  ``_ssm_scan`` is the reference's ``lax.scan``, not a
TPU kernel, so it is a plain PyTorch loop over T here, with the
reference's op order: ``h = h * dA_t + dBu_t`` (one fused multiply-add, as
XLA emits it), then ``y_t = h . C_t``.
``dA = exp(delta * A)`` and ``dBu`` are formed a chunk of ``SCAN_CHUNK``
steps at a time: the same elementwise float32 values the reference forms
for all of T at once, which at B 1 x S 4096 would take 2 GiB each a layer.
On the card the loop costs one launch a step (host-bound); a scan kernel
is a later ROADMAP item.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .common import causal_conv1d, dense_init
from .mlp import silu, softplus
from .qmm import is_quant, mm

SCAN_CHUNK = 256  # steps whose dA, dBu and states are held at once


def ssm_init(generator: torch.Generator, d_model: int, d_inner: int,
             d_state: int, d_conv: int, dt_rank: int, params: Dict,
             dtype=torch.bfloat16, device=None, stack: Sequence[int] = ()
             ) -> None:
    """The block's weights, each of shape ``(*stack, ...)``; ``dt_bias``,
    ``A_log`` (S4D-real) and ``D`` are the reference's constants."""
    stack = tuple(stack)

    def const(a: np.ndarray, dt) -> torch.Tensor:
        t = torch.as_tensor(a, dtype=torch.float32).to(device=device,
                                                       dtype=dt)
        return t.expand(stack + t.shape).clone()

    params["in_proj"] = dense_init(generator, stack + (d_model, 2 * d_inner),
                                   dtype, device=device)
    params["conv_w"] = dense_init(generator, stack + (d_conv, d_inner), dtype,
                                  scale=0.5, device=device)
    params["conv_b"] = torch.zeros(stack + (d_inner,), dtype=dtype,
                                   device=device)
    params["x_proj"] = dense_init(
        generator, stack + (d_inner, dt_rank + 2 * d_state), dtype,
        device=device)
    params["dt_proj"] = dense_init(generator, stack + (dt_rank, d_inner),
                                   dtype, device=device)
    params["dt_bias"] = const(
        np.log(np.expm1(np.linspace(1e-3, 0.1, d_inner))), dtype)
    a = np.tile(np.arange(1, d_state + 1, dtype=np.float32), (d_inner, 1))
    params["A_log"] = const(np.log(a), torch.float32)
    params["D"] = const(np.ones(d_inner, np.float32), torch.float32)
    params["out_proj"] = dense_init(generator, stack + (d_inner, d_model),
                                    dtype, device=device)


def _ssm_scan(u: torch.Tensor, delta: torch.Tensor, A: torch.Tensor,
              B: torch.Tensor, C: torch.Tensor, h0: Optional[torch.Tensor]
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan.  u, delta ``(Bt, T, Di)``; A ``(Di, N)``;
    B, C ``(Bt, T, N)``; h0 ``(Bt, Di, N)`` float32 or None.  Returns
    ``(y (Bt, T, Di) float32, h_T)``."""
    Bt, T, Di = u.shape
    N = A.shape[-1]
    h = (torch.zeros((Bt, Di, N), dtype=torch.float32, device=u.device)
         if h0 is None else h0.float())
    # (T, Bt, ...) so that each step's slices are contiguous
    delta_t = delta.float().transpose(0, 1)
    # delta * u in float32: under jit XLA drops the bf16 rounding of the
    # product that the reference casts to float32 (ROADMAP Queue 3, F6)
    du_t = (delta.float() * u.float()).transpose(0, 1)
    B_t = B.float().transpose(0, 1)
    C_t = C.float().transpose(0, 1)
    ys = torch.empty((T, Bt, Di), dtype=torch.float32, device=u.device)
    for t0 in range(0, T, SCAN_CHUNK):
        t1 = min(T, t0 + SCAN_CHUNK)
        dA = torch.exp(delta_t[t0:t1, :, :, None] * A)  # (c, Bt, Di, N)
        dBu = du_t[t0:t1, :, :, None] * B_t[t0:t1, :, None, :]
        # one fused multiply-add a step, as XLA contracts h * dA_t + dBu_t
        steps = []
        for a, b in zip(dA.unbind(0), dBu.unbind(0)):
            h = torch.addcmul(b, h, a)
            steps.append(h)
        hs = torch.stack(steps)
        ys[t0:t1] = torch.einsum("tbdn,tbn->tbd", hs, C_t[t0:t1])
    return ys.transpose(0, 1), h


def ssm_apply(params: Dict, x: torch.Tensor,
              state: Optional[Dict[str, torch.Tensor]] = None,
              d_state: int = 16, dt_rank: int = 0
              ) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """x ``(B, T, d_model)`` -> ``(out, new state)``; with ``state``
    (decode: ``{"h", "conv"}``) the scan starts from it and the new state
    is returned, else ``None``.  ``dt_proj`` (and the other products) may
    be int8 ``{"q", "s"}``."""
    dtp = params["dt_proj"]
    d_inner = (dtp["q"] if is_quant(dtp) else dtp).shape[1]
    xz = mm(x, params["in_proj"])
    xs, z = xz[..., :d_inner], xz[..., d_inner:]
    conv_cache = state["conv"] if state is not None else None
    xs, new_conv = causal_conv1d(xs, params["conv_w"], params["conv_b"],
                                 conv_cache)
    xs = silu(xs)
    proj = mm(xs, params["x_proj"])
    dt = proj[..., :dt_rank]
    Bc = proj[..., dt_rank:dt_rank + d_state]
    Cc = proj[..., dt_rank + d_state:]
    delta = softplus(mm(dt, params["dt_proj"]) + params["dt_bias"])
    A = -torch.exp(params["A_log"])  # (Di, N)
    h0 = state["h"] if state is not None else None
    y, h_T = _ssm_scan(xs, delta, A, Bc, Cc, h0)
    y = y.to(x.dtype) + xs * params["D"].to(x.dtype)
    y = y * silu(z)
    out = mm(y, params["out_proj"])
    new_state = {"h": h_T, "conv": new_conv} if state is not None else None
    return out, new_state
