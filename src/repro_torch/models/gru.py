"""Float GRU reference: the second cell served through the integer stack.

Port of ``repro.models.gru``.  The cuDNN/v3 "reset-after" form keeps the
recurrent product one packed ``(B, H) x (H, 3H)`` GEMM (the reset gate
multiplies the *output* of ``h @ R_n``):

  r = sigmoid(x W_r + h R_r + b_r)
  u = sigmoid(x W_u + h R_u + b_u)
  n = tanh(x W_n + r (.) (h R_n + b_n))
  h' = u (.) h + (1 - u) (.) n

Variants: plain and layer-normalized (LN replaces the per-gate bias add by
``norm(.) (.) L + b`` as in the LSTM).  The float graph is the calibration
vehicle for ``core/recipe.quantize_gru_layer``: a ``TapCollector`` passed
through it records every Table-2 range.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .lstm import _layernorm_stats

GATES = ("r", "u", "n")  # reset, update, new/candidate


@dataclasses.dataclass(frozen=True)
class GRUVariant:
    use_layernorm: bool = False

    @property
    def gates(self) -> Tuple[str, ...]:
        return GATES

    @property
    def name(self) -> str:
        return "LN" if self.use_layernorm else "noLN"


ALL_VARIANTS = tuple(GRUVariant(ln) for ln in (False, True))


@dataclasses.dataclass(frozen=True)
class GRUConfig:
    d_input: int
    d_hidden: int
    variant: GRUVariant = GRUVariant()

    @property
    def d_output(self) -> int:
        return self.d_hidden


def init_gru_params(generator: torch.Generator, cfg: GRUConfig,
                    device=None) -> Dict[str, Any]:
    """One GRU layer's float32 parameters; per-gate W/R kept separate.

    Drawn on ``generator``'s device, then placed on ``device``.
    """
    gdev = generator.device

    def dense(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=gdev)
                / math.sqrt(fan_in)).to(device)

    params: Dict[str, Any] = {"W": {}, "R": {}, "b": {}}
    for g in cfg.variant.gates:
        params["W"][g] = dense((cfg.d_input, cfg.d_hidden), cfg.d_input)
        params["R"][g] = dense((cfg.d_hidden, cfg.d_hidden), cfg.d_hidden)
        params["b"][g] = torch.zeros(cfg.d_hidden, device=device)
    if cfg.variant.use_layernorm:
        params["L"] = {g: torch.ones(cfg.d_hidden, device=device)
                       for g in cfg.variant.gates}
    return params


def gru_cell(params: Dict[str, Any], cfg: GRUConfig, x: torch.Tensor,
             h: torch.Tensor, collector=None) -> torch.Tensor:
    """One float GRU step (reset-after).  x: (B, d_in); h: (B, d_h).

    Taps as in the reference: ``g_<gate>`` is the pre-activation before LN
    and before the bias; for ``n`` it is taken after the reset product.
    """
    v = cfg.variant

    def tap(name, t):
        return collector.tap(name, t) if collector is not None else t

    x = tap("x", x)
    h = tap("h", h)

    def sigmoid_gate(g: str):
        acc = tap(f"g_{g}", x @ params["W"][g] + h @ params["R"][g])
        if v.use_layernorm:
            acc = _layernorm_stats(acc) * params["L"][g] + params["b"][g]
        else:
            acc = acc + params["b"][g]
        return torch.sigmoid(acc)

    r_t = sigmoid_gate("r")
    u_t = sigmoid_gate("u")
    gh = h @ params["R"]["n"]
    if v.use_layernorm:
        acc = tap("g_n", x @ params["W"]["n"] + r_t * gh)
        acc = _layernorm_stats(acc) * params["L"]["n"] + params["b"]["n"]
    else:
        acc = tap("g_n", x @ params["W"]["n"] + r_t * (gh + params["b"]["n"]))
    n_t = torch.tanh(acc)
    return tap("h_out", u_t * h + (1.0 - u_t) * n_t)


def gru_layer(params: Dict[str, Any], cfg: GRUConfig, xs: torch.Tensor,
              h0: Optional[torch.Tensor] = None, collector=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run a layer over time.  xs: (B, T, d_in) -> (B, T, d_h)."""
    B = xs.shape[0]
    h = h0 if h0 is not None else xs.new_zeros((B, cfg.d_hidden))
    outs = []
    for t in range(xs.shape[1]):
        h = gru_cell(params, cfg, xs[:, t], h, collector)
        outs.append(h)
    if not outs:
        return xs.new_zeros((B, 0, cfg.d_hidden)), h
    return torch.stack(outs, dim=1), h
