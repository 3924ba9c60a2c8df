"""Float LSTM reference: every topology variant of the paper (sec 2).

Port of ``repro.models.lstm``: peephole, CIFG, projection and layer-norm
flags compose freely.  This float graph is (a) the accuracy baseline, (b)
the calibration vehicle (a ``TapCollector`` passed through it records
every Table-2 range) and (c) the QAT graph: with ``qat=True`` straight-
through fake quantization wraps every Table-2 tensor, W and R kept
un-concatenated (fig 16) so each product carries its own scale.
``sparsify_params`` is the magnitude pruning of Table 1's sparse rows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from .. import tree_util as tu
from ..core import fake_quant as fq

GATES = ("i", "f", "z", "o")  # input, forget, update (cell), output


@dataclasses.dataclass(frozen=True)
class LSTMVariant:
    use_layernorm: bool = False
    use_projection: bool = False
    use_peephole: bool = False
    use_cifg: bool = False

    @property
    def gates(self) -> Tuple[str, ...]:
        return tuple(g for g in GATES if not (self.use_cifg and g == "i"))

    @property
    def name(self) -> str:
        parts = ["LN" if self.use_layernorm else "noLN",
                 "Proj" if self.use_projection else "noProj",
                 "PH" if self.use_peephole else "noPH"]
        if self.use_cifg:
            parts.append("CIFG")
        return "-".join(parts)


ALL_VARIANTS = tuple(
    LSTMVariant(ln, proj, ph, cifg)
    for ln in (False, True)
    for proj in (False, True)
    for ph in (False, True)
    for cifg in (False, True)
)


@dataclasses.dataclass(frozen=True)
class LSTMConfig:
    d_input: int
    d_hidden: int
    d_proj: int = 0  # 0 => no projection
    variant: LSTMVariant = LSTMVariant()

    @property
    def d_output(self) -> int:
        return self.d_proj if self.variant.use_projection else self.d_hidden


def init_lstm_params(generator: torch.Generator, cfg: LSTMConfig,
                     device=None) -> Dict[str, Any]:
    """One layer's float32 parameters; per-gate W/R kept separate (fig 16).

    Drawn on ``generator``'s device, then placed on ``device``.
    """
    v = cfg.variant
    gdev = generator.device

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gdev).to(device)

    def dense(shape, fan_in):
        return normal(shape) / math.sqrt(fan_in)

    def zeros(n):
        return torch.zeros(n, device=device)

    params: Dict[str, Any] = {"W": {}, "R": {}, "b": {}}
    for g in v.gates:
        params["W"][g] = dense((cfg.d_input, cfg.d_hidden), cfg.d_input)
        params["R"][g] = dense((cfg.d_output, cfg.d_hidden), cfg.d_output)
        params["b"][g] = zeros(cfg.d_hidden)
    if v.use_peephole:
        params["P"] = {g: 0.1 * normal((cfg.d_hidden,))
                       for g in v.gates if g != "z"}
    if v.use_layernorm:
        params["L"] = {g: torch.ones(cfg.d_hidden, device=device)
                       for g in v.gates}
    if v.use_projection:
        params["W_proj"] = dense((cfg.d_hidden, cfg.d_proj), cfg.d_hidden)
        params["b_proj"] = zeros(cfg.d_proj)
    return params


def _layernorm_stats(x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-12)


def qat_weights(params: Dict[str, Any], cfg: LSTMConfig) -> Dict[str, Any]:
    """``params`` with every weight the QAT graph quantizes (W, R, the
    peepholes, W_proj) fake-quantized, the other leaves as they are."""
    out = dict(params)
    for name in ("W", "R"):
        out[name] = {g: fq.fake_quant_symmetric(w, bits=8)
                     for g, w in params[name].items()}
    if cfg.variant.use_peephole:
        out["P"] = {g: fq.fake_quant_symmetric(w, bits=16)
                    for g, w in params["P"].items()}
    if cfg.variant.use_projection:
        out["W_proj"] = fq.fake_quant_symmetric(params["W_proj"], bits=8)
    return out


def lstm_cell(params: Dict[str, Any], cfg: LSTMConfig, x: torch.Tensor,
              h: torch.Tensor, c: torch.Tensor, collector=None,
              qat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """One float LSTM step (eqs 1-7).  x: (B, d_in); h: (B, d_out); c: (B, d_h).

    ``collector``: optional TapCollector registering every Table-2 range.
    ``qat``: straight-through fake quant at the Table-2 tap points.
    """
    return _cell(qat_weights(params, cfg) if qat else params, cfg, x, h, c,
                 collector, qat)


def _cell(params, cfg: LSTMConfig, x, h, c, collector, qat):
    """``lstm_cell`` on weights already fake-quantized where ``qat``."""
    v = cfg.variant

    def tap(name, t):
        return collector.tap(name, t) if collector is not None else t

    x = tap("x", x)
    h = tap("h", h)
    if qat:
        x = fq.fake_quant_asymmetric(x, bits=8)
        h = fq.fake_quant_asymmetric(h, bits=8)

    def gate_preact(g: str, c_for_peephole: Optional[torch.Tensor]):
        acc = x @ params["W"][g] + h @ params["R"][g]
        if v.use_peephole and g != "z" and c_for_peephole is not None:
            acc = acc + params["P"][g] * c_for_peephole
        acc = tap(f"g_{g}", acc)  # Table-2 row g_lambda (LN output scale)
        if v.use_layernorm:
            acc = _layernorm_stats(acc) * params["L"][g] + params["b"][g]
        else:
            acc = acc + params["b"][g]
        if qat:
            acc = fq.fake_quant_q(acc, fractional_bits=12)  # Q3.12 input
        return acc

    f_t = torch.sigmoid(gate_preact("f", c))
    z_t = torch.tanh(gate_preact("z", None))
    i_t = 1.0 - f_t if v.use_cifg else torch.sigmoid(gate_preact("i", c))
    c_new = tap("c", i_t * z_t + f_t * c)
    if qat:
        c_new = fq.fake_quant_symmetric(c_new, bits=16, pot=True)
    o_t = torch.sigmoid(gate_preact("o", c_new))
    m_t = tap("m", o_t * torch.tanh(c_new))
    if v.use_projection:
        if qat:
            m_t = fq.fake_quant_asymmetric(m_t, bits=8)
        h_new = m_t @ params["W_proj"] + params["b_proj"]
    else:
        h_new = m_t
    return tap("h_out", h_new), c_new


def lstm_layer(params: Dict[str, Any], cfg: LSTMConfig, xs: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               c0: Optional[torch.Tensor] = None, collector=None,
               qat: bool = False
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Run a layer over time.  xs: (B, T, d_in) -> (B, T, d_out).

    Under ``qat`` the weights are fake-quantized once for the whole
    sequence: each step would quantize them to the same values, and
    autograd would keep one copy of every quantized weight per step (~60
    GB over full-width lstm-rnnt at T 128).
    """
    B = xs.shape[0]
    h = h0 if h0 is not None else xs.new_zeros((B, cfg.d_output))
    c = c0 if c0 is not None else xs.new_zeros((B, cfg.d_hidden))
    if qat:
        params = qat_weights(params, cfg)
    outs = []
    for t in range(xs.shape[1]):
        h, c = _cell(params, cfg, xs[:, t], h, c, collector, qat)
        outs.append(h)
    if not outs:
        return xs.new_zeros((B, 0, cfg.d_output)), (h, c)
    return torch.stack(outs, dim=1), (h, c)


def sparsify_params(params, sparsity: float):
    """Magnitude pruning of the matmul weights (paper Table 1: 50% sparse).

    Every 2-D leaf loses its ``k = round(size * sparsity)`` smallest
    magnitudes: all entries with |w| at or below the k-th smallest |w|
    become 0, so ties at that threshold go together.  Returns a new tree.
    """
    def prune(w):
        if not isinstance(w, torch.Tensor) or w.ndim != 2:
            return w
        k = int(round(w.numel() * sparsity))
        if k == 0:
            return w
        thresh = torch.sort(w.abs().reshape(-1)).values[k - 1]
        return torch.where(w.abs() <= thresh, 0.0, w)

    return tu.tree_map(prune, params)
