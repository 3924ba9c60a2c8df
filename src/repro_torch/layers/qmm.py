"""Quantization-aware matmul helpers (port of ``repro.layers.qmm``).

A weight is either a plain tensor or a quantized dict ``{"q": int8, "s":
float32}`` with per-output-channel scales (symmetric max/127).  ``mm`` and
friends dequantize inside the consumer, as the reference does: the int8
weight is cast to the activation's dtype and the product runs as a plain
matmul, the scale applied to its output.  The reference computes that
product in XLA, outside any Pallas kernel.  ``expert_einsum`` is the MoE
layer's batched product over the experts, with per (expert, out-channel)
scales.

A bf16 product accumulates in float32 and rounds once.  On the card it
runs on the bf16 tensor cores (``torch.matmul``).  On the CPU torch's bf16
GEMM sums in another blocked order than XLA, so there ``matmul`` runs a
float32 GEMM of the (exact) bf16 values, which gives XLA's results.
"""
from __future__ import annotations

from typing import Dict, Union

import torch

QWeight = Union[torch.Tensor, Dict[str, torch.Tensor]]


def is_quant(w: QWeight) -> bool:
    return isinstance(w, dict) and "q" in w


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in x's dtype (see the module's note on bf16)."""
    if x.device.type == "cpu" and x.dtype == torch.bfloat16:
        return (x.float() @ w.float()).to(x.dtype)
    return x @ w


def mm(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """x @ w, with transparent int8-weight dequantization."""
    if is_quant(w):
        y = matmul(x, w["q"].to(x.dtype))
        return y * w["s"].to(x.dtype)
    return matmul(x, w)


def expert_einsum(x: torch.Tensor, w: QWeight) -> torch.Tensor:
    """The batched expert product ``ecd,edf->ecf``: x ``(E, C, in)`` times
    w ``(E, in, out)``, an int8 w dequantized inside with its ``(E, out)``
    scales broadcast over the capacity axis."""
    if is_quant(w):
        y = matmul(x, w["q"].to(x.dtype))
        return y * w["s"][:, None, :].to(x.dtype)
    return matmul(x, w)


def emb_lookup(w: QWeight, ids: torch.Tensor, unrounded: bool = False
               ) -> torch.Tensor:
    """Rows of the embedding table for integer token ids.  With
    ``unrounded`` an int8 table's rows come back as the float32 product of
    row and scale, not rounded to bf16: what a jitted reference hands a
    norm that reads the lookup directly (ROADMAP Queue 3, F6)."""
    ids = ids.to(torch.long)
    if is_quant(w):
        rows = w["q"][ids]
        scale = w["s"][ids][..., None].to(torch.bfloat16)
        if unrounded:
            return rows.float() * scale.float()
        return rows.to(torch.bfloat16) * scale
    return w[ids]


def emb_logits(w: QWeight, x: torch.Tensor) -> torch.Tensor:
    """x @ embedding.T (tied head); per-row scales become per-logit ones."""
    if is_quant(w):
        y = matmul(x, w["q"].t().to(x.dtype))
        return y * w["s"].to(x.dtype)
    return matmul(x, w.t())


def quantize_weight(w: torch.Tensor, channel_axis: int = -1
                    ) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel int8 (paper: s = max|W|/127)."""
    wf = w.float()
    ch = channel_axis % w.ndim
    axes = tuple(i for i in range(w.ndim) if i != ch)
    s = torch.clamp_min(torch.amax(torch.abs(wf), dim=axes), 1e-8) / 127.0
    shape = [1] * w.ndim
    shape[ch] = w.shape[ch]
    q = torch.clamp(torch.round(wf / s.reshape(shape)), -127, 127)
    return {"q": q.to(torch.int8), "s": s}
