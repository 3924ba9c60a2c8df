"""Matmul and lookup helpers for plain (bf16) weights.

Port of the plain-weight paths of ``repro.layers.qmm``; the int8-weight
dict form serves the transformer family, which this port has not reached.
"""
from __future__ import annotations

import torch


def mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the operands' dtype (bf16 for the LM head)."""
    return x @ w


def emb_lookup(w: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Rows of the embedding table for integer token ids."""
    return w[ids.to(torch.long)]
