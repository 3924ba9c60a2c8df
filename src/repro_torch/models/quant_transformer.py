"""The paper's recipe on transformer serving: int8 weights + int8 KV cache.

Port of ``repro.models.quant_transformer``.  ``quantize_param_tree`` turns
every large (>= 2-D, >= 16k-element) float weight of the whitelist into
``{"q": int8, "s": float32}``: symmetric max/127 per output channel (the
scale reduces only the contraction axis, -2, so a stacked ``(L, in, out)``
weight keeps its layer axis: ``{"q": (L, in, out), "s": (L, out)}``, and
an MoE expert stack its expert axis too: ``{"q": (L, E, in, out), "s":
(L, E, out)}``), and per row for the embedding.  ``quantize_bundle`` also asks for an int8
decode cache, which the dense family's takes (the recurrent families keep
their float state, as in the reference).  The reference's ``quantize_specs`` mirrors logical sharding specs,
which the port does not have.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .model_zoo import ModelBundle

# the reference's whitelist of weight-matrix leaf names (Table 2's weight
# rule); norms, biases and routers stay as they are
_WEIGHT_NAMES = (
    "wq", "wk", "wv", "wo", "mlp_gate", "mlp_up", "mlp_down", "moe_gate",
    "moe_up", "moe_down", "shared_gate", "shared_up", "shared_down",
    "embedding", "lm_head", "in_proj", "x_proj", "dt_proj", "out_proj",
    "rg_in", "rg_gate_r", "rg_gate_i", "rg_out", "W_proj",
    "self_wq", "self_wk", "self_wv", "self_wo",
    "cross_wq", "cross_wk", "cross_wv", "cross_wo",
)
_MIN_SIZE = 1 << 14
_FLOATS = (torch.bfloat16, torch.float32, torch.float16)


def _should_quantize(path: str, leaf) -> bool:
    name = path.rsplit("/", 1)[-1]
    if name not in _WEIGHT_NAMES:
        return False
    if not isinstance(leaf, torch.Tensor) or leaf.dim() < 2:
        return False
    if leaf.dtype not in _FLOATS:
        return False
    return leaf.numel() >= _MIN_SIZE


def _quantize(path: str, leaf: torch.Tensor):
    """One weight -> ``{"q", "s"}``.  The division is true division: the
    reference launcher runs this eagerly, outside jit.  A stack of layers
    (or of experts) is quantized a matrix at a time (the same values: each
    matrix's scales reduce its own contraction axis), so the float32
    temporaries stay one matrix's size (a full-width mamba ``in_proj``
    stack is 4.3 G elements, a kimi layer's experts 16.9 G)."""
    if leaf.dim() > 2:
        q = torch.empty(leaf.shape, dtype=torch.int8, device=leaf.device)
        s = torch.empty(leaf.shape[:-2] + leaf.shape[-1:],
                        dtype=torch.float32, device=leaf.device)
        for i in range(leaf.shape[0]):
            part = _quantize(path, leaf[i])
            q[i], s[i] = part["q"], part["s"]
        return {"q": q, "s": s}
    wf = leaf.float()
    if "embedding" in path:  # (vocab, d): per row
        s = torch.clamp_min(torch.amax(torch.abs(wf), dim=-1), 1e-8) / 127.0
        q = torch.clamp(torch.round(wf / s[..., None]), -127, 127)
    else:
        s = torch.clamp_min(torch.amax(torch.abs(wf), dim=-2), 1e-8) / 127.0
        q = torch.clamp(torch.round(wf / s[..., None, :]), -127, 127)
    return {"q": q.to(torch.int8), "s": s}


def quantize_param_tree(params, path: str = "") -> Any:
    """int8 per-channel quantization of a param tree (nested dicts, and
    lists such as whisper's layer lists, a leaf's path naming list items by
    index as the reference's does); returns a new tree and leaves the input
    as it was.  Float leaves off the whitelist (``A_log``, ``D``,
    ``rg_lambda``, the norms and biases) stay as they are."""
    if isinstance(params, dict):
        return {k: quantize_param_tree(v, f"{path}/{k}" if path else str(k))
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(
            quantize_param_tree(v, f"{path}/{i}" if path else str(i))
            for i, v in enumerate(params))
    if _should_quantize(path, params):
        return _quantize(path, params)
    return params


def quantize_bundle(bundle: ModelBundle) -> ModelBundle:
    orig_init = bundle.init

    def init(generator, device="cuda"):
        return quantize_param_tree(orig_init(generator, device))

    def init_state(batch, max_len, quantized=True, device="cuda"):
        return bundle.init_state(batch, max_len, quantized=True,
                                 device=device)

    return dataclasses.replace(bundle, init=init, init_state=init_state)
