"""Attention: GQA, blockwise (flash) softmax, decode against a KV cache.

Port of ``repro.layers.attention``:

* ``flash_attention`` -- blockwise online softmax; it launches the
  hand-written kernel ``kernels/flash_attention.py`` on CUDA tensors and
  takes that kernel's plain version on CPU tensors (the model's forward at
  S > 1024).  Under autograd it runs through ``FlashAttention``, the
  reference's custom VJP: the forward also writes each row's log-sum-exp,
  and the backward recomputes each tile's logits from the saved ``(q, k,
  v, out, lse)`` (``flash_attention_bwd``: the hand-written backward
  kernel on CUDA tensors, its plain version on CPU tensors);
* ``full_attention`` -- the direct product for short sequences (plain
  PyTorch, as the reference runs it in XLA);
* ``decode_attention`` -- one query position against a bf16 or int8 KV
  cache (plain PyTorch: the reference has no kernel for it).

The reference's triangular-schedule environment toggle is not ported: the
default rectangular schedule defines the result, and the kernels skip only
tiles that schedule leaves unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from ..kernels import flash_attention as FA

NEG_INF = -1e30
# float32(1 / float32(127)): under jit XLA turns the reference's ``x / 127``
# into a product with this reciprocal (ROADMAP Queue 3, F4)
_RECIP_127 = float(np.float32(1.0) / np.float32(127.0))


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, KVH, D) -> (B, S, KVH*groups, D) by head repetition."""
    if groups == 1:
        return k
    B, S, KVH, D = k.shape
    k = k[:, :, :, None, :].expand(B, S, KVH, groups, D)
    return k.reshape(B, S, KVH * groups, D)


def _pick_block(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    if n <= target:
        return n
    for b in range(target, 0, -1):
        if n % b == 0:
            return b
    return n


def _mask_block(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                window: int) -> torch.Tensor:
    """(bq, bk) boolean mask: True = attend."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m &= k_pos[None, :] > q_pos[:, None] - window
    return m


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True)


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_offset: int = 0, causal: bool = True, window: int = 0
                   ) -> torch.Tensor:
    """q ``(B, Sq, H, D)``, k/v ``(B, Sk, H, D)`` (already GQA-repeated)."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    scale = 1.0 / np.sqrt(D)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(Sq, device=q.device) + q_offset
    k_pos = torch.arange(Sk, device=q.device)
    mask = _mask_block(q_pos, k_pos, causal, window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = _softmax(logits)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                        v.float()).to(v.dtype)


def _flash_forward(q, k, v, q_offset, causal, window, block_q, block_k,
                   return_lse=False):
    """The reference's ``_flash_fwd_impl``: q pre-scaled by ``1/sqrt(D)``
    in its own dtype, then the kernel (or its plain version) at
    ``scale=1.0`` over the reference's chunks."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    qs = (q.float() * scale).to(q.dtype)
    return FA.flash_attention(
        qs, k, v, causal=causal, window=window, scale=1.0, q_offset=q_offset,
        block_q=_pick_block(q.shape[1], block_q),
        block_k=_pick_block(k.shape[1], block_k), return_lse=return_lse)


class FlashAttention(torch.autograd.Function):
    """``flash_attention`` with the reference's custom VJP: the forward
    saves ``(q, k, v, out, lse)`` (q unscaled, k and v unrepeated), the
    backward is ``flash_attention_bwd`` at the reference's chunks on the
    CPU and the backward kernel on the card."""

    @staticmethod
    def forward(ctx, q, k, v, q_offset, causal, window, block_q, block_k):
        out, lse = _flash_forward(q, k, v, q_offset, causal, window, block_q,
                                  block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (q_offset, causal, window, block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        q_offset, causal, window, block_q, block_k = ctx.args
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = FA.flash_attention_bwd(
            q, k, v, out, lse, dout, causal=causal, window=window,
            scale=1.0 / np.sqrt(q.shape[-1]), q_offset=q_offset,
            block_q=_pick_block(q.shape[1], block_q),
            block_k=_pick_block(k.shape[1], block_k))
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: int = 0, causal: bool = True, window: int = 0,
                    block_q: int = 512, block_k: int = 512) -> torch.Tensor:
    """Blockwise online-softmax attention.

    q ``(B, Sq, H, D)``; k/v ``(B, Sk, KVH, D)`` with KVH dividing H (the
    reference takes them GQA-repeated; each query head reads its KV head in
    place, which computes the same).  q is pre-scaled by ``1/sqrt(D)`` in
    its own dtype, as the reference layer does, and the kernel then runs
    with ``scale=1.0``.  ``block_q``/``block_k`` pick the plain versions'
    chunks as the reference picks them (the largest divisor of the length
    up to the target); the CUDA kernels tile by their own.  Where autograd
    records (grad enabled and an input requires grad) it runs through
    ``FlashAttention``; otherwise no log-sum-exp is written.
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, q_offset, causal, window,
                                    block_q, block_k)
    return _flash_forward(q, k, v, q_offset, causal, window, block_q,
                          block_k)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     cache_len: Union[int, torch.Tensor], window: int = 0,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token attention against a (possibly int8) KV cache.

    q ``(B, 1, H, D)``; caches ``(B, S, KVH, D)``; ``cache_len`` the valid
    prefix (an int, or ``(B,)``).  For int8 caches the per-(pos, head)
    scales fold into the logits and into the probabilities, as in the
    reference.
    """
    B, S, KVH, D = k_cache.shape
    H = q.shape[2]
    groups = H // KVH
    scale = 1.0 / np.sqrt(D)
    qg = (q.float() * scale).to(q.dtype).reshape(B, 1, KVH, groups, D)
    kc = k_cache.to(q.dtype) if k_cache.dtype == torch.int8 else k_cache
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kc.float())
    logits = logits[:, :, :, 0]  # (B, KVH, G, S)
    if k_scale is not None:
        logits = logits * k_scale.float().permute(0, 2, 1)[:, :, None, :]
    pos = torch.arange(S, device=q.device)
    # an int length stays a Python scalar: no host-to-device copy per call
    n = cache_len if isinstance(cache_len, int) else cache_len.reshape(-1, 1)
    valid = pos[None] < n
    if window > 0:
        valid = valid & (pos[None] >= n - window)
    logits = torch.where(valid[:, None, None], logits, NEG_INF)
    probs = _softmax(logits)
    if v_scale is not None:
        probs = probs * v_scale.float().permute(0, 2, 1)[:, :, None, :]
    vc = v_cache.to(q.dtype) if v_cache.dtype == torch.int8 else v_cache
    out = torch.einsum("bkgs,bskd->bkgd", probs.to(q.dtype).float(),
                       vc.float())
    return out.reshape(B, 1, H, D).to(q.dtype)


# --- KV cache (bf16 or int8) ------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    max_len: int
    kv_heads: int
    head_dim: int
    quantized: bool = False  # int8 per (head) symmetric, scales carried


def init_cache(batch: int, n_layers: int, spec: CacheSpec,
               dtype=torch.bfloat16, device=None) -> Dict[str, torch.Tensor]:
    shape = (n_layers, batch, spec.max_len, spec.kv_heads, spec.head_dim)
    length = torch.zeros((batch,), dtype=torch.int32, device=device)
    if spec.quantized:
        sshape = shape[:2] + (spec.max_len, spec.kv_heads)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device),
                "v_scale": torch.ones(sshape, dtype=torch.float32,
                                      device=device),
                "len": length}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "len": length}


def quantize_kv(k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per (batch, pos, head) symmetric int8, as the reference computes it
    inside its jitted decode step: the scale is ``max|k| * f32(1/127)``
    (XLA's rewrite of ``/ 127``) and the rows are truly divided by it."""
    kf = k.float()
    s = torch.clamp_min(torch.amax(torch.abs(kf), dim=-1), 1e-6) * _RECIP_127
    q = torch.clamp(torch.round(kf / s[..., None]), -127, 127)
    return q.to(torch.int8), s


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16
                  ) -> torch.Tensor:
    return (q.float() * s[..., None]).to(dtype)
