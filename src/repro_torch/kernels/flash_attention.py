"""Blockwise online-softmax attention (forward): CUDA kernel + plain version.

Port of ``repro.kernels.flash_attention.flash_attention_pallas``.
``flash_attention`` launches ``csrc/flash_attention.cu`` for CUDA tensors
and takes ``flash_attention_plain`` for CPU tensors; there is no other
fallback.  Both compute, per (batch, head) and per q tile, over the k tiles
in order:

    logits = (q . k^T in float32) * scale, masked to NEG_INF
    m_new  = max(m, rowmax(logits));  alpha = exp(m - m_new)
    p      = exp(logits - m_new);     l = l * alpha + rowsum(p)
    acc    = acc * alpha + cast(p, v.dtype) . v   (float32 accumulation)
    out    = cast(acc / max(l, 1e-30), q.dtype)

with causal (``k <= q + q_offset``) and sliding-window (``k > q + q_offset
- window``) masks.  Layouts are the model's: q ``(B, Sq, H, D)``, k and v
``(B, Sk, KVH, D)`` with ``H`` a multiple of ``KVH`` (GQA: head ``h``
reads KV head ``h // (H // KVH)`` in place).  Unlike the TPU kernel, any
``Sq``/``Sk`` is taken: the ragged tail of the last tile is masked.

The kernel has two forms (``csrc/flash_attention.cu``): bf16 inputs with
head_dim 64, 112, 128 or 256 and rows aligned to 16 bytes (every tensor
the model passes) run on the tensor cores (TMA loads into a ring of
128-key tiles, 64-key at head_dim 256, ``wgmma`` products, 128-row q
tiles; head_dim 112 runs at 128, its last 16 columns zero), everything
else on the float32 FMA units (64 x 64 tiles).
``kernel_tiles`` says which tiles a call runs at.

``scale`` defaults to ``1/sqrt(D)`` applied to the float32 logits, the TPU
kernel's semantics.  ``layers.attention.flash_attention`` pre-scales q in
its own dtype instead, as the reference layer does, and passes
``scale=1.0``.

Only the forward is ported: under autograd on the card the kernel
refuses (see ``flash_attention``); the reference's custom VJP comes with
the kernel's backward.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional

import torch

from . import build

SOURCE = "src/repro_torch/csrc/flash_attention.cu"
REPLACES = "src/repro/kernels/flash_attention.py:77"
NEG_INF = -1e30
BLOCK_Q = 64  # the FMA form's tiles (rows of q, rows of k per step)
BLOCK_K = 64
TC_BLOCK_Q = 128  # the tensor-core form's tiles: q rows, and keys by head_dim
# keys a K/V tile by head_dim (``tiles::tc_block_k`` in csrc/flash_tiles.cuh)
TC_BLOCK_K = {64: 128, 112: 128, 128: 128, 256: 64}
HEAD_DIMS = (16, 64, 112, 128, 256)  # head widths the kernel is built for
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (plain calls not counted)


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Sq, H, D) and k, v (B, Sk, KVH, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, _, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         "pair (batch, head_dim, or H not a multiple of KVH)")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise TypeError(f"q, k, v dtypes differ: {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")


def tensor_core_form(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> bool:
    """Does the CUDA kernel run these inputs in its tensor-core form?  bf16,
    head_dim 64, 112, 128 or 256, base addresses and batch/sequence/head strides
    aligned to 16 bytes (what TMA needs to read the rows in place)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TC_BLOCK_K:
        return False
    return all(t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                              for st in t.stride()[:3])
               for t in (q, k, v))


def kernel_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                 ) -> Dict[str, int]:
    """``{block_q, block_k}``: the tiles the CUDA kernel runs these inputs
    at, for holding it against the plain version at its own tiles."""
    if tensor_core_form(q, k, v):
        return dict(block_q=TC_BLOCK_Q, block_k=TC_BLOCK_K[q.shape[-1]])
    return dict(block_q=BLOCK_Q, block_k=BLOCK_K)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None, q_offset: int = 0,
                          block_q: int = BLOCK_Q, block_k: int = BLOCK_K
                          ) -> torch.Tensor:
    """The kernel's arithmetic in PyTorch, tile by tile (``block_q`` x
    ``block_k``; the last tile of each axis may be shorter)."""
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    kf, vf = k.float(), v.float()  # bf16 -> float32 is exact
    for q0 in range(0, Sq, block_q):
        bq = min(block_q, Sq - q0)
        qb = q[:, q0:q0 + bq].float().reshape(B, bq, KVH, G, D)
        q_pos = q_offset + torch.arange(q0, q0 + bq, device=q.device)
        acc = torch.zeros((B, KVH, G, bq, D), dtype=torch.float32,
                          device=q.device)
        m = torch.full((B, KVH, G, bq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        for k0 in range(0, Sk, block_k):
            kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qb, kb) * scale
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            mask = torch.ones((bq, kb.shape[1]), dtype=torch.bool,
                              device=q.device)
            if causal:
                mask &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb)
            acc = acc * alpha[..., None] + pv
            m = m_new
        o = acc / torch.clamp_min(l, 1e-30)[..., None]
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, D).to(q.dtype)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K
                    ) -> torch.Tensor:
    """Attention forward of ``(B, Sq, H, D)`` q over ``(B, Sk, KVH, D)`` k/v.

    CUDA tensors launch the kernel, which tiles as ``kernel_tiles`` says
    whatever ``block_q``/``block_k`` say; CPU tensors take the plain
    version at ``block_q`` x ``block_k``.  Each of q, k, v needs a
    contiguous last axis; the other axes are read through their strides.

    The kernel has no backward yet: on CUDA tensors that autograd would
    differentiate it raises rather than return an output cut off from the
    gradient.  The plain version on the CPU is differentiable.
    """
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset,
                                     block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "the flash-attention kernel has no backward yet (ROADMAP Queue 1 "
            "item 5): train at S <= 1024, where the model takes "
            "full_attention, or run this forward under torch.no_grad()")
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash kernel is built for head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.stride(3) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    if Sk < 1:
        raise ValueError("the flash kernel needs at least one key")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    fn = build.function("flash_attention", "flash_attention_launch",
                        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 9
                        + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 B, Sq, Sk, H, KVH, D, _DTYPES[q.dtype], int(causal),
                 int(window), int(q_offset), float(scale), stream)
    build.check(err, "flash_attention")
    global launches
    launches += 1
    return out
