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
``scale=1.0``.  With ``return_lse=True`` both also return each row's
log-sum-exp, float32 ``(B, Sq, H)``: ``m + log(max(l, 1e-30))``, what the
reference's ``_flash_fwd_impl`` saves for its backward.

The backward (``flash_attention_bwd``: ``csrc/flash_attention_bwd.cu`` on
CUDA tensors, ``flash_attention_bwd_plain`` on CPU tensors) is the
reference's custom VJP, ``_flash_bwd`` in ``repro.layers.attention``, which
the reference runs in XLA: no TPU kernel stands behind it.  It is written
by hand because its forward is.  From the saved ``(q, k, v, out, lse)`` and
the output's gradient ``dout``, per (q tile, k tile), in float32:

    delta = rowsum(dout * out);  qf = q * scale (float32, unrounded)
    p  = exp(qf . k^T - lse), masked to exp(NEG_INF - lse)
    dp = dout . v^T;  ds = p * (dp - delta)
    dq = ds . k * scale;  dk = ds^T . qf;  dv = p^T . dout

dk and dv sum over the ``H // KVH`` query heads of a KV head in float32 and
round once.  The kernel has two forms, chosen by the inputs alone
(``backward_tensor_core_form``): bf16 with head_dim 64, 112, 128 or 256
and q, k, v, out and dout rows aligned to 16 bytes run on the tensor cores
(``wgmma``, p and ds rounded to bf16 for the three gradient products, as
FlashAttention-2/3 and SDPA's backward do; ``backward_tiles``), everything
else on the float32 FMA units with p and ds in float32.  The autograd
boundary is ``layers.attention.FlashAttention``;
nothing else runs the forward kernel under autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Dict, Optional, Tuple

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
# the backward's tensor-core form by head_dim (``tiles::tc_bwd_*`` in
# csrc/flash_tiles.cuh): keys a dk/dv CTA holds and q rows a step of it, q
# rows a dq CTA holds and keys a step of it
TC_BWD_TILES = {64: (128, 128, 128, 128), 112: (128, 64, 128, 128),
                128: (128, 64, 128, 128), 256: (64, 64, 64, 64)}
TC_BWD_SEQ_PAD = 128  # its lse and delta rows: Sq rounded up to this
# the backward's dk/dv kernel splits a KV head's query heads where its CTAs
# would not fill one wave of the card's SMs, into enough to fill this many
# waves (``dkdv_splits``).  On an H100 (``chip_smoke.time_flash_bwd``):
# the tensor-core form at recurrentgemma-9b's layer (64 CTAs) 2.66 ms
# unsplit, 1.67 / 1.62 / 1.47 / 1.55 at 2 / 4 / 8 / 16 splits, at
# qwen3-4b's (256) 1.79 unsplit, 1.85 / 1.89 at 2 / 4; the FMA form at
# recurrentgemma's (128) 30.0 unsplit, 26.3 at 4, at qwen3-4b's (512) 20.3
# unsplit, 20.4 at 2
DKDV_WAVES = 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches = 0  # kernel launches since the last reset (plain calls not counted)


@dataclasses.dataclass
class KernelRecord:
    """The source, the replaced function and the launch counter of the
    second kernel this module wraps (``serve.KERNELS`` reads
    ``.launches``)."""
    SOURCE: str
    REPLACES: str
    launches: int = 0


# the backward: the reference's custom VJP, which XLA runs (no TPU kernel)
backward = KernelRecord("src/repro_torch/csrc/flash_attention_bwd.cu",
                        "src/repro/layers/attention.py:180")


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


def _rows_aligned(t: torch.Tensor) -> bool:
    """Can TMA read ``t``'s rows in place?  Base and batch/sequence/head
    strides aligned to 16 bytes (bf16)."""
    return t.data_ptr() % 16 == 0 and all(st % 8 == 0
                                          for st in t.stride()[:3])


def tensor_core_form(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> bool:
    """Does the CUDA kernel run these inputs in its tensor-core form?  bf16,
    head_dim 64, 112, 128 or 256, base addresses and batch/sequence/head strides
    aligned to 16 bytes (what TMA needs to read the rows in place)."""
    if q.dtype != torch.bfloat16 or q.shape[-1] not in TC_BLOCK_K:
        return False
    return all(_rows_aligned(t) for t in (q, k, v))


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
                          block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                          return_lse: bool = False):
    """The kernel's arithmetic in PyTorch, tile by tile (``block_q`` x
    ``block_k``; the last tile of each axis may be shorter); with
    ``return_lse`` also each row's log-sum-exp ``(B, Sq, H)``."""
    _check_shapes(q, k, v)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    out = torch.empty_like(q)
    lse = torch.empty((B, Sq, H), dtype=torch.float32, device=q.device)
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
            mask = _tile_mask(q_pos, k0, kb.shape[1], causal, window)
            logits = torch.where(mask, logits, NEG_INF)
            m_new = torch.maximum(m, logits.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new[..., None])
            l = l * alpha + p.sum(-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb)
            acc = acc * alpha[..., None] + pv
            m = m_new
        l_safe = torch.clamp_min(l, 1e-30)
        o = acc / l_safe[..., None]
        out[:, q0:q0 + bq] = o.permute(0, 3, 1, 2, 4).reshape(
            B, bq, H, D).to(q.dtype)
        lse[:, q0:q0 + bq] = (m + torch.log(l_safe)).permute(
            0, 3, 1, 2).reshape(B, bq, H)
    return (out, lse) if return_lse else out


def _tile_mask(q_pos: torch.Tensor, k0: int, bk: int, causal: bool,
               window: int) -> torch.Tensor:
    """(bq, bk) boolean mask of the keys ``k0..k0 + bk`` for the rows at
    positions ``q_pos``: True = attend."""
    k_pos = torch.arange(k0, k0 + bk, device=q_pos.device)
    mask = torch.ones((q_pos.shape[0], bk), dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None, q_offset: int = 0,
                    block_q: int = BLOCK_Q, block_k: int = BLOCK_K,
                    return_lse: bool = False):
    """Attention forward of ``(B, Sq, H, D)`` q over ``(B, Sk, KVH, D)`` k/v
    (and, with ``return_lse``, each row's float32 log-sum-exp ``(B, Sq,
    H)``).

    CUDA tensors launch the kernel, which tiles as ``kernel_tiles`` says
    whatever ``block_q``/``block_k`` say; CPU tensors take the plain
    version at ``block_q`` x ``block_k``.  Each of q, k, v needs a
    contiguous last axis; the other axes are read through their strides.
    The kernel's output carries no gradient: ``layers.attention.
    FlashAttention`` is the autograd boundary around it.
    """
    if q.device.type != "cuda":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_offset=q_offset,
                                     block_q=block_q, block_k=block_k,
                                     return_lse=return_lse)
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
    lse = (torch.empty((B, Sq, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    fn = build.function("flash_attention", "flash_attention_launch",
                        [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 9
                        + [ctypes.c_int] * 10
                        + [ctypes.c_float, ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 B, Sq, Sk, H, KVH, D, _DTYPES[q.dtype], int(causal),
                 int(window), int(q_offset), float(scale), stream)
    build.check(err, "flash_attention")
    global launches
    launches += 1
    return (out, lse) if return_lse else out


def _check_backward(q, k, v, out, lse, dout):
    _check_shapes(q, k, v)
    B, Sq, H, _ = q.shape
    for name, t in (("out", out), ("dout", dout)):
        if t.shape != q.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
    if out.dtype != q.dtype:
        raise TypeError(f"out is {out.dtype}, q {q.dtype}")
    if tuple(lse.shape) != (B, Sq, H) or lse.dtype != torch.float32:
        raise ValueError(f"lse must be float32 {(B, Sq, H)}, got "
                         f"{lse.dtype}{tuple(lse.shape)}")


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              lse: torch.Tensor, dout: torch.Tensor, *,
                              causal: bool = True, window: int = 0,
                              scale: Optional[float] = None,
                              q_offset: int = 0, block_q: int = 512,
                              block_k: int = 512
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(dq, dk, dv)`` of attention at the saved ``(q, k, v, out, lse)``,
    the reference's ``_flash_bwd`` op for op over ``block_q`` x ``block_k``
    chunks (the last of each axis may be shorter), every chunk visited.  q
    is unscaled; ``q * scale`` enters the logits in float32.  dk and dv
    sum a KV head's query heads in float32 and round once."""
    _check_backward(q, k, v, out, lse, dout)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    dev = q.device
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dout_f = dout.float()
    delta = torch.einsum("bqhd,bqhd->bqh", dout_f, out.float())
    kf, vf = k.float(), v.float()
    dq = torch.empty((B, Sq, H, D), dtype=torch.float32, device=dev)
    dk = torch.zeros((B, Sk, KVH, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    for q0 in range(0, Sq, block_q):
        bq = min(block_q, Sq - q0)
        qf = q[:, q0:q0 + bq].float().reshape(B, bq, KVH, G, D) * scale
        do = dout_f[:, q0:q0 + bq].reshape(B, bq, KVH, G, D)
        lse_b = lse[:, q0:q0 + bq].reshape(B, bq, KVH, G).permute(0, 2, 3, 1)
        dl_b = delta[:, q0:q0 + bq].reshape(B, bq, KVH, G).permute(
            0, 2, 3, 1)
        q_pos = q_offset + torch.arange(q0, q0 + bq, device=dev)
        dq_acc = torch.zeros((B, bq, KVH, G, D), dtype=torch.float32,
                             device=dev)
        for k0 in range(0, Sk, block_k):
            kb, vb = kf[:, k0:k0 + block_k], vf[:, k0:k0 + block_k]
            logits = torch.einsum("bqkgd,bskd->bkgqs", qf, kb)
            mask = _tile_mask(q_pos, k0, kb.shape[1], causal, window)
            logits = torch.where(mask, logits, NEG_INF)
            p = torch.exp(logits - lse_b[..., None])
            dp = torch.einsum("bqkgd,bskd->bkgqs", do, vb)
            ds = p * (dp - dl_b[..., None])
            dq_acc = dq_acc + torch.einsum("bkgqs,bskd->bqkgd", ds,
                                           kb) * scale
            dk[:, k0:k0 + block_k] += torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                   qf)
            dv[:, k0:k0 + block_k] += torch.einsum("bkgqs,bqkgd->bskd", p,
                                                   do)
        dq[:, q0:q0 + bq] = dq_acc.reshape(B, bq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def backward_tensor_core_form(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, out: torch.Tensor,
                              dout: torch.Tensor) -> bool:
    """Does the backward kernel run these inputs in its tensor-core form?
    What ``tensor_core_form`` asks of q, k and v, and of out and dout."""
    return tensor_core_form(q, k, v) and _rows_aligned(out) and \
        _rows_aligned(dout)


def backward_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, dout: torch.Tensor) -> Dict[str, int]:
    """The backward kernel's form and tiles for these inputs:
    ``tensor_cores`` (0 or 1), ``dkdv_keys`` and ``dkdv_rows`` (keys a dk/dv
    CTA holds, q rows a step of it), ``dq_rows`` and ``dq_keys``."""
    D = q.shape[-1]
    tc = backward_tensor_core_form(q, k, v, out, dout)
    tiles = TC_BWD_TILES[D] if tc else (32 if D > 128 else 64,) * 4
    return dict(tensor_cores=int(tc), **dict(zip(
        ("dkdv_keys", "dkdv_rows", "dq_rows", "dq_keys"), tiles)))


def dkdv_splits(B: int, Sk: int, KVH: int, G: int, block_k: int, sms: int
                ) -> int:
    """How many ways the backward kernel splits a KV head's ``G`` query
    heads for dk and dv, its CTAs holding ``block_k`` keys each
    (``backward_tiles``' ``dkdv_keys``): 1 where its (key tile, KV head,
    batch) CTAs fill a wave of ``sms`` SMs (one CTA an SM), else the least
    divisor of ``G`` (every split takes as many heads) that fills
    ``DKDV_WAVES`` waves, at most ``G``."""
    base = -(-Sk // block_k) * KVH * B
    if base >= sms:
        return 1
    need = -(-DKDV_WAVES * sms // base)
    return next(n for n in range(1, G + 1) if G % n == 0 and
                (n >= need or n == G))


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, scale: Optional[float] = None,
                        q_offset: int = 0, block_q: int = 512,
                        block_k: int = 512, splits: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` from the forward's saved ``(q, k, v, out, lse)``
    and ``dout``.  CUDA tensors launch ``csrc/flash_attention_bwd.cu`` in
    the form and at the tiles ``backward_tiles`` says, whatever
    ``block_q``/``block_k`` say (``splits`` the head splits of its dk/dv
    kernel, by default ``dkdv_splits`` for the card); CPU
    tensors take ``flash_attention_bwd_plain`` at ``block_q`` x
    ``block_k``.  q, k, v, out and dout need a contiguous last axis (the
    other axes are read through their strides); lse is contiguous."""
    if q.device.type != "cuda":
        return flash_attention_bwd_plain(
            q, k, v, out, lse, dout, causal=causal, window=window,
            scale=scale, q_offset=q_offset, block_q=block_q,
            block_k=block_k)
    _check_backward(q, k, v, out, lse, dout)
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    dev = q.device
    if q.dtype not in _DTYPES:
        raise TypeError(f"the flash backward takes float32 or bfloat16, "
                        f"got {q.dtype}")
    if D not in HEAD_DIMS:
        raise ValueError(f"the flash backward is built for head_dim in "
                         f"{HEAD_DIMS}, got {D}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("lse", lse)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} needs a contiguous last axis")
    if not lse.is_contiguous():
        raise ValueError("lse must be contiguous")
    if Sk < 1:
        raise ValueError("the flash backward needs at least one key")
    scale = 1.0 / math.sqrt(D) if scale is None else scale
    dq = torch.empty((B, Sq, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, Sk, KVH, D), dtype=k.dtype, device=dev)
    dv = torch.empty_like(dk)
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    G = H // KVH
    tiles = backward_tiles(q, k, v, out, dout)
    if splits is None:
        splits = dkdv_splits(B, Sk, KVH, G, tiles["dkdv_keys"],
                             torch.cuda.get_device_properties(
                                 dev).multi_processor_count)
    if not 1 <= splits <= G:
        raise ValueError(f"splits must be in 1 .. H // KVH = {G}, got "
                         f"{splits}")
    # delta (B, Sq, H) in the FMA form; lse and delta per head, padded, in
    # the tensor-core form's stages
    delta = torch.empty((2, B, H, -(-Sq // TC_BWD_SEQ_PAD) * TC_BWD_SEQ_PAD),
                        dtype=torch.float32, device=dev)
    part = (torch.empty((2, splits, B, Sk, KVH, D), dtype=torch.float32,
                        device=dev) if splits > 1 else None)
    ptrs = (ctypes.c_void_p * 11)(*[t.data_ptr() for t in (
        q, k, v, out, dout, lse, delta, dq, dk, dv)],
        None if part is None else part.data_ptr())
    vals = (ctypes.c_longlong * 27)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3], *dout.stride()[:3],
        B, Sq, Sk, H, KVH, D, _DTYPES[q.dtype], int(causal), int(window),
        int(q_offset), splits, tiles["tensor_cores"])
    fn = build.function("flash_attention_bwd", "flash_attention_bwd_launch",
                        [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
                         ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(vals),
                 float(scale), stream)
    build.check(err, "flash_attention_bwd")
    backward.launches += 1
    return dq, dk, dv
