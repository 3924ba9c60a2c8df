"""The flash kernel's check cases and the float tolerances of the
transformer path: one definition for ``chip_smoke.py``, the ``gpu`` tests
and the CPU parity tests.

Tolerances (each check names its rule):

* float32 outputs: ``|got - want| <= 2e-5 + 2e-5 |want|`` (the reference's
  own rule for its Pallas kernel, ``tests/test_kernels.py``);
* bf16 outputs: ``|got - want| <= 2`` bf16 ulps of the row's largest
  ``|want|`` (ROADMAP Queue 3, F3), a row being the last axis;
* logits of a whole bf16 model: within 1 % of the row's largest
  ``|logit|``, and the argmax equal wherever the reference's top-2 margin
  exceeds 2 % of it.  Where the reference itself spreads wider (a long
  sequence, a deep model: bf16 roundings that flip with the float32
  summation order, compounded layer by layer), the caller measures that
  spread and passes a wider ``limit``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

# (B, H, KVH, S, D); S = 1100 (and 300) is ragged for any power-of-two tile
FLASH_SHAPES = ((2, 4, 4, 256, 64), (1, 32, 8, 1100, 128),
                (2, 32, 8, 4096, 128))
FLASH_MASKS = (("causal", True, 0), ("non-causal", False, 0),
               ("causal window 64", True, 64))
# head_dim 256 (recurrentgemma's MQA layers: 16 query heads over one KV
# head), with a window whose edge falls inside the 64-key tiles
FLASH_SHAPES_D256 = ((2, 4, 2, 300, 256), (1, 16, 1, 1100, 256))
FLASH_MASKS_D256 = FLASH_MASKS + (("causal window 300", True, 300),)
# head_dim 112 (kimi's GQA layers: 64 query heads over 8 KV heads), the
# tensor-core form reading 128 columns a row, the last 16 zero: a ragged
# shape and kimi's prefill layer (both with the masks of head_dim 256)
FLASH_SHAPES_D112 = ((2, 4, 2, 300, 112), (1, 64, 8, 2048, 112))
FLASH_DTYPES = (torch.float32, torch.bfloat16)


def unaligned(t: torch.Tensor) -> torch.Tensor:
    """The same values in rows that start one element past an aligned
    address (a view with a contiguous last axis), which the flash kernel
    runs in its FMA form."""
    pad = torch.empty(t.shape[:-1] + (t.shape[-1] + 1,), dtype=t.dtype,
                      device=t.device)
    view = pad[..., 1:]
    view.copy_(t)
    return view


def flash_cases(gen: torch.Generator, shapes=FLASH_SHAPES, masks=FLASH_MASKS
                ) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """``(label, kwargs)`` for ``flash_attention`` and its plain version:
    every shape x dtype x (the kernel's own scale, or q pre-scaled in its
    dtype as the model's layer does, with ``scale=1``) x mask, and per
    shape one bf16 causal case with unaligned rows (bf16 with aligned rows
    and head_dim 64, 112, 128 or 256 runs the kernel's tensor-core form,
    everything else its FMA form)."""
    dev = gen.device
    for B, H, KVH, S, D in shapes:
        q = torch.randn((B, S, H, D), generator=gen, device=dev).bfloat16()
        k = torch.randn((B, S, KVH, D), generator=gen, device=dev).bfloat16()
        yield (f"B{B} H{H} KVH{KVH} S{S} D{D} bfloat16 unaligned rows causal",
               dict(q=unaligned(q), k=unaligned(k), v=unaligned(k.flip(1)),
                    causal=True, window=0, scale=None))
        for dtype in FLASH_DTYPES:
            q = torch.randn((B, S, H, D), generator=gen, device=dev)
            k = torch.randn((B, S, KVH, D), generator=gen, device=dev)
            v = torch.randn((B, S, KVH, D), generator=gen, device=dev)
            k, v = k.to(dtype), v.to(dtype)
            for prescale in (False, True):
                if prescale:
                    qq, scale = (q / math.sqrt(D)).to(dtype), 1.0
                else:
                    qq, scale = q.to(dtype), None
                for mask, causal, window in masks:
                    label = (f"B{B} H{H} KVH{KVH} S{S} D{D} "
                             f"{str(dtype).split('.')[-1]} "
                             f"{'pre-scaled' if prescale else 'scale'} {mask}")
                    yield label, dict(q=qq, k=k, v=v, causal=causal,
                                      window=window, scale=scale)


def bf16_bound(want: torch.Tensor, ulps: int = 2) -> torch.Tensor:
    """``ulps`` bf16 ulps of each row's largest ``|want|`` (8 bits)."""
    top = want.float().abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return ulps * torch.exp2(torch.floor(torch.log2(top)) - 7)


def check_close(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Hold ``got`` to ``want`` by the rule of their dtype (float32 or
    bf16); raise AssertionError, else return the largest |difference|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if want.dtype == torch.bfloat16:
        bound = bf16_bound(want).expand_as(diff)
    else:
        bound = 2e-5 + 2e-5 * w.abs()
    bad = ~(diff <= bound)  # NaN counts as bad
    if bool(bad.any()):
        idx = tuple(int(i) for i in torch.nonzero(bad)[0])
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {diff.numel()} elements out of "
            f"tolerance; first at {idx}: {g[idx].item()} vs {w[idx].item()} "
            f"(bound {bound[idx].item():.3g})")
    return float(diff.max()) if diff.numel() else 0.0


def logit_spread(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| over its row's largest |want|."""
    g, w = got.float(), want.float()
    top = w.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((g - w).abs() / top).max())


def check_logits(what: str, got: torch.Tensor, want: torch.Tensor,
                 limit: float = 0.01) -> float:
    """Whole-model logits ``(..., vocab)``: within ``limit`` (1 %) of the
    row's largest ``|want|``; argmax equal where ``want``'s top-2 margin
    exceeds 2 % of it.  Returns ``logit_spread(got, want)``."""
    g, w = got.float(), want.float()
    top = w.abs().amax(-1, keepdim=True)
    worst = logit_spread(got, want)
    if not worst <= limit:
        raise AssertionError(f"{what}: a logit differs by {worst:.4f} of its "
                             f"row's largest |logit| (limit {limit:.4f})")
    two = torch.topk(w, 2, dim=-1).values
    clear = (two[..., 0] - two[..., 1]) > 0.02 * top[..., 0]
    if not torch.equal(g.argmax(-1)[clear], w.argmax(-1)[clear]):
        raise AssertionError(f"{what}: argmax differs where the reference's "
                             "top-2 margin exceeds 2 % of the row's max")
    return worst
