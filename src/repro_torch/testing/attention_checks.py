"""The flash kernel's check cases and the float tolerances of the
transformer path: one definition for ``chip_smoke.py``, the ``gpu`` tests
and the CPU parity tests.

Tolerances (each check names its rule):

* float32 outputs: ``|got - want| <= 2e-5 + 2e-5 |want|`` (the reference's
  own rule for its Pallas kernel, ``tests/test_kernels.py``);
* bf16 outputs: ``|got - want| <= 2`` bf16 ulps of the row's largest
  ``|want|`` (ROADMAP Queue 3, F3), a row being the last axis;
* the flash backward's gradients (``check_flash_bwd``, its kernel against
  its plain version at the reference's 512-row chunks) by the same two
  rules, a bf16 row's largest ``|want|`` taken as at least ``2**-12`` of
  the whole gradient's (``grad_bound``): a query that attends a single key
  has ``dp = delta`` in exact arithmetic, so its dq row is 0 and the two
  versions' float32 rounding noise is all there is (on an H100, ~5e-7 in
  the plain version at qwen3-4b's layer, whose dq peaks at ~3: 2 ulps of
  such a row's own largest |want| are ~5e-10); kernel 5's row
  log-sum-exp, float32, by the float32 rule;
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


# the flash backward's check cases: (label, B, Sq, Sk, H, KVH, D, causal,
# window, q_offset, dtype, layout).  The training layers of the models
# that take flash attention past S 1024 (qwen3-4b, recurrentgemma-9b with
# its window, stablelm-1.6b, kimi-k2-1t-a32b at head_dim 112), then small
# float32 and bf16 cases: head_dim 16, queries at an offset over more keys
# (Sq != Sk), lengths that are no multiple of any tile, q, k, v as strided
# views of one fused projection, and unaligned rows (the FMA forms of
# kernel 5 and of the backward); the bf16 cases at head_dim 64 to 256 with
# aligned rows run the backward's tensor-core form, among them a window
# edge inside a 64-key tile at a ragged length (head_dim 256, where its
# warpgroups split the columns) and queries at an offset over more keys
FLASH_BWD_MODEL_CASES = (
    ("qwen3-4b", 1, 4096, 4096, 32, 8, 128, True, 0, 0, torch.bfloat16,
     "contiguous"),
    ("recurrentgemma-9b", 1, 4096, 4096, 16, 1, 256, True, 2048, 0,
     torch.bfloat16, "contiguous"),
    ("stablelm-1.6b", 1, 2048, 2048, 32, 32, 64, True, 0, 0, torch.bfloat16,
     "contiguous"),
    ("kimi-k2-1t-a32b", 1, 2048, 2048, 64, 8, 112, True, 0, 0,
     torch.bfloat16, "contiguous"),
)
FLASH_BWD_SMALL_CASES = (
    ("D16 float32", 2, 300, 300, 4, 2, 16, True, 0, 0, torch.float32,
     "contiguous"),
    ("offset window float32", 1, 200, 456, 4, 1, 64, True, 100, 256,
     torch.float32, "contiguous"),
    ("non-causal ragged float32", 1, 333, 333, 4, 2, 128, False, 0, 0,
     torch.float32, "contiguous"),
    ("D256 window float32", 1, 300, 300, 4, 2, 256, True, 70, 0,
     torch.float32, "contiguous"),
    ("D112 ragged bf16", 1, 300, 300, 4, 2, 112, True, 0, 0, torch.bfloat16,
     "contiguous"),
    ("D16 offset window bf16", 1, 100, 177, 4, 4, 16, True, 40, 77,
     torch.bfloat16, "contiguous"),
    ("D128 strided bf16", 2, 333, 333, 8, 2, 128, True, 0, 0,
     torch.bfloat16, "strided"),
    ("D64 unaligned bf16", 1, 300, 300, 4, 2, 64, True, 0, 0,
     torch.bfloat16, "unaligned"),
    ("D256 window ragged bf16", 1, 300, 300, 4, 1, 256, True, 70, 0,
     torch.bfloat16, "contiguous"),
    ("D128 offset window bf16", 1, 200, 456, 4, 1, 128, True, 100, 256,
     torch.bfloat16, "contiguous"),
)


def flash_bwd_inputs(gen: torch.Generator, case) -> Dict[str, Any]:
    """``q, k, v, dout`` (normal draws from ``gen``) and the mask of a
    ``FLASH_BWD_*_CASES`` case, laid out as it says."""
    _, B, Sq, Sk, H, KVH, D, causal, window, q_offset, dtype, layout = case
    dev = gen.device
    if layout == "strided":  # slices of one fused (B, S, H + 2 KVH, D)
        qkv = torch.randn((B, Sq, H + 2 * KVH, D), generator=gen,
                          device=dev).to(dtype)
        q, k, v = qkv.split([H, KVH, KVH], dim=2)
    else:
        q, k, v = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                   for shape in ((B, Sq, H, D), (B, Sk, KVH, D),
                                 (B, Sk, KVH, D)))
        if layout == "unaligned":
            q, k, v = unaligned(q), unaligned(k), unaligned(v)
    dout = torch.randn((B, Sq, H, D), generator=gen, device=dev).to(dtype)
    return dict(q=q, k=k, v=v, dout=dout, causal=causal, window=window,
                q_offset=q_offset)


def check_flash_bwd(label: str, q, k, v, dout, causal: bool, window: int,
                    q_offset: int) -> Dict[str, Any]:
    """Kernel 5's forward with ``return_lse`` on q pre-scaled in its dtype
    (as the layer runs it), then the backward kernel, each against its
    plain version on the same inputs: the lse at kernel 5's own tiles by
    the float32 rule, dq, dk, dv at the reference's chunks by the rule of
    their dtype (bf16: ``grad_bound``), the backward at each of
    ``bwd_splits`` (its dk/dv kernel unsplit, and at the card's head
    splits), each launched twice, the two calls' gradients equal bit for
    bit.  Returns ``lse_err`` and ``grad_err`` (the largest |d|), the
    ``splits`` run, the ``launches`` made and the form and tiles the
    backward took (``flash_attention.backward_tiles``)."""
    from ..kernels import flash_attention as FA

    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qs = (q.float() * scale).to(q.dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = FA.flash_attention(qs, k, v, scale=1.0, return_lse=True, **kw)
    _, want_lse = FA.flash_attention_plain(
        qs, k, v, scale=1.0, return_lse=True, **kw,
        **FA.kernel_tiles(qs, k, v))
    lse_err = check_close(f"{label} lse", lse, want_lse)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout, scale=scale,
                                        **kw)
    tiles = FA.backward_tiles(q, k, v, out, dout)
    splits = bwd_splits(q, k, tiles["dkdv_keys"])
    grad_err = 0.0
    for n in splits:
        got = FA.flash_attention_bwd(q, k, v, out, lse, dout, scale=scale,
                                     splits=n, **kw)
        again = FA.flash_attention_bwd(q, k, v, out, lse, dout, scale=scale,
                                       splits=n, **kw)
        for name, g, g2 in zip("qkv", got, again):
            if not torch.equal(g.view(torch.uint8), g2.view(torch.uint8)):
                raise AssertionError(f"{label} splits {n} d{name}: two calls "
                                     "on the same inputs differ")
        grad_err = max([grad_err] + [
            check_close(f"{label} splits {n} d{name}", g, w, grad=True)
            for name, g, w in zip("qkv", got, want)])
    return dict(lse_err=lse_err, grad_err=grad_err, splits=splits,
                launches=2 * len(splits), **tiles)


def bwd_splits(q: torch.Tensor, k: torch.Tensor, block_k: int
               ) -> Tuple[int, ...]:
    """The head splits ``check_flash_bwd`` runs the backward kernel at: 1,
    and the card's own (``flash_attention.dkdv_splits`` for dk/dv CTAs of
    ``block_k`` keys) where it differs."""
    from ..kernels import flash_attention as FA

    B, _, H, _ = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    auto = FA.dkdv_splits(B, Sk, KVH, H // KVH, block_k, torch.cuda.
                          get_device_properties(q.device).multi_processor_count)
    return (1,) if auto == 1 else (1, auto)


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


def grad_bound(want: torch.Tensor, ulps: int = 2) -> torch.Tensor:
    """``bf16_bound`` of a gradient: each row's largest ``|want|`` taken as
    at least ``2**-12`` of the whole tensor's."""
    w = want.float().abs()
    top = w.amax(-1, keepdim=True).clamp_min(
        float(w.max()) * 2.0**-12).clamp_min(1e-30)
    return ulps * torch.exp2(torch.floor(torch.log2(top)) - 7)


def check_close(what: str, got: torch.Tensor, want: torch.Tensor,
                grad: bool = False) -> float:
    """Hold ``got`` to ``want`` by the rule of their dtype (float32 or
    bf16; ``grad`` takes ``grad_bound`` for bf16); raise AssertionError,
    else return the largest |difference|."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    if want.dtype == torch.bfloat16:
        bound = (grad_bound(want) if grad else bf16_bound(want)).expand_as(
            diff)
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
