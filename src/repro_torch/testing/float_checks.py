"""Checks of the float recurrent LM and of fake quantization on the card:
one definition for ``chip_smoke.py``'s ``[float]`` phase and the ``gpu``
tests.

Rules (each check names its own):

* decode against forward: teacher-forcing a prompt through
  ``lstm_lm.decode_step`` gives ``forward``'s last-position logits within
  2 bf16 ulps of the row's largest |logit| (ROADMAP F3);
* card against CPU: on the same weights, each layer's float32 output
  within ``CARD_CPU_RTOL`` of that layer's largest |output| on the CPU,
  and the logits by F3.  Float32 products stay float32 (TF32 off, as
  PyTorch leaves it).  On the CPU at full width (3 layers, B 4, T 4) the
  float32 stack sits 1-3e-6 of the layer's largest |output| from a
  float64 run, slowly growing with depth; two float32 runs summing in
  other orders may each sit that far;
* fake quantization: bit for bit on the card and on the CPU, the same
  float32 operations in the same order (``core/fake_quant.py`` divides by
  tensors for this).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from .. import tree_util as tu
from ..core import fake_quant as fq
from ..layers import embedding as emb
from ..models import lstm_lm
from .attention_checks import bf16_bound

CARD_CPU_RTOL = 1e-4


def layer_outputs(params, cfg, tokens: torch.Tensor
                  ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """The float stack over ``tokens`` layer by layer: ``([ys of each
    layer], bf16 logits)``, as ``lstm_lm.forward`` computes them."""
    outs = []
    with torch.no_grad():
        x = emb.embed_tokens(params, tokens).to(torch.float32)
        for p, lc in zip(params["lstm"], lstm_lm.layer_cfgs(cfg)):
            x, _ = lstm_lm._float_layer(p, lc, x, None, None, False)
            outs.append(x)
        logits = emb.logits_head(params, x.to(torch.bfloat16))
    return outs, logits


def check_logits_f3(what: str, got: torch.Tensor, want: torch.Tensor
                    ) -> float:
    """F3: |got - want| within 2 bf16 ulps of the row's largest |want|;
    returns the largest |difference| in bf16 ulps of its row's largest
    |want|."""
    d = (got.float() - want.float()).abs()
    bound = bf16_bound(want)
    if not bool((d <= bound).all()):
        raise AssertionError(f"{what}: logits off by {float(d.max()):.4g}, "
                             f"beyond 2 bf16 ulps of the row's largest "
                             f"|logit|")
    return float((d / bound * 2).max())  # in bf16 ulps of the row's max


def decode_against_forward(params, cfg, prompt: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(last logits of the prompt teacher-forced through decode_step,
    forward's last-position logits)``."""
    with torch.no_grad():
        state = lstm_lm.init_decode_state(cfg, prompt.shape[0],
                                          device=prompt.device)
        for t in range(prompt.shape[1]):
            logits, state = lstm_lm.decode_step(params, cfg,
                                                prompt[:, t:t + 1], state)
        return logits, lstm_lm.prefill(params, cfg, prompt)


def card_against_cpu(params_card, params_cpu, cfg, tokens: torch.Tensor
                     ) -> Dict[str, float]:
    """Hold the float stack on the card to the same stack on the CPU:
    every layer within ``CARD_CPU_RTOL`` of its largest |output|, the
    logits by F3.  Returns each layer's largest |difference| over its
    largest |output|, and the logits' in bf16 ulps."""
    got, got_logits = layer_outputs(
        params_card, cfg, tokens.to(params_card["embedding"].device))
    want, want_logits = layer_outputs(params_cpu, cfg, tokens.cpu())
    out = {}
    for i, (g, w) in enumerate(zip(got, want, strict=True)):
        rel = float((g.cpu() - w).abs().max() / w.abs().max())
        if not rel <= CARD_CPU_RTOL:
            raise AssertionError(f"layer {i}: card and CPU differ by {rel:.3g}"
                                 f" of the layer's largest |output|, over "
                                 f"{CARD_CPU_RTOL}")
        out[f"layer {i}"] = rel
    out["logits_ulps"] = check_logits_f3("logits", got_logits.cpu(),
                                         want_logits)
    return out


def params_to(params, device):
    """A copy of a param tree on ``device``."""
    return tu.tree_map(lambda t: t.to(device), params)


def fake_quant_cases(gen: torch.Generator, device, n: int = 1000
                     ) -> List[Tuple[str, Callable, torch.Tensor]]:
    """``(name, function, x)`` at n x n values drawn on ``gen``: every
    fake-quant form the QAT graph uses, per-channel too."""
    x = torch.randn((n, n), generator=gen, device=gen.device) * 3
    w = torch.randn((n, n), generator=gen, device=gen.device) * 0.05
    x, w = x.to(device), w.to(device)
    return [
        ("asymmetric 8", lambda t: fq.fake_quant_asymmetric(t, 8), x),
        ("asymmetric 16", lambda t: fq.fake_quant_asymmetric(t, 16), x),
        ("symmetric 8", lambda t: fq.fake_quant_symmetric(t, 8), w),
        ("symmetric 16 pot", lambda t: fq.fake_quant_symmetric(
            t, 16, pot=True), x),
        ("symmetric 8 per channel", lambda t: fq.fake_quant_symmetric(
            t, 8, per_channel_axis=1), w),
        ("symmetric 8 pot per row", lambda t: fq.fake_quant_symmetric(
            t, 8, per_channel_axis=0, pot=True), x),
        ("q3.12", lambda t: fq.fake_quant_q(t, 12), x),
    ]


def fake_quant_card_against_cpu(gen: torch.Generator, device, n: int = 1000
                                ) -> int:
    """Every case of ``fake_quant_cases`` on the card equals the same call
    on the CPU bit for bit; returns the number of values compared."""
    count = 0
    for name, fn, x in fake_quant_cases(gen, device, n):
        got = fn(x).cpu()
        want = fn(x.cpu())
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"fake quant {name}: {bad} of {x.numel()} "
                                 "values differ between card and CPU")
        count += x.numel()
    return count
