"""Checks of the train step on the card: one definition for
``chip_smoke.py``'s ``[train]`` phase and the ``gpu`` tests.

Rules (each check names its own):

* card against CPU: one step of ``runtime.train_loop.make_train_step``
  from the same params, optimizer state and batch on the card and on the
  CPU.  The float recurrent LM's loss within ``LOSS_RTOL`` and its global
  gradient norm within ``GNORM_RTOL`` (float32 products in full, TF32 off:
  the two devices sum in other orders, as ``float_checks.card_against_cpu``
  allows a layer 1e-4 of its largest |output|).  Under QAT within
  ``QAT_RTOL`` (loss, grad_norm): an ulp of difference that meets a fake
  quantization rounding tie moves an activation by a whole quantization
  step (ROADMAP F9; ``tests/test_torch_float_lm.py`` holds QAT against
  the reference to 1e-4 and 2 % of each gradient).  The bf16 transformer's
  within ``BF16_RTOL`` of both: its products round to bf16 on the card's
  tensor cores and after a float32 GEMM on the CPU (ROADMAP F8), so a sum
  that lands near a rounding boundary moves an activation by a bf16 ulp
  (2**-8 relative), as F7 allows a whole pass 1 %; with float32 weights
  within ``F32_RTOL`` (past S 1024 the card runs the flash kernels at
  their own tiles, the CPU the plain versions at the reference's chunks:
  float32 sums in other orders);
* flash attention under autograd: ``layers.attention.flash_attention``
  on the card (kernel 5 writing the lse, then the backward kernel: one
  launch each) against the same layer on the CPU (the plain versions at
  the reference's chunks), in float32, where the two sum in other orders
  and round nothing else: the output and dq, dk, dv by
  ``attention_checks.check_close``'s float32 rule.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..kernels import flash_attention as KF
from ..models import model_zoo
from ..optim.optimizers import OptConfig
from ..runtime.train_loop import make_train_step
from .float_checks import params_to

LOSS_RTOL = 1e-5
GNORM_RTOL = 1e-4
QAT_RTOL = (1e-4, 2e-2)
BF16_RTOL = 1e-2
F32_RTOL = 1e-4


def step_card_against_cpu(cfg, params_card, batch, opt_cfg: OptConfig, *,
                          qat: bool = False) -> Dict[str, Dict[str, float]]:
    """One train step of ``cfg`` on the card's ``params_card`` and on a
    CPU copy; raises unless the loss and grad_norm agree by the rule of
    ``cfg``'s family.  Returns each device's metrics and their relative
    differences."""
    bundle = model_zoo.build(cfg)
    if cfg.family != "lstm":
        loss_rtol = gnorm_rtol = (
            F32_RTOL if params_card["embedding"].dtype == torch.float32
            else BF16_RTOL)
    else:
        loss_rtol, gnorm_rtol = QAT_RTOL if qat else (LOSS_RTOL, GNORM_RTOL)
    out = {}
    for name, params in (("card", params_card),
                         ("cpu", params_to(params_card, "cpu"))):
        art = make_train_step(bundle, params["embedding"].device, opt_cfg,
                              qat=qat)
        _, _, m = art.step_fn(params, art.init_opt(params), batch)
        out[name] = {k: float(v) for k, v in m.items()}
    for key, rtol in (("loss", loss_rtol), ("grad_norm", gnorm_rtol)):
        card, cpu = out["card"][key], out["cpu"][key]
        rel = abs(card - cpu) / abs(cpu)
        if not rel <= rtol:
            raise AssertionError(f"{cfg.name}: {key} on the card {card!r} "
                                 f"against {cpu!r} on the CPU, relative "
                                 f"{rel:.3g} over {rtol}")
        out[f"{key}_rel"] = rel
    return out


def flash_grad_card_against_cpu(device) -> Dict[str, float]:
    """The attention layer's forward and gradients under autograd, float32,
    B 1 x S 1100, 8 query heads over 2 KV heads of 128, causal, on the card
    and on the CPU from the same inputs; raises unless kernel 5 and the
    backward kernel each launched once on the card and the results agree.
    Returns the largest |difference| of each."""
    from ..layers import attention as TA
    from .attention_checks import check_close

    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=device)
                     for shape in ((1, 1100, 8, 128), (1, 1100, 2, 128),
                                   (1, 1100, 2, 128), (1, 1100, 8, 128)))
    out = {}
    for dev in (device, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        before = (KF.launches, KF.backward.launches)
        o = TA.flash_attention(*leaves)
        grads = torch.autograd.grad(o, leaves, dout.to(dev))
        launched = (KF.launches - before[0], KF.backward.launches - before[1])
        if launched != ((1, 1) if dev.type == "cuda" else (0, 0)):
            raise AssertionError(f"flash attention under autograd on {dev} "
                                 f"launched (forward, backward) {launched}")
        out[dev.type] = (o.detach(),) + grads
    return {name: check_close(f"flash attention {name}, card vs CPU",
                              got.cpu(), want)
            for name, got, want in zip(("out", "dq", "dk", "dv"),
                                       out["cuda"], out["cpu"])}
