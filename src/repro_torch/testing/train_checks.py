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
  (2**-8 relative), as F7 allows a whole pass 1 %;
* kernel 5 under autograd: on CUDA tensors that require grad the kernel
  raises rather than return an output cut off from the gradient; under
  ``torch.no_grad()`` it runs.
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


def step_card_against_cpu(cfg, params_card, batch, opt_cfg: OptConfig, *,
                          qat: bool = False) -> Dict[str, Dict[str, float]]:
    """One train step of ``cfg`` on the card's ``params_card`` and on a
    CPU copy; raises unless the loss and grad_norm agree by the rule of
    ``cfg``'s family.  Returns each device's metrics and their relative
    differences."""
    bundle = model_zoo.build(cfg)
    if cfg.family != "lstm":
        loss_rtol, gnorm_rtol = BF16_RTOL, BF16_RTOL
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


def flash_refuses_grad(device) -> str:
    """Kernel 5 on CUDA tensors that require grad raises; under no_grad
    it runs.  Returns the error's message."""
    gen = torch.Generator(device=device).manual_seed(5)
    q, k, v = (torch.randn((1, 64, 2, 64), generator=gen, device=device)
               .to(torch.bfloat16).requires_grad_(True) for _ in range(3))
    try:
        KF.flash_attention(q, k, v)
    except RuntimeError as e:
        message = str(e)
    else:
        raise AssertionError("the flash kernel ran under autograd and "
                             "returned an output without a gradient")
    if "no backward" not in message:
        raise AssertionError(f"unexpected refusal: {message}")
    with torch.no_grad():
        out = KF.flash_attention(q, k, v)
    if out.requires_grad or not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("the flash kernel under no_grad")
    return message
