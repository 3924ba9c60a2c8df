"""Optimizers: AdamW (float32 moments) and Adafactor (factored second
moment), with global-norm clipping and a warmup-cosine schedule.

Port of ``repro.optim.optimizers``: plain functions over the port's
parameter trees (``repro_torch.tree_util``), not ``torch.optim``, whose
update order and decay rules differ.  The reference's rules hold here:

* clipping to the global norm runs before the moments;
* weight decay applies to leaves of two or more dimensions only, added to
  the step;
* a bf16 leaf is updated in float32 and rounded back to bf16;
* the schedule and the bias corrections are float32 computations on the
  int32 step, as the reference's traced step gives them (Python float64
  would move ``lr`` and the corrections by an ulp);
* every division is by a tensor: PyTorch's CUDA division by a Python
  number multiplies by its reciprocal, which rounds differently.

Every function returns new tensors and leaves its inputs as they were,
except an update called with ``donate=True``: it writes each leaf's new
param and moments into the given tensors (what the reference's donated
buffers let XLA do), so a step holds one copy of the params and of the
state, not two (full-width qwen3-4b's AdamW moments alone are 35 GB).  The
values are the same bits either way.  The optimizer state lives on the
params' device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch

from .. import tree_util as tu


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    min_lr_ratio: float = 0.1


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to a float32 scalar on ``like``'s device."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (int32 tensor): linear warmup, then a
    cosine decay to ``min_lr_ratio`` of ``lr``; a float32 scalar."""
    step = step.to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    t = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    floor = cfg.min_lr_ratio
    return cfg.lr * warm * (floor + (1 - floor) * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in the reference's order) of each
    leaf's float32 sum of squares."""
    total = 0
    for g in tu.leaves(tree):
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    return torch.sqrt(total)


def _clip_scale(grads, max_norm: float):
    """``(scale, global norm)``: the factor that brings the grads' global
    norm to at most ``max_norm``."""
    norm = global_norm(grads)
    return torch.clamp(_f32(max_norm, norm) / torch.clamp(norm, min=1e-9),
                       max=1.0), norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """One leaf of ``clip_by_global_norm``'s output, in float32."""
    return (g.to(torch.float32) * scale).to(g.dtype).to(torch.float32)


def clip_by_global_norm(grads, max_norm: float):
    """``(grads scaled to at most max_norm, their global norm)``; each
    leaf is scaled in float32 and cast back to its dtype.  The updates
    apply the same scaling leaf by leaf (``_clipped``), so no second copy
    of the grads exists."""
    scale, norm = _clip_scale(grads, max_norm)
    return tu.tree_map(
        lambda g: (g.to(torch.float32) * scale).to(g.dtype), grads), norm


# --- AdamW -------------------------------------------------------------------


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tu.leaves(params)[0].device)


def adamw_init(params) -> Dict[str, Any]:
    return {"mu": tu.tree_map(_zeros_f32, params),
            "nu": tu.tree_map(_zeros_f32, params),
            "step": _step0(params)}


@torch.no_grad()
def adamw_update(cfg: OptConfig, grads, state, params, donate: bool = False):
    """``(new params, new state, {"lr", "grad_norm"})``; with ``donate``
    the new values are written into ``params`` and ``state``'s tensors."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    corr1 = 1 - _f32(b1, stepf) ** stepf
    corr2 = 1 - _f32(b2, stepf) ** stepf

    # the leaf-sized float32 temporaries (a full-width qwen3-4b MLP stack is
    # 3.6 GB in float32) are updated in place where the op is the same, and
    # with donate the moments too
    def upd(g, mu, nu, p):
        g = _clipped(g, scale)  # a new tensor
        mu_new = (mu.mul_(b1) if donate else b1 * mu).add_((1 - b1) * g)
        nu_new = (nu.mul_(b2) if donate else b2 * nu).add_(
            torch.square(g).mul_(1 - b2))
        del g
        delta = (mu_new / corr1).div_(
            (nu_new / corr2).sqrt_().add_(cfg.eps))
        if p.ndim >= 2:  # decay matrices only
            delta = delta.add_(cfg.weight_decay * p.to(torch.float32))
        new_p = (p.to(torch.float32) - delta.mul_(lr)).to(p.dtype)
        if not donate:
            return new_p, mu_new, nu_new
        del delta
        p.copy_(new_p)
        return p, mu, nu

    out = [upd(*leaf) for leaf in zip(
        tu.leaves(grads), tu.leaves(state["mu"]), tu.leaves(state["nu"]),
        tu.leaves(params), strict=True)]
    new_state = {"mu": tu.unflatten(params, [o[1] for o in out]),
                 "nu": tu.unflatten(params, [o[2] for o in out]),
                 "step": step}
    return (tu.unflatten(params, [o[0] for o in out]), new_state,
            {"lr": lr, "grad_norm": gnorm})


# --- Adafactor (factored second moments; memory ~ O(n+m) per matrix) ---------


def adafactor_init(params) -> Dict[str, Any]:
    def init(p):
        if p.ndim >= 2:
            return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=torch.float32, device=p.device)}
        return {"v": _zeros_f32(p)}

    return {"v": tu.tree_map(init, params), "step": _step0(params)}


@torch.no_grad()
def adafactor_update(cfg: OptConfig, grads, state, params,
                     donate: bool = False):
    """``(new params, new state, {"lr", "grad_norm"})``; with ``donate``
    the new values are written into ``params`` and ``state``'s tensors."""
    step = state["step"] + 1
    lr = schedule(cfg, step)
    scale, gnorm = _clip_scale(grads, cfg.clip_norm)
    decay = 1.0 - (step.to(torch.float32) + 1.0) ** -0.8

    # the leaf-sized float32 temporaries are updated in place where the op
    # is the same (a full-width grok expert stack is 6.4 GB in float32)
    def upd(g, v, p):
        g = _clipped(g, scale)  # a new tensor
        g2 = torch.square(g).add_(1e-30)
        if p.ndim >= 2:
            vr = decay * v["vr"] + (1 - decay) * torch.mean(g2, dim=-1)
            vc = decay * v["vc"] + (1 - decay) * torch.mean(g2, dim=-2)
            del g2
            denom = (vr[..., None] * vc[..., None, :]).div_(
                torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                            min=1e-30)[..., None]).sqrt_()
            delta = g.div_(denom.clamp_(min=1e-30))
            del denom
            new_v = {"vr": vr, "vc": vc}
        else:
            nv = decay * v["v"] + (1 - decay) * g2
            delta = g / (torch.sqrt(nv) + 1e-30)
            new_v = {"v": nv}
        del g
        # update clipping (Adafactor's d=1.0 RMS rule)
        rms = torch.sqrt(torch.mean(torch.square(delta)) + 1e-30)
        delta = delta.div_(torch.clamp(rms, min=1.0))
        if p.ndim >= 2:
            delta = delta.add_(cfg.weight_decay * p.to(torch.float32))
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        if not donate:
            return new_p, new_v
        del delta
        for k, t in new_v.items():
            v[k].copy_(t)
        p.copy_(new_p)
        return p, v

    # a leaf's second moment is a dict ({"vr", "vc"} or {"v"}): find it by
    # the leaf's path in the params
    out = [upd(g, _at(state["v"], path), p) for (path, p), g in zip(
        tu.leaves_with_paths(params), tu.leaves(grads), strict=True)]
    new_state = {"v": tu.unflatten(params, [o[1] for o in out]),
                 "step": step}
    return (tu.unflatten(params, [o[0] for o in out]), new_state,
            {"lr": lr, "grad_norm": gnorm})


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def make_optimizer(cfg: OptConfig, donate: bool = False
                   ) -> Tuple[Callable, Callable]:
    """``(init(params), update(grads, state, params))`` of ``cfg.name``;
    ``donate`` updates params and state in place."""
    if cfg.name == "adamw":
        return adamw_init, lambda g, s, p: adamw_update(cfg, g, s, p, donate)
    if cfg.name == "adafactor":
        return adafactor_init, lambda g, s, p: adafactor_update(cfg, g, s, p,
                                                                donate)
    raise ValueError(cfg.name)
