"""The train step and the serving functions of a model bundle (port of
``repro.runtime.train_loop`` without a mesh).

``make_train_step`` builds the reference's step: the bundle's loss (QAT's
for the ``lstm`` family under ``qat``), its gradients by autograd,
accumulated over micro-batches in float32, optional int8 error-feedback
compression, then the optimizer.  ``make_serve_fns`` runs the bundle's
prefill and decode eagerly, without autograd.  Both run on ``device``: no
sharding and no jit.  The sharded step (the reference's ``abstract_init``,
``opt_logical_specs`` and mesh shardings) comes with the mesh (ROADMAP
Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from .. import tree_util as tu
from ..models import lstm_lm
from ..models.model_zoo import ModelBundle
from ..optim import grad_compress
from ..optim.optimizers import OptConfig, make_optimizer


@dataclasses.dataclass
class TrainArtifacts:
    step_fn: Callable  # (params, opt_state, batch) -> (params, opt, metrics)
    init_opt: Callable  # params -> opt_state


def make_train_step(bundle: ModelBundle, device, opt_cfg: OptConfig, *,
                    microbatches: int = 1, grad_compress_int8: bool = False,
                    qat: bool = False, donate: bool = False
                    ) -> TrainArtifacts:
    """The train step of ``bundle`` on ``device``.

    ``step_fn(params, opt_state, batch)`` returns ``(new params, new
    opt_state, {"loss", "lr", "grad_norm"})``, each metric a float32 scalar
    tensor; ``batch`` (numpy arrays or tensors, batch first) is moved to
    ``device``.  The state is ``{"inner": <the optimizer's>}`` plus
    ``"ef_residual"`` under ``grad_compress_int8``, the reference's layout,
    so checkpoints of either package line up.  With one micro-batch a
    gradient keeps its leaf's dtype (bf16 for the embedding and the head);
    with more they are float32 means.  The step returns new tensors and
    leaves its inputs as they were; with ``donate`` (the reference's
    default, which the train launcher takes) it writes the new params and
    optimizer state into the ones it was given instead, the same bits, and
    returns those.
    """
    cfg = bundle.cfg
    device = torch.device(device)
    opt_init, opt_update = (make_optimizer(opt_cfg, donate=True) if donate
                            else make_optimizer(opt_cfg))
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")

    def loss_fn(params, batch):
        if qat and cfg.family == "lstm":
            return lstm_lm.loss_fn(params, cfg, batch, qat=True)
        return bundle.loss(params, batch)

    def value_and_grad(params, batch):
        flat = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
        with torch.enable_grad():
            loss = loss_fn(tu.unflatten(params, flat), batch)
            grads = torch.autograd.grad(loss, flat)
        return loss.detach(), list(grads)

    def compute_grads(params, batch):
        if microbatches == 1:
            loss, grads = value_and_grad(params, batch)
            return loss, tu.unflatten(params, grads)
        n = next(iter(batch.values())).shape[0]
        if n % microbatches:
            raise ValueError(f"batch of {n} rows does not split into "
                             f"{microbatches} micro-batches")
        size = n // microbatches
        loss_acc = torch.zeros((), dtype=torch.float32, device=device)
        grad_acc = [torch.zeros(p.shape, dtype=torch.float32, device=device)
                    for p in tu.leaves(params)]
        for i in range(microbatches):
            mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
            loss, grads = value_and_grad(params, mb)
            grad_acc = [a + g.to(torch.float32)
                        for a, g in zip(grad_acc, grads, strict=True)]
            loss_acc = loss_acc + loss
        inv = 1.0 / microbatches
        return loss_acc * inv, tu.unflatten(params, [g * inv
                                                     for g in grad_acc])

    def step_fn(params, opt_state, batch: Dict[str, Any]):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        loss, grads = compute_grads(params, batch)
        if grad_compress_int8:
            grads, new_resid = grad_compress.ef_compress_tree(
                grads, opt_state["ef_residual"])
        new_params, new_inner, metrics = opt_update(
            grads, opt_state["inner"], params)
        new_opt = {"inner": new_inner}
        if grad_compress_int8:
            new_opt["ef_residual"] = new_resid
        return new_params, new_opt, dict(metrics, loss=loss)

    def init_opt(params):
        st = {"inner": opt_init(params)}
        if grad_compress_int8:
            st["ef_residual"] = grad_compress.ef_init(params)
        return st

    return TrainArtifacts(step_fn, init_opt)


def make_serve_fns(bundle: ModelBundle, device, batch: int, max_len: int,
                   quantized_cache: bool = False
                   ) -> Tuple[Callable, Callable]:
    """``(prefill_fn, decode_fn)``.

    ``prefill_fn(params, b)`` takes ``{"tokens": (batch, S)}`` (and the
    VLM's ``"frontend_embeds"``) and returns the last-token logits;
    ``decode_fn(params, token, state)`` returns ``(logits, state)``, and
    with ``state=None`` starts from a fresh ``(batch, max_len)`` cache
    (int8 when ``quantized_cache``).  Inputs are moved to ``device``.
    """
    device = torch.device(device)

    @torch.no_grad()
    def prefill_fn(params, b):
        b = {k: v.to(device) for k, v in b.items()}
        return bundle.prefill(params, b)

    @torch.no_grad()
    def decode_fn(params, token, state=None):
        if state is None:
            state = bundle.init_state(batch, max_len,
                                      quantized=quantized_cache,
                                      device=device)
        return bundle.decode(params, token.to(device), state)

    return prefill_fn, decode_fn
