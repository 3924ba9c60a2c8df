"""Mixture-of-Experts on one device: top-k routing with a static per-expert
capacity (port of ``repro.layers.moe``, its single-device case).

``moe_apply_local`` computes what the reference's ``moe_apply_local``
computes at ``ep_rank 0, ep_size 1, model_axis None``: float32 router
logits, ``top_k`` (the lower expert index first on ties) and a softmax over
the k selected, then a capacity of

    capacity = min(max(int(T * k * capacity_factor / E) * E, E), T * k)

slots, ``capacity // E`` an expert.  The (token, k) assignments are ranked
by a stable sort on their expert id, so an expert keeps its first
``capacity // E`` arrivals and drops the rest (a dropped assignment adds
nothing: the token falls through on the residual).  The experts run as
batched SwiGLU products (``qmm.expert_einsum``; SwiGLU whatever the
config's ``mlp_type``, as in the reference), and each token's kept outputs,
weighted by their gate probabilities, are added in the order the
reference's scatter-add meets them (ascending expert, then arrival),
rounded in the activations' dtype at each add: the same code on the CPU and
on the card, with no atomics, so two runs agree bit for bit.

The slots an expert are ``capacity // E`` whatever the remainder.  Where
``capacity`` is ``T * k`` and not a multiple of E (kimi's prefill of 2048
tokens: 16384 over 384 experts) the reference's own code raises (it
reshapes ``capacity`` rows into ``(E, capacity // E, d)``), and when ``T *
k < E`` every expert gets 0 slots, every assignment is dropped and the
layer returns zeros (kimi's decode below 48 rows): the port takes the
formula at its word in both (ROADMAP Watch R9).

The expert-parallel ``shard_map`` path (``ep_size > 1``, a psum over the
model axis) is not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from .common import dense_init
from .mlp import silu
from .qmm import expert_einsum

# float32 elements an expert-stack init draws at a time (1 GiB): a kimi
# layer's stack is 384 x 7168 x 2048, whose float32 draw alone would be
# 22.5 GB
_INIT_CHUNK = 1 << 28


def _expert_init(generator: torch.Generator, shape: Sequence[int], scale,
                 dtype, device) -> torch.Tensor:
    """``(*stack, E, in, out)`` normal weights times ``scale``, drawn a
    chunk of experts at a time so no float32 copy of the stack exists."""
    out = torch.empty(tuple(shape), dtype=dtype,
                      device=device or generator.device)
    flat = out.view(-1, shape[-2], shape[-1])
    step = max(1, _INIT_CHUNK // (shape[-2] * shape[-1]))
    for i in range(0, flat.shape[0], step):
        n = min(step, flat.shape[0] - i)
        flat[i:i + n] = dense_init(generator, (n, shape[-2], shape[-1]),
                                   dtype, scale=scale, device=device)
    return out


def moe_init(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, params: Dict, prefix: str = "moe",
             dtype=torch.bfloat16, device=None, stack: Sequence[int] = ()
             ) -> None:
    """The float32 router ``(*stack, d, E)`` and the bf16 expert stacks
    ``gate``/``up`` ``(*stack, E, d, ff)`` and ``down`` ``(*stack, E, ff,
    d)``.  The experts' scale is ``1/sqrt(E)``: the reference's
    ``dense_init`` takes its fan-in from the leading axis, which for an
    expert stack is the expert count."""
    stack = tuple(stack)
    params[f"{prefix}_router"] = dense_init(
        generator, stack + (d_model, n_experts), torch.float32, device=device)
    scale = 1.0 / np.sqrt(n_experts)
    for name, shape in (("gate", (d_model, d_ff)), ("up", (d_model, d_ff)),
                        ("down", (d_ff, d_model))):
        params[f"{prefix}_{name}"] = _expert_init(
            generator, stack + (n_experts,) + shape, scale, dtype, device)


def _local_expert_ffn(x: torch.Tensor, gate_w, up_w, down_w) -> torch.Tensor:
    """x ``(E, C, d)`` batched over the experts; SwiGLU."""
    h = silu(expert_einsum(x, gate_w)) * expert_einsum(x, up_w)
    return expert_einsum(h, down_w)


def capacity_of(T: int, topk: int, capacity_factor: float, n_experts: int
                ) -> int:
    """The reference's slot count over all experts (``ep_size`` 1)."""
    capacity = max(int(T * topk * capacity_factor / n_experts) * n_experts,
                   n_experts)
    return min(capacity, T * topk)


def route(x: torch.Tensor, router: torch.Tensor, topk: int):
    """``(gate_p, gate_idx)``, each ``(T, k)``: the float32 logits' top k
    (descending, the lower index first on ties, as ``lax.top_k``) and the
    softmax over them."""
    logits = x.float() @ router.float()
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :topk], idx[:, :topk]
    e = torch.exp(vals - vals.amax(-1, keepdim=True))
    return e / e.sum(-1, keepdim=True), idx


def moe_apply_local(params: Dict, x: torch.Tensor, *, n_experts: int,
                    topk: int, capacity_factor: float, prefix: str = "moe"
                    ) -> torch.Tensor:
    """x ``(T, d)`` -> the combined expert output ``(T, d)`` in x's
    dtype."""
    T, d = x.shape
    dev = x.device
    capacity = capacity_of(T, topk, capacity_factor, n_experts)
    cap = capacity // n_experts
    if cap == 0:
        return torch.zeros_like(x)
    gate_p, gate_idx = route(x, params[f"{prefix}_router"], topk)

    # rank the (token, k) assignments by (expert, arrival): slot of each
    n = T * topk
    flat_expert = gate_idx.reshape(-1)
    order = torch.sort(flat_expert, stable=True).indices
    sorted_e = flat_expert[order]
    counts = torch.bincount(sorted_e, minlength=n_experts)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - start[sorted_e]
    keep = pos < cap
    slot = sorted_e * cap + pos
    tok = torch.div(order, topk, rounding_mode="floor")

    buf = x.new_zeros((n_experts * cap, d))
    buf[slot[keep]] = x[tok[keep]]
    out = _local_expert_ffn(buf.view(n_experts, cap, d),
                            params[f"{prefix}_gate"], params[f"{prefix}_up"],
                            params[f"{prefix}_down"]).reshape(-1, d)

    # each kept assignment reads its slot, weighted by its gate probability
    prob = gate_p.reshape(-1)[order].to(out.dtype)
    contrib = out[torch.where(keep, slot, 0)] * prob[:, None]
    contrib = torch.where(keep[:, None], contrib, contrib.new_zeros(()))
    # each token's k assignments in the order the scatter meets them
    rank = torch.empty_like(order)
    rank[order] = torch.arange(n, device=dev)
    seq = torch.sort(rank.view(T, topk), dim=1).values
    parts = contrib[seq]  # (T, k, d)
    y = out.new_zeros((T, d))
    for j in range(topk):
        y = y + parts[:, j]
    return y
