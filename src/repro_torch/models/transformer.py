"""Decoder-only transformer LM: init, forward, loss, prefill, decode.

Port of ``repro.models.transformer``: the dense models (qwen3-4b,
stablelm-1.6b, yi-34b, qwen1.5-0.5b and the VLM internvl2-2b with its
patch-embedding stub prepended) and the MoE models (grok-1-314b,
kimi-k2-1t-a32b: ``layers/moe.py`` on one device, kimi's shared expert and
its dense prefix).  Params are a dict of tensors with the reference's
layout: each per-layer weight is stacked on a leading ``(n_layers, ...)``
axis under ``params["layers"]`` (and the dense prefix's under
``params["dense_layers"]``), and ``_run_layers`` walks the layers in a
Python loop (views, no copies).  A quantized tree
(``quant_transformer.quantize_param_tree``) runs through the same code.

A forward of S > 1024 positions runs ``attention.flash_attention`` in
every layer, which launches the hand-written CUDA kernel on the card (and,
under autograd, its hand-written backward); shorter ones run
``full_attention``.  Training (``loss_fn``, ``train=True``) wraps each
layer in ``torch.utils.checkpoint`` where ``cfg.remat`` is ``"full"``, as
the reference wraps its layer step in ``jax.checkpoint``, and adds the MoE
layers' auxiliary load-balancing loss; the reference's expert-parallel
``shard_map`` branch is not ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..layers import attention as attn
from ..layers import embedding as emb
from ..layers import moe as moe_lib
from ..layers import qmm
from ..layers.common import dense_init, norm_apply, norm_init, rmsnorm
from ..layers.mlp import mlp_apply, mlp_init
from ..layers.rotary import apply_rope

FLASH_MIN_SEQ = 1024  # a forward of more positions than this runs flash


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------


def _layers_init(generator: torch.Generator, cfg: ArchConfig, device,
                 n_layers: Optional[int] = None, moe_layer: bool = False
                 ) -> Dict[str, torch.Tensor]:
    """Every layer's weights, stacked on a leading ``(n_layers,)`` axis
    (``cfg.n_layers`` unless given: recurrentgemma stacks its attention
    layers alone, an MoE model its dense prefix and its MoE layers apart).
    An MoE layer holds the experts and, where the config has them, the
    shared experts' MLP; a dense one the MLP of ``dense_d_ff or d_ff``."""
    L = (cfg.n_layers if n_layers is None else n_layers,)
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p: Dict[str, Any] = {}
    norm_init(cfg.norm_type, d, "norm_attn", p, device=device, stack=L)
    norm_init(cfg.norm_type, d, "norm_mlp", p, device=device, stack=L)
    for name, shape in (("wq", (d, H * hd)), ("wk", (d, KVH * hd)),
                        ("wv", (d, KVH * hd)), ("wo", (H * hd, d))):
        p[name] = dense_init(generator, L + shape, device=device)
    if cfg.qkv_bias:
        for name, w in (("bq", H * hd), ("bk", KVH * hd), ("bv", KVH * hd)):
            p[name] = torch.zeros(L + (w,), dtype=torch.bfloat16,
                                  device=device)
    if cfg.qk_norm:
        for name in ("q_norm", "k_norm"):
            p[name] = torch.ones(L + (hd,), dtype=torch.bfloat16,
                                 device=device)
    if moe_layer:
        moe_lib.moe_init(generator, d, cfg.moe_d_ff, cfg.n_experts, p,
                         device=device, stack=L)
        if cfg.n_shared_experts:
            mlp_init(generator, d, cfg.moe_d_ff * cfg.n_shared_experts,
                     cfg.mlp_type, p, prefix="shared", device=device,
                     stack=L)
    else:
        mlp_init(generator, d, cfg.dense_d_ff or cfg.d_ff, cfg.mlp_type, p,
                 device=device, stack=L)
    return p


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None
                ) -> Dict[str, Any]:
    """Random bf16 params (the routers float32) from a seeded generator,
    placed on ``device``."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device,
                   tie=cfg.tie_embeddings)
    norm_init(cfg.norm_type, cfg.d_model, "norm_final", params, device=device)
    if cfg.n_dense_layers:
        params["dense_layers"] = _layers_init(generator, cfg, device,
                                              cfg.n_dense_layers)
    params["layers"] = _layers_init(generator, cfg, device,
                                    cfg.n_layers - cfg.n_dense_layers,
                                    moe_layer=cfg.n_experts > 0)
    return params


def param_count(cfg: ArchConfig) -> int:
    """The number of parameters ``init_params`` draws for ``cfg``, counted
    from the config alone (nothing is allocated)."""
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_norm = 2 if cfg.norm_type == "layernorm" else 1
    n_mlp = 3 if cfg.mlp_type in ("swiglu", "geglu") else 2
    attn = 2 * n_norm * d + 2 * d * H * hd + 2 * d * KVH * hd
    attn += (H + 2 * KVH) * hd * cfg.qkv_bias + 2 * hd * cfg.qk_norm
    dense = attn + n_mlp * d * (cfg.dense_d_ff or cfg.d_ff)
    moe = (attn + d * cfg.n_experts + 3 * cfg.n_experts * d * cfg.moe_d_ff
           + n_mlp * d * cfg.moe_d_ff * cfg.n_shared_experts)
    n_main = cfg.n_layers - cfg.n_dense_layers
    layers = cfg.n_dense_layers * dense + n_main * (
        moe if cfg.n_experts else dense)
    head = 0 if cfg.tie_embeddings else cfg.vocab_size * d
    return cfg.vocab_size * d + head + n_norm * d + layers


def layer_params(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer ``i`` of a stacked tree (int8 ``{"q", "s"}`` leaves too)."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------


def _qk_normalize(cfg: ArchConfig, q, k, p):
    if not cfg.qk_norm:
        return q, k
    return rmsnorm(q, p["q_norm"]), rmsnorm(k, p["k_norm"])


def _attention_block(p: Dict, cfg: ArchConfig, x: torch.Tensor,
                     positions: torch.Tensor, cache: Optional[Dict] = None
                     ) -> torch.Tensor:
    """Self-attention of one layer.  With ``cache`` (decode) the step's K/V
    are written into the cache tensors in place, at ``pos % S_cache``."""
    B, S, d = x.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = qmm.mm(x, p["wq"])
    k = qmm.mm(x, p["wk"])
    v = qmm.mm(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, H, hd)
    k = k.reshape(B, S, KVH, hd)
    v = v.reshape(B, S, KVH, hd)
    q, k = _qk_normalize(cfg, q, k, p)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if S > FLASH_MIN_SEQ:
            # the kernel reads KV head h // (H // KVH) in place of repeat_kv
            o = attn.flash_attention(q, k, v, causal=True,
                                     window=cfg.attn_window)
        else:
            kr = attn.repeat_kv(k, H // KVH)
            vr = attn.repeat_kv(v, H // KVH)
            o = attn.full_attention(q, kr, vr, causal=True,
                                    window=cfg.attn_window)
    else:
        # decode: ring-buffer write at pos % S_cache (the start clamped so
        # the S new positions fit, as dynamic_update_slice clamps it)
        k_cache, v_cache, pos = cache["k"], cache["v"], cache["pos"]
        s_cache = k_cache.shape[1]
        wpos = min(pos % s_cache, s_cache - S)
        k_scale = v_scale = None
        if k_cache.dtype == torch.int8:
            k, ks = attn.quantize_kv(k)
            v, vs = attn.quantize_kv(v)
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
            k_scale[:, wpos:wpos + S] = ks.to(k_scale.dtype)
            v_scale[:, wpos:wpos + S] = vs.to(v_scale.dtype)
        k_cache[:, wpos:wpos + S] = k.to(k_cache.dtype)
        v_cache[:, wpos:wpos + S] = v.to(v_cache.dtype)
        o = attn.decode_attention(q, k_cache, v_cache, min(pos + 1, s_cache),
                                  window=0, k_scale=k_scale, v_scale=v_scale)
    return qmm.mm(o.reshape(B, S, H * hd), p["wo"])


def moe_aux(p: Dict, cfg: ArchConfig, tokens: torch.Tensor) -> torch.Tensor:
    """The reference's auxiliary load-balancing loss of one MoE layer over
    its ``(T, d)`` routed tokens: ``n_experts * sum(frac * mean(softmax))``,
    ``frac`` each expert's share of the tokens whose top logit it holds
    (float32 logits ``tokens @ router``; no gradient flows through the
    argmax)."""
    logits = tokens.float() @ p["moe_router"].float()
    probs = torch.softmax(logits, dim=-1)
    frac = torch.nn.functional.one_hot(logits.argmax(-1),
                                       cfg.n_experts).float().mean(0)
    return cfg.n_experts * torch.sum(frac * probs.mean(0))


def ffn(p: Dict, cfg: ArchConfig, x, is_moe: bool = False,
        train: bool = False):
    """``(y, aux)``: the block's feed-forward on its normed input x ``(B,
    S, d)`` -- the MLP, or the MoE layer over the B * S tokens plus the
    shared experts' MLP where the config has them -- and, in training, an
    MoE layer's ``moe_aux`` (else None).  The router reads x as rounded:
    the normed tokens have other users, and the jitted reference keeps
    their rounding (the smoke models' logits are equal bit for bit)."""
    if not is_moe:
        return mlp_apply(p, x, cfg.mlp_type), None
    B, S, d = x.shape
    tokens = x.reshape(B * S, d)
    aux = moe_aux(p, cfg, tokens) if train else None
    y = moe_lib.moe_apply_local(
        p, tokens, n_experts=cfg.n_experts, topk=cfg.topk,
        capacity_factor=cfg.capacity_factor).reshape(B, S, d)
    if cfg.n_shared_experts:
        y = y + mlp_apply(p, x, cfg.mlp_type, prefix="shared")
    return y, aux


def residual_mlp(p: Dict, cfg: ArchConfig, x, h, unrounded: bool = False,
                 is_moe: bool = False, train: bool = False):
    """``(out, aux)``: the second half of a block -- ``x + h``, then the
    feed-forward (``ffn``) on its norm, added, in h's dtype -- and ffn's
    aux.  The residual sum reaches the norm unrounded and the residual
    stream rounded, as the jitted reference computes it: XLA drops the
    bf16 rounding of a sum that is cast to float32, as a norm casts its
    input (ROADMAP Queue 3, F6).  ``unrounded`` returns the block's own sum
    unrounded too, in float32, for a model whose layers the reference
    unrolls (the next norm reads it so; ``x`` may then be such a sum)."""
    dt = h.dtype
    x2 = x.to(dt).float() + h.float()
    y, aux = ffn(p, cfg, norm_apply(cfg.norm_type, x2, p, "norm_mlp").to(dt),
                 is_moe, train)
    if unrounded:
        return x2.to(dt).float() + y.float(), aux
    return x2.to(dt) + y, aux


def _block(p: Dict, cfg: ArchConfig, x, positions, cache=None,
           is_moe: bool = False, train: bool = False):
    h = _attention_block(p, cfg, norm_apply(cfg.norm_type, x, p, "norm_attn"),
                         positions, cache)
    return residual_mlp(p, cfg, x, h, is_moe=is_moe, train=train)


def _stacks(cfg: ArchConfig):
    """``(params key, cache key, layers, MoE?)`` of each stack in order:
    the dense prefix, where the config has one, then the main stack."""
    n_dense = cfg.n_dense_layers
    out = [("dense_layers", "dense", n_dense, False)] if n_dense else []
    return out + [("layers", "main", cfg.n_layers - n_dense,
                   cfg.n_experts > 0)]


def remat_of(cfg: ArchConfig, train: bool) -> bool:
    """Does training recompute each layer in the backward?  The reference's
    rule: ``train`` and ``cfg.remat != "none"``.  Its ``"dots"`` policy
    (save the products, recompute the rest) is not ported: no registered
    config uses it."""
    if not train or cfg.remat == "none":
        return False
    if cfg.remat != "full":
        raise NotImplementedError(
            f"{cfg.name}: remat={cfg.remat!r} is not ported (the port "
            "recomputes whole layers: remat='full')")
    return True


def _run_layers(params, cfg: ArchConfig, x, positions,
                caches: Optional[Dict] = None, train: bool = False):
    """``(x, aux, caches)``: the layers in order, one Python loop over each
    stack's weights; aux sums the MoE layers' ``moe_aux`` in training (0
    otherwise).  Where ``remat_of(cfg, train)`` each layer runs under
    ``torch.utils.checkpoint``: its activations are recomputed in the
    backward, so only the layers' inputs stay saved."""
    remat = remat_of(cfg, train)
    total_aux = 0.0
    for key, ckey, n, is_moe in _stacks(cfg):
        for i in range(n):
            p = layer_params(params[key], i)
            cache = None
            if caches is not None:
                cache = {k: t[i] for k, t in caches[ckey].items()}
                cache["pos"] = caches["len"]
            if remat:
                x, aux = checkpoint(_block, p, cfg, x, positions, None,
                                    is_moe, train, use_reentrant=False)
            else:
                x, aux = _block(p, cfg, x, positions, cache, is_moe, train)
            if aux is not None:
                total_aux = total_aux + aux
    if caches is None:
        return x, total_aux, None
    return x, total_aux, dict(caches, len=caches["len"] + 1)


def _embed(params, tokens, frontend_embeds):
    x = emb.embed_tokens(params, tokens)
    if frontend_embeds is not None:
        x = torch.cat([frontend_embeds.to(x.dtype), x], dim=1)
    return x


def _forward(params, cfg: ArchConfig, tokens, frontend_embeds, train):
    x = _embed(params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, aux, _ = _run_layers(params, cfg, x, positions, train=train)
    x = norm_apply(cfg.norm_type, x, params, "norm_final")
    return emb.logits_head(params, x), aux


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            frontend_embeds: Optional[torch.Tensor] = None,
            train: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S_total, vocab).  ``frontend_embeds``
    (B, F, d) are prepended (VLM patch stub).  ``train`` runs the layers
    as training does (remat; ``loss_fn`` adds the MoE auxiliary loss,
    which the reference also returns from here)."""
    return _forward(params, cfg, tokens, frontend_embeds, train)[0]


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch`` (``{"tokens", "labels"}``
    and the VLM's ``"frontend_embeds"``, on the params' device), the
    frontend positions cut from the logits, plus ``0.01 *`` the MoE layers'
    auxiliary load-balancing loss (0 for a dense model), the layers run
    with ``train=True``."""
    frontend = batch.get("frontend_embeds")
    logits, aux = _forward(params, cfg, batch["tokens"], frontend, True)
    if frontend is not None:
        logits = logits[:, frontend.shape[1]:]
    return emb.cross_entropy(logits, batch["labels"]) + 0.01 * aux


# --------------------------------------------------------------------------
# serving
# --------------------------------------------------------------------------


def init_decode_cache(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, quantized: bool = False,
                      device=None) -> Dict[str, Any]:
    """Stacked per-layer K/V caches (bf16, or int8 with float16 scales per
    (position, KV head)) of each stack (``"main"``, and ``"dense"`` for an
    MoE model's dense prefix); ``len`` counts the positions written, a
    Python int here (the reference's int32 scalar)."""
    kv_dtype = torch.int8 if quantized else dtype

    def mk(L):
        shape = (L, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
        c = {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
        if quantized:
            for name in ("k_scale", "v_scale"):
                c[name] = torch.ones(shape[:4], dtype=torch.float16,
                                     device=device)
        return c

    cache = {ckey: mk(n) for _, ckey, n, _ in _stacks(cfg)}
    cache["len"] = 0
    return cache


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None,
            frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run the prompt, return the last position's logits (B, vocab).  The
    head runs on that position alone, which equals the last row of the
    full logits (the final norm is per position)."""
    x = _embed(params, tokens, frontend_embeds)
    positions = torch.arange(x.shape[1], device=x.device)
    x, _, _ = _run_layers(params, cfg, x, positions)
    x = norm_apply(cfg.norm_type, x[:, -1:], params, "norm_final")
    return emb.logits_head(params, x)[:, 0]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                caches: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) + caches -> (logits (B, vocab), caches with len + 1).
    The cache tensors are updated in place (the reference returns new
    arrays); the returned dict shares them."""
    x = emb.embed_tokens(params, token)
    positions = torch.full((1,), caches["len"], dtype=torch.int32,
                           device=x.device)
    x, _, new_caches = _run_layers(params, cfg, x, positions, caches)
    x = norm_apply(cfg.norm_type, x, params, "norm_final")
    return emb.logits_head(params, x[:, -1]), new_caches
