"""Whisper-tiny backbone: an encoder-decoder transformer with a stub
frontend (port of ``repro.models.whisper``).

The conv/mel frontend is a stub: the caller passes precomputed frame
embeddings ``(B, N_FRAMES, d_model)``.  The encoder is bidirectional; the
decoder has causal self-attention and cross-attention with learned
positions (no RoPE).  Params keep the reference's tree: ``enc_layers`` and
``dec_layers`` are lists of layer dicts.  ``N_FRAMES`` and
``MAX_TEXT_POS`` are module constants, read when a function runs (the
smoke tests patch ``N_FRAMES``).

Attention over more than 2048 keys (``_mha``'s own threshold, not
``transformer.FLASH_MIN_SEQ``) runs ``flash_attention``: on the card the
decoder's self-attention of a text prompt longer than 2048 tokens launches
kernel 5 (head_dim 64, its tensor-core form); the encoder's 1500 frames
never reach it.  Decode writes each step's self-attention K/V into the
cache in place and reads the cross-attention cache as it is: like the
reference, decode never fills it, so ``init_decode_state``'s zeros stand
for the encoder's keys and values (ROADMAP Queue 3, R8).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..layers import attention as attn
from ..layers import embedding as emb
from ..layers.common import dense_init, layernorm, norm_init
from ..layers.mlp import mlp_apply, mlp_init
from ..layers.qmm import mm

MAX_TEXT_POS = 32768 + 8
N_FRAMES = 1500
FLASH_MIN_KEYS = 2048  # _mha runs flash attention over more keys than this


def _attn_init(generator, d: int, prefix: str, params, device) -> None:
    for name in ("wq", "wk", "wv", "wo"):
        params[f"{prefix}_{name}"] = dense_init(generator, (d, d),
                                                device=device)


def _enc_layer_init(generator, cfg: ArchConfig, device) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    norm_init("layernorm", cfg.d_model, "norm_attn", p, device=device)
    norm_init("layernorm", cfg.d_model, "norm_mlp", p, device=device)
    _attn_init(generator, cfg.d_model, "self", p, device)
    mlp_init(generator, cfg.d_model, cfg.d_ff, "gelu", p, device=device)
    return p


def _dec_layer_init(generator, cfg: ArchConfig, device) -> Dict[str, Any]:
    p: Dict[str, Any] = {}
    for name in ("norm_self", "norm_cross", "norm_mlp"):
        norm_init("layernorm", cfg.d_model, name, p, device=device)
    _attn_init(generator, cfg.d_model, "self", p, device)
    _attn_init(generator, cfg.d_model, "cross", p, device)
    mlp_init(generator, cfg.d_model, cfg.d_ff, "gelu", p, device=device)
    return p


def sinusoid(n: int, d: int) -> np.ndarray:
    """The encoder's fixed positions (numpy, as the reference builds
    them): sin over the first half of the width, cos over the second."""
    pos = np.arange(n)[:, None]
    dim = np.arange(d // 2)[None]
    ang = pos / (10000 ** (dim / (d // 2)))
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)


def init_params(generator: torch.Generator, cfg: ArchConfig, device=None
                ) -> Dict[str, Any]:
    """Random bf16 params from a seeded generator, placed on ``device``."""
    params: Dict[str, Any] = {}
    emb.embed_init(generator, cfg.vocab_size, cfg.d_model, params, device,
                   tie=True)
    params["pos_dec"] = dense_init(generator, (MAX_TEXT_POS, cfg.d_model),
                                   scale=0.02, device=device)
    params["pos_enc"] = torch.as_tensor(
        sinusoid(N_FRAMES, cfg.d_model), dtype=torch.float32).to(
            device=device, dtype=torch.bfloat16)
    norm_init("layernorm", cfg.d_model, "norm_enc_final", params,
              device=device)
    norm_init("layernorm", cfg.d_model, "norm_dec_final", params,
              device=device)
    params["enc_layers"] = [_enc_layer_init(generator, cfg, device)
                            for _ in range(cfg.enc_layers)]
    params["dec_layers"] = [_dec_layer_init(generator, cfg, device)
                            for _ in range(cfg.n_layers)]
    return params


def _norm(x, p, name, dt):
    return layernorm(x, p[name], p.get(name + "_b")).to(dt)


def _add(x, h):
    """The residual sum ``x + h`` as the jitted reference feeds it to the
    next norm: unrounded, in float32.  The reference unrolls the layers and
    every residual sum is read by a LayerNorm, which casts it to float32,
    so XLA drops its bf16 rounding there; the next residual add reads it
    rounded to h's dtype (ROADMAP Queue 3, F6)."""
    return x.to(h.dtype).float() + h.float()


def _mha(p, prefix: str, xq: torch.Tensor, xkv: Optional[torch.Tensor],
         H: int, causal: bool, cache: Optional[Dict] = None,
         pos: Optional[int] = None):
    """Multi-head attention of one layer; returns ``(out, cache)``.  With a
    ``cross`` cache q attends its precomputed K/V; with a ``self`` cache
    (decode) the step's K/V are written at ``pos`` (clamped so they fit,
    as ``dynamic_update_slice`` clamps) and ``pos + 1`` positions are
    read."""
    B, Sq, d = xq.shape
    hd = d // H
    if xkv is None:
        xkv = xq  # self-attention
    q = mm(xq, p[f"{prefix}_wq"]).reshape(B, Sq, H, hd)
    if cache is not None and prefix == "cross":
        k, v = cache["k"], cache["v"]
        o = attn.decode_attention(q, k, v, k.shape[1])
        return mm(o.reshape(B, Sq, d), p[f"{prefix}_wo"]), cache
    k = mm(xkv, p[f"{prefix}_wk"]).reshape(B, -1, H, hd)
    v = mm(xkv, p[f"{prefix}_wv"]).reshape(B, -1, H, hd)
    if cache is not None:  # decode self-attention
        kc, vc = cache["k"], cache["v"]
        wpos = max(0, min(pos, kc.shape[1] - Sq))
        kc[:, wpos:wpos + Sq] = k.to(kc.dtype)
        vc[:, wpos:wpos + Sq] = v.to(vc.dtype)
        o = attn.decode_attention(q, kc, vc, pos + 1)
        return mm(o.reshape(B, Sq, d), p[f"{prefix}_wo"]), cache
    if k.shape[1] > FLASH_MIN_KEYS:
        o = attn.flash_attention(q, k, v, causal=causal)
    else:
        o = attn.full_attention(q, k, v, causal=causal)
    return mm(o.reshape(B, Sq, d), p[f"{prefix}_wo"]), None


def encode(params, cfg: ArchConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames ``(B, F, d_model)`` (the frontend stub's embeddings) -> the
    encoder's output."""
    dt = frames.dtype
    x = _add(frames, params["pos_enc"][None, :frames.shape[1]].to(dt))
    for p in params["enc_layers"]:
        h, _ = _mha(p, "self", _norm(x, p, "norm_attn", dt), None,
                    cfg.n_heads, causal=False)
        x = _add(x, h)
        x = _add(x, mlp_apply(p, _norm(x, p, "norm_mlp", dt), "gelu"))
    return _norm(x, params, "norm_enc_final", dt)


def _decoder(params, cfg: ArchConfig, tokens: torch.Tensor,
             enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder's layers over the text; returns the residual stream (the
    final norm's input) as float32, unrounded (``_add``)."""
    S = tokens.shape[1]
    x = emb.embed_tokens(params, tokens)
    dt = x.dtype
    x = _add(x, params["pos_dec"][None, :S])
    for p in params["dec_layers"]:
        x = _dec_layer(p, cfg, x, dt, enc_out)
    return x


def _dec_layer(p, cfg: ArchConfig, x, dt, enc_out, cache=None, pos=None):
    h, _ = _mha(p, "self", _norm(x, p, "norm_self", dt), None, cfg.n_heads,
                causal=True, cache=None if cache is None else cache[0],
                pos=pos)
    x = _add(x, h)
    h, _ = _mha(p, "cross", _norm(x, p, "norm_cross", dt), enc_out,
                cfg.n_heads, causal=False,
                cache=None if cache is None else cache[1])
    x = _add(x, h)
    return _add(x, mlp_apply(p, _norm(x, p, "norm_mlp", dt), "gelu"))


def decode_train(params, cfg: ArchConfig, tokens: torch.Tensor,
                 enc_out: torch.Tensor) -> torch.Tensor:
    """The decoder over a whole text sequence: logits (B, S, vocab)."""
    x = _decoder(params, cfg, tokens, enc_out)
    return emb.logits_head(params, _norm(x, params, "norm_dec_final",
                                         enc_out.dtype))


def loss_fn(params, cfg: ArchConfig, batch) -> torch.Tensor:
    """``batch``: ``tokens``, ``labels`` (B, S) and ``frontend_embeds``
    (B, N_FRAMES, d_model)."""
    enc_out = encode(params, cfg, batch["frontend_embeds"])
    logits = decode_train(params, cfg, batch["tokens"], enc_out)
    return emb.cross_entropy(logits, batch["labels"])


def init_decode_state(cfg: ArchConfig, batch: int, max_len: int,
                      dtype=torch.bfloat16, device=None) -> Dict[str, Any]:
    hd = cfg.d_model // cfg.n_heads

    def kv(n: int) -> List[Dict[str, torch.Tensor]]:
        shape = (batch, n, cfg.n_heads, hd)
        return [{"k": torch.zeros(shape, dtype=dtype, device=device),
                 "v": torch.zeros(shape, dtype=dtype, device=device)}
                for _ in range(cfg.n_layers)]

    return {"self": kv(max_len), "cross": kv(N_FRAMES), "len": 0}


def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            frames: torch.Tensor) -> torch.Tensor:
    """Encode the frames, run the decoder over the prompt; the last
    position's logits (B, vocab), the head on that position alone."""
    enc_out = encode(params, cfg, frames)
    x = _decoder(params, cfg, tokens, enc_out)
    x = _norm(x[:, -1:], params, "norm_dec_final", enc_out.dtype)
    return emb.logits_head(params, x)[:, 0]


def decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                states: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """token (B, 1) + states -> (logits (B, vocab), states with len + 1)."""
    pos = states["len"]
    x = emb.embed_tokens(params, token)
    dt = x.dtype
    row = min(pos, params["pos_dec"].shape[0] - 1)  # dynamic_slice clamps
    x = _add(x, params["pos_dec"][None, row:row + 1])
    for p, sc, cc in zip(params["dec_layers"], states["self"],
                         states["cross"]):
        x = _dec_layer(p, cfg, x, dt, None, cache=(sc, cc), pos=pos)
    x = _norm(x, params, "norm_dec_final", dt)
    return emb.logits_head(params, x[:, -1]), dict(states, len=pos + 1)
