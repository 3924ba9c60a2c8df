"""The flash-attention backward: the plain version and the layer's
``FlashAttention`` against ``jax.vjp`` of the jitted reference layer.

The same numpy inputs go through ``repro.layers.attention.flash_attention``
(given GQA-repeated k and v, 64-wide chunks, jitted once per case) and its
counterparts in the port.  Tolerances, against the largest ``|ref|`` of
each gradient:

* float32: ``|d| <= 1e-5 max|ref|`` (the float32 sums run in other
  orders);
* bf16: 2 bf16 ulps of ``max|ref|``.  The reference rounds each query
  head's dk and dv to bf16 and ``repeat_kv``'s transpose then sums a
  group's heads; the port sums them in float32 and rounds once.

Kernel 5's row log-sum-exp (``return_lse``) is held against the
reference's ``_flash_fwd_impl`` within ``2e-5 + 2e-5 |ref|``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.layers import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.testing.attention_checks import (  # noqa: E402
    bf16_bound, unaligned)

torch.set_num_threads(1)

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
BLOCK = 64
# (label, B, Sq, Sk, H, KVH, D, causal, window, q_offset)
CASES = [
    ("causal-g1-d64", 1, 320, 320, 2, 2, 64, True, 0, 0),
    ("window-g2-d64", 1, 320, 320, 4, 2, 64, True, 100, 0),
    ("noncausal-g4-d16", 2, 192, 192, 4, 1, 16, False, 0, 0),
    ("offset-g2-d16", 1, 128, 256, 4, 2, 16, True, 0, 128),
    ("offset-window-g4-d64", 1, 192, 320, 4, 1, 64, True, 72, 128),
]
IDS = [c[0] for c in CASES]


def _inputs(case, dtype):
    """q, k, v and dout as numpy float32 values of ``dtype``."""
    _, B, Sq, Sk, H, KVH, D, *_ = case
    rng = np.random.default_rng(sum(map(ord, case[0])))
    jdt = DTYPES[dtype][0]
    shapes = ((B, Sq, H, D), (B, Sk, KVH, D), (B, Sk, KVH, D), (B, Sq, H, D))
    return [np.array(jnp.asarray(rng.standard_normal(s).astype(np.float32))
                       .astype(jdt).astype(jnp.float32)) for s in shapes]


@functools.lru_cache(maxsize=None)
def _reference(case, dtype):
    """``(out, lse, (dq, dk, dv))`` of the jitted reference, as numpy."""
    _, B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
    G = H // KVH
    jdt = DTYPES[dtype][0]
    q, k, v, dout = (jnp.asarray(a).astype(jdt) for a in _inputs(case, dtype))

    @jax.jit
    def run(q, k, v, dout):
        def f(q, k, v):
            return JA.flash_attention(q, JA.repeat_kv(k, G),
                                      JA.repeat_kv(v, G), q_offset, causal,
                                      window, BLOCK, BLOCK)
        out, vjp = jax.vjp(f, q, k, v)
        _, lse = JA._flash_fwd_impl(q, JA.repeat_kv(k, G),
                                    JA.repeat_kv(v, G), q_offset, causal,
                                    window, BLOCK, BLOCK)
        return out, lse, vjp(dout)

    out, lse, grads = run(q, k, v, dout)
    to_np = lambda a: np.array(a.astype(jnp.float32))  # noqa: E731
    return to_np(out), to_np(lse), tuple(to_np(g) for g in grads)


def _torch_inputs(case, dtype, requires_grad=False):
    tdt = DTYPES[dtype][1]
    return [torch.from_numpy(a).to(tdt).requires_grad_(requires_grad)
            for a in _inputs(case, dtype)]


def check_grad(what, got, want):
    """Hold ``got`` (a torch gradient) to ``want`` (numpy) by the rule of
    got's dtype, against the largest ``|want|``; returns max|d|."""
    w = torch.from_numpy(want)
    diff = (got.float() - w).abs().max()
    top = w.abs().max()
    if got.dtype == torch.bfloat16:
        bound = float(bf16_bound(top.reshape(1)))
    else:
        bound = 1e-5 * float(top)
    assert float(diff) <= bound, (what, float(diff), bound, float(top))
    return float(diff)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_backward_matches_reference_vjp(case, dtype):
    """``flash_attention_bwd_plain`` on the port's own forward (q
    pre-scaled in its dtype, ``return_lse``) == ``jax.vjp`` of the
    reference; the forward's lse == the reference's."""
    _, B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
    q, k, v, dout = _torch_inputs(case, dtype)
    want_out, want_lse, want_grads = _reference(case, dtype)
    qs = (q.float() * (1.0 / np.sqrt(D))).to(q.dtype)
    out, lse = FA.flash_attention_plain(
        qs, k, v, causal=causal, window=window, scale=1.0,
        q_offset=q_offset, block_q=BLOCK, block_k=BLOCK, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, Sq, H)
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=2e-5, atol=2e-5)
    check_grad("out", out, want_out)
    grads = FA.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, causal=causal, window=window,
        q_offset=q_offset, block_q=BLOCK, block_k=BLOCK)
    for name, got, want, like in zip("qkv", grads, want_grads, (q, k, v)):
        assert got.dtype == like.dtype and got.shape == like.shape
        check_grad(f"d{name}", got, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_layer_autograd_matches_reference_vjp(case, dtype):
    """``layers.attention.flash_attention`` under autograd (the
    ``FlashAttention`` function; KV heads unrepeated) == ``jax.vjp`` of
    the reference on repeated ones; CPU tensors launch nothing."""
    _, B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
    q, k, v, dout = _torch_inputs(case, dtype, requires_grad=True)
    want_out, _, want_grads = _reference(case, dtype)
    before = (FA.launches, FA.backward.launches)
    out = TA.flash_attention(q, k, v, q_offset=q_offset, causal=causal,
                             window=window, block_q=BLOCK, block_k=BLOCK)
    assert out.grad_fn is not None and "FlashAttention" in str(out.grad_fn)
    check_grad("out", out.detach(), want_out)
    grads = torch.autograd.grad(out, (q, k, v), dout.detach())
    for name, got, want in zip("qkv", grads, want_grads):
        check_grad(f"d{name}", got, want)
    assert (FA.launches, FA.backward.launches) == before


def test_no_grad_writes_no_lse(monkeypatch):
    """Under ``torch.no_grad()`` (and on inputs that need no gradient) the
    layer runs the forward alone: no lse, no autograd node."""
    case = CASES[1]
    q, k, v, _ = _torch_inputs(case, "bf16", requires_grad=True)
    seen = []
    real = FA.flash_attention

    def spy(*args, **kw):
        seen.append(kw.get("return_lse", False))
        return real(*args, **kw)

    monkeypatch.setattr(FA, "flash_attention", spy)
    with torch.no_grad():
        a = TA.flash_attention(q, k, v, window=100)
    b = TA.flash_attention(q.detach(), k.detach(), v.detach(), window=100)
    c = TA.flash_attention(q, k, v, window=100)
    assert seen == [False, False, True]
    assert a.grad_fn is None and b.grad_fn is None and c.grad_fn is not None
    assert torch.equal(a, b) and torch.equal(a, c.detach())


def test_backward_wrapper_takes_plain_on_cpu_and_checks_shapes():
    """On CPU tensors ``flash_attention_bwd`` is the plain version and
    counts no launch; mismatched saved tensors raise."""
    case = CASES[3]
    _, B, Sq, Sk, H, KVH, D, causal, window, q_offset = case
    q, k, v, dout = _torch_inputs(case, "f32")
    out, lse = FA.flash_attention_plain(q, k, v, q_offset=q_offset,
                                        return_lse=True)
    before = FA.backward.launches
    got = FA.flash_attention_bwd(q, k, v, out, lse, dout, q_offset=q_offset)
    want = FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                        q_offset=q_offset)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert FA.backward.launches == before
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, k, v, out, lse[:, :-1], dout)
    with pytest.raises(ValueError):
        FA.flash_attention_bwd(q, k, v, out[:, :-1], lse, dout)


def _form_inputs(layout, D, dtype):
    """q, k, v, out, dout (zeros, B 1, S 40, H 4 over 2 KV heads) laid out
    as ``layout`` says."""
    B, S, H, KVH = 1, 40, 4, 2
    q, out, dout = (torch.zeros((B, S, H, D), dtype=dtype) for _ in range(3))
    k, v = (torch.zeros((B, S, KVH, D), dtype=dtype) for _ in range(2))
    if layout == "strided":  # views of one fused projection
        q, k, v = torch.zeros((B, S, H + 2 * KVH, D), dtype=dtype).split(
            [H, KVH, KVH], dim=2)
    elif layout == "unaligned":
        q, k, v = unaligned(q), unaligned(k), unaligned(v)
    elif layout == "out unaligned":
        out = unaligned(out)
    elif layout == "dout unaligned":
        dout = unaligned(dout)
    elif layout == "dout rows 4 apart":  # a head stride of D + 4 elements
        dout = torch.zeros((B, S, H, D + 4), dtype=dtype)[..., :D]
    return q, k, v, out, dout


FORM_CASES = [("aligned", D, torch.bfloat16, True)
              for D in (64, 112, 128, 256)] + [
    ("aligned", 128, torch.float32, False),
    ("aligned", 256, torch.float32, False),
    ("aligned", 16, torch.bfloat16, False),
    ("strided", 128, torch.bfloat16, True),
    ("strided", 112, torch.bfloat16, True),
    ("unaligned", 128, torch.bfloat16, False),
    ("out unaligned", 256, torch.bfloat16, False),
    ("dout unaligned", 64, torch.bfloat16, False),
    ("dout rows 4 apart", 64, torch.bfloat16, False),
]


@pytest.mark.parametrize("layout,D,dtype,want", FORM_CASES,
                         ids=[f"{c[0]}-D{c[1]}-{str(c[2])[6:]}"
                              for c in FORM_CASES])
def test_backward_form_by_inputs(layout, D, dtype, want):
    """The backward's form is chosen by its inputs alone: aligned bf16 at
    head_dim 64, 112, 128 or 256 (q, k, v as strided views of one fused
    projection too) take the tensor-core form at ``TC_BWD_TILES``'
    tiles; float32, head_dim 16, and unaligned rows of q, k, v, out or
    dout take the FMA form at its own (64, or 32 past head_dim 128).  The
    kernel refuses a launch whose form the wrapper did not expect, so this
    predicate is the one the card runs."""
    q, k, v, out, dout = _form_inputs(layout, D, dtype)
    assert FA.backward_tensor_core_form(q, k, v, out, dout) == want
    tiles = FA.backward_tiles(q, k, v, out, dout)
    assert tiles["tensor_cores"] == int(want)
    want_tiles = FA.TC_BWD_TILES[D] if want else (32 if D > 128 else 64,) * 4
    assert (tiles["dkdv_keys"], tiles["dkdv_rows"], tiles["dq_rows"],
            tiles["dq_keys"]) == want_tiles
    if layout in ("out unaligned", "dout unaligned", "dout rows 4 apart"):
        assert FA.tensor_core_form(q, k, v)  # kernel 5 would take them


@pytest.mark.parametrize("layer,tensor_cores,want", [
    ("qwen3-4b", True, 1), ("qwen3-4b", False, 1),
    ("recurrentgemma-9b", True, 8), ("recurrentgemma-9b", False, 4),
    ("stablelm-1.6b", True, 1), ("kimi-k2-1t-a32b", True, 4),
])
def test_dkdv_splits_at_the_training_layers(layer, tensor_cores, want):
    """The dk/dv kernel's head splits on a 132-SM card at the training
    layers of ``attention_checks.FLASH_BWD_MODEL_CASES``: none where its
    CTAs fill a wave (qwen3-4b: 256 tensor-core CTAs, 512 FMA ones; the
    splits measured slower there), else enough to fill ``DKDV_WAVES``
    waves (recurrentgemma-9b's MQA layer: 64 CTAs -> 8 splits, the fastest
    measured; 128 FMA CTAs -> 4)."""
    from repro_torch.testing.attention_checks import FLASH_BWD_MODEL_CASES
    case = next(c for c in FLASH_BWD_MODEL_CASES if c[0] == layer)
    _, B, Sq, Sk, H, KVH, D, *_ = case
    keys = FA.TC_BWD_TILES[D][0] if tensor_cores else (32 if D > 128 else 64)
    assert FA.dkdv_splits(B, Sk, KVH, H // KVH, keys, 132) == want
