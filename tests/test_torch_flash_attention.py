"""Kernel 5's plain version and the port's attention layer against JAX.

Inputs are drawn with numpy from a seed and handed to both packages.
Tolerances (``repro_torch.testing.attention_checks``):

* float32: ``|d| <= 2e-5 + 2e-5 |ref|`` (the reference's rule for its
  Pallas kernel, ``tests/test_kernels.py``);
* bf16: 2 bf16 ulps of the row's largest ``|ref|`` (ROADMAP Queue 3, F3).

``flash_attention_plain`` is held against ``flash_attention_pallas`` in
interpret mode (the TPU kernel's semantics: the f32 logits are scaled) at
the Pallas tiles, and the port's ``attention.flash_attention`` against
the reference layer (q pre-scaled in its own dtype), including head_dim
128, where 1/sqrt(128) is no power of two and the two scalings differ.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro.layers import attention as JA  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.layers import attention as TA  # noqa: E402
from repro_torch.testing.attention_checks import check_close  # noqa: E402

torch.set_num_threads(1)

DTYPES = {"f32": (np.float32, jnp.float32, torch.float32),
          "bf16": (None, jnp.bfloat16, torch.bfloat16)}
MASKS = [(True, 0), (False, 0), (True, 64)]


def _pair(shape, dtype, seed):
    """The same random values as a JAX array and a torch tensor."""
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    _, jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(a).astype(jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(tdt)
    return j, t


def _to_torch(j, dtype):
    return torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_pallas_interpret(dtype, causal, window):
    """Plain version == the TPU kernel run by the Pallas interpreter, on
    its (B*H, S, D) layout at its own 128 x 128 tiles, default scale."""
    BH, S, D = 2, 256, 64
    (jq, tq), (jk, tk), (jv, tv) = (_pair((BH, S, D), dtype, s)
                                    for s in (1, 2, 3))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  block_q=128, block_k=128, interpret=True)
    got = FA.flash_attention_plain(tq[:, :, None], tk[:, :, None],
                                   tv[:, :, None], causal=causal,
                                   window=window, block_q=128, block_k=128)
    check_close("plain vs pallas", got[:, :, 0], _to_torch(want, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_matches_pallas_interpret_head_dim_128(dtype):
    """head_dim 128: the kernel's default scale 1/sqrt(128) applies to the
    float32 logits, as the Pallas kernel applies it."""
    BH, S, D = 2, 128, 128
    (jq, tq), (jk, tk), (jv, tv) = (_pair((BH, S, D), dtype, s)
                                    for s in (4, 5, 6))
    want = flash_attention_pallas(jq, jk, jv, causal=True, block_q=64,
                                  block_k=64, interpret=True)
    got = FA.flash_attention_plain(tq[:, :, None], tk[:, :, None],
                                   tv[:, :, None], causal=True)
    check_close("plain vs pallas D128", got[:, :, 0], _to_torch(want, dtype))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("S,H,KVH,D", [(300, 4, 2, 128), (1100, 4, 1, 64)],
                         ids=["S300-gqa2-D128", "S1100-gqa4-D64"])
def test_layer_matches_reference_layer(dtype, causal, window, S, H, KVH, D):
    """The port's layer (KV heads read in place, q pre-scaled, the plain
    version at the reference's chunking) == the reference layer given the
    GQA-repeated k/v.  S = 1100 is chunked 4 x 275 by both."""
    B = 1
    jq, tq = _pair((B, S, H, D), dtype, 7)
    jk, tk = _pair((B, S, KVH, D), dtype, 8)
    jv, tv = _pair((B, S, KVH, D), dtype, 9)
    G = H // KVH
    want = JA.flash_attention(jq, JA.repeat_kv(jk, G), JA.repeat_kv(jv, G),
                              0, causal, window, 512, 512)
    got = TA.flash_attention(tq, tk, tv, causal=causal, window=window)
    check_close("layer vs reference", got, _to_torch(want, dtype))


def test_layer_with_q_offset_matches_reference():
    """Queries at positions 100..163 over 164 keys (a chunk of a longer
    prompt), causal with a window."""
    jq, tq = _pair((2, 64, 4, 64), "f32", 10)
    jk, tk = _pair((2, 164, 4, 64), "f32", 11)
    jv, tv = _pair((2, 164, 4, 64), "f32", 12)
    want = JA.flash_attention(jq, jk, jv, 100, True, 48, 32, 64)
    got = TA.flash_attention(tq, tk, tv, q_offset=100, causal=True,
                             window=48, block_q=32, block_k=64)
    check_close("q_offset", got, _to_torch(want, "f32"))


def test_layer_prescales_q_and_the_two_scalings_differ_at_d128():
    """At head_dim 128 the layer's result is exactly the kernel's run on
    q pre-scaled in bf16 with scale 1, and that differs from the kernel's
    own scaling of the logits (the reason the layer passes scale=1)."""
    _, q = _pair((1, 256, 4, 128), "bf16", 13)
    _, k = _pair((1, 256, 2, 128), "bf16", 14)
    _, v = _pair((1, 256, 2, 128), "bf16", 15)
    got = TA.flash_attention(q, k, v)
    qs = (q.float() * (1.0 / np.sqrt(128))).to(torch.bfloat16)
    pre = FA.flash_attention_plain(qs, k, v, scale=1.0, block_q=256,
                                   block_k=256)
    assert torch.equal(got, pre)
    own = FA.flash_attention_plain(q, k, v, block_q=256, block_k=256)
    assert not torch.equal(got, own)
    check_close("pre-scaled vs logit-scaled", own, got)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ragged_tiles_and_gqa_in_place(dtype):
    """S = 1100 at the kernel's 64 x 64 tiles (a ragged last tile) against
    the reference's chunking of the same function, and GQA read in place
    against GQA-repeated k/v."""
    _, q = _pair((1, 1100, 8, 64), dtype, 16)
    _, k = _pair((1, 1100, 2, 64), dtype, 17)
    _, v = _pair((1, 1100, 2, 64), dtype, 18)
    for causal, window in MASKS:
        ragged = FA.flash_attention_plain(q, k, v, causal=causal,
                                          window=window)
        chunked = FA.flash_attention_plain(
            q, TA.repeat_kv(k, 4), TA.repeat_kv(v, 4), causal=causal,
            window=window, block_q=275, block_k=275)
        check_close(f"ragged causal={causal} window={window}", ragged,
                    chunked)


def test_cpu_tensors_take_the_plain_version():
    """On CPU tensors the wrapper is the plain version and launches
    nothing; on any other device it would launch the kernel or raise."""
    _, q = _pair((1, 80, 4, 16), "bf16", 19)
    _, k = _pair((1, 80, 2, 16), "bf16", 20)
    before = FA.launches
    got = FA.flash_attention(q, k, k, causal=True, window=16)
    want = FA.flash_attention_plain(q, k, k, causal=True, window=16)
    assert torch.equal(got, want) and FA.launches == before
    with pytest.raises(ValueError):
        FA.flash_attention(q, k[:, :, :1, :8], k[:, :, :1, :8])


def test_full_attention_matches_reference():
    """The short-sequence path (S <= 1024 in the model), bf16, GQA-repeated,
    causal with and without a window."""
    jq, tq = _pair((2, 48, 4, 16), "bf16", 21)
    jk, tk = _pair((2, 48, 4, 16), "bf16", 22)
    jv, tv = _pair((2, 48, 4, 16), "bf16", 23)
    for window in (0, 8):
        want = JA.full_attention(jq, jk, jv, causal=True, window=window)
        got = TA.full_attention(tq, tk, tv, causal=True, window=window)
        check_close(f"full window={window}", got, _to_torch(want, "bf16"))


def test_pick_block_and_repeat_kv_match_reference():
    for n, target in ((4096, 512), (1100, 512), (1500, 512), (7, 512),
                      (97, 16)):
        assert TA._pick_block(n, target) == JA._pick_block(n, target)
    jk, tk = _pair((2, 5, 3, 8), "f32", 24)
    np.testing.assert_array_equal(TA.repeat_kv(tk, 4).numpy(),
                                  np.asarray(JA.repeat_kv(jk, 4)))
    assert math.isclose(FA.NEG_INF, JA.NEG_INF)
