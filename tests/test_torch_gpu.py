"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  On a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import functools

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


def test_int8_matmul_kernel_matches_plain(cuda):
    """Every case of ``repro_torch.testing.gemm_checks`` (each kernel
    instance and split of K the plan picks, the three epilogues under a
    split, ragged and byte-copied shapes, the serving shapes) and the all
    -128 extremes, split and unsplit: zero differing elements, one launch a
    call, the same bits from a second launch at the same shape."""
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.testing import gemm_checks as GC

    gen = torch.Generator(device=cuda).manual_seed(0)

    def ints(shape, lo, hi, dtype):
        return torch.randint(lo, hi, shape, generator=gen, device=cuda,
                             dtype=dtype)

    for M, K, N, odt in GC.CASES:
        x = ints((M, K), -128, 128, torch.int8)
        w = ints((K, N), -127, 128, torch.int8)
        fold = ints((N,), -(2**20), 2**20, torch.int32)
        m0 = ints((N,), 1 << 30, 2**31 - 1, torch.int32)
        shift = ints((N,), -20, 2, torch.int32)
        before = K1.launches
        got = K1.int8_matmul(x, w, fold, m0, shift, out_dtype=odt, zp_out=-3)
        assert K1.launches == before + 1
        want = K1.int8_matmul_plain(x, w, fold, m0, shift, out_dtype=odt,
                                    zp_out=-3)
        assert torch.equal(got, want), (M, K, N, odt)
    for M, K, N in ((4, 2048, 8192), (128, 2048, 8192)):
        x, w, fold = GC.extreme_operands(M, K, N, cuda)
        want = K1.int8_matmul_plain(x, w, fold)
        assert int(want[0, 0]) == K * 2**14
        for _ in range(2):
            assert torch.equal(K1.int8_matmul(x, w, fold), want), (M, K, N)


@pytest.mark.parametrize("vi", [0, 5, 10, 15])
def test_scan_kernel_matches_plain(cuda, vi):
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    variant = L.ALL_VARIANTS[vi]
    cfg = L.LSTMConfig(9, 13, 6 if variant.use_projection else 0, variant)
    gen = torch.Generator(device=cuda).manual_seed(vi)
    params = L.init_lstm_params(gen, cfg, cuda)
    xs = 0.8 * torch.randn((3, 5, 9), generator=gen, device=cuda)
    col = TapCollector()
    L.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_lstm_layer(params, cfg, stats)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    acc = K1.int8_matmul_plain(xs_q.reshape(15, 9), arrays["W_cat"],
                               arrays["fold_x_cat"]).reshape(3, 5, -1)
    state0 = QL.initial_recurrent_state(spec, 3, cuda)
    _, carried = K2.quant_recurrent_seq_scan_plain(arrays, spec, acc, state0)
    # from the reset state, then one decode-shaped step from the carried one
    for a, st in ((acc, state0), (acc[:, :1].contiguous(), carried)):
        for vl in (None, torch.tensor([5, 0, 1], dtype=torch.int32,
                                      device=cuda)):
            ys, (h, c) = K2.quant_recurrent_seq_scan(arrays, spec, a, st, vl)
            pys, (ph, pc) = K2.quant_recurrent_seq_scan_plain(arrays, spec, a,
                                                              st, vl)
            assert torch.equal(ys, pys) and torch.equal(h, ph)
            assert torch.equal(c, pc)


def _gru_layer(cuda, ln, seed, d_in=9, H=13, B=3, T=5):
    """A small GRU layer quantized by the port's own recipe on the card."""
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.models import gru as G

    cfg = G.GRUConfig(d_in, H, G.GRUVariant(use_layernorm=ln))
    gen = torch.Generator(device=cuda).manual_seed(seed)
    params = G.init_gru_params(gen, cfg, cuda)
    if ln:
        for g in params["L"]:
            params["L"][g] = 1.0 + 0.3 * torch.randn(H, generator=gen,
                                                     device=cuda)
    xs = 0.8 * torch.randn((B, T, d_in), generator=gen, device=cuda)
    col = TapCollector()
    G.gru_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    return R.quantize_gru_layer(params, cfg, stats), xs


@pytest.mark.parametrize("ln", [False, True], ids=["noLN", "LN"])
def test_gru_scan_kernel_matches_plain(cuda, ln):
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_gru_scan as KG
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.models import quant_lstm as QL

    (arrays, spec), xs = _gru_layer(cuda, ln, seed=int(ln))
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    acc = K1.int8_matmul_plain(xs_q.reshape(15, 9), arrays["W_cat"],
                               arrays["fold_x_cat"]).reshape(3, 5, -1)
    state0 = QL.initial_recurrent_state(spec, 3, cuda)
    _, carried = K2.quant_recurrent_seq_scan_plain(arrays, spec, acc, state0)
    assert bool(carried[0].ne(spec.zp_h).any())
    for a, st in ((acc, state0), (acc[:, :1].contiguous(), carried)):
        for vl in (None, torch.tensor([5, 0, 1], dtype=torch.int32,
                                      device=cuda)):
            before = KG.launches
            ys, (h,) = K2.quant_recurrent_seq_scan(arrays, spec, a, st, vl)
            assert KG.launches == before + 1
            pys, (ph,) = K2.quant_recurrent_seq_scan_plain(arrays, spec, a,
                                                           st, vl)
            assert torch.equal(ys, pys) and torch.equal(h, ph)


def test_cuda_gru_layer_never_reaches_plain(cuda, monkeypatch):
    """With every plain version made to raise, a CUDA GRU layer still runs:
    nothing on the CUDA path falls back to the plain versions."""
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_gru_scan as KG
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.kernels import ref
    from repro_torch.models import quant_lstm as QL

    (arrays, spec), xs = _gru_layer(cuda, True, seed=5)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((K2, "quant_recurrent_seq_scan_plain"),
                      (K1, "int8_matmul_plain"), (ref, "recurrent_step"),
                      (ref, "quant_gru_recurrent")):
        monkeypatch.setattr(mod, name, refuse)
    before = (K1.launches, KG.launches)
    ys, (h,) = QL.quant_recurrent_layer(arrays, spec, xs_q)
    ys_m, _ = QL.quant_recurrent_layer(
        arrays, spec, xs_q,
        valid_len=torch.tensor([5, 2, 0], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    assert (K1.launches, KG.launches) == (before[0] + 2, before[1] + 2)
    assert ys.shape == (3, 5, 13) and ys.is_cuda
    assert torch.equal(ys_m[0], ys[0])


def test_fixedpoint_header_on_card_matches_port(cuda):
    from repro_torch.kernels import fixedpoint_check as FC

    c = FC.cases(seed=1)
    got = FC.on_card(c, cuda)
    for key, want in FC.expected(c, cuda).items():
        assert torch.equal(got[key], want), key


def test_serve_smoke_launches_each_kernel_per_layer_and_step(cuda):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    cfg = get_config("lstm-rnnt", smoke=True)
    params, qlayers = serve.build_model(cfg, 2, 5, cuda)
    res = serve.serve(params, qlayers, cfg, serve.random_prompt(cfg, 2, 5, cuda),
                      3)
    expect = cfg.n_layers * (1 + 3)
    assert res.launches == {"int8_matmul": expect, "quant_lstm_scan": expect,
                            "quant_gru_scan": 0, "int_layernorm": 0,
                            "quant_lstm_cell": 0, "flash_attention": 0,
                            "flash_attention_bwd": 0}
    assert tuple(res.tokens.shape) == (2, 3)


def test_engine_smoke_gru_launches_and_matches_decode_single(cuda):
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import engine as E
    from repro_torch.launch import serve

    cfg = get_config("gru-rnnt", smoke=True)
    params, qlayers = serve.build_model(cfg, 2, 8, cuda)
    requests = E.synthetic_trace(6, cfg.vocab_size, seed=3,
                                 prompt_lens=(3, 6), gen_lens=(2, 5))
    eng = E.ContinuousBatchingEngine(params, qlayers, cfg, n_slots=2,
                                     chunk=4, speculate=2, policy="srf",
                                     oversubscribe=2.0)
    eng.submit_all(requests)
    serve.reset_launch_counts()
    results, stats = eng.run()
    counts = serve.launch_counts()
    assert counts["quant_gru_scan"] > 0 and counts["quant_lstm_scan"] == 0
    assert counts["int8_matmul"] == counts["quant_gru_scan"]
    for r in requests:
        assert results[r.rid].tokens == E.decode_single(
            params, qlayers, cfg, r.prompt, r.max_new_tokens)


def _fleet_on_card(cuda, spec, arrivals, kill, **router_kw):
    """A 2-shard fleet run of smoke ``lstm-rnnt`` on the card (both shards
    on it): ``(requests, results, stats, launches, decode_single by
    rid)``."""
    import numpy as np

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import engine as E
    from repro_torch.launch import fleet as F
    from repro_torch.launch import serve

    cfg = get_config("lstm-rnnt", smoke=True)
    params, qlayers = serve.build_model(cfg, 2, 8, cuda)
    rng = np.random.default_rng(7)
    requests = [E.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                     size=(p,)),
                          max_new_tokens=g, arrival=float(a))
                for i, ((p, g), a) in enumerate(zip(spec, arrivals))]
    router = F.FleetRouter(params, qlayers, cfg, n_shards=2,
                           slots_per_shard=2,
                           injector=F.FaultInjector(kills=[kill]),
                           **router_kw)
    router.warmup()
    router.submit_all(requests)
    serve.reset_launch_counts()
    results, stats = router.run()
    launches = serve.launch_counts()
    singles = {r.rid: E.decode_single(params, qlayers, cfg, r.prompt,
                                      r.max_new_tokens) for r in requests}
    return requests, results, stats, launches, singles


def _assert_fleet_served(requests, results, launches, singles):
    assert launches["quant_lstm_scan"] > 0
    assert launches["int8_matmul"] == launches["quant_lstm_scan"]
    assert all(v == 0 for k, v in launches.items()
               if k not in ("int8_matmul", "quant_lstm_scan"))
    for r in requests:
        assert not results[r.rid].truncated
        assert results[r.rid].tokens == singles[r.rid], r.rid


def test_fleet_hard_kill_on_card_matches_decode_single(cuda):
    """The acceptance case of ``tests/test_fleet.py`` on the card: a hard
    kill of shard 0 at fleet step 5 migrates a pooled stream and replays
    the residents, and every stream equals ``decode_single``."""
    requests, results, stats, launches, singles = _fleet_on_card(
        cuda, [(3, 12)] * 4 + [(2, 3)] * 2, [0, 0, 0, 0, 2, 2],
        dict(shard=0, at_step=5), oversubscribe=2.0, policy="srf")
    assert stats.kills == 1 and stats.completed == len(requests)
    assert stats.migrated_streams >= 1 and stats.replayed_streams >= 1
    _assert_fleet_served(requests, results, launches, singles)


def test_fleet_graceful_drain_on_card_matches_decode_single(cuda):
    requests, results, stats, launches, singles = _fleet_on_card(
        cuda, [(2, 9), (3, 7), (5, 6), (2, 8)], [0, 0, 0, 0],
        dict(shard=0, at_step=5, graceful=True))
    assert stats.kills == 1 and stats.replayed_streams == 0
    assert stats.migrated_streams >= 1
    _assert_fleet_served(requests, results, launches, singles)


@functools.lru_cache(maxsize=None)
def _step_cases():
    from repro_torch.testing import kernel_cases

    return kernel_cases.step_cases(torch.device("cuda", 0))


@pytest.mark.parametrize("B,H", [(8, 256), (16, 1024), (4, 2048), (4, 1001),
                                 (2, 16384), (2, 600), (2, 1100), (2, 1300),
                                 (2, 1600), (2, 1900), (132, 16384)])
def test_cell_kernel_matches_plain(cuda, B, H):
    """The TPU-contract entry at (B, H), then the step entry on every
    ``kernel_cases.step_cases`` case of that shape: one launch a call, the
    plain version's bits, twice back to back."""
    from repro_torch.kernels import quant_lstm_cell as K3
    from repro_torch.testing import kernel_cases

    gen = torch.Generator(device=cuda).manual_seed(B + H)
    for label, kw in kernel_cases.cell_cases(B, H, gen):
        before = K3.launches
        got = K3.quant_lstm_cell(**kw)
        assert K3.launches == before + 1
        want = K3.quant_lstm_cell_plain(**kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), \
            label
    steps = [kw for _, kw in _step_cases()[1] if kw["c_q"].shape == (B, H)]
    assert steps
    for kw in steps:
        want = K3.quant_lstm_cell_step_plain(**kw)
        for _ in range(2):
            before = K3.launches
            got = K3.quant_lstm_cell_step(**kw)
            assert K3.launches == before + 1
            assert torch.equal(got[0], want[0]) and torch.equal(
                got[1], want[1])


def test_layernorm_kernel_matches_plain(cuda):
    """The TPU-contract entry at row lengths 1..16384, then the gate pass on
    every ``kernel_cases.step_cases`` case (each shape and LN layer, the
    row split over 1..8 CTAs), twice back to back."""
    from repro_torch.kernels import int_layernorm as K2
    from repro_torch.testing import kernel_cases

    gen = torch.Generator(device=cuda).manual_seed(2)
    for n in kernel_cases.LN_LENGTHS:
        label, kw = kernel_cases.layernorm_case(n, gen)
        before = K2.launches
        got = K2.int_layernorm(**kw)
        assert K2.launches == before + 1
        assert torch.equal(got, K2.int_layernorm_plain(**kw)), label
    for label, kw in _step_cases()[0]:
        want = K2.int_layernorm_gates_plain(**kw)
        for _ in range(2):
            before = K2.launches
            got = K2.int_layernorm_gates(**kw)
            assert K2.launches == before + 1
            assert torch.equal(got, want), label


def _refuse_plain_versions(monkeypatch):
    """Make every plain version raise: a CUDA path must not reach one."""
    from repro_torch.core import integer_ops as iops
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import int_layernorm as KL
    from repro_torch.kernels import quant_lstm_cell as KC
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.kernels import ref

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached a plain version")

    for mod, name in ((K2, "quant_recurrent_seq_scan_plain"),
                      (K1, "int8_matmul_plain"), (KL, "int_layernorm_plain"),
                      (KL, "int_layernorm_gates_plain"),
                      (KC, "quant_lstm_cell_plain"),
                      (KC, "quant_lstm_cell_step_plain"),
                      (ref, "lstm_gate_acc"), (ref, "recurrent_step"),
                      (ref, "quant_lstm_cell"), (ref, "quant_gru_recurrent"),
                      (ref, "lstm_project"), (iops, "integer_layernorm")):
        monkeypatch.setattr(mod, name, refuse)


@pytest.mark.parametrize("vi", [10, 12, 15])
def test_cuda_stepwise_lstm_layer_never_reaches_plain(cuda, monkeypatch, vi):
    """A stepwise LSTM layer on CUDA runs the GEMM, the gate pass (one
    LayerNorm launch a step) and the cell kernel only, and equals the
    hoisted sequence kernel."""
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import int_layernorm as KL
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_lstm_cell as KC
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    variant = L.ALL_VARIANTS[vi]
    assert variant.use_layernorm
    cfg = L.LSTMConfig(9, 13, 6 if variant.use_projection else 0, variant)
    gen = torch.Generator(device=cuda).manual_seed(vi)
    params = L.init_lstm_params(gen, cfg, cuda)
    xs = 0.8 * torch.randn((3, 5, 9), generator=gen, device=cuda)
    col = TapCollector()
    L.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_lstm_layer(params, cfg, stats)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    hoisted = QL.quant_recurrent_layer(arrays, spec, xs_q)
    _refuse_plain_versions(monkeypatch)
    before = (K1.launches, KL.launches, KC.launches)
    state0 = QL.initial_recurrent_state(spec, 3, cuda)
    ys, state = ops.quant_recurrent_seq_stepwise(arrays, spec, xs_q, state0)
    torch.cuda.synchronize()
    gemms = 2 + int(variant.use_projection)
    assert (K1.launches, KL.launches, KC.launches) == (
        before[0] + 5 * gemms, before[1] + 5, before[2] + 5)
    assert torch.equal(ys, hoisted[0])
    for leaf, want in zip(state, hoisted[1]):
        assert torch.equal(leaf, want)


def test_cuda_stepwise_gru_layer_never_reaches_plain(cuda, monkeypatch):
    """A stepwise GRU layer on CUDA runs the input GEMM and the GRU
    sequence kernel over one timestep per step, and equals the hoisted
    kernel."""
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import ops
    from repro_torch.kernels import quant_gru_scan as KG
    from repro_torch.models import quant_lstm as QL

    (arrays, spec), xs = _gru_layer(cuda, True, seed=6)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    hoisted = QL.quant_recurrent_layer(arrays, spec, xs_q)
    _refuse_plain_versions(monkeypatch)
    before = (K1.launches, KG.launches)
    ys, (h,) = ops.quant_recurrent_seq_stepwise(
        arrays, spec, xs_q, QL.initial_recurrent_state(spec, 3, cuda))
    torch.cuda.synchronize()
    assert (K1.launches, KG.launches) == (before[0] + 5, before[1] + 5)
    assert torch.equal(ys, hoisted[0]) and torch.equal(h, hoisted[1][0])


@pytest.mark.parametrize("shape", [(2, 4, 4, 256, 64), (1, 32, 8, 1100, 128),
                                   (2, 32, 8, 4096, 128), (2, 4, 2, 300, 256),
                                   (1, 16, 1, 1100, 256), (2, 4, 2, 300, 112),
                                   (1, 64, 8, 2048, 112)],
                         ids=["S256-D64", "S1100-D128", "S4096-D128",
                              "S300-D256", "S1100-D256", "S300-D112",
                              "S2048-D112"])
def test_flash_kernel_matches_plain(cuda, shape):
    """Kernel 5 against its plain version at its own tiles, on the shapes
    ``chip_smoke.py`` checks: float32 and bf16, its own scale and q
    pre-scaled, causal / non-causal / window 64, and at head_dim 112 and
    256 also a window of 300, whose edge falls inside a key tile (float32
    within 2e-5 + 2e-5 |ref|, bf16 within 2 ulps of the row's largest
    |ref|)."""
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.testing import attention_checks as AC

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(sum(shape))
    masks = (AC.FLASH_MASKS_D256 if shape[-1] in (112, 256)
             else AC.FLASH_MASKS)
    for label, kw in AC.flash_cases(gen, shapes=(shape,), masks=masks):
        before = KF.launches
        got = KF.flash_attention(**kw)
        assert KF.launches == before + 1
        AC.check_close(label, got, KF.flash_attention_plain(
            **kw, **KF.kernel_tiles(kw["q"], kw["k"], kw["v"])))


@pytest.mark.parametrize("D", [64, 112, 128, 256])
def test_flash_tensor_core_form_never_reaches_plain(cuda, monkeypatch, D):
    """The TMA + wgmma form of kernel 5 (bf16, aligned rows) on a ragged
    GQA prefill shape and on a strided view (q, k, v as slices of one
    fused projection, read in place), with the plain version patched to
    raise: one launch each, within 2 bf16 ulps of the plain version
    computed before the patch."""
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.testing import attention_checks as AC

    gen = torch.Generator(device=cuda).manual_seed(D)
    B, S, H, KVH = 2, 1100, 8, 2
    qkv = torch.randn((B, S, H + 2 * KVH, D), generator=gen,
                      device=cuda).bfloat16()
    q, k, v = qkv.split([H, KVH, KVH], dim=2)  # strided views
    cases = [(q, k, v, dict(causal=True, window=0)),
             (q.contiguous(), k.contiguous(), v.contiguous(),
              dict(causal=True, window=300))]
    wants = []
    for qq, kk, vv, kw in cases:
        assert KF.tensor_core_form(qq, kk, vv)
        wants.append(KF.flash_attention_plain(qq, kk, vv, **kw,
                                              **KF.kernel_tiles(qq, kk, vv)))

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(KF, "flash_attention_plain", refuse)
    for (qq, kk, vv, kw), want in zip(cases, wants):
        before = KF.launches
        got = KF.flash_attention(qq, kk, vv, **kw)
        torch.cuda.synchronize()
        assert KF.launches == before + 1
        AC.check_close(f"D{D} {kw}", got, want)


@pytest.mark.parametrize("B", [1, 16, 64])
def test_scan_kernels_match_plain_at_batch(cuda, B):
    """The cooperative sequence kernels at one, 16 and 64 batch rows (64
    pass in two groups at full width): four LSTM variants and both GRU
    variants, a width the split leaves ragged (H = 40: one unit a CTA) and
    a full-width layer of each, unmasked and masked, bit-exact."""
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    def lstm_layer(variant, d_in, H, d_proj, seed):
        cfg = L.LSTMConfig(d_in, H, d_proj if variant.use_projection else 0,
                           variant)
        gen = torch.Generator(device=cuda).manual_seed(seed)
        params = L.init_lstm_params(gen, cfg, cuda)
        xs = 0.8 * torch.randn((B, 6, d_in), generator=gen, device=cuda)
        col = TapCollector()
        L.lstm_layer(params, cfg, xs, collector=col)
        stats = Stats()
        stats.merge(col.snapshot())
        return R.quantize_lstm_layer(params, cfg, stats), xs

    layers = [lstm_layer(L.ALL_VARIANTS[vi], 9, 40, 6, vi)
              for vi in (0, 5, 10, 15)]
    layers.append(lstm_layer(L.LSTMVariant(use_layernorm=True,
                                           use_projection=True),
                             640, 2048, 640, 7))
    layers += [_gru_layer(cuda, ln, seed=7 + int(ln), d_in=9, H=40, B=B,
                          T=6) for ln in (False, True)]
    layers.append(_gru_layer(cuda, True, seed=9, d_in=64, H=2048, B=B, T=6))
    valid = torch.tensor(([6, 2, 0, 5] * 16)[:B] if B > 1 else [3],
                         dtype=torch.int32, device=cuda)
    for (arrays, spec), xs in layers:
        xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
        acc = K1.int8_matmul_plain(
            xs_q.reshape(B * 6, -1), arrays["W_cat"],
            arrays["fold_x_cat"]).reshape(B, 6, -1)
        state0 = QL.initial_recurrent_state(spec, B, cuda)
        for vl in (None, valid):
            got = K2.quant_recurrent_seq_scan(arrays, spec, acc, state0, vl)
            want = K2.quant_recurrent_seq_scan_plain(arrays, spec, acc,
                                                     state0, vl)
            assert torch.equal(got[0], want[0])
            for g, w in zip(got[1], want[1], strict=True):
                assert torch.equal(g, w)


def test_cuda_lstm_layer_never_reaches_plain(cuda, monkeypatch):
    """With every plain version made to raise, a CUDA LSTM layer (LN +
    projection + peephole, B = 16) runs on the GEMM and the cooperative
    sequence kernel only, one launch each per call."""
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    variant = L.LSTMVariant(use_layernorm=True, use_projection=True,
                            use_peephole=True)
    cfg = L.LSTMConfig(24, 300, 96, variant)
    gen = torch.Generator(device=cuda).manual_seed(4)
    params = L.init_lstm_params(gen, cfg, cuda)
    xs = 0.8 * torch.randn((16, 7, 24), generator=gen, device=cuda)
    col = TapCollector()
    L.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_lstm_layer(params, cfg, stats)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    want = QL.quant_recurrent_layer(arrays, spec, xs_q)
    _refuse_plain_versions(monkeypatch)
    before = (K1.launches, K2.launches)
    ys, (h, c) = QL.quant_recurrent_layer(arrays, spec, xs_q)
    torch.cuda.synchronize()
    assert (K1.launches, K2.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(ys, want[0]) and torch.equal(h, want[1][0])
    assert torch.equal(c, want[1][1])


def test_cuda_transformer_prefill_never_reaches_plain(cuda, monkeypatch):
    """A CUDA prefill at S > 1024 of ``qwen3-4b-smoke`` (head_dim 16, GQA
    4:2) runs with the flash plain version patched to raise, launching the
    kernel once per layer; a prefill at S <= 1024 launches it never."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.launch import serve
    from repro_torch.runtime import train_loop

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA prefill reached the plain version")

    monkeypatch.setattr(KF, "flash_attention_plain", refuse)
    cfg = get_config("qwen3-4b", smoke=True)
    bundle, params = serve.build_bundle(cfg, cuda)
    prefill, _ = train_loop.make_serve_fns(bundle, cuda, 2, 1100)
    for S, launched in ((1100, cfg.n_layers), (64, 0)):
        before = KF.launches
        logits = prefill(params, {"tokens": serve.random_prompt(
            cfg, 2, S, cuda)})
        torch.cuda.synchronize()
        assert KF.launches == before + launched
        assert logits.shape == (2, cfg.vocab_size)
        assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ["grok-1-314b", "kimi-k2-1t-a32b"])
def test_moe_on_card(cuda, arch):
    """The MoE smoke models on the card: a layer's output the same bits in
    two runs (the combine adds in a fixed order, no atomics); the float32
    model's prefill (TF32 off) within ``float_checks.CARD_CPU_RTOL`` of
    the row's largest |logit| of the CPU's on the same weights; an int8
    static serve launches no kernel."""
    from repro_torch import tree_util as tu
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.layers import moe
    from repro_torch.runtime import train_loop
    from repro_torch.testing.attention_checks import check_logits
    from repro_torch.testing.float_checks import CARD_CPU_RTOL, params_to

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    bundle, params = serve.build_bundle(cfg, cuda)
    p = {k: v[0] for k, v in params["layers"].items()}
    x = torch.randn((64, cfg.d_model), device=cuda).bfloat16()
    kw = dict(n_experts=cfg.n_experts, topk=cfg.topk,
              capacity_factor=cfg.capacity_factor)
    assert torch.equal(moe.moe_apply_local(p, x, **kw),
                       moe.moe_apply_local(p, x, **kw))
    p32 = tu.tree_map(lambda t: t.float(), params)
    toks = serve.random_prompt(cfg, 2, 16, cuda)
    card, _ = train_loop.make_serve_fns(bundle, cuda, 2, 16)
    host, _ = train_loop.make_serve_fns(bundle, "cpu", 2, 16)
    check_logits(f"{arch} card vs CPU", card(p32, {"tokens": toks}).cpu(),
                 host(params_to(p32, "cpu"), {"tokens": toks.cpu()}),
                 limit=CARD_CPU_RTOL)
    qb, qp = serve.build_bundle(cfg, cuda, "int8")
    res = serve.serve_bundle(qb, qp, toks[:, :4], 3, 16, quantized_cache=True)
    assert all(n == 0 for n in res.launches.values()), res.launches
    assert res.tokens.shape == (2, 3)


@pytest.mark.parametrize("arch", ["lstm-rnnt", "gru-rnnt"])
def test_float_lm_on_card(cuda, arch):
    """The float stack (smoke width) on the card: teacher-forced decode
    gives forward's last logits (F3), the card's stack equals the CPU's on
    the same weights within ``CARD_CPU_RTOL`` a layer, and no kernel
    launches (the float path runs plain PyTorch products)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lstm_lm
    from repro_torch.testing import float_checks as FC

    cfg = get_config(arch, smoke=True)
    gen = torch.Generator(device=cuda).manual_seed(3)
    params = lstm_lm.init_params(gen, cfg, cuda)
    prompt = torch.randint(0, cfg.vocab_size, (4, 8), generator=gen,
                           device=cuda)
    before = serve.launch_counts()
    dec, fwd = FC.decode_against_forward(params, cfg, prompt)
    FC.check_logits_f3("decode against forward", dec, fwd)
    errs = FC.card_against_cpu(params, FC.params_to(params, "cpu"), cfg,
                               prompt[:, :4])
    assert max(v for k, v in errs.items() if k.startswith("layer")) <= \
        FC.CARD_CPU_RTOL
    assert serve.launch_counts() == before


def test_fake_quant_card_matches_cpu(cuda):
    from repro_torch.testing import float_checks as FC

    gen = torch.Generator(device=cuda).manual_seed(4)
    assert FC.fake_quant_card_against_cpu(gen, cuda) == 7 * 10**6


@pytest.mark.parametrize("arch,qat", [("lstm-rnnt", False),
                                      ("lstm-rnnt", True),
                                      ("qwen1.5-0.5b", False)])
def test_train_step_card_matches_cpu(cuda, arch, qat):
    """One train step (smoke width) on the card and on the CPU from the
    same params, state and batch, by ``train_checks``' rules."""
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.testing import train_checks as TC

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch, smoke=True)
    params = model_zoo.build(cfg).init(
        torch.Generator(device=cuda).manual_seed(0), cuda)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                                   global_batch=2)).batch_at(0)
    before = serve.launch_counts()
    TC.step_card_against_cpu(cfg, params, batch, OptConfig(lr=3e-3),
                             qat=qat)
    assert serve.launch_counts() == before  # no kernel in a train step


def test_flash_layer_grad_on_card_matches_cpu(cuda):
    """The attention layer under autograd on the card (kernel 5 writing
    the lse, then the backward kernel, one launch each) against the CPU,
    by ``train_checks``' rule."""
    from repro_torch.testing import train_checks as TC

    torch.backends.cuda.matmul.allow_tf32 = False
    errs = TC.flash_grad_card_against_cpu(cuda)
    assert set(errs) == {"out", "dq", "dk", "dv"}


@pytest.mark.parametrize("which", ["qwen3-4b", "small"])
def test_flash_bwd_kernel_matches_plain(cuda, which):
    """The backward kernel (and kernel 5's lse) against their plain
    versions: a qwen3-4b training layer (B 1, H 32 over 8 KV heads, S
    4096, D 128, causal, bf16), and the small float32 / bf16 cases of
    ``attention_checks`` (head_dim 16 to 256, Sq != Sk at an offset,
    windows, ragged lengths, strided and unaligned rows); the dk/dv kernel
    unsplit and at the card's head splits, each launched twice with the
    same bits, one backward launch a call; aligned bf16 at head_dim 64 to
    256 in the tensor-core form, the rest in the FMA form."""
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.testing import attention_checks as AC

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda).manual_seed(3)
    cases = (AC.FLASH_BWD_MODEL_CASES[:1] if which == "qwen3-4b"
             else AC.FLASH_BWD_SMALL_CASES)
    for case in cases:
        _, B, Sq, Sk, H, KVH, D, *_, dtype, layout = case
        before = KF.backward.launches
        kw = AC.flash_bwd_inputs(gen, case)
        res = AC.check_flash_bwd(case[0], **kw)
        torch.cuda.synchronize()
        assert KF.backward.launches == before + res["launches"]
        assert res["tensor_cores"] == int(
            dtype == torch.bfloat16 and D in KF.TC_BWD_TILES
            and layout != "unaligned"), case[0]


def test_checkpoint_roundtrip_on_card(cuda, tmp_path):
    """An async save of card tensors, which the caller then overwrites,
    restores onto the card bit for bit, bf16 too."""
    from repro_torch import tree_util as tu
    from repro_torch.checkpoint.manager import CheckpointManager

    gen = torch.Generator(device=cuda).manual_seed(6)
    tree = {"w": torch.randn((256, 64), generator=gen, device=cuda),
            "e": [torch.randn((64, 8), generator=gen, device=cuda)
                  .to(torch.bfloat16)],
            "step": torch.tensor(3, dtype=torch.int32, device=cuda)}
    want = tu.tree_map(torch.clone, tree)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, tree)
    tree["w"].zero_()
    mgr.wait()
    like = tu.tree_map(torch.zeros_like, want)
    restored, _ = mgr.restore(3, like)
    for got, w in zip(tu.leaves(restored), tu.leaves(want), strict=True):
        assert got.device == w.device and got.dtype == w.dtype
        assert torch.equal(got, w)
