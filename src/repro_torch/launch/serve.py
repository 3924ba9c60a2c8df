"""Serving on the GPU: the integer recurrent LM (LSTM or GRU), its float
baseline, and the dense transformer family.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lstm-rnnt \
        --quant int8-lstm --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-rnnt \
        --quant none --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gru-rnnt \
        --quant int8-gru --engine --slots 4 --requests 12 --chunk 4 \
        --speculate 4 --policy srf --oversubscribe 2.0
    PYTHONPATH=src python -m repro_torch.launch.serve --arch lstm-rnnt \
        --quant int8-lstm --engine --shards 2 --slots 4 --requests 16 \
        --fault-spec '{"kills": [{"shard": 0, "at_frac": 0.5, "restart_after": 8}]}'
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        [--quant int8] --batch 4 --prompt-len 32 --gen 16 --max-len 256
    PYTHONPATH=src python -m repro_torch.launch.serve --arch \
        falcon-mamba-7b [--quant int8]   # or whisper-tiny, recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch grok-1-314b \
        --smoke --device cpu [--quant int8]   # or kimi-k2-1t-a32b

Seeded float init, calibration and the Table-2 recipe, then either the
static batch (ONE integer prefill over the prompt and a greedy decode
loop) or, with ``--engine``, a queue of requests served by the
continuous-batching engine (``launch/engine.py``: chunked prefill
``--chunk``, speculative decoding ``--speculate``, scheduling ``--policy``
with preemption through the state pool under ``--oversubscribe``), or,
with ``--shards N``, by the fleet router over N such engines
(``launch/fleet.py``: least-loaded admission, and a seeded fault plane,
``--fault-spec``, whose shard kills, hangs and admission failures every
stream survives bit for bit).  The workload is synthetic (``--requests
N``; spread over ``N // 2`` fleet steps of arrivals under ``--shards``) or
a JSON trace (``--trace``).  A shard runs on a CUDA device of its own when
there are at least N of them; otherwise every shard shares ``--device``.
Every layer of every step launches the int8 GEMM kernel once (hoisted input
stage) and the cell's sequence kernel once (recurrent stage).

A model bundle (``models/model_zoo.py``) is served as the reference
launcher's static path does: seeded init, the prompt teacher-forced
through the bundle's ``decode``, then greedy decoding.  That is a
transformer (``--quant none``, the default, or ``int8``: int8 weights and
an int8 KV cache, in a ``--max-len`` cache; decode never reaches the
flash kernel, only a prefill of more than 1024 positions does,
``runtime.train_loop.make_serve_fns``; the MoE models grok-1-314b and
kimi-k2-1t-a32b too, whose full-width weights no single card holds: the
CLI refuses them there, ``check_fits``), whisper-tiny (frames of the
frontend stub are not read in decode: its cross-attention cache stays
zero, as in the reference), falcon-mamba-7b or recurrentgemma-9b (``int8``
quantizes their weights; their recurrent state and recurrentgemma's
window cache stay float; no kernel launches in decode), or the float
recurrent LM
(``--quant none`` on ``lstm-rnnt`` / ``gru-rnnt``: the paper's accuracy
baseline, plain PyTorch products, no kernel launched).  ``--quant int8``
on the recurrent family is refused: its float cell cannot take int8
weights (the reference raises a ``TypeError`` there at full width); the
integer LM is ``--quant int8-lstm`` / ``int8-gru``.  ``--device cpu``
runs every path through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs.registry import get_config
from ..kernels import (flash_attention, int8_matmul, int_layernorm,
                       quant_gru_scan, quant_lstm_cell, quant_lstm_scan)
from ..models import lstm_lm, model_zoo, quant_transformer, transformer
from ..runtime import sharding, train_loop
from . import engine as E
from . import fleet as F

KERNELS = {"int8_matmul": int8_matmul, "quant_lstm_scan": quant_lstm_scan,
           "quant_gru_scan": quant_gru_scan, "int_layernorm": int_layernorm,
           "quant_lstm_cell": quant_lstm_cell,
           "flash_attention": flash_attention,
           "flash_attention_bwd": flash_attention.backward}
RECURRENT_QUANT = ("int8-lstm", "int8-gru")


def launch_counts() -> Dict[str, int]:
    """Every kernel's launch counter, by kernel name."""
    return {name: mod.launches for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.launches = 0
    int8_matmul.launches_by_shape.clear()


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor  # (B, gen) int64 greedy tokens
    prefill_s: float
    decode_s: float
    # stacked integer state after the prompt, then after each decode step
    states: List[Dict[str, Any]]
    decode_inputs: torch.Tensor  # (B, gen) the token fed to each decode step
    launches: Dict[str, int]  # kernel launches during prefill + decode


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(cfg, batch: int, prompt_len: int, device, seed: int = 0):
    """Seeded float init + calibration + quantization on ``device``.

    Returns ``(params, qlayers)``.  Calibration uses ``(batch,
    max(prompt_len, 8))`` random tokens, as the reference launcher does.
    """
    gen = torch.Generator(device=device).manual_seed(seed)
    params = lstm_lm.init_params(gen, cfg, device)
    calib_gen = torch.Generator(device=device).manual_seed(seed + 2)
    calib = torch.randint(0, cfg.vocab_size, (batch, max(prompt_len, 8)),
                          generator=calib_gen, device=device)
    return params, lstm_lm.quantize_stack(params, cfg, calib)


def serve(params, qlayers, cfg, prompt: torch.Tensor, n_gen: int
          ) -> ServeResult:
    """Integer prefill of ``prompt`` (B, T) then ``n_gen`` greedy tokens."""
    device = prompt.device
    counts0 = launch_counts()
    state = lstm_lm.init_quant_decode_state(qlayers, prompt.shape[0], device)
    _sync(device)
    t0 = time.perf_counter()
    with torch.no_grad():
        logits, state = lstm_lm.quant_prefill(params, qlayers, cfg, prompt,
                                              state)
        states = [state]
        _sync(device)
        t1 = time.perf_counter()
        fed: List[torch.Tensor] = []
        out: List[torch.Tensor] = []
        tok = logits.argmax(-1)[:, None]
        for _ in range(n_gen):
            fed.append(tok)
            logits, state = lstm_lm.quant_decode_step(params, qlayers, cfg,
                                                      tok, state)
            states.append(state)
            tok = logits.argmax(-1)[:, None]
            out.append(tok)
        _sync(device)
    t2 = time.perf_counter()
    empty = prompt.new_zeros((prompt.shape[0], 0))
    return ServeResult(
        tokens=torch.cat(out, dim=1) if out else empty,
        prefill_s=t1 - t0, decode_s=t2 - t1, states=states,
        decode_inputs=torch.cat(fed, dim=1) if fed else empty,
        launches={k: v - counts0[k] for k, v in launch_counts().items()})


@dataclasses.dataclass
class BundleServeResult:
    tokens: torch.Tensor  # (B, gen) int64 greedy tokens
    prefill_s: float
    decode_s: float
    logits: torch.Tensor  # (B, vocab) the last decode step's logits
    launches: Dict[str, int]  # kernel launches during prefill + decode


def build_bundle(cfg, device, quant: str = "none", seed: int = 0):
    """``(bundle, params)``: seeded init on ``device`` (a transformer's
    params in bf16; the recurrent LM's the ones ``build_model`` draws
    before calibrating); with ``quant == "int8"`` the params and the
    bundle's cache are quantized, as the reference launcher does."""
    bundle = model_zoo.build(cfg)
    params = bundle.init(torch.Generator(device=device).manual_seed(seed),
                         device)
    if quant == "int8":
        params = quant_transformer.quantize_param_tree(params)
        bundle = quant_transformer.quantize_bundle(bundle)
    return bundle, params


def serve_bundle(bundle, params, prompt: torch.Tensor, n_gen: int,
                 max_len: int, quantized_cache: bool = False
                 ) -> BundleServeResult:
    """Teacher-force ``prompt`` (B, P) through ``decode`` into a fresh
    cache, then ``n_gen`` greedy tokens; the first greedy token is fed
    back but not returned, as in the reference's greedy loop."""
    device = prompt.device
    B = prompt.shape[0]
    counts0 = launch_counts()
    _, decode = train_loop.make_serve_fns(bundle, device, B, max_len,
                                          quantized_cache)
    state = bundle.init_state(B, max_len, quantized=quantized_cache,
                              device=device)
    _sync(device)
    t0 = time.perf_counter()
    for t in range(prompt.shape[1]):
        logits, state = decode(params, prompt[:, t:t + 1], state)
    _sync(device)
    t1 = time.perf_counter()
    out: List[torch.Tensor] = []
    tok = logits.argmax(-1)[:, None]
    for _ in range(n_gen):
        logits, state = decode(params, tok, state)
        tok = logits.argmax(-1)[:, None]
        out.append(tok)
    _sync(device)
    t2 = time.perf_counter()
    return BundleServeResult(
        tokens=torch.cat(out, dim=1) if out else prompt.new_zeros((B, 0)),
        prefill_s=t1 - t0, decode_s=t2 - t1, logits=logits,
        launches={k: v - counts0[k] for k, v in launch_counts().items()})


def device_bytes(device: torch.device) -> int:
    """The memory of ``device``: the card's, or the host's."""
    if device.type == "cuda":
        return torch.cuda.get_device_properties(device).total_memory
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def check_fits(cfg, quant: str, device: torch.device) -> None:
    """Refuse a transformer whose weights alone exceed ``device``'s memory
    (grok-1-314b and kimi-k2-1t-a32b at full width: 316 G and 1.03 T
    parameters), rather than run out of memory part way through the
    init."""
    if cfg.family not in ("dense", "vlm", "moe"):
        return
    n = transformer.param_count(cfg)
    need = n * (1 if quant == "int8" else 2)  # int8 weights: at least
    have = device_bytes(device)
    if need > have:
        raise SystemExit(
            f"{cfg.name} holds {n / 1e9:.1f} G parameters: at least "
            f"{need / 1e9:.1f} GB of weights at --quant {quant}, more than "
            f"the {have / 1e9:.1f} GB of {device}.  Serve it with --smoke, "
            f"or a cut of its depth (python3 chip_smoke.py --moe serves "
            f"full-width cuts of the MoE models on one card)")


def _serve_bundle_cli(args, cfg, device) -> None:
    check_fits(cfg, args.quant, device)
    t0 = time.perf_counter()
    bundle, params = build_bundle(cfg, device, args.quant)
    _sync(device)
    print(f"initialized {cfg.name} ({cfg.n_layers} layers, quant="
          f"{args.quant}) in {time.perf_counter() - t0:.1f}s "
          f"(device={device})")
    prompt = random_prompt(cfg, args.batch, args.prompt_len, device)
    res = serve_bundle(bundle, params, prompt, args.gen, args.max_len,
                       quantized_cache=args.quant == "int8")
    print(f"arch={cfg.name} quant={args.quant} device={device}")
    print(f"prompt tokens/s: {args.batch * args.prompt_len / res.prefill_s:.1f}")
    if args.gen:
        print(f"decode tokens/s: {args.batch * args.gen / res.decode_s:.1f}")
    print("kernel launches:", " ".join(
        f"{k}={v}" for k, v in res.launches.items()))
    print("sample:", res.tokens[0].tolist())


def random_prompt(cfg, batch: int, prompt_len: int, device, seed: int = 1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def engine_requests(args, cfg, arrival_span: int = 0) -> List[E.Request]:
    """The engine workload of the CLI: a JSON trace or the synthetic one
    (seed 1, prompt lengths (P/2, P), budgets (G/2, G), arrivals over
    ``arrival_span`` steps), as in the reference launcher."""
    if args.trace:
        return E.load_trace(args.trace, cfg.vocab_size, seed=1)
    return E.synthetic_trace(
        args.requests, cfg.vocab_size, seed=1,
        prompt_lens=(args.prompt_len // 2 or 1, args.prompt_len),
        gen_lens=(args.gen // 2 or 1, args.gen), arrival_span=arrival_span)


def print_engine_stats(stats: E.EngineStats, n_results: int,
                       n_requests: int) -> None:
    """The reference launcher's engine stats lines."""
    print(f"served {n_results}/{n_requests} requests in "
          f"{stats.wall_s:.2f}s ({stats.steps} steps)")
    print(f"decode tokens/s: {stats.tokens_per_s:.1f} "
          f"(+{stats.prompt_tokens} prompt tokens)")
    print(f"slot occupancy: {stats.occupancy:.2f}")
    print(f"mean TTFT: {stats.mean_ttft_steps:.1f} steps / "
          f"{stats.mean_ttft_s * 1e3:.1f} ms; "
          f"mean stream tokens/s: {stats.mean_stream_tokens_per_s:.1f}")
    if stats.preemptions or stats.resumes or stats.rejected \
            or stats.oversubscribe > 1:
        print(f"scheduling: peak live {stats.peak_live} "
              f"(slots={stats.n_slots}), {stats.preemptions} preemptions, "
              f"{stats.resumes} resumes, {stats.rejected} rejected, "
              f"{stats.pool_state_bytes} B/stream parked state")
    if stats.speculate:
        print(f"speculation: accept rate {stats.accept_rate:.2f} "
              f"({stats.accepted_draft_tokens}/{stats.drafted_tokens} "
              f"drafts), {stats.accepted_tokens_per_spec_step:.2f} "
              f"tokens/slot-step over {stats.spec_slot_steps} speculating "
              f"slot-steps ({stats.spec_steps} verify steps)")


def _serve_engine(args, cfg, params, qlayers, device) -> None:
    requests = engine_requests(args, cfg)
    if not requests:
        raise SystemExit("engine: empty workload (use --requests N >= 1 or "
                         "a non-empty --trace)")
    eng = E.ContinuousBatchingEngine(
        params, qlayers, cfg, n_slots=args.slots, chunk=args.chunk,
        speculate=args.speculate, policy=args.policy,
        oversubscribe=args.oversubscribe)
    eng.submit_all(requests)
    counts0 = launch_counts()
    results, stats = eng.run()
    print(f"arch={cfg.name} quant={args.quant} engine slots={args.slots} "
          f"chunk={args.chunk} speculate={args.speculate} "
          f"policy={stats.policy} oversubscribe={stats.oversubscribe} "
          f"device={device}")
    print_engine_stats(stats, len(results), len(requests))
    print("kernel launches:", " ".join(
        f"{k}={v - counts0[k]}" for k, v in launch_counts().items()))
    print("sample:", results[requests[0].rid].tokens)


def _load_fault_spec(raw: Optional[str]) -> Optional[F.FaultInjector]:
    """``--fault-spec`` value -> FaultInjector (inline JSON or @file)."""
    if raw is None:
        return None
    if raw.startswith("@"):
        with open(raw[1:]) as f:
            spec = json.load(f)
    else:
        spec = json.loads(raw)
    if not isinstance(spec, dict):
        raise SystemExit(f"--fault-spec: expected a JSON object, "
                         f"got {type(spec).__name__}")
    return F.FaultInjector.from_spec(spec)


def print_fleet_stats(stats: F.FleetStats, n_slots: int) -> None:
    """The reference launcher's fleet lines: served, goodput, the fault
    plane's counts and one line a shard."""
    print(f"served {stats.completed}/{stats.submitted} requests in "
          f"{stats.wall_s:.2f}s ({stats.fleet_steps} fleet steps); "
          f"{stats.rejected} rejected, {stats.lost} lost")
    print(f"goodput: {stats.goodput_tokens_per_step:.2f} tokens/step "
          f"({stats.tokens_per_s:.1f} tokens/s)")
    print(f"fault plane: {stats.kills} kills, {stats.restarts} restarts, "
          f"{stats.hang_events} hung steps, {stats.migrated_streams} "
          f"migrated, {stats.replayed_streams} replayed, "
          f"{stats.rerouted_pending} rerouted, {stats.admit_retries} "
          f"admission retries")
    for i, s in enumerate(stats.shards):
        print(f"  shard {i}: {'alive' if s.alive else 'dead '} "
              f"steps={s.steps} occupancy={s.occupancy(n_slots):.2f} "
              f"tokens={s.generated_tokens} adopted={s.adopted} "
              f"stragglers={s.stragglers} hung={s.hung} "
              f"kills={s.kills} restarts={s.restarts}")


def _serve_fleet(args, cfg, params, qlayers, device) -> None:
    """Sharded serving of the integer recurrent LM through the fleet
    router (admission routing + fault-plane recovery)."""
    requests = engine_requests(args, cfg,
                               arrival_span=max(args.requests // 2, 1))
    if not requests:
        raise SystemExit("fleet: empty workload (use --requests N >= 1 or "
                         "a non-empty --trace)")
    groups = (sharding.fleet_device_groups(args.shards)
              if device.type == "cuda" else None)
    devices = [g[0] for g in groups] if groups else None
    router = F.FleetRouter(
        params, qlayers, cfg, n_shards=args.shards,
        slots_per_shard=args.slots, chunk=args.chunk,
        speculate=args.speculate, policy=args.policy,
        oversubscribe=args.oversubscribe,
        injector=_load_fault_spec(args.fault_spec), devices=devices)
    router.warmup()
    router.submit_all(requests)
    counts0 = launch_counts()
    results, stats = router.run()
    print(f"arch={cfg.name} quant={args.quant} fleet shards={args.shards} "
          f"slots/shard={args.slots} chunk={args.chunk} "
          f"policy={args.policy} oversubscribe={args.oversubscribe} "
          f"device={device} devices={len(groups or ())}/{args.shards}")
    print_fleet_stats(stats, args.slots)
    done = [r for r in results.values() if r.tokens and not r.truncated]
    ttfts = sorted(r.ttft_steps for r in done if r.ttft_steps is not None)
    if ttfts:
        print(f"TTFT p50/p99: {ttfts[len(ttfts) // 2]} / "
              f"{ttfts[min(len(ttfts) - 1, int(len(ttfts) * 0.99))]} "
              f"fleet steps")
    print("kernel launches:", " ".join(
        f"{k}={v - counts0[k]}" for k, v in launch_counts().items()))
    # the first request's tokens, as the engine path prints
    first = [r for r in done if r.rid == requests[0].rid]
    if first or done:
        print("sample:", (first or done)[0].tokens)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", *RECURRENT_QUANT],
                    help="none: a transformer in bf16 or the float "
                         "recurrent LM; int8: a transformer with int8 "
                         "weights and KV cache; int8-lstm/int8-gru: the "
                         "integer recurrent LM")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=256,
                    help="KV cache length of the transformer path")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--engine", action="store_true",
                    help="serve a request queue through the "
                         "continuous-batching engine")
    ap.add_argument("--slots", type=int, default=8,
                    help="decode-batch rows of the engine")
    ap.add_argument("--requests", type=int, default=16,
                    help="synthetic workload size for --engine")
    ap.add_argument("--trace", default=None,
                    help="JSON request trace for --engine "
                         "(see launch/engine.py:load_trace)")
    ap.add_argument("--chunk", type=int, default=1,
                    help="prefill chunk size K for --engine: up to K prompt "
                         "tokens per slot per step, bit-exact vs 1")
    ap.add_argument("--speculate", type=int, default=0,
                    help="draft budget k for --engine speculative decoding "
                         "(n-gram drafter, one (S, k+1) verify per step), "
                         "bit-exact vs 0")
    ap.add_argument("--policy", default="fifo",
                    help="slot-scheduling policy for --engine (fifo | "
                         "priority | srf | rr | fifo-reject)")
    ap.add_argument("--oversubscribe", type=float, default=1.0,
                    help="admission headroom for --engine as a multiple of "
                         "--slots (streams beyond the slots are parked in "
                         "the state pool by preempting policies)")
    ap.add_argument("--shards", type=int, default=None,
                    help="serve through the fleet router over N per-shard "
                         "engines (requires --engine; launch/fleet.py). "
                         "Each shard gets --slots decode rows and a CUDA "
                         "device of its own when there are enough")
    ap.add_argument("--fault-spec", default=None,
                    help="fault-injection spec for --shards: inline JSON or "
                         "@file, schema per fleet.FaultInjector.from_spec "
                         "(kills / hangs / admission failures, all seeded "
                         "and deterministic)")
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        ap.error("--prompt-len must be >= 1")
    if args.chunk < 1:
        ap.error("--chunk must be >= 1")
    if args.speculate < 0:
        ap.error("--speculate must be >= 0")
    if args.oversubscribe < 1.0:
        ap.error("--oversubscribe must be >= 1.0")
    if not args.engine and (args.policy != "fifo" or args.oversubscribe > 1.0
                            or args.speculate or args.chunk > 1):
        ap.error("--chunk/--speculate/--policy/--oversubscribe require "
                 "--engine")
    if args.engine and args.quant not in RECURRENT_QUANT:
        ap.error("--engine requires --quant int8-lstm or int8-gru")
    if args.shards is not None and not args.engine:
        ap.error("--shards requires --engine (the fleet router drives "
                 "continuous-batching engines)")
    if args.shards is not None and args.shards < 1:
        ap.error("--shards must be >= 1")
    if args.fault_spec is not None and args.shards is None:
        ap.error("--fault-spec requires --shards (faults are injected at "
                 "the fleet router)")
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.quant == "int8" and cfg.family == "lstm":
        raise SystemExit(
            f"--quant int8 quantizes a transformer's weights and KV cache; "
            f"{cfg.name}'s float cell cannot take int8 weights.  Serve the "
            f"integer LM with --quant int8-{lstm_lm.rnn_cell(cfg)} or the "
            f"float one with --quant none")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "versions")
    # float32 products in full: the recurrent scans' and heads' float32
    # einsums and matmuls must not round their inputs to TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.quant not in RECURRENT_QUANT:
        if cfg.family not in model_zoo.PORTED:
            raise SystemExit(f"--quant {args.quant} serves the "
                             f"{'/'.join(model_zoo.PORTED)} families, got "
                             f"{cfg.name} ({cfg.family})")
        _serve_bundle_cli(args, cfg, device)
        return
    want = args.quant.split("-", 1)[1]  # int8-gru -> gru
    if cfg.family != "lstm" or lstm_lm.rnn_cell(cfg) != want:
        raise SystemExit(f"--quant {args.quant} needs a {want.upper()} stack, "
                         f"got {cfg.name}")
    t0 = time.perf_counter()
    params, qlayers = build_model(cfg, args.batch, args.prompt_len, device)
    print(f"calibrated+quantized {len(qlayers)} {want.upper()} layers in "
          f"{time.perf_counter() - t0:.1f}s (device={device})")
    if args.shards is not None:
        _serve_fleet(args, cfg, params, qlayers, device)
        return
    if args.engine:
        _serve_engine(args, cfg, params, qlayers, device)
        return
    prompt = random_prompt(cfg, args.batch, args.prompt_len, device)
    res = serve(params, qlayers, cfg, prompt, args.gen)
    print(f"arch={cfg.name} quant={args.quant} device={device}")
    print(f"prompt tokens/s: {args.batch * args.prompt_len / res.prefill_s:.1f}")
    if args.gen:
        print(f"decode tokens/s: {args.batch * args.gen / res.decode_s:.1f}")
    print("kernel launches:", " ".join(
        f"{k}={v}" for k, v in res.launches.items()))
    print("sample:", res.tokens[0].tolist())


if __name__ == "__main__":
    main()
