"""Static-batch integer serving of the recurrent LM on the GPU.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch lstm-rnnt \
        --quant int8-lstm --batch 4 --prompt-len 32 --gen 16

Seeded float init, calibration and the Table-2 recipe, then ONE integer
prefill over the prompt and a greedy decode loop.  Every layer of every
call launches the int8 GEMM kernel once (hoisted input stage) and the
sequence kernel once (recurrent stage).  ``--device cpu`` runs the same
path through the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional

import torch

from ..configs.registry import get_config
from ..kernels import int8_matmul, quant_lstm_scan
from ..models import lstm_lm


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
    counts0 = (int8_matmul.launches, quant_lstm_scan.launches)
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
        launches={"int8_matmul": int8_matmul.launches - counts0[0],
                  "quant_lstm_scan": quant_lstm_scan.launches - counts0[1]})


def random_prompt(cfg, batch: int, prompt_len: int, device, seed: int = 1):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--quant", required=True, choices=["int8-lstm"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.prompt_len < 1:
        ap.error("--prompt-len must be >= 1")
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family != "lstm" or lstm_lm.rnn_cell(cfg) != "lstm":
        raise SystemExit(f"--quant int8-lstm needs an LSTM stack, got "
                         f"{cfg.name}")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run the plain "
                         "versions")
    t0 = time.perf_counter()
    params, qlayers = build_model(cfg, args.batch, args.prompt_len, device)
    print(f"calibrated+quantized {len(qlayers)} LSTM layers in "
          f"{time.perf_counter() - t0:.1f}s (device={device})")
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
