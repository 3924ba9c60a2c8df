"""Training launcher: data pipeline -> train step -> checkpoints, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch lstm-rnnt \
        --steps 100 --batch 8 --seq 128 --ckpt-dir /path/to/ckpt [--qat]
    PYTHONPATH=src python -m repro_torch.launch.train --arch lstm-rnnt \
        --smoke --device cpu --steps 3 --ckpt-dir D [--resume]

Port of ``repro.launch.train`` on one device: ``SyntheticLM`` batches
through ``runtime.train_loop.make_train_step`` (float, or QAT with
``--qat``; ``--microbatches``, ``--grad-compress``; ``--data-vocab``
narrows the tokens), the step's wall time
held against the ``StepWatchdog``, async checkpoints every
``--ckpt-every`` steps and ``--resume`` from the latest one.  The step
updates the params and optimizer state in place (``donate``, as the
reference's launcher donates its buffers), so full-width ``qwen3-4b``
trains at ``--batch 1 --seq 4096`` on one 80 GB card: each layer is
recomputed in the backward (its ``remat``) and attention past S 1024 runs
the flash kernels forward and backward.  It runs on
the card unless ``--device cpu`` is given, with float32 products in full
(TF32 off).  The sharded run (the reference's ``--mesh``) comes with the
mesh (ROADMAP Queue 1).
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, List, Optional

import torch

from ..checkpoint.manager import CheckpointManager
from ..configs.registry import get_config
from ..data.pipeline import DataConfig, SyntheticLM
from ..models import model_zoo
from ..optim.optimizers import OptConfig
from ..runtime.fault import StepWatchdog
from ..runtime.train_loop import TrainArtifacts, make_train_step


@dataclasses.dataclass
class TrainResult:
    losses: List[float]
    grad_norms: List[float]
    step_s: List[float]  # wall seconds of each step, host clock
    start_step: int
    params: Any
    opt_state: Any
    art: TrainArtifacts  # the step the run took
    data: SyntheticLM  # the batches it drew


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--qat", action="store_true")
    ap.add_argument("--data-vocab", type=int, default=None,
                    help="draw the synthetic tokens from the first N ids "
                         "(default: the model's vocabulary), a rule a few "
                         "steps can learn")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> TrainResult:
    """Train as ``args`` say; print the reference launcher's log lines."""
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to train on the "
                         "CPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = model_zoo.build(cfg)
    data = SyntheticLM(DataConfig(
        vocab_size=args.data_vocab or cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
        frontend_tokens=cfg.n_frontend_tokens if cfg.family in ("vlm",
                                                                "encdec")
        else 0,
        d_model=cfg.d_model))
    opt_cfg = OptConfig(name=cfg.optimizer, lr=args.lr,
                        warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps)
    art = make_train_step(bundle, device, opt_cfg,
                          microbatches=args.microbatches,
                          grad_compress_int8=args.grad_compress, qat=args.qat,
                          donate=True)
    params = bundle.init(torch.Generator(device=device).manual_seed(0),
                         device)
    opt_state = art.init_opt(params)

    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    if ckpt and args.resume and ckpt.latest_step() is not None:
        start_step = ckpt.latest_step()
        (params, opt_state), _ = ckpt.restore(start_step,
                                              (params, opt_state))
        print(f"resumed from step {start_step}")

    watchdog = StepWatchdog()
    losses, grad_norms, step_s = [], [], []
    for step, batch in data.iterate(start_step):
        if step >= args.steps:
            break
        t0 = time.perf_counter()
        params, opt_state, metrics = art.step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        _sync(device)
        step_s.append(time.perf_counter() - t0)
        verdict = watchdog.observe(step_s[-1])
        losses.append(loss)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {loss:.4f} lr "
                  f"{float(metrics['lr']):.2e} gnorm "
                  f"{float(metrics['grad_norm']):.2f} [{verdict}]",
                  flush=True)
        if ckpt and (step + 1) % args.ckpt_every == 0:
            ckpt.save(step + 1, (params, opt_state))
    if ckpt:
        ckpt.wait()
    if losses:
        print(f"final loss: {losses[-1]:.4f} (first: {losses[0]:.4f}); "
              f"stragglers: {watchdog.stragglers}/{watchdog.steps}")
    else:
        print(f"no step to run: resumed at step {start_step} of "
              f"{args.steps}")
    return TrainResult(losses, grad_norms, step_s, start_step, params,
                       opt_state, art, data)


def main(argv: Optional[List[str]] = None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
