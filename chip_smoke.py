#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

    python3 chip_smoke.py
    python3 chip_smoke.py --gemm-times SRC TAG  # kernel 1 alone, see below
    python3 chip_smoke.py --cell-times SRC TAG  # kernels 2 and 3 alone
    python3 chip_smoke.py --serve-times SRC TAG  # the served paths' rates
    python3 chip_smoke.py --families  # kernel 5 and [families] alone
    python3 chip_smoke.py --moe  # kernel 5 and [moe] alone
    python3 chip_smoke.py --train  # the flash backward and training past S 1024
    python3 chip_smoke.py --flash-digests SRC TAG  # kernel 5's outputs' hashes

1. builds the seven CUDA kernels from ``src/repro_torch/csrc`` (one nvcc
   each, in parallel, beside the header check of step 2) and prints the
   build seconds and ptxas resource lines;
2. holds the kernels' fixed-point header, compiled for the card, against
   the port's PyTorch fixed point: tanh/sigmoid on every int16 input for
   integer_bits 0..15, the LayerNorm rsqrt multiplier, MBQM;
3. holds the int8 GEMM kernel bit for bit against its plain version on the
   card at the cases of ``repro_torch.testing.gemm_checks``: every shape the
   serving paths launch, one case for each kernel instance and split of K
   the plan picks (both forms: weight-streaming at M <= 32, tensor-core
   above), the three epilogues under a split, ragged and byte-copied
   shapes, M 1, 16, 17, 20, 32, 33, 128, 129, and the all -128 extremes
   split and unsplit, each launched twice back to back;
4. holds the fused LSTM cell kernel's TPU-contract entry against its plain
   version at (B, H) in {(8, 256), (16, 1024), (4, 2048)} x CIFG on/off x
   cell formats Q0/Q2/Q4, and its peephole o gate with and without the
   in-fusion LayerNorm; the integer LayerNorm kernel's TPU-contract entry at
   row lengths 1..16384 with constant rows (V = 0) and rows at the int16
   extremes; then the two step entries (``repro_torch.testing.kernel_cases.
   step_cases``): the gate pass (kernel 2 forming and normalising a step's
   gates from its accumulators) and the cell's step entry (kernel 3 forming
   the rest) at (B, H) in {(8, 256), (16, 1024), (4, 2048), (4, 1001),
   (2, 16384)} x LN x peephole x CIFG, with int32-extreme and constant
   rows, and the LN + peephole layer at the shapes of ``CLUSTER_SHAPES``,
   so each row form splits a row over every cluster size 1..8, every case
   launched twice back to back, all bit for bit;
5. holds the LSTM sequence kernel (one cooperative grid per call, the
   layer's weights split over the CTAs' shared memory) against its plain
   version: all 16 LSTM variants at small widths, then a full-width
   LN+projection layer from the port's own recipe, and an LN+projection+
   peephole layer at H = 1001 (which the split leaves ragged: u = 8 units
   on 126 CTAs, the last holding one), unmasked and masked, each from the
   reset state and continued from the carried (nonzero) state, at the
   decode shape (T = 1) too, every case at B = 1, 4, 16 and 64 (which
   passes through the kernel in two groups of rows at full width; the
   small-width variants at two widths and B = 1, 4 and 64);
6. holds the GRU sequence kernel against its plain version in the same
   way: both GRU variants (noLN, LN) at small widths, then a full-width
   LN layer (d_in = H = 2048) and an LN layer at H = 1001, at T = 32 and
   T = 1, B = 1, 4 and 16;
7. holds the stepwise executor (per LSTM step: the GEMM for the input, the
   recurrent product and the projection, for an LN layer the gate pass,
   the cell's step entry; per GRU step: the GEMM and the GRU kernel over
   one timestep) against the hoisted kernels: all 16 LSTM variants at the
   golden cases' widths (and the per-gate executor), a full-width
   LN+projection+peephole layer, both GRU variants and the full-width GRU
   layer; each call's launches must be exactly those of its steps;
   then holds the flash-attention kernel against its plain version at its
   own tiles (128 x 128 in the tensor-core form, 128 x 64 there at
   head_dim 256, 64 x 64 in the FMA form): (B, H, KVH, S, D) in {(2, 4,
   4, 256, 64), (1, 32, 8, 1100, 128), (2, 32, 8, 4096, 128), (2, 4, 2,
   300, 256), (1, 16, 1, 1100, 256), (2, 4, 2, 300, 112), (1, 64, 8, 2048,
   112)} x float32/bf16 x (its own scale, or q pre-scaled in its dtype as
   the model's layer does) x (causal, non-causal, causal with window 64,
   and at head_dim 112 and 256 a window of 300 whose edge falls inside a
   key tile), and per shape a bf16 case with
   unaligned rows (the kernel's FMA form; aligned bf16 runs on the tensor
   cores); float32 within 2e-5 + 2e-5 |ref|, bf16 within 2 ulps of the
   row's largest |ref|;
8. serves full-width ``lstm-rnnt`` (10 layers, d_rnn 2048, d_proj 640,
   vocab 4096) and then full-width ``gru-rnnt`` (10 layers, d_rnn 2048,
   vocab 4096) through the port's static serve path: seeded init,
   calibration, quantization, prefill of 4 x 32 tokens and 16 greedy
   tokens; the GEMM's and the cell's sequence kernel's launch counters
   must rise by exactly 10 x (1 + 16), the others not at all, and the
   integer states of every layer after the prefill and after each decode
   step, and every greedy token, must equal a plain-version run of the
   stack fed the same tokens; the LSTM serve is then repeated to show the
   spread of tokens/s; then ``[float]``, the paper's float baseline: both
   models served float (``--quant none``: the prompt teacher-forced
   through the bundle's decode, 16 greedy tokens), where no kernel may
   launch, with prompt and decode tokens/s beside the integer serves'; the
   prompt teacher-forced through ``decode_step`` against ``forward``'s
   last logits (F3); lstm-rnnt's float stack on the card against the CPU
   on the same weights, all 10 layers at T 4 (each layer within 1e-4 of
   its largest |output|, the logits by F3); post-training quantization:
   ``calibrate.calibrate`` over 4 ``SyntheticLM`` batches (one batch's
   ``Stats`` equal to ``calibration_stats``), the recipe on every layer
   and an integer serve of the same prompt (the GEMM and the LSTM sequence
   kernel 10 x (1 + 16) times each), with the share of greedy tokens it
   agrees with the float serve on and the prefill logits' distance,
   reported without a gate; and fake quantization on the card equal to
   the CPU bit for bit at 10**6 values in each of 7 cases; then
   ``[train]``, training on the card through ``launch/train.py``: 8 float
   steps of full-width ``lstm-rnnt`` at B 8 x T 128 (the loss must fall;
   async checkpoints restored bit for bit, and the step after the middle
   one resumed from it to the uninterrupted run's loss bit for bit; the
   device's busy share of a profiled step; PTQ of the trained params
   against their float serve, reported), 4 QAT steps, 2 full-width
   ``gru-rnnt`` steps (no kernel may launch), a 2-layer cut's step on the
   card against the CPU, the attention layer under autograd on the card
   (kernel 5 writing its row log-sum-exp, then the flash backward kernel)
   against the CPU in float32, and a ``qwen1.5-0.5b`` smoke step on the
   card against the CPU (``testing/train_checks.py``); then training past
   S 1024 (``train_attention``): the flash backward kernel against its
   plain version (its dk/dv kernel unsplit and at the card's head
   splits, each call made twice with the same bits; aligned bf16 at
   head_dim 64 to 256 in its tensor-core form, the rest in its FMA form,
   each case printing the form and tiles it took), and kernel 5's lse
   against its plain version's, at the
   training layers of qwen3-4b (B 1, H 32 over 8 KV heads, S 4096, D 128,
   bf16), recurrentgemma-9b (H 16 over 1, D 256, window 2048),
   stablelm-1.6b (H 32, D 64, S 2048) and kimi-k2-1t-a32b (H 64 over 8, D
   112, S 2048), and at small float32 and bf16 cases (head_dim 16, Sq !=
   Sk at an offset, windows, ragged lengths, strided and unaligned rows;
   ``attention_checks.FLASH_BWD_*_CASES``: float32 within 2e-5 + 2e-5
   |ref|, bf16 within 2 ulps of the row's largest |ref|, a row's largest
   taken as at least 2**-12 of the tensor's); full-width qwen3-4b through
   ``launch/train.py`` at B 1 x S 4096, 3 AdamW steps with per-layer
   remat and donated buffers (kernel 5 exactly 72 and the backward 36
   times a step, no other kernel; every loss and grad norm finite; peak
   device memory), then one more step under the profiler (the device time
   of kernel 5, of the backward, of the GEMMs and of the rest, and the
   busy share); recurrentgemma-9b cut to (rec, rec, attn) at B 1 x S
   3072 (its window binds) and grok-1-314b cut to 1 layer at B 1 x S 2048
   (Adafactor, auxiliary loss > 0), one step each at full width; float32
   smoke steps of qwen1.5-0.5b and grok-1-314b at S 1100 on the card
   against the CPU (loss and grad norm within 1e-4);
9. runs a 4 x 32 prompt through all 10 layers of full-width ``lstm-rnnt``
   with the stepwise executor (``quantize_input -> stepwise ->
   dequantize_output``): the cell kernel must launch exactly 10 x 32
   times, the LayerNorm kernel (the gate pass) 10 x 32, the GEMM 3 x 10 x
   32, the sequence kernels never; every layer's ys and state must equal the
   hoisted path, and layer 0 the per-gate executor; prompt tokens/s of
   both executors (the comparison of ``benchmarks/prefill_throughput.py``)
   and the device's busy share over two stepwise layers under the
   profiler, where the port's kernels must run exactly 5 times a step and
   every other device op fewer times than there are steps (no PyTorch op
   between a step's kernels);
10. serves 12 requests through the continuous-batching engine on each
   full-width model (4 slots, chunked prefill K = 4; gru-rnnt with
   arrivals staggered over 8 steps; gru-rnnt with speculation k = 4 under
   ``srf`` at oversubscription 2.0, so streams are preempted through the
   state pool; lstm-rnnt under ``fifo``): every stream's tokens must equal
   the port's ``decode_single`` on the card;
   then ``[fleet]``, the fleet router (``launch/fleet.py``) over 2 shards
   that share the card, on the same two models: ``tests/test_fleet.py``'s
   acceptance workload on lstm-rnnt (2 x 2 slots, ``srf`` at 2.0, a hard
   kill of shard 0 at fleet step 5: at least one stream migrates with its
   state and one replays its prefix); lstm-rnnt over 16 requests of
   ``synthetic_trace(seed=11, arrival_span=8)`` (2 x 4 slots, chunk 4,
   ``srf`` at 2.0, a hard kill of shard 0 at half the tokens and its
   restart 8 fleet steps later; a second run of it under the profiler for
   the device's busy share); gru-rnnt over the engine workload with a
   0.5 s hang of shard 0 that its watchdog must rule hung and
   ``on_hang="kill"`` drains gracefully.  Each run must serve every
   request, launch the GEMM once per launch of the model's sequence kernel
   and no other kernel, meet its spec's kill, restart and hang counts, and
   give every stream the tokens of ``decode_single`` on the card; its
   goodput (tokens a fleet step and a second, host clock) and fault-plane
   counts are printed;
   then initialises full-width ``qwen3-4b`` (36 layers, d_model 2560, 32
   query over 8 KV heads of 128, vocab 151936) on the card from a seed and
   prefills 2 x 4096 tokens through ``make_serve_fns``: the flash kernel
   must launch exactly 36 times and no other kernel; each layer's
   attention output is held against the plain version on that layer's
   inputs (2 bf16 ulps of the row's largest |value|) and the last-token
   logits against a run with the plain version in every layer (1 % of the
   row's largest |logit|, or 1.5 x the spread between the plain version at
   two tilings where that is wider; argmax equal where the margin exceeds
   2 %);
   prompt tokens/s over 3 prefills and kernel 5's share of the device
   time under the profiler; then serves it statically (B 4, prompt 32, 16
   greedy tokens, cache 256) in bf16 and with int8 weights and KV cache,
   where no kernel may launch (decode never reaches flash attention);
   then ``[families]``: full-width ``recurrentgemma-9b`` (38 layers, 26
   RG-LRU and 12 window-2048 attention layers of 16 query heads over one
   KV head of 256, vocab 256000), ``falcon-mamba-7b`` (64 Mamba-1 layers,
   d_inner 8192) and ``whisper-tiny`` (4 + 4 layers over 1500 frames of
   the frontend stub), each initialised on the card from a seed and freed
   before the next: recurrentgemma's prefill of 1 x 4096 tokens through
   ``make_serve_fns`` launches kernel 5 exactly 12 times in its
   tensor-core form at head_dim 256 and no other kernel, each launch held
   against the plain version on that layer's inputs (2 bf16 ulps), the
   last-token logits against plain-version runs by the F7 rule, prompt
   tokens/s over 3 prefills and kernel 5's share of the device time;
   mamba's prefill of 1 x 4096 (3 repeats) and whisper's of 4 x 64 text
   tokens launch no kernel; whisper's of 1 x 4096 text tokens launches
   kernel 5 exactly 4 times (head_dim 64, tensor cores), held the same
   way; each model's static serves in bf16 and int8 (no kernel); a cut
   of each (3, 2 and 2 + 2 layers at full width) on the card against the
   CPU on the same weights, the last-token logits within 1 % of the row's
   largest |logit|, or 1.5 x the CPU's own spread between two summation
   orders of its products where that is wider (F7's rule);
   then ``[moe]``: ``grok-1-314b`` (8 experts of 32768, top 2, 48 query
   over 8 KV heads of 128) cut to 2 of its 64 layers and
   ``kimi-k2-1t-a32b`` (384 experts of 2048, top 8, a shared expert; 64
   query over 8 KV heads of 112) cut to its dense layer and 1 of its 60
   MoE layers, at full width from a seed, one resident at a time: a
   prefill of 1 x 2048 tokens through ``make_serve_fns`` launches kernel 5
   exactly once a layer in its tensor-core form (head_dim 128, and 112)
   and no other kernel, each launch within 2 bf16 ulps of its plain
   version, the logits by F7, prompt tokens/s and kernel 5's share of the
   device time; the static serves in bf16 and int8 (no kernel; kimi's
   decode at B 4 has T k = 32 < 384 experts, so every routed assignment
   drops and its shared expert alone acts, ROADMAP R9); the float32 smoke
   configs and grok's 1-layer cut on the card against the CPU;
11. times each kernel with CUDA events (L2 flushed, the card held busy while
   the host enqueues the call, so the span is device time) beside its plain
   version, its bound and, for the GEMM, torch._int_mm (at M <= 16, where
   it refuses, on x zero-padded to 32 rows under its own key) at every
   shape the main paths launch (for flash attention, at the qwen3-4b and
   the recurrentgemma-9b and the kimi-k2-1t-a32b prefill layers' shapes,
   recurrentgemma's bound counting only the keys inside the window,
   scaled_dot_product_attention; the flash backward at the qwen3-4b and
   recurrentgemma-9b training layers, its tensor-core form at every head
   split beside its FMA form on the same values in unaligned rows and the
   backward of scaled_dot_product_attention; for kernels 2 and 3, the step
   entries and the TPU-contract entries at B 4, H 2048, beside the
   method's launch floor, and launches x (ms - bound) over the stepwise
   pass); and the sequence kernels' grid barrier alone;
12. prints the card's name and power limit, the kernels' JSON line and, as
   the last line, ``{"ok": true, "device": {...}}``.

Every launch counter is set to 0 just before each served path (the two
static serves, the two float serves and the PTQ serves, the train runs,
the stepwise pass,
the two engine runs, the three fleet runs, the transformer's prefill and
its two static serves, each prefill and static serve of ``[families]``
and ``[moe]``)
and read just after it; a kernel of the path that did not launch fails
the run.  The kernels' JSON line counts each kernel's launches over the
engine runs, the fleet runs and the stepwise pass (the GEMM's also by
shape), kernel 5's over the transformer's, recurrentgemma's,
whisper's and the MoE cuts' long prefills and the training runs past S
1024 (by path too), and the flash backward's over those training runs.  Each phase prints its
seconds.

``--gemm-times SRC TAG`` builds and times kernel 1 alone (step 11's GEMM
shapes) from the port under ``SRC``: ``src`` of this checkout, or of an
earlier revision unpacked beside it with ``git archive``, so that two
revisions' kernels are timed in one call on one card.  ``--cell-times SRC
TAG`` does the same for kernels 2 and 3 (step 11's rows, the step entries
where the revision has them), and ``--serve-times SRC TAG`` for the
host-clock rates of the static serves, the stepwise pass and the engine
runs of steps 8-10, with the tokens each served (no checks).
``--families`` builds kernel 5 alone and runs its checks (step 7's), the
``[families]`` phase and its timings (step 11's), no other phase; results
in ``chiprun_out/families.json``; ``--moe`` the same with ``[moe]``
(``chiprun_out/moe.json``); ``--train`` builds kernel 5 and the flash
backward and runs ``train_attention`` and the backward's timings alone
(``chiprun_out/train.json``).  ``--flash-digests SRC TAG`` builds kernel 5
from the port under ``SRC`` and writes the SHA-256 of its output on every
case of step 7's check to ``chiprun_out/flash_digests_TAG.json``: two
revisions run in one call are equal bit for bit where their hashes are.

Any mismatch, build failure or launch error raises, and the script exits
non-zero without the last line.  Without a CUDA device it fails at once.
Full results also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12  # H100 SXM dense int8 tensor-core peak
SM_CYCLES_PER_S = 1.98e9  # H100 SXM boost clock; a lower clock sleeps longer
B, T, GEN = 4, 32, 16
REPEATS = 9  # repeated serves for the spread of tokens/s
ENGINE_REPEATS = 5  # repeated engine runs for the spread of tokens/s
SCAN_OF = {"lstm": "quant_lstm_scan", "gru": "quant_gru_scan"}
# the engine workload: 12 requests of synthetic_trace(seed=11), arriving
# over engine steps 0..8, on 4 slots with chunked prefill K = 4
ENGINE = dict(n_requests=12, seed=11, prompt_lens=(8, 16, 32),
              gen_lens=(4, 8, 16), arrival_span=8, slots=4, chunk=4)
ENGINE_RUNS = (("gru-rnnt", "srf", 2.0, 4),  # arch, policy, oversubscribe,
               ("lstm-rnnt", "fifo", 1.0, 0))  # speculate
# the [fleet] phase: three fleet runs of 2 shards on the models built
# above, both shards on the one card.  FLEET_ACCEPT is tests/test_fleet.py's
# acceptance workload (prompts from default_rng(7)): 4 long requests at
# step 0 and 2 short ones at step 2 on 2 x 2 slots under srf, so the hard
# kill of shard 0 at fleet step 5 finds a pooled stream (migrates with its
# state) and residents (replay their prefix)
FLEET_ACCEPT = dict(lens=((3, 12),) * 4 + ((2, 3),) * 2,
                    arrivals=(0, 0, 0, 0, 2, 2), slots=2, kill_step=5)
FLEET_TRACE = dict(n_requests=16, seed=11, prompt_lens=(8, 16, 32),
                   gen_lens=(8, 12, 16), arrival_span=8, slots=4, chunk=4)
FLEET_KILL = dict(shard=0, at_frac=0.5, restart_after=8)
# warmup takes engine steps 0-2 at chunk 4; the hang fires on shard 0's
# fifth serving step
FLEET_HANG = dict(shard=0, at_step=7, sleep_s=0.5)
BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak
# the transformer path: qwen3-4b at full width, a long-prompt prefill
# through make_serve_fns (flash attention in every layer) and the static
# serve (decode only)
TRANSFORMER = "qwen3-4b"
PREFILL_B, PREFILL_S = 2, 4096
SERVE_B, SERVE_PROMPT, SERVE_MAX_LEN = 4, 32, 256
FLASH_TIMED = dict(B=2, H=32, KVH=8, S=4096, D=128)  # causal, bf16
BARRIER_CTAS = 128  # the sequence kernels' grid at full width
# the [float] phase: the card against the CPU over all 10 layers of
# lstm-rnnt at a cut length, and the PTQ calibration's SyntheticLM batches
FLOAT_CPU_T = 4
PTQ_BATCHES = 4
# the [train] phase: full-width lstm-rnnt through the train CLI (float with
# checkpoints, then QAT), gru-rnnt, a cut stack on the card against the CPU
# and a smoke dense step on the card against the CPU
TRAIN_B, TRAIN_T, TRAIN_LR = 8, 128, 3e-3
TRAIN_STEPS, TRAIN_CKPT_EVERY = 8, 4
# the float run's tokens come from the first 16 ids (test_system.py's rule
# for training the LSTM): over the whole 4096 a random init already
# predicts the uniform ln 4096 and 8 steps cannot learn the affine rule, so
# its loss only wanders (on an H100: 8.3286 -> 8.4578; PERF.md section 6)
TRAIN_DATA_VOCAB = 16
TRAIN_PROF_T = 16
TRAIN_QAT_STEPS, TRAIN_GRU_STEPS = 4, 2
TRAIN_CPU = dict(n_layers=2, B=2, T=16)
TRAIN_DENSE, TRAIN_DENSE_S = "qwen1.5-0.5b", 64
# [train]'s attention families past S 1024: the flash backward kernel
# against its plain version (attention_checks.FLASH_BWD_*_CASES),
# full-width qwen3-4b through the train CLI (remat, AdamW, donated
# buffers), recurrentgemma-9b cut to (rec, rec, attn) at an S where its
# window binds, grok-1-314b cut to one MoE layer (Adafactor, the aux loss),
# and float32 smoke steps past S 1024 on the card against the CPU
TRAIN_LM, TRAIN_LM_B, TRAIN_LM_S, TRAIN_LM_STEPS = "qwen3-4b", 1, 4096, 3
TRAIN_CUTS = (("recurrentgemma-9b", dict(n_layers=3), 1, 3072),
              ("grok-1-314b", dict(n_layers=1), 1, 2048))
TRAIN_F32 = (("qwen1.5-0.5b", 1, 1100), ("grok-1-314b", 1, 1100))
# the backward timed at a qwen3-4b training layer (causal, bf16) and a
# recurrentgemma-9b one (MQA, window 2048)
FLASH_BWD_TIMED = (dict(B=1, H=32, KVH=8, S=4096, D=128),
                   dict(B=1, H=16, KVH=1, S=4096, D=256, window=2048))
# the [families] phase: the three other model families that fit one card,
# at full width, one resident at a time: a long prefill through
# make_serve_fns (recurrentgemma's 12 window-2048 attention layers run
# kernel 5 at head_dim 256; whisper's decoder runs it past 2048 text
# tokens), the static serves of SERVE_B x SERVE_PROMPT, and a cut of each
# on the card against the CPU
FAMILIES = ("recurrentgemma-9b", "falcon-mamba-7b", "whisper-tiny")
FAMILY_PREFILL_S, FAMILY_REPEATS = 4096, 3
WHISPER_PREFILLS = ((4, 64), (1, 4096))  # (B, text tokens) over the frames
FAMILY_CUTS = {"recurrentgemma-9b": dict(n_layers=3),  # rec, rec, attn
               "falcon-mamba-7b": dict(n_layers=2),
               "whisper-tiny": dict(n_layers=2, enc_layers=2)}
FAMILY_CPU_B, FAMILY_CPU_S = 2, 8
# kernel 5 at a recurrentgemma prefill layer: MQA, causal, window 2048
FLASH_TIMED_D256 = dict(B=1, H=16, KVH=1, S=4096, D=256, window=2048)
# the [moe] phase: the MoE family at full width, cut in depth (neither
# model fits one card whole: 316 G and 1.03 T parameters), one resident at
# a time: grok-1-314b at 2 of its 64 layers (its experts 9.7 GB a layer in
# bf16), kimi-k2-1t-a32b at its dense layer and 1 of its 60 MoE layers (384
# experts, 33.8 GB); a prefill of 1 x 2048 through make_serve_fns (kernel
# 5 in every layer: head_dim 128 for grok, 112 for kimi), the static
# serves, and the card against the CPU in float32 on the smoke configs and
# on grok's 1-layer cut where the host holds its float32 weights twice
MOE = ("grok-1-314b", "kimi-k2-1t-a32b")
MOE_CUTS = {"grok-1-314b": dict(n_layers=2),
            "kimi-k2-1t-a32b": dict(n_layers=2)}  # dense + 1 MoE layer
MOE_PREFILL_B, MOE_PREFILL_S = 1, 2048
MOE_CPU_CUT = ("grok-1-314b", dict(n_layers=1))
# kernel 5 at a kimi prefill layer: GQA 64 over 8 KV heads of 112, causal
FLASH_TIMED_D112 = dict(B=1, H=64, KVH=8, S=2048, D=112)


def _gemm_timed():
    import torch

    i32, i8 = torch.int32, torch.int8
    # (M, K, N, out): the static prefill's and decode's input stages of
    # lstm-rnnt (K 2048 at layer 0, then 640) and gru-rnnt (N 6144), and
    # what else the main paths launch: the stepwise projection (int8 out),
    # the engine chunk (M 16, both models) and the GRU's speculative verify
    # (M 20)
    return ((B * T, 2048, 8192, i32), (B * T, 640, 8192, i32),
            (B, 2048, 8192, i32), (B, 640, 8192, i32),
            (B * T, 2048, 6144, i32), (B, 2048, 6144, i32),
            (B, 2048, 640, i8), (16, 640, 8192, i32), (16, 2048, 6144, i32),
            (20, 2048, 6144, i32), (16, 2048, 8192, i32))


def log(*args):
    print(*args, flush=True)


def require_equal(what, got, want):
    """Raise unless two integer tensors are identical; return max |diff|."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.dtype}{tuple(got.shape)} vs "
                             f"{want.dtype}{tuple(want.shape)}")
    diff = (got.to(torch.int64) - want.to(torch.int64)).abs()
    bad = int((diff != 0).sum())
    if bad:
        idx = [int(i) for i in torch.nonzero(diff)[0]]
        raise AssertionError(
            f"{what}: {bad} of {diff.numel()} elements differ; first at "
            f"{idx}: kernel {got[tuple(idx)].item()} vs plain "
            f"{want[tuple(idx)].item()}")
    return int(diff.max()) if diff.numel() else 0


def cold_ms(fn, iters, flush):
    """``(device ms, host ms)`` of one call of ``fn``, means over ``iters``.

    Before each timed call the L2 cache is flushed, then the card is held
    busy by ``torch.cuda._sleep`` for three times the host's time to enqueue
    the call (its argument checks, ctypes call and allocations), so the
    start event fires with the call's launches already queued: the span
    between the CUDA events is device time, not host time.  Where a call
    enqueues for longer than the sleep (a plain version's many small ops),
    its remaining host gaps stay in the span."""
    import torch

    fn()
    torch.cuda.synchronize()
    host = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        host.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    host_s = sorted(host)[1]
    cycles = int(min(max(3 * host_s, 1e-4), 0.25) * SM_CYCLES_PER_S)
    pairs = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(cycles)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters, host_s * 1e3


def bound(bytes_moved, int8_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = int8_ops / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gemm_operands(M, K, N, gen, dev):
    import torch

    x = torch.randint(-128, 128, (M, K), generator=gen, device=dev,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                      dtype=torch.int8)
    fold = torch.randint(-(2**20), 2**20, (N,), generator=gen, device=dev,
                         dtype=torch.int32)
    m0 = torch.randint(1 << 30, 2**31 - 1, (N,), generator=gen, device=dev,
                       dtype=torch.int32)
    shift = torch.randint(-20, 2, (N,), generator=gen, device=dev,
                          dtype=torch.int32)
    return x, w, fold, m0, shift


def check_gemm(dev):
    """Kernel 1 against its plain version, bit for bit, at every case of
    ``repro_torch.testing.gemm_checks`` (each kernel instance and split of
    K the plan picks, the three epilogues under a split, ragged and
    byte-copied shapes, the serving shapes), the all -128 extremes at a
    weight-streaming and a tensor-core shape, each launched twice back to
    back; logs the plans the cases reached and returns the largest
    |difference| (0)."""
    import torch
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels.scan_plan import sm_count
    from repro_torch.testing import gemm_checks as GC

    gen = torch.Generator(device=dev).manual_seed(11)
    n_sm = sm_count(dev.index or 0)
    err = 0
    plans = set()
    for M, Kd, N, odt in GC.CASES:
        x, w, fold, m0, shift = gemm_operands(M, Kd, N, gen, dev)
        got = K1.int8_matmul(x, w, fold, m0, shift, out_dtype=odt, zp_out=3)
        want = K1.int8_matmul_plain(x, w, fold, m0, shift, out_dtype=odt,
                                    zp_out=3)
        err = max(err, require_equal(f"int8_matmul {M}x{Kd}x{N} {odt}",
                                     got, want))
        p = K1.gemm_plan(M, N, Kd, n_sm)
        plans.add((p.form, p.bm, p.bn, p.split))
    # the extreme accumulation of a full-depth int8 product (2**25), split
    # and unsplit, twice back to back
    for M, Kd, N in ((B, 2048, 8192), (B * T, 2048, 8192)):
        x, w, fold = GC.extreme_operands(M, Kd, N, dev)
        want = K1.int8_matmul_plain(x, w, fold)
        first = K1.int8_matmul(x, w, fold)
        second = K1.int8_matmul(x, w, fold)
        err = max(err, require_equal(f"int8_matmul extremes {M}x{Kd}x{N}",
                                     first, want))
        err = max(err, require_equal(f"int8_matmul extremes {M}x{Kd}x{N}, "
                                     "second launch", second, want))
    torch.cuda.synchronize()
    log(f"[check] int8_matmul: {len(GC.CASES) + 2} shapes bit-exact vs "
        f"plain, {len(plans)} (form, bm, bn, split) plans on {n_sm} SMs: "
        f"{sorted(plans)}")
    return err


def quantized_layer(variant, d_in, H, d_proj, dev, seed, calib_T=6):
    """A layer quantized by the port's own calibration + recipe on ``dev``."""
    import torch
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.models import lstm as L

    cfg = L.LSTMConfig(d_in, H, d_proj if variant.use_projection else 0,
                       variant)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = L.init_lstm_params(gen, cfg, dev)
    if variant.use_layernorm:
        for g in params["L"]:
            params["L"][g] = 1.0 + 0.3 * torch.randn(
                H, generator=gen, device=dev)
    xs = 0.8 * torch.randn((B, calib_T, d_in), generator=gen, device=dev)
    col = TapCollector()
    with torch.no_grad():
        L.lstm_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_lstm_layer(params, cfg, stats)
    return arrays, spec, xs


def quantized_gru_layer(use_ln, d_in, H, dev, seed, calib_T=6):
    """A GRU layer quantized by the port's own calibration + recipe."""
    import torch
    from repro_torch.core import recipe as R
    from repro_torch.core.calibrate import Stats, TapCollector
    from repro_torch.models import gru as G

    cfg = G.GRUConfig(d_in, H, G.GRUVariant(use_layernorm=use_ln))
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = G.init_gru_params(gen, cfg, dev)
    if use_ln:
        for g in params["L"]:
            params["L"][g] = 1.0 + 0.3 * torch.randn(
                H, generator=gen, device=dev)
    xs = 0.8 * torch.randn((B, calib_T, d_in), generator=gen, device=dev)
    col = TapCollector()
    with torch.no_grad():
        G.gru_layer(params, cfg, xs, collector=col)
    stats = Stats()
    stats.merge(col.snapshot())
    arrays, spec = R.quantize_gru_layer(params, cfg, stats)
    return arrays, spec, xs


def run_scan_pair(arrays, spec, xs_q, valid_len=None, state0=None):
    """(kernel result, plain result) of the recurrent stage on one input,
    from ``state0`` (the reset state when None)."""
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.models import quant_lstm as QL

    Bx, Tx, d_in = xs_q.shape
    acc = K1.int8_matmul_plain(xs_q.reshape(Bx * Tx, d_in), arrays["W_cat"],
                               arrays["fold_x_cat"]).reshape(Bx, Tx, -1)
    if state0 is None:
        state0 = QL.initial_recurrent_state(spec, Bx, xs_q.device)
    got = K2.quant_recurrent_seq_scan(arrays, spec, acc, state0, valid_len)
    want = K2.quant_recurrent_seq_scan_plain(arrays, spec, acc, state0,
                                             valid_len)
    return got, want


def compare_scan(what, got, want):
    err = require_equal(f"{what} ys", got[0], want[0])
    if len(got[1]) != len(want[1]):
        raise AssertionError(f"{what}: {len(got[1])} state leaves, plain "
                             f"{len(want[1])}")
    for name, g, w in zip(("h", "c"), got[1], want[1]):
        err = max(err, require_equal(f"{what} {name}", g, w))
    return err


def check_layer(what, arrays, spec, xs_q, vl_full, vl_next, t_next):
    """The layer over ``xs_q`` from the reset state, then over its first
    ``t_next`` steps again from the carried (nonzero) final state; each
    unmasked and masked.  Returns the largest difference (0)."""
    got, want = run_scan_pair(arrays, spec, xs_q)
    err = compare_scan(what, got, want)
    err = max(err, compare_scan(f"{what} masked", *run_scan_pair(
        arrays, spec, xs_q, vl_full)))
    carried = want[1]
    if not bool(carried[0].ne(spec.zp_h_out).any()):
        raise AssertionError(f"{what}: the carried h is still the reset h")
    nxt = xs_q[:, :t_next].contiguous()
    err = max(err, compare_scan(f"{what} carried", *run_scan_pair(
        arrays, spec, nxt, state0=carried)))
    return max(err, compare_scan(f"{what} carried masked", *run_scan_pair(
        arrays, spec, nxt, vl_next, state0=carried)))


# rows the sequence kernels are checked at; 64 passes in two groups at full
# width.  The 16 LSTM variants at small widths take two widths and the
# first, second and last of these (the check's depth cut to keep the whole
# run inside its time limit)
SCAN_BATCHES = (1, B, 16, 64)
SCAN_SMALL = dict(widths=((10, 13, 6), (24, 40, 12)), batches=(1, B, 64))


def batch_inputs(spec, xs, Bx, gen):
    """The layer's int8 input at ``Bx`` rows: ``xs`` itself at B rows,
    else seeded float inputs of ``xs``'s scale quantized the same way."""
    import torch
    from repro_torch.models import quant_lstm as QL

    if Bx != xs.shape[0]:
        xs = 0.8 * torch.randn((Bx,) + tuple(xs.shape[1:]), generator=gen,
                               device=xs.device)
    return QL.quantize_input(xs, spec.s_x, spec.zp_x)


def batch_lens(base, Bx, dev):
    """``base`` valid lengths cycled over ``Bx`` rows (one row: the second,
    a partial length)."""
    import torch

    vals = [base[(i + int(Bx == 1)) % len(base)] for i in range(Bx)]
    return torch.tensor(vals, dtype=torch.int32, device=dev)


def check_layer_batches(what, arrays, spec, xs, full, nxt, t_next, gen,
                        batches=SCAN_BATCHES):
    """``check_layer`` at every batch size of ``batches``."""
    err = 0
    dev = xs.device
    for Bx in batches:
        xs_q = batch_inputs(spec, xs, Bx, gen)
        err = max(err, check_layer(f"{what} B={Bx}", arrays, spec, xs_q,
                                   batch_lens(full, Bx, dev),
                                   batch_lens(nxt, Bx, dev), t_next))
    return err


def check_scan(dev):
    import torch
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    gen = torch.Generator(device=dev).manual_seed(17)
    err = 0
    for i, variant in enumerate(L.ALL_VARIANTS):
        for d_in, H, d_proj in SCAN_SMALL["widths"]:
            arrays, spec, xs = quantized_layer(variant, d_in, H, d_proj, dev,
                                               seed=100 + i)
            err = max(err, check_layer_batches(
                f"{variant.name} H={H}", arrays, spec, xs, (6, 3, 0, 1),
                (2, 1, 0, 2), 2, gen, SCAN_SMALL["batches"]))
    log(f"[check] quant_lstm_scan: 16 variants x {len(SCAN_SMALL['widths'])} "
        f"widths x B in {SCAN_SMALL['batches']}, from the reset and the "
        "carried state, plain and masked, bit-exact vs plain")
    variant = L.LSTMVariant(use_layernorm=True, use_projection=True,
                            use_peephole=True)
    arrays, spec, xs = quantized_layer(variant, 333, 1001, 333, dev, seed=8,
                                       calib_T=T)
    err = max(err, check_layer_batches(
        "H=1001 LN+projection+peephole layer", arrays, spec, xs,
        (T, 17, 1, 0), (1, 0, 1, 0), 1, gen))
    variant = L.LSTMVariant(use_layernorm=True, use_projection=True)
    arrays, spec, xs = quantized_layer(variant, 640, 2048, 640, dev, seed=7,
                                       calib_T=T)
    err = max(err, check_layer_batches("full-width layer", arrays, spec, xs,
                                       (T, 17, 1, 0), (1, 0, 1, 0), 1, gen))
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    torch.cuda.synchronize()
    log("[check] quant_lstm_scan: full-width LN+projection layer "
        "(H=2048, d_proj=640) and an LN+projection+peephole layer at "
        f"H=1001 (a ragged split), B in {SCAN_BATCHES}: T=32 from the reset "
        "state and T=1 (the decode shape) from its carried state, plain and "
        "masked, bit-exact")
    return err, (arrays, spec, xs_q)


def check_gru_scan(dev):
    import torch
    from repro_torch.models import gru as G
    from repro_torch.models import quant_lstm as QL

    gen = torch.Generator(device=dev).manual_seed(19)
    err = 0
    for i, variant in enumerate(G.ALL_VARIANTS):
        for d_in, H in ((10, 13), (24, 40), (24, 48)):
            arrays, spec, xs = quantized_gru_layer(
                variant.use_layernorm, d_in, H, dev, seed=200 + i)
            err = max(err, check_layer_batches(
                f"GRU {variant.name} H={H}", arrays, spec, xs, (6, 3, 0, 1),
                (2, 1, 0, 2), 2, gen))
    log("[check] quant_gru_scan: 2 variants x 3 widths x B in "
        f"{SCAN_BATCHES}, from the reset and the carried state, plain and "
        "masked, bit-exact vs plain")
    arrays, spec, xs = quantized_gru_layer(True, 1001, 1001, dev, seed=10,
                                           calib_T=T)
    err = max(err, check_layer_batches("H=1001 GRU layer", arrays, spec, xs,
                                       (T, 17, 1, 0), (1, 0, 1, 0), 1, gen))
    arrays, spec, xs = quantized_gru_layer(True, 2048, 2048, dev, seed=9,
                                           calib_T=T)
    err = max(err, check_layer_batches("full-width GRU layer", arrays, spec,
                                       xs, (T, 17, 1, 0), (1, 0, 1, 0), 1,
                                       gen))
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    torch.cuda.synchronize()
    log("[check] quant_gru_scan: full-width LN layer (d_in = H = 2048) and "
        f"an LN layer at H=1001 (a ragged split), B in {SCAN_BATCHES}: T=32 "
        "from the reset state and T=1 (the decode shape) from its carried "
        "state, plain and masked, bit-exact")
    return err, (arrays, spec, xs_q)


def check_fixedpoint(dev):
    """The kernels' fixed-point header on the card against the PyTorch
    port (which the CPU tests hold against the JAX reference)."""
    from repro_torch.kernels import fixedpoint_check as FC

    c = FC.cases(seed=3)
    got = FC.on_card(c, dev)
    for key, want in FC.expected(c, dev).items():
        require_equal(f"fixedpoint.cuh {key}", got[key], want)
    log(f"[check] fixedpoint.cuh on the card: tanh_q15/sigmoid_q15 on all "
        f"65536 inputs x integer_bits {FC.INTEGER_BITS[0]}.."
        f"{FC.INTEGER_BITS[-1]}, {len(c['v'])} rsqrt multipliers, "
        f"{len(c['x'])} MBQMs equal the PyTorch port")


def check_cell_kernels(dev):
    """The standalone cell and LayerNorm kernels against their plain
    versions on the cases of ``repro_torch.testing.kernel_cases`` (the
    ``gpu`` tests use the same list): the cell at the shapes of
    ``tests/test_kernels.py`` (CIFG on and off, cell formats Q0/Q2/Q4, the
    peephole o gate with and without the in-fusion LN); the LayerNorm over
    row lengths 1..16384 with constant rows (V = 0) and rows at the int16
    extremes.  Returns ``(largest cell difference, largest LN difference)``
    (0)."""
    import torch
    from repro_torch.kernels import int_layernorm as KL
    from repro_torch.kernels import quant_lstm_cell as KC
    from repro_torch.testing import kernel_cases as KCASES

    gen = torch.Generator(device=dev).manual_seed(13)
    err_c = n_cell = 0
    for Bx, H in KCASES.CELL_SHAPES:
        for label, kw in KCASES.cell_cases(Bx, H, gen):
            got = KC.quant_lstm_cell(**kw)
            want = KC.quant_lstm_cell_plain(**kw)
            err_c = max(err_c,
                        require_equal(f"quant_lstm_cell {label} m", got[0],
                                      want[0]),
                        require_equal(f"quant_lstm_cell {label} c", got[1],
                                      want[1]))
            n_cell += 1
    err_l = n_ln = 0
    for n in KCASES.LN_LENGTHS:
        label, kw = KCASES.layernorm_case(n, gen)
        err_l = max(err_l, require_equal(f"int_layernorm {label}",
                                         KL.int_layernorm(**kw),
                                         KL.int_layernorm_plain(**kw)))
        n_ln += 1
    torch.cuda.synchronize()
    log(f"[check] quant_lstm_cell: {n_cell} cases (3 shapes x CIFG x m_c "
        "0/2/4, and the peephole o gate with and without in-fusion LN) "
        "bit-exact vs plain")
    log(f"[check] int_layernorm: n in 1..16384 ({n_ln} row lengths, "
        "constant and int16-extreme rows) bit-exact vs plain")
    # the step entries: each case launched twice back to back
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    gate_cases, cell_step_cases = KCASES.step_cases(dev, seed=40)
    clusters = {"int_layernorm_gates": set(), "quant_lstm_cell_step": set()}
    for label, kw in gate_cases:
        want = KL.int_layernorm_gates_plain(**kw)
        for i in range(2):
            err_l = max(err_l, require_equal(
                f"int_layernorm_gates {label} (launch {i})",
                KL.int_layernorm_gates(**kw), want))
        spec = kw["spec"]
        clusters["int_layernorm_gates"].add(KL.ln_plan(
            kw["acc_x"].shape[0], len(spec.variant.gates), spec.cfg_d_hidden,
            n_sm).C)
    for label, kw in cell_step_cases:
        want = KC.quant_lstm_cell_step_plain(**kw)
        for i in range(2):
            got = KC.quant_lstm_cell_step(**kw)
            err_c = max(err_c, require_equal(
                f"quant_lstm_cell_step {label} m (launch {i})", got[0],
                want[0]), require_equal(
                f"quant_lstm_cell_step {label} c (launch {i})", got[1],
                want[1]))
        spec = kw["spec"]
        if spec.use_layernorm and spec.use_peephole:
            clusters["quant_lstm_cell_step"].add(KL.ln_plan(
                kw["c_q"].shape[0], 1, spec.cfg_d_hidden, n_sm, 2).C)
    torch.cuda.synchronize()
    for entry, sizes in clusters.items():
        if sizes != set(range(1, 9)):
            raise AssertionError(f"{entry}: the cases split a row over "
                                 f"{sorted(sizes)} CTAs, not 1..8")
    log(f"[check] int_layernorm_gates (the gate pass): {len(gate_cases)} "
        f"cases and quant_lstm_cell_step: {len(cell_step_cases)} cases, "
        f"(B, H) in {KCASES.STEP_SHAPES} x LN x peephole x CIFG and the "
        f"LN + peephole layer at {KCASES.CLUSTER_SHAPES} (rows split over "
        "1..8 CTAs in each row form), each launched twice: bit-exact vs "
        "plain")
    return err_c, err_l


def step_kernel_counts(spec, steps):
    """Launches one stepwise layer of ``steps`` timesteps makes: per LSTM
    step the input, recurrent (and projection) GEMMs, the gate pass (one
    LayerNorm launch) where the layer has LN, one cell; per GRU step the
    input GEMM and the GRU kernel over one timestep."""
    from repro_torch.launch import serve

    counts = {name: 0 for name in serve.KERNELS}
    if spec.cell == "gru":
        counts.update(int8_matmul=steps, quant_gru_scan=steps)
        return counts
    counts.update(int8_matmul=steps * (2 + int(spec.use_projection)),
                  int_layernorm=steps * int(spec.use_layernorm),
                  quant_lstm_cell=steps)
    return counts


def compare_stepwise(what, arrays, spec, xs_q, state0=None, per_gate=False):
    """The stepwise executor (its launches counted) against the hoisted one
    (kernels 1 and 4) on one input, and the per-gate executor too where
    asked.  Returns the stepwise final state."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import quant_lstm as QL

    if state0 is None:
        state0 = QL.initial_recurrent_state(spec, xs_q.shape[0], xs_q.device)
    hoisted = ops.quant_recurrent_seq(arrays, spec, xs_q, state0)
    before = serve.launch_counts()
    got = ops.quant_recurrent_seq_stepwise(arrays, spec, xs_q, state0)
    counts = {k: v - before[k] for k, v in serve.launch_counts().items()}
    if counts != step_kernel_counts(spec, xs_q.shape[1]):
        raise AssertionError(f"{what}: stepwise launches {counts}, expected "
                             f"{step_kernel_counts(spec, xs_q.shape[1])}")
    compare_scan(f"{what} stepwise", got, hoisted)
    if per_gate:
        compare_scan(f"{what} per-gate", QL.quant_lstm_layer_ref(
            arrays, spec, xs_q, *state0), hoisted)
    torch.cuda.synchronize()
    return got[1]


def check_stepwise_layers(dev, gru_layer):
    """Every LSTM variant at the golden cases' widths (B=2, T=5, d_in=8,
    H=12, d_p=6) and a full-width LN+projection+peephole layer, both GRU
    variants and the full-width GRU layer: stepwise equals hoisted, from
    the reset state and from the carried one."""
    from repro_torch.models import gru as G
    from repro_torch.models import lstm as L
    from repro_torch.models import quant_lstm as QL

    for i, variant in enumerate(L.ALL_VARIANTS):
        arrays, spec, xs = quantized_layer(variant, 8, 12, 6, dev,
                                           seed=300 + i)
        xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)[:2, :5].contiguous()
        carried = compare_stepwise(variant.name, arrays, spec, xs_q,
                                   per_gate=True)
        compare_stepwise(f"{variant.name} carried", arrays, spec,
                         xs_q[:, :2].contiguous(), carried, per_gate=True)
    variant = L.LSTMVariant(use_layernorm=True, use_projection=True,
                            use_peephole=True)
    arrays, spec, xs = quantized_layer(variant, 640, 2048, 640, dev, seed=13,
                                       calib_T=T)
    xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)
    compare_stepwise("full-width LN+Proj+PH layer", arrays, spec, xs_q)
    log("[check] stepwise LSTM: 16 variants (B=2 T=5 H=12, from the reset "
        "and the carried state, per-gate too) and a full-width "
        "LN+projection+peephole layer (H=2048, B=4, T=32, in-fusion o-gate "
        "LN) equal the hoisted kernels")
    for i, variant in enumerate(G.ALL_VARIANTS):
        arrays, spec, xs = quantized_gru_layer(variant.use_layernorm, 8, 12,
                                               dev, seed=400 + i)
        xs_q = QL.quantize_input(xs, spec.s_x, spec.zp_x)[:2, :5].contiguous()
        carried = compare_stepwise(f"GRU {variant.name}", arrays, spec, xs_q)
        compare_stepwise(f"GRU {variant.name} carried", arrays, spec,
                         xs_q[:, :2].contiguous(), carried)
    arrays, spec, xs_q = gru_layer
    compare_stepwise("full-width GRU layer", arrays, spec, xs_q)
    log("[check] stepwise GRU: both variants (B=2 T=5 H=12, from the reset "
        "and the carried state) and the full-width LN layer (B=4, T=32) "
        "equal the hoisted kernel")


def stack_pass(qlayers, x, executor):
    """``quantize_input -> executor -> dequantize_output`` layer by layer
    from the reset state; returns each layer's ``(xs_q, ys, state)``."""
    from repro_torch.models import quant_lstm as QL

    layers = []
    for arrays, spec in qlayers:
        xs_q = QL.quantize_input(x, spec.s_x, spec.zp_x)
        state0 = QL.initial_recurrent_state(spec, xs_q.shape[0], xs_q.device)
        ys, state = executor(arrays, spec, xs_q, state0)
        layers.append((xs_q, ys, state))
        x = QL.dequantize_output(ys, spec.s_h, spec.zp_h_out)
    return layers


def timed_pass(qlayers, x, executor):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    layers = stack_pass(qlayers, x, executor)
    torch.cuda.synchronize()
    return layers, time.perf_counter() - t0


def stepwise_full_width(dev, model, repeats=3):
    """The stepwise executor over all layers of full-width ``lstm-rnnt`` on
    a B x T prompt: its launches counted, every layer equal to the hoisted
    path, layer 0 to the per-gate executor; prompt tokens/s of both."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.layers import embedding as emb
    from repro_torch.models import quant_lstm as QL

    params, qlayers, cfg = model
    with torch.no_grad():
        x = emb.embed_tokens(params, serve.random_prompt(
            cfg, B, T, dev, seed=4)).float()
        serve.reset_launch_counts()
        step, step_s = timed_pass(qlayers, x, ops.quant_recurrent_seq_stepwise)
        counts = serve.launch_counts()
        by_shape = gemm_shape_counts()
        expect = {k: sum(step_kernel_counts(spec, T)[k] for _, spec in qlayers)
                  for k in counts}
        path_launches(f"stepwise {cfg.name}", counts, expect)
        hoisted, hoisted_s = timed_pass(qlayers, x, ops.quant_recurrent_seq)
        for i, ((xq, ys, st), (hxq, hys, hst)) in enumerate(zip(step,
                                                                hoisted)):
            require_equal(f"stepwise layer {i} input", xq, hxq)
            compare_scan(f"stepwise layer {i}", (ys, st), (hys, hst))
        arrays, spec = qlayers[0]
        compare_scan("per-gate layer 0", QL.quant_lstm_layer_ref(
            arrays, spec, step[0][0]), (step[0][1], step[0][2]))
        torch.cuda.synchronize()
        log(f"[stepwise] {cfg.name}: all {len(qlayers)} layers' ys and "
            f"states equal the hoisted path (B={B}, T={T}); layer 0 equals "
            "the per-gate executor")
        times = {"stepwise": [step_s], "hoisted": [hoisted_s]}
        for _ in range(repeats):
            for name, executor in (("stepwise",
                                    ops.quant_recurrent_seq_stepwise),
                                   ("hoisted", ops.quant_recurrent_seq)):
                layers, secs = timed_pass(qlayers, x, executor)
                if not torch.equal(layers[-1][1], step[-1][1]):
                    raise AssertionError(f"a repeated {name} pass differs")
                times[name].append(secs)
        # profiled over the first two layers (both input widths): the
        # profiler's bookkeeping of a whole pass costs a minute
        kernels = {}
        busy_ms, prof_wall_s = device_busy_ms(lambda: timed_pass(
            qlayers[:2], x, ops.quant_recurrent_seq_stepwise)[1], kernels)
        step_ops = between_kernels(kernels, 2 * T)
    tok_s = {name: sorted(B * T / t for t in v) for name, v in times.items()}
    for name, vals in tok_s.items():
        log(f"[stepwise] {cfg.name} {name} prompt tokens/s over "
            f"{len(vals)} passes: min {vals[0]:.1f} median "
            f"{vals[len(vals) // 2]:.1f} max {vals[-1]:.1f} (host clock)")
    share = (busy_ms / 1e3 / prof_wall_s) if busy_ms else None
    log(f"[stepwise] {cfg.name} profiled stepwise layers 0-1: device busy "
        f"{busy_ms} ms of {prof_wall_s * 1e3:.1f} ms wall (busy share "
        f"{share})")
    return {"arch": cfg.name, "launches": counts,
            "device_activities_layers_0_1": kernels,
            "other_device_ops_layers_0_1": step_ops,
            "gemm_launches_by_shape": by_shape, "prompt_tok_s": tok_s,
            "first_pass_s": {"stepwise": step_s, "hoisted": hoisted_s},
            "profiled": {"device_busy_ms": busy_ms, "wall_s": prof_wall_s,
                         "busy_share": share}}


STEP_KERNELS = ("gemm_kernel", "int_layernorm_kernel", "quant_lstm_cell")


def between_kernels(kernels, steps):
    """From the profiled device activities of ``steps`` stepwise LSTM steps
    of LN layers: fail unless the port's kernels ran exactly 5 a step (3
    GEMMs, the gate pass, the cell) and everything else on the device (a
    layer's quantize, transpose, stack and dequantize) fewer times than
    there are steps, so that no PyTorch op runs between a step's kernels.
    Returns the other activities' total; None where the profiler recorded
    nothing."""
    if not kernels:
        log("[stepwise] the profiler recorded no device activity: the ops "
            "between the kernels are not counted")
        return None
    ours = sum(n for k, n in kernels.items()
               if any(name in k for name in STEP_KERNELS))
    other = {k: n for k, n in kernels.items()
             if not any(name in k for name in STEP_KERNELS)}
    log(f"[stepwise] profiled {steps} steps: {ours} launches of the port's "
        f"kernels, {sum(other.values())} other device activities "
        f"{sorted(other.items(), key=lambda kv: -kv[1])[:8]}")
    if ours != 5 * steps or sum(other.values()) >= steps:
        raise AssertionError(f"stepwise: {ours} kernel launches and "
                             f"{sum(other.values())} other device activities "
                             f"over {steps} steps; expected {5 * steps} and "
                             f"fewer than {steps}")
    return sum(other.values())


def plain_forward(params, qlayers, tokens, states):
    """``lstm_lm.quant_forward`` with every kernel swapped for its plain
    version (the reference for the served run).  Returns the last
    position's logits and the new per-leaf states (``{"h": [...],
    "c": [...]}`` for the LSTM, ``{"h": [...]}`` for the GRU)."""
    import torch
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.layers import embedding as emb
    from repro_torch.models import lstm_lm
    from repro_torch.models import quant_lstm as QL

    keys = lstm_lm._cell_state_keys(qlayers)
    x = emb.embed_tokens(params, tokens).float()
    new = {k: [] for k in keys}
    for i, (arrays, spec) in enumerate(qlayers):
        x_q = QL.quantize_input(x, spec.s_x, spec.zp_x)
        Bx, Tx, d_in = x_q.shape
        acc = K1.int8_matmul_plain(x_q.reshape(Bx * Tx, d_in),
                                   arrays["W_cat"], arrays["fold_x_cat"])
        ys, layer = K2.quant_recurrent_seq_scan_plain(
            arrays, spec, acc.reshape(Bx, Tx, -1),
            tuple(states[k][i] for k in keys))
        x = QL.dequantize_output(ys, spec.s_h, spec.zp_h_out)
        for k, leaf in zip(keys, layer, strict=True):
            new[k].append(leaf)
    logits = emb.logits_head(params, x.to(torch.bfloat16))
    return logits[:, -1], new


def compare_states(what, got, want):
    for key in want:
        for i, (g, w) in enumerate(zip(got[key], want[key], strict=True)):
            require_equal(f"{what} layer {i} {key}", g, w)


def gemm_shape_counts():
    """Kernel 1's launches since the last reset, by shape:
    ``{"M4 K2048 N8192 int32": n, ...}``."""
    from repro_torch.kernels import int8_matmul as K1

    return {f"M{m} K{k} N{n} {dt}": c for (m, k, n, dt), c
            in sorted(K1.launches_by_shape.items())}


def path_launches(what, counts, expect):
    """Fail unless every kernel of a served path launched (as often as
    ``expect`` says, where it says)."""
    log(f"[{what}] launches: {counts}")
    for name, n in expect.items():
        if n is None:
            if counts[name] <= 0:
                raise AssertionError(f"{what}: {name} never launched")
        elif counts[name] != n:
            raise AssertionError(f"{what}: {name} launched {counts[name]} "
                                 f"times, expected {n}")


def serve_full_width(dev, arch, repeats):
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lstm_lm

    cfg = get_config(arch)
    t0 = time.perf_counter()
    params, qlayers = serve.build_model(cfg, B, T, dev)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}: init + calibration + quantization of "
        f"{len(qlayers)} layers in {time.perf_counter() - t0:.1f}s")
    prompt = serve.random_prompt(cfg, B, T, dev)
    scan = SCAN_OF[lstm_lm.rnn_cell(cfg)]
    expect = {name: 0 for name in serve.KERNELS}
    expect.update({"int8_matmul": cfg.n_layers * (1 + GEN),
                   scan: cfg.n_layers * (1 + GEN)})
    serve.reset_launch_counts()
    res = serve.serve(params, qlayers, cfg, prompt, GEN)
    counts = serve.launch_counts()
    path_launches(f"serve {cfg.name}", counts, expect)
    if res.launches != counts:
        raise AssertionError(f"serve() counted {res.launches}")
    toks = res.tokens
    if tuple(toks.shape) != (B, GEN) or int(toks.min()) < 0 or \
            int(toks.max()) >= cfg.vocab_size:
        raise AssertionError(f"bad generated tokens {toks}")
    log(f"[serve] {cfg.name} prompt tokens/s: {B * T / res.prefill_s:.1f}  "
        f"decode tokens/s: {B * GEN / res.decode_s:.1f}  "
        f"(prefill {res.prefill_s * 1e3:.2f} ms, decode "
        f"{res.decode_s * 1e3 / GEN:.2f} ms/step, host clock)")
    log(f"[serve] {cfg.name} sample:", toks[0].tolist())
    # the served run, step by step, against the plain-version stack
    with torch.no_grad():
        logits, st = plain_forward(
            params, qlayers, prompt,
            lstm_lm.init_quant_decode_state(qlayers, B, dev))
        compare_states("prefill", res.states[0], st)
        for i in range(GEN):
            tok = logits.argmax(-1)[:, None]
            require_equal(f"decode step {i} input",
                          res.decode_inputs[:, i:i + 1], tok)
            logits, st = plain_forward(params, qlayers, tok, st)
            compare_states(f"decode step {i}", res.states[i + 1], st)
        require_equal("last greedy token", toks[:, -1:],
                      logits.argmax(-1)[:, None])
    if serve.launch_counts() != counts:
        raise AssertionError("the plain-version stack launched a kernel")
    log(f"[serve] {cfg.name}: integer states of all {cfg.n_layers} layers "
        f"after the prefill and after each of the {GEN} decode steps, and "
        "every greedy token, equal the plain-version stack")
    spread = None
    if repeats:  # the spread of the host-clock metrics: the serve, repeated
        reps = [serve.serve(params, qlayers, cfg, prompt, GEN)
                for _ in range(repeats)]
        spread = {
            "prompt_tok_s": sorted(B * T / r.prefill_s for r in reps),
            "decode_tok_s": sorted(B * GEN / r.decode_s for r in reps)}
        if any(not torch.equal(r.tokens, toks) for r in reps):
            raise AssertionError("a repeated serve generated other tokens")
        for name, vals in spread.items():
            log(f"[serve] {cfg.name} {name} over {repeats} repeats: min "
                f"{vals[0]:.1f} median {vals[repeats // 2]:.1f} max "
                f"{vals[-1]:.1f}")
    out = {"arch": cfg.name, "launches": counts, "prefill_s": res.prefill_s,
           "decode_s": res.decode_s, "repeats": spread,
           "sample": toks[0].tolist()}
    return out, (params, qlayers, cfg)


def float_full_width(dev, int_serves):
    """[float]: the paper's float baseline at full width and its PTQ.

    (a) serves full-width ``lstm-rnnt`` and ``gru-rnnt`` float (``--quant
    none``: the prompt teacher-forced through the bundle's ``decode``, then
    ``GEN`` greedy tokens), where no kernel may launch; (b) holds decode
    against forward (F3); (c) holds lstm-rnnt's float stack on the card to
    the CPU's on the same weights at T ``FLOAT_CPU_T`` (each layer within
    ``CARD_CPU_RTOL`` of its largest |output|, the logits by F3); (d)
    calibrates lstm-rnnt on ``PTQ_BATCHES`` SyntheticLM batches with
    ``calibrate.calibrate`` (one batch's ``Stats`` must equal
    ``calibration_stats``), quantizes every layer and serves the prompt
    integer-only (kernels 1 and 4, 10 x (1 + GEN) launches each), reporting
    how far it lands from the float serve; (e) holds fake quantization on
    the card to the CPU bit for bit at 10**6 values a case."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.testing import float_checks as FC

    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise AssertionError("float32 products must stay float32 (TF32 on)")
    out = {}
    for arch in ("lstm-rnnt", "gru-rnnt"):
        cfg = get_config(arch)
        bundle, params = serve.build_bundle(cfg, dev)
        prompt = serve.random_prompt(cfg, B, T, dev)
        serve.reset_launch_counts()
        res = serve.serve_bundle(bundle, params, prompt, GEN, SERVE_MAX_LEN)
        what = f"float serve {cfg.name}"
        path_launches(what, serve.launch_counts(),
                      {name: 0 for name in serve.KERNELS})
        toks = res.tokens
        if tuple(toks.shape) != (B, GEN) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size or not bool(
                    torch.isfinite(res.logits.float()).all()):
            raise AssertionError(f"{what}: bad tokens {toks} or logits")
        ints = int_serves[arch]
        log(f"[float] {cfg.name} float prompt tokens/s: "
            f"{B * T / res.prefill_s:.1f}  decode tokens/s: "
            f"{B * GEN / res.decode_s:.1f}; integer (this call's [serve]): "
            f"{B * T / ints['prefill_s']:.1f} / "
            f"{B * GEN / ints['decode_s']:.1f} (host clock)")
        log(f"[float] {what} sample:", toks[0].tolist())
        dec, fwd = FC.decode_against_forward(params, cfg, prompt)
        ulps = FC.check_logits_f3(f"{cfg.name} decode against forward",
                                  dec, fwd)
        log(f"[float] {cfg.name}: decode_step teacher-forced over {T} "
            f"tokens against forward: largest |d| {ulps:.3g} bf16 ulps of "
            f"the row's largest |logit| (equal: {torch.equal(dec, fwd)})")
        entry = {"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                 "int_prefill_s": ints["prefill_s"],
                 "int_decode_s": ints["decode_s"],
                 "sample": toks[0].tolist(), "decode_vs_forward_ulps": ulps}
        if arch == "lstm-rnnt":
            t0 = time.perf_counter()
            errs = FC.card_against_cpu(params, FC.params_to(params, "cpu"),
                                       cfg, prompt[:, :FLOAT_CPU_T])
            log(f"[float] {cfg.name} card against CPU, B {B} T "
                f"{FLOAT_CPU_T}, all {cfg.n_layers} layers: largest |d| over "
                f"the layer's largest |output| "
                f"{max(v for k, v in errs.items() if k != 'logits_ulps'):.3g}"
                f" (limit {FC.CARD_CPU_RTOL}), logits "
                f"{errs['logits_ulps']:.3g} bf16 ulps "
                f"({time.perf_counter() - t0:.1f}s)")
            entry["card_vs_cpu"] = errs
            entry["ptq"] = ptq_full_width(dev, cfg, params, prompt, res)
        out[arch] = entry
    t0 = time.perf_counter()
    n = FC.fake_quant_card_against_cpu(
        torch.Generator(device=dev).manual_seed(7), dev)
    log(f"[float] fake quant: {n} values in 7 cases, card equal to CPU bit "
        f"for bit ({time.perf_counter() - t0:.1f}s)")
    out["fake_quant_values"] = n
    return out


def ptq_full_width(dev, cfg, params, prompt, float_res, data_vocab=None):
    """(d) of ``float_full_width``: calibrate (on ``SyntheticLM`` over the
    first ``data_vocab`` ids, all by default), quantize, serve integer."""
    import torch
    from repro_torch.core import calibrate
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import lstm_lm

    t0 = time.perf_counter()
    data = SyntheticLM(DataConfig(vocab_size=data_vocab or cfg.vocab_size,
                                  seq_len=T, global_batch=B))
    batches = [data.batch_at(step) for step in range(PTQ_BATCHES)]

    def apply_fn(p, batch, collector):
        tokens = torch.from_numpy(batch["tokens"]).to(dev)
        lstm_lm.forward(p, cfg, tokens, collector=collector)

    one = calibrate.calibrate(apply_fn, params, batches[:1])
    want = lstm_lm.calibration_stats(
        params, cfg, torch.from_numpy(batches[0]["tokens"]).to(dev))
    if one.to_dict() != want.to_dict():
        raise AssertionError("calibrate's Stats of one batch differ from "
                             "calibration_stats")
    stats = calibrate.calibrate(apply_fn, params, batches)
    qlayers = lstm_lm.quantize_layers(params, cfg, stats)
    torch.cuda.synchronize()
    log(f"[float] {cfg.name} PTQ: calibrated on {PTQ_BATCHES} SyntheticLM "
        f"batches of {B} x {T} ({len(stats.ranges)} taps; one batch equal "
        f"to calibration_stats) and quantized {len(qlayers)} layers in "
        f"{time.perf_counter() - t0:.1f}s")
    scan = SCAN_OF[lstm_lm.rnn_cell(cfg)]
    expect = {name: 0 for name in serve.KERNELS}
    expect.update({"int8_matmul": cfg.n_layers * (1 + GEN),
                   scan: cfg.n_layers * (1 + GEN)})
    serve.reset_launch_counts()
    res = serve.serve(params, qlayers, cfg, prompt, GEN)
    counts = serve.launch_counts()
    path_launches(f"PTQ serve {cfg.name}", counts, expect)
    with torch.no_grad():
        li, _ = lstm_lm.quant_prefill(
            params, qlayers, cfg, prompt,
            lstm_lm.init_quant_decode_state(qlayers, B, dev))
        lf = lstm_lm.prefill(params, cfg, prompt)
    rel = float((li.float() - lf.float()).abs().max() / lf.float().abs().max())
    agree = float((res.tokens == float_res.tokens).float().mean())
    first = float((res.tokens[:, 0] == float_res.tokens[:, 0]).float().mean())
    log(f"[float] {cfg.name} PTQ integer serve against the float serve: "
        f"greedy tokens agree {agree:.4f} ({first:.2f} of the first), "
        f"max |logit_int - logit_float| / max |logit_float| at the prefill "
        f"{rel:.4g} (reported, no gate)")
    log("[float] PTQ serve sample:", res.tokens[0].tolist())
    return {"launches": counts, "token_agreement": agree,
            "first_token_agreement": first, "prefill_logit_rel_err": rel,
            "taps": len(stats.ranges), "sample": res.tokens[0].tolist()}


def _train_cli(*flags):
    """``python -m repro_torch.launch.train`` in this process (its log lines
    printed), on the card."""
    from repro_torch.launch import train

    return train.run(train.parse_args(
        ["--batch", str(TRAIN_B), "--seq", str(TRAIN_T), "--lr",
         str(TRAIN_LR), *flags]))


def _train_run_summary(what, res, cfg, held):
    """Finite losses; step ms and trained tokens/s over the steps after the
    first (which pays the allocator's warm-up); the peak device memory
    over the ``held`` bytes that earlier phases kept allocated."""
    import torch

    if not all(math.isfinite(v) for v in res.losses):
        raise AssertionError(f"{what}: a loss is not finite: {res.losses}")
    steady = sorted(res.step_s[1:] or res.step_s)
    step_s = steady[len(steady) // 2]
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    log(f"[train] {what}: losses {[round(v, 4) for v in res.losses]}; "
        f"first step {res.step_s[0] * 1e3:.1f} ms, then median "
        f"{step_s * 1e3:.1f} ms a step ({TRAIN_B * TRAIN_T / step_s:.1f} "
        f"trained tokens/s, host clock), peak memory {peak:.2f} GiB over "
        f"the {held / 2**30:.2f} GiB held before the run")
    return {"arch": cfg.name, "losses": res.losses, "step_s": res.step_s,
            "median_step_s": step_s,
            "tokens_per_s": TRAIN_B * TRAIN_T / step_s,
            "peak_mem_gib": peak, "held_before_gib": held / 2**30}


def train_full_width(dev):
    """[train]: the training path on the card (no kernel launched: the
    train step runs plain PyTorch and autograd, as the reference runs XLA).

    (a) ``launch/train.py`` on full-width lstm-rnnt, B ``TRAIN_B`` x T
    ``TRAIN_T``, ``SyntheticLM`` over the first ``TRAIN_DATA_VOCAB`` ids,
    AdamW at lr ``TRAIN_LR``: ``TRAIN_STEPS`` float steps with an async
    checkpoint every ``TRAIN_CKPT_EVERY``; every loss finite, the last
    below the first; the last checkpoint restores into fresh trees
    bit-equal to the run's final state, and from the middle one the next
    step's loss equals the uninterrupted run's bit for bit; one more step
    under the profiler at T ``TRAIN_PROF_T`` gives the device's busy share;
    (b) ``TRAIN_QAT_STEPS`` QAT steps from fresh params over the whole
    vocabulary; (c) ``TRAIN_GRU_STEPS`` float steps of full-width
    gru-rnnt; (d) one step of full-width lstm-rnnt cut to
    ``TRAIN_CPU["n_layers"]`` layers on the card against the CPU
    (``testing/train_checks.py``); (e) the attention layer under autograd
    on the card (kernel 5, then the backward kernel) against the CPU; (f)
    one step of ``TRAIN_DENSE`` at smoke width, S ``TRAIN_DENSE_S``, on the
    card against the CPU; then ``train_attention``."""
    import dataclasses
    import tempfile

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.testing import train_checks as TC

    out = {}
    cfg = get_config("lstm-rnnt")
    with tempfile.TemporaryDirectory() as ckpt_dir:
        serve.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res = _train_cli("--arch", cfg.name, "--steps", str(TRAIN_STEPS),
                         "--data-vocab", str(TRAIN_DATA_VOCAB),
                         "--ckpt-dir", ckpt_dir, "--ckpt-every",
                         str(TRAIN_CKPT_EVERY))
        path_launches("train lstm-rnnt", serve.launch_counts(),
                      {name: 0 for name in serve.KERNELS})
        run = _train_run_summary(f"{cfg.name} float", res, cfg, held)
        if not res.losses[-1] < res.losses[0]:
            raise AssertionError(f"{cfg.name}: the loss did not fall over "
                                 f"{TRAIN_STEPS} steps: {res.losses}")
        # (a) the checkpoints, restored into fresh trees
        t0 = time.perf_counter()
        art, data = res.art, res.data
        bundle = model_zoo.build(cfg)
        fresh = bundle.init(torch.Generator(device=dev).manual_seed(1), dev)
        like = (fresh, art.init_opt(fresh))
        mgr = CheckpointManager(ckpt_dir)
        if sorted(mgr.steps()) != list(range(TRAIN_CKPT_EVERY,
                                             TRAIN_STEPS + 1,
                                             TRAIN_CKPT_EVERY)):
            raise AssertionError(f"checkpoints {sorted(mgr.steps())}")
        (p_end, o_end), _ = mgr.restore(TRAIN_STEPS, like)
        n_leaves = 0
        for got, want in zip(tu.leaves((p_end, o_end)),
                             tu.leaves((res.params, res.opt_state)),
                             strict=True):
            if got.dtype != want.dtype or got.device != want.device or \
                    not torch.equal(got, want):
                raise AssertionError("a restored leaf differs from the "
                                     "saved one")
            n_leaves += 1
        del p_end, o_end
        k = TRAIN_CKPT_EVERY
        (p_k, o_k), _ = mgr.restore(k, like)
        resumed = float(art.step_fn(p_k, o_k, data.batch_at(k))[2]["loss"])
        if resumed != res.losses[k]:
            raise AssertionError(f"step {k} from the checkpoint: loss "
                                 f"{resumed!r}, uninterrupted "
                                 f"{res.losses[k]!r}")
        del p_k, o_k, fresh, like
        ckpt_s = time.perf_counter() - t0
    log(f"[train] {cfg.name} checkpoints at steps {k} and {TRAIN_STEPS} "
        f"(async): {n_leaves} leaves restored bit-equal; step {k} resumed "
        f"from its checkpoint gives loss {resumed!r}, the uninterrupted "
        f"run's bit for bit ({ckpt_s:.1f}s)")
    # the device's busy share, from the same step at T TRAIN_PROF_T: the
    # profiler's events of a T TRAIN_T step (~10**6) take minutes to sum
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                   seq_len=TRAIN_PROF_T,
                                   global_batch=TRAIN_B)).batch_at(0)

    def one_step():
        t0 = time.perf_counter()
        art.step_fn(res.params, res.opt_state, batch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_s = sorted(one_step() for _ in range(3))[1]
    busy_ms, prof_wall_s = device_busy_ms(one_step)
    share = None if busy_ms is None else busy_ms / 1e3 / wall_s
    log(f"[train] {cfg.name} float step at B {TRAIN_B} T {TRAIN_PROF_T}: "
        f"{wall_s * 1e3:.1f} ms (median of 3, host clock); under the "
        f"profiler ({prof_wall_s * 1e3:.1f} ms) the device is busy "
        f"{busy_ms} ms: busy share {share}")
    # PTQ of the trained params, as a log (PERF.md section 7): the float
    # serve of a prompt from the training rule against the integer serve
    prompt = torch.from_numpy(SyntheticLM(DataConfig(
        vocab_size=TRAIN_DATA_VOCAB, seq_len=T, global_batch=B)).batch_at(
            TRAIN_STEPS + 1)["tokens"]).to(dev)
    with torch.no_grad():
        float_res = serve.serve_bundle(model_zoo.build(cfg), res.params,
                                       prompt, GEN, SERVE_MAX_LEN)
    log(f"[train] {cfg.name} after {TRAIN_STEPS} steps, float serve "
        f"sample: {float_res.tokens[0].tolist()}")
    run["ptq"] = ptq_full_width(dev, cfg, res.params, prompt, float_res,
                                data_vocab=TRAIN_DATA_VOCAB)
    run.update(checkpoint_leaves=n_leaves, resumed_loss=resumed,
               checkpoint_s=ckpt_s, profiled_T=TRAIN_PROF_T,
               profiled_step_s=wall_s, device_busy_ms=busy_ms,
               profiled_wall_s=prof_wall_s, busy_share=share)
    out["lstm-rnnt float"] = run
    del res, art, batch
    torch.cuda.empty_cache()

    # (b) QAT, (c) gru-rnnt
    for arch, steps, flags, what in (
            ("lstm-rnnt", TRAIN_QAT_STEPS, ("--qat",), "lstm-rnnt QAT"),
            ("gru-rnnt", TRAIN_GRU_STEPS, (), "gru-rnnt float")):
        serve.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        res = _train_cli("--arch", arch, "--steps", str(steps), *flags)
        path_launches(f"train {what}", serve.launch_counts(),
                      {name: 0 for name in serve.KERNELS})
        out[what] = _train_run_summary(what, res, get_config(arch), held)
        del res
        torch.cuda.empty_cache()

    # (d) card against CPU
    cut = dataclasses.replace(cfg, n_layers=TRAIN_CPU["n_layers"])
    params = model_zoo.build(cut).init(
        torch.Generator(device=dev).manual_seed(2), dev)
    batch = SyntheticLM(DataConfig(
        vocab_size=cut.vocab_size, seq_len=TRAIN_CPU["T"],
        global_batch=TRAIN_CPU["B"])).batch_at(0)
    t0 = time.perf_counter()
    cmp = TC.step_card_against_cpu(cut, params, batch, OptConfig(lr=TRAIN_LR))
    log(f"[train] {cfg.name} cut to {cut.n_layers} layers, B "
        f"{TRAIN_CPU['B']} T {TRAIN_CPU['T']}, one step on the card against "
        f"the CPU: loss {cmp['card']['loss']!r} / {cmp['cpu']['loss']!r} "
        f"(relative {cmp['loss_rel']:.3g}, limit {TC.LOSS_RTOL}), grad_norm "
        f"{cmp['card']['grad_norm']!r} / {cmp['cpu']['grad_norm']!r} "
        f"(relative {cmp['grad_norm_rel']:.3g}, limit {TC.GNORM_RTOL}) "
        f"({time.perf_counter() - t0:.1f}s)")
    out["card_vs_cpu"] = cmp
    del params

    # (e) the attention layer under autograd: kernel 5 and the backward
    out["flash_grad_card_vs_cpu"] = TC.flash_grad_card_against_cpu(dev)
    log(f"[train] flash attention under autograd (float32, B 1 S 1100 H 8 "
        f"KVH 2 D 128): kernel 5 and the backward kernel once each, the "
        f"output and gradients against the CPU's, max |d| "
        f"{out['flash_grad_card_vs_cpu']}")

    # (f) the dense transformer's step
    dcfg = get_config(TRAIN_DENSE, smoke=True)
    params = model_zoo.build(dcfg).init(
        torch.Generator(device=dev).manual_seed(3), dev)
    batch = SyntheticLM(DataConfig(vocab_size=dcfg.vocab_size,
                                   seq_len=TRAIN_DENSE_S,
                                   global_batch=2)).batch_at(0)
    cmp = TC.step_card_against_cpu(dcfg, params, batch,
                                   OptConfig(lr=TRAIN_LR))
    log(f"[train] {dcfg.name} S {TRAIN_DENSE_S}, one step on the card "
        f"against the CPU: loss relative {cmp['loss_rel']:.3g}, grad_norm "
        f"relative {cmp['grad_norm_rel']:.3g} (limit {TC.BF16_RTOL})")
    out["dense_card_vs_cpu"] = cmp
    del params
    out["attention"] = train_attention(dev)
    return out


def check_flash_bwd_cases(dev):
    """The flash backward kernel against its plain version, and kernel 5's
    lse against its plain version's, at every case of
    ``attention_checks.FLASH_BWD_MODEL_CASES`` and ``FLASH_BWD_SMALL_CASES``
    (``attention_checks.check_flash_bwd``: float32 within 2e-5 + 2e-5
    |ref|, bf16 within 2 ulps of the row's largest |ref|, the lse by the
    float32 rule; each call made twice, with the same bits), printing the
    form and tiles each case took.  Returns the largest |d| of the lse and
    of the gradients by dtype, and each case's result."""
    import torch
    from repro_torch.testing import attention_checks as AC

    gen = torch.Generator(device=dev).manual_seed(23)
    out = {"lse": 0.0, "float32": 0.0, "bfloat16": 0.0, "cases": []}
    for case in AC.FLASH_BWD_MODEL_CASES + AC.FLASH_BWD_SMALL_CASES:
        label, B_, Sq, Sk, H, KVH, D, causal, window, q_offset, dtype, \
            layout = case
        t0 = time.perf_counter()
        kw = AC.flash_bwd_inputs(gen, case)
        res = AC.check_flash_bwd(label, **kw)
        torch.cuda.synchronize()
        dt = str(dtype).split(".")[-1]
        out["lse"] = max(out["lse"], res["lse_err"])
        out[dt] = max(out[dt], res["grad_err"])
        form = "tensor-core" if res["tensor_cores"] else "FMA"
        out["cases"].append(dict(res, label=label, splits=list(res["splits"])))
        log(f"[train] flash backward {label} (B {B_} Sq {Sq} Sk {Sk} H {H} "
            f"KVH {KVH} D {D} causal {causal} window {window} q_offset "
            f"{q_offset} {dt} {layout}): {form} form (dk/dv {res['dkdv_keys']}"
            f" keys x {res['dkdv_rows']} rows, dq {res['dq_rows']} rows x "
            f"{res['dq_keys']} keys) at splits {res['splits']}, each twice "
            f"with the same bits; lse max|d| {res['lse_err']:.3g}, dq/dk/dv "
            f"max|d| {res['grad_err']:.3g}, within tolerance of the plain "
            f"versions ({time.perf_counter() - t0:.1f}s)")
        del kw
    return out


def _finite_run(what, losses, grad_norms):
    if not all(math.isfinite(v) for v in list(losses) + list(grad_norms)):
        raise AssertionError(f"{what}: a loss or grad norm is not finite: "
                             f"{losses} {grad_norms}")


def _expected_flash(cfg, n_attn, steps=1):
    """Launches of kernel 5 and of the backward over ``steps`` train
    steps of a model with ``n_attn`` attention layers past S 1024: each
    layer's forward once, again in the backward where the model recomputes
    its layers (the transformer's remat), and the backward once."""
    from repro_torch.models import transformer

    remat = cfg.family in ("dense", "vlm", "moe") and \
        transformer.remat_of(cfg, True)
    return {"flash_attention": n_attn * (2 if remat else 1) * steps,
            "flash_attention_bwd": n_attn * steps}


# the device time of a train step by kind of kernel (a kernel's name holds
# one of its group's words; the first group that matches takes it)
STEP_GROUPS = (
    ("flash forward (kernel 5)", ("flash_kernel", "flash_wgmma_kernel")),
    ("flash backward", ("delta_kernel", "dkdv_kernel", "dkdv_sum_kernel",
                        "dq_kernel", "delta_lse_kernel", "dkdv_wgmma_kernel",
                        "dq_wgmma_kernel")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
)


def profile_train_step(res, step):
    """One more step of a train CLI run's ``res`` (its step, params,
    optimizer state and data) under ``torch.profiler``: the device ms of
    each ``STEP_GROUPS`` group and of the rest, their launches, and the
    busy share, the device ms over the wall seconds of the same step
    unprofiled (the median of the run's steps after the first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = res.data.batch_at(step)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res.params, res.opt_state, m = res.art.step_fn(
            res.params, res.opt_state, batch)
        torch.cuda.synchronize()
        prof_wall_s = time.perf_counter() - t0
    _finite_run("profiled step", [float(m["loss"])], [float(m["grad_norm"])])
    groups = {name: {"ms": 0.0, "launches": 0} for name, _ in STEP_GROUPS}
    groups["other"] = {"ms": 0.0, "launches": 0}
    bwd = {}  # the flash backward's device ms and launches by kernel
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = next((g for g, words in STEP_GROUPS
                     if any(w in e.key for w in words)), "other")
        groups[name]["ms"] += e.self_device_time_total / 1e3
        groups[name]["launches"] += e.count
        if name == "flash backward":
            word = max((w for w in dict(STEP_GROUPS)[name] if w in e.key),
                       key=len)
            ms, n = bwd.get(word, (0.0, 0))
            bwd[word] = (ms + e.self_device_time_total / 1e3, n + e.count)
    busy_ms = sum(g["ms"] for g in groups.values())
    others = sorted(((e.self_device_time_total / 1e3, e.count, e.key)
                     for e in prof.key_averages()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not any(w in e.key for _, words in STEP_GROUPS
                                 for w in words)), reverse=True)[:8]
    steady = sorted(res.step_s[1:])
    wall_s = steady[len(steady) // 2]
    share = busy_ms / 1e3 / wall_s if busy_ms > 0 else None
    log(f"[train] a profiled step: device busy {busy_ms:.1f} ms of the "
        f"unprofiled step's {wall_s * 1e3:.1f} ms (busy share {share}; "
        f"{prof_wall_s * 1e3:.1f} ms under the profiler); by kernel: "
        + ", ".join(f"{g} {v['ms']:.1f} ms in {v['launches']} launches"
                    for g, v in groups.items())
        + "; the flash backward by kernel: " + ", ".join(
            f"{w} {ms:.1f} ms in {n}" for w, (ms, n) in sorted(bwd.items()))
        + "; the most of the rest: " + "; ".join(
            f"{ms:.1f} ms in {n} x {name[:90]}" for ms, n, name in others))
    return {"groups": groups, "flash_backward_by_kernel": bwd,
            "busy_ms": busy_ms, "step_wall_s": wall_s,
            "busy_share": share, "profiled_wall_s": prof_wall_s,
            "top_other": [{"ms": ms, "launches": n, "kernel": name}
                          for ms, n, name in others]}


def train_attention(dev):
    """[train]'s attention families past S 1024.  (a)
    ``check_flash_bwd_cases``;
    (b) full-width ``TRAIN_LM`` through ``launch/train.py`` at B
    ``TRAIN_LM_B`` x S ``TRAIN_LM_S``, ``TRAIN_LM_STEPS`` AdamW steps with
    per-layer remat: every loss and grad norm finite, kernel 5 launched
    twice a layer a step (forward and recompute) and the backward once,
    no other kernel; peak device memory; (c), (d) one step of each of
    ``TRAIN_CUTS`` (full width, cut in depth; the model's optimizer,
    donated buffers): finite, the launches as (b) counts them, grok's
    auxiliary loss positive; (e) float32 steps of ``TRAIN_F32`` (smoke
    width) on the card against the CPU (``train_checks``' float32 rule)."""
    import dataclasses
    import gc

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve
    from repro_torch.models import model_zoo, recurrentgemma, transformer
    from repro_torch.optim.optimizers import OptConfig
    from repro_torch.runtime.train_loop import make_train_step
    from repro_torch.testing import train_checks as TC

    out = {"check": check_flash_bwd_cases(dev)}

    def fresh():
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        serve.reset_launch_counts()
        return torch.cuda.memory_allocated()

    # (b) the dense transformer at full width through the train CLI
    cfg = get_config(TRAIN_LM)
    held = fresh()
    t0 = time.perf_counter()
    res = _train_cli("--arch", TRAIN_LM, "--steps", str(TRAIN_LM_STEPS),
                     "--batch", str(TRAIN_LM_B), "--seq", str(TRAIN_LM_S))
    wall = time.perf_counter() - t0
    counts = serve.launch_counts()
    expect = {name: 0 for name in serve.KERNELS}
    expect.update(_expected_flash(cfg, cfg.n_layers, TRAIN_LM_STEPS))
    path_launches(f"train {TRAIN_LM}", counts, expect)
    _finite_run(TRAIN_LM, res.losses, res.grad_norms)
    peak = torch.cuda.max_memory_allocated()
    n_params = transformer.param_count(cfg)
    steady = sorted(res.step_s[1:])
    log(f"[train] {TRAIN_LM} full width ({n_params / 1e9:.3f} B parameters, "
        f"remat {cfg.remat!r}, {cfg.optimizer}) B {TRAIN_LM_B} x S "
        f"{TRAIN_LM_S}, {TRAIN_LM_STEPS} steps through launch/train.py: "
        f"losses {res.losses}, grad norms {res.grad_norms}; step seconds "
        f"{res.step_s} (host clock); a step launches kernel 5 "
        f"{counts['flash_attention'] // TRAIN_LM_STEPS} times and the "
        f"backward {counts['flash_attention_bwd'] // TRAIN_LM_STEPS}; peak "
        f"device memory {peak / 2**30:.2f} GiB ({peak / 1e9:.2f} GB; "
        f"{held / 2**30:.2f} GiB held before the run); {wall:.1f}s")
    out[TRAIN_LM] = {"batch": TRAIN_LM_B, "seq": TRAIN_LM_S,
                     "n_params": n_params, "losses": res.losses,
                     "grad_norms": res.grad_norms, "step_s": res.step_s,
                     "median_step_s": steady[len(steady) // 2],
                     "launches": counts,
                     "launches_per_step": {
                         k: v // TRAIN_LM_STEPS for k, v in counts.items()},
                     "peak_mem_bytes": peak, "held_before_bytes": held,
                     "seconds": wall}
    out[TRAIN_LM]["profile"] = profile_train_step(res, TRAIN_LM_STEPS)
    del res

    # (c), (d) the hybrid and the MoE model, cut in depth
    for name, cut, B_, S in TRAIN_CUTS:
        cfg = dataclasses.replace(get_config(name), **cut)
        held = fresh()
        t0 = time.perf_counter()
        bundle, params = serve.build_bundle(cfg, dev)
        n_params = sum(t.numel() for t in tu.leaves(params))
        art = make_train_step(bundle, dev, OptConfig(
            name=cfg.optimizer, lr=TRAIN_LR, warmup_steps=1, total_steps=10),
            donate=True)
        opt = art.init_opt(params)
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                       global_batch=B_)).batch_at(0)
        aux = None
        if cfg.n_experts:
            with torch.no_grad():
                aux = float(transformer._forward(
                    params, cfg, torch.as_tensor(batch["tokens"], device=dev),
                    None, True)[1])
            if not aux > 0:
                raise AssertionError(f"{name}: auxiliary loss {aux}")
        serve.reset_launch_counts()
        params, opt, m = art.step_fn(params, opt, batch)
        torch.cuda.synchronize()
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        counts = serve.launch_counts()
        n_attn = (recurrentgemma._layer_counts(cfg)[1]
                  if cfg.family == "hybrid" else cfg.n_layers)
        expect = {k: 0 for k in serve.KERNELS}
        expect.update(_expected_flash(cfg, n_attn))
        path_launches(f"train {name} cut", counts, expect)
        _finite_run(name, [loss], [gnorm])
        peak = torch.cuda.max_memory_allocated()
        wall = time.perf_counter() - t0
        log(f"[train] {name} cut to {cut} at full width ({n_params / 1e9:.3f}"
            f" B parameters, {cfg.optimizer}, window {cfg.attn_window}) B "
            f"{B_} x S {S}, one step: loss {loss!r}, grad norm {gnorm!r}"
            + ("" if aux is None else f", auxiliary loss {aux!r}")
            + f"; launches {counts}; peak device memory {peak / 2**30:.2f} "
            f"GiB ({peak / 1e9:.2f} GB; {held / 2**30:.2f} GiB held before); "
            f"{wall:.1f}s (init included)")
        out[name] = {"cut": cut, "batch": B_, "seq": S, "n_params": n_params,
                     "optimizer": cfg.optimizer, "loss": loss,
                     "grad_norm": gnorm, "aux": aux, "launches": counts,
                     "peak_mem_bytes": peak, "held_before_bytes": held,
                     "seconds": wall}
        del bundle, params, opt, art, m

    # (e) float32 steps past S 1024, card against CPU
    fresh()
    for name, B_, S in TRAIN_F32:
        cfg = get_config(name, smoke=True)
        params = tu.tree_map(lambda t: t.float(), model_zoo.build(cfg).init(
            torch.Generator(device=dev).manual_seed(4), dev))
        batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=S,
                                       global_batch=B_)).batch_at(0)
        serve.reset_launch_counts()
        t0 = time.perf_counter()
        cmp = TC.step_card_against_cpu(cfg, params, batch,
                                       OptConfig(lr=TRAIN_LR))
        counts = serve.launch_counts()
        expect = {k: 0 for k in serve.KERNELS}
        expect.update(_expected_flash(cfg, cfg.n_layers))
        path_launches(f"train {name} smoke float32", counts, expect)
        log(f"[train] {name} smoke, float32, B {B_} x S {S}: one step on the "
            f"card against the CPU: loss {cmp['card']['loss']!r} / "
            f"{cmp['cpu']['loss']!r} (relative {cmp['loss_rel']:.3g}), grad "
            f"norm {cmp['card']['grad_norm']!r} / {cmp['cpu']['grad_norm']!r}"
            f" (relative {cmp['grad_norm_rel']:.3g}; limit {TC.F32_RTOL}) "
            f"({time.perf_counter() - t0:.1f}s)")
        out[f"{name} float32 card vs CPU"] = cmp
        del params
    fresh()
    return out


def engine_workload(cfg):
    """``ENGINE``'s requests for ``cfg``'s vocabulary."""
    from repro_torch.launch import engine as E

    return E.synthetic_trace(
        ENGINE["n_requests"], cfg.vocab_size, seed=ENGINE["seed"],
        prompt_lens=ENGINE["prompt_lens"], gen_lens=ENGINE["gen_lens"],
        arrival_span=ENGINE["arrival_span"])


def engine_run(model, requests, policy, oversubscribe, speculate):
    """One continuous-batching engine run over ``requests``: ``(results,
    stats)``."""
    import torch
    from repro_torch.launch import engine as E

    params, qlayers, cfg = model
    eng = E.ContinuousBatchingEngine(
        params, qlayers, cfg, n_slots=ENGINE["slots"], chunk=ENGINE["chunk"],
        speculate=speculate, policy=policy, oversubscribe=oversubscribe)
    eng.submit_all(requests)
    torch.cuda.synchronize()
    return eng.run()


def engine_full_width(model, policy, oversubscribe, speculate):
    """The continuous-batching engine over ``ENGINE``'s workload on a
    full-width model; every stream held against ``decode_single``."""
    from repro_torch.launch import engine as E
    from repro_torch.launch import serve
    from repro_torch.models import lstm_lm

    params, qlayers, cfg = model
    requests = engine_workload(cfg)

    def run():
        return engine_run(model, requests, policy, oversubscribe, speculate)

    serve.reset_launch_counts()
    results, stats = run()
    counts = serve.launch_counts()
    by_shape = gemm_shape_counts()
    what = f"engine {cfg.name} {policy}"
    expect = {"int8_matmul": None, SCAN_OF[lstm_lm.rnn_cell(cfg)]: None}
    path_launches(what, counts, expect)
    if counts["int8_matmul"] != counts[SCAN_OF[lstm_lm.rnn_cell(cfg)]]:
        raise AssertionError(f"{what}: one GEMM per sequence-kernel launch "
                             f"expected, got {counts}")
    serve.print_engine_stats(stats, len(results), len(requests))
    if len(results) != len(requests) or any(
            r.truncated for r in results.values()):
        raise AssertionError(f"{what}: not every request was served")
    if policy != "fifo" and stats.preemptions < 1:
        raise AssertionError(f"{what}: no stream was preempted")
    t0 = time.perf_counter()
    for r in requests:
        single = E.decode_single(params, qlayers, cfg, r.prompt,
                                 r.max_new_tokens)
        if results[r.rid].tokens != single:
            raise AssertionError(f"{what}: stream {r.rid} "
                                 f"{results[r.rid].tokens} != decode_single "
                                 f"{single}")
    log(f"[{what}] all {len(requests)} streams equal decode_single on the "
        f"card ({time.perf_counter() - t0:.1f}s); {stats.steps} steps, "
        f"{stats.preemptions} preemptions, {stats.resumes} resumes, accept "
        f"rate {stats.accept_rate:.2f}")
    # the spread of the host-clock metrics: the same workload, repeated
    reps = []
    for _ in range(ENGINE_REPEATS):
        res_r, st_r = run()
        if any(res_r[r.rid].tokens != results[r.rid].tokens
               for r in requests):
            raise AssertionError(f"{what}: a repeated run generated other "
                                 "tokens")
        reps.append(st_r)
    spread = {
        "tokens_per_s": sorted(r.tokens_per_s for r in reps),
        "mean_ttft_s": sorted(r.mean_ttft_s for r in reps),
        "step_ms": sorted(r.wall_s / r.steps * 1e3 for r in reps)}
    for name, vals in spread.items():
        log(f"[{what}] {name} over {ENGINE_REPEATS} repeats: min "
            f"{vals[0]:.4g} median {vals[ENGINE_REPEATS // 2]:.4g} max "
            f"{vals[-1]:.4g}")
    busy_ms, prof_wall_s = device_busy_ms(lambda: run()[1].wall_s)
    share = (busy_ms / 1e3 / prof_wall_s) if busy_ms else None
    log(f"[{what}] profiled run: device busy {busy_ms} ms of "
        f"{prof_wall_s * 1e3:.1f} ms wall (busy share {share})")
    return {"arch": cfg.name, "policy": policy, "oversubscribe": oversubscribe,
            "speculate": speculate, "chunk": ENGINE["chunk"],
            "arrival_span": ENGINE["arrival_span"], "launches": counts,
            "gemm_launches_by_shape": by_shape,
            "steps": stats.steps, "wall_s": stats.wall_s,
            "tokens_per_s": stats.tokens_per_s,
            "generated_tokens": stats.generated_tokens,
            "prompt_tokens": stats.prompt_tokens,
            "mean_ttft_steps": stats.mean_ttft_steps,
            "mean_ttft_s": stats.mean_ttft_s, "occupancy": stats.occupancy,
            "preemptions": stats.preemptions, "resumes": stats.resumes,
            "accept_rate": stats.accept_rate,
            "pool_state_bytes": stats.pool_state_bytes, "repeats": spread,
            "profiled": {"device_busy_ms": busy_ms, "wall_s": prof_wall_s,
                         "busy_share": share}}


def fleet_requests(cfg):
    """``FLEET_ACCEPT``'s requests for ``cfg``'s vocabulary."""
    import numpy as np
    from repro_torch.launch import engine as E

    rng = np.random.default_rng(7)
    return [E.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                                 size=(p,)),
                      max_new_tokens=g, arrival=float(a))
            for i, ((p, g), a) in enumerate(zip(FLEET_ACCEPT["lens"],
                                                FLEET_ACCEPT["arrivals"]))]


def fleet_router(model, requests, faults, **router_kw):
    """A warmed router of 2 shards on ``model`` with ``requests`` submitted
    and a fresh ``FaultInjector(**faults)``."""
    from repro_torch.launch import fleet as F
    from repro_torch.launch import serve
    from repro_torch.runtime.fault import StepWatchdog

    params, qlayers, cfg = model
    if router_kw.get("on_hang") == "kill":
        # shard 1 is the survivor: its watchdog rules no step hung, so a
        # slow host step there cannot take the whole fleet down
        wds = iter([StepWatchdog(), StepWatchdog(timeout_factor=math.inf)])
        router_kw["watchdog_factory"] = lambda: next(wds)
    router = F.FleetRouter(params, qlayers, cfg, n_shards=2,
                           injector=F.FaultInjector(**faults), **router_kw)
    router.warmup()
    router.submit_all(requests)
    serve._sync(params["embedding"].device)
    return router


def fleet_run(what, model, requests, expect, faults, profile=False,
              **router_kw):
    """One fleet run of 2 shards on ``model``: warmup, then the run with
    every launch counter set to 0 just before it; every stream held
    against ``decode_single``; the fault plane's counts against
    ``expect`` (an int is an exact count, ``(n,)`` a least one).  With
    ``profile`` a second run of the same fleet goes under the profiler
    for the device's busy share."""
    from repro_torch.launch import engine as E
    from repro_torch.launch import serve
    from repro_torch.models import lstm_lm

    params, qlayers, cfg = model
    dev = params["embedding"].device
    t0 = time.perf_counter()
    router = fleet_router(model, requests, faults, **router_kw)
    serve.reset_launch_counts()
    results, stats = router.run()
    serve._sync(dev)
    counts = serve.launch_counts()
    by_shape = gemm_shape_counts()
    scan = SCAN_OF[lstm_lm.rnn_cell(cfg)]
    want = {name: 0 for name in serve.KERNELS}
    want.update({"int8_matmul": None, scan: None})
    path_launches(what, counts, want)
    if counts["int8_matmul"] != counts[scan]:
        raise AssertionError(f"{what}: one GEMM per sequence-kernel launch "
                             f"expected, got {counts}")
    serve.print_fleet_stats(stats, router.slots_per_shard)
    if stats.completed != len(requests) or stats.lost or stats.rejected:
        raise AssertionError(f"{what}: not every request was served")
    for key, n in expect.items():
        got = getattr(stats, key)
        if (got < n[0]) if isinstance(n, tuple) else (got != n):
            raise AssertionError(f"{what}: {key} = {got}, expected {n}")
    t1 = time.perf_counter()
    for r in requests:
        single = E.decode_single(params, qlayers, cfg, r.prompt,
                                 r.max_new_tokens)
        if results[r.rid].tokens != single:
            raise AssertionError(f"{what}: stream {r.rid} "
                                 f"{results[r.rid].tokens} != decode_single "
                                 f"{single}")
    log(f"[{what}] all {len(requests)} streams equal decode_single on the "
        f"card ({time.perf_counter() - t1:.1f}s); goodput "
        f"{stats.goodput_tokens_per_step:.3f} tokens/fleet step, "
        f"{stats.tokens_per_s:.1f} tokens/s (host clock), "
        f"{stats.wall_s / max(stats.fleet_steps, 1) * 1e3:.2f} ms a fleet "
        f"step; {time.perf_counter() - t0:.1f}s")
    fault = ("kills", "restarts", "hang_events", "migrated_streams",
             "replayed_streams", "rerouted_pending", "admit_retries")
    busy = None
    if profile:
        again = fleet_router(model, requests, faults, **router_kw)
        busy_ms, wall_s = device_busy_ms(lambda: again.run()[1].wall_s)
        busy = {"device_busy_ms": busy_ms, "wall_s": wall_s,
                "busy_share": busy_ms / 1e3 / wall_s if busy_ms else None}
        log(f"[{what}] profiled run: device busy {busy_ms} ms of "
            f"{wall_s * 1e3:.1f} ms wall (busy share {busy['busy_share']})")
    return {"what": what, "arch": cfg.name,
            "slots": router.slots_per_shard, "requests": len(requests),
            "served": stats.completed, "fleet_steps": stats.fleet_steps,
            "generated_tokens": stats.generated_tokens,
            "goodput_tokens_per_step": stats.goodput_tokens_per_step,
            "tokens_per_s": stats.tokens_per_s, "wall_s": stats.wall_s,
            **{k: getattr(stats, k) for k in fault},
            "shards": [{"alive": sh.alive, "steps": sh.steps,
                        "generated_tokens": sh.generated_tokens,
                        "adopted": sh.adopted, "hung": sh.hung}
                       for sh in stats.shards],
            "launches": counts, "gemm_launches_by_shape": by_shape,
            "profiled": busy, "seconds": time.perf_counter() - t0}


def fleet_full_width(models):
    """[fleet]: the fleet router over 2 co-located shards on the full-width
    models, through a hard kill, a kill with a restart and a hang."""
    from repro_torch.launch import engine as E

    lstm, gru = models["lstm-rnnt"], models["gru-rnnt"]
    trace = {k: FLEET_TRACE[k] for k in ("seed", "prompt_lens", "gen_lens",
                                         "arrival_span")}
    kw = dict(slots_per_shard=FLEET_TRACE["slots"],
              chunk=FLEET_TRACE["chunk"])
    runs = [
        fleet_run("fleet accept lstm-rnnt", lstm, fleet_requests(lstm[2]),
                  dict(kills=1, restarts=0, migrated_streams=(1,),
                       replayed_streams=(1,)),
                  dict(kills=[dict(shard=0,
                                   at_step=FLEET_ACCEPT["kill_step"])]),
                  slots_per_shard=FLEET_ACCEPT["slots"], policy="srf",
                  oversubscribe=2.0),
        fleet_run("fleet kill+restart lstm-rnnt", lstm, E.synthetic_trace(
                      FLEET_TRACE["n_requests"], lstm[2].vocab_size,
                      **trace),
                  dict(kills=1, restarts=1), dict(kills=[FLEET_KILL]),
                  profile=True, policy="srf", oversubscribe=2.0, **kw),
        fleet_run("fleet hang gru-rnnt", gru, engine_workload(gru[2]),
                  dict(kills=1, restarts=0, hang_events=(1,),
                       replayed_streams=0, migrated_streams=(1,)),
                  dict(hangs=[FLEET_HANG]), on_hang="kill", **kw),
    ]
    if runs[2]["shards"][0]["alive"] or runs[2]["shards"][0]["hung"] < 1:
        raise AssertionError("fleet hang: shard 0 was not ruled hung and "
                             "drained")
    return runs


def device_busy_ms(run, kernels=None):
    """``(device ms, wall s)`` of one run under ``torch.profiler``: the sum
    of the kernels' device time (launches do not overlap on one stream),
    beside the wall seconds ``run`` returns (its own host clock).  Device
    ms is None where the profiler records no device time.  ``kernels``, a
    dict, receives each device activity's count by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_s = run()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    if kernels is not None:
        kernels.update({e.key: e.count for e in events})
    busy_us = sum(e.self_device_time_total for e in events)
    return (busy_us / 1e3 if busy_us > 0 else None), wall_s


def scan_bytes_ops(acc, spec):
    """Bytes a sequence-kernel call must move (each input read once, each
    output written once) and its int8 operations, from its shapes."""
    Bx, Tx, GH = acc.shape
    H, d = spec.cfg_d_hidden, spec.d_out
    per_gate = 4 * H * 6 if spec.cell == "lstm" else 3 * H * 6  # P, L, Lb
    state = Bx * d + (Bx * H * 2 if spec.cell == "lstm" else 0)
    proj = H * d + d * 4 if getattr(spec, "use_projection", False) else 0
    n_bytes = (Bx * Tx * GH * 4 + d * GH + GH * 4 + per_gate + proj
               + 2 * state + Bx * Tx * d)
    ops = 2 * Bx * Tx * (d * GH + (H * d if proj else 0))
    return n_bytes, ops


def time_scan(dev, layer, name, flush):
    """Device ms of a sequence kernel at B4 T32 and B4 T1, beside its plain
    version and its bound."""
    import torch
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import quant_lstm_scan as K2
    from repro_torch.models import quant_lstm as QL

    arrays, spec, xs_q = layer
    rows = []
    for Tx in (T, 1):
        xq = xs_q[:, :Tx].contiguous()
        acc = K1.int8_matmul_plain(xq.reshape(B * Tx, -1), arrays["W_cat"],
                                   arrays["fold_x_cat"]).reshape(B, Tx, -1)
        st = QL.initial_recurrent_state(spec, B, dev)
        row = {"B": B, "T": Tx, "H": spec.cfg_d_hidden, "d_out": spec.d_out}
        row["ms"], row["host_ms"] = cold_ms(
            lambda: K2.quant_recurrent_seq_scan(arrays, spec, acc, st), 10,
            flush)
        row["plain_ms"], _ = cold_ms(
            lambda: K2.quant_recurrent_seq_scan_plain(arrays, spec, acc, st),
            2, flush)
        row["library_ms"] = None
        row["bound_ms"], row["bound_by"] = bound(*scan_bytes_ops(acc, spec))
        rows.append(row)
        log(f"[time] {name} B={B} T={Tx}: {row['ms']:.4f} ms (host enqueue "
            f"{row['host_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    torch.cuda.synchronize()
    return rows


def time_gemm(dev, flush):
    """Device ms of kernel 1 at ``_gemm_timed()`` beside its host enqueue, its
    plain version, its bound and ``torch._int_mm`` (``library_ms``, where
    it runs: M > 16); at M <= 16 also ``_int_mm`` on x zero-padded to 32
    rows (``int_mm_pad32_ms``), the nearest library call, which is not the
    same function (the padding is made outside the timed call)."""
    import torch
    from repro_torch.kernels import int8_matmul as K1

    gen = torch.Generator(device=dev).manual_seed(5)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = getattr(K1, "gemm_plan", None)  # None in an earlier revision
    # this method's floor: one launch that does no work to speak of (a
    # one-element PyTorch add), timed the same way
    tiny = torch.zeros(1, device=dev)
    floor_ms, _ = cold_ms(lambda: tiny.add_(1), 50, flush)
    log(f"[time] launch floor of cold_ms (a one-element add): "
        f"{floor_ms:.4f} ms")
    rows = []
    for M, Kd, N, odt in _gemm_timed():
        x, w, fold, m0, shift = gemm_operands(M, Kd, N, gen, dev)
        kw = dict(out_dtype=odt, zp_out=3)
        p = plan(M, N, Kd, n_sm) if plan else None
        row = {"M": M, "K": Kd, "N": N, "out": str(odt).split(".")[-1],
               "plan": p._asdict() if p else None,
               "ctas": p.split * p.tiles_m * p.tiles_n if p else None,
               "launch_floor_ms": floor_ms}
        row["ms"], row["host_ms"] = cold_ms(
            lambda: K1.int8_matmul(x, w, fold, m0, shift, **kw), 50, flush)
        row["plain_ms"], _ = cold_ms(
            lambda: K1.int8_matmul_plain(x, w, fold, m0, shift, **kw), 10,
            flush)
        row["library_ms"] = row["int_mm_pad32_ms"] = None
        if M > 16:
            row["library_ms"], _ = cold_ms(lambda: torch._int_mm(x, w), 50,
                                           flush)
        else:  # torch._int_mm refuses M <= 16
            xp = torch.zeros((32, Kd), dtype=torch.int8, device=dev)
            xp[:M] = x
            row["int_mm_pad32_ms"], _ = cold_ms(
                lambda: torch._int_mm(xp, w), 50, flush)
        out_bytes = M * N * torch.empty((), dtype=odt).element_size()
        epi_bytes = 4 * N + (8 * N if odt != torch.int32 else 0)
        row["bound_ms"], row["bound_by"] = bound(
            M * Kd + Kd * N + epi_bytes + out_bytes, 2 * M * N * Kd)
        rows.append(row)
        lib = (f"_int_mm {row['library_ms']:.4f}" if row["library_ms"]
               else f"_int_mm on 32 padded rows {row['int_mm_pad32_ms']:.4f}")
        log(f"[time] int8_matmul {M}x{Kd}x{N} {row['out']}: {row['ms']:.4f} "
            f"ms (host enqueue {row['host_ms']:.4f} ms), plain "
            f"{row['plain_ms']:.4f} ms, {lib} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']})" + (
                f"; plan form {p.form} {p.bm}x{p.bn} split {p.split}, "
                f"{row['ctas']} CTAs, {p.stages} stages, {p.smem} B shared"
                if p else ""))
    torch.cuda.synchronize()
    return rows


def time_kernels(dev, lstm_layer, gru_layer):
    import torch

    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    gemm = time_gemm(dev, flush)
    return (gemm, time_scan(dev, lstm_layer, "quant_lstm_scan", flush),
            time_scan(dev, gru_layer, "quant_gru_scan", flush),
            time_cell_kernels(dev, flush))


def launch_floor_ms(dev, flush):
    """``cold_ms`` of one launch that does no work to speak of (a
    one-element PyTorch add): the timing method's floor."""
    import torch

    tiny = torch.zeros(1, device=dev)
    return cold_ms(lambda: tiny.add_(1), 50, flush)[0]


def step_bytes(spec, B, kind):
    """Bytes the gate pass (``kind`` "gates") or the cell's step entry
    ("cell") of one LSTM step must move: each input read once (the blocks
    of the accumulators and of the gate pass's output that it reads, the
    cell state where read, the per-gate vectors), each output written
    once."""
    from repro_torch.kernels import int_layernorm as KL

    H, gates = spec.cfg_d_hidden, spec.variant.gates
    given = KL.pass_gates(spec)
    bh = B * H
    if kind == "gates":
        n = 2 * len(gates) * bh * 4 + len(gates) * bh * 2  # acc in, out
        peep = [g for g in given if KL.gate_scale(spec, g)[-1]]
        return n + len(given) * 6 * H + len(peep) * 2 * H + (
            2 * bh if peep else 0)
    n = 2 * bh + 3 * bh  # c in, c and m out
    for g in gates:
        if g in given:
            n += 2 * bh
        else:
            n += 8 * bh + (2 * H if KL.gate_scale(spec, g)[-1] else 0)
    if spec.use_peephole:
        n += 2 * H + (6 * H if spec.use_layernorm else 0)
    return n


def time_cell_kernels(dev, flush):
    """Device ms of kernels 2 and 3 at the stepwise pass's B4 H2048, each
    beside its host enqueue, plain version, bound (bytes: there are no
    int8 products) and the method's launch floor: the TPU-contract entries
    (the cell in the lstm-rnnt form and the peephole + in-fusion LN form,
    the LayerNorm of one gate's rows) and, where this revision has them,
    the step entries: the gate pass of an lstm-rnnt step (B4 G4 n2048,
    ``launch`` rows) and the cell's step entry in the lstm-rnnt form and
    the peephole + LN form.  Returns ``(cell rows, LayerNorm rows)``; the
    first row of each is the main path's."""
    import torch
    from repro_torch.core import fixedpoint as fp
    from repro_torch.kernels import int_layernorm as KL
    from repro_torch.kernels import quant_lstm_cell as KC
    from repro_torch.models import lstm as L

    H = 2048
    floor = launch_floor_ms(dev, flush)
    log(f"[time] launch floor of cold_ms (a one-element add): {floor:.4f} ms")
    gen = torch.Generator(device=dev).manual_seed(6)

    def ints(shape, lo, hi, dtype=torch.int16):
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=dtype)

    def row(fields, fn, plain, bytes_moved):
        r = dict(fields, launch_floor_ms=floor, library_ms=None)
        r["ms"], r["host_ms"] = cold_ms(fn, 50, flush)
        r["plain_ms"] = cold_ms(plain, 5, flush)[0]
        r["bound_ms"], r["bound_by"] = bound(bytes_moved, 0)
        log(f"[time] {fields}: {r['ms']:.4f} ms (host enqueue "
            f"{r['host_ms']:.4f} ms), plain {r['plain_ms']:.4f} ms, bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}), "
            f"floor {floor:.4f} ms")
        return r

    step = hasattr(KL, "int_layernorm_gates")
    cell_rows, ln_rows = [], []
    if step:
        from repro_torch.testing import kernel_cases as KCASES

        layers = {
            "lstm-rnnt form": KCASES.step_layer(L.LSTMVariant(
                use_layernorm=True, use_projection=True), B, H, dev, 61)[2],
            "peephole + in-fusion LN": KCASES.step_layer(L.LSTMVariant(
                use_layernorm=True, use_projection=True, use_peephole=True),
                B, H, dev, 62)[2]}
        kw = layers["lstm-rnnt form"]
        gkw = {k: kw[k] for k in ("arrays", "spec", "acc_x", "acc_h", "c_q")}
        ln_rows.append(row(
            {"entry": "int_layernorm_gates", "B": B, "G": 4, "n": H},
            lambda: KL.int_layernorm_gates(**gkw),
            lambda: KL.int_layernorm_gates_plain(**gkw),
            step_bytes(kw["spec"], B, "gates")))
        for form, kw in layers.items():
            cell_rows.append(row(
                {"entry": "quant_lstm_cell_step", "B": B, "H": H,
                 "form": form},
                lambda kw=kw: KC.quant_lstm_cell_step(**kw),
                lambda kw=kw: KC.quant_lstm_cell_step_plain(**kw),
                step_bytes(kw["spec"], B, "cell")))
    # the TPU-contract entries (the only ones of an earlier revision)
    i16, f16, z16, o16, c = (ints((B, H), -32768, 32768) for _ in range(5))
    o32 = ints((B, H), -(2**20), 2**20, torch.int32)
    p_o, lw = ints((H,), -32767, 32768), ints((H,), 100, 32767)
    lb = ints((H,), -100000, 100000, torch.int32)
    ln_out = fp.quantize_multiplier(2**-10 * 3e-5 / 2**-12)
    base = dict(cell_int_bits=2, cifg=False,
                eff_m=fp.quantize_multiplier(2.0**-30 / 0.005), zp_m=-4)
    forms = (("lstm-rnnt form", dict(o_in=o16, **base), 5 * 2),
             ("peephole + in-fusion LN", dict(
                 o_in=o32, p_o=p_o, eff_c_o=fp.quantize_multiplier(0.37),
                 lw_o=lw, lb_o=lb, ln_out_o=ln_out, **base), 4 * 2 + 4))
    for name, kw, in_bytes in forms:
        vec_bytes = 8 * H if "p_o" in kw else 0  # p_o, L (int16), b (int32)
        cell_rows.append(row(
            {"entry": "quant_lstm_cell", "B": B, "H": H, "form": name},
            lambda kw=kw: KC.quant_lstm_cell(i16, f16, z16, c_q=c, **kw),
            lambda kw=kw: KC.quant_lstm_cell_plain(i16, f16, z16, c_q=c,
                                                   **kw),
            B * H * (in_bytes + 3) + vec_bytes))
    q = ints((B, H), -32768, 32768)
    ln_rows.append(row(
        {"entry": "int_layernorm", "B": B, "n": H},
        lambda: KL.int_layernorm(q, lw, lb, out_m0=ln_out[0],
                                 out_shift=ln_out[1]),
        lambda: KL.int_layernorm_plain(q, lw, lb, out_m0=ln_out[0],
                                       out_shift=ln_out[1]),
        B * H * 4 + H * 6))
    torch.cuda.synchronize()
    return cell_rows, ln_rows


def check_flash(dev):
    """Kernel 5 against its plain version at the kernel's own tiles: every
    shape x dtype x scaling x mask of ``attention_checks.flash_cases``, the
    head_dim-256 and head_dim-112 shapes with their masks too (both forms: float32 and
    unaligned rows take the FMA form) (float32: |d| <= 2e-5 + 2e-5 |ref|;
    bf16: 2 ulps of the row's largest |ref|).  Returns the largest
    |difference|."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.testing import attention_checks as AC

    gen = torch.Generator(device=dev).manual_seed(21)
    err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    n = 0
    cases = [AC.flash_cases(gen),
             AC.flash_cases(gen, AC.FLASH_SHAPES_D256, AC.FLASH_MASKS_D256),
             AC.flash_cases(gen, AC.FLASH_SHAPES_D112, AC.FLASH_MASKS_D256)]
    for label, kw in (case for group in cases for case in group):
        got = FA.flash_attention(**kw)
        want = FA.flash_attention_plain(**kw, **FA.kernel_tiles(
            kw["q"], kw["k"], kw["v"]))
        dt = kw["q"].dtype
        err[dt] = max(err[dt], AC.check_close(f"flash_attention {label}",
                                              got, want))
        n += 1
    torch.cuda.synchronize()
    log(f"[check] flash_attention: {n} cases ({len(AC.FLASH_SHAPES)} shapes "
        "x float32/bf16 x own scale/pre-scaled q x causal/non-causal/"
        f"window 64, and {len(AC.FLASH_SHAPES_D256)} head_dim-256 and "
        f"{len(AC.FLASH_SHAPES_D112)} head_dim-112 shapes with a window of "
        "300 besides) within tolerance of the plain "
        f"version; max |d| float32 {err[torch.float32]:.3g}, bf16 "
        f"{err[torch.bfloat16]:.3g}")
    return max(err.values())


def kernel_device_ms(run, names, host_ops=True):
    """``(kernel ms, all device ms)`` of one run under ``torch.profiler``:
    the device time of the kernels whose name holds one of ``names``,
    beside the device time of every kernel.  ``(None, None)`` where the
    profiler records no device time.  ``host_ops=False`` traces the device
    alone: a run of ~10**5 eager ops takes minutes to trace on the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.append(ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        run()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e3
    mine = sum(e.self_device_time_total for e in events
               if any(n in e.key for n in names)) / 1e3
    return (mine, total) if total > 0 else (None, None)


def prefill_full_width(dev, repeats=3):
    """The full-width transformer's prefill through ``make_serve_fns`` at
    B x S = 2 x 4096: kernel 5 launches once per layer and no other kernel
    launches; each layer's attention output equals the plain version on
    that layer's inputs (2 bf16 ulps of the row's largest |value|), the
    last-token logits equal a run with the plain version in every layer
    (1 % of the row's largest |logit|, or 1.5 x the plain version's own
    spread between two tilings where that is wider; argmax where the
    margin exceeds 2 %); prompt tokens/s and kernel 5's share of the
    device time."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.runtime import train_loop
    from repro_torch.testing import attention_checks as AC

    cfg = get_config(TRANSFORMER)
    t0 = time.perf_counter()
    bundle, params = serve.build_bundle(cfg, dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in params["layers"].values()) + sum(
        t.numel() for k, t in params.items() if k != "layers")
    log(f"[prefill] {cfg.name}: seeded init of {n_params / 1e9:.3f} B bf16 "
        f"parameters on the card in {time.perf_counter() - t0:.2f}s")
    prefill_fn, _ = train_loop.make_serve_fns(bundle, dev, PREFILL_B,
                                              PREFILL_S)
    batch = {"tokens": serve.random_prompt(cfg, PREFILL_B, PREFILL_S, dev)}
    real = FA.flash_attention
    layer_err = []

    def checked(q, k, v, **kw):  # the kernel, then its plain version
        out = real(q, k, v, **kw)
        layer_err.append(AC.check_close(
            f"prefill layer {len(layer_err)} attention", out,
            FA.flash_attention_plain(q, k, v, **dict(
                kw, **FA.kernel_tiles(q, k, v)))))
        return out

    def plain(q, k, v, **kw):
        return FA.flash_attention_plain(q, k, v, **kw)

    def plain_256(q, k, v, **kw):  # the same function at 256-row tiles
        return FA.flash_attention_plain(q, k, v, **dict(
            kw, block_q=256, block_k=256))

    serve.reset_launch_counts()
    FA.flash_attention = checked
    try:
        logits = prefill_fn(params, batch)
    finally:
        FA.flash_attention = real
    counts = serve.launch_counts()
    expect = {name: 0 for name in serve.KERNELS}
    expect["flash_attention"] = cfg.n_layers
    path_launches(f"prefill {cfg.name}", counts, expect)
    if tuple(logits.shape) != (PREFILL_B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"prefill logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    refs = []
    for fn in (plain, plain_256):
        FA.flash_attention = fn
        try:
            refs.append(prefill_fn(params, batch))
        finally:
            FA.flash_attention = real
    if serve.launch_counts() != counts:
        raise AssertionError("the plain-version prefill launched a kernel")
    # the plain version at two tilings differs by bf16 roundings that flip
    # with the float32 summation order, compounded over 36 layers: the
    # whole-pass rule is 1 % or 1.5 x that spread, whichever is larger
    spread = AC.logit_spread(refs[1], refs[0])
    limit = max(0.01, 1.5 * spread)
    logit_err = AC.check_logits("prefill last-token logits", logits,
                                refs[0], limit=limit)
    log(f"[prefill] {cfg.name}: every layer's attention output within 2 "
        f"bf16 ulps of its plain version (largest |d| {max(layer_err):.3g});"
        f" last-token logits within {logit_err:.4f} of the row's largest "
        f"|logit| of the plain-version run (the plain version at 512- and "
        f"256-row tiles differs by {spread:.4f}; limit {limit:.4f}), argmax "
        "equal where the margin exceeds 2 %")
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = prefill_fn(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not torch.equal(again, logits):
            raise AssertionError("a repeated prefill gave other logits")
    tok_s = sorted(PREFILL_B * PREFILL_S / t for t in secs)
    flash_ms, device_ms = kernel_device_ms(  # both forms of kernel 5
        lambda: prefill_fn(params, batch), ("flash_kernel",
                                            "flash_wgmma_kernel"))
    share = flash_ms / device_ms if device_ms else None
    log(f"[prefill] {cfg.name} B={PREFILL_B} S={PREFILL_S}: prompt tokens/s "
        f"median {tok_s[repeats // 2]:.1f} (min {tok_s[0]:.1f}, max "
        f"{tok_s[-1]:.1f}; host clock over {repeats} prefills); profiled: "
        f"kernel 5 {flash_ms} ms of {device_ms} ms device time (share "
        f"{share})")
    out = {"arch": cfg.name, "batch": PREFILL_B, "seq": PREFILL_S,
           "launches": counts, "layer_max_abs_err": layer_err,
           "logit_err_of_row_max": logit_err,
           "plain_tilings_spread_of_row_max": spread, "logit_limit": limit,
           "prompt_tok_s": tok_s,
           "prefill_s": sorted(secs),
           "profiled": {"flash_ms": flash_ms, "device_ms": device_ms,
                        "flash_share": share}}
    return out, (bundle, params)


def serve_transformer_full_width(dev, model):
    """The static serve of a full-width bundle (``qwen3-4b``, and the
    ``[families]``' models; B 4, prompt 32, 16 greedy tokens, cache 256),
    bf16 and with ``--quant int8`` (int8 weights, and the transformer's
    KV cache): no kernel launches (decode never reaches flash attention);
    tokens in the vocabulary, logits finite."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import quant_transformer as QT

    bundle, params = model
    cfg = bundle.cfg
    prompt = serve.random_prompt(cfg, SERVE_B, SERVE_PROMPT, dev)
    out = []
    for quant in ("none", "int8"):
        if quant == "int8":
            t0 = time.perf_counter()
            bundle, params = QT.quantize_bundle(bundle), \
                QT.quantize_param_tree(params)
            torch.cuda.synchronize()
            log(f"[serve] {cfg.name}: int8 weights in "
                f"{time.perf_counter() - t0:.2f}s")
        serve.reset_launch_counts()
        res = serve.serve_bundle(bundle, params, prompt, GEN,
                                 SERVE_MAX_LEN,
                                 quantized_cache=quant == "int8")
        counts = serve.launch_counts()
        what = f"serve {cfg.name} quant={quant}"
        path_launches(what, counts, {name: 0 for name in serve.KERNELS})
        toks = res.tokens
        if tuple(toks.shape) != (SERVE_B, GEN) or int(toks.min()) < 0 or \
                int(toks.max()) >= cfg.vocab_size or not bool(
                    torch.isfinite(res.logits).all()):
            raise AssertionError(f"{what}: bad tokens {toks} or logits")
        log(f"[serve] {what} prompt tokens/s: "
            f"{SERVE_B * SERVE_PROMPT / res.prefill_s:.1f}  decode tokens/s: "
            f"{SERVE_B * GEN / res.decode_s:.1f}  (prompt teacher-forced "
            f"through decode: {res.prefill_s * 1e3 / SERVE_PROMPT:.2f} ms a "
            f"step, decode {res.decode_s * 1e3 / GEN:.2f} ms a step, host "
            "clock)")
        log(f"[serve] {what} sample:", toks[0].tolist())
        out.append({"arch": cfg.name, "quant": quant, "launches": counts,
                    "prefill_s": res.prefill_s, "decode_s": res.decode_s,
                    "sample": toks[0].tolist()})
    return out


def flash_bound(B, H, KVH, S, D, window=0):
    """``(bound ms, bound_by, bytes ms)`` of a causal bf16 prefill layer:
    the operations over the bf16 peak, counting only the (query, key)
    pairs inside the causal window (2 D for q . k, 2 D for p . v), or q,
    k, v and o read or written once over the memory rate."""
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(S))
    flops = 4 * B * H * D * pairs
    n_bytes = 2 * (2 * B * S * H * D + 2 * B * S * KVH * D)  # q, o, k, v
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations", t_bytes) if t_ops >= t_bytes
            else (t_bytes, "bytes", t_bytes))


def time_flash_at(dev, shape, flush, iters):
    """Device ms of kernel 5 at a causal bf16 prefill layer's ``shape``
    (``B H KVH S D`` and an optional ``window``) in its tensor-core form
    (the model's path) and its FMA form (rows unaligned, so it takes
    them), beside its plain version, its bound and
    ``scaled_dot_product_attention`` on the same inputs (the library
    yardstick, never used by the port; with a boolean band mask where the
    layer has a window)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.testing import attention_checks as AC

    Bq, H, KVH, S, D = (shape[k] for k in ("B", "H", "KVH", "S", "D"))
    window = shape.get("window", 0)
    gen = torch.Generator(device=dev).manual_seed(7)
    q = torch.randn((Bq, S, H, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((Bq, S, KVH, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((Bq, S, KVH, D), generator=gen, device=dev).bfloat16()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    row = dict(shape, causal=True, dtype="bfloat16", form="tensor cores",
               tiles=FA.kernel_tiles(q, k, v))
    row["ms"], row["host_ms"] = cold_ms(
        lambda: FA.flash_attention(q, k, v, window=window), iters, flush)
    uq, uk, uv = (AC.unaligned(t) for t in (q, k, v))
    fma = dict(row, form="float32 FMA (unaligned rows)",
               tiles=FA.kernel_tiles(uq, uk, uv))
    fma["ms"], fma["host_ms"] = cold_ms(
        lambda: FA.flash_attention(uq, uk, uv, window=window),
        max(iters // 2, 1), flush)
    row["plain_ms"], _ = cold_ms(
        lambda: FA.flash_attention_plain(q, k, v, window=window), 1, flush)
    if window:
        pos = torch.arange(S, device=dev)
        band = (pos[None, :] <= pos[:, None]) & (
            pos[None, :] > pos[:, None] - window)
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
            qt, kt, vt, attn_mask=band, enable_gqa=True)
    else:
        library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731,E501
            qt, kt, vt, is_causal=True, enable_gqa=True)
    row["library_ms"], _ = cold_ms(library, iters, flush)
    row["bound_ms"], row["bound_by"], row["bytes_ms"] = flash_bound(
        Bq, H, KVH, S, D, window)
    for key in ("plain_ms", "library_ms", "bound_ms", "bound_by",
                "bytes_ms"):
        fma[key] = row[key]
    log(f"[time] flash_attention B={Bq} H={H} KVH={KVH} S={S} D={D} causal "
        f"window={window} bf16: {row['ms']:.4f} ms on the tensor cores "
        f"(tiles {row['tiles']}; host enqueue {row['host_ms']:.4f} ms), "
        f"{fma['ms']:.4f} ms in the FMA form, plain {row['plain_ms']:.1f} "
        f"ms, scaled_dot_product_attention {row['library_ms']:.4f} ms, "
        f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}; bytes "
        f"{row['bytes_ms']:.4f} ms)")
    torch.cuda.synchronize()
    return [row, fma]


def time_flash(dev):
    """Kernel 5 timed at a ``qwen3-4b`` prefill layer's shape (head_dim
    128), at a ``recurrentgemma-9b`` one's (head_dim 256, window 2048) and
    at a ``kimi-k2-1t-a32b`` one's (head_dim 112), each in both forms
    (``time_flash_at``)."""
    import torch

    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    return (time_flash_at(dev, FLASH_TIMED, flush, 10)
            + time_flash_at(dev, FLASH_TIMED_D256, flush, 10)
            + time_flash_at(dev, FLASH_TIMED_D112, flush, 10))


def flash_bwd_bound(B, H, KVH, S, D, window=0):
    """``(bound ms, bound_by, bytes ms)`` of the flash backward at a causal
    bf16 training layer: the five products (q k^T, dout v^T, ds k, ds^T q,
    p^T dout), 2 D operations a (query, key) pair each inside the causal
    window, over the bf16 tensor-core peak; or q, out, dout, dq, k, v, dk,
    dv (bf16) and lse (float32) read or written once over the memory
    rate."""
    pairs = sum(min(i + 1, window) if window > 0 else i + 1
                for i in range(S))
    flops = 10 * B * H * D * pairs
    n_bytes = 2 * (4 * B * S * H * D + 4 * B * S * KVH * D) + 4 * B * S * H
    t_ops = flops / BF16_FLOPS * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return ((t_ops, "operations", t_bytes) if t_ops >= t_bytes
            else (t_bytes, "bytes", t_bytes))


def time_flash_bwd(dev):
    """Device ms of the flash backward kernel at each ``FLASH_BWD_TIMED``
    shape (bf16, causal; the saved out and lse from kernel 5): its
    tensor-core form at the card's head splits and at each split, and its
    FMA form on the same values in unaligned rows (``attention_checks.
    unaligned``: the form the inputs choose, no switch) at the FMA form's
    own splits, beside its plain version, its bound and the backward of
    ``scaled_dot_product_attention`` (autograd through it at the same
    shape, the backward alone timed: the library yardstick, never used by
    the port)."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.testing import attention_checks as AC

    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    iters = 5
    rows = []
    for shape in FLASH_BWD_TIMED:
        Bq, H, KVH, S, D = (shape[k] for k in ("B", "H", "KVH", "S", "D"))
        window = shape.get("window", 0)
        gen = torch.Generator(device=dev).manual_seed(9)
        q, k, v, dout = (torch.randn(sh, generator=gen, device=dev).bfloat16()
                         for sh in ((Bq, S, H, D), (Bq, S, KVH, D),
                                    (Bq, S, KVH, D), (Bq, S, H, D)))
        scale = 1.0 / math.sqrt(D)
        qs = (q.float() * scale).to(q.dtype)
        out, lse = FA.flash_attention(qs, k, v, scale=1.0, window=window,
                                      return_lse=True)
        kw = dict(window=window, scale=scale)
        fma_in = [AC.unaligned(t) for t in (q, k, v, out)] + [lse] + [
            AC.unaligned(dout)]
        row = dict(shape, causal=True, dtype="bfloat16")
        for name, ins in (("tensor_cores", (q, k, v, out, lse, dout)),
                          ("fma", fma_in)):
            tiles = FA.backward_tiles(*ins[:4], ins[5])
            if tiles["tensor_cores"] != (name == "tensor_cores"):
                raise AssertionError(f"flash backward timing: {name} inputs "
                                     f"take the other form ({tiles})")
            row[f"{name}_splits"] = FA.dkdv_splits(
                Bq, S, KVH, H // KVH, tiles["dkdv_keys"], sms)
            row[f"{name}_ms"], row[f"{name}_host_ms"] = cold_ms(
                lambda: FA.flash_attention_bwd(*ins, **kw), iters, flush)
        row["ms"], row["host_ms"] = row["tensor_cores_ms"], \
            row["tensor_cores_host_ms"]
        row["splits"] = row["tensor_cores_splits"]
        # the tensor-core form's dk/dv kernel at each head split
        row["split_ms"] = {
            n: cold_ms(lambda: FA.flash_attention_bwd(
                q, k, v, out, lse, dout, splits=n, **kw), iters, flush)[0]
            for n in range(1, H // KVH + 1) if (H // KVH) % n == 0}
        row["plain_ms"], _ = cold_ms(
            lambda: FA.flash_attention_bwd_plain(q, k, v, out, lse, dout,
                                                 **kw), 1, flush)
        qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_(True)
                      for t in (q, k, v))
        if window:
            pos = torch.arange(S, device=dev)
            band = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - window)
            o = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band, enable_gqa=True)
        else:
            o = torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)
        dot = dout.transpose(1, 2)
        row["library_ms"], _ = cold_ms(
            lambda: torch.autograd.grad(o, (qt, kt, vt), dot,
                                        retain_graph=True), iters, flush)
        row["bound_ms"], row["bound_by"], row["bytes_ms"] = flash_bwd_bound(
            Bq, H, KVH, S, D, window)
        log(f"[time] flash_attention_bwd B={Bq} H={H} KVH={KVH} S={S} D={D} "
            f"causal window={window} bf16: tensor cores {row['ms']:.4f} ms at "
            f"{row['splits']} head splits (by splits: "
            + ", ".join(f"{n} {t:.4f}" for n, t in row["split_ms"].items())
            + f" ms; host enqueue {row['host_ms']:.4f} ms), FMA form "
            f"{row['fma_ms']:.4f} ms at {row['fma_splits']} splits, plain "
            f"{row['plain_ms']:.1f} ms, scaled_dot_product_attention backward "
            f"{row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}; bytes {row['bytes_ms']:.4f} ms)")
        rows.append(row)
        del q, k, v, dout, out, lse, qt, kt, vt, o, dot, fma_in
    torch.cuda.synchronize()
    return rows


def family_prefill(dev, what, bundle, params, batch, n_flash, repeats,
                   tag="families"):
    """One full-width prefill of ``batch`` through ``make_serve_fns``:
    kernel 5 launches exactly ``n_flash`` times (each launch held against
    the plain version at the kernel's tiles on that layer's inputs, 2 bf16
    ulps of the row's largest |value|, and in its tensor-core form) and no
    other kernel launches; where it launches, the last-token logits are
    held against runs with the plain version in every layer by F7 (1 %, or
    1.5 x the plain version's spread between 512- and 256-row tiles);
    prompt tokens/s over ``repeats`` prefills (each equal to the first),
    peak device memory, and kernel 5's share of the device time
    (profiled) where it launches."""
    import torch
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.launch import serve
    from repro_torch.runtime import train_loop
    from repro_torch.testing import attention_checks as AC

    cfg = bundle.cfg
    B, S = batch["tokens"].shape
    prefill_fn, _ = train_loop.make_serve_fns(bundle, dev, B, S)
    real = FA.flash_attention
    layer_err, forms = [], set()

    def checked(q, k, v, **kw):  # the kernel, then its plain version
        out = real(q, k, v, **kw)
        forms.add((FA.tensor_core_form(q, k, v), q.shape[-1]))
        layer_err.append(AC.check_close(
            f"{what} attention {len(layer_err)}", out,
            FA.flash_attention_plain(q, k, v, **dict(
                kw, **FA.kernel_tiles(q, k, v)))))
        return out

    stages = {}
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(dev)
    serve.reset_launch_counts()
    FA.flash_attention = checked
    try:
        logits = prefill_fn(params, batch)
    finally:
        FA.flash_attention = real
    counts = serve.launch_counts()
    expect = {name: 0 for name in serve.KERNELS}
    expect["flash_attention"] = n_flash
    path_launches(what, counts, expect)
    if tuple(logits.shape) != (B, cfg.vocab_size) or not bool(
            torch.isfinite(logits).all()):
        raise AssertionError(f"{what}: logits {tuple(logits.shape)} not "
                             "finite or of the wrong shape")
    out = {"arch": cfg.name, "batch": B, "seq": S, "launches": counts,
           "stage_s": stages}
    stages["checked"] = time.perf_counter() - t0
    if n_flash:
        if forms != {(True, cfg.head_dim or cfg.d_model // cfg.n_heads)}:
            raise AssertionError(f"{what}: kernel 5 ran in {forms} "
                                 "(tensor cores?, head_dim), expected its "
                                 "tensor-core form only")
        refs = []
        for tiles in ({}, dict(block_q=256, block_k=256)):
            FA.flash_attention = lambda q, k, v, **kw: (  # noqa: E731
                FA.flash_attention_plain(q, k, v, **dict(kw, **tiles)))
            try:
                refs.append(prefill_fn(params, batch))
            finally:
                FA.flash_attention = real
        if serve.launch_counts() != counts:
            raise AssertionError(f"{what}: a plain-version run launched a "
                                 "kernel")
        stages["plain"] = time.perf_counter() - t0 - stages["checked"]
        spread = AC.logit_spread(refs[1], refs[0])
        limit = max(0.01, 1.5 * spread)
        out.update(layer_max_abs_err=layer_err, plain_tilings_spread=spread,
                   logit_limit=limit, logit_err=AC.check_logits(
                       f"{what} last-token logits", logits, refs[0],
                       limit=limit))
        log(f"[{tag}] {what}: {n_flash} launches of kernel 5 (head_dim "
            f"{sorted(forms)[0][1]}, tensor cores), each within 2 bf16 ulps "
            f"of its plain version (largest |d| {max(layer_err):.3g}); "
            f"last-token logits within {out['logit_err']:.4f} of the "
            f"row's largest |logit| of the plain-version run (tilings "
            f"differ by {spread:.4f}; limit {limit:.4f})")
    out["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = prefill_fn(params, batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        if not torch.equal(again, logits):
            raise AssertionError(f"{what}: a repeated prefill gave other "
                                 "logits")
    out["prefill_s"] = sorted(secs)
    out["prompt_tok_s"] = sorted(B * S / t for t in secs)
    t1 = time.perf_counter()
    if n_flash:
        flash_ms, device_ms = kernel_device_ms(
            lambda: prefill_fn(params, batch),
            ("flash_kernel", "flash_wgmma_kernel"), host_ops=False)
        out["profiled"] = {"flash_ms": flash_ms, "device_ms": device_ms,
                           "flash_share": flash_ms / device_ms
                           if device_ms else None}
        stages["profiled"] = time.perf_counter() - t1
    rates = out["prompt_tok_s"]
    log(f"[{tag}] {what}: prompt tokens/s median "
        f"{rates[len(rates) // 2]:.1f} (min {rates[0]:.1f}, max "
        f"{rates[-1]:.1f}; host clock over {repeats} prefills), peak "
        f"{out['peak_gib']:.2f} GiB"
        + (f"; profiled: kernel 5 {out['profiled']}" if n_flash else "")
        + f"; seconds {stages}")
    return out


def family_batch(cfg, B, S, dev, seed=1):
    """The prompt (seeded as ``serve.random_prompt``) and, for the
    enc-dec family, the frontend stub's frames ``(B, N_FRAMES, d)``."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import whisper

    batch = {"tokens": serve.random_prompt(cfg, B, S, dev, seed=seed)}
    if cfg.family == "encdec":
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        batch["frontend_embeds"] = torch.randn(
            (B, whisper.N_FRAMES, cfg.d_model), generator=gen,
            device=dev).bfloat16()
    return batch


def split_k_matmul(x, w):
    """``qmm.matmul`` summed in another order: the two halves of the
    contraction as separate float32 products, added (the CPU's product of
    bf16 values otherwise runs as one float32 GEMM)."""
    h = x.shape[-1] // 2
    return (x[..., :h].float() @ w[:h].float()
            + x[..., h:].float() @ w[h:].float()).to(x.dtype)


def family_card_cpu(dev, cfg):
    """A cut of the model at full width (``FAMILY_CUTS``) from seeded
    weights on the card and the same weights on the CPU, prefilling
    ``FAMILY_CPU_B x FAMILY_CPU_S`` tokens: with the weights in float32
    (TF32 off), where the point is the algorithm as in ``[float]``, the
    last-token logits within ``float_checks.CARD_CPU_RTOL`` of the row's
    largest |logit| and the argmax equal where the margin exceeds 2 %.  In
    bf16 the two devices' distance is reported beside the CPU's own spread
    between two summation orders of its products, without a gate: on a
    near-uniform random-weight row a bf16 rounding that flips with the
    order moves a logit by about 1 % of the row's largest (F7)."""
    import dataclasses

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.launch import serve
    from repro_torch.layers import qmm
    from repro_torch.runtime import train_loop
    from repro_torch.testing import attention_checks as AC
    from repro_torch.testing.float_checks import CARD_CPU_RTOL, params_to

    cut = dataclasses.replace(cfg, **FAMILY_CUTS[cfg.name])
    bundle, params = serve.build_bundle(cut, dev)
    batch = family_batch(cut, FAMILY_CPU_B, FAMILY_CPU_S, dev)
    card, _ = train_loop.make_serve_fns(bundle, dev, FAMILY_CPU_B,
                                        FAMILY_CPU_S)
    on_cpu, _ = train_loop.make_serve_fns(bundle, "cpu", FAMILY_CPU_B,
                                          FAMILY_CPU_S)
    t0 = time.perf_counter()
    out = {"cut": FAMILY_CUTS[cfg.name]}
    for dtype in (torch.float32, torch.bfloat16):
        p_card = tu.tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                             else t, params)
        b = {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()}
        got = card(p_card, b).cpu()
        p_cpu = params_to(p_card, "cpu")
        del p_card
        want = on_cpu(p_cpu, b)
        name = str(dtype).split(".")[-1]
        if dtype == torch.float32:
            out["float32_logit_err"] = AC.check_logits(
                f"{cut.name} {FAMILY_CUTS[cfg.name]} float32 card vs CPU",
                got, want, limit=CARD_CPU_RTOL)
            continue
        real = qmm.matmul
        qmm.matmul = split_k_matmul
        try:
            other = on_cpu(p_cpu, b)
        finally:
            qmm.matmul = real
        out["bfloat16_logit_spread"] = AC.logit_spread(got, want)
        out["bfloat16_cpu_orders_spread"] = AC.logit_spread(other, want)
        del p_cpu
    log(f"[families] {cfg.name} cut to {FAMILY_CUTS[cfg.name]}, "
        f"{FAMILY_CPU_B} x {FAMILY_CPU_S} tokens: float32 weights, the "
        f"card's last-token logits within {out['float32_logit_err']:.3g} of "
        f"the row's largest |logit| of the CPU's (limit {CARD_CPU_RTOL}); "
        f"bf16: {out['bfloat16_logit_spread']:.4f} apart, the CPU's two "
        f"summation orders {out['bfloat16_cpu_orders_spread']:.4f} (no "
        f"gate; {time.perf_counter() - t0:.1f}s)")
    del params
    torch.cuda.empty_cache()
    return out


def families_full_width(dev):
    """``[families]``: whisper-tiny, falcon-mamba-7b and recurrentgemma-9b
    at full width from seeded weights, one resident on the card at a time:
    recurrentgemma's prefill of 1 x 4096 (kernel 5 in each of its 12
    attention layers, at head_dim 256, and no other kernel), mamba's of 1 x
    4096 (no kernel), whisper's of 4 x 64 text tokens over the 1500 frames
    (no kernel) and of 1 x 4096 (kernel 5 in each of the decoder's 4
    self-attention layers, head_dim 64); each model's static serves in
    bf16 and int8 (no kernel); a cut of each on the card against the
    CPU."""
    import gc

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import recurrentgemma

    out = {}
    for name in FAMILIES:
        cfg = get_config(name)
        t0 = time.perf_counter()
        bundle, params = serve.build_bundle(cfg, dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tu.leaves(params))
        log(f"[families] {name}: seeded init of {n_params / 1e9:.3f} B "
            f"parameters on the card in {time.perf_counter() - t0:.2f}s")
        if cfg.family == "encdec":
            runs = [(B, S, cfg.n_layers if S > 2048 else 0)
                    for B, S in WHISPER_PREFILLS]
        else:
            n_flash = (recurrentgemma._layer_counts(cfg)[1]
                       if cfg.family == "hybrid" else 0)
            runs = [(1, FAMILY_PREFILL_S, n_flash)]
        with torch.no_grad():
            prefills = [family_prefill(
                dev, f"prefill {name} B={B} S={S}", bundle, params,
                family_batch(cfg, B, S, dev), n_flash, FAMILY_REPEATS)
                for B, S, n_flash in runs]
        serves = serve_transformer_full_width(dev, (bundle, params))
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = {"n_params": n_params, "prefills": prefills,
                     "serves": serves,
                     "card_cpu": family_card_cpu(dev, cfg),
                     "seconds": time.perf_counter() - t0}
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[families] {name}: {out[name]['seconds']:.1f}s")
    return out


def moe_card_cpu(dev):
    """The MoE models on the card against the CPU, float32 weights (TF32
    off): each smoke config, and grok's 1-layer full-width cut where the
    host holds its float32 weights twice over (they are counted first);
    prefill of ``FAMILY_CPU_B x FAMILY_CPU_S`` tokens, the last-token
    logits within ``float_checks.CARD_CPU_RTOL`` of the row's largest
    |logit|, the argmax equal where the margin exceeds 2 %."""
    import dataclasses

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    from repro_torch.runtime import train_loop
    from repro_torch.testing import attention_checks as AC
    from repro_torch.testing.float_checks import CARD_CPU_RTOL, params_to

    name, cut = MOE_CPU_CUT
    runs = [(f"{n} smoke", get_config(n, smoke=True)) for n in MOE]
    full = dataclasses.replace(get_config(name), **cut)
    need = 4 * transformer.param_count(full)
    have = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_AVPHYS_PAGES")
    out = {"cut": {name: cut}, "cut_float32_bytes": need,
           "host_available_bytes": have}
    if 2 * need < have:
        runs.append((f"{name} cut to {cut}", full))
    else:
        log(f"[moe] {name} cut to {cut}: its float32 weights take "
            f"{need / 1e9:.1f} GB, the host has {have / 1e9:.1f} GB free: "
            "not run")
    for what, cfg in runs:
        t0 = time.perf_counter()
        bundle, params = serve.build_bundle(cfg, dev)
        p32 = tu.tree_map(lambda t: t.float(), params)
        del params
        batch = family_batch(cfg, FAMILY_CPU_B, FAMILY_CPU_S, dev)
        card, _ = train_loop.make_serve_fns(bundle, dev, FAMILY_CPU_B,
                                            FAMILY_CPU_S)
        on_cpu, _ = train_loop.make_serve_fns(bundle, "cpu", FAMILY_CPU_B,
                                              FAMILY_CPU_S)
        got = card(p32, batch).cpu()
        p_cpu = params_to(p32, "cpu")
        del p32
        torch.cuda.empty_cache()
        want = on_cpu(p_cpu, batch)
        del p_cpu
        err = AC.check_logits(f"{what} float32 card vs CPU", got, want,
                              limit=CARD_CPU_RTOL)
        out[what] = {"float32_logit_err": err,
                     "float32_bytes": 4 * transformer.param_count(cfg),
                     "seconds": time.perf_counter() - t0}
        log(f"[moe] {what}, {FAMILY_CPU_B} x {FAMILY_CPU_S} tokens: float32 "
            f"weights ({out[what]['float32_bytes'] / 1e9:.3f} GB on each "
            f"device), the card's last-token logits within {err:.3g} of the "
            f"row's largest |logit| of the CPU's (limit {CARD_CPU_RTOL}; "
            f"{out[what]['seconds']:.1f}s)")
    return out


def moe_full_width(dev):
    """``[moe]``: grok-1-314b and kimi-k2-1t-a32b at full width, cut in
    depth (``MOE_CUTS``), from seeded weights, one resident on the card at
    a time: a prefill of ``MOE_PREFILL_B x MOE_PREFILL_S`` through
    ``make_serve_fns`` (kernel 5 once a layer in its tensor-core form, at
    head_dim 128 and 112, each launch within 2 bf16 ulps of its plain
    version, the logits by F7, and no other kernel; ``family_prefill``),
    the static serves in bf16 and int8 (no kernel), then ``moe_card_cpu``."""
    import dataclasses
    import gc

    import torch
    from repro_torch import tree_util as tu
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve

    out = {}
    for name in MOE:
        cfg = dataclasses.replace(get_config(name), **MOE_CUTS[name])
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(dev)
        bundle, params = serve.build_bundle(cfg, dev)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in tu.leaves(params))
        log(f"[moe] {name} cut to {MOE_CUTS[name]} ({cfg.n_dense_layers} "
            f"dense + {cfg.n_layers - cfg.n_dense_layers} MoE layers of "
            f"{cfg.n_experts} experts, top {cfg.topk}): seeded init of "
            f"{n_params / 1e9:.3f} B parameters on the card in "
            f"{time.perf_counter() - t0:.2f}s, peak "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
        with torch.no_grad():
            prefill = family_prefill(
                dev, f"prefill {name} B={MOE_PREFILL_B} S={MOE_PREFILL_S}",
                bundle, params, family_batch(cfg, MOE_PREFILL_B,
                                             MOE_PREFILL_S, dev),
                cfg.n_layers, FAMILY_REPEATS, tag="moe")
        serves = serve_transformer_full_width(dev, (bundle, params))
        del bundle, params
        gc.collect()
        torch.cuda.empty_cache()
        out[name] = {"cut": MOE_CUTS[name], "n_params": n_params,
                     "prefills": [prefill], "serves": serves,
                     "seconds": time.perf_counter() - t0}
        log(f"[moe] {name}: {out[name]['seconds']:.1f}s")
    out["card_cpu"] = moe_card_cpu(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return out


class Phases:
    """Seconds of each phase, printed as it ends."""

    def __init__(self):
        self.seconds = {}
        self.t0 = time.perf_counter()

    def done(self, name):
        now = time.perf_counter()
        self.seconds[name] = now - self.t0
        log(f"[phase] {name}: {self.seconds[name]:.1f}s")
        self.t0 = now


def kernel_entry(name, mod, launches, err, row, at, rows):
    entry = {"name": name, "route": "cuda", "source": mod.SOURCE,
             "replaces": mod.REPLACES, "launches": launches,
             "max_abs_err": err, "ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"], "at": at, "shapes": rows}
    return entry


def time_barrier(dev, n_barriers=2000, repeats=5):
    """Device us of one grid barrier of the sequence kernels
    (``scan::grid_sync``) on a cooperative grid of ``BARRIER_CTAS`` CTAs:
    a launch of ``n_barriers`` barriers less a launch of none, over
    ``n_barriers``; the median of ``repeats``."""
    import ctypes
    import torch
    from repro_torch.kernels import build

    fn = build.load("quant_lstm_scan").quant_scan_barrier_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch_ms(n):
        counter.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        build.check(fn(counter.data_ptr(), n, BARRIER_CTAS, stream),
                    "quant_scan_barrier_probe")
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e)

    launch_ms(n_barriers)  # warm up
    per = sorted((launch_ms(n_barriers) - launch_ms(0)) / n_barriers * 1e3
                 for _ in range(repeats))
    us = per[repeats // 2]
    log(f"[time] grid barrier of the sequence kernels: {us:.3f} us on "
        f"{BARRIER_CTAS} CTAs (median of {repeats}; {per})")
    return {"ctas": BARRIER_CTAS, "us": us, "repeats_us": per}


TIMES = {"--gemm-times": ("gemm", ("int8_matmul",)),
         "--cell-times": ("cell", ("int_layernorm", "quant_lstm_cell")),
         "--serve-times": ("serve", ("int8_matmul", "quant_lstm_scan",
                                     "quant_gru_scan", "int_layernorm",
                                     "quant_lstm_cell"))}


def serve_rates(dev):
    """The host-clock rates of the served paths, without their checks (the
    full run holds every output): full-width lstm-rnnt and gru-rnnt served
    statically ``REPEATS`` times each, the stepwise pass of lstm-rnnt 3
    times, and each of ``ENGINE_RUNS`` ``ENGINE_REPEATS`` times, each path
    after one run that is not counted; with the tokens each path served,
    so two revisions' outputs are compared too."""
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.layers import embedding as emb

    out, models = {}, {}
    for arch in ("lstm-rnnt", "gru-rnnt"):
        cfg = get_config(arch)
        params, qlayers = serve.build_model(cfg, B, T, dev)
        models[arch] = (params, qlayers, cfg)
        prompt = serve.random_prompt(cfg, B, T, dev)
        reps = [serve.serve(params, qlayers, cfg, prompt, GEN)
                for _ in range(REPEATS + 1)][1:]
        out[f"serve {arch}"] = {
            "prompt_tok_s": sorted(B * T / r.prefill_s for r in reps),
            "decode_tok_s": sorted(B * GEN / r.decode_s for r in reps),
            "tokens": reps[0].tokens.tolist()}
    params, qlayers, cfg = models["lstm-rnnt"]
    with torch.no_grad():
        x = emb.embed_tokens(params, serve.random_prompt(
            cfg, B, T, dev, seed=4)).float()
        passes = [timed_pass(qlayers, x, ops.quant_recurrent_seq_stepwise)
                  for _ in range(4)][1:]
    out["stepwise lstm-rnnt"] = {
        "prompt_tok_s": sorted(B * T / secs for _, secs in passes),
        "ys_sum": int(passes[0][0][-1][1].long().sum())}
    for arch, policy, ratio, speculate in ENGINE_RUNS:
        requests = engine_workload(models[arch][2])
        runs = [engine_run(models[arch], requests, policy, ratio, speculate)
                for _ in range(ENGINE_REPEATS + 1)][1:]
        stats = [st for _, st in runs]
        out[f"engine {arch} {policy}"] = {
            "tokens_per_s": sorted(st.tokens_per_s for st in stats),
            "step_ms": sorted(st.wall_s / st.steps * 1e3 for st in stats),
            "tokens": [runs[0][0][r.rid].tokens for r in requests]}
    for path, rates in out.items():
        for name, vals in rates.items():
            if name.endswith(("_s", "_ms")):
                log(f"[serve-times] {path} {name} over {len(vals)} runs: min "
                    f"{vals[0]:.1f} median {vals[len(vals) // 2]:.1f} max "
                    f"{vals[-1]:.1f} (host clock)")
    return out


def kernel_times(flag, src, tag):
    """``--gemm-times SRC TAG`` (kernel 1 at ``_gemm_timed()``, by
    ``time_gemm``), ``--cell-times SRC TAG`` (kernels 2 and 3 at the
    stepwise pass's shapes, by ``time_cell_kernels``) or ``--serve-times
    SRC TAG`` (the served paths' host-clock rates, by ``serve_rates``):
    the port under ``SRC`` (this checkout's ``src``, or an earlier
    revision's unpacked beside it), so that two revisions are set side by
    side in one call on one card.  Writes
    ``chiprun_out/<gemm|cell|serve>_times_<TAG>.json``."""
    kind, names = TIMES[flag]
    sys.path.insert(0, os.path.abspath(src))
    import torch
    import repro_torch
    from repro_torch.kernels import build

    log(f"[{kind}-times] {tag}: repro_torch from "
        f"{os.path.dirname(repro_torch.__file__)} on "
        f"{torch.cuda.get_device_name(0)}")
    log(f"[build] {build.build_all(list(names))}")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")
    dev = torch.device("cuda", 0)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device=dev)
    if kind == "gemm":
        out = {"rows": time_gemm(dev, flush)}
    elif kind == "cell":
        cell, ln = time_cell_kernels(dev, flush)
        out = {"quant_lstm_cell": cell, "int_layernorm": ln}
    else:
        del flush
        out = serve_rates(dev)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", f"{kind}_times_{tag}.json"),
              "w") as f:
        json.dump({"gpu": smi, "src": os.path.abspath(src), **out}, f,
                  indent=1)
    log(smi)
    return 0


def families_only() -> int:
    """``--families``: kernel 5 built and checked (every case of
    ``check_flash``), the ``[families]`` phase and kernel 5's timings, with
    no other phase; results in ``chiprun_out/families.json``."""
    import torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phases = Phases()
    log(f"[build] {build.build_all(['flash_attention'])}")
    phases.done("build")
    err = check_flash(dev)
    phases.done("check flash_attention")
    families = families_full_width(dev)
    phases.done("families")
    flash = time_flash(dev)
    phases.done("timing")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "families.json"), "w") as f:
        json.dump({"gpu": smi, "flash_max_abs_err": err,
                   "families": families, "flash": flash,
                   "phase_s": phases.seconds}, f, indent=1)
    log(smi)
    return 0


def moe_only() -> int:
    """``--moe``: kernel 5 built and checked (every case of
    ``check_flash``), the ``[moe]`` phase and kernel 5's timings, with no
    other phase; results in ``chiprun_out/moe.json``."""
    import torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phases = Phases()
    log(f"[build] {build.build_all(['flash_attention'])}")
    for line in build.build_log("flash_attention").splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build] flash_attention: {line.strip()}")
    phases.done("build")
    err = check_flash(dev)
    phases.done("check flash_attention")
    moe = moe_full_width(dev)
    phases.done("moe")
    flash = time_flash(dev)
    phases.done("timing")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "moe.json"), "w") as f:
        json.dump({"gpu": smi, "flash_max_abs_err": err, "moe": moe,
                   "flash": flash, "phase_s": phases.seconds}, f, indent=1)
    log(smi)
    return 0


def flash_digests(src, tag) -> int:
    """``--flash-digests SRC TAG``: kernel 5 built from the port under
    ``SRC`` (this checkout's ``src``, or an earlier revision unpacked with
    ``git archive``) and run on every case of ``check_flash`` (the same
    seeded inputs); the SHA-256 of each output's values goes to
    ``chiprun_out/flash_digests_<TAG>.json``."""
    sys.path.insert(0, os.path.abspath(src))
    import hashlib

    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.testing import attention_checks as AC

    log(f"[build] {build.build_all(['flash_attention'])}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(21)
    groups = [AC.flash_cases(gen),
              AC.flash_cases(gen, AC.FLASH_SHAPES_D256, AC.FLASH_MASKS_D256),
              AC.flash_cases(gen, AC.FLASH_SHAPES_D112, AC.FLASH_MASKS_D256)]
    digests = {label: hashlib.sha256(FA.flash_attention(**kw).float().cpu()
                                     .numpy().tobytes()).hexdigest()
               for label, kw in (case for group in groups for case in group)}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           f"flash_digests_{tag}.json"), "w") as f:
        json.dump({"gpu": smi, "src": os.path.abspath(src),
                   "digests": digests}, f, indent=1)
    log(f"[flash-digests] {tag}: {len(digests)} cases, {smi}")
    return 0


def train_only() -> int:
    """``--train``: kernel 5 and the flash backward built, the attention
    families' training (``train_attention``: the backward's checks,
    full-width qwen3-4b through the train CLI, the recurrentgemma and grok
    cuts, float32 card against CPU) and the backward's timings, with no
    other phase; results in ``chiprun_out/train.json``."""
    import torch
    from repro_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phases = Phases()
    names = ["flash_attention", "flash_attention_bwd"]
    log(f"[build] {build.build_all(names)} (parallel)")
    for name in names:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    phases.done("build")
    train = train_attention(dev)
    phases.done("train")
    flash_bwd = time_flash_bwd(dev)
    phases.done("timing")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "train.json"), "w") as f:
        json.dump({"gpu": smi, "train": train, "flash_bwd": flash_bwd,
                   "phase_s": phases.seconds}, f, indent=1)
    log(smi)
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing is run on the CPU",
              file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--families"]:
        return families_only()
    if sys.argv[1:] == ["--moe"]:
        return moe_only()
    if sys.argv[1:] == ["--train"]:
        return train_only()
    if sys.argv[1:2] == ["--flash-digests"]:
        if len(sys.argv) != 4:
            print("usage: chip_smoke.py --flash-digests SRC TAG",
                  file=sys.stderr)
            return 2
        return flash_digests(*sys.argv[2:4])
    if sys.argv[1:2] and sys.argv[1] in TIMES:
        if len(sys.argv) != 4:
            print(f"usage: chip_smoke.py {sys.argv[1]} SRC TAG",
                  file=sys.stderr)
            return 2
        return kernel_times(*sys.argv[1:4])
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as KF
    from repro_torch.kernels import int8_matmul as K1
    from repro_torch.kernels import int_layernorm as KL
    from repro_torch.kernels import quant_gru_scan as KG
    from repro_torch.kernels import quant_lstm_cell as KC
    from repro_torch.kernels import quant_lstm_scan as K2

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}")
    phases = Phases()

    secs = build.build_all(build.KERNELS + ("fixedpoint_check",))
    log(f"[build] {secs} (parallel)")
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"[build] {name}: {line.strip()}")
    phases.done("build")

    check_fixedpoint(dev)
    err1 = check_gemm(dev)
    phases.done("check fixedpoint + int8_matmul")
    err_cell, err_ln = check_cell_kernels(dev)
    phases.done("check quant_lstm_cell + int_layernorm")
    err2, lstm_layer = check_scan(dev)
    phases.done("check quant_lstm_scan")
    err3, gru_layer = check_gru_scan(dev)
    phases.done("check quant_gru_scan")
    check_stepwise_layers(dev, gru_layer)
    phases.done("check stepwise layers")
    err_flash = check_flash(dev)
    phases.done("check flash_attention")
    lstm_serve, lstm_model = serve_full_width(dev, "lstm-rnnt", REPEATS)
    phases.done("serve lstm-rnnt")
    stepwise = stepwise_full_width(dev, lstm_model)
    phases.done("stepwise lstm-rnnt")
    gru_serve, gru_model = serve_full_width(dev, "gru-rnnt", 0)
    phases.done("serve gru-rnnt")
    float_serves = float_full_width(dev, {"lstm-rnnt": lstm_serve,
                                          "gru-rnnt": gru_serve})
    phases.done("float")
    train = train_full_width(dev)
    phases.done("train")
    models = {"gru-rnnt": gru_model, "lstm-rnnt": lstm_model}
    engines = []
    for arch, policy, ratio, speculate in ENGINE_RUNS:
        engines.append(engine_full_width(models[arch], policy, ratio,
                                         speculate))
        phases.done(f"engine {arch}")
    fleet = fleet_full_width(models)
    phases.done("fleet")
    prefill, transformer = prefill_full_width(dev)
    phases.done(f"prefill {TRANSFORMER}")
    transformer_serve = serve_transformer_full_width(dev, transformer)
    del transformer
    phases.done(f"serve {TRANSFORMER}")
    families = families_full_width(dev)
    phases.done("families")
    moe = moe_full_width(dev)
    phases.done("moe")
    gemm, scan, gru_scan, (cell, ln) = time_kernels(dev, lstm_layer,
                                                    gru_layer)
    flash = time_flash(dev)
    flash_bwd = time_flash_bwd(dev)
    barrier = time_barrier(dev)
    phases.done("timing")

    # the main paths of the slices so far: the engine and the fleet on both
    # models and the stepwise pass of lstm-rnnt; each kernel's launches
    # over them
    launches = {name: sum(e["launches"][name] for e in engines + fleet)
                + stepwise["launches"][name] for name in stepwise["launches"]}
    # kernel 5's main paths: the long-prompt prefills of the transformer,
    # of recurrentgemma, of whisper's decoder and of the MoE models' cuts
    family_flash = {f"{p['arch']} B={p['batch']} S={p['seq']}":
                    p["launches"]["flash_attention"]
                    for fam in list(families.values()) + [
                        moe[name] for name in MOE]
                    for p in fam["prefills"]}
    # and training past S 1024: the full-width qwen3-4b run and the cuts
    attn_train = train["attention"]
    train_flash = {f"train {name}": attn_train[name]["launches"]
                   for name in [TRAIN_LM] + [c[0] for c in TRAIN_CUTS]}
    launches["flash_attention"] = prefill["launches"]["flash_attention"] \
        + sum(family_flash.values()) + sum(
            c["flash_attention"] for c in train_flash.values())
    launches["flash_attention_bwd"] = sum(
        c["flash_attention_bwd"] for c in train_flash.values())
    gemm_by_shape = {}
    for path in engines + fleet + [stepwise]:
        for shape, n in path["gemm_launches_by_shape"].items():
            gemm_by_shape[shape] = gemm_by_shape.get(shape, 0) + n
    if sum(gemm_by_shape.values()) != launches["int8_matmul"]:
        raise AssertionError(f"int8_matmul launches by shape {gemm_by_shape}"
                             f" do not add up to {launches['int8_matmul']}")
    log(f"[launches] int8_matmul by shape over the engines, the fleet "
        f"runs and the stepwise pass: {gemm_by_shape}")
    for name, r in (("int_layernorm", ln[0]), ("quant_lstm_cell", cell[0])):
        r["launches_x_gap_ms"] = launches[name] * (r["ms"] - r["bound_ms"])
        log(f"[launches] {name}: {launches[name]} x ({r['ms']:.4f} - "
            f"{r['bound_ms']:.6f}) ms = {r['launches_x_gap_ms']:.2f} ms")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kernels = [
        dict(kernel_entry("int8_matmul", K1, launches["int8_matmul"], err1,
                          gemm[0], "M=B*T=128 K=2048 N=8192 int32 out (LSTM "
                          "layer-0 prefill)", gemm),
             launches_by_shape=gemm_by_shape),
        kernel_entry("quant_lstm_scan", K2, launches["quant_lstm_scan"],
                     err2, scan[0], "B=4 T=32 H=2048 d_proj=640 "
                     "LN+projection (prefill layer)", scan),
        kernel_entry("quant_gru_scan", KG, launches["quant_gru_scan"], err3,
                     gru_scan[0], "B=4 T=32 H=2048 LN (prefill layer)",
                     gru_scan),
        kernel_entry("int_layernorm", KL, launches["int_layernorm"], err_ln,
                     ln[0], "the gate pass of a stepwise lstm-rnnt step, "
                     "B=4 G=4 n=2048", ln),
        kernel_entry("quant_lstm_cell", KC, launches["quant_lstm_cell"],
                     err_cell, cell[0], "the step entry of a stepwise "
                     "lstm-rnnt step, B=4 H=2048", cell),
        dict(kernel_entry("flash_attention", KF, launches["flash_attention"],
                          err_flash, flash[0], "B=2 H=32 KVH=8 S=4096 D=128 "
                          "causal bf16, tensor-core form (a qwen3-4b "
                          "prefill layer; the head_dim-256 rows of a "
                          "recurrentgemma-9b layer and the head_dim-112 "
                          "rows of a kimi-k2-1t-a32b layer follow in "
                          "shapes)",
                          flash),
             launches_by_path=dict(
                 {f"{TRANSFORMER} B={PREFILL_B} S={PREFILL_S}":
                  prefill["launches"]["flash_attention"]}, **family_flash,
                 **{p: c["flash_attention"]
                    for p, c in train_flash.items()})),
        dict(kernel_entry("flash_attention_bwd", KF.backward,
                          launches["flash_attention_bwd"],
                          max(attn_train["check"]["float32"],
                              attn_train["check"]["bfloat16"]),
                          flash_bwd[0], "B=1 H=32 KVH=8 S=4096 D=128 causal "
                          "bf16 (a qwen3-4b training layer; a "
                          "recurrentgemma-9b layer, window 2048, follows in "
                          "shapes)", flash_bwd),
             launches_by_path={p: c["flash_attention_bwd"]
                               for p, c in train_flash.items()},
             launches_per_step={
                 f"train {TRAIN_LM}": attn_train[TRAIN_LM][
                     "launches_per_step"]["flash_attention_bwd"]}),
    ]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"gpu": smi, "build_s": secs, "kernels": kernels,
                   "serve": [lstm_serve, gru_serve], "engine": engines,
                   "fleet": fleet,
                   "float": float_serves, "train": train,
                   "stepwise": stepwise, "prefill": prefill,
                   "transformer_serve": transformer_serve,
                   "families": families, "moe": moe,
                   "grid_barrier": barrier, "flash_bwd": flash_bwd,
                   "batch": B, "prompt_len": T, "gen": GEN,
                   "phase_s": phases.seconds}, f, indent=1)
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
