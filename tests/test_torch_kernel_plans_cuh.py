"""The redesigned kernels' planning headers, compiled for the host.

``src/repro_torch/csrc/flash_tiles.cuh`` (kernel 5: which key tiles a q
tile visits, and which of those run the mask) and the partition of
``src/repro_torch/csrc/recurrent_scan.cuh`` (kernel 4: how a layer's hidden
units split over the cooperative grid) are valid host C++.  g++ compiles a
small program around each, as ``test_torch_fixedpoint_cuh.py`` does for the
fixed-point header:

* the tile classification is held against a brute-force mask over causal,
  sliding-window, ragged-Sk and ``q_offset`` shapes, at the tensor-core
  form's tiles (128-row q tiles read by two 64-row warpgroups, 128 keys,
  and the key tiles the header picks at head_dim 112 and 256) and the FMA
  form's (64 x 64): a skipped tile holds no attended pair and is only
  skipped when every row of the q tile has a key (what makes the skip
  exact), an unmasked tile holds only attended pairs, and a masked one at
  least one pair that is not;
* the tensor-core form's head-width plan: every width the wrapper sends
  there (64, 112, 128, 256) pads to whole 64-column TMA boxes (112 to 128,
  wasting 6.7 % of the form's tensor-core work), takes k-steps that cover
  exactly its columns, fits a block's shared memory and has the key tile
  the wrapper's ``kernel_tiles`` reports;
* the backward's tensor-core plan: at every width the wrapper sends there
  (64, 112, 128, 256) both kernels fit a block's shared memory, hold at
  most 255 registers a thread of accumulators and logits, cover exactly
  the width's columns in 64-column TMA boxes (split over the two
  warpgroups past 128 columns) and their tiles' rows in logit columns, and
  run the tiles ``flash_attention.TC_BWD_TILES`` reports; widths the
  forward's form refuses are refused;
* the partition (which the wrappers read from the built libraries, through
  ``kernels.scan_plan``) covers every hidden unit exactly once on at most
  one CTA per SM, fits every registered recurrent config at the batch
  sizes the port runs, passes the batch rows in groups whose shared memory
  stays bounded however many rows there are, and refuses widths that
  cannot fit.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402
from repro_torch.models import lstm_lm  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

TILES_PROGRAM = r"""
#include <cstdint>
#include <cstdio>

#include "flash_tiles.cuh"

// in: n, then n x (Sq, Sk, causal, window, q_offset, bq, bk, sub) int32
// out per case, per q tile: kt0, kt1, then per sub-block of `sub` rows
// and per key tile of the whole key range: masked (0 / 1)
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t c[8];
    if (fread(c, 4, 8, stdin) != 8) return 1;
    const tiles::Mask m{c[0], c[1], c[2], c[3], c[4]};
    const int bq = c[5], bk = c[6], sub = c[7];
    const int n_kt = (m.Sk + bk - 1) / bk;
    for (int q0 = 0; q0 < m.Sq; q0 += bq) {
      int32_t r[2];
      tiles::tile_range(m, q0, bq, bk, &r[0], &r[1]);
      fwrite(r, 4, 2, stdout);
      for (int s0 = q0; s0 < q0 + bq; s0 += sub)
        for (int kt = 0; kt < n_kt; ++kt) {
          const int32_t masked = tiles::tile_masked(
              m, s0 + m.q_offset, s0 + sub - 1 + m.q_offset, kt * bk, bk);
          fwrite(&masked, 4, 1, stdout);
        }
    }
  }
  return 0;
}
"""

WIDTHS_PROGRAM = r"""
#include <cstdint>
#include <cstdio>

#include "flash_tiles.cuh"

// in: n, then n head widths int32
// out per width: padded, block_k, smem bytes, width_ok (int32)
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t D;
    if (fread(&D, 4, 1, stdin) != 1) return 1;
    const int32_t r[4] = {tiles::tc_padded(D), tiles::tc_block_k(D),
                          tiles::tc_smem_bytes(D), tiles::tc_width_ok(D)};
    fwrite(r, 4, 4, stdout);
  }
  return 0;
}
"""

BWD_PROGRAM = r"""
#include <cstdint>
#include <cstdio>

#include "flash_tiles.cuh"

// in: n, then n head widths int32
// out per width: padded, split, acc_cols, kv_keys, kv_rows, kv_logit_cols,
// q_rows, q_keys, q_logit_cols, kv_regs, q_regs, kv_smem, q_smem, ok,
// seq_pad, stages (int32)
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t D;
    if (fread(&D, 4, 1, stdin) != 1) return 1;
    const int32_t r[16] = {
        tiles::tc_padded(D), tiles::tc_bwd_split(D), tiles::tc_bwd_acc_cols(D),
        tiles::tc_bwd_kv_keys(D), tiles::tc_bwd_kv_rows(D),
        tiles::tc_bwd_logit_cols(D, tiles::tc_bwd_kv_rows(D)),
        tiles::tc_bwd_q_rows(D), tiles::tc_bwd_q_keys(D),
        tiles::tc_bwd_logit_cols(D, tiles::tc_bwd_q_keys(D)),
        tiles::tc_bwd_kv_regs(D), tiles::tc_bwd_q_regs(D),
        tiles::tc_bwd_kv_smem(D), tiles::tc_bwd_q_smem(D),
        tiles::tc_bwd_width_ok(D), tiles::kTcBwdSeqPad, tiles::kTcBwdStages};
    fwrite(r, 4, 16, stdout);
  }
  return 0;
}
"""

PLAN_PROGRAM = r"""
#include <cstdint>
#include <cstdio>

#include "recurrent_scan.cuh"

// in: n, then n x (cell, H, d_out, G, B, proj, n_sm) int32
// out: n x (err, u, nb, rg, smem, ws) int64
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t c[7];
    if (fread(c, 4, 7, stdin) != 7) return 1;
    const scan::Plan p = scan::plan(c[0], c[1], c[2], c[3], c[4], c[5], c[6]);
    const int64_t r[6] = {p.err, p.u, p.nb, p.rg, p.smem, p.ws};
    fwrite(r, 8, 6, stdout);
  }
  return 0;
}
"""


def _compile(tmp_path_factory, name, program):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    work = tmp_path_factory.mktemp(name)
    (work / f"{name}.cpp").write_text(program)
    exe = work / name
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}", "-o", str(exe),
                    str(work / f"{name}.cpp")], check=True, timeout=120)
    return exe


def _run(exe, rows):
    blob = np.array([len(rows)], np.int32).tobytes() + np.array(
        rows, np.int32).tobytes()
    return subprocess.run([str(exe)], input=blob, capture_output=True,
                          check=True, timeout=120).stdout


# (Sq, Sk, causal, window, q_offset): the prefill's square causal shape,
# ragged lengths, sliding windows, a decode-like offset, keys past every
# row's reach and rows with no key at all
MASKS = {
    "causal": [(256, 256, 1, 0, 0), (1100, 1100, 1, 0, 0),
               (300, 300, 1, 0, 0)],
    "non-causal ragged": [(200, 77, 0, 0, 0), (129, 1100, 0, 0, 0)],
    "window": [(1100, 1100, 1, 64, 0), (512, 512, 1, 200, 0),
               (300, 300, 0, 100, 0)],
    "q_offset": [(64, 1100, 1, 0, 1036), (200, 300, 1, 0, 100),
                 (130, 700, 1, 128, 570), (100, 90, 1, 0, -50)],
}
TILINGS = {"tensor cores": (128, 128, 64), "FMA": (64, 64, 64),
           "tensor cores D112": (128, FA.TC_BLOCK_K[112], 64),
           "tensor cores D256": (128, FA.TC_BLOCK_K[256], 64)}


@pytest.fixture(scope="module")
def tiles_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "flash_tiles", TILES_PROGRAM)


@pytest.fixture(scope="module")
def widths_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "flash_widths", WIDTHS_PROGRAM)


def test_flash_head_width_plan(widths_exe):
    """Every width the wrapper sends to the tensor-core form is one the
    header builds: whole 64-column boxes (D <= Dp < D + 64), k-steps of 16
    columns covering D exactly, at most 227 KB of shared memory, and the
    key tile ``kernel_tiles`` reports; head_dim 112 runs at 128, its P.v
    wasting (128 - 112) / (112 + 128) of the form's tensor-core work (the
    q.k^T product takes 7 k-steps, no padding); widths off the 16-column
    grid or past 256 are refused."""
    widths = list(range(8, 321, 8)) + [100]
    out = np.frombuffer(_run(widths_exe, [(D,) for D in widths]),
                        np.int32).reshape(-1, 4)
    plan = {D: tuple(int(v) for v in row) for D, row in zip(widths, out)}
    for D in FA.TC_BLOCK_K:
        padded, block_k, smem, ok = plan[D]
        assert ok and padded % 64 == 0 and D <= padded < D + 64, (D, plan[D])
        assert D % 16 == 0 and smem <= 227 * 1024, (D, plan[D])
        assert block_k == FA.TC_BLOCK_K[D], (D, plan[D])
        assert smem == 128 * padded * 2 + 2 * 2 * block_k * padded * 2 + 1024
    assert plan[112][:2] == (128, 128) and plan[112][2] == plan[128][2]
    assert abs((128 - 112) / (112 + 128) - 0.0667) < 1e-3
    for D in (8, 100, 264, 320):
        assert not plan[D][3], (D, plan[D])


@pytest.fixture(scope="module")
def bwd_plan(tmp_path_factory):
    """``{D: {field: value}}`` of the backward's tensor-core plan over the
    wrapper's widths and a sweep around them."""
    exe = _compile(tmp_path_factory, "flash_bwd_plan", BWD_PROGRAM)
    widths = sorted(set(range(16, 321, 16)) | set(FA.TC_BWD_TILES) | {8, 100})
    out = np.frombuffer(_run(exe, [(D,) for D in widths]),
                        np.int32).reshape(-1, 16)
    names = ("padded", "split", "acc_cols", "kv_keys", "kv_rows",
             "kv_logit_cols", "q_rows", "q_keys", "q_logit_cols", "kv_regs",
             "q_regs", "kv_smem", "q_smem", "ok", "seq_pad", "stages")
    return {D: dict(zip(names, (int(v) for v in row)))
            for D, row in zip(widths, out)}


@pytest.mark.parametrize("D", sorted(FA.TC_BWD_TILES))
def test_flash_bwd_plan_fits_and_covers(bwd_plan, D):
    """Each width the wrapper sends to the backward's tensor-core form:
    both kernels in 227 KB of shared memory (K, V and two stages of Q,
    dout, lse and delta; Q, dout and two stages of K and V; the shared
    bf16 logits where split), at most 255 registers a thread of
    accumulators and logits, the width's columns exactly covered by whole
    64-column boxes and by the two warpgroups' accumulators (each all of
    them up to 128, half past it), D / 16 k-steps covering D, each step's
    logit columns covering the other tile's rows, and the tiles
    ``TC_BWD_TILES`` reports (so the head splits the wrapper picks count
    the CTAs the kernel launches)."""
    p = bwd_plan[D]
    assert p["ok"] and p["stages"] >= 2, p
    assert p["kv_smem"] <= 227 * 1024 and p["q_smem"] <= 227 * 1024, p
    assert p["kv_regs"] <= 255 and p["q_regs"] <= 255, p
    # the counts the registers stand for: dk and dv, S^T and dP^T; dq, S, dP
    assert p["kv_regs"] == 2 * p["acc_cols"] // 2 + 2 * p["kv_logit_cols"] // 2
    assert p["q_regs"] == p["acc_cols"] // 2 + 2 * p["q_logit_cols"] // 2
    padded = p["padded"]
    assert padded % 64 == 0 and D <= padded < D + 64 and D % 16 == 0, p
    owners = np.zeros(padded, np.int64)
    for wg in range(2):
        lo = wg * p["acc_cols"] if p["split"] else 0
        owners[lo:lo + p["acc_cols"]] += 1
    assert (owners == (1 if p["split"] else 2)).all(), p
    assert p["split"] == (padded > 128)
    for rows, cols in ((p["kv_rows"], p["kv_logit_cols"]),
                       (p["q_keys"], p["q_logit_cols"])):
        assert cols * (2 if p["split"] else 1) == rows and cols % 16 == 0, p
    # a warpgroup's 64 accumulator rows: its own 64 keys / q rows, or the
    # tile's 64 shared by both where split
    assert p["kv_keys"] == p["q_rows"] == (64 if p["split"] else 128), p
    assert (p["kv_keys"], p["kv_rows"], p["q_rows"], p["q_keys"]) == \
        FA.TC_BWD_TILES[D]
    assert p["seq_pad"] == FA.TC_BWD_SEQ_PAD
    assert p["seq_pad"] % max(p["kv_rows"], p["q_rows"]) == 0
    smem = (2 * p["kv_keys"] * padded * 2 + p["stages"] * (
        2 * p["kv_rows"] * padded * 2 + 2 * p["kv_rows"] * 4)
        + (2 * 64 * 64 * 2 if p["split"] else 0) + 1024)
    assert p["kv_smem"] == smem, p


def test_flash_bwd_plan_refuses_other_widths(bwd_plan):
    """Widths off the forward's tensor-core grid are not the backward's
    either, and those it takes are the forward's."""
    for D, p in bwd_plan.items():
        if p["ok"]:
            assert D % 16 == 0 and p["padded"] <= 256, (D, p)
    for D in (8, 100):
        assert not bwd_plan[D]["ok"], D


@pytest.mark.parametrize("tiling", sorted(TILINGS))
@pytest.mark.parametrize("group", sorted(MASKS))
def test_flash_tiles_match_brute_force(tiles_exe, group, tiling):
    bq, bk, sub = TILINGS[tiling]
    cases = MASKS[group]
    raw = _run(tiles_exe, [c + (bq, bk, sub) for c in cases])
    out = np.frombuffer(raw, np.int32)
    pos = 0
    for Sq, Sk, causal, window, q_offset in cases:
        n_kt = -(-Sk // bk)
        for q0 in range(0, Sq, bq):
            kt0, kt1 = out[pos], out[pos + 1]
            pos += 2
            rows = np.arange(q0, q0 + bq)
            qp = rows[:, None] + q_offset
            kp = np.arange(n_kt * bk)[None, :]
            att = (kp < Sk) & (qp > -(1 << 30))  # (rows, keys)
            if causal:
                att = att & (kp <= qp)
            if window > 0:
                att = att & (kp > qp - window)
            real = rows < Sq  # rows past Sq are never written
            visited = np.zeros(n_kt, bool)
            visited[kt0:kt1] = True
            for kt in range(n_kt):
                if not visited[kt]:
                    assert not att[real, kt * bk:(kt + 1) * bk].any(), (
                        f"{(Sq, Sk, causal, window, q_offset)} q0={q0}: "
                        f"skipped key tile {kt} holds attended keys")
            if not visited.all():  # exact only if every row has a key
                assert att[real].any(axis=1).all()
            for s0 in range(q0, q0 + bq, sub):
                blk = att[s0 - q0:s0 - q0 + sub]
                for kt in range(n_kt):
                    masked = out[pos]
                    pos += 1
                    full = blk[:, kt * bk:(kt + 1) * bk].all()
                    assert bool(masked) == (not full), (
                        f"{(Sq, Sk, causal, window, q_offset)} rows "
                        f"{s0}..{s0 + sub - 1} key tile {kt}: masked="
                        f"{masked}, every pair attended={full}")
    assert pos == len(out)


def _registered_layers():
    """(name, cell, H, d_out, G, proj) of every registered recurrent
    stack's layers, full and smoke."""
    out = []
    for arch in ("lstm-rnnt", "gru-rnnt"):
        for smoke in (False, True):
            cfg = get_config(arch, smoke=smoke)
            cell = lstm_lm.rnn_cell(cfg)
            lc = lstm_lm.layer_cfgs(cfg)[0]
            G = 3 if cell == "gru" else len(lc.variant.gates)
            proj = cell == "lstm" and lc.variant.use_projection
            out.append((cfg.name, cell, lc.d_hidden, lc.d_output, G, proj))
    return out


# batch rows the port runs the kernels at: the serve and engine defaults
# (4, 8 slots), the chip checks (1, 4, 16, 64); the SM counts of an H100
# (132) and of a smaller part
BATCHES = (1, 4, 8, 16, 64)
N_SMS = (132, 114)
# shapes beside the registered ones: every LSTM variant's gate count, H
# that the split leaves ragged, the chip checks' small widths
EXTRA = [("lstm", 13, 6, 4, True), ("lstm", 40, 40, 3, False),
         ("lstm", 48, 10, 4, True), ("gru", 13, 13, 3, False),
         ("lstm", 1001, 333, 4, True), ("gru", 1001, 1001, 3, False),
         ("lstm", 2047, 2047, 4, False), ("lstm", 131, 7, 3, True)]


@pytest.fixture(scope="module")
def plan_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "scan_plan", PLAN_PROGRAM)


def _header_plans(exe, shapes):
    rows = [(0 if cell == "lstm" else 1, H, d, G, B, int(proj), n_sm)
            for cell, H, d, G, B, proj, n_sm in shapes]
    return np.frombuffer(_run(exe, rows), np.int64).reshape(-1, 6)


@pytest.mark.parametrize("source", ["registered", "extra"])
def test_scan_plan_header_covers_and_fits(plan_exe, source):
    layers = ([row[1:] for row in _registered_layers()]
              if source == "registered" else EXTRA)
    shapes = [(cell, H, d, G, B, proj, n_sm) for cell, H, d, G, proj in layers
              for B in BATCHES for n_sm in N_SMS]
    got = _header_plans(plan_exe, shapes)
    for (cell, H, d, G, B, proj, n_sm), (err, u, nb, rg, smem, ws) in zip(
            shapes, got):
        assert err == 0, (cell, H, d, G, B, proj, n_sm)
        assert nb <= min(H, n_sm) and smem <= 232448 and ws > 0
        assert 1 <= rg <= B
        owner = np.zeros(H, np.int64)
        for n in range(nb):
            lo, hi = n * u, min((n + 1) * u, H)
            assert hi > lo  # no CTA idles
            owner[lo:hi] += 1
        assert (owner == 1).all()  # every unit, exactly once


@pytest.mark.parametrize("layer", [
    ("gru", 2048, 2048, 3, False),  # gru-rnnt: h rows beside 110 KB of R_cat
    ("lstm", 2048, 640, 4, True),  # lstm-rnnt: m rows beside R_cat, W_proj
], ids=["gru-full", "lstm-full"])
def test_scan_plan_groups_rows_for_any_batch(plan_exe, layer):
    """Where all rows fit beside the weights they make one group; past
    that, they pass in groups of a multiple of 16, and a CTA's shared
    memory stays the same however many rows there are."""
    cell, H, d, G, proj = layer
    batches = (1, 16, 32, 40, 48, 64, 100, 256, 4096)
    got = _header_plans(plan_exe, [(cell, H, d, G, B, proj, 132)
                                   for B in batches])
    assert (got[:, 0] == 0).all()
    rgs, smems = got[:, 3], got[:, 4]
    assert (smems <= 232448).all()
    most = rgs[-1]
    assert 16 <= most < 4096 and most % 16 == 0
    for B, rg, smem in zip(batches, rgs, smems):
        assert rg == B or (rg == most and smem == smems[-1]), (B, rg, smem)
    assert got[batches.index(64), 3] < 64  # 64 rows take two groups


@pytest.mark.parametrize("shape", [
    ("lstm", 2048, 8192, 4, 1, True, 132),  # one 8 KB h row beside 590 KB
    ("gru", 8192, 8192, 3, 1, False, 132),  # 1.5 MB of R_cat a CTA
    ("lstm", 2048, 640, 4, 1, True, 8),  # too few SMs to spread it over
    ("lstm", 0, 640, 4, 1, True, 132),  # not a layer
    ("gru", 64, 64, 3, 1, True, 132),  # a GRU has no projection
], ids=["lstm-d8192", "gru-H8192", "lstm-8-SMs", "H0", "gru-proj"])
def test_scan_plan_refuses_what_cannot_fit(plan_exe, shape):
    (err, *_), = _header_plans(plan_exe, [shape])
    assert err != 0
