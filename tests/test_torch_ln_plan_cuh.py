"""The row kernels' plan and gate prologue, compiled for the host.

``src/repro_torch/csrc/ln_plan.cuh`` (how the gate pass, the TPU-contract
LayerNorm and the cell's in-fusion LN split each row over a thread-block
cluster, and how the elementwise cell covers (B, H)) and the gate prologue
of ``lstm_cell.cuh`` (``cell::gate_preact``) are valid host C++.  g++
compiles a small program around them, as ``test_torch_kernel_plans_cuh.py``
does for the other kernels' plans:

* the row plan, walked as the kernels walk it (CTA rank r of the cluster
  owns its column slice, thread t its columns t, t + threads, ...), covers
  every (row, gate, column) exactly once with no CTA idle, keeps every
  column inside the CTA's shared slice, fits shared memory and threads at
  every n = 1..16384, caps the cluster at 8, and reaches the main paths'
  shapes (16 clusters of 8 CTAs for the gate pass at B 4, G 4, n 2048);
  the chip checks' shapes split a row over every cluster size 1..8;
* the elementwise plan covers every element of (B, H) once;
* the prologue equals ``ref.lstm_gate_acc`` (the plain versions'
  prologue, held to the JAX reference by ``test_torch_gate_pass.py``) on
  random and int32-extreme accumulators, with and without the i/f
  peephole, and ignores the peephole for the o gate.
"""
import shutil
import subprocess
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

PLAN_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

#include "ln_plan.cuh"

// in: n, then n x (rows, G, cols, n_sm, slices, walk) int32
// out per case: err, C, W, threads, smem, ctas, then with walk: the fewest
// and most visits of a column, CTAs without columns, columns past the
// CTA's shared slice (int64)
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t c[6];
    if (fread(c, 4, 6, stdin) != 6) return 1;
    const lnp::Plan p = lnp::plan(c[0], c[1], c[2], c[3], c[4]);
    int64_t r[10] = {p.err, p.C, p.W, p.threads, p.smem, p.ctas, -1, -1, -1, -1};
    if (c[5] && p.err == 0) {
      const int cols = c[2];
      std::vector<int> seen(cols, 0);
      int64_t idle = 0, outside = 0;
      for (int rank = 0; rank < p.C; ++rank) {  // one row: all are alike
        const int lo = lnp::slice_lo(p, rank), hi = lnp::slice_hi(p, rank, cols);
        if (hi <= lo) ++idle;
        for (int t = 0; t < p.threads; ++t)
          for (int j = lo + t; j < hi; j += p.threads) {
            if (j - lo >= p.W) ++outside;
            ++seen[j];
          }
      }
      int64_t lo = 1 << 30, hi = 0;
      for (int v : seen) {
        lo = v < lo ? v : lo;
        hi = v > hi ? v : hi;
      }
      r[6] = lo;
      r[7] = hi;
      r[8] = idle;
      r[9] = outside;
    }
    fwrite(r, 8, 10, stdout);
  }
  return 0;
}
"""

EW_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

#include "ln_plan.cuh"

// in: n, then n x (B, H) int32; out: err, threads, ctas, and the fewest
// and most visits of an element (int64)
int main() {
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t c[2];
    if (fread(c, 4, 2, stdin) != 2) return 1;
    const lnp::EwPlan p = lnp::ew_plan(c[0], c[1]);
    int64_t r[5] = {p.err, p.threads, p.ctas, -1, -1};
    if (p.err == 0) {
      const int B = c[0], H = c[1];
      std::vector<int> seen((size_t)B * H, 0);
      for (long long g = 0; g < p.ctas * p.threads; ++g)  // the kernel's walk
        if (g < (long long)B * H) ++seen[g / H * H + g % H];
      int64_t lo = 1 << 30, hi = 0;
      for (int v : seen) {
        lo = v < lo ? v : lo;
        hi = v > hi ? v : hi;
      }
      r[3] = lo;
      r[4] = hi;
    }
    fwrite(r, 8, 5, stdout);
  }
  return 0;
}
"""

PROLOGUE_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

#include "lstm_cell.cuh"

// in: N, the 7 ints of a cell::GateScale, then acc_x, acc_h (int32 N),
// p, c (int16 N); out: gate_preact per element (int32 N)
int main() {
  int32_t n, s[7];
  if (fread(&n, 4, 1, stdin) != 1 || fread(s, 4, 7, stdin) != 7) return 1;
  std::vector<int32_t> ax(n), ah(n), out(n);
  std::vector<int16_t> p(n), c(n);
  if (fread(ax.data(), 4, n, stdin) != (size_t)n ||
      fread(ah.data(), 4, n, stdin) != (size_t)n ||
      fread(p.data(), 2, n, stdin) != (size_t)n ||
      fread(c.data(), 2, n, stdin) != (size_t)n)
    return 1;
  const cell::GateScale sc = {s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  for (int i = 0; i < n; ++i) out[i] = cell::gate_preact(sc, ax[i], ah[i], p[i], c[i]);
  fwrite(out.data(), 4, n, stdout);
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


def _run(exe, rows, width):
    blob = np.array([len(rows)], np.int32).tobytes() + np.array(
        rows, np.int32).tobytes()
    out = subprocess.run([str(exe)], input=blob, capture_output=True,
                         check=True, timeout=120).stdout
    return np.frombuffer(out, np.int64).reshape(-1, width)


@pytest.fixture(scope="module")
def plan_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "ln_plan", PLAN_PROGRAM)


# (rows, G) the kernels are launched at: the gate pass at the serving batch
# (4: lstm-rnnt, G 4; a CIFG layer, G 3) and the chip checks' batches, the
# TPU-contract LayerNorm and the cell's o-gate LN (G 1)
UNITS = ((4, 4), (4, 3), (8, 4), (16, 4), (64, 4), (4, 1), (1, 1), (16, 1))
SLICES = (1, 2)  # the gate pass and TPU-contract LN; the cell's LN form
WALK_NS = sorted(set(range(1, 520)) | {1001, 1023, 1024, 1025, 2047, 2048,
                                       2049, 3000, 4095, 4096, 8191, 8192,
                                       12345, 16383, 16384})


@pytest.mark.parametrize("units", UNITS, ids=lambda u: f"rows{u[0]}xG{u[1]}")
def test_row_plan_covers_each_column_once(plan_exe, units):
    rows, G = units
    cases = [(rows, G, n, 132, sl, 1) for n in WALK_NS for sl in SLICES]
    got = _run(plan_exe, cases, 10)
    for (_, _, n, _, sl, _), r in zip(cases, got):
        err, C, W, threads, smem, ctas, lo, hi, idle, outside = r
        assert err == 0, (rows, G, n, sl)
        assert 1 <= C <= 8 and C == -(-n // W)
        assert 32 <= threads <= 512 and threads % 32 == 0
        assert smem == 2 * sl * W <= 232448 and ctas == rows * G * C
        assert (lo, hi, idle, outside) == (1, 1, 0, 0), (rows, G, n, sl, r)


def test_row_plan_fits_every_length(plan_exe):
    """n = 1..16384 at the serving batch and at a batch that fills the card
    with one CTA a row, for either kernel's shared slices: no refusal, the
    shared memory within an SM's, the cluster within 8; longer rows and
    bad shapes are refused."""
    cases = [(rows, 4, n, 132, sl, 0) for n in range(1, 16385)
             for rows in (4, 132) for sl in SLICES]
    got = _run(plan_exe, cases, 10)
    assert (got[:, 0] == 0).all()
    assert (got[:, 1] <= 8).all() and (got[:, 4] <= 232448).all()
    assert (got[:, 3] <= 512).all()
    bad = [(4, 4, 16385, 132, 1, 0), (4, 4, 0, 132, 1, 0),
           (4, 5, 64, 132, 1, 0), (0, 4, 64, 132, 1, 0),
           (4, 4, 64, 132, 0, 0), (4, 4, 64, 132, 3, 0),
           (4, 4, 64, 0, 1, 0)]
    assert (_run(plan_exe, bad, 10)[:, 0] != 0).all()


def test_row_plan_reaches_the_main_paths(plan_exe):
    """The gate pass of a full-width lstm-rnnt step (B 4, G 4, H 2048) is
    16 rows of 8 CTAs; the cell's o-gate LN and the TPU-contract LN at B 4
    are 4 rows of 8; a wide batch fills the card with smaller clusters; a
    short row is not split."""
    shapes = [(4, 4, 2048, 132, 1, 0), (4, 1, 2048, 132, 2, 0),
              (64, 4, 2048, 132, 1, 0), (4, 4, 12, 132, 1, 0)]
    got = _run(plan_exe, shapes, 10)
    C, ctas = got[:, 1], got[:, 5]
    assert (C[0], ctas[0]) == (8, 128)
    assert (C[1], ctas[1]) == (8, 32)
    assert (C[2], ctas[2]) == (1, 256)
    assert C[3] == 1


def test_check_cases_reach_every_cluster_size(plan_exe):
    """The chip checks' step cases (``kernel_cases.step_cases``: the LN
    layers at ``STEP_SHAPES``, G 3 under CIFG and 4 otherwise, and the LN +
    peephole layer at ``CLUSTER_SHAPES``) split a row over every cluster
    size 1..8 in the gate pass and in the cell's LN form, and at
    ``CLUSTER_SHAPES``' widest batch the cell's two slices of a whole
    16384-column row pass the default 48 KiB of shared memory."""
    from repro_torch.testing import kernel_cases as KC

    gate = [(B, G, H, 132, 1, 0) for B, H in KC.STEP_SHAPES for G in (3, 4)]
    gate += [(B, 4, H, 132, 1, 0) for B, H in KC.CLUSTER_SHAPES]
    cell = [(B, 1, H, 132, 2, 0)
            for B, H in KC.STEP_SHAPES + KC.CLUSTER_SHAPES]
    assert set(_run(plan_exe, gate, 10)[:, 1]) == set(range(1, 9))
    got = _run(plan_exe, cell, 10)
    assert set(got[:, 1]) == set(range(1, 9))
    assert got[:, 4].max() == 2 * 2 * 16384 > 48 * 1024


@pytest.fixture(scope="module")
def ew_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "ew_plan", EW_PROGRAM)


def test_elementwise_plan_covers_each_element_once(ew_exe):
    cases = [(B, H) for B in (1, 4, 8, 16, 64)
             for H in (1, 7, 12, 37, 256, 1001, 1024, 2048)]
    got = _run(ew_exe, cases, 5)
    for (B, H), (err, threads, ctas, lo, hi) in zip(cases, got):
        assert err == 0
        assert (lo, hi) == (1, 1), (B, H)
        assert ctas * threads >= B * H
    assert (_run(ew_exe, [(0, 64), (4, 0)], 5)[:, 0] != 0).all()


@pytest.fixture(scope="module")
def prologue_exe(tmp_path_factory):
    return _compile(tmp_path_factory, "gate_prologue", PROLOGUE_PROGRAM)


@pytest.mark.parametrize("gate,peephole", [("f", True), ("i", False),
                                           ("o", True), ("z", False)])
def test_gate_prologue_equals_plain(prologue_exe, gate, peephole):
    from repro_torch.core import fixedpoint as tfp
    from repro_torch.kernels import int_layernorm as tln
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(len(gate) + 2 * peephole)
    B, H = 6, 777
    ax = rng.integers(-(2**31), 2**31, (B, H)).astype(np.int32)
    ah = rng.integers(-(2**24), 2**24, (B, H)).astype(np.int32)
    ax[0, ::2], ax[0, 1::2] = 2**31 - 1, -(2**31)
    ah[1], ax[1] = -(2**31), -(2**31)
    p = rng.integers(-32768, 32768, H).astype(np.int16)
    c = rng.integers(-32768, 32768, (B, H)).astype(np.int16)
    c[2] = -32768
    p[:3] = (-32768, 32767, 0)
    gs = types.SimpleNamespace(
        eff_x=tfp.quantize_multiplier(float(rng.uniform(1e-6, 1e-3))),
        eff_h=tfp.quantize_multiplier(float(rng.uniform(1e-4, 2.0))),
        eff_c=(tfp.quantize_multiplier(float(rng.uniform(1e-3, 4.0)))
               if peephole else None))
    spec = types.SimpleNamespace(cfg_d_hidden=H, gate_spec=lambda g: gs)
    vals = {"P": {gate: torch.from_numpy(p)}}
    scale = tln.gate_scale(spec, gate)
    assert scale[-1] == int(peephole and gate != "o")
    blob = b"".join([np.array([B * H, *scale], np.int32).tobytes(),
                     ax.tobytes(), ah.tobytes(),
                     np.tile(p, (B, 1)).tobytes(),
                     c.tobytes()])
    raw = subprocess.run([str(prologue_exe)], input=blob,
                         capture_output=True, check=True, timeout=120).stdout
    got = np.frombuffer(raw, np.int32).reshape(B, H)
    want = tref.lstm_gate_acc(vals, spec, 0, gate, torch.from_numpy(ax),
                              torch.from_numpy(ah), torch.from_numpy(c))
    np.testing.assert_array_equal(got, want.numpy())
