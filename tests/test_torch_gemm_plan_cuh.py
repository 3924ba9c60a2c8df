"""The int8 GEMM's plan and shared-memory layout, compiled for the host.

``src/repro_torch/csrc/gemm_plan.cuh`` (kernel 1: which form, tile, split
of K and shared memory a launch takes, and where each byte of a stage sits)
is valid host C++.  g++ compiles one small program around it, once for the
module, as ``test_torch_kernel_plans_cuh.py`` does for kernels 4 and 5:

* the plan, over the main paths' shapes and a ragged sweep: every output
  element lies in exactly one tile, every step of K in exactly one split
  and every element of a tile in exactly one CTA's share of the epilogue;
  shared memory fits an SM, a cluster holds at most 8 CTAs, the
  weight-streaming form takes M <= 32 and puts a CTA on every SM at the
  serving shapes; shapes it cannot take are refused;
* the card's exactness cases (``repro_torch.testing.gemm_checks``) reach
  every (instance, split) pair the plan picks over a wide sweep on a
  132-SM card, each epilogue under a split, the byte copies of both forms
  and the M at the forms' edges;
* one stage of every kernel instance, replayed on the host: x and w stored
  at the header's offsets (a bijection onto the slabs), every lane's
  ldmatrix addresses, the transposing ldmatrix over column pairs and
  ``pack::split_pairs``, mma.sync m16n8k32 as the PTX ISA lays out its
  fragments, and the partial tile stored at ``frag_row`` / ``frag_col``,
  held equal to the int8 product; and the 8 rows of each ldmatrix phase on
  distinct 16-byte bank groups (2-way at most in the 32-column tile).
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.testing import gemm_checks  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"
SMEM_MAX = 232448
N_SM = 132

PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "gemm_plan.cuh"
#include "int8_pack.cuh"

// ldmatrix.x4 (.b16) as the PTX ISA defines it: lane t gives the address
// of row t % 8 of matrix t / 8; without .trans lane t receives row t / 4,
// elements 2 (t % 4) and 2 (t % 4) + 1 of each matrix; with .trans the
// elements (2 (t % 4), t / 4) and (2 (t % 4) + 1, t / 4).  Returns the
// worst bank-group collision of a phase (8 rows of 16 bytes).
static int ldsm(const uint8_t* sm, const int addr[32], bool trans,
                uint32_t out[32][4]) {
  int worst = 1;
  for (int q = 0; q < 4; ++q) {
    int seen[8] = {0};
    for (int r = 0; r < 8; ++r) {
      const int bank = (addr[8 * q + r] / 16) % 8;
      if (++seen[bank] > worst) worst = seen[bank];
    }
  }
  for (int t = 0; t < 32; ++t)
    for (int q = 0; q < 4; ++q) {
      const uint8_t* b0;
      const uint8_t* b1;
      if (!trans) {
        b0 = sm + addr[8 * q + t / 4] + 4 * (t % 4);
        b1 = b0 + 2;
      } else {
        b0 = sm + addr[8 * q + 2 * (t % 4)] + 2 * (t / 4);
        b1 = sm + addr[8 * q + 2 * (t % 4) + 1] + 2 * (t / 4);
      }
      out[t][q] = (uint32_t)b0[0] | (uint32_t)b0[1] << 8 |
                  (uint32_t)b1[0] << 16 | (uint32_t)b1[1] << 24;
    }
  return worst;
}

static int8_t byte_of(uint32_t w, int j) { return (int8_t)(w >> (8 * j)); }

// mma.sync.m16n8k32.row.col.s32.s8.s8.s32: lane (g, t4) = (t / 4, t % 4)
// holds A rows g, g + 8 at k 4 t4.. (a0, a1) and 16 + 4 t4.. (a2, a3),
// B column g at k 4 t4.. (b0) and 16 + 4 t4.. (b1), C rows g, g + 8 at
// columns 2 t4, 2 t4 + 1.
static void mma(const uint32_t a[32][4], const int b[32][2], int c[32][4]) {
  int A[16][32], B[32][8];
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, t4 = t % 4;
    for (int j = 0; j < 4; ++j) {
      A[g][4 * t4 + j] = byte_of(a[t][0], j);
      A[g + 8][4 * t4 + j] = byte_of(a[t][1], j);
      A[g][16 + 4 * t4 + j] = byte_of(a[t][2], j);
      A[g + 8][16 + 4 * t4 + j] = byte_of(a[t][3], j);
      B[4 * t4 + j][g] = byte_of((uint32_t)b[t][0], j);
      B[16 + 4 * t4 + j][g] = byte_of((uint32_t)b[t][1], j);
    }
  }
  for (int t = 0; t < 32; ++t) {
    const int g = t / 4, t4 = t % 4;
    for (int i = 0; i < 4; ++i) {
      const int row = g + 8 * (i / 2), col = 2 * t4 + i % 2;
      int s = 0;
      for (int k = 0; k < 32; ++k) s += A[row][k] * B[k][col];
      c[t][i] += s;
    }
  }
}

// One stage of instance `ti` with random x and w: returns mismatches of the
// partial tile against the product, layout errors, and the worst bank
// collisions of the A and B phases.
static void replay(int ti, unsigned seed, long long res[4]) {
  const gemm::Tile tl = gemm::kTiles[ti];
  const int BM = tl.bm, BN = tl.bn, WM = tl.wm, WN = tl.wn;  // the multiplying warps
  const int MT = BM / WM / 16, NC = BN / WN / 16;
  srand(seed);
  std::vector<int8_t> X(BM * gemm::kBK), W(gemm::kBK * BN);
  for (auto& v : X) v = (int8_t)(rand() % 256 - 128);
  for (auto& v : W) v = (int8_t)(rand() % 256 - 128);
  const int kA = BM * gemm::kBK, stage = gemm::stage_bytes(BM, BN);
  std::vector<uint8_t> sm(stage, 0);
  std::vector<int> hits(stage, 0);
  long long layout_err = 0;
  for (int r = 0; r < BM; ++r)
    for (int kb = 0; kb < gemm::kBK; ++kb) {
      const int o = gemm::a_offset(r, kb >> 4) + (kb & 15);
      if (o < 0 || o >= kA) { ++layout_err; continue; }
      sm[o] = (uint8_t)X[r * gemm::kBK + kb];
      ++hits[o];
    }
  for (int k = 0; k < gemm::kBK; ++k)
    for (int n = 0; n < BN; ++n) {
      const int o = kA + gemm::b_offset(k, n >> 4, BN) + (n & 15);
      if (o < kA || o >= stage) { ++layout_err; continue; }
      sm[o] = (uint8_t)W[k * BN + n];
      ++hits[o];
    }
  for (int h : hits) layout_err += h != 1;
  std::vector<int32_t> red(BM * BN, 0);
  int worst_a = 1, worst_b = 1;
  for (int warp = 0; warp < WM * WN; ++warp) {
    const int wr = (warp / WN) * (BM / WM), wc = (warp % WN) * NC;
    std::vector<int> acc(MT * NC * 2 * 32 * 4, 0);
    auto at = [&](int mt, int nc, int tile) { return &acc[((mt * NC + nc) * 2 + tile) * 128]; };
    for (int kk = 0; kk < gemm::kBK; kk += 32) {
      std::vector<uint32_t> af(MT * 128);
      for (int mt = 0; mt < MT; ++mt) {
        int addr[32];
        for (int t = 0; t < 32; ++t) addr[t] = gemm::a_lane_offset(t, wr + 16 * mt, kk);
        uint32_t out[32][4];
        const int w = ldsm(sm.data(), addr, false, out);
        if (w > worst_a) worst_a = w;
        memcpy(&af[mt * 128], out, sizeof(out));
      }
      for (int nc = 0; nc < NC; ++nc) {
        int addr[32];
        for (int t = 0; t < 32; ++t) addr[t] = kA + gemm::b_lane_offset(t, kk, wc + nc, BN);
        uint32_t r[32][4];
        const int w = ldsm(sm.data(), addr, true, r);
        if (w > worst_b) worst_b = w;
        int b[2][32][2];
        for (int t = 0; t < 32; ++t) {
          int lo[2], hi[2];
          pack::split_pairs((int)r[t][0], (int)r[t][1], lo);
          pack::split_pairs((int)r[t][2], (int)r[t][3], hi);
          for (int tile = 0; tile < 2; ++tile) {
            b[tile][t][0] = lo[tile];
            b[tile][t][1] = hi[tile];
          }
        }
        for (int mt = 0; mt < MT; ++mt)
          for (int tile = 0; tile < 2; ++tile)
            mma(reinterpret_cast<const uint32_t(*)[4]>(&af[mt * 128]), b[tile],
                reinterpret_cast<int(*)[4]>(at(mt, nc, tile)));
      }
    }
    for (int mt = 0; mt < MT; ++mt)
      for (int nc = 0; nc < NC; ++nc)
        for (int t = 0; t < 32; ++t)
          for (int h = 0; h < 2; ++h) {
            const int* t0 = at(mt, nc, 0) + 4 * t;
            const int* t1 = at(mt, nc, 1) + 4 * t;
            const int v[4] = {t0[2 * h], t1[2 * h], t0[2 * h + 1], t1[2 * h + 1]};
            const int row = gemm::frag_row(t, wr + 16 * mt, h);
            const int col = gemm::frag_col(t, wc + nc);
            for (int e = 0; e < 4; ++e) red[row * BN + col + e] += v[e];
          }
  }
  long long bad = 0;
  for (int r = 0; r < BM; ++r)
    for (int n = 0; n < BN; ++n) {
      int s = 0;
      for (int k = 0; k < gemm::kBK; ++k) s += X[r * gemm::kBK + k] * W[k * BN + n];
      bad += red[r * BN + n] != s;
    }
  res[0] = bad;
  res[1] = layout_err;
  res[2] = worst_a;
  res[3] = worst_b;
}

// stdin: mode 0: n, n x (M, N, K, n_sm) -> per shape 12 plan fields, the
// split boundaries of K's steps (9, -1 past split) and of the first
// tile's epilogue shares (9), and the pieces piece_owner misplaces;
// mode 1: -> per instance 4 replay results.
int main() {
  int32_t mode;
  if (fread(&mode, 4, 1, stdin) != 1) return 1;
  if (mode == 1) {
    for (int ti = 0; ti < gemm::kNumTiles; ++ti) {
      long long res[4];
      replay(ti, 1234u + ti, res);
      fwrite(res, 8, 4, stdout);
    }
    return 0;
  }
  int32_t n;
  if (fread(&n, 4, 1, stdin) != 1) return 1;
  for (int i = 0; i < n; ++i) {
    int32_t c[4];
    if (fread(c, 4, 4, stdin) != 4) return 1;
    const gemm::Plan p = gemm::plan(c[0], c[1], c[2], c[3]);
    long long r[31];
    const long long f[12] = {p.err, p.form, p.tile, p.bm, p.bn, p.threads,
                             p.tiles_m, p.tiles_n, p.split, p.steps,
                             p.stages, p.smem};
    for (int j = 0; j < 12; ++j) r[j] = f[j];
    const int rows = p.bm && c[0] < p.bm ? c[0] : p.bm;
    // pieces of the first tile whose piece_owner is not the CTA whose
    // epilogue share holds them
    long long owner_err = 0;
    const int pieces = rows * (p.bn / 4);
    for (int e = 0; p.err == 0 && e < pieces; ++e) {
      const int q = gemm::piece_owner(e, pieces, p.split);
      owner_err += !(q >= 0 && q < p.split && gemm::split_lo(q, pieces, p.split) <= e &&
                     e < gemm::split_lo(q + 1, pieces, p.split));
    }
    r[30] = owner_err;
    for (int j = 0; j < 9; ++j) {
      const bool in = p.err == 0 && j <= p.split;
      r[12 + j] = in ? gemm::split_lo(j, p.steps, p.split) : -1;
      r[21 + j] = in ? gemm::split_lo(j, rows * (p.bn / 4), p.split) : -1;
    }
    fwrite(r, 8, 31, stdout);
  }
  return 0;
}
"""

FIELDS = ("err", "form", "tile", "bm", "bn", "threads", "tiles_m", "tiles_n",
          "split", "steps", "stages", "smem")
STREAM, TENSOR = 0, 1

# (M, N, K): what the main paths launch.  lstm-rnnt: the hoisted input
# stages (layer 0 K 2048, then K 640) at the static prefill (M 128), decode
# and stepwise (4) and engine chunk (16); the stepwise recurrent product
# (K 640) and projection (N 640).  gru-rnnt: N 6144, K 2048, with the
# speculative verify block (20).
SKINNY = [(4, 8192, 2048), (4, 8192, 640), (4, 640, 2048), (4, 6144, 2048),
          (16, 8192, 2048), (16, 8192, 640), (16, 6144, 2048),
          (20, 6144, 2048)]
WIDE = [(128, 8192, 2048), (128, 8192, 640), (128, 6144, 2048)]
SWEEP = [(m, n, k) for m in (1, 3, 16, 17, 20, 32, 33, 64, 65, 128, 129, 1000,
                             4096)
         for n in (1, 5, 61, 100, 640, 6144, 8191, 8192)
         for k in (0, 1, 37, 64, 99, 641, 2047, 2048)]


@pytest.fixture(scope="module")
def exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    work = tmp_path_factory.mktemp("gemm_plan")
    (work / "gemm_plan.cpp").write_text(PROGRAM)
    out = work / "gemm_plan"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}", "-o", str(out),
                    str(work / "gemm_plan.cpp")], check=True, timeout=120)
    return out


def _run(exe, words):
    return subprocess.run([str(exe)], input=np.array(words, np.int32).tobytes(),
                          capture_output=True, check=True, timeout=120).stdout


def _plans(exe, shapes):
    rows = [w for M, N, K, n_sm in shapes for w in (M, N, K, n_sm)]
    raw = np.frombuffer(_run(exe, [0, len(shapes)] + rows),
                        np.int64).reshape(-1, 31)
    return [(dict(zip(FIELDS, r[:12]), owner_err=r[30]), r[12:21], r[21:30])
            for r in raw]


def _check_plan(shape, plan, k_bounds, e_bounds):
    M, N, K, n_sm = shape
    p = plan
    assert p["err"] == 0, shape
    bm, bn, split, steps = p["bm"], p["bn"], p["split"], p["steps"]
    # every output element in exactly one tile: the tiles cover M x N and
    # none lies wholly outside it
    assert p["tiles_m"] * bm >= M > (p["tiles_m"] - 1) * bm, (shape, p)
    assert p["tiles_n"] * bn >= N > (p["tiles_n"] - 1) * bn, (shape, p)
    assert p["tiles_m"] <= 65535 and p["tiles_n"] <= 65535
    # every step of K in exactly one split, no split empty (K = 0: one)
    assert steps == -(-K // 64)
    assert 1 <= split <= 8 and (split == 1 or split <= steps), (shape, p)
    kb = list(k_bounds[:split + 1])
    assert kb[0] == 0 and kb[-1] == steps and (k_bounds[split + 1:] == -1).all()
    assert all(b > a for a, b in zip(kb, kb[1:])) or steps == 0, (shape, kb)
    # every element of a tile reduced by exactly one CTA of its cluster
    rows = min(M, bm)
    eb = list(e_bounds[:split + 1])
    assert eb[0] == 0 and eb[-1] == rows * bn // 4
    assert all(b >= a for a, b in zip(eb, eb[1:]))
    assert p["owner_err"] == 0  # each piece pushed to the CTA that sums it
    # the ring, the epilogue's vectors and (split) the receive buffer fit
    recv = split * -(-(bm * bn // 4) // split) * 16 if split > 1 else 0
    assert p["smem"] == p["stages"] * (bm * 64 + 64 * bn) + 12 * bn + recv
    assert p["smem"] <= SMEM_MAX and p["stages"] >= 2
    # every CTA resident at once, with a spare slot an SM under a cluster,
    # unless the ring is already at its least depth
    ctas = p["tiles_m"] * p["tiles_n"] * split
    per_sm = -(-ctas // n_sm) + (split > 1)
    assert p["stages"] == 2 or per_sm * (p["smem"] + 1024) <= 233472
    # 2, 4 or 8 warps (weight-streaming), 8 + 4 that only copy (tensor-core)
    assert p["threads"] in ((64, 128, 256) if M <= 32 else (384,))
    # the form follows M; x is padded to 16 or 32 rows (weight-streaming),
    # 64 or 128 (tensor-core, K never split)
    if M <= 32:
        assert p["form"] == STREAM and bm == (16 if M <= 16 else 32)
    else:
        assert p["form"] == TENSOR and bm == (64 if M <= 128 else 128)
        assert bn == 128 and split == 1


@pytest.mark.parametrize("group", ["main path", "ragged sweep"])
def test_gemm_plan_covers_and_fits(exe, group):
    base = SKINNY + WIDE if group == "main path" else SWEEP
    shapes = [(M, N, K, n_sm) for M, N, K in base for n_sm in (N_SM, 114, 8)]
    for shape, (plan, kb, eb) in zip(shapes, _plans(exe, shapes)):
        _check_plan(shape, plan, kb, eb)


def test_gemm_plan_fills_the_card_at_decode_shapes(exe):
    """The weight-streaming form puts at least one CTA on each of the 132
    SMs at every skinny shape of the main paths; the static prefill's M 128
    takes the tensor-core form."""
    shapes = [(M, N, K, N_SM) for M, N, K in SKINNY + WIDE]
    for (M, N, K, _), (p, _, _) in zip(shapes, _plans(exe, shapes)):
        ctas = p["tiles_m"] * p["tiles_n"] * p["split"]
        if M <= 32:
            assert ctas >= N_SM, ((M, N, K), p)
            assert p["split"] > 1  # the weight alone fills no card here
        else:
            assert p["form"] == TENSOR, ((M, N, K), p)


@pytest.mark.parametrize("shape", [
    (0, 8192, 2048), (4, 0, 2048), (4, 8192, -1), (4, 8192, 2048, 0),
    (65535 * 128 + 1, 64, 64),
], ids=["M0", "N0", "K-1", "no-SMs", "grid-too-tall"])
def test_gemm_plan_refuses_what_it_cannot_take(exe, shape):
    M, N, K, *rest = shape
    (p, _, _), = _plans(exe, [(M, N, K, rest[0] if rest else N_SM)])
    assert p["err"] != 0


def test_gemm_stage_replayed_on_host_matches_product(exe):
    """Every kernel instance's stage layout, ldmatrix addressing, column-pair
    split and fragment maps give the int8 product, with no bank-group
    collision in an ldmatrix phase (2-way at most where a row of w is 32
    bytes)."""
    res = np.frombuffer(_run(exe, [1]), np.int64).reshape(-1, 4)
    tiles = [(16, 128), (16, 64), (16, 32), (32, 128), (32, 64), (32, 32),
             (64, 128), (128, 128)]
    assert len(res) == len(tiles)
    for (bm, bn), (bad, layout_err, worst_a, worst_b) in zip(tiles, res):
        assert layout_err == 0, (bm, bn)
        assert bad == 0, (bm, bn, bad)
        assert worst_a == 1, (bm, bn)
        assert worst_b <= (2 if bn == 32 else 1), (bm, bn, worst_b)


def test_card_cases_reach_every_branch_of_the_plan(exe):
    cases = gemm_checks.CASES
    got = _plans(exe, [(M, N, K, N_SM) for M, K, N, _ in cases])
    picked = {(int(p["tile"]), int(p["split"])) for p, _, _ in got}
    sweep = [(m, n, k, N_SM) for m in (1, 4, 16, 17, 20, 32, 33, 64, 65, 128,
                                       129)
             for n in (5, 32, 61, 100, 130, 192, 256, 640, 1000, 1024, 2048,
                       3000, 4096, 6144, 8191, 8192)
             for k in (37, 64, 100, 128, 200, 256, 512, 640, 641, 1000,
                       2047, 2048)]
    reachable = {(int(p["tile"]), int(p["split"]))
                 for p, _, _ in _plans(exe, sweep)}
    assert reachable <= picked, sorted(reachable - picked)
    assert {t for t, _ in picked} == set(range(8))
    split_dtypes = {str(dt) for (M, K, N, dt), (p, _, _) in zip(cases, got)
                    if p["split"] > 1}
    assert split_dtypes == {"torch.int32", "torch.int8", "torch.int16"}
    for form in (STREAM, TENSOR):  # byte copies of x, of w, in both forms
        rows = [(M, K, N) for (M, K, N, _), (p, _, _) in zip(cases, got)
                if p["form"] == form]
        assert any(K % 16 for _, K, _ in rows)
        assert any(N % 16 for _, _, N in rows)
    assert {1, 16, 17, 20, 32, 33, 128, 129} <= {M for M, *_ in cases}
    assert {(M, K, N) for M, K, N, _ in gemm_checks.SERVING} >= {
        (M, K, N) for M, N, K in SKINNY + WIDE}
