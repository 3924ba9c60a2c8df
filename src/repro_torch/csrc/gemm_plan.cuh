// The plan of the int8 GEMM (int8_matmul.cu, kernel 1): which form, tile,
// split of K and shared memory a launch at (M, N, K) takes, and where each
// byte of a stage sits in shared memory.  Valid host C++ as well, so
// tests/test_torch_gemm_plan_cuh.py compiles it with g++ and checks the
// plan's coverage and fit, and replays the kernel's shared-memory layout and
// tensor-core fragments on the host; the wrapper reads the same plan through
// the library's exported int8_matmul_plan.
//
// Two forms, one kernel template:
//
// * weight-streaming (M <= 32): the cost is reading the K x N weight once,
//   so the plan is about SMs in use and bytes in flight.  x is padded (with
//   zeros that are never read from memory) to BM = 16 or 32 rows; each CTA
//   owns BN in {128, 64, 32} columns and one of `split` contiguous ranges
//   of K, so that tiles_n x split CTAs cover every SM.  The CTAs of one
//   tile form a thread-block cluster (split <= 8) and sum their partial
//   tiles through distributed shared memory.
// * tensor-core (M > 32): BM = 64 (M <= 128) or 128 by BN = 128 output
//   tiles, 8 warps of 32 x 32 or 64 x 32 each and 4 warps that only copy,
//   K never split: a split's partial tiles (32-64 KB a CTA) cost more to
//   sum than the SMs it fills gain at the prefill's M.
//
// Both stage x and w in a ring of `stages` slabs of kBK = 64 k, copied as
// they are stored (cp.async, 16 bytes a thread), and multiply them with
// mma.sync m16n8k32 (int8 in, int32 out).
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define GP_HD __host__ __device__ __forceinline__
#else
#define GP_HD inline
#endif
#define GP_H inline  // the plan runs on the host only (it reads kTiles)

namespace gemm {

constexpr int kBK = 64;              // k of one stage
constexpr int kSmemMax = 232448;     // an H100 block's shared-memory ceiling
constexpr int kMaxSplit = 8;         // the portable cluster size
constexpr int kStreamMaxM = 32;      // the weight-streaming form's rows
constexpr int kStreamStages = 4;     // ring depths
constexpr int kTensorStages = 6;
constexpr int kSmemPerSM = 233472;   // an SM's shared memory, all CTAs
constexpr int kSmemPerCTA = 1024;    // reserved by the system for each CTA
constexpr int kMaxGrid = 65535;      // grid y (m tiles) and z (n tiles)

enum Form { kStream = 0, kTensor = 1 };
enum PlanError { kPlanOk = 0, kPlanBadShape = 1, kPlanTooLarge = 2 };

// The kernel's instances: rows and columns of the output tile, the
// multiplying warps over them (wm x wn, each warp bm / wm rows by bn / wn
// columns) and cw warps that only issue the ring's copies (0: every warp
// copies its share, then multiplies).
struct Tile {
  int bm, bn, wm, wn, cw;
};
constexpr int kNumTiles = 8;
constexpr Tile kTiles[kNumTiles] = {
    {16, 128, 1, 8, 0}, {16, 64, 1, 4, 0}, {16, 32, 1, 2, 0},  // weight-streaming
    {32, 128, 1, 8, 0}, {32, 64, 1, 4, 0}, {32, 32, 1, 2, 0},
    {64, 128, 2, 4, 4}, {128, 128, 2, 4, 4}};                  // tensor-core

struct Plan {
  int err, form, tile;  // tile: index into kTiles
  int bm, bn, threads;
  int tiles_m, tiles_n, split;  // grid (split, tiles_m, tiles_n)
  int steps, stages;            // kBK-deep steps of K, ring slabs
  int smem;                     // dynamic shared memory of a CTA, bytes
  long long ctas;
};

GP_HD int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The steps [split_lo(r), split_lo(r + 1)) of K that split r of s sums:
// contiguous, together every step once, each nonempty where s <= steps.
GP_HD int split_lo(int r, int steps, int s) {
  return static_cast<int>(static_cast<long long>(r) * steps / s);
}

// Shared memory of a CTA, in order: the ring of `stages` stages (an A slab
// of bm rows x kBK bytes of x, then a B slab of kBK rows x bn bytes of w);
// the epilogue's vectors (fold, m0, shift over the tile's bn columns); and,
// where K is split, the receive buffer: the partial sums the cluster's CTAs
// push to the CTA that finishes each piece of the tile (a piece is 4
// columns of one row; CTA r finishes pieces [split_lo(r, pieces, split),
// split_lo(r + 1, ...)), and holds one slot of recv_share pieces for each
// CTA of the cluster).
GP_HD int stage_bytes(int bm, int bn) { return bm * kBK + kBK * bn; }
GP_HD int epi_bytes(int bn) { return 3 * bn * 4; }
GP_HD int recv_share(int pieces, int split) { return ceil_div(pieces, split); }
GP_HD int recv_bytes(int bm, int bn, int split) {
  return split > 1 ? split * recv_share(bm * bn / 4, split) * 16 : 0;
}

// The CTA of a cluster of `split` that finishes piece e of `pieces`: the r
// with split_lo(r, pieces, split) <= e < split_lo(r + 1, pieces, split).
GP_HD int piece_owner(int e, int pieces, int split) {
  return static_cast<int>((static_cast<long long>(e + 1) * split - 1) / pieces);
}

// How unevenly `ctas` CTAs fall on n_sm SMs, as the busiest SM's share of
// the work over the average SM's (1 = even).
GP_H double imbalance(long long ctas, int n_sm) {
  const long long waves = (ctas + n_sm - 1) / n_sm;
  return static_cast<double>(waves) * n_sm / static_cast<double>(ctas);
}

GP_H Plan plan(int M, int N, int K, int n_sm) {
  Plan p = {};
  if (M < 1 || N < 1 || K < 0 || n_sm < 1) {  // K = 0: out = fold
    p.err = kPlanBadShape;
    return p;
  }
  p.steps = ceil_div(K, kBK);
  p.form = M <= kStreamMaxM ? kStream : kTensor;
  // candidates: the form's tiles x splits of K.  The fewest CTAs whose
  // imbalance is within 5 % of the best; the weight-streaming form first
  // asks for a CTA on every SM, where any candidate gives one.  Ties go to
  // the first tile in kTiles (the widest).
  double best = 1e30;
  bool best_fills = false;
  long long best_ctas = 0;
  const int most_split = p.form == kStream ? kMaxSplit : 1;
  for (int pass = 0; pass < 2; ++pass) {
    for (int t = 0; t < kNumTiles; ++t) {
      const Tile& tl = kTiles[t];
      const bool stream_tile = tl.bm <= kStreamMaxM;
      if (stream_tile != (p.form == kStream)) continue;
      // the rows: M padded to 16 or 32 (streaming), 64 or 128 (tensor)
      if (tl.bm != (p.form == kStream ? (M <= 16 ? 16 : 32) : (M <= 128 ? 64 : 128)))
        continue;
      const int tm = ceil_div(M, tl.bm), tn = ceil_div(N, tl.bn);
      if (tm > kMaxGrid || tn > kMaxGrid) continue;
      for (int s = 1; s <= most_split && (s == 1 || s <= p.steps); ++s) {
        const long long ctas = static_cast<long long>(tm) * tn * s;
        const double score = imbalance(ctas, n_sm);
        const bool fills = p.form == kStream && ctas >= n_sm;
        if (pass == 0) {  // the best score, among those that fill if any do
          if ((fills && !best_fills) ||
              (fills == best_fills && score < best)) {
            best = score;
            best_fills = fills;
          }
          continue;
        }
        if (fills != best_fills || score > best * 1.05) continue;
        if (p.ctas != 0 && ctas >= best_ctas) continue;
        best_ctas = ctas;
        p.ctas = ctas;
        p.tile = t;
        p.tiles_m = tm;
        p.tiles_n = tn;
        p.split = s;
      }
    }
  }
  if (p.ctas == 0) {
    p.err = kPlanBadShape;
    return p;
  }
  const Tile& tl = kTiles[p.tile];
  p.bm = tl.bm;
  p.bn = tl.bn;
  p.threads = 32 * (tl.wm * tl.wn + tl.cw);
  // the ring: as deep as the form allows and the CTA's steps need, then
  // shallower (not below 2) until every CTA of the grid is resident at once
  // with room for one more on each SM (clusters do not pack SMs perfectly)
  const int most_steps = ceil_div(p.steps, p.split);
  const int depth = p.form == kStream ? kStreamStages : kTensorStages;
  p.stages = most_steps < depth ? most_steps : depth;
  if (p.stages < 2) p.stages = 2;
  auto smem_at = [&](int stages) {
    return stages * stage_bytes(p.bm, p.bn) + epi_bytes(p.bn) + recv_bytes(p.bm, p.bn, p.split);
  };
  const long long per_sm = (p.ctas + n_sm - 1) / n_sm + (p.split > 1 ? 1 : 0);
  while (p.stages > 2 && per_sm * (smem_at(p.stages) + kSmemPerCTA) > kSmemPerSM) --p.stages;
  p.smem = smem_at(p.stages);
  if (p.smem > kSmemMax) p.err = kPlanTooLarge;
  return p;
}

// ---- where the bytes of a stage sit, and which a lane's fragments read --
//
// A slab (row-major, kBK = 64 bytes a row, 4 chunks of 16): chunk c of row
// r moves to c ^ ((r >> 1) & 3), so the 8 rows an ldmatrix phase reads
// (r0 .. r0 + 7) hit 8 distinct 16-byte bank groups.
GP_HD int a_offset(int r, int c) {
  return r * kBK + ((c ^ ((r >> 1) & 3)) << 4);
}

// B slab (row k of bn bytes, bn / 16 chunks): the transposing ldmatrix
// reads rows k0 + {0, 1, 4, 5, 8, 9, 12, 13} (+ 2) of one chunk at once;
// the swizzle puts those 8 rows on 8 distinct bank groups at bn = 128 and
// 64 (and on 4 at bn = 32, where a row is a quarter of the 128 banks).
GP_HD int b_swizzle(int k, int nch) {
  return nch >= 8 ? ((k & 1) | ((k >> 1) & 6)) : ((k >> 2) & (nch - 1));
}
GP_HD int b_offset(int k, int c, int bn) {
  return k * bn + ((c ^ b_swizzle(k, bn / 16)) << 4);
}

// The A fragments of one m16 x k32 block (rows r0.., k kk.. of the slab)
// come from one ldmatrix.x4: lane t gives the address of row
// r0 + ((t >> 3) & 1) * 8 + (t & 7), chunk (kk >> 4) + (t >> 4); the four
// 8 x 8 (b16) matrices are then a0..a3 of mma.sync m16n8k32.
GP_HD int a_lane_offset(int lane, int r0, int kk) {
  return a_offset(r0 + ((lane >> 3) & 1) * 8 + (lane & 7), (kk >> 4) + (lane >> 4));
}

// The B fragments of one k32 x n16 block (k kk.. and chunk c of the slab)
// come from one ldmatrix.x4.trans over 16-bit pairs of columns: matrix
// q = t >> 3 holds rows kk + (q & 1) * 2 + (q >> 1) * 16 + {0, 1, 4, 5,
// 8, 9, 12, 13}, so lane (g, t4) receives k = 4 t4 .. 4 t4 + 3 (+ 16) of
// columns 2 g and 2 g + 1 of the chunk, which pack::split_pairs turns into
// the B registers of two n8 tiles: tile 0 holds the chunk's even columns,
// tile 1 its odd ones.  So the accumulators of lane (g, t4) hold rows g
// and g + 8 at columns 4 t4 .. 4 t4 + 3 of the chunk as
// {tile 0 c0, tile 1 c0, tile 0 c1, tile 1 c1} (and c2, c3 for row g + 8).
GP_HD int b_lane_offset(int lane, int kk, int c, int bn) {
  const int q = lane >> 3, r = lane & 7;
  const int k = kk + (q & 1) * 2 + (q >> 1) * 16 + ((r >> 1) << 2) + (r & 1);
  return b_offset(k, c, bn);
}

// Where the accumulators of one m16 x n16 block (rows r0.., chunk c) go:
// lane (g, t4) holds acc[tile][i], i = 0..3 as mma.sync's c0..c3; element
// e (0..3) of its row h (0: row r0 + g, 1: row r0 + g + 8) is column
// 16 c + 4 t4 + e and comes from acc[e & 1][2 h + (e >> 1)]: one piece.
GP_HD int frag_row(int lane, int r0, int h) { return r0 + (lane >> 2) + 8 * h; }
GP_HD int frag_col(int lane, int c) { return 16 * c + 4 * (lane & 3); }

}  // namespace gemm
