// The tile classification of the flash-attention kernel (flash_attention.cu):
// which key tiles a q tile visits, and which of those need the mask; and
// the tensor-core form's plan of a head width (its key tiles, the padded
// width its TMA boxes and P.v products run at, its shared memory).
// Valid host C++ as well, so the rules are compiled and checked against a
// brute-force mask without a GPU (tests/test_torch_kernel_plans_cuh.py).
//
// Positions: the row at index s of q sits at position s + q_offset; key kp
// is attended by the row at position qp iff
//   kp < Sk  and  (!causal or kp <= qp)  and  (window <= 0 or kp > qp - window).
// A key tile [k0, k0 + bk) is, for a block of rows,
//   * skipped   when it lies outside tile_range (no row of the q tile
//               attends any of its keys, and skipping is exact: see below);
//   * unmasked  when every row of the block attends every key of it;
//   * masked    otherwise (the mask runs on every logit of the tile).
#pragma once

#ifdef __CUDACC__
#define FT_HD __host__ __device__ __forceinline__
#else
#define FT_HD inline
#endif

namespace tiles {

struct Mask {
  int Sq, Sk, causal, window, q_offset;
};

FT_HD int imin(int a, int b) { return a < b ? a : b; }
FT_HD int imax(int a, int b) { return a > b ? a : b; }

// does key kp at all attend the row at position qp?
FT_HD bool attends(const Mask& m, int qp, int kp) {
  return kp < m.Sk && (!m.causal || kp <= qp) &&
         (m.window <= 0 || kp > qp - m.window);
}

// does the row at position qp have a key in [0, Sk) under the mask?
FT_HD bool row_attends(const Mask& m, int qp) {
  const int lo = m.window > 0 ? imax(qp - m.window + 1, 0) : 0;
  const int hi = m.causal ? imin(qp, m.Sk - 1) : m.Sk - 1;
  return lo <= hi;
}

// The key tiles [kt0, kt1) of bk keys that the q tile of bq rows at row q0
// visits: all of them, or (when every row of the tile has a key: the count
// of keys a row attends is concave in its position, so the first and last
// rows decide) those the mask leaves non-empty for some row.  Skipping is
// then exact: after the diagonal a tile would add p = 0 at alpha = 1, and
// before the window a later tile's alpha = 0 wipes what it added.
FT_HD void tile_range(const Mask& m, int q0, int bq, int bk, int* kt0,
                      int* kt1) {
  const int n_tiles = (m.Sk + bk - 1) / bk;
  const int first = q0 + m.q_offset;
  const int last = imin(q0 + bq, m.Sq) - 1 + m.q_offset;
  *kt0 = 0;
  *kt1 = n_tiles;
  if (row_attends(m, first) && row_attends(m, last)) {
    if (m.causal) *kt1 = imin(n_tiles, last / bk + 1);
    if (m.window > 0) *kt0 = imax(0, (first - m.window + 1) / bk);
  }
}

// Must the key tile [k0, k0 + bk) be masked for the rows at positions
// [qp_lo, qp_hi]?  False only when every row attends every key of it.
FT_HD bool tile_masked(const Mask& m, int qp_lo, int qp_hi, int k0, int bk) {
  const int k_last = k0 + bk - 1;
  return k_last >= m.Sk || (m.causal && k_last > qp_lo) ||
         (m.window > 0 && k0 <= qp_hi - m.window);
}

// ---- the tensor-core form's head-width plan ----
//
// A row of D bf16 values is read as 64-column TMA boxes (128 bytes, the
// 128-byte swizzle's span).  A width that is not a multiple of 64 (kimi's
// 112) is padded to the next one: the tensor map's D extent stays D, so
// TMA fills columns D..Dp-1 of the last box with zeros.  q.k^T runs D / 16
// k-steps (the padding never enters it); P.v runs on the padded width (for
// 112 the D128 n128 product, (Dp - D) / (D + Dp) = 6.7 % of the form's
// tensor-core work wasted) and only D columns are stored.

constexpr int kTcBox = 64;   // bf16 columns a TMA box
constexpr int kTcBQ = 128;   // q rows a CTA
constexpr int kTcStages = 2;  // K/V ring depth

// the width the boxes and P.v run at
FT_HD constexpr int tc_padded(int D) { return (D + kTcBox - 1) / kTcBox * kTcBox; }
// keys a K/V tile: 128, or 64 past D 128, where the q tile and two stages
// of 128-key K and V tiles would need 320 KB of shared memory
FT_HD constexpr int tc_block_k(int D) { return D > 128 ? 64 : 128; }
// dynamic shared memory: the q tile, the K and V stages, 1 KB of alignment
FT_HD constexpr int tc_smem_bytes(int D) {
  return kTcBQ * tc_padded(D) * 2 +
         2 * kTcStages * tc_block_k(D) * tc_padded(D) * 2 + 1024;
}
// a width the form is built for: k-steps of 16 columns cover D exactly,
// P.v's accumulators fit one n128 or two (D 256), the tiles fit a block
FT_HD constexpr bool tc_width_ok(int D) {
  return D >= 16 && D % 16 == 0 && tc_padded(D) <= 256 &&
         (tc_padded(D) == 64 || tc_padded(D) % 128 == 0) &&
         tc_smem_bytes(D) <= 227 * 1024;
}

}  // namespace tiles
