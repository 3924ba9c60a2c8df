// The tile classification of the flash-attention kernel (flash_attention.cu):
// which key tiles a q tile visits, and which of those need the mask; the
// tensor-core form's plan of a head width (its key tiles, the padded
// width its TMA boxes and P.v products run at, its shared memory); and the
// plan of the backward's tensor-core form (flash_attention_bwd.cu).
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

// ---- the backward's tensor-core form (flash_attention_bwd.cu) ----
//
// Two kernels of two warpgroups (256 threads, one CTA an SM).  The dk/dv
// kernel holds a tile of keys (K and V loaded once) and walks the q tiles
// that reach it through a ring of kTcBwdStages (Q, dout, lse, delta)
// stages; the dq kernel holds a tile of q rows (Q and dout loaded once) and
// walks the key tiles through a ring of (K, V) stages.  Up to 128 padded
// columns a warpgroup owns 64 accumulator rows (keys, or q rows) of every
// column, and the logits' products (S and dP, 64 rows x the other tile's
// rows) feed the gradient products from registers.  Past 128 (D 256) both
// warpgroups share 64 rows and split the columns, 128 each (64 rows x 256
// float32 columns of dk and dv would be 256 registers a thread); each then
// forms half of the logits' columns and the two halves meet in shared
// memory as bf16 (P^T and dS^T, or dS), the A operand of the products.

constexpr int kTcBwdStages = 2;  // ring depth of both kernels
constexpr int kTcBwdSeqPad = 128;  // lse and delta rows: Sq rounded up to it

// do the two warpgroups split the columns (and share the logits)?
FT_HD constexpr bool tc_bwd_split(int D) { return tc_padded(D) > 128; }
// keys a dk/dv CTA holds, and q rows a step of it (128 at D 64, where the
// logits are 64 keys x 128 rows; else 64)
FT_HD constexpr int tc_bwd_kv_keys(int D) { return tc_bwd_split(D) ? 64 : 128; }
FT_HD constexpr int tc_bwd_kv_rows(int D) { return tc_padded(D) <= 64 ? 128 : 64; }
// q rows a dq CTA holds, and keys a step of it
FT_HD constexpr int tc_bwd_q_rows(int D) { return tc_bwd_split(D) ? 64 : 128; }
FT_HD constexpr int tc_bwd_q_keys(int D) { return tc_bwd_split(D) ? 64 : 128; }
// accumulator columns a warpgroup holds (of dk and dv, or of dq)
FT_HD constexpr int tc_bwd_acc_cols(int D) {
  return tc_bwd_split(D) ? tc_padded(D) / 2 : tc_padded(D);
}
// logit columns (S and dP each) a warpgroup forms a step, of `n` in all
FT_HD constexpr int tc_bwd_logit_cols(int D, int n) {
  return tc_bwd_split(D) ? n / 2 : n;
}
// float32 registers a thread holds in accumulators and logits (a
// 64-row fragment of c columns is c / 2 a thread): dk, dv, S^T, dP^T; and
// dq, S, dP
FT_HD constexpr int tc_bwd_kv_regs(int D) {
  return tc_bwd_acc_cols(D) + tc_bwd_logit_cols(D, tc_bwd_kv_rows(D));
}
FT_HD constexpr int tc_bwd_q_regs(int D) {
  return tc_bwd_acc_cols(D) / 2 + tc_bwd_logit_cols(D, tc_bwd_q_keys(D));
}
// dynamic shared memory, 1 KB of it alignment: K and V; the stages of Q,
// dout (bf16) and lse, delta (float32); P^T and dS^T where split
FT_HD constexpr int tc_bwd_kv_smem(int D) {
  return 2 * tc_bwd_kv_keys(D) * tc_padded(D) * 2 +
         kTcBwdStages * (2 * tc_bwd_kv_rows(D) * tc_padded(D) * 2 +
                         2 * tc_bwd_kv_rows(D) * 4) +
         (tc_bwd_split(D) ? 2 * 64 * 64 * 2 : 0) + 1024;
}
// Q and dout; the stages of K and V; dS where split
FT_HD constexpr int tc_bwd_q_smem(int D) {
  return 2 * tc_bwd_q_rows(D) * tc_padded(D) * 2 +
         kTcBwdStages * 2 * tc_bwd_q_keys(D) * tc_padded(D) * 2 +
         (tc_bwd_split(D) ? 64 * 64 * 2 : 0) + 1024;
}
// a width the backward's form is built for: the forward's, with both
// kernels' tiles in a block's shared memory and their accumulators and
// logits in a thread's 255 registers
FT_HD constexpr bool tc_bwd_width_ok(int D) {
  return tc_width_ok(D) && tc_bwd_kv_smem(D) <= 227 * 1024 &&
         tc_bwd_q_smem(D) <= 227 * 1024 && tc_bwd_kv_regs(D) <= 255 &&
         tc_bwd_q_regs(D) <= 255;
}

}  // namespace tiles
