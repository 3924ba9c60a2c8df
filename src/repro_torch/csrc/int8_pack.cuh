// Byte-level helpers for int8 dot products, shared by the int8 GEMM and the
// sequence kernels' weight loader.  A row-major int8 matrix stores 4
// consecutive COLUMNS in a 32-bit word, while __dp4a (and the B operand of
// mma.sync m16n8k32) wants 4 consecutive K values of one column:
// `transpose4` turns the words of 4 consecutive rows into one packed word
// per column with 8 byte permutes.  Host fallbacks of __byte_perm and
// __dp4a keep the header valid host C++, so the packing can be checked
// without a GPU.
#pragma once
#include <stdint.h>

#ifdef __CUDACC__
#define PACK_HD __device__ __forceinline__
#else
#define PACK_HD inline
inline int __byte_perm(int x, int y, int s) {
  const uint64_t in = (uint64_t)(uint32_t)x | ((uint64_t)(uint32_t)y << 32);
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) {
    const int sel = (s >> (4 * n)) & 7;
    r |= (uint32_t)((in >> (8 * sel)) & 0xFF) << (8 * n);
  }
  return (int)r;
}
inline int __dp4a(int a, int b, int c) {
  int s = c;
  for (int n = 0; n < 4; ++n) s += (int8_t)(a >> (8 * n)) * (int8_t)(b >> (8 * n));
  return s;
}
#endif

namespace pack {

// Rows a, b, c, d each hold columns j = 0..3 as bytes j.  out[j] holds
// column j's 4 values (a_j, b_j, c_j, d_j) as bytes 0..3.
PACK_HD void transpose4(int a, int b, int c, int d, int out[4]) {
  const int ab_lo = __byte_perm(a, b, 0x5140);  // a0 b0 a1 b1
  const int ab_hi = __byte_perm(a, b, 0x7362);  // a2 b2 a3 b3
  const int cd_lo = __byte_perm(c, d, 0x5140);  // c0 d0 c1 d1
  const int cd_hi = __byte_perm(c, d, 0x7362);  // c2 d2 c3 d3
  out[0] = __byte_perm(ab_lo, cd_lo, 0x5410);   // a0 b0 c0 d0
  out[1] = __byte_perm(ab_lo, cd_lo, 0x7632);   // a1 b1 c1 d1
  out[2] = __byte_perm(ab_hi, cd_hi, 0x5410);
  out[3] = __byte_perm(ab_hi, cd_hi, 0x7632);
}

// A transposing ldmatrix over 16-bit elements of a row-major int8 matrix
// gives a lane two words, each holding two rows of a pair of adjacent
// columns n, n + 1: lo = (k, n) (k, n+1) (k+1, n) (k+1, n+1) as bytes 0..3,
// hi the same for rows k + 2, k + 3.  out[0] packs column n's 4 values
// (k .. k + 3), out[1] column n + 1's.
PACK_HD void split_pairs(int lo, int hi, int out[2]) {
  out[0] = __byte_perm(lo, hi, 0x6420);
  out[1] = __byte_perm(lo, hi, 0x7531);
}

}  // namespace pack
