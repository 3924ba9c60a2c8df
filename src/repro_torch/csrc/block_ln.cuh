// Block-wide exact LayerNorm statistics, shared by the standalone LayerNorm
// kernel (int_layernorm.cu) and the cell kernel's in-fusion o-gate
// LayerNorm (quant_lstm_cell.cu): one thread block of kThreads covers a
// row, reduces Sum q and Sum q^2 through warp shuffles, and one thread per
// gate slot forms V = n Sum q^2 - (Sum q)^2 and its rsqrt multiplier.
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"

namespace blk {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct LNStats {
  int32_t sum[4];
  int32_t m0[4];
  int32_t shift[4];
  int deg[4];
  long long red_s[kWarps][4];
  long long red_q[kWarps][4];
};

// Block-wide exact Sum q and Sum q^2 per gate slot, then one thread per
// slot forms V = n Sum q^2 - (Sum q)^2 and its rsqrt multiplier.
__device__ inline void ln_stats(const long long* s, const long long* q, int n,
                         int nslots, LNStats* st) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int k = 0; k < nslots; ++k) {
    long long a = s[k], b = q[k];
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
    }
    if (lane == 0) {
      st->red_s[warp][k] = a;
      st->red_q[warp][k] = b;
    }
  }
  __syncthreads();
  if (threadIdx.x < nslots) {
    const int k = threadIdx.x;
    long long a = 0, b = 0;
    for (int w = 0; w < kWarps; ++w) {
      a += st->red_s[w][k];
      b += st->red_q[w][k];
    }
    const long long v = (long long)n * b - a * a;  // >= 0, < 2**59
    st->sum[k] = (int32_t)a;
    st->deg[k] = v == 0;
    fp::rsqrt_multiplier((uint64_t)v, 10, &st->m0[k], &st->shift[k]);
  }
  __syncthreads();
}

}  // namespace blk
