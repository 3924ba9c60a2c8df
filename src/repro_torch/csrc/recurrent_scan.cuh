// Device code shared by the two persistent sequence kernels
// (quant_lstm_scan.cu, quant_gru_scan.cu): the block-wide int8 mat-vec that
// streams a layer's packed recurrent weights once per step, and the exact
// per-gate LayerNorm statistics.  Both kernels run one thread block of
// kThreads per batch row.
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"
#include "int8_pack.cuh"

namespace scan {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPartInts = 16 * kThreads;  // matvec partial sums (32 KB)

// out[col] = wrap32(sum_k v[k] * W[k, col] + bias[col]) for col < N, with v
// an int8 row vector in shared memory (16-byte aligned).  Each work item
// owns WIDTH adjacent columns: 16 (one 16-byte load per row, 4 rows at a
// time packed by `transpose4` into __dp4a operands), 4 or 1 (ragged
// widths).  Spare threads split K, and the partial sums meet in `part`.
template <int WIDTH>
__device__ void matvec_cols(const int8_t* v, int K, const int8_t* __restrict__ W,
                            int N, const int32_t* __restrict__ bias,
                            int32_t* out, int32_t* part) {
  const int groups = N / WIDTH;
  int ks_n = kThreads / groups;
  if (ks_n > kPartInts / N) ks_n = kPartInts / N;
  if (ks_n < 1) ks_n = 1;
  for (int item = threadIdx.x; item < groups * ks_n; item += kThreads) {
    const int g = item % groups;
    const int ks = item / groups;
    const int8_t* Wg = W + (size_t)g * WIDTH;
    int acc[WIDTH];
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) acc[i] = 0;
    int k_tail = 0;  // rows below k_tail were handled 4 at a time
    if (WIDTH == 16) {
      k_tail = K & ~3;
#pragma unroll 2
      for (int k = 4 * ks; k < k_tail; k += 4 * ks_n) {
        int4 r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          r[j] = __ldg(reinterpret_cast<const int4*>(Wg + (size_t)(k + j) * N));
        const int vk = *reinterpret_cast<const int*>(v + k);
        int cols[4];
        pack::transpose4(r[0].x, r[1].x, r[2].x, r[3].x, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[j] = __dp4a(cols[j], vk, acc[j]);
        pack::transpose4(r[0].y, r[1].y, r[2].y, r[3].y, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 + j] = __dp4a(cols[j], vk, acc[4 + j]);
        pack::transpose4(r[0].z, r[1].z, r[2].z, r[3].z, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[8 + j] = __dp4a(cols[j], vk, acc[8 + j]);
        pack::transpose4(r[0].w, r[1].w, r[2].w, r[3].w, cols);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[12 + j] = __dp4a(cols[j], vk, acc[12 + j]);
      }
      if (ks != 0) k_tail = K;  // the K % 4 tail rows belong to split 0
    }
    for (int k = k_tail + ks; k < K; k += (WIDTH == 16 ? 1 : ks_n)) {
      const int vk = v[k];
#pragma unroll
      for (int i = 0; i < WIDTH; ++i) acc[i] += vk * (int)Wg[(size_t)k * N + i];
    }
#pragma unroll
    for (int i = 0; i < WIDTH; ++i) {
      const int col = g * WIDTH + i;
      if (ks_n == 1) {
        out[col] = fp::wrap32((int64_t)acc[i] + bias[col]);
      } else {
        part[ks * N + col] = acc[i];
      }
    }
  }
  if (ks_n > 1) {
    __syncthreads();
    for (int col = threadIdx.x; col < N; col += kThreads) {
      int64_t s = bias[col];
      for (int ks = 0; ks < ks_n; ++ks) s += part[ks * N + col];
      out[col] = fp::wrap32(s);
    }
  }
}

__device__ inline void matvec(const int8_t* v, int K, const int8_t* __restrict__ W,
                       int N, const int32_t* __restrict__ bias, int32_t* out,
                       int32_t* part) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(W);
  if (N % 16 == 0 && (addr & 15) == 0) {
    matvec_cols<16>(v, K, W, N, bias, out, part);
  } else if (N % 4 == 0 && (addr & 3) == 0) {
    matvec_cols<4>(v, K, W, N, bias, out, part);
  } else {
    matvec_cols<1>(v, K, W, N, bias, out, part);
  }
}

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

}  // namespace scan
