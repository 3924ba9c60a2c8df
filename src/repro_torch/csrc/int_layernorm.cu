// Exact integer LayerNorm over int16 rows (paper sec 3.2.6, eqs 13-16).
//
// Replaces the TPU kernel `int_layernorm_pallas`
// (repro/kernels/int_layernorm.py, body `_ln_kernel`, which traces
// `integer_layernorm` of repro/core/integer_ops.py).  For each row q of n
// int16 values (n <= 16384):
//   Sum q and Sum q^2 exactly (int64; Sum q^2 < 2**44), V = n Sum q^2 - (Sum q)^2
//   q'  = mbqm(n*q - Sum q, 1024 rsqrt V), 0 where V == 0, clipped to int16
//   out = sat16(mbqm(q' * L sat+ b, out_m0, out_shift))
// The TPU kernel carries the u64 statistics as uint32 limb pairs; here they
// are int64, which gives the same integers.
//
// What bounds it on an H100: one pass over the row in and one out (2 bytes
// each way per element) plus L and b: bytes, about 0.01 us at B = 4,
// n = 2048, far below the cost of one launch, so a launch is the real
// floor.  One thread block per row: each thread sums its strided elements,
// the block reduces through warp shuffles (`blk::ln_stats`, the statistics
// the sequence kernels use per gate), one thread forms the rsqrt
// multiplier, and every thread normalises its elements
// (`fp::layernorm_apply`, the same device function as the sequence kernels).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "block_ln.cuh"

namespace {

using blk::kThreads;

__global__ void __launch_bounds__(kThreads) int_layernorm_kernel(
    const int16_t* __restrict__ q, const int16_t* __restrict__ lw,
    const int32_t* __restrict__ lb, int16_t* __restrict__ out, int n,
    int32_t out_m0, int32_t out_shift) {
  __shared__ blk::LNStats st;
  const int16_t* row = q + (size_t)blockIdx.x * n;
  int16_t* dst = out + (size_t)blockIdx.x * n;
  long long s[1] = {0}, sq[1] = {0};
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const long long v = row[j];
    s[0] += v;
    sq[0] += v * v;
  }
  blk::ln_stats(s, sq, n, 1, &st);
  for (int j = threadIdx.x; j < n; j += kThreads) {
    dst[j] = fp::layernorm_apply(row[j], n, st.sum[0], st.deg[0], st.m0[0],
                                 st.shift[0], lw[j], lb[j], out_m0, out_shift);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes): `rows` rows of `n` int16 values.
// Returns cudaGetLastError().
extern "C" int int_layernorm_launch(const void* q, const void* lw, const void* lb,
                                    void* out, int rows, int n, int out_m0,
                                    int out_shift, void* stream) {
  int_layernorm_kernel<<<rows, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(q), static_cast<const int16_t*>(lw),
      static_cast<const int32_t*>(lb), static_cast<int16_t*>(out), n, out_m0,
      out_shift);
  return static_cast<int>(cudaGetLastError());
}
