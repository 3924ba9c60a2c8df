// Exact integer LayerNorm over int16 rows (paper sec 3.2.6, eqs 13-16), and
// the stepwise LSTM step's gate pass built on it.
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
// One kernel, two entries.  The TPU contract: rows of given int16 values
// (G = 1).  The gate pass of a stepwise LSTM step: the rows are formed in
// the kernel from the step's two int32 accumulators (B, G*H) and the old
// cell state, gate by gate as ref.lstm_gate_preacts does (the prologue
// cell::gate_preact, then sat16), and each gate is normalised with its own
// L, b and output multiplier into one (B, G*H) int16 tensor; a gate the
// cell finishes itself (the peephole o) is written as 0.
//
// What bounds it on an H100: bytes, about 0.01-0.05 us at B = 4, n = 2048,
// far below the cost of one launch, so the launch and the serial latency of
// the statistics are the real floor.  Each (row, gate) is split over a
// cluster of C CTAs (ln_plan.cuh), each owning a column slice: one pass
// forms (or loads) the slice into shared memory while summing, the
// statistics meet through distributed shared memory and one cluster
// barrier (block_ln.cuh), every thread forms the rsqrt multiplier itself,
// and a second pass normalises the slice (fp::layernorm_apply).  At B = 4,
// G = 4, n = 2048 that is 16 clusters of 8 CTAs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "lstm_cell.cuh"
#include "ln_plan.cuh"
#include "block_ln.cuh"

namespace {

struct LNParams {
  const int16_t* q;  // given int16 rows (the TPU contract), or null
  const int32_t* acc_x;  // (rows, G n) int32 accumulators of the gate pass
  const int32_t* acc_h;
  const int16_t* c_old;  // (rows, n), read by the i/f peephole
  const int16_t* P[4];   // (n,) per gate slot: i/f peephole weights
  const int16_t* L[4];   // (n,) LayerNorm weights
  const int32_t* Lb[4];  // (n,) LayerNorm bias
  int16_t* out;          // (rows, G n)
  int G, n;
  int normalise[4];  // slot normalised here; else written 0
  cell::GateScale sc[4];
  int32_t ln_out[4][2];
};

__global__ void __launch_bounds__(lnp::kMaxThreads) int_layernorm_kernel(LNParams p,
                                                                        lnp::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* slice = reinterpret_cast<int16_t*>(smem);  // this CTA's rows, formed
  __shared__ blk::RowShared rsh;
  const int rank = (int)(blockIdx.x % pl.C);
  const long long unit = blockIdx.x / pl.C;
  const long long b = unit / p.G;
  const int k = (int)(unit % p.G);
  const int n = p.n;
  const int lo = lnp::slice_lo(pl, rank), hi = lnp::slice_hi(pl, rank, n);
  const size_t row = (size_t)unit * n;  // (b, gate k) starts here
  if (!p.normalise[k]) {  // the whole cluster takes this branch
    for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) p.out[row + j] = 0;
    return;
  }
  if (pl.C > 1) blk::cluster_arrive_relaxed();
  const cell::GateScale sc = p.sc[k];
  long long s = 0, sq = 0;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    int32_t v;
    if (p.q) {
      v = p.q[row + j];
    } else {
      const int32_t pw = sc.has_c ? p.P[k][j] : 0;
      const int32_t c = sc.has_c ? p.c_old[(size_t)b * n + j] : 0;
      v = fp::sat16(cell::gate_preact(sc, p.acc_x[row + j], p.acc_h[row + j], pw, c));
    }
    s += v;
    sq += (long long)v * v;
    slice[j - lo] = (int16_t)v;
  }
  const blk::RowNorm rn = blk::row_norm(s, sq, n, pl.C, rank, &rsh);
  const int32_t om0 = p.ln_out[k][0], osh = p.ln_out[k][1];
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x)  // this thread's own columns
    p.out[row + j] = (int16_t)fp::layernorm_apply(slice[j - lo], n, rn.sum, rn.deg, rn.m0,
                                                  rn.shift, p.L[k][j], p.Lb[k][j], om0, osh);
}

}  // namespace

// The plan of `rows` x `G` rows of n columns (ln_plan.cuh), each CTA
// keeping `slices` int16 vectors of its columns (1 here, 2 for the cell's
// LN form), into out[0..5] = err, C, W, threads, smem, ctas; returns err.
extern "C" int int_layernorm_plan(long long rows, int G, int n, int n_sm, int slices,
                                  long long* out) {
  const lnp::Plan p = lnp::plan(rows, G, n, n_sm, slices);
  const long long v[6] = {p.err, p.C, p.W, p.threads, p.smem, p.ctas};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return p.err;
}

// Plain C entry point (bound with ctypes).
//   ptrs: q, acc_x, acc_h, c_old, P[4], L[4], Lb[4], out          (17 pointers)
//   ints: rows, G, n, normalise[4],
//         sc[4] x (x_m0, x_sh, h_m0, h_sh, c_m0, c_sh, has_c), ln_out[4][2]
//                                                                 (43 ints)
// q non-null: the TPU contract (G = 1, rows of given int16); else the gate
// pass.  Returns cudaGetLastError() (or the first failing call's;
// cudaErrorInvalidValue where the plan refuses).
extern "C" int int_layernorm_launch(const void* const* ptrs, const int32_t* ints,
                                    int n_sm, void* stream) {
  LNParams p = {};
  int i = 0;
  p.q = static_cast<const int16_t*>(ptrs[i++]);
  p.acc_x = static_cast<const int32_t*>(ptrs[i++]);
  p.acc_h = static_cast<const int32_t*>(ptrs[i++]);
  p.c_old = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.P[k] = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.L[k] = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.Lb[k] = static_cast<const int32_t*>(ptrs[i++]);
  p.out = static_cast<int16_t*>(const_cast<void*>(ptrs[i++]));
  int j = 0;
  const int rows = ints[j++];
  p.G = ints[j++];
  p.n = ints[j++];
  for (int k = 0; k < 4; ++k) p.normalise[k] = ints[j++];
  for (int k = 0; k < 4; ++k) {
    cell::GateScale& s = p.sc[k];
    s.x_m0 = ints[j++];
    s.x_sh = ints[j++];
    s.h_m0 = ints[j++];
    s.h_sh = ints[j++];
    s.c_m0 = ints[j++];
    s.c_sh = ints[j++];
    s.has_c = ints[j++];
  }
  for (int k = 0; k < 4; ++k) for (int l = 0; l < 2; ++l) p.ln_out[k][l] = ints[j++];
  const lnp::Plan pl = lnp::plan(rows, p.G, p.n, n_sm, 1);
  if (pl.err != lnp::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      blk::launch_rows(int_layernorm_kernel, pl, static_cast<cudaStream_t>(stream), p, pl));
}
