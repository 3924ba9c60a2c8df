// The launch plans of the row kernels of the stepwise LSTM step (kernel 2,
// int_layernorm.cu: the gate pass and the TPU-contract LayerNorm; kernel 3,
// quant_lstm_cell.cu: the cell, elementwise or with the o gate's in-fusion
// LayerNorm).  Valid host C++ too, so tests/test_torch_ln_plan_cuh.py
// compiles it with g++; int_layernorm's library exports the row plan.
//
// A LayerNorm row (one gate of one batch row: rows x G rows of n columns)
// is split over a thread-block cluster of C <= 8 CTAs: CTA `rank` owns the
// columns [rank W, min((rank + 1) W, n)), one column a thread at a time,
// and pushes its partial Sum q and Sum q^2 into every cluster CTA's shared
// memory.  C is the fewest CTAs a row that fill the SMs, at most 8 and at
// most n / kMinSlice, and no CTA's slice is empty.  A CTA keeps `slices`
// int16 vectors of W in shared memory (the gate pass 1, the cell's LN form
// 2).  The elementwise cell takes one column of one batch row a thread.
// Loads wider than one column a thread (2, 4 and 8 int16, up to 16 bytes)
// measured 1.3-14x slower on an H100 at the main paths' shapes (PERF.md).
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"

namespace lnp {

constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr int kMaxRow = 16384;     // the exact statistics' limit
constexpr int kMaxThreads = 512;
constexpr int kMinSlice = 256;     // fewest columns worth a CTA of their own
constexpr int kSmemMax = 232448;   // an H100 block's shared-memory ceiling
constexpr int kEwThreads = 128;    // threads a CTA of the elementwise cell

enum PlanError { kPlanOk = 0, kPlanBadShape = 1, kPlanTooLarge = 2 };

FP_HD long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

struct Plan {
  int err;
  int C;            // CTAs a row (one cluster)
  int W;            // columns a CTA
  int threads;      // threads a CTA
  int smem;         // dynamic shared bytes a CTA: `slices` int16 vectors of W
  long long ctas;   // rows * G rows of C CTAs
};

// `rows` x `G` LayerNorm rows of n columns on `n_sm` SMs, each CTA keeping
// `slices` int16 vectors of its columns in shared memory.
FP_HD Plan plan(long long rows, int G, int n, int n_sm, int slices) {
  Plan p = {};
  if (rows < 1 || G < 1 || G > 4 || n < 1 || n > kMaxRow || n_sm < 1 ||
      slices < 1 || slices > 2) {
    p.err = kPlanBadShape;
    return p;
  }
  const long long units = rows * G;
  long long C = kMaxCluster;
  const long long fill = cdiv(n_sm, units);
  const long long wide = n / kMinSlice > 1 ? n / kMinSlice : 1;
  if (fill < C) C = fill;
  if (wide < C) C = wide;
  p.W = (int)cdiv(n, C);
  p.C = (int)cdiv(n, p.W);  // no CTA without columns
  const int t = (int)(cdiv(p.W, 32) * 32);
  p.threads = t > kMaxThreads ? kMaxThreads : t;
  p.smem = slices * p.W * (int)sizeof(int16_t);
  p.ctas = units * p.C;
  if (p.ctas > 2147483647LL || p.smem > kSmemMax) p.err = kPlanTooLarge;
  return p;
}

// the columns of CTA `rank`: [slice_lo, slice_hi)
FP_HD int slice_lo(const Plan& p, int rank) { return rank * p.W; }
FP_HD int slice_hi(const Plan& p, int rank, int n) {
  const int hi = (rank + 1) * p.W;
  return hi < n ? hi : n;
}

struct EwPlan {
  int err;
  int threads;  // threads a CTA
  long long ctas;
};

// The elementwise cell over (B, H): thread g takes column g % H of batch
// row g / H.
FP_HD EwPlan ew_plan(long long B, int H) {
  EwPlan p = {};
  if (B < 1 || H < 1) {
    p.err = kPlanBadShape;
    return p;
  }
  p.threads = kEwThreads;
  p.ctas = cdiv(B * H, p.threads);
  if (p.ctas > 2147483647LL) p.err = kPlanTooLarge;
  return p;
}

}  // namespace lnp
