// Shared by the two cooperative sequence kernels (quant_lstm_scan.cu,
// quant_gru_scan.cu): the partition of a layer's hidden units over the
// card's SMs and the layout of a CTA's shared memory (valid host C++ too,
// so tests/test_torch_kernel_plans_cuh.py compiles it with g++; the
// wrappers read it through each library's exported *_plan function), and
// the device code of one step: the grid barrier, the int8 tensor-core
// mat-vec over shared memory, the exact LayerNorm totals.
//
// The partition: NB CTAs, one per SM, CTA n owning hidden units
// [n u, min((n + 1) u, H)) with u = ceil(H / min(H, n_sm)), so NB =
// ceil(H / u) <= n_sm.  For its units a CTA keeps, for the whole launch,
// the G gate columns of R_cat (d_out x G u int8) and, for an LSTM with
// projection, the columns [n wc, (n + 1) wc) of W_proj (H x wc, wc =
// ceil(d_out / NB)), both as words packing 4 rows of a column (the B
// operand of mma.sync m16n8k32).  The batch rows pass through in groups of
// rg: a group's full h (and, with projection, its full m), gates and
// LayerNorm scratch sit beside the weights, rg the most rows that fit
// (all B where they do, else a multiple of 16), so the shared memory a CTA
// needs is bounded whatever B is.  The plan raises (err != 0) where the
// weights and one row do not fit in one SM's 227 KB.
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"
#include "int8_pack.cuh"

namespace scan {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 5;    // LayerNorm totals per row: 4 gates + the late o
constexpr int kSmemMax = 232448;  // an H100 block's shared-memory ceiling
constexpr int kBarrierBytes = 128;

enum PlanError { kPlanOk = 0, kPlanBadShape = 1, kPlanTooLarge = 2 };

// One mat-vec operand layout: a (K x N) int8 matrix held as words
// W4[k4 * ws + n] packing rows 4 k4 .. 4 k4 + 3 of column n, K padded to
// k32 (a multiple of the MMA's 32), N to np (of its 8); the word stride ws
// is an odd multiple of 8, so the B fragments of a warp fall on 32
// distinct banks.  The K split kw spreads its np / 8 column tiles over
// about 2 * kWarps work items of at least 4 MMAs each.
struct Operand {
  int k32, np, ws, kw;
};

FP_HD int ceil_div(int a, int b) { return (a + b - 1) / b; }
FP_HD int round_up(int a, int m) { return ceil_div(a, m) * m; }

FP_HD Operand operand(int K, int N) {
  Operand o;
  o.k32 = round_up(K, 32);
  o.np = round_up(N, 8);
  o.ws = (o.np / 8) % 2 ? o.np : o.np + 8;
  const int tiles = o.np / 8, steps = o.k32 / 32;
  int kw = 2 * kWarps / tiles;     // about two work items a warp,
  const int most = steps / 4;      // each at least 4 MMAs deep
  kw = kw > most ? most : kw;
  o.kw = kw < 1 ? 1 : kw;
  return o;
}

struct Plan {
  int err;
  int u, nb, C, wc;  // units and gate columns a CTA, W_proj columns a CTA
  int rg;            // batch rows a group
  Operand gate, proj;
  int hp, mp;  // row strides (bytes) of h and m in shared and global memory
  // shared-memory byte offsets, and the total
  int off_w, off_wp, off_h, off_m, off_part, off_gates, off_ax, off_c, off_cz,
      off_ms, off_ln, smem;
  // workspace byte offsets (zeroed by the caller for every launch)
  long long ws_stats, ws_mbuf, ws_hbuf, ws;
};

// cell: 0 = LSTM, 1 = GRU.  proj: the LSTM's projection (W_proj).
FP_HD Plan plan(int cell, int H, int d_out, int G, int B, int proj, int n_sm) {
  Plan p = {};
  if (H < 1 || d_out < 1 || G < 1 || G > 4 || B < 1 || n_sm < 1 ||
      (cell != 0 && cell != 1) || (cell == 1 && proj)) {
    p.err = kPlanBadShape;
    return p;
  }
  p.u = ceil_div(H, H < n_sm ? H : n_sm);
  p.nb = ceil_div(H, p.u);
  p.C = G * p.u;
  p.wc = proj ? ceil_div(d_out, p.nb) : 0;
  p.gate = operand(d_out, p.C);
  p.proj = operand(proj ? H : 32, proj ? p.wc : 8);
  // +16 bytes a row keeps the A fragments of 8 rows on distinct banks
  p.hp = p.gate.k32 + 16;
  p.mp = proj ? p.proj.k32 + 16 : 0;
  const int part = (p.gate.kw * p.gate.np > p.proj.kw * p.proj.np
                        ? p.gate.kw * p.gate.np
                        : p.proj.kw * p.proj.np) *
                   16 * 4;
  // the layout at rg rows a group; false where it exceeds one SM
  auto layout = [&](int rg) {
    long long off = 0;
    auto take = [&](long long bytes) {
      const long long at = off;
      off += (bytes + 15) & ~15LL;
      return static_cast<int>(at < kSmemMax ? at : kSmemMax);
    };
    p.off_w = take(static_cast<long long>(p.gate.k32) * p.gate.ws);
    p.off_wp = take(proj ? static_cast<long long>(p.proj.k32) * p.proj.ws : 0);
    p.off_h = take(static_cast<long long>(rg) * p.hp);
    p.off_m = take(static_cast<long long>(rg) * p.mp);
    p.off_part = take(part);
    p.off_gates = take(static_cast<long long>(rg) * p.C * 4);
    p.off_ax = take(static_cast<long long>(rg) * p.C * 4);
    p.off_c = take(cell == 0 ? static_cast<long long>(rg) * p.u * 2 : 0);
    p.off_cz = take(cell == 0 ? static_cast<long long>(rg) * p.u * 2 : 0);
    p.off_ms = take(proj ? static_cast<long long>(rg) * p.wc * 4 : 0);
    p.off_ln = take(static_cast<long long>(rg) * kSlots * 16);
    p.smem = static_cast<int>(off < kSmemMax ? off : kSmemMax + 1);
    return off <= kSmemMax;
  };
  int rg = B;
  if (!layout(rg)) {  // the most rows that fit, a multiple of 16 past 16
    layout(1);
    const long long row = p.hp + p.mp + 8LL * p.C + (cell == 0 ? 4LL * p.u : 0) +
                          4LL * p.wc + 16 * kSlots;
    rg = static_cast<int>((kSmemMax - p.smem) / row) + 1;
    rg = rg < B ? rg : B;
    while (rg > 0 && !layout(rg)) --rg;
    if (rg > 16) rg -= rg % 16;
    if (rg < 1 || !layout(rg)) {
      p.err = kPlanTooLarge;
      p.smem = kSmemMax + 1;
      return p;
    }
  }
  p.rg = rg;
  p.ws_stats = kBarrierBytes;
  p.ws_mbuf = p.ws_stats + 3LL * B * kSlots * 2 * 8;
  p.ws_hbuf = p.ws_mbuf + 2LL * B * p.mp;
  p.ws = p.ws_hbuf + 2LL * B * p.hp;
  return p;
}

#ifdef __CUDACC__

// Grid-wide barrier on a monotone arrival counter (zeroed per launch): the
// k-th barrier of the launch waits for k * nb arrivals.  Thread 0 arrives
// with a release add (after the block barrier, so it publishes every write
// its CTA made before the barrier) and polls with acquire loads, so every
// CTA sees those writes after it; data that other CTAs wrote is read with
// __ldcg (L2), never from a stale L1 line.  A wait that outlasts any step
// by orders of magnitude traps (a launch error) instead of hanging the
// card.
__device__ __forceinline__ void grid_sync(unsigned int* counter,
                                          unsigned int& target,
                                          unsigned int nb) {
  __syncthreads();
  target += nb;
  if (threadIdx.x == 0) {
    asm volatile("red.release.gpu.global.add.u32 [%0], 1;\n" ::"l"(counter)
                 : "memory");
    unsigned int seen;
    for (unsigned int spins = 0;; ++spins) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
                   : "=r"(seen)
                   : "l"(counter)
                   : "memory");
      if (seen >= target) break;
      if (spins == (1u << 26)) __trap();
    }
  }
  __syncthreads();
}

// 4 bytes from global to shared memory, asynchronously (cp.async); the
// copies land by the thread's next cp_async_wait_all
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// int64 add into a global total (two's complement wraps like int64)
__device__ __forceinline__ void add64(long long* dst, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(dst),
            static_cast<unsigned long long>(v));
}

// Load this CTA's gate columns of R (d_out x GH int8, row-major) into the
// operand layout: column c = k u + j holds R[:, k H + unit0 + j]; rows
// past d_out, units past `un` and the padding are 0.  A work item takes 4
// rows of 16 units of one gate: four 16-byte loads where the columns are
// 16-byte aligned (byte loads elsewhere), turned into 16 words by byte
// permutes and stored as four 16-byte words.
__device__ inline void load_gate_columns(uint32_t* W4, const Operand& op,
                                         const int8_t* __restrict__ R, int d_out,
                                         int H, int G, int u, int un, int unit0) {
  const int GH = G * H, ws = op.ws;
  const int nj = (u + 15) / 16;
  const bool vec = u % 16 == 0 && H % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(R) & 15) == 0;
  for (int idx = threadIdx.x; idx < (op.k32 / 4) * ws; idx += kThreads)
    W4[idx] = 0;  // padding columns and rows
  __syncthreads();
  for (int item = threadIdx.x; item < (op.k32 / 4) * G * nj; item += kThreads) {
    const int i4 = item / (G * nj), k = (item / nj) % G, j0 = (item % nj) * 16;
    int w[4][4];  // [row][column word]
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = 4 * i4 + r;
      const int8_t* src = R + (size_t)i * GH + k * H + unit0 + j0;
      if (vec && i < d_out && j0 + 16 <= un) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(src));
        w[r][0] = v.x;
        w[r][1] = v.y;
        w[r][2] = v.z;
        w[r][3] = v.w;
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t word = 0;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int j = j0 + 4 * q + e;
            if (i < d_out && j < un && j < u)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(src[4 * q + e]))
                      << (8 * e);
          }
          w[r][q] = static_cast<int>(word);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      int cols[4];
      pack::transpose4(w[0][q], w[1][q], w[2][q], w[3][q], cols);
      const int j = j0 + 4 * q;
      uint32_t* dst = W4 + (size_t)i4 * ws + k * u + j;
      if (j + 4 <= u && (u & 3) == 0) {  // 16-byte aligned: ws, k u, j % 4 == 0
        *reinterpret_cast<int4*>(dst) = make_int4(cols[0], cols[1], cols[2], cols[3]);
      } else {
        for (int e = 0; e < 4 && j + e < u; ++e) dst[e] = static_cast<uint32_t>(cols[e]);
      }
    }
  }
}

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1,
                                       uint32_t a2, uint32_t a3, uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// out[b * N + n] = sum_k x[b][k] * W[k][n] for b < B, n < N (exact int32:
// |sum| < 2**31 for K <= 2**17), with x as B rows of `xs` bytes in shared
// memory (zero past K) and W in the operand layout, on the int8 tensor
// cores: mma.sync m16n8k32, 16 rows a pass, each warp taking (column tile,
// K share) work items whose partial sums meet in `part`.
__device__ inline void matvec(const int8_t* x, int B, int xs, const uint32_t* W4,
                              const Operand& op, int N, int32_t* part,
                              int32_t* out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int tiles = op.np / 8, steps = op.k32 / 32, np = op.np;
  for (int b0 = 0; b0 < B; b0 += 16) {
    const int r0 = b0 + g, r1 = r0 + 8;
    const bool v0 = r0 < B, v1 = r1 < B;
    const int8_t* x0 = x + (size_t)(v0 ? r0 : 0) * xs + 4 * t4;
    const int8_t* x1 = x + (size_t)(v1 ? r1 : 0) * xs + 4 * t4;
    for (int item = warp; item < tiles * op.kw; item += kWarps) {
      const int nt = item % tiles, kc = item / tiles;
      const int s0 = kc * steps / op.kw, s1 = (kc + 1) * steps / op.kw;
      const uint32_t* w = W4 + t4 * op.ws + nt * 8 + g;
      int c[4] = {0, 0, 0, 0};
      for (int s = s0; s < s1; ++s) {
        const int kb = 32 * s;
        const uint32_t a0 = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kb) : 0u;
        const uint32_t a1 = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kb) : 0u;
        const uint32_t a2 = v0 ? *reinterpret_cast<const uint32_t*>(x0 + kb + 16) : 0u;
        const uint32_t a3 = v1 ? *reinterpret_cast<const uint32_t*>(x1 + kb + 16) : 0u;
        mma_s8(c, a0, a1, a2, a3, w[(kb / 4) * op.ws], w[(kb / 4 + 4) * op.ws]);
      }
      int32_t* pp = part + (kc * 16 + g) * np + nt * 8 + 2 * t4;
      pp[0] = c[0];
      pp[1] = c[1];
      pp[8 * np] = c[2];
      pp[8 * np + 1] = c[3];
    }
    __syncthreads();
    const int nr = B - b0 < 16 ? B - b0 : 16;
    for (int idx = threadIdx.x; idx < nr * N; idx += kThreads) {
      const int r = idx / N, n = idx % N;
      int32_t s = 0;
      for (int kc = 0; kc < op.kw; ++kc) s += part[(kc * 16 + r) * np + n];
      out[(b0 + r) * N + n] = s;
    }
    __syncthreads();
  }
}

// Copy B rows of `stride` bytes that other CTAs wrote (L2, not L1) into
// shared memory, 16 bytes a load.
__device__ __forceinline__ void load_rows(int8_t* dst, const int8_t* src, int B,
                                          int stride) {
  for (int idx = threadIdx.x; idx < B * stride / 16; idx += kThreads)
    reinterpret_cast<int4*>(dst)[idx] = __ldcg(reinterpret_cast<const int4*>(src) + idx);
}

// Copy B rows of h0 (`d` bytes a row, any alignment) into shared rows of
// `stride` bytes, zero past d.
__device__ __forceinline__ void load_h0(int8_t* dst, const int8_t* src, int B, int d,
                                        int stride) {
  for (int idx = threadIdx.x; idx < B * stride; idx += kThreads) {
    const int b = idx / stride, i = idx % stride;
    dst[idx] = i < d ? src[(size_t)b * d + i] : 0;
  }
}

// One row's LayerNorm multipliers from the grid's totals (sum, sum of
// squares over the n units): ln[0..3] = m0, shift, sum, degenerate.
__device__ __forceinline__ void ln_multipliers(const long long* tot, int n,
                                               int32_t* ln) {
  const long long a = __ldcg(tot), q = __ldcg(tot + 1);
  const long long v = (long long)n * q - a * a;  // >= 0, < 2**59
  int32_t m0, shift;
  fp::rsqrt_multiplier((uint64_t)v, 10, &m0, &shift);
  ln[0] = m0;
  ln[1] = shift;
  ln[2] = (int32_t)a;
  ln[3] = v == 0;
}

__device__ __forceinline__ int16_t ln_apply(const int32_t* ln, int n, int32_t q,
                                            int16_t lw, int32_t lb,
                                            const int (&out)[2]) {
  return fp::layernorm_apply(q, n, ln[2], ln[3] != 0, ln[0], ln[1], lw, lb,
                             out[0], out[1]);
}

#endif  // __CUDACC__

}  // namespace scan
