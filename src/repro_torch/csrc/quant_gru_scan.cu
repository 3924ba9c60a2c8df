// Cooperative integer GRU sequence kernel: the whole recurrent stage of one
// GRU layer in ONE launch, with the time loop inside the kernel.
//
// Replaces the GRU form of the TPU kernel `quant_recurrent_seq_scan_pallas`
// (repro/kernels/quant_lstm_scan.py, body `_scan_kernel`), whose body traces
// `quant_gru_recurrent_jnp` (repro/kernels/ref.py).  Per step t, for each
// row b, in the reference's order (reset-after GRU, gates [r|u|n] in the
// spec's column order):
//   acc_h = h @ R_cat + fold_hb_cat                      (int8 -> int32)
//   r, u  = sigmoid_q15(LN(sat16(mbqm(acc_x_g, eff_x) sat+ mbqm(acc_h_g, eff_h))), 3)
//   gh    = sat16(mbqm(acc_h_n, eff_h_n));  rg = rdbpot(r * gh, 15)
//   n     = tanh_q15(LN(sat16(mbqm(acc_x_n, eff_x_n) sat+ rg)), 3)
//   h'    = sat8(mbqm(u * (h - zp_h), eff_carry) sat+ mbqm((32768 - u) * n, eff_n)
//                + zp_h_out)
//   ys[b, t] = h'
// (LN only with use_ln.)  With `valid_len`, row b is frozen for
// t >= valid_len[b] and still writes its unchanged h to ys[b, t].
//
// What bounds it on an H100: the steps are sequential, and each reads R_cat
// (H x 3H int8, 12.6 MB at H = 2048; the GRU has no projection): more than
// one SM holds, less than the card's 132 SMs hold together.  The design is
// the LSTM kernel's (quant_lstm_scan.cu): one cooperative grid of NB <= 132
// CTAs, CTA n owning hidden units [n u, (n + 1) u) (u = 16 at full width:
// 128 CTAs, ~110 KB of R_cat each, loaded once per launch), every CTA
// serving all batch rows, a group of rows at a time, from the group's full
// h_{t-1} in its shared memory on the int8 tensor cores.  A step, per
// group: the group's h_{t-1} from a double-buffered global h; the r/u/n
// gate columns of its units; with LayerNorm, r's and u's totals (int64
// atomics), barrier; r/u activations side by side and the candidate's
// pre-activation; with LayerNorm, the candidate's totals, barrier; the
// u-blend of its units into the global h and ys.  One barrier after the
// last group publishes the step's h.
// int32 and int64 sums are exact in any order, so the result is
// bit-identical to the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "recurrent_scan.cuh"

namespace {

using scan::kSlots;
using scan::kThreads;

struct GruParams {
  const int32_t* acc_x;  // (B, T, 3H): hoisted input accumulator
  const int8_t* R;       // (H, 3H)
  const int32_t* fold_hb;
  const int16_t* L[3];  // per gate slot: LayerNorm weights or null
  const int32_t* Lb[3];
  const int8_t* h0;          // (B, H)
  const int32_t* valid_len;  // (B,) or null
  int8_t* ys;                // (B, T, H)
  int8_t* h_out;
  unsigned char* ws;  // zeroed workspace (scan::Plan::ws bytes)
  int B, T, H, use_ln;
  int slot_r, slot_u, slot_n;  // column block of each gate
  int eff_x[3][2], eff_h[3][2], ln_out[3][2];
  int eff_carry[2], eff_n[2];
  int zp_h, zp_h_out;
};

// this CTA's units' sum and sum of squares of gate block k, for the nr
// rows of the group at batch row g0, added into the grid's totals at
// LayerNorm slot `slot`
__device__ __forceinline__ void add_totals(const int32_t* gates, int nr, int g0,
                                           int C, int u, int un, int k, int slot,
                                           long long* st) {
  for (int r = threadIdx.x; r < nr; r += kThreads) {
    long long s = 0, q = 0;
    for (int j = 0; j < un; ++j) {
      const long long g = gates[r * C + k * u + j];
      s += g;
      q += g * g;
    }
    scan::add64(&st[((g0 + r) * kSlots + slot) * 2], s);
    scan::add64(&st[((g0 + r) * kSlots + slot) * 2 + 1], q);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    quant_gru_scan_kernel(GruParams p, scan::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H;
  const int u = pl.u, C = pl.C, hp = pl.hp, rg = pl.rg;
  const int unit0 = n * u, un = min(u, H - unit0);
  const int GH = 3 * H;
  uint32_t* W4 = reinterpret_cast<uint32_t*>(smem + pl.off_w);
  int8_t* hs = reinterpret_cast<int8_t*>(smem + pl.off_h);
  int32_t* part = reinterpret_cast<int32_t*>(smem + pl.off_part);
  int32_t* gates = reinterpret_cast<int32_t*>(smem + pl.off_gates);
  int32_t* ln = reinterpret_cast<int32_t*>(smem + pl.off_ln);
  int32_t* axs = reinterpret_cast<int32_t*>(smem + pl.off_ax);
  unsigned int* bar = reinterpret_cast<unsigned int*>(p.ws);
  long long* stats = reinterpret_cast<long long*>(p.ws + pl.ws_stats);
  int8_t* hbuf = reinterpret_cast<int8_t*>(p.ws + pl.ws_hbuf);

  scan::load_gate_columns(W4, pl.gate, p.R, H, H, 3, u, un, unit0);
  scan::load_h0(hs, p.h0, min(rg, B), H, hp);  // the first group's h0
  int maxlen = 0;
  for (int b = 0; b < B; ++b) {
    const int v = p.valid_len ? p.valid_len[b] : T;
    maxlen = v > maxlen ? v : maxlen;
  }
  const int steps = min(maxlen, T);  // the live steps; h then stays
  __syncthreads();

  unsigned int target = 0;
  const unsigned int nb = gridDim.x;
  const int kr = p.slot_r, ku = p.slot_u, kn = p.slot_n;
  const int n_st = B * kSlots * 2;
  // h after `steps` steps (other CTAs' writes: read from L2)
  auto h_final = [&](int b, int unit) -> int8_t {
    return steps == 0 ? p.h0[(size_t)b * H + unit]
                      : __ldcg(hbuf + (size_t)(steps & 1) * B * hp + (size_t)b * hp + unit);
  };

  for (int t = 0; t < T; ++t) {
    if (t >= steps) {  // every row frozen: ys[:, t] = h, its own units each
      for (int idx = tid; idx < B * un; idx += kThreads) {
        const int b = idx / un, unit = unit0 + idx % un;
        p.ys[((size_t)b * T + t) * H + unit] = h_final(b, unit);
      }
      continue;
    }
    const int cur = t % 3, nxt = (t + 1) % 3;
    long long* st = stats + cur * n_st;
    for (int idx = n * kThreads + tid; idx < n_st; idx += nb * kThreads)
      stats[nxt * n_st + idx] = 0;
    const int8_t* hb_cur = hbuf + (t & 1) * B * hp;  // h_{t-1} for t >= 1
    int8_t* hb_next = hbuf + ((t + 1) & 1) * B * hp;

    // the rows in groups of rg; r is a row of the group, b = g0 + r the
    // batch row
    for (int g0 = 0; g0 < B; g0 += rg) {
      const int nr = min(rg, B - g0);
      // 1. the group's h_{t-1}; gate columns of h_{t-1} @ R_cat (this
      //    step's slice of acc_x copied in meanwhile); r and u
      //    pre-activations (the candidate's block keeps its wrapped
      //    accumulator)
      for (int idx = tid; idx < nr * C; idx += kThreads) {
        const int b = g0 + idx / C, c = idx % C, j = c % u;
        if (j < un)
          scan::cp_async4(&axs[idx],
                          &p.acc_x[((size_t)b * T + t) * GH + (c / u) * H + unit0 + j]);
      }
      if (t == 0) {
        if (g0 > 0) scan::load_h0(hs, p.h0 + (size_t)g0 * H, nr, H, hp);
      } else {
        scan::load_rows(hs, hb_cur + (size_t)g0 * hp, nr, hp);  // padding 0
      }
      __syncthreads();
      scan::matvec(hs, nr, hp, W4, pl.gate, C, part, gates);
      scan::cp_async_wait_all();
      __syncthreads();
      for (int idx = tid; idx < nr * C; idx += kThreads) {
        const int c = idx % C, k = c / u, j = c % u;
        if (j >= un) continue;
        const int col = k * H + unit0 + j;
        const int32_t acc_h = fp::wrap32((int64_t)gates[idx] + p.fold_hb[col]);
        if (k == kn) {
          gates[idx] = acc_h;
          continue;
        }
        gates[idx] = fp::sat16(
            fp::sat_add(fp::mbqm(axs[idx], p.eff_x[k][0], p.eff_x[k][1]),
                        fp::mbqm(acc_h, p.eff_h[k][0], p.eff_h[k][1])));
      }
      __syncthreads();
      if (p.use_ln) {  // r's totals at slot 0, u's at slot 1
        add_totals(gates, nr, g0, C, u, un, kr, 0, st);
        add_totals(gates, nr, g0, C, u, un, ku, 1, st);
        scan::grid_sync(bar, target, nb);
        for (int idx = tid; idx < 2 * nr; idx += kThreads) {
          const int r = idx >> 1, e = idx & 1;
          scan::ln_multipliers(&st[((g0 + r) * kSlots + e) * 2], H,
                               &ln[(r * kSlots + e) * 4]);
        }
        __syncthreads();
      }

      // 2. the r and u activations side by side (u as Q0.15 in place),
      //    then the candidate's pre-activation
      //    n16 = sat16(mbqm(acc_x_n, eff_x_n) sat+ rdbpot(r * gh16, 15))
      for (int idx = tid; idx < 2 * nr * u; idx += kThreads) {
        const int e = idx / (nr * u), rj = idx % (nr * u), r = rj / u, j = rj % u;
        if (j >= un) continue;
        const int k = e == 0 ? kr : ku;
        int32_t* g = &gates[r * C + k * u + j];
        int32_t g16 = *g;
        if (p.use_ln)
          g16 = scan::ln_apply(&ln[(r * kSlots + e) * 4], H, g16, p.L[k][unit0 + j],
                               p.Lb[k][unit0 + j], p.ln_out[k]);
        *g = fp::sigmoid_q15(g16, 3);
      }
      __syncthreads();
      for (int idx = tid; idx < nr * u; idx += kThreads) {
        const int r = idx / u, j = idx % u;
        if (j >= un) continue;
        int32_t* gb = gates + r * C;
        const int32_t gh16 =
            fp::sat16(fp::mbqm(gb[kn * u + j], p.eff_h[kn][0], p.eff_h[kn][1]));
        const int32_t rg16 = fp::rdbpot(fp::wrap32((int64_t)gb[kr * u + j] * gh16), 15);
        gb[kn * u + j] = fp::sat16(fp::sat_add(
            fp::mbqm(axs[r * C + kn * u + j], p.eff_x[kn][0], p.eff_x[kn][1]), rg16));
      }
      __syncthreads();
      if (p.use_ln) {  // the candidate's totals at slot 2
        add_totals(gates, nr, g0, C, u, un, kn, 2, st);
        scan::grid_sync(bar, target, nb);
        for (int r = tid; r < nr; r += kThreads)
          scan::ln_multipliers(&st[((g0 + r) * kSlots + 2) * 2], H,
                               &ln[(r * kSlots + 2) * 4]);
        __syncthreads();
      }

      // 3. the integer u-blend of this CTA's units into the new h, in the
      //    grid's double-buffered h and in ys; a frozen row re-emits its h
      for (int idx = tid; idx < nr * u; idx += kThreads) {
        const int r = idx / u, j = idx % u, b = g0 + r;
        if (j >= un) continue;
        const int unit = unit0 + j;
        const int32_t* gb = gates + r * C;
        int32_t n16 = gb[kn * u + j];
        if (p.use_ln)
          n16 = scan::ln_apply(&ln[(r * kSlots + 2) * 4], H, n16, p.L[kn][unit],
                               p.Lb[kn][unit], p.ln_out[kn]);
        const int32_t n_act = fp::tanh_q15(n16, 3);
        const int32_t uu = gb[ku * u + j];
        const int8_t h_old = hs[r * hp + unit];
        const int32_t carry = fp::wrap32((int64_t)uu * ((int32_t)h_old - p.zp_h));
        const int32_t blend = fp::wrap32((int64_t)(32768 - uu) * n_act);
        const int32_t h_new = fp::sat_add(fp::mbqm(carry, p.eff_carry[0], p.eff_carry[1]),
                                          fp::mbqm(blend, p.eff_n[0], p.eff_n[1]));
        const bool live = p.valid_len == nullptr || t < p.valid_len[b];
        const int8_t h = live ? fp::sat8(fp::wrap32((int64_t)h_new + p.zp_h_out)) : h_old;
        hb_next[b * hp + unit] = h;
        p.ys[((size_t)b * T + t) * H + unit] = h;
        if (t == steps - 1) p.h_out[(size_t)b * H + unit] = h;
      }
      // the group's new h is read next in step t + 1: the last group's
      // barrier publishes every group's (a group reads only its own rows)
      if (g0 + nr == B)
        scan::grid_sync(bar, target, nb);
      else
        __syncthreads();
    }
  }
  if (steps == 0)  // no live step: h_out = h0 (else the last step wrote it)
    for (int idx = tid; idx < B * un; idx += kThreads) {
      const int b = idx / un, unit = unit0 + idx % un;
      p.h_out[(size_t)b * H + unit] = p.h0[(size_t)b * H + unit];
    }
}

}  // namespace

// Plain C entry point (bound with ctypes).
//   ptrs: acc_x, R, fold_hb, L[3], Lb[3], h0, valid_len, ys, h_out, ws
//                                                          (14 pointers)
//   ints: T, H, use_ln, slot_r, slot_u, slot_n, eff_x[3][2], eff_h[3][2],
//         ln_out[3][2], eff_carry[2], eff_n[2], zp_h, zp_h_out (30 ints)
// `ws` is a zeroed workspace of the plan's bytes; n_sm the card's SMs.
// Returns cudaGetLastError() (or the first failing call's error;
// cudaErrorInvalidValue where the plan refuses the shapes).
extern "C" int quant_gru_scan_launch(const void* const* ptrs, const int32_t* ints,
                                     int B, int n_sm, void* stream) {
  GruParams p;
  int i = 0;
  p.acc_x = static_cast<const int32_t*>(ptrs[i++]);
  p.R = static_cast<const int8_t*>(ptrs[i++]);
  p.fold_hb = static_cast<const int32_t*>(ptrs[i++]);
  for (int k = 0; k < 3; ++k) p.L[k] = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 3; ++k) p.Lb[k] = static_cast<const int32_t*>(ptrs[i++]);
  p.h0 = static_cast<const int8_t*>(ptrs[i++]);
  p.valid_len = static_cast<const int32_t*>(ptrs[i++]);
  p.ys = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.h_out = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.ws = static_cast<unsigned char*>(const_cast<void*>(ptrs[i++]));

  int j = 0;
  p.B = B;
  p.T = ints[j++];
  p.H = ints[j++];
  p.use_ln = ints[j++];
  p.slot_r = ints[j++];
  p.slot_u = ints[j++];
  p.slot_n = ints[j++];
  for (int k = 0; k < 3; ++k) for (int l = 0; l < 2; ++l) p.eff_x[k][l] = ints[j++];
  for (int k = 0; k < 3; ++k) for (int l = 0; l < 2; ++l) p.eff_h[k][l] = ints[j++];
  for (int k = 0; k < 3; ++k) for (int l = 0; l < 2; ++l) p.ln_out[k][l] = ints[j++];
  p.eff_carry[0] = ints[j++];
  p.eff_carry[1] = ints[j++];
  p.eff_n[0] = ints[j++];
  p.eff_n[1] = ints[j++];
  p.zp_h = ints[j++];
  p.zp_h_out = ints[j++];

  const scan::Plan pl = scan::plan(1, p.H, p.H, 3, B, 0, n_sm);
  if (pl.err != scan::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      quant_gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p, const_cast<scan::Plan*>(&pl)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(quant_gru_scan_kernel),
                                    dim3(pl.nb), dim3(kThreads), args, pl.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch at (H, B) on n_sm SMs: out = {u, nb, rg, smem, ws}.
// Returns 0, or the scan::PlanError that refuses the shapes.
extern "C" int quant_gru_scan_plan(int H, int B, int n_sm, long long* out) {
  const scan::Plan pl = scan::plan(1, H, H, 3, B, 0, n_sm);
  const long long vals[5] = {pl.u, pl.nb, pl.rg, pl.smem, pl.ws};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return pl.err;
}
