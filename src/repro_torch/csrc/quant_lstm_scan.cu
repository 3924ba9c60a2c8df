// Cooperative integer LSTM sequence kernel: the whole recurrent stage of one
// layer in ONE launch, with the time loop inside the kernel.
//
// Replaces the TPU kernel `quant_recurrent_seq_scan_pallas`
// (repro/kernels/quant_lstm_scan.py, body `_scan_kernel`), whose body traces
// `recurrent_step_jnp` (repro/kernels/ref.py).  Per step t, for each row b:
//   acc_h = h @ R_cat + fold_hb_cat                      (int8 -> int32)
//   gate_g = sat16(mbqm(acc_x[b,t,g], eff_x) sat+ mbqm(acc_h[g], eff_h)
//                  [sat+ mbqm(P_g * c, eff_c)])  -> integer LayerNorm
//   c = sat16(rdbpot(i*z, 30 - n_c) sat+ rdbpot(f*c, 15)); o finished on c
//   m = sat8(mbqm(o * tanh(c), eff_m) + zp_m); h = projection(m) or m
// The gate prologue (cell::gate_preact) and the cell (c, the peephole o
// gate, m) are the device code of lstm_cell.cuh, which the gate pass
// (int_layernorm.cu) and the standalone cell kernel (quant_lstm_cell.cu)
// run too.
//   ys[b, t] = h
// All 16 LSTM variants run through runtime flags (use_layernorm,
// use_projection, use_peephole, use_cifg; G = 3 or 4 gate blocks).  With
// `valid_len`, row b is frozen for t >= valid_len[b] and still writes its
// unchanged h to ys[b, t], as the TPU kernel does.
//
// What bounds it on an H100: the steps are sequential, and each reads the
// layer's recurrent weights, R_cat (d_out x 4H int8, 5.2 MB at full width)
// and W_proj (H x d_proj, 1.3 MB): more than one SM holds, less than the
// card's 132 SMs hold together.  So the weights stay in shared memory for
// the whole launch, split by hidden unit: one cooperative grid of NB <= 132
// CTAs (recurrent_scan.cuh's plan: u = 16 units a CTA at full width, 128
// CTAs, 80-135 KB each), loaded once (6.5 MB at 3.35 TB/s: ~2 us), each
// CTA serving every batch row, so a step reads each weight once from
// shared memory and uses it B times, on the int8 tensor cores (mma.sync
// m16n8k32).  The rows pass in groups of the plan's rg (all B rows where
// they fit beside the weights), so B is not bounded by shared memory.  A
// step is then bound by its grid barriers (2 or 3 a group, ~1 us each on
// the card; PERF.md) and the latency of its phases, per group:
//   1. every CTA reads the group's full h_{t-1} (rg x d_out) from a
//      double-buffered global h into shared memory and forms its G u gate
//      columns while its slice of acc_x is copied in (cp.async), then
//      rescales and saturates (peephole i/f on its own c);
//   2. with LayerNorm, it adds its units' partial sum and sum of squares
//      per (row, gate) into int64 totals with atomics; barrier; each CTA
//      derives the row's LayerNorm multipliers from the totals itself;
//   3. the gates' activations (one a thread), the cell on its units; a
//      peephole o gate under LayerNorm has its own totals and barrier;
//   4. with projection, each CTA writes its units' m into a double-buffered
//      global m; barrier; every CTA reads the group's full m and forms its
//      columns of the projected h (W_proj[:, its columns] in its shared
//      memory) into the global h and ys.  Without projection, each CTA
//      writes its units' m (= h) there directly.
// One barrier after the last group publishes the step's h.  A CTA's c
// stays in shared memory where one group holds every row, else in c_out
// (its own units: no other CTA reads them) between groups.
// The LayerNorm totals rotate over three buffers, the one for step t + 1
// zeroed during step t.  int64 sums are associative and commutative, so
// atomics in any order, like the tensor cores' exact int32 sums, give
// results bit-identical to the plain version (kernels/ref.py).
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "lstm_cell.cuh"
#include "recurrent_scan.cuh"

namespace {

using scan::kSlots;
using scan::kThreads;

struct ScanParams {
  const int32_t* acc_x;  // (B, T, G*H): hoisted input accumulator
  const int8_t* R;       // (d_out, G*H)
  const int32_t* fold_hb;
  const int16_t* P[4];  // per gate slot: peephole weights (i, f, o) or null
  const int16_t* L[4];  // per gate slot: LayerNorm weights or null
  const int32_t* Lb[4];
  const int8_t* W_proj;  // (H, d_out) or null
  const int32_t* fold_proj;
  const int8_t* h0;          // (B, d_out)
  const int16_t* c0;         // (B, H)
  const int32_t* valid_len;  // (B,) or null
  int8_t* ys;                // (B, T, d_out)
  int8_t* h_out;
  int16_t* c_out;
  unsigned char* ws;  // zeroed workspace (scan::Plan::ws bytes)
  int B, T, H, d_out, G;
  int use_ln, use_proj, use_ph, cifg;
  int slot_i, slot_f, slot_z, slot_o;  // column block of each gate (-1: none)
  int eff_x[4][2], eff_h[4][2], eff_c[4][2], ln_out[4][2];
  int eff_m[2], eff_proj[2];
  int zp_m, zp_h_out, cell_int_bits;
};

__global__ void __launch_bounds__(kThreads, 1)
    quant_lstm_scan_kernel(ScanParams p, scan::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = blockIdx.x, tid = threadIdx.x;
  const int B = p.B, T = p.T, H = p.H, G = p.G, d_out = p.d_out;
  const int u = pl.u, C = pl.C, hp = pl.hp, mp = pl.mp, wc = pl.wc, rg = pl.rg;
  const bool one = rg >= B;  // one group: c stays in shared memory
  const int unit0 = n * u, un = min(u, H - unit0);
  const int pc0 = n * wc, pcn = max(0, min(wc, d_out - pc0));  // W_proj columns
  const int GH = G * H;
  uint32_t* W4 = reinterpret_cast<uint32_t*>(smem + pl.off_w);
  uint32_t* Wp4 = reinterpret_cast<uint32_t*>(smem + pl.off_wp);
  int8_t* hs = reinterpret_cast<int8_t*>(smem + pl.off_h);
  int8_t* mfull = reinterpret_cast<int8_t*>(smem + pl.off_m);
  int32_t* part = reinterpret_cast<int32_t*>(smem + pl.off_part);
  int32_t* gates = reinterpret_cast<int32_t*>(smem + pl.off_gates);
  int16_t* cs = reinterpret_cast<int16_t*>(smem + pl.off_c);
  int32_t* macc = reinterpret_cast<int32_t*>(smem + pl.off_ms);
  int32_t* ln = reinterpret_cast<int32_t*>(smem + pl.off_ln);
  int32_t* axs = reinterpret_cast<int32_t*>(smem + pl.off_ax);
  int16_t* cz = reinterpret_cast<int16_t*>(smem + pl.off_cz);  // c_new
  unsigned int* bar = reinterpret_cast<unsigned int*>(p.ws);
  long long* stats = reinterpret_cast<long long*>(p.ws + pl.ws_stats);
  int8_t* mbuf = reinterpret_cast<int8_t*>(p.ws + pl.ws_mbuf);
  int8_t* hbuf = reinterpret_cast<int8_t*>(p.ws + pl.ws_hbuf);

  // the slice of the weights, once; the first group's h0; c0 into shared
  // memory (one group) or, past one group, into c_out, where this CTA
  // keeps its units' c between groups
  scan::load_gate_columns(W4, pl.gate, p.R, d_out, H, G, u, un, unit0);
  scan::load_h0(hs, p.h0, min(rg, B), d_out, hp);
  if (p.use_proj) {  // W_proj[:, pc0 .. pc0 + pcn) as words of 4 rows
    const int ws = pl.proj.ws;
    for (int idx = tid; idx < (pl.proj.k32 / 4) * ws; idx += kThreads) {
      const int i4 = idx / ws, c = idx % ws;
      uint32_t word = 0;
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * i4 + e;
        if (c < pcn && i < H)
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      p.W_proj[(size_t)i * d_out + pc0 + c]))
                  << (8 * e);
      }
      Wp4[idx] = word;
    }
  }
  for (int idx = tid; idx < B * u; idx += kThreads) {
    const int b = idx / u, j = idx % u;
    if (one)
      cs[idx] = j < un ? p.c0[(size_t)b * H + unit0 + j] : 0;
    else if (j < un)
      p.c_out[(size_t)b * H + unit0 + j] = p.c0[(size_t)b * H + unit0 + j];
  }
  int maxlen = 0;
  for (int b = 0; b < B; ++b) {
    const int v = p.valid_len ? p.valid_len[b] : T;
    maxlen = v > maxlen ? v : maxlen;
  }
  const int steps = min(maxlen, T);  // the live steps; h then stays
  __syncthreads();

  unsigned int target = 0;
  const unsigned int nb = gridDim.x;
  const int slot_o_late = p.use_ph ? p.slot_o : -1;  // finished after c_new
  const int yc = (d_out + pl.nb - 1) / pl.nb;        // h columns a CTA copies
  const int col0 = n * yc, col1 = min(d_out, col0 + yc);
  const int n_st = B * kSlots * 2;
  // h after `steps` steps (other CTAs' writes: read from L2)
  auto h_final = [&](int b, int col) -> int8_t {
    return steps == 0 ? p.h0[(size_t)b * d_out + col]
                      : __ldcg(hbuf + (size_t)(steps & 1) * B * hp + (size_t)b * hp + col);
  };

  for (int t = 0; t < T; ++t) {
    if (t >= steps) {  // every row frozen: ys[:, t] = h, a share of columns each
      for (int idx = tid; idx < B * (col1 - col0); idx += kThreads) {
        const int b = idx / (col1 - col0), col = col0 + idx % (col1 - col0);
        p.ys[((size_t)b * T + t) * d_out + col] = h_final(b, col);
      }
      continue;
    }
    const int cur = t % 3, nxt = (t + 1) % 3;
    long long* st = stats + cur * n_st;
    // zero step t + 1's totals (read last in step t - 2)
    for (int idx = n * kThreads + tid; idx < n_st; idx += nb * kThreads)
      stats[nxt * n_st + idx] = 0;
    const int8_t* hb_cur = hbuf + (t & 1) * B * hp;  // h_{t-1} for t >= 1
    int8_t* mb_next = mbuf + ((t + 1) & 1) * B * mp;
    int8_t* hb_next = hbuf + ((t + 1) & 1) * B * hp;

    // the rows in groups of rg; r is a row of the group, b = g0 + r the
    // batch row
    for (int g0 = 0; g0 < B; g0 += rg) {
      const int nr = min(rg, B - g0);
      // 1. the group's h_{t-1} (and, past one group, its c); gate columns
      //    of h_{t-1} @ R_cat (this step's slice of acc_x copied in
      //    meanwhile), then the pre-activations
      for (int idx = tid; idx < nr * C; idx += kThreads) {
        const int b = g0 + idx / C, c = idx % C, j = c % u;
        if (j < un)
          scan::cp_async4(&axs[idx],
                          &p.acc_x[((size_t)b * T + t) * GH + (c / u) * H + unit0 + j]);
      }
      if (t == 0) {
        if (g0 > 0) scan::load_h0(hs, p.h0 + (size_t)g0 * d_out, nr, d_out, hp);
      } else {
        scan::load_rows(hs, hb_cur + (size_t)g0 * hp, nr, hp);  // padding 0
      }
      if (!one)
        for (int idx = tid; idx < nr * u; idx += kThreads) {
          const int b = g0 + idx / u, j = idx % u;
          cs[idx] = j < un ? p.c_out[(size_t)b * H + unit0 + j] : 0;
        }
      __syncthreads();
      scan::matvec(hs, nr, hp, W4, pl.gate, C, part, gates);
      scan::cp_async_wait_all();
      __syncthreads();
      for (int idx = tid; idx < nr * C; idx += kThreads) {
        const int r = idx / C, c = idx % C, k = c / u, j = c % u;
        if (j >= un) continue;
        const int col = k * H + unit0 + j;
        const int32_t acc_h = fp::wrap32((int64_t)gates[idx] + p.fold_hb[col]);
        // an i/f peephole reads the old c; the late o is finished on c_new
        const bool has_c = p.use_ph && k != p.slot_z && k != slot_o_late;
        const cell::GateScale sc = {p.eff_x[k][0], p.eff_x[k][1], p.eff_h[k][0],
                                    p.eff_h[k][1], p.eff_c[k][0], p.eff_c[k][1], has_c};
        const int32_t g = cell::gate_preact(sc, axs[idx], acc_h,
                                            has_c ? p.P[k][unit0 + j] : 0,
                                            has_c ? cs[r * u + j] : 0);
        // the late o keeps its int32 pre-peephole accumulator
        gates[idx] = k == slot_o_late ? g : fp::sat16(g);
      }
      __syncthreads();

      // 2. LayerNorm over the H units of each (row, gate): totals, barrier
      if (p.use_ln) {
        for (int idx = tid; idx < nr * G; idx += kThreads) {
          const int r = idx / G, k = idx % G;
          if (k == slot_o_late) continue;
          long long s = 0, q = 0;
          for (int j = 0; j < un; ++j) {
            const long long g = gates[r * C + k * u + j];
            s += g;
            q += g * g;
          }
          scan::add64(&st[((g0 + r) * kSlots + k) * 2], s);
          scan::add64(&st[((g0 + r) * kSlots + k) * 2 + 1], q);
        }
        scan::grid_sync(bar, target, nb);
        for (int idx = tid; idx < nr * G; idx += kThreads) {
          const int r = idx / G, k = idx % G;
          if (k != slot_o_late)
            scan::ln_multipliers(&st[((g0 + r) * kSlots + k) * 2], H,
                                 &ln[(r * kSlots + k) * 4]);
        }
        __syncthreads();
        for (int idx = tid; idx < nr * C; idx += kThreads) {
          const int r = idx / C, c = idx % C, k = c / u, j = c % u;
          if (j >= un || k == slot_o_late) continue;
          gates[idx] = scan::ln_apply(&ln[(r * kSlots + k) * 4], H, gates[idx],
                                      p.L[k][unit0 + j], p.Lb[k][unit0 + j],
                                      p.ln_out[k]);
        }
        __syncthreads();
      }

      // 3. the cell on this CTA's units.  The gates' activations first, one
      //    a thread (sigmoid for i, f and an o without peephole, tanh for
      //    z), in place; then c_new (a frozen row keeps its c) and the
      //    peephole o gate on it
      for (int idx = tid; idx < nr * C; idx += kThreads) {
        const int c = idx % C, k = c / u;
        if (c % u >= un || k == slot_o_late) continue;
        gates[idx] = k == p.slot_z ? fp::tanh_q15(gates[idx], 3)
                                   : fp::sigmoid_q15(gates[idx], 3);
      }
      __syncthreads();
      for (int idx = tid; idx < nr * u; idx += kThreads) {
        const int r = idx / u, j = idx % u;
        if (j >= un) continue;
        int32_t* gb = gates + r * C;
        const int32_t f_act = gb[p.slot_f * u + j];
        const int32_t i_act = p.cifg ? cell::cifg_input(f_act) : gb[p.slot_i * u + j];
        const int16_t c_new = cell::combine_c(i_act, f_act, gb[p.slot_z * u + j],
                                              cs[idx], p.cell_int_bits);
        if (p.valid_len == nullptr || t < p.valid_len[g0 + r]) {
          cs[idx] = c_new;
          if (!one) p.c_out[(size_t)(g0 + r) * H + unit0 + j] = c_new;
        }
        if (slot_o_late >= 0) {
          const int k = slot_o_late;
          gb[k * u + j] = cell::o_peephole(gb[k * u + j], p.P[k][unit0 + j], c_new,
                                           p.eff_c[k][0], p.eff_c[k][1]);
        }
        cz[idx] = c_new;
      }
      __syncthreads();
      if (slot_o_late >= 0 && p.use_ln) {
        const int k = slot_o_late;
        for (int r = tid; r < nr; r += kThreads) {
          long long s = 0, q = 0;
          for (int j = 0; j < un; ++j) {
            const long long g = gates[r * C + k * u + j];
            s += g;
            q += g * g;
          }
          scan::add64(&st[((g0 + r) * kSlots + kSlots - 1) * 2], s);
          scan::add64(&st[((g0 + r) * kSlots + kSlots - 1) * 2 + 1], q);
        }
        scan::grid_sync(bar, target, nb);
        for (int r = tid; r < nr; r += kThreads)
          scan::ln_multipliers(&st[((g0 + r) * kSlots + kSlots - 1) * 2], H,
                               &ln[(r * kSlots + kSlots - 1) * 4]);
        __syncthreads();
        for (int idx = tid; idx < nr * u; idx += kThreads) {
          const int r = idx / u, j = idx % u;
          if (j >= un) continue;
          int32_t* g = &gates[r * C + k * u + j];
          *g = scan::ln_apply(&ln[(r * kSlots + kSlots - 1) * 4], H, *g,
                              p.L[k][unit0 + j], p.Lb[k][unit0 + j], p.ln_out[k]);
        }
        __syncthreads();
      }
      // sigmoid of the peephole o gate and tanh(c_new), side by side (the
      // latter in z's place, whose activation is spent)
      for (int idx = tid; idx < 2 * nr * u; idx += kThreads) {
        const int e = idx / (nr * u), rj = idx % (nr * u), r = rj / u, j = rj % u;
        if (j >= un) continue;
        if (e == 0) {
          gates[r * C + p.slot_z * u + j] = fp::tanh_q15(cz[rj], p.cell_int_bits);
        } else if (slot_o_late >= 0) {
          int32_t* g = &gates[r * C + slot_o_late * u + j];
          *g = fp::sigmoid_q15(*g, 3);
        }
      }
      __syncthreads();

      // 4. m = sat8(mbqm(sigmoid(o) * tanh(c), eff_m) + zp_m) on this CTA's
      //    units.  With projection m goes to the grid's double-buffered m;
      //    without, m IS the new h (a frozen row re-emits its h), written
      //    to the grid's double-buffered h and to ys
      for (int idx = tid; idx < nr * u; idx += kThreads) {
        const int r = idx / u, j = idx % u, b = g0 + r;
        if (j >= un) continue;
        const int8_t m = cell::hidden_from_acts(
            gates[r * C + p.slot_o * u + j], gates[r * C + p.slot_z * u + j],
            p.eff_m[0], p.eff_m[1], p.zp_m);
        if (p.use_proj) {
          mb_next[b * mp + unit0 + j] = m;
        } else {
          const bool live = p.valid_len == nullptr || t < p.valid_len[b];
          const int8_t h = live ? m : hs[r * hp + unit0 + j];
          hb_next[b * hp + unit0 + j] = h;
          p.ys[((size_t)b * T + t) * d_out + unit0 + j] = h;
          if (t == steps - 1) p.h_out[(size_t)b * d_out + unit0 + j] = h;
        }
      }
      // 5. with projection: barrier; every CTA takes the group's full m and
      //    forms its W_proj columns of h = sat8(mbqm(m @ W_proj + fold_proj,
      //    eff_proj) + zp_h) into the grid's h and ys
      if (p.use_proj) {
        scan::grid_sync(bar, target, nb);
        scan::load_rows(mfull, mb_next + (size_t)g0 * mp, nr, mp);
        __syncthreads();
        scan::matvec(mfull, nr, mp, Wp4, pl.proj, wc, part, macc);
        for (int idx = tid; idx < nr * pcn; idx += kThreads) {
          const int r = idx / pcn, c = idx % pcn, col = pc0 + c, b = g0 + r;
          const bool live = p.valid_len == nullptr || t < p.valid_len[b];
          const int32_t acc =
              fp::wrap32((int64_t)macc[r * wc + c] + p.fold_proj[col]);
          const int8_t h =
              live ? fp::sat8(fp::wrap32((int64_t)fp::mbqm(acc, p.eff_proj[0],
                                                           p.eff_proj[1]) +
                                         p.zp_h_out))
                   : hs[r * hp + col];
          hb_next[b * hp + col] = h;
          p.ys[((size_t)b * T + t) * d_out + col] = h;
          if (t == steps - 1) p.h_out[(size_t)b * d_out + col] = h;
        }
      }
      // the group's new h is read next in step t + 1: the last group's
      // barrier publishes every group's (a group reads only its own rows)
      if (g0 + nr == B)
        scan::grid_sync(bar, target, nb);
      else
        __syncthreads();
    }
  }
  if (one)
    for (int idx = tid; idx < B * un; idx += kThreads) {
      const int b = idx / un, j = idx % un;
      p.c_out[(size_t)b * H + unit0 + j] = cs[b * u + j];
    }
  if (steps == 0)  // no live step: h_out = h0 (else the last step wrote it)
    for (int idx = tid; idx < B * (col1 - col0); idx += kThreads) {
      const int b = idx / (col1 - col0), col = col0 + idx % (col1 - col0);
      p.h_out[(size_t)b * d_out + col] = p.h0[(size_t)b * d_out + col];
    }
}

}  // namespace

// Plain C entry point (bound with ctypes).
//   ptrs: acc_x, R, fold_hb, P[4], L[4], Lb[4], W_proj, fold_proj, h0, c0,
//         valid_len, ys, h_out, c_out, ws                  (24 pointers)
//   ints: T, H, d_out, G, use_ln, use_proj, use_ph, cifg, slot_i, slot_f,
//         slot_z, slot_o, eff_x[4][2], eff_h[4][2], eff_c[4][2],
//         ln_out[4][2], eff_m[2], eff_proj[2], zp_m, zp_h_out,
//         cell_int_bits                                   (51 ints)
// `ws` is a zeroed workspace of the plan's bytes; n_sm the card's SMs.
// Returns cudaGetLastError() (or the first failing call's error;
// cudaErrorInvalidValue where the plan refuses the shapes).
extern "C" int quant_lstm_scan_launch(const void* const* ptrs, const int32_t* ints,
                                      int B, int n_sm, void* stream) {
  ScanParams p;
  int i = 0;
  p.acc_x = static_cast<const int32_t*>(ptrs[i++]);
  p.R = static_cast<const int8_t*>(ptrs[i++]);
  p.fold_hb = static_cast<const int32_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.P[k] = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.L[k] = static_cast<const int16_t*>(ptrs[i++]);
  for (int k = 0; k < 4; ++k) p.Lb[k] = static_cast<const int32_t*>(ptrs[i++]);
  p.W_proj = static_cast<const int8_t*>(ptrs[i++]);
  p.fold_proj = static_cast<const int32_t*>(ptrs[i++]);
  p.h0 = static_cast<const int8_t*>(ptrs[i++]);
  p.c0 = static_cast<const int16_t*>(ptrs[i++]);
  p.valid_len = static_cast<const int32_t*>(ptrs[i++]);
  p.ys = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.h_out = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.c_out = static_cast<int16_t*>(const_cast<void*>(ptrs[i++]));
  p.ws = static_cast<unsigned char*>(const_cast<void*>(ptrs[i++]));

  int j = 0;
  p.B = B;
  p.T = ints[j++];
  p.H = ints[j++];
  p.d_out = ints[j++];
  p.G = ints[j++];
  p.use_ln = ints[j++];
  p.use_proj = ints[j++];
  p.use_ph = ints[j++];
  p.cifg = ints[j++];
  p.slot_i = ints[j++];
  p.slot_f = ints[j++];
  p.slot_z = ints[j++];
  p.slot_o = ints[j++];
  for (int k = 0; k < 4; ++k) for (int l = 0; l < 2; ++l) p.eff_x[k][l] = ints[j++];
  for (int k = 0; k < 4; ++k) for (int l = 0; l < 2; ++l) p.eff_h[k][l] = ints[j++];
  for (int k = 0; k < 4; ++k) for (int l = 0; l < 2; ++l) p.eff_c[k][l] = ints[j++];
  for (int k = 0; k < 4; ++k) for (int l = 0; l < 2; ++l) p.ln_out[k][l] = ints[j++];
  p.eff_m[0] = ints[j++];
  p.eff_m[1] = ints[j++];
  p.eff_proj[0] = ints[j++];
  p.eff_proj[1] = ints[j++];
  p.zp_m = ints[j++];
  p.zp_h_out = ints[j++];
  p.cell_int_bits = ints[j++];

  const scan::Plan pl = scan::plan(0, p.H, p.d_out, p.G, B, p.use_proj, n_sm);
  if (pl.err != scan::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      quant_lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* args[] = {&p, const_cast<scan::Plan*>(&pl)};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(quant_lstm_scan_kernel),
                                    dim3(pl.nb), dim3(kThreads), args, pl.smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The plan of a launch at (H, d_out, G, B, proj) on n_sm SMs: out = {u,
// nb, rg, smem, ws}.  Returns 0, or the scan::PlanError that refuses the
// shapes.
extern "C" int quant_lstm_scan_plan(int H, int d_out, int G, int B, int proj,
                                    int n_sm, long long* out) {
  const scan::Plan pl = scan::plan(0, H, d_out, G, B, proj, n_sm);
  const long long vals[5] = {pl.u, pl.nb, pl.rg, pl.smem, pl.ws};
  for (int i = 0; i < 5; ++i) out[i] = vals[i];
  return pl.err;
}

// The cost of the grid barrier alone, for measuring it on the card: one
// cooperative grid of nb CTAs (kThreads each) passing n_barriers of
// scan::grid_sync.  `counter` is a zeroed unsigned int in device memory.
// No serving path launches it.
__global__ void __launch_bounds__(kThreads, 1)
    grid_sync_probe_kernel(unsigned int* counter, int n_barriers) {
  unsigned int target = 0;
  for (int i = 0; i < n_barriers; ++i) scan::grid_sync(counter, target, gridDim.x);
}

extern "C" int quant_scan_barrier_probe(void* counter, int n_barriers, int nb,
                                        void* stream) {
  void* args[] = {&counter, &n_barriers};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(grid_sync_probe_kernel), dim3(nb), dim3(kThreads),
      args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
