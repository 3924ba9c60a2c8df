// Persistent integer LSTM sequence kernel: the whole recurrent stage of one
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
// The cell (c, the peephole o gate, m) is the device code of lstm_cell.cuh,
// which the standalone cell kernel (quant_lstm_cell.cu) runs too.
//   ys[b, t] = h
// All 16 LSTM variants run through runtime flags (use_layernorm,
// use_projection, use_peephole, use_cifg; G = 3 or 4 gate blocks).  With
// `valid_len`, row b is frozen for t >= valid_len[b] and still writes its
// unchanged h to ys[b, t], as the TPU kernel does.
//
// What bounds it on an H100: every step re-reads R_cat (d_out x 4H int8,
// 5.2 MB at full width) and W_proj (H x d_proj, 1.3 MB), which no SM's
// shared memory can hold, and the steps are sequential.  The ideal is
// bytes: the weights once per step from L2.  This first design gives each
// batch row its own thread block (rows are independent), so there is no
// grid-wide barrier: h, c, m, the row's 4H int32 gate accumulators and the
// LayerNorm statistics stay in shared memory for the whole sweep, and each
// step streams R_cat and W_proj with coalesced 16-byte loads, several in
// flight per thread, multiplied 4 rows at a time with __dp4a.  It reads
// the weights B times per step and uses only B SMs; splitting gate columns
// across blocks with a grid barrier for LayerNorm and projection is the
// later performance design.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "lstm_cell.cuh"
#include "recurrent_scan.cuh"

namespace {

using scan::kPartInts;
using scan::kThreads;
using scan::LNStats;
using scan::ln_stats;
using scan::matvec;

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
  int T, H, d_out, G;
  int use_ln, use_proj, use_ph, cifg;
  int slot_i, slot_f, slot_z, slot_o;  // column block of each gate (-1: none)
  int eff_x[4][2], eff_h[4][2], eff_c[4][2], ln_out[4][2];
  int eff_m[2], eff_proj[2];
  int zp_m, zp_h_out, cell_int_bits;
};

__global__ void __launch_bounds__(kThreads, 1) quant_lstm_scan_kernel(ScanParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LNStats st;
  const int GH = p.G * p.H;
  const int H = p.H;
  int32_t* gates = reinterpret_cast<int32_t*>(smem);     // [G*H]
  int32_t* part = gates + GH;                             // [kPartInts]
  int16_t* c = reinterpret_cast<int16_t*>(part + kPartInts);     // [H]
  int8_t* h = reinterpret_cast<int8_t*>(c + ((H + 7) & ~7));     // [d_out]
  int8_t* m = h + ((p.d_out + 15) & ~15);                        // [H]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < p.d_out; j += kThreads) h[j] = p.h0[(size_t)b * p.d_out + j];
  for (int j = tid; j < H; j += kThreads) c[j] = p.c0[(size_t)b * H + j];
  __syncthreads();

  const int vlen = p.valid_len ? p.valid_len[b] : p.T;
  // with a peephole the o gate is finished after c_new (and LN'd there)
  const int slot_o_late = p.use_ph ? p.slot_o : -1;

  for (int t = 0; t < p.T; ++t) {
    int8_t* ys_t = p.ys + ((size_t)b * p.T + t) * p.d_out;
    if (t >= vlen) {  // frozen row: state unchanged, leaf 0 still emitted
      for (int j = tid; j < p.d_out; j += kThreads) ys_t[j] = h[j];
      continue;
    }
    const int32_t* ax = p.acc_x + ((size_t)b * p.T + t) * GH;

    // 1. recurrent product h @ R_cat + fold_hb_cat into `gates`
    matvec(h, p.d_out, p.R, GH, p.fold_hb, gates, part);
    __syncthreads();

    // 2. gate pre-activations (each thread owns hidden units j)
    long long s[4] = {0, 0, 0, 0}, q[4] = {0, 0, 0, 0};
    for (int j = tid; j < H; j += kThreads) {
      const int32_t c_old = c[j];
      for (int k = 0; k < p.G; ++k) {
        const int idx = k * H + j;
        int32_t g = fp::sat_add(fp::mbqm(ax[idx], p.eff_x[k][0], p.eff_x[k][1]),
                                fp::mbqm(gates[idx], p.eff_h[k][0], p.eff_h[k][1]));
        if (k == slot_o_late) {  // int32 pre-peephole o accumulator
          gates[idx] = g;
          continue;
        }
        if (p.use_ph && k != p.slot_z) {
          g = fp::sat_add(g, fp::mbqm((int32_t)p.P[k][j] * c_old,
                                      p.eff_c[k][0], p.eff_c[k][1]));
        }
        const int32_t g16 = fp::sat16(g);
        gates[idx] = g16;
        s[k] += g16;
        q[k] += (long long)g16 * g16;
      }
    }
    if (p.use_ln) {
      ln_stats(s, q, H, p.G, &st);
      for (int j = tid; j < H; j += kThreads) {
        for (int k = 0; k < p.G; ++k) {
          if (k == slot_o_late) continue;
          const int idx = k * H + j;
          gates[idx] = fp::layernorm_apply(gates[idx], H, st.sum[k], st.deg[k],
                                           st.m0[k], st.shift[k], p.L[k][j],
                                           p.Lb[k][j], p.ln_out[k][0],
                                           p.ln_out[k][1]);
        }
      }
    }

    // 3. cell update (and the peephole o gate, which reads c_new)
    long long so[4] = {0, 0, 0, 0}, qo[4] = {0, 0, 0, 0};
    for (int j = tid; j < H; j += kThreads) {
      const int16_t c_new = cell::update_c(
          p.cifg ? 0 : gates[p.slot_i * H + j], gates[p.slot_f * H + j],
          gates[p.slot_z * H + j], c[j], p.cifg, p.cell_int_bits);
      c[j] = c_new;
      if (slot_o_late >= 0) {
        const int k = slot_o_late;
        const int32_t o16 = cell::o_peephole(gates[k * H + j], p.P[k][j], c_new,
                                             p.eff_c[k][0], p.eff_c[k][1]);
        gates[k * H + j] = o16;
        so[0] += o16;
        qo[0] += (long long)o16 * o16;
      }
    }
    if (slot_o_late >= 0 && p.use_ln) {
      const int k = slot_o_late;
      ln_stats(so, qo, H, 1, &st);
      for (int j = tid; j < H; j += kThreads) {
        gates[k * H + j] = fp::layernorm_apply(
            gates[k * H + j], H, st.sum[0], st.deg[0], st.m0[0], st.shift[0],
            p.L[k][j], p.Lb[k][j], p.ln_out[k][0], p.ln_out[k][1]);
      }
    }

    // 4. hidden output m = sat8(mbqm(o * tanh(c), eff_m) + zp_m)
    int8_t* m_dst = p.use_proj ? m : h;  // no projection: m IS the new h
    for (int j = tid; j < H; j += kThreads) {
      m_dst[j] = cell::hidden_out(gates[p.slot_o * H + j], c[j], p.cell_int_bits,
                                  p.eff_m[0], p.eff_m[1], p.zp_m);
    }
    __syncthreads();

    // 5. projection h = sat8(mbqm(m @ W_proj + fold_proj, eff_proj) + zp_h)
    if (p.use_proj) {
      matvec(m, H, p.W_proj, p.d_out, p.fold_proj, gates, part);
      __syncthreads();
      for (int j = tid; j < p.d_out; j += kThreads) {
        h[j] = fp::sat8(fp::wrap32(
            (int64_t)fp::mbqm(gates[j], p.eff_proj[0], p.eff_proj[1]) + p.zp_h_out));
      }
      __syncthreads();
    }
    for (int j = tid; j < p.d_out; j += kThreads) ys_t[j] = h[j];
  }
  __syncthreads();
  for (int j = tid; j < p.d_out; j += kThreads) p.h_out[(size_t)b * p.d_out + j] = h[j];
  for (int j = tid; j < H; j += kThreads) p.c_out[(size_t)b * H + j] = c[j];
}

}  // namespace

// Shared-memory bytes the kernel needs for one row.
static int quant_lstm_scan_smem_bytes(int G, int H, int d_out) {
  return G * H * 4 + kPartInts * 4 + ((H + 7) & ~7) * 2 + ((d_out + 15) & ~15) +
         ((H + 15) & ~15);
}

// Plain C entry point (bound with ctypes).
//   ptrs: acc_x, R, fold_hb, P[4], L[4], Lb[4], W_proj, fold_proj, h0, c0,
//         valid_len, ys, h_out, c_out                      (23 pointers)
//   ints: T, H, d_out, G, use_ln, use_proj, use_ph, cifg, slot_i, slot_f,
//         slot_z, slot_o, eff_x[4][2], eff_h[4][2], eff_c[4][2],
//         ln_out[4][2], eff_m[2], eff_proj[2], zp_m, zp_h_out,
//         cell_int_bits                                   (51 ints)
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int quant_lstm_scan_launch(const void* const* ptrs, const int32_t* ints,
                                      int B, void* stream) {
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

  int j = 0;
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

  const int smem = quant_lstm_scan_smem_bytes(p.G, p.H, p.d_out);
  cudaError_t err = cudaFuncSetAttribute(
      quant_lstm_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_lstm_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
