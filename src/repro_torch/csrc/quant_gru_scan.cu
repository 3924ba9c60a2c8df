// Persistent integer GRU sequence kernel: the whole recurrent stage of one
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
// What bounds it on an H100: every step re-reads R_cat (H x 3H int8, 12.6 MB
// at H = 2048; the GRU has no projection), which no SM's shared memory can
// hold, and the steps are sequential.  The ideal is bytes: the weights once
// per step from L2.  This first design is the LSTM kernel's: one thread
// block per batch row (rows are independent, so no grid-wide barrier), h,
// the 3H int32 gate accumulators and the LayerNorm statistics in shared
// memory for the whole sweep, and each step streams R_cat through the
// shared mat-vec of recurrent_scan.cuh.  It reads the weights B times per
// step and uses only B SMs; splitting gate columns across blocks is later
// work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "recurrent_scan.cuh"

namespace {

using scan::kPartInts;
using scan::kThreads;
using scan::LNStats;
using scan::ln_stats;
using scan::matvec;

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
  int T, H, use_ln;
  int slot_r, slot_u, slot_n;  // column block of each gate
  int eff_x[3][2], eff_h[3][2], ln_out[3][2];
  int eff_carry[2], eff_n[2];
  int zp_h, zp_h_out;
};

__device__ __forceinline__ int32_t gate_ln(const GruParams& p, const LNStats& st,
                                           int k, int st_k, int j, int32_t g16) {
  return fp::layernorm_apply(g16, p.H, st.sum[st_k], st.deg[st_k], st.m0[st_k],
                             st.shift[st_k], p.L[k][j], p.Lb[k][j], p.ln_out[k][0],
                             p.ln_out[k][1]);
}

__global__ void __launch_bounds__(kThreads, 1) quant_gru_scan_kernel(GruParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ LNStats st;
  const int H = p.H;
  const int GH = 3 * H;
  int32_t* gates = reinterpret_cast<int32_t*>(smem);  // [3H]
  int32_t* part = gates + GH;                          // [kPartInts]
  int8_t* h = reinterpret_cast<int8_t*>(part + kPartInts);  // [H]

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  for (int j = tid; j < H; j += kThreads) h[j] = p.h0[(size_t)b * H + j];
  __syncthreads();

  const int vlen = p.valid_len ? p.valid_len[b] : p.T;
  const int kr = p.slot_r, ku = p.slot_u, kn = p.slot_n;

  for (int t = 0; t < p.T; ++t) {
    int8_t* ys_t = p.ys + ((size_t)b * p.T + t) * H;
    if (t >= vlen) {  // frozen row: state unchanged, leaf 0 still emitted
      for (int j = tid; j < H; j += kThreads) ys_t[j] = h[j];
      continue;
    }
    const int32_t* ax = p.acc_x + ((size_t)b * p.T + t) * GH;

    // 1. recurrent product h @ R_cat + fold_hb_cat into `gates`
    matvec(h, H, p.R, GH, p.fold_hb, gates, part);
    __syncthreads();

    // 2. r and u pre-activations (each thread owns hidden units j); their
    //    LayerNorm statistics land in st slot 0 (r) and 1 (u)
    long long s[2] = {0, 0}, q[2] = {0, 0};
    for (int j = tid; j < H; j += kThreads) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = e == 0 ? kr : ku;
        const int idx = k * H + j;
        const int32_t g16 = fp::sat16(fp::sat_add(
            fp::mbqm(ax[idx], p.eff_x[k][0], p.eff_x[k][1]),
            fp::mbqm(gates[idx], p.eff_h[k][0], p.eff_h[k][1])));
        gates[idx] = g16;
        s[e] += g16;
        q[e] += (long long)g16 * g16;
      }
    }
    if (p.use_ln) ln_stats(s, q, H, 2, &st);

    // 3. r/u activations, then the candidate's pre-activation:
    //    n16 = sat16(mbqm(acc_x_n, eff_x_n) sat+ rdbpot(r * gh16, 15)),
    //    whose statistics then land in st slot 0 (after the barrier inside
    //    ln_stats, so no thread still reads r's)
    long long sn[1] = {0}, qn[1] = {0};
    for (int j = tid; j < H; j += kThreads) {
      int32_t r16 = gates[kr * H + j], u16 = gates[ku * H + j];
      if (p.use_ln) {
        r16 = gate_ln(p, st, kr, 0, j, r16);
        u16 = gate_ln(p, st, ku, 1, j, u16);
      }
      const int32_t r_act = fp::sigmoid_q15(r16, 3);
      gates[ku * H + j] = fp::sigmoid_q15(u16, 3);  // u, Q0.15
      const int idx = kn * H + j;
      const int32_t gh16 = fp::sat16(fp::mbqm(gates[idx], p.eff_h[kn][0], p.eff_h[kn][1]));
      const int32_t rg = fp::rdbpot(fp::wrap32((int64_t)r_act * gh16), 15);
      const int32_t n16 = fp::sat16(
          fp::sat_add(fp::mbqm(ax[idx], p.eff_x[kn][0], p.eff_x[kn][1]), rg));
      gates[idx] = n16;
      sn[0] += n16;
      qn[0] += (long long)n16 * n16;
    }
    if (p.use_ln) ln_stats(sn, qn, H, 1, &st);

    // 4. the integer u-blend into the new int8 h (each thread reads and
    //    writes only its own units j; the mat-vec that reads h is behind
    //    the barrier at the end of the step)
    for (int j = tid; j < H; j += kThreads) {
      int32_t n16 = gates[kn * H + j];
      if (p.use_ln) n16 = gate_ln(p, st, kn, 0, j, n16);
      const int32_t n_act = fp::tanh_q15(n16, 3);
      const int32_t u = gates[ku * H + j];
      const int32_t carry = fp::wrap32((int64_t)u * ((int32_t)h[j] - p.zp_h));
      const int32_t blend = fp::wrap32((int64_t)(32768 - u) * n_act);
      const int32_t h_new = fp::sat_add(
          fp::mbqm(carry, p.eff_carry[0], p.eff_carry[1]),
          fp::mbqm(blend, p.eff_n[0], p.eff_n[1]));
      const int8_t h8 = fp::sat8(fp::wrap32((int64_t)h_new + p.zp_h_out));
      h[j] = h8;
      ys_t[j] = h8;
    }
    __syncthreads();
  }
  for (int j = tid; j < H; j += kThreads) p.h_out[(size_t)b * H + j] = h[j];
}

}  // namespace

// Shared-memory bytes the kernel needs for one row.
static int quant_gru_scan_smem_bytes(int H) {
  return 3 * H * 4 + kPartInts * 4 + ((H + 15) & ~15);
}

// Plain C entry point (bound with ctypes).
//   ptrs: acc_x, R, fold_hb, L[3], Lb[3], h0, valid_len, ys, h_out
//                                                          (13 pointers)
//   ints: T, H, use_ln, slot_r, slot_u, slot_n, eff_x[3][2], eff_h[3][2],
//         ln_out[3][2], eff_carry[2], eff_n[2], zp_h, zp_h_out (30 ints)
// Returns cudaGetLastError() (or the attribute call's error).
extern "C" int quant_gru_scan_launch(const void* const* ptrs, const int32_t* ints,
                                     int B, void* stream) {
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

  int j = 0;
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

  const int smem = quant_gru_scan_smem_bytes(p.H);
  cudaError_t err = cudaFuncSetAttribute(
      quant_gru_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  quant_gru_scan_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
