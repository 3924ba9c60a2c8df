// Fused integer LSTM cell: gate activations, the cell update, the peephole
// o gate and the hidden output, for one timestep of a (B, H) batch.
//
// Replaces the TPU kernel `quant_lstm_cell_pallas`
// (repro/kernels/quant_lstm_cell.py, body `_cell_kernel`, helper
// `finish_o_gate`).  One kernel, two entries.  The TPU contract: the int16
// gate pre-activations i/f/z (i is ignored under CIFG), the o gate and the
// int16 cell state are given.  The step entry of the stepwise executor:
// the kernel reads the step's two int32 accumulators (B, G*H) and forms
// every gate the gate pass (int_layernorm.cu) did not give it -- all gates
// of a layer without LN, and the peephole o gate's pre-peephole
// accumulator -- through the same prologue (cell::gate_preact); the gates
// the pass normalised it reads from the pass's (B, G*H) int16 output.  The
// o-gate contract: without a peephole o is the int16 gate; with one it is
// the int32 pre-peephole accumulator, finished here on c_new (the peephole
// reads the NEW cell state), then LayerNorm'd over the whole row when the
// layer has LN.  The per-element math is lstm_cell.cuh, which the
// persistent sequence kernel runs too.  Outputs: m int8 and c_new int16.
//
// What bounds it on an H100: bytes, about 0.03-0.05 us at B = 4, H = 2048,
// far below the cost of one launch; past the launch, the serial latency of
// the fixed-point activations.  Two kernels (ln_plan.cuh): an elementwise
// one, a column a thread over a grid on (B, H), the independent i/f/z
// activations of a thread overlapping; and, for peephole
// + LN, each row split over a cluster of CTAs that keep their slice's o
// gate and c_new in shared memory while the o gate's statistics meet
// through distributed shared memory (block_ln.cuh), as in the gate pass.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "lstm_cell.cuh"
#include "ln_plan.cuh"
#include "block_ln.cuh"

namespace {

enum Role { kI = 0, kF = 1, kZ = 2, kO = 3 };

struct CellParams {
  const int16_t* g16[4];  // a given int16 gate: g16[r][b ld16[r] + j], or null
  int ld16[4];
  const int32_t* o32;     // a given int32 pre-peephole o: o32[b H + j], or null
  const int32_t* acc_x;   // a formed gate: acc[b G H + slot[r] H + j]
  const int32_t* acc_h;
  int slot[4];
  cell::GateScale sc[4];
  const int16_t* P[4];  // (H,) i/f peephole weights of a formed gate
  const int16_t* c;     // (B, H) the old cell state
  const int16_t* p_o;   // (H,) o peephole weights, or null
  const int16_t* lw_o;  // (H,) o-gate LN weights, or null
  const int32_t* lb_o;
  int8_t* m_out;
  int16_t* c_out;
  int B, H, G, cifg, cell_int_bits, peephole;
  int32_t eff_c_o[2], ln_out_o[2], eff_m[2], zp_m;
};

// gate `r` at (b, j): given, or formed from the accumulators (int16 after
// sat16, but the peephole o's int32 accumulator); c is the old cell state
__device__ __forceinline__ int32_t gate(const CellParams& p, int r, long long b, int j,
                                        int32_t c) {
  if (p.g16[r]) return p.g16[r][(size_t)b * p.ld16[r] + j];
  if (r == kO && p.o32) return p.o32[(size_t)b * p.H + j];
  const size_t off = ((size_t)b * p.G + p.slot[r]) * p.H + j;
  const cell::GateScale sc = p.sc[r];
  const int32_t g = cell::gate_preact(sc, p.acc_x[off], p.acc_h[off],
                                      sc.has_c ? p.P[r][j] : 0, c);
  return r == kO && p.peephole ? g : fp::sat16(g);
}

// c_new (stored) and the o gate before any LN (finished on c_new with a
// peephole) at (b, j)
__device__ __forceinline__ void cell_at(const CellParams& p, long long b, int j,
                                        int16_t* c_new, int32_t* o16) {
  const int32_t c = p.c[(size_t)b * p.H + j];
  const int32_t f = gate(p, kF, b, j, c), z = gate(p, kZ, b, j, c);
  const int32_t i = p.cifg ? 0 : gate(p, kI, b, j, c), o = gate(p, kO, b, j, c);
  const int32_t f_act = fp::sigmoid_q15(f, 3);
  const int32_t z_act = fp::tanh_q15(z, 3);
  const int32_t i_act = p.cifg ? cell::cifg_input(f_act) : fp::sigmoid_q15(i, 3);
  const int16_t cn = cell::combine_c(i_act, f_act, z_act, c, p.cell_int_bits);
  p.c_out[(size_t)b * p.H + j] = cn;
  *c_new = cn;
  *o16 = p.peephole ? cell::o_peephole(o, p.p_o[j], cn, p.eff_c_o[0], p.eff_c_o[1]) : o;
}

__device__ __forceinline__ void store_m(const CellParams& p, long long b, int j, int32_t o16,
                                        int16_t c_new) {
  p.m_out[(size_t)b * p.H + j] =
      cell::hidden_out(o16, c_new, p.cell_int_bits, p.eff_m[0], p.eff_m[1], p.zp_m);
}

__global__ void quant_lstm_cell_kernel(CellParams p) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= (long long)p.B * p.H) return;
  const long long b = g / p.H;
  const int j = (int)(g % p.H);
  int16_t c_new;
  int32_t o16;
  cell_at(p, b, j, &c_new, &o16);
  store_m(p, b, j, o16, c_new);
}

// Peephole + LN: each row over a cluster of pl.C CTAs; a CTA's slice of
// the o gate and of c_new waits in shared memory for the row's statistics.
__global__ void __launch_bounds__(lnp::kMaxThreads) quant_lstm_cell_ln_kernel(
    CellParams p, lnp::Plan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* o_slice = reinterpret_cast<int16_t*>(smem);
  int16_t* c_slice = o_slice + pl.W;
  __shared__ blk::RowShared rsh;
  if (pl.C > 1) blk::cluster_arrive_relaxed();
  const int rank = (int)(blockIdx.x % pl.C);
  const long long b = blockIdx.x / pl.C;
  const int lo = lnp::slice_lo(pl, rank), hi = lnp::slice_hi(pl, rank, p.H);
  long long s = 0, sq = 0;
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    int16_t c_new;
    int32_t o16;
    cell_at(p, b, j, &c_new, &o16);
    s += o16;
    sq += (long long)o16 * o16;
    o_slice[j - lo] = (int16_t)o16;
    c_slice[j - lo] = c_new;
  }
  const blk::RowNorm rn = blk::row_norm(s, sq, p.H, pl.C, rank, &rsh);
  for (int j = lo + threadIdx.x; j < hi; j += blockDim.x) {  // this thread's own columns
    const int32_t o16 = fp::layernorm_apply(o_slice[j - lo], p.H, rn.sum, rn.deg, rn.m0,
                                            rn.shift, p.lw_o[j], p.lb_o[j], p.ln_out_o[0],
                                            p.ln_out_o[1]);
    store_m(p, b, j, o16, c_slice[j - lo]);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).
//   ptrs: g16[4] (i, f, z, o), o32, acc_x, acc_h, P[4] (by role), c, p_o,
//         lw_o, lb_o, m_out, c_out                               (17 pointers)
//   ints: B, H, G, cifg, cell_int_bits, peephole, ln,
//         ld16[4], slot[4], sc[4] x (x_m0, x_sh, h_m0, h_sh, c_m0, c_sh,
//         has_c), eff_c_o[2], ln_out_o[2], eff_m[2], zp_m        (50 ints)
// A role without a given gate is formed from acc_x / acc_h at its slot.
// `ln` (which needs the peephole) selects the row kernel.  Returns
// cudaGetLastError() (or the first failing call's; cudaErrorInvalidValue
// where the plan refuses).
extern "C" int quant_lstm_cell_launch(const void* const* ptrs, const int32_t* ints,
                                      int n_sm, void* stream) {
  CellParams p = {};
  int i = 0;
  for (int r = 0; r < 4; ++r) p.g16[r] = static_cast<const int16_t*>(ptrs[i++]);
  p.o32 = static_cast<const int32_t*>(ptrs[i++]);
  p.acc_x = static_cast<const int32_t*>(ptrs[i++]);
  p.acc_h = static_cast<const int32_t*>(ptrs[i++]);
  for (int r = 0; r < 4; ++r) p.P[r] = static_cast<const int16_t*>(ptrs[i++]);
  p.c = static_cast<const int16_t*>(ptrs[i++]);
  p.p_o = static_cast<const int16_t*>(ptrs[i++]);
  p.lw_o = static_cast<const int16_t*>(ptrs[i++]);
  p.lb_o = static_cast<const int32_t*>(ptrs[i++]);
  p.m_out = static_cast<int8_t*>(const_cast<void*>(ptrs[i++]));
  p.c_out = static_cast<int16_t*>(const_cast<void*>(ptrs[i++]));
  int j = 0;
  p.B = ints[j++];
  p.H = ints[j++];
  p.G = ints[j++];
  p.cifg = ints[j++];
  p.cell_int_bits = ints[j++];
  p.peephole = ints[j++];
  const int ln = ints[j++];
  for (int r = 0; r < 4; ++r) p.ld16[r] = ints[j++];
  for (int r = 0; r < 4; ++r) p.slot[r] = ints[j++];
  for (int r = 0; r < 4; ++r) {
    cell::GateScale& s = p.sc[r];
    s.x_m0 = ints[j++];
    s.x_sh = ints[j++];
    s.h_m0 = ints[j++];
    s.h_sh = ints[j++];
    s.c_m0 = ints[j++];
    s.c_sh = ints[j++];
    s.has_c = ints[j++];
  }
  p.eff_c_o[0] = ints[j++];
  p.eff_c_o[1] = ints[j++];
  p.ln_out_o[0] = ints[j++];
  p.ln_out_o[1] = ints[j++];
  p.eff_m[0] = ints[j++];
  p.eff_m[1] = ints[j++];
  p.zp_m = ints[j++];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln) {
    const lnp::Plan pl = lnp::plan(p.B, 1, p.H, n_sm, 2);
    if (pl.err != lnp::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(blk::launch_rows(quant_lstm_cell_ln_kernel, pl, s, p, pl));
  }
  const lnp::EwPlan pl = lnp::ew_plan(p.B, p.H);
  if (pl.err != lnp::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
  quant_lstm_cell_kernel<<<(unsigned)pl.ctas, pl.threads, 0, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
