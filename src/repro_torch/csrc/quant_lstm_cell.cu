// Fused integer LSTM cell: gate activations, the cell update, the peephole
// o gate and the hidden output, for one timestep of a (B, H) batch.
//
// Replaces the TPU kernel `quant_lstm_cell_pallas`
// (repro/kernels/quant_lstm_cell.py, body `_cell_kernel`, helper
// `finish_o_gate`).  Inputs are the int16 gate pre-activations i/f/z (i is
// ignored under CIFG), the o gate and the int16 cell state.  The o-gate
// contract: without a peephole `o_in` is the int16 gate; with one it is the
// int32 pre-peephole accumulator, finished here on c_new (the peephole reads
// the NEW cell state), then LayerNorm'd over the whole row when the layer
// has LN.  The per-element math is lstm_cell.cuh, which the persistent
// sequence kernel runs too.  Outputs: m int8 and c_new int16.
//
// What bounds it on an H100: bytes, five int16 inputs in and three bytes
// per element out (about 0.03 us at B = 4, H = 2048), far below the cost of
// one launch.  Two kernels: an elementwise one (a grid-stride loop, one
// element per thread per pass) for every case but the in-fusion LN, and,
// for peephole + LN, one thread block per row that keeps the row's o gate in
// shared memory while the block reduces its LN statistics
// (`blk::ln_stats`), as the TPU kernel pins its block to the full H axis.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "lstm_cell.cuh"
#include "block_ln.cuh"

namespace {

using blk::kThreads;

struct CellParams {
  const int16_t* i;  // (B, H), null under CIFG
  const int16_t* f;
  const int16_t* z;
  const void* o_in;  // (B, H) int16, or int32 with a peephole
  const int16_t* c;
  const int16_t* p_o;   // (H,) peephole weights or null
  const int16_t* lw_o;  // (H,) o-gate LN weights or null
  const int32_t* lb_o;
  int8_t* m_out;
  int16_t* c_out;
  int B, H, cifg, cell_int_bits, peephole;
  int eff_c_o[2], ln_out_o[2], eff_m[2], zp_m;
};

// c_new for element idx (column j), stored; returns it.
__device__ __forceinline__ int16_t cell_c(const CellParams& p, size_t idx) {
  const int16_t c_new = cell::update_c(p.cifg ? 0 : p.i[idx], p.f[idx], p.z[idx],
                                       p.c[idx], p.cifg, p.cell_int_bits);
  p.c_out[idx] = c_new;
  return c_new;
}

__device__ __forceinline__ int32_t cell_o(const CellParams& p, size_t idx, int j,
                                          int16_t c_new) {
  if (!p.peephole) return static_cast<const int16_t*>(p.o_in)[idx];
  return cell::o_peephole(static_cast<const int32_t*>(p.o_in)[idx], p.p_o[j],
                          c_new, p.eff_c_o[0], p.eff_c_o[1]);
}

__global__ void quant_lstm_cell_kernel(CellParams p) {
  const size_t total = (size_t)p.B * p.H;
  for (size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += (size_t)gridDim.x * blockDim.x) {
    const int j = (int)(idx % p.H);
    const int16_t c_new = cell_c(p, idx);
    p.m_out[idx] = cell::hidden_out(cell_o(p, idx, j, c_new), c_new,
                                    p.cell_int_bits, p.eff_m[0], p.eff_m[1],
                                    p.zp_m);
  }
}

// Peephole + LN: one block per row; the row's o16 waits in shared memory
// for the LN statistics.
__global__ void __launch_bounds__(kThreads) quant_lstm_cell_ln_kernel(CellParams p) {
  extern __shared__ int16_t o_row[];  // [H]
  __shared__ blk::LNStats st;
  const size_t base = (size_t)blockIdx.x * p.H;
  long long s[1] = {0}, sq[1] = {0};
  for (int j = threadIdx.x; j < p.H; j += kThreads) {
    const int16_t c_new = cell_c(p, base + j);
    const int32_t o16 = cell_o(p, base + j, j, c_new);
    o_row[j] = (int16_t)o16;
    s[0] += o16;
    sq[0] += (long long)o16 * o16;
  }
  blk::ln_stats(s, sq, p.H, 1, &st);
  for (int j = threadIdx.x; j < p.H; j += kThreads) {
    const int16_t o16 = fp::layernorm_apply(
        o_row[j], p.H, st.sum[0], st.deg[0], st.m0[0], st.shift[0], p.lw_o[j],
        p.lb_o[j], p.ln_out_o[0], p.ln_out_o[1]);
    // c_out[base + j] was written by this thread in the first pass
    p.m_out[base + j] = cell::hidden_out(o16, p.c_out[base + j], p.cell_int_bits,
                                         p.eff_m[0], p.eff_m[1], p.zp_m);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).
//   ptrs: i, f, z, o_in, c, p_o, lw_o, lb_o, m_out, c_out   (10 pointers)
//   ints: B, H, cifg, cell_int_bits, peephole, ln, eff_c_o[2], ln_out_o[2],
//         eff_m[2], zp_m                                    (13 ints)
// `ln` (which needs the peephole) selects the per-row kernel.  Returns
// cudaGetLastError().
extern "C" int quant_lstm_cell_launch(const void* const* ptrs, const int32_t* ints,
                                      void* stream) {
  CellParams p;
  p.i = static_cast<const int16_t*>(ptrs[0]);
  p.f = static_cast<const int16_t*>(ptrs[1]);
  p.z = static_cast<const int16_t*>(ptrs[2]);
  p.o_in = ptrs[3];
  p.c = static_cast<const int16_t*>(ptrs[4]);
  p.p_o = static_cast<const int16_t*>(ptrs[5]);
  p.lw_o = static_cast<const int16_t*>(ptrs[6]);
  p.lb_o = static_cast<const int32_t*>(ptrs[7]);
  p.m_out = static_cast<int8_t*>(const_cast<void*>(ptrs[8]));
  p.c_out = static_cast<int16_t*>(const_cast<void*>(ptrs[9]));
  p.B = ints[0];
  p.H = ints[1];
  p.cifg = ints[2];
  p.cell_int_bits = ints[3];
  p.peephole = ints[4];
  const int ln = ints[5];
  p.eff_c_o[0] = ints[6];
  p.eff_c_o[1] = ints[7];
  p.ln_out_o[0] = ints[8];
  p.ln_out_o[1] = ints[9];
  p.eff_m[0] = ints[10];
  p.eff_m[1] = ints[11];
  p.zp_m = ints[12];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ln) {
    quant_lstm_cell_ln_kernel<<<p.B, kThreads, p.H * sizeof(int16_t), s>>>(p);
  } else {
    constexpr int kCellThreads = 256;
    const size_t total = (size_t)p.B * p.H;
    size_t blocks = (total + kCellThreads - 1) / kCellThreads;
    if (blocks > 4096) blocks = 4096;
    quant_lstm_cell_kernel<<<(unsigned)blocks, kCellThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
