// The integer LSTM cell as device functions, shared by the standalone cell
// kernel (quant_lstm_cell.cu), the gate pass (int_layernorm.cu) and the
// cooperative LSTM sequence kernel (quant_lstm_scan.cu), so they cannot
// drift.  Port of the body of the TPU kernel `_cell_kernel` and of
// `finish_o_gate` (repro/kernels/quant_lstm_cell.py), and of the gate
// prologue of `ref.lstm_gate_preacts`.  Per hidden unit:
//   gate  = mbqm(acc_x, eff_x) sat+ mbqm(acc_h, eff_h)
//           [sat+ mbqm(P (.) c_old, eff_c)]   (i/f peephole; sat16 after)
//   c_new = sat16(rdbpot(i*z, 30 - n_c) sat+ rdbpot(f*c, 15)),
//           i = sigmoid(i16), or min(32768 - f, 32767) under CIFG
//   o16   = sat16(o_in sat+ mbqm(P_o * c_new, eff_c_o))   (peephole only;
//           LayerNorm over the row follows where the layer has it)
//   m     = sat8(mbqm(sigmoid(o16) * tanh(c_new), eff_m) + zp_m)
// The pieces (cifg_input, combine_c, hidden_from_acts) let the sequence
// kernel spread the activations over threads.  Valid host C++ as well,
// like fixedpoint.cuh.
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"

namespace cell {

// One gate's rescale constants: the packed accumulators' eff_x and eff_h
// and, for an i/f peephole on the previous cell state, eff_c (has_c).  The
// peephole o gate has has_c = 0 here: the cell finishes it on c_new.
struct GateScale {
  int32_t x_m0, x_sh, h_m0, h_sh, c_m0, c_sh, has_c;
};

// The gate prologue (ref.lstm_gate_acc): the int32 pre-activation of one
// element from its input and recurrent accumulators, the peephole weight p
// and the previous cell state c (both read only where has_c).
FP_HD int32_t gate_preact(const GateScale& s, int32_t acc_x, int32_t acc_h,
                          int32_t p, int32_t c) {
  int32_t g = fp::sat_add(fp::mbqm(acc_x, s.x_m0, s.x_sh),
                          fp::mbqm(acc_h, s.h_m0, s.h_sh));
  if (s.has_c) g = fp::sat_add(g, fp::mbqm(p * c, s.c_m0, s.c_sh));
  return g;
}

// the input gate of a CIFG cell from its forget gate's activation
FP_HD int32_t cifg_input(int32_t f_act) {
  const int32_t i_act = 32768 - f_act;
  return i_act > 32767 ? 32767 : i_act;
}

// c_new from the gates' Q0.15 activations (i, f: sigmoid; z: tanh)
FP_HD int16_t combine_c(int32_t i_act, int32_t f_act, int32_t z_act,
                        int32_t c_old, int cell_int_bits) {
  const int n_c = 15 - cell_int_bits;
  return fp::sat16(fp::sat_add(fp::rdbpot(i_act * z_act, 30 - n_c),
                               fp::rdbpot(f_act * c_old, 15)));
}

FP_HD int16_t update_c(int32_t i16, int32_t f16, int32_t z16, int32_t c_old,
                       bool cifg, int cell_int_bits) {
  const int32_t f_act = fp::sigmoid_q15(f16, 3);
  const int32_t z_act = fp::tanh_q15(z16, 3);
  const int32_t i_act = cifg ? cifg_input(f_act) : fp::sigmoid_q15(i16, 3);
  return combine_c(i_act, f_act, z_act, c_old, cell_int_bits);
}

FP_HD int16_t o_peephole(int32_t o_in, int16_t p_o, int16_t c_new, int32_t m0,
                         int32_t shift) {
  return fp::sat16(fp::sat_add(o_in, fp::mbqm((int32_t)p_o * c_new, m0, shift)));
}

// m from sigmoid(o16) and tanh(c_new), both Q0.15
FP_HD int8_t hidden_from_acts(int32_t o_act, int32_t g_c, int32_t m0,
                              int32_t shift, int32_t zp_m) {
  return fp::sat8(fp::wrap32((int64_t)fp::mbqm(o_act * g_c, m0, shift) + zp_m));
}

FP_HD int8_t hidden_out(int32_t o16, int16_t c_new, int cell_int_bits,
                        int32_t m0, int32_t shift, int32_t zp_m) {
  return hidden_from_acts(fp::sigmoid_q15(o16, 3),
                          fp::tanh_q15(c_new, cell_int_bits), m0, shift, zp_m);
}

}  // namespace cell
