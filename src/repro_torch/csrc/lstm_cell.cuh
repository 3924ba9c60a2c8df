// The integer LSTM cell as device functions, shared by the standalone cell
// kernel (quant_lstm_cell.cu) and the cooperative LSTM sequence kernel
// (quant_lstm_scan.cu), so the two cannot drift.  Port of the body of the
// TPU kernel `_cell_kernel` and of `finish_o_gate`
// (repro/kernels/quant_lstm_cell.py).  Per hidden unit:
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
