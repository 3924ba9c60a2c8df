// The integer LSTM cell as device functions, shared by the standalone cell
// kernel (quant_lstm_cell.cu) and the persistent LSTM sequence kernel
// (quant_lstm_scan.cu), so the two cannot drift.  Port of the body of the
// TPU kernel `_cell_kernel` and of `finish_o_gate`
// (repro/kernels/quant_lstm_cell.py).  Per hidden unit:
//   c_new = sat16(rdbpot(i*z, 30 - n_c) sat+ rdbpot(f*c, 15)),
//           i = sigmoid(i16), or min(32768 - f, 32767) under CIFG
//   o16   = sat16(o_in sat+ mbqm(P_o * c_new, eff_c_o))   (peephole only;
//           LayerNorm over the row follows where the layer has it)
//   m     = sat8(mbqm(sigmoid(o16) * tanh(c_new), eff_m) + zp_m)
// Valid host C++ as well, like fixedpoint.cuh.
#pragma once
#include <stdint.h>

#include "fixedpoint.cuh"

namespace cell {

FP_HD int16_t update_c(int32_t i16, int32_t f16, int32_t z16, int32_t c_old,
                       bool cifg, int cell_int_bits) {
  const int n_c = 15 - cell_int_bits;
  const int32_t f_act = fp::sigmoid_q15(f16, 3);
  const int32_t z_act = fp::tanh_q15(z16, 3);
  int32_t i_act;
  if (cifg) {
    i_act = 32768 - f_act;
    if (i_act > 32767) i_act = 32767;
  } else {
    i_act = fp::sigmoid_q15(i16, 3);
  }
  return fp::sat16(fp::sat_add(fp::rdbpot(i_act * z_act, 30 - n_c),
                               fp::rdbpot(f_act * c_old, 15)));
}

FP_HD int16_t o_peephole(int32_t o_in, int16_t p_o, int16_t c_new, int32_t m0,
                         int32_t shift) {
  return fp::sat16(fp::sat_add(o_in, fp::mbqm((int32_t)p_o * c_new, m0, shift)));
}

FP_HD int8_t hidden_out(int32_t o16, int16_t c_new, int cell_int_bits,
                        int32_t m0, int32_t shift, int32_t zp_m) {
  const int32_t o_act = fp::sigmoid_q15(o16, 3);
  const int32_t g_c = fp::tanh_q15(c_new, cell_int_bits);
  return fp::sat8(fp::wrap32((int64_t)fp::mbqm(o_act * g_c, m0, shift) + zp_m));
}

}  // namespace cell
