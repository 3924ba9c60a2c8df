"""Plain PyTorch step math of the integer recurrent stage.

Port of the step math of ``repro.kernels.ref`` (LSTM and reset-after
GRU).  These functions are the CPU path of the sequence executor and the
oracle that the CUDA sequence kernels (``csrc/quant_lstm_scan.cu``,
``csrc/quant_gru_scan.cu``) are held against on the card: same gate order,
same rescale order, same saturations.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core import fixedpoint as fp
from ..core import integer_ops as iops


def finish_o_gate(o_in, c_new, p_o, eff_c_o, lw_o, lb_o, ln_out_o):
    """o-gate finisher (the peephole contract of the fused cell).

    With a peephole, ``o_in`` is the int32 pre-peephole accumulator; the
    gate reads the NEW cell state (eq 5), so it is finished here:
    ``sat16(o_in sat+ mbqm(P_o * c_new, eff_c_o))`` then LayerNorm if the
    layer has it.  Without a peephole ``o_in`` is already the int16 gate.
    """
    if eff_c_o is None:
        assert ln_out_o is None, "in-fusion o-gate LN requires the peephole"
        return o_in
    acc_c = iops.matmul_i16_elementwise(p_o, c_new)
    o16 = fp.saturate_i16(fp.saturating_add_i32(
        o_in, fp.multiply_by_quantized_multiplier(acc_c, *eff_c_o)))
    if ln_out_o is not None:
        o16 = iops.integer_layernorm(o16, lw_o, lb_o, *ln_out_o)
    return o16


def quant_lstm_cell(i16, f16, z16, o_in, c_q, *, cell_int_bits: int,
                    cifg: bool, eff_m, zp_m: int, p_o=None, eff_c_o=None,
                    lw_o=None, lb_o=None, ln_out_o=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused integer LSTM cell: activations, c update, o gate, m.

    Returns ``(m int8, c_new int16)``.
    """
    n_c = 15 - cell_int_bits
    f_act = fp.sigmoid_q15(f16, 3).to(torch.int32)
    z_act = fp.tanh_q15(z16, 3).to(torch.int32)
    if cifg:
        i_act = torch.clamp(32768 - f_act, max=32767)
    else:
        i_act = fp.sigmoid_q15(i16, 3).to(torch.int32)
    c_new = fp.saturate_i16(fp.saturating_add_i32(
        fp.rounding_divide_by_pot(i_act * z_act, 30 - n_c),
        fp.rounding_divide_by_pot(f_act * c_q.to(torch.int32), 15)))
    o16 = finish_o_gate(o_in, c_new, p_o, eff_c_o, lw_o, lb_o, ln_out_o)
    o_act = fp.sigmoid_q15(o16, 3).to(torch.int32)
    g_c = fp.tanh_q15(c_new, cell_int_bits).to(torch.int32)
    m_q = fp.saturate_i8(fp._wrap32(
        fp.multiply_by_quantized_multiplier(o_act * g_c, *eff_m).to(
            torch.int64) + zp_m))
    return m_q, c_new


def lstm_gate_acc(vals, spec, k, g, acc_x, acc_h, c_q):
    """Gate ``g``'s int32 pre-activation from its block ``k`` of the packed
    accumulators: ``mbqm(acc_x, eff_x) sat+ mbqm(acc_h, eff_h) [sat+
    mbqm(P_g (.) c_q, eff_c)]``, the peephole term for i/f only (the cell
    finishes a peephole o gate on the new cell state).  The gate prologue
    that the gate pass and the cell kernel run (``cell::gate_preact``)."""
    H = spec.cfg_d_hidden
    gs = spec.gate_spec(g)
    gate = fp.saturating_add_i32(
        fp.multiply_by_quantized_multiplier(
            acc_x[..., k * H:(k + 1) * H], *gs.eff_x),
        fp.multiply_by_quantized_multiplier(
            acc_h[..., k * H:(k + 1) * H], *gs.eff_h))
    if gs.eff_c is not None and g != "o":
        acc_c = iops.matmul_i16_elementwise(vals["P"][g], c_q)
        gate = fp.saturating_add_i32(
            gate, fp.multiply_by_quantized_multiplier(acc_c, *gs.eff_c))
    return gate


def o_finisher_kw(vals, spec):
    """The cell's o-gate finisher parameters of a peephole layer (``p_o``,
    ``eff_c_o`` and, with LN, the in-fusion LN's), else ``{}``."""
    if not spec.use_peephole:
        return {}
    gs = spec.gate_spec("o")
    o_kw = dict(p_o=vals["P"]["o"], eff_c_o=gs.eff_c)
    if spec.use_layernorm:
        o_kw.update(lw_o=vals["L"]["o"], lb_o=vals["Lb"]["o"],
                    ln_out_o=gs.ln_out)
    return o_kw


def lstm_gate_preacts(vals, spec, acc_x, acc_h, c_q):
    """Per-step gate pre-activations from the packed int32 accumulators.

    Rescales run in the reference order (mbqm(x) sat+ mbqm(h) [sat+
    mbqm(P (.) c)] -> sat16 -> LN, ``lstm_gate_acc``).  Returns
    ``(i16, f16, z16, o_in, o_kw)``; with a peephole ``o_in`` is the int32
    pre-peephole o accumulator and ``o_kw`` the finisher's params.
    """
    g16 = {}
    o_in = None
    for k, g in enumerate(spec.variant.gates):
        gate = lstm_gate_acc(vals, spec, k, g, acc_x, acc_h, c_q)
        if g == "o" and spec.use_peephole:
            o_in = gate
            continue
        gate16 = fp.saturate_i16(gate)
        if spec.use_layernorm:
            gs = spec.gate_spec(g)
            gate16 = iops.integer_layernorm(gate16, vals["L"][g],
                                            vals["Lb"][g], *gs.ln_out)
        g16[g] = gate16
    if o_in is None:
        o_in = g16["o"]
    i16 = g16.get("i", g16["f"])  # placeholder when CIFG (cell ignores it)
    return i16, g16["f"], g16["z"], o_in, o_finisher_kw(vals, spec)


def lstm_project(vals, spec, m_q: torch.Tensor) -> torch.Tensor:
    """Optional projection: int8 hidden ``m`` -> int8 output ``h``."""
    if not spec.use_projection:
        return m_q
    acc = fp._wrap32(iops.matmul_i8_i32(m_q, vals["W_proj"]).to(torch.int64)
                     + vals["fold_proj"].to(torch.int64))
    h_new = fp.multiply_by_quantized_multiplier(acc, *spec.eff_proj)
    return fp.saturate_i8(fp._wrap32(h_new.to(torch.int64) + spec.zp_h_out))


def quant_lstm_recurrent(vals, spec, acc_x_t, h_q, c_q):
    """One LSTM timestep given the hoisted input accumulator slice."""
    acc_h = fp._wrap32(iops.matmul_i8_i32(h_q, vals["R_cat"]).to(torch.int64)
                       + vals["fold_hb_cat"].to(torch.int64))
    i16, f16, z16, o_in, o_kw = lstm_gate_preacts(vals, spec, acc_x_t, acc_h,
                                                  c_q)
    m_q, c_new = quant_lstm_cell(
        i16, f16, z16, o_in, c_q, cell_int_bits=spec.cell_int_bits,
        cifg=spec.use_cifg, eff_m=spec.eff_m, zp_m=spec.zp_m, **o_kw)
    return lstm_project(vals, spec, m_q), c_new


def gru_gate_preacts(vals, spec, acc_x, acc_h):
    """Per-step GRU gate pre-activations from the packed ``[r|u|n]`` int32
    accumulators (reset-after form).

    ``r``/``u`` follow the LSTM gate path: rescale both accumulators,
    saturating-add, sat16, LN if the layer has it, ``sigmoid_q15(., 3)``.
    The candidate ``n`` applies ``r`` (Q0.15) to the *rescaled* recurrent
    term, ``rdbpot(r * gh16, 15)``, before adding the input term.  Returns
    ``(r15, u15, n16)``: r/u as int32 Q0.15 activations, n as the int16
    pre-tanh value.
    """
    H = spec.cfg_d_hidden

    def block(g):
        k = spec.gate_names.index(g)
        return acc_x[..., k * H:(k + 1) * H], acc_h[..., k * H:(k + 1) * H]

    def maybe_ln(g, gate16):
        if spec.use_layernorm:
            return iops.integer_layernorm(gate16, vals["L"][g], vals["Lb"][g],
                                          *spec.gate_spec(g).ln_out)
        return gate16

    acts = {}
    for g in ("r", "u"):
        gs = spec.gate_spec(g)
        ax, ah = block(g)
        gate16 = fp.saturate_i16(fp.saturating_add_i32(
            fp.multiply_by_quantized_multiplier(ax, *gs.eff_x),
            fp.multiply_by_quantized_multiplier(ah, *gs.eff_h)))
        acts[g] = fp.sigmoid_q15(maybe_ln(g, gate16), 3).to(torch.int32)

    gs = spec.gate_spec("n")
    ax, ah = block("n")
    gh16 = fp.saturate_i16(
        fp.multiply_by_quantized_multiplier(ah, *gs.eff_h)).to(torch.int32)
    rg = fp.rounding_divide_by_pot(acts["r"] * gh16, 15)  # |r*gh| < 2**30
    n16 = fp.saturate_i16(fp.saturating_add_i32(
        fp.multiply_by_quantized_multiplier(ax, *gs.eff_x), rg))
    return acts["r"], acts["u"], maybe_ln("n", n16)


def quant_gru_recurrent(vals, spec, acc_x_t, h_q):
    """One GRU timestep given the hoisted input accumulator slice.

    ``h' = sat8(MBQM(u*(h - zp_h), eff_carry) sat+ MBQM((32768 - u)*n,
    eff_n) + zp_h_out)``; both products fit int32 (< 2**23 and < 2**30).
    """
    acc_h = fp._wrap32(iops.matmul_i8_i32(h_q, vals["R_cat"]).to(torch.int64)
                       + vals["fold_hb_cat"].to(torch.int64))
    _, u15, n16 = gru_gate_preacts(vals, spec, acc_x_t, acc_h)
    n_act = fp.tanh_q15(n16, 3).to(torch.int32)
    carry = u15 * (h_q.to(torch.int32) - spec.zp_h)
    blend = (32768 - u15) * n_act
    h_new = fp.saturating_add_i32(
        fp.multiply_by_quantized_multiplier(carry, *spec.eff_carry),
        fp.multiply_by_quantized_multiplier(blend, *spec.eff_n))
    return fp.saturate_i8(fp._wrap32(h_new.to(torch.int64) + spec.zp_h_out))


def recurrent_step(vals, spec, acc_x_t, state: Tuple[torch.Tensor, ...]
                   ) -> Tuple[torch.Tensor, ...]:
    """One timestep of the layer's cell over its flat state tuple (leaf 0
    is the emitted output)."""
    cell = getattr(spec, "cell", "lstm")
    if cell == "lstm":
        return quant_lstm_recurrent(vals, spec, acc_x_t, state[0], state[1])
    if cell == "gru":
        return (quant_gru_recurrent(vals, spec, acc_x_t, state[0]),)
    raise NotImplementedError(f"no recurrent step for cell {cell!r}")

