"""The paper's quantization recipe (Table 2): float cell -> integer cell.

Port of ``repro.core.recipe``.  Given calibrated ``Stats`` and float
parameters it produces (a) a dict of integer tensors and (b) a frozen
``QLSTMSpec`` / ``QGRUSpec`` holding every derived scale and fixed-point
multiplier.  All real-valued scale arithmetic runs here, offline, in
float64 numpy exactly as in the reference, so both packages emit the same
integers from the same inputs.

Recipe summary (Table 2):
  x, h, m      int8  asymmetric  range/255 (nudged zero point)
  W, R, W_proj int8  symmetric   max/127
  P, L         int16 symmetric   max/32767
  b (no LN)    int32 at s_R*s_h     |  b (LN) int32 at 2**-10 * s_L
  b_proj       int32 at s_Wproj*s_m
  c            int16 symmetric POT(max)/32768  => Q_{m.15-m}
  gates (noLN) int16 Q3.12 (2**-12)  |  gates (LN) int16 max|g|/32767
The GRU reuses the x/h/W/R/b/gate rows.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import fixedpoint as fp
from . import qtypes as qt
from .calibrate import Stats
from ..models.gru import GRUConfig, GRUVariant
from ..models.lstm import LSTMConfig, LSTMVariant

MulPair = Tuple[int, int]  # (m0, shift) from fp.quantize_multiplier


@dataclasses.dataclass(frozen=True)
class GateSpec:
    eff_x: MulPair  # s_W*s_x / s_gate
    eff_h: MulPair  # s_R*s_h / s_gate
    eff_c: Optional[MulPair]  # s_P*s_c / s_gate (peephole)
    ln_out: Optional[MulPair]  # 2**-10 * s_L / 2**-12 (LN only)


@dataclasses.dataclass(frozen=True)
class QLSTMSpec:
    """Static (hashable) integer-execution plan for one LSTM layer."""

    cfg_d_input: int
    cfg_d_hidden: int
    cfg_d_proj: int
    use_layernorm: bool
    use_projection: bool
    use_peephole: bool
    use_cifg: bool
    zp_x: int
    zp_h: int
    zp_m: int
    zp_h_out: int
    cell_int_bits: int  # m of Q_{m.15-m}
    gates: Tuple[Tuple[str, GateSpec], ...]
    eff_m: MulPair  # 2**-30 / s_m  (gate-to-hidden, sec 3.2.7)
    eff_proj: Optional[MulPair]  # s_Wproj*s_m / s_h
    s_x: float
    s_h: float
    s_m: float
    s_c: float

    @property
    def cell(self) -> str:
        return "lstm"

    @property
    def variant(self) -> LSTMVariant:
        return LSTMVariant(self.use_layernorm, self.use_projection,
                           self.use_peephole, self.use_cifg)

    @property
    def gate_names(self) -> Tuple[str, ...]:
        return self.variant.gates

    @property
    def d_out(self) -> int:
        return self.cfg_d_proj if self.use_projection else self.cfg_d_hidden

    def gate_spec(self, g: str) -> GateSpec:
        return dict(self.gates)[g]

    def gate_block(self, g: str) -> slice:
        """Column block of gate ``g`` inside the packed [i|f|z|o] arrays."""
        k = self.gate_names.index(g)
        return slice(k * self.cfg_d_hidden, (k + 1) * self.cfg_d_hidden)


@dataclasses.dataclass(frozen=True)
class QGRUSpec:
    """Static (hashable) integer-execution plan for one GRU layer.

    The GRU feeds its int8 hidden straight back, so the recipe uses ONE
    hidden format (the union of the ``h`` and ``h_out`` taps) and the carry
    update ``u (.) h`` needs only ``eff_carry`` = 2**-15.
    """

    cfg_d_input: int
    cfg_d_hidden: int
    use_layernorm: bool
    zp_x: int
    zp_h: int
    zp_h_out: int  # == zp_h (single hidden format)
    gates: Tuple[Tuple[str, GateSpec], ...]  # ("r"|"u"|"n", GateSpec)
    eff_carry: MulPair  # 2**-15       : u (.) (h - zp_h)  -> h units
    eff_n: MulPair  # 2**-30 / s_h : (1 - u) (.) n_act -> h units
    s_x: float
    s_h: float

    @property
    def cell(self) -> str:
        return "gru"

    @property
    def variant(self) -> GRUVariant:
        return GRUVariant(self.use_layernorm)

    @property
    def gate_names(self) -> Tuple[str, ...]:
        return tuple(g for g, _ in self.gates)

    @property
    def d_out(self) -> int:
        return self.cfg_d_hidden

    def gate_spec(self, g: str) -> GateSpec:
        return dict(self.gates)[g]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _i32(x) -> np.ndarray:
    return np.clip(x, -(2**31 - 1), 2**31 - 1).astype(np.int32)


def _pack_gate_blocks(arrays: Dict[str, Any],
                      per_gate: Dict[str, Dict[str, np.ndarray]],
                      gate_order: Tuple[str, ...], device) -> None:
    """Column-concatenate the per-gate blocks into the fused layout, so one
    ``(B, d_in) x (d_in, G*H)`` int8 GEMM yields every gate accumulator;
    column block g is the per-gate product."""
    for name, key in (("W_cat", "W"), ("R_cat", "R")):
        arrays[name] = torch.from_numpy(np.ascontiguousarray(np.concatenate(
            [per_gate[key][g] for g in gate_order], axis=1))).to(device)
    for name, key in (("fold_x_cat", "fold_x"), ("fold_hb_cat", "fold_hb")):
        arrays[name] = torch.from_numpy(np.concatenate(
            [per_gate[key][g] for g in gate_order])).to(device)


def _quantize_gate(params: Dict[str, Any], g: str, stats: Stats, prefix: str,
                   use_ln: bool, s_x: float, zp_x: int, s_h: float, zp_h: int,
                   per_gate: Dict[str, Dict[str, np.ndarray]],
                   arrays: Dict[str, Any], device):
    """The Table-2 rows every cell shares, for one gate: int8 W and R
    (symmetric), the folded zero points and bias, the LN vectors.  Fills
    ``per_gate`` and ``arrays``; returns ``(s_gate, GateSpec)`` with no
    peephole (``eff_c``) -- the cell adds its own extras."""
    W = _np(params["W"][g])
    R = _np(params["R"][g])
    b = _np(params["b"][g])
    s_W = qt.symmetric_scale(np.abs(W).max(), 8)
    s_R = qt.symmetric_scale(np.abs(R).max(), 8)
    Wq = np.clip(np.round(W / s_W), -127, 127).astype(np.int8)
    Rq = np.clip(np.round(R / s_R), -127, 127).astype(np.int8)
    per_gate["W"][g] = Wq
    per_gate["R"][g] = Rq
    # gate output scale: Q3.12 without LN, measured/32767 with LN
    if use_ln:
        s_gate = qt.symmetric_scale(stats.max_abs(prefix + f"g_{g}"), 16)
    else:
        s_gate = 2.0**-12
    # zero-point folding (sec 6): W(x - zp) == Wx - colsum(W)*zp
    per_gate["fold_x"][g] = _i32(-Wq.astype(np.int64).sum(axis=0) * zp_x)
    fold_h = -Rq.astype(np.int64).sum(axis=0) * zp_h
    if not use_ln:
        # bias carried at s_R*s_h into the recurrent accumulator (3.2.4); for
        # the GRU's "n" it sits INSIDE the reset product (reset-after form)
        fold_h = fold_h + np.round(b / (s_R * s_h))
    per_gate["fold_hb"][g] = _i32(fold_h)

    ln_out = None
    if use_ln:
        L = _np(params["L"][g])
        s_L = qt.symmetric_scale(np.abs(L).max(), 16)
        Lq = np.clip(np.round(L / s_L), -32767, 32767).astype(np.int16)
        arrays.setdefault("L", {})[g] = torch.from_numpy(Lq).to(device)
        # LN bias at 2**-10 * s_L (Table 2)
        arrays.setdefault("Lb", {})[g] = torch.from_numpy(
            _i32(np.round(b / (2.0**-10 * s_L)))).to(device)
        ln_out = fp.quantize_multiplier(2.0**-10 * s_L / 2.0**-12)
    return s_gate, GateSpec(eff_x=fp.quantize_multiplier(s_W * s_x / s_gate),
                            eff_h=fp.quantize_multiplier(s_R * s_h / s_gate),
                            eff_c=None, ln_out=ln_out)


def quantize_lstm_layer(params: Dict[str, Any], cfg: LSTMConfig,
                        stats: Stats, prefix: str = "", device=None
                        ) -> Tuple[Dict[str, Any], QLSTMSpec]:
    """Apply Table 2 to one layer.  Returns (integer arrays, static spec).

    The arrays land on ``device`` (default: where ``params`` live).
    """
    v = cfg.variant
    if device is None:
        device = params["W"][v.gates[0]].device

    def rng(name):
        return stats.range(prefix + name)

    def max_abs(name):
        return stats.max_abs(prefix + name)

    def to_dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(device)

    # --- activations (asymmetric int8) and cell (POT int16) ----------------
    s_x, zp_x = qt.asymmetric_scale_zp(*rng("x"), 8)
    # ONE hidden format for the recurrence (the union of the input tap and
    # the output tap), so the fed-back int8 code is exact by construction.
    lo_in, hi_in = rng("h")
    lo_out, hi_out = rng("h_out" if v.use_projection else "m")
    s_h, zp_h = qt.asymmetric_scale_zp(min(lo_in, lo_out),
                                       max(hi_in, hi_out), 8)
    if v.use_projection:
        s_m, zp_m = qt.asymmetric_scale_zp(*rng("m"), 8)
    else:
        s_m, zp_m = s_h, zp_h  # no projection: m IS the emitted h
    s_c = qt.pot_scale_for(max_abs("c"), 16)
    m_c = max(15 - int(round(-np.log2(s_c))), 0)  # integer bits of Q_{m.15-m}

    arrays: Dict[str, Any] = {}
    per_gate: Dict[str, Dict[str, np.ndarray]] = {
        "W": {}, "R": {}, "fold_x": {}, "fold_hb": {}}
    gate_specs = []
    for g in v.gates:
        s_gate, gs = _quantize_gate(params, g, stats, prefix, v.use_layernorm,
                                    s_x, zp_x, s_h, zp_h, per_gate, arrays,
                                    device)
        if v.use_peephole and g != "z":
            P = _np(params["P"][g])
            s_P = qt.symmetric_scale(np.abs(P).max(), 16)
            Pq = np.clip(np.round(P / s_P), -32767, 32767).astype(np.int16)
            arrays.setdefault("P", {})[g] = to_dev(Pq)
            gs = dataclasses.replace(
                gs, eff_c=fp.quantize_multiplier(s_P * s_c / s_gate))
        gate_specs.append((g, gs))

    _pack_gate_blocks(arrays, per_gate, v.gates, device)

    eff_proj = None
    if v.use_projection:
        Wp = _np(params["W_proj"])
        bp = _np(params["b_proj"])
        s_wp = qt.symmetric_scale(np.abs(Wp).max(), 8)
        Wpq = np.clip(np.round(Wp / s_wp), -127, 127).astype(np.int8)
        arrays["W_proj"] = to_dev(Wpq)
        fold_p = (-Wpq.astype(np.int64).sum(axis=0) * zp_m
                  + np.round(bp / (s_wp * s_m)))
        arrays["fold_proj"] = to_dev(_i32(fold_p))
        eff_proj = fp.quantize_multiplier(s_wp * s_m / s_h)

    spec = QLSTMSpec(
        cfg_d_input=cfg.d_input, cfg_d_hidden=cfg.d_hidden,
        cfg_d_proj=cfg.d_proj, use_layernorm=v.use_layernorm,
        use_projection=v.use_projection, use_peephole=v.use_peephole,
        use_cifg=v.use_cifg, zp_x=zp_x, zp_h=zp_h, zp_m=zp_m, zp_h_out=zp_h,
        cell_int_bits=m_c, gates=tuple(gate_specs),
        eff_m=fp.quantize_multiplier(2.0**-30 / s_m), eff_proj=eff_proj,
        s_x=s_x, s_h=s_h, s_m=s_m, s_c=s_c)
    return arrays, spec


def quantize_gru_layer(params: Dict[str, Any], cfg: GRUConfig, stats: Stats,
                       prefix: str = "", device=None
                       ) -> Tuple[Dict[str, Any], QGRUSpec]:
    """Apply Table 2 to one GRU layer.  Returns (integer arrays, spec).

    The LSTM's recipe rows, specialized to the reset-after GRU:

      r, u  : sigmoid_q15(rescale(acc_x) + rescale(acc_h))      [LN'd first]
      n     : tanh_q15(rescale(acc_x_n) + rdp(r * rescale(acc_h_n), 15))
      h'    : sat8(mbqm(u*(h - zp_h), 2**-15)
                   + mbqm((2**15 - u)*n, 2**-30/s_h) + zp_h)

    The arrays land on ``device`` (default: where ``params`` live).
    """
    v = cfg.variant
    if device is None:
        device = params["W"][v.gates[0]].device

    def rng(name):
        return stats.range(prefix + name)

    # one hidden format for the input AND output taps
    s_x, zp_x = qt.asymmetric_scale_zp(*rng("x"), 8)
    lo_in, hi_in = rng("h")
    lo_out, hi_out = rng("h_out")
    s_h, zp_h = qt.asymmetric_scale_zp(min(lo_in, lo_out),
                                       max(hi_in, hi_out), 8)

    arrays: Dict[str, Any] = {}
    per_gate: Dict[str, Dict[str, np.ndarray]] = {
        "W": {}, "R": {}, "fold_x": {}, "fold_hb": {}}
    gate_specs = [(g, _quantize_gate(params, g, stats, prefix,
                                     v.use_layernorm, s_x, zp_x, s_h, zp_h,
                                     per_gate, arrays, device)[1])
                  for g in v.gates]

    _pack_gate_blocks(arrays, per_gate, v.gates, device)

    spec = QGRUSpec(
        cfg_d_input=cfg.d_input, cfg_d_hidden=cfg.d_hidden,
        use_layernorm=v.use_layernorm, zp_x=zp_x, zp_h=zp_h, zp_h_out=zp_h,
        gates=tuple(gate_specs),
        eff_carry=fp.quantize_multiplier(2.0**-15),
        eff_n=fp.quantize_multiplier(2.0**-30 / s_h), s_x=s_x, s_h=s_h)
    return arrays, spec


def recipe_table(spec) -> Dict[str, str]:
    """Human-readable Table-2 row dump for one quantized layer (benchmarks);
    the reference's strings."""
    rows = {"x": f"int8 asym s={spec.s_x:.3e} zp={spec.zp_x}",
            "h": f"int8 asym s={spec.s_h:.3e} zp={spec.zp_h}"}
    if spec.cell == "lstm":
        rows["m"] = f"int8 asym s={spec.s_m:.3e} zp={spec.zp_m}"
        rows["c"] = (f"int16 POT s={spec.s_c:.3e} (Q{spec.cell_int_bits}."
                     f"{15 - spec.cell_int_bits})")
    for g, gs in spec.gates:
        rows[f"gate_{g}"] = (f"eff_x={gs.eff_x} eff_h={gs.eff_h} "
                             f"eff_c={gs.eff_c} ln_out={gs.ln_out}")
    if getattr(spec, "eff_proj", None):
        rows["proj"] = f"eff={spec.eff_proj}"
    return rows
