"""The integer recurrent cell contract (port of ``repro.core.cell``).

A quantized layer is ``(arrays, spec)``: ``arrays`` holds the packed
``W_cat``/``R_cat``/``fold_x_cat``/``fold_hb_cat`` plus the cell's extras,
and ``spec`` is a frozen dataclass naming the cell (``spec.cell``).  The
cell's state is an ordered tuple of ``StateLeaf``; leaf 0 is the per-step
output every executor returns as ``ys[t]``.  Registered cells: ``lstm``
(4 gates ``[i|f|z|o]``, CIFG drops ``i``; state ``(h int8, c int16)``) and
``gru`` (3 gates ``[r|u|n]``; state ``(h int8,)``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StateLeaf:
    """One carry tensor of a quantized recurrent state."""

    key: str  # key in the stacked decode state ({"h": ..., ...})
    dtype: torch.dtype
    width: int  # per-row width (trailing dim)
    reset: int  # integer fill of a freshly reset row (e.g. the h zero point)


class QuantRecurrentCell:
    """Static descriptor of one integer recurrent cell topology."""

    name: str = "?"
    state_key_names: Tuple[str, ...] = ()

    def gate_names(self, spec) -> Tuple[str, ...]:
        raise NotImplementedError

    def d_out(self, spec) -> int:
        raise NotImplementedError

    def state_leaves(self, spec) -> Tuple[StateLeaf, ...]:
        raise NotImplementedError

    def state_keys(self, spec) -> Tuple[str, ...]:
        return tuple(leaf.key for leaf in self.state_leaves(spec))

    def reset_rows(self, spec, state: Tuple[torch.Tensor, ...], row
                   ) -> Tuple[torch.Tensor, ...]:
        """Reset batch row(s) ``row`` of a stacked carry to t=0 (a new
        tuple; the input tensors are left as they were)."""
        out = []
        for arr, leaf in zip(state, self.state_leaves(spec)):
            arr = arr.clone()
            arr[row] = leaf.reset
            out.append(arr)
        return tuple(out)

    def init_state(self, spec, batch: int, device) -> Tuple[torch.Tensor, ...]:
        """t=0 carry: every leaf filled with its declared reset value."""
        return tuple(
            torch.full((batch, leaf.width), leaf.reset, dtype=leaf.dtype,
                       device=device)
            for leaf in self.state_leaves(spec))


class LSTMCell(QuantRecurrentCell):
    """Paper LSTM (eqs 1-7): 4 gates ``[i|f|z|o]`` (CIFG drops ``i``),
    int8 hidden ``h`` (at the output zero point) + int16 POT cell ``c``."""

    name = "lstm"
    state_key_names = ("h", "c")

    def gate_names(self, spec) -> Tuple[str, ...]:
        return spec.variant.gates

    def d_out(self, spec) -> int:
        return spec.cfg_d_proj if spec.use_projection else spec.cfg_d_hidden

    def state_leaves(self, spec) -> Tuple[StateLeaf, ...]:
        return (
            StateLeaf("h", torch.int8, self.d_out(spec), spec.zp_h_out),
            StateLeaf("c", torch.int16, spec.cfg_d_hidden, 0),
        )


class GRUCell(QuantRecurrentCell):
    """Integer GRU (reset-after form, so the packed GEMM holds): 3 gates
    ``[r|u|n]``, a single int8 hidden ``h`` carry reset at ``zp_h``."""

    name = "gru"
    state_key_names = ("h",)

    def gate_names(self, spec) -> Tuple[str, ...]:
        return spec.gate_names

    def d_out(self, spec) -> int:
        return spec.cfg_d_hidden

    def state_leaves(self, spec) -> Tuple[StateLeaf, ...]:
        return (StateLeaf("h", torch.int8, spec.cfg_d_hidden,
                          spec.zp_h_out),)


CELLS: Dict[str, QuantRecurrentCell] = {"lstm": LSTMCell(), "gru": GRUCell()}


def register_cell(cell: QuantRecurrentCell) -> None:
    """Extension hook: make a new cell resolvable by ``spec.cell`` name."""
    CELLS[cell.name] = cell


def get_cell(spec) -> QuantRecurrentCell:
    """Resolve a quantized layer spec's cell descriptor."""
    name = getattr(spec, "cell", "lstm")
    if name not in CELLS:
        raise ValueError(f"unknown recurrent cell {name!r}: registered "
                         f"cells are {sorted(CELLS)}")
    return CELLS[name]
