"""Carry weights across from the reference package's numpy exports.

Both functions take plain numpy (what ``jax.device_get`` returns) and
Python containers, so this module needs neither JAX nor the reference
package:

* ``params_from_numpy``: a reference param tree -> the port's params
  (bf16 stays bf16, float32 stays float32, int8 stays int8; nested dicts
  keep their keys, so the transformer's stacked ``(L, ...)`` layer leaves,
  an MoE model's ``dense_layers`` tree, its ``(L, E, in, out)`` expert
  stacks and their int8 ``{"q", "s"}`` leaves carry over as they are);
* ``opt_state_from_numpy``: the reference train step's optimizer state
  -> the port's (``runtime.train_loop.make_train_step`` keeps the same
  layout);
* ``qlayers_from_numpy``: the reference's quantized ``[(arrays, spec)]``
  list, each spec given as ``dataclasses.asdict(spec)`` -> the port's
  ``(arrays, QLSTMSpec | QGRUSpec)`` list.

With these, both packages compute on the same weights.  ``model_to``
places the port's integer LM on a device (the fleet's shards).
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from . import tree_util as tu
from .core.recipe import GateSpec, QGRUSpec, QLSTMSpec


def tensor_from_numpy(a, device="cpu") -> torch.Tensor:
    """numpy (or ml_dtypes bfloat16) array -> tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def _tree(x, device):
    return tu.tree_map(lambda a: tensor_from_numpy(a, device), x)


def params_from_numpy(params: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """A reference param tree (numpy leaves) -> the port's params."""
    return _tree(params, device)


def opt_state_from_numpy(state: Dict[str, Any], device="cpu"
                         ) -> Dict[str, Any]:
    """The reference's ``{"inner": {"mu", "nu", "step"} (AdamW) or {"v",
    "step"} (Adafactor, each ``v`` leaf ``{"vr", "vc"}`` or ``{"v"}``),
    ["ef_residual"]}`` (numpy leaves) -> the port's state of the same
    layout: float32 moments, the int32 step as a 0-d tensor."""
    if set(state) - {"inner", "ef_residual"} or "step" not in state["inner"]:
        raise ValueError(f"not a train-step optimizer state: {sorted(state)}")
    return _tree(state, device)


def _pair(v):
    return None if v is None else (int(v[0]), int(v[1]))


def spec_from_dict(d: Dict[str, Any]):
    """``dataclasses.asdict`` of a reference QLSTMSpec / QGRUSpec -> the
    port's spec of the same cell."""
    if "use_cifg" in d:
        cls, pairs = QLSTMSpec, ("eff_m", "eff_proj")
    elif "eff_carry" in d:
        cls, pairs = QGRUSpec, ("eff_carry", "eff_n")
    else:
        raise NotImplementedError(
            f"the port has LSTM and GRU layer specs, not {sorted(d)}")
    gates = tuple(
        (g, GateSpec(eff_x=_pair(gs["eff_x"]), eff_h=_pair(gs["eff_h"]),
                     eff_c=_pair(gs["eff_c"]), ln_out=_pair(gs["ln_out"])))
        for g, gs in d["gates"])
    fields = {k: v for k, v in d.items() if k != "gates"}
    for k in pairs:
        fields[k] = _pair(fields[k])
    return cls(gates=gates, **fields)


def qlayers_from_numpy(qlayers, device="cpu"
                       ) -> List[Tuple[Dict[str, Any], Any]]:
    """``[(numpy arrays tree, asdict(spec))]`` -> the port's quantized layers."""
    return [(_tree(arrays, device), spec_from_dict(spec))
            for arrays, spec in qlayers]


def model_to(params, qlayers, device):
    """``(params, qlayers)`` of the integer LM on ``device``.

    A tensor already there is returned as it is (``Tensor.to`` copies
    nothing then), so engines placed on the model's own device share one
    set of weights, as the reference's co-located fleet engines share
    arrays."""
    device = torch.device(device)

    def put(t):
        return t.to(device) if isinstance(t, torch.Tensor) else t

    return (tu.tree_map(put, params),
            [(tu.tree_map(put, arrays), spec) for arrays, spec in qlayers])
