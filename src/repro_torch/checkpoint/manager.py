"""Checkpointing: atomic, keep-K, async save; restore onto a model's
devices and dtypes.

Port of ``repro.checkpoint.manager``, on the same layout, so a checkpoint
written by either package restores in the other:

    <dir>/step_<N>/
        tree.json    -- the sorted leaf keys and the tree's structure
        arrays.npz   -- full arrays keyed by leaf path
        meta.json    -- step and any extra metadata

A leaf's key is ``"/".join`` of the dict keys and sequence indices from
the root (``"1/inner/mu/lstm/0/W/f"`` in a ``(params, opt_state)`` tuple).
bf16 leaves are stored as float32 (numpy has no bfloat16) and cast back
on restore, which is exact.

Fault tolerance contract (``runtime.fault.run_with_restarts``):

* writes go to ``tmp_step_<N>`` and then ``os.replace`` -> crash-safe;
* ``latest_step`` scans durable directories only;
* ``keep_k`` garbage-collects old steps after a successful save.

An async save copies every tensor to host memory before its thread
starts, so the caller may go on updating (or freeing) the device tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .. import tree_util as tu


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> Dict[str, Any]:
    return {_key(path): leaf for path, leaf in tu.leaves_with_paths(tree)}


def _structure(tree) -> Any:
    """The tree with every leaf replaced by its dtype and shape."""
    return tu.tree_map(lambda t: f"{t.dtype}{list(t.shape)}", tree)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """A host copy that later writes to ``t`` cannot reach."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3,
                 async_save: bool = True):
        self.dir = directory
        self.keep_k = keep_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[Exception] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------

    def save(self, step: int, tree: Any, extra_meta: Optional[Dict] = None,
             block: bool = False) -> None:
        structure = _structure(tree)
        flat = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if self.async_save and not block:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_thread,
                args=(step, flat, structure, extra_meta))
            self._thread.start()
        else:
            self._save_sync(step, flat, structure, extra_meta)

    def _save_thread(self, *args) -> None:
        try:
            self._save_sync(*args)
        except Exception as e:  # raised again by wait()
            self._error = e

    def _save_sync(self, step: int, flat, structure, extra_meta) -> None:
        tmp = os.path.join(self.dir, f"tmp_step_{step}")
        final = os.path.join(self.dir, f"step_{step}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        with open(os.path.join(tmp, "tree.json"), "w") as f:
            json.dump({"keys": sorted(flat), "treedef": structure}, f)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"step": step, **(extra_meta or {})}, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        """Join a pending async save; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
        self._thread = None
        error, self._error = self._error, None
        if error is not None:
            raise error

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------

    def steps(self):
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    pass
        return out

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return max(steps) if steps else None

    def restore(self, step: int, like_tree: Any) -> Tuple[Any, Dict]:
        """``(a tree shaped like like_tree, meta)``: every leaf from the
        checkpoint, on the device and in the dtype of ``like_tree``'s leaf.
        A leaf the checkpoint lacks raises ``KeyError``, a leaf of another
        shape ``ValueError``."""
        path = os.path.join(self.dir, f"step_{step}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        out = []
        with np.load(os.path.join(path, "arrays.npz")) as arrays:
            for p, like in tu.leaves_with_paths(like_tree):
                key = _key(p)
                if key not in arrays:
                    raise KeyError(f"checkpoint missing leaf '{key}'")
                arr = arrays[key]
                if tuple(arr.shape) != tuple(like.shape):
                    raise ValueError(f"shape mismatch for {key}: ckpt "
                                     f"{arr.shape} vs {tuple(like.shape)}")
                out.append(torch.from_numpy(arr).to(device=like.device,
                                                    dtype=like.dtype))
        return tu.unflatten(like_tree, out), meta
