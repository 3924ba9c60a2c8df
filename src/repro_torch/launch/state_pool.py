"""Paged host-side pool of quantized per-stream recurrent decode states.

The port's own copy of ``repro.launch.state_pool`` (host-only: no tensors).

The paper's deployment pitch makes preemption nearly free: an integer
recurrent layer's whole state is a handful of small integer vectors per
layer per stream (e.g. an LSTM's int8 hidden at its zero point + int16
cell, or a GRU's single int8 hidden) plus one int32 token counter -- a few
KB, not a transformer KV cache that grows with context.
Swapping a live stream out of its decode-batch slot is therefore one
row-slice + host copy, and swapping it back in is one row write; both are
**bit-exact** because the state is integer (no float re-rounding on the
round trip) and every decode-batch row is computed independently of its
neighbours.

:class:`StatePool` stores those per-stream states in fixed-size **pages**
(one page = ``page_size`` rows of every state leaf plus the ``len``
counters), allocated lazily and recycled through a free list, so a
long-lived serving process that oversubscribes its slots (more live streams
than decode-batch rows) neither fragments host memory nor grows it per
admission.  The pool is the mechanism behind the engine's scheduling
policies (``launch/scheduler.py``): a scheduler *preempts* a stream by
parking its state here and *resumes* it later into whatever slot is free,
and the stream's tokens stay bit-identical to decoding it alone no matter
how often it bounces.

The pool is cell-agnostic: it pages any ``{<leaf>: [rows...] | row, ...,
"len": counter}`` state dict whose arrays have a leading batch axis of 1
(the shape ``models.lstm_lm.slice_state`` produces) -- leaf names, leaf
count, dtypes, and whether a leaf is a per-layer list or a single array are
all taken from the first state parked.  LSTM (``h``/``c``), GRU (``h``
only), and any future ``QuantRecurrentCell`` page through it unchanged.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["StatePool"]


def _as_row(x) -> np.ndarray:
    """Host copy of one state leaf, normalized to a leading batch-1 axis."""
    a = np.asarray(x)
    if a.ndim == 0:
        a = a[None]
    if a.shape[0] != 1:
        raise ValueError(
            f"pool rows must be batch-1 state slices, got leading dim "
            f"{a.shape[0]} (shape {a.shape})")
    return a


class _Page:
    """One page: ``page_size`` rows of every state leaf, preallocated.

    ``data[key]`` mirrors the state dict's shape: a list of per-layer
    arrays when the state holds a list, else a single array.
    """

    def __init__(self, template: Dict[str, Any], page_size: int):
        def alloc(r: np.ndarray) -> np.ndarray:
            return np.zeros((page_size,) + r.shape[1:], r.dtype)

        self.data: Dict[str, Any] = {
            k: [alloc(r) for r in v] if isinstance(v, list) else alloc(v)
            for k, v in template.items()
        }

    def write(self, row: int, state: Dict[str, Any]) -> None:
        for k, dst in self.data.items():
            if isinstance(dst, list):
                for d, src in zip(dst, state[k]):
                    d[row] = src[0]
            else:
                dst[row] = state[k][0]

    def read(self, row: int) -> Dict[str, Any]:
        return {
            k: ([a[row:row + 1].copy() for a in v] if isinstance(v, list)
                else v[row:row + 1].copy())
            for k, v in self.data.items()
        }


class StatePool:
    """Paged storage of per-stream decode states, keyed by stream id.

    ``put(key, state)`` parks a batch-1 state (host or device arrays; device
    arrays are copied to host) into a free page row, allocating a new page
    only when every existing row is taken.  ``take(key)`` returns the parked
    state (fresh host arrays, leading batch-1 axis -- ready for
    ``models.lstm_lm.write_quant_slot``) and recycles the row.  Misuse is a
    ``ValueError``, not silent corruption: parking a key twice (the stream
    is already swapped out), taking or freeing an absent key (double-resume
    / double-free), or a row whose leading axis is not 1.
    """

    def __init__(self, page_size: int = 8):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        self._pages: List[_Page] = []
        self._free: List[Tuple[int, int]] = []  # (page, row), LIFO reuse
        self._where: Dict[Any, Tuple[int, int]] = {}
        self._template: Optional[Dict[str, Any]] = None
        self.peak_live = 0  # high-water mark of parked streams

    # -- capacity introspection ---------------------------------------------

    def __len__(self) -> int:
        return len(self._where)

    def __contains__(self, key) -> bool:
        return key in self._where

    @property
    def n_pages(self) -> int:
        return len(self._pages)

    @property
    def capacity(self) -> int:
        return len(self._pages) * self.page_size

    @property
    def state_bytes_per_stream(self) -> int:
        """Host bytes one parked stream occupies (the paper's 'tiny state'
        claim, measurable: a few KB/stream vs a KV cache's MBs).  Summed
        generically over the state pytree, so it is correct for any cell
        (LSTM h+c, GRU h, ...)."""
        if self._template is None:
            return 0
        return int(sum(
            sum(a.nbytes for a in v) if isinstance(v, list) else v.nbytes
            for v in self._template.values()))

    def location(self, key) -> Tuple[int, int]:
        """(page, row) a key is parked at -- for tests pinning page reuse."""
        if key not in self._where:
            raise ValueError(f"stream {key!r} is not in the pool")
        return self._where[key]

    # -- park / resume ------------------------------------------------------

    def put(self, key, state: Dict[str, Any]) -> None:
        """Park a batch-1 state under ``key``.  O(state bytes) host copy."""
        if key in self._where:
            raise ValueError(
                f"stream {key!r} is already in the pool (double swap-out)")
        row_state = {
            k: ([_as_row(x) for x in v] if isinstance(v, list)
                else _as_row(v))
            for k, v in state.items()
        }
        if self._template is not None:
            if set(row_state) != set(self._template):
                raise ValueError(
                    f"state leaves {sorted(row_state)} do not match the "
                    f"pool's template {sorted(self._template)}")
        if self._template is None:
            self._template = row_state
        if not self._free:
            self._pages.append(_Page(self._template, self.page_size))
            pg = len(self._pages) - 1
            # push rows reversed so allocation order is row 0, 1, 2, ...
            self._free.extend((pg, r)
                              for r in reversed(range(self.page_size)))
        loc = self._free.pop()
        self._pages[loc[0]].write(loc[1], row_state)
        self._where[key] = loc
        self.peak_live = max(self.peak_live, len(self._where))

    def take(self, key) -> Dict[str, Any]:
        """Un-park ``key``'s state and recycle its row.

        Raises ``ValueError`` for an absent key -- a double resume (or a
        resume of a never-preempted stream) is a scheduler bug and must not
        fabricate a zero state.
        """
        if key not in self._where:
            raise ValueError(
                f"stream {key!r} is not in the pool (double resume?)")
        pg, row = self._where.pop(key)
        state = self._pages[pg].read(row)
        self._free.append((pg, row))
        return state

    def free(self, key) -> None:
        """Drop a parked state without reading it (stream cancelled)."""
        if key not in self._where:
            raise ValueError(
                f"stream {key!r} is not in the pool (double free?)")
        self._free.append(self._where.pop(key))
