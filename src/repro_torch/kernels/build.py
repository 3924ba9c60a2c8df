"""Build the package's CUDA kernels with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use into a shared library with a
plain C interface under ``kernels/build/`` (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

The file name carries a hash of the sources, so an edited kernel is never
served from a stale build.  ``build_all`` starts one ``nvcc`` per source at
once.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
KERNELS = ("int8_matmul", "quant_lstm_scan", "quant_gru_scan", "int_layernorm",
           "quant_lstm_cell", "flash_attention", "flash_attention_bwd")
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_LIBS: Dict[str, ctypes.CDLL] = {}
_FNS: Dict[tuple, object] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:12]}.so"


def _command(name: str, out: Path):
    return [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-Xptxas", "-v", f"-I{CSRC}",
            "-o", str(out), str(CSRC / f"{name}.cu")]


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library in parallel.

    Returns ``{name: seconds}`` for the ones compiled now; writes each
    compiler log (with ``ptxas`` register/shared-memory lines) beside the
    library as ``<lib>.log``.  Raises on the first failed build.
    """
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (target, tmp, time.perf_counter(), subprocess.Popen(
            _command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    seconds = {}
    failed = []
    for name, (target, tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        target.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build_log(name: str) -> str:
    path = _target(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built if needed, loaded once."""
    if name not in _LIBS:
        build_all([name])
        _LIBS[name] = ctypes.CDLL(str(_target(name)))
    return _LIBS[name]


def function(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of library ``name`` with its ctypes signature, set once
    (the wrappers call this per launch; the lookup is a dict hit)."""
    fn = _FNS.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = argtypes
        fn.restype = restype
        _FNS[(name, symbol)] = fn
    return fn


def launch(name: str, tensors, ints, n_sm: int, device) -> None:
    """``<name>_launch(ptrs, ints, n_sm, stream)`` of library ``name``:
    the tensors' pointers (None for null) and the int32 scalar block as
    arrays, on ``device``'s current stream; raises on a launch error."""
    import torch  # nothing here runs at import time

    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if t is None else t.data_ptr() for t in tensors])
    vals = (ctypes.c_int32 * len(ints))(*ints)
    fn = function(name, f"{name}_launch", [ctypes.c_void_p, ctypes.c_void_p,
                                           ctypes.c_int, ctypes.c_void_p])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(ptrs), ctypes.addressof(vals), n_sm, stream)
    check(err, name)


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def require(t, name: str, dtype, shape, device):
    """Check a kernel argument's device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t
