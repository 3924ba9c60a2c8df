"""The CUDA kernels' fixed-point header, compiled for the host, against the
port's PyTorch fixed point.

``src/repro_torch/csrc/fixedpoint.cuh`` is also valid host C++.  Here g++
compiles a small program around it, which evaluates the inputs of
``repro_torch.kernels.fixedpoint_check.cases``: tanh_q15 and sigmoid_q15 on
every int16 input for integer_bits 0..15, the LayerNorm rsqrt multiplier on
edge and random variances, MBQM on edge and random triples.  Every result
must EQUAL ``repro_torch.core.fixedpoint`` (held equal to the JAX reference
by ``test_torch_fixedpoint.py``).  ``chip_smoke.py`` runs the same check
with the header compiled for the card.  The cell header ``lstm_cell.cuh``
(the arithmetic of the cell kernel and of the LSTM sequence kernel) is
compiled the same way and must equal the port's plain cell.
"""
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import fixedpoint_check as FC  # noqa: E402

CSRC = Path(__file__).resolve().parents[1] / "src" / "repro_torch" / "csrc"

PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

#include "fixedpoint.cuh"

template <class T> static std::vector<T> take(int32_t n) {
  std::vector<T> v(n);
  if (n && fread(v.data(), sizeof(T), n, stdin) != (size_t)n) throw 1;
  return v;
}

template <class T> static void put(const std::vector<T>& v) {
  fwrite(v.data(), sizeof(T), v.size(), stdout);
}

int main() {
  int32_t n[3];  // bits, v, mbqm triples
  if (fread(n, sizeof(int32_t), 3, stdin) != 3) return 1;
  const auto bits = take<int32_t>(n[0]);
  const auto v = take<int64_t>(n[1]);
  const auto x = take<int32_t>(n[2]);
  const auto m0 = take<int32_t>(n[2]);
  const auto shift = take<int32_t>(n[2]);
  std::vector<int16_t> th, sg;
  for (int32_t b : bits)
    for (int32_t q = -32768; q < 32768; ++q) {
      th.push_back(fp::tanh_q15(q, b));
      sg.push_back(fp::sigmoid_q15(q, b));
    }
  std::vector<int32_t> rm(v.size()), rs(v.size()), mq(x.size());
  for (size_t i = 0; i < v.size(); ++i)
    fp::rsqrt_multiplier((uint64_t)v[i], EXTRA_POW2, &rm[i], &rs[i]);
  for (size_t i = 0; i < x.size(); ++i) mq[i] = fp::mbqm(x[i], m0[i], shift[i]);
  put(th); put(sg); put(rm); put(rs); put(mq);
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_results(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    work = tmp_path_factory.mktemp("fixedpoint_cuh")
    (work / "sweep.cpp").write_text(PROGRAM)
    exe = work / "sweep"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}",
                    f"-DEXTRA_POW2={FC.RSQRT_EXTRA_POW2}", "-o", str(exe),
                    str(work / "sweep.cpp")], check=True, timeout=120)
    c = FC.cases(seed=3)
    nb, nv, nm = len(c["bits"]), len(c["v"]), len(c["x"])
    blob = b"".join([np.array([nb, nv, nm], np.int32).tobytes(),
                     c["bits"].tobytes(), c["v"].tobytes(), c["x"].tobytes(),
                     c["m0"].tobytes(), c["shift"].tobytes()])
    raw = subprocess.run([str(exe)], input=blob, capture_output=True,
                         check=True, timeout=120).stdout
    got, pos = {}, 0
    for key, dtype, count in (("tanh", np.int16, nb * 65536),
                              ("sigmoid", np.int16, nb * 65536),
                              ("rsqrt_m0", np.int32, nv),
                              ("rsqrt_shift", np.int32, nv),
                              ("mbqm", np.int32, nm)):
        got[key] = np.frombuffer(raw, dtype, count, pos)
        pos += count * np.dtype(dtype).itemsize
    assert pos == len(raw)
    want = {k: v.numpy().reshape(-1) for k, v in
            FC.expected(c, torch.device("cpu")).items()}
    return got, want


@pytest.mark.parametrize("key", ["tanh", "sigmoid", "rsqrt_m0",
                                 "rsqrt_shift", "mbqm"])
def test_header_equals_torch_port(host_results, key):
    got, want = host_results
    assert got[key].dtype == want[key].dtype
    np.testing.assert_array_equal(got[key], want[key])


CELL_PROGRAM = r"""
#include <cstdint>
#include <cstdio>
#include <vector>

#include "lstm_cell.cuh"

int main() {
  int32_t a[10];  // n, cifg, cell_int_bits, peephole, eff_c_o, eff_m, zp_m
  if (fread(a, sizeof(int32_t), 10, stdin) != 10) return 1;
  const int n = a[0];
  std::vector<int16_t> i(n), f(n), z(n), c(n), p(n);
  std::vector<int32_t> o(n);
  for (auto* v : {&i, &f, &z, &c, &p})
    if (fread(v->data(), sizeof(int16_t), n, stdin) != (size_t)n) return 1;
  if (fread(o.data(), sizeof(int32_t), n, stdin) != (size_t)n) return 1;
  std::vector<int16_t> c_new(n);
  std::vector<int8_t> m(n);
  for (int k = 0; k < n; ++k) {
    c_new[k] = cell::update_c(i[k], f[k], z[k], c[k], a[1], a[2]);
    const int32_t o16 = a[3] ? cell::o_peephole(o[k], p[k], c_new[k], a[4], a[5])
                             : o[k];
    m[k] = cell::hidden_out(o16, c_new[k], a[2], a[6], a[7], a[8]);
  }
  fwrite(c_new.data(), sizeof(int16_t), n, stdout);
  fwrite(m.data(), sizeof(int8_t), n, stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def cell_exe(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    work = tmp_path_factory.mktemp("lstm_cell_cuh")
    (work / "cell.cpp").write_text(CELL_PROGRAM)
    exe = work / "cell"
    subprocess.run([gxx, "-std=c++17", "-O2", f"-I{CSRC}", "-o", str(exe),
                    str(work / "cell.cpp")], check=True, timeout=120)
    return exe


@pytest.mark.parametrize("peephole", [False, True])
@pytest.mark.parametrize("cifg", [False, True])
@pytest.mark.parametrize("m_c", [0, 2, 4])
def test_cell_header_equals_plain_cell(cell_exe, m_c, cifg, peephole):
    """``lstm_cell.cuh`` (the cell of both CUDA cell paths) on the host
    equals the port's plain cell, o-gate peephole contract included."""
    from repro_torch.core import fixedpoint as tfp
    from repro_torch.kernels import ref as tref

    rng = np.random.default_rng(m_c + 3 * cifg + 7 * peephole)
    B, H = 4, 512
    i, f, z = (rng.integers(-32768, 32768, (B, H)).astype(np.int16)
               for _ in range(3))
    c = rng.integers(-32768, 32768, (B, H)).astype(np.int16)
    p = np.broadcast_to(rng.integers(-32767, 32768, H).astype(np.int16),
                        (B, H))
    if peephole:
        o = rng.integers(-(2**24), 2**24, (B, H)).astype(np.int32)
    else:
        o = rng.integers(-32768, 32768, (B, H)).astype(np.int32)
    eff_c_o = tfp.quantize_multiplier(0.37)
    eff_m = tfp.quantize_multiplier(2.0**-30 / 0.005)
    head = np.array([B * H, cifg, m_c, peephole, *eff_c_o, *eff_m, -4, 0],
                    np.int32)
    blob = b"".join(a.tobytes() for a in (head, i, f, z, c,
                                          np.ascontiguousarray(p), o))
    raw = subprocess.run([str(cell_exe)], input=blob, capture_output=True,
                         check=True, timeout=120).stdout
    got_c = np.frombuffer(raw, np.int16, B * H).reshape(B, H)
    got_m = np.frombuffer(raw, np.int8, B * H, 2 * B * H).reshape(B, H)
    t = [torch.from_numpy(a) for a in (i, f, z)]
    kw = dict(p_o=torch.from_numpy(p[0].copy()), eff_c_o=eff_c_o) \
        if peephole else {}
    o_in = torch.from_numpy(o if peephole else o.astype(np.int16))
    m, c_new = tref.quant_lstm_cell(*t, o_in, torch.from_numpy(c),
                                    cell_int_bits=m_c, cifg=cifg, eff_m=eff_m,
                                    zp_m=-4, **kw)
    np.testing.assert_array_equal(got_c, c_new.numpy())
    np.testing.assert_array_equal(got_m, m.numpy())
