"""The int8 GEMM kernel's plain version against the JAX reference.

The plain version is what a CPU tensor runs and what the CUDA kernel is
held against on the card, so it must equal the reference's
``ops.int8_matmul`` (both epilogues) and the exact int64 oracle on ragged
shapes the TPU kernel does not take.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import fixedpoint as jfp  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import int8_matmul as tmm  # noqa: E402


def _operands(M, K, N, seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(M, K)).astype(np.int8)
    w = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    fold = rng.integers(-(2**20), 2**20, size=N).astype(np.int32)
    pairs = [jfp.quantize_multiplier(float(s))
             for s in rng.uniform(1e-5, 3e-3, size=N)]
    m0 = np.array([p[0] for p in pairs], np.int32)
    shift = np.array([p[1] for p in pairs], np.int32)
    return x, w, fold, m0, shift


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("out", ["int32", "int8", "int16"])
def test_plain_matches_reference_epilogues(backend, out):
    x, w, fold, m0, shift = _operands(128, 256, 256, 0)
    jdt = {"int32": jnp.int32, "int8": jnp.int8, "int16": jnp.int16}[out]
    tdt = {"int32": torch.int32, "int8": torch.int8, "int16": torch.int16}[out]
    zp = -5 if out != "int32" else 0
    want = np.asarray(jops.int8_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(fold), jnp.asarray(m0),
        jnp.asarray(shift), out_dtype=jdt, zp_out=zp, backend=backend))
    got = tmm.int8_matmul(*_t(x, w, fold, m0, shift), out_dtype=tdt,
                          zp_out=zp)
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (3, 17, 5), (4, 640, 33),
                                   (37, 100, 130), (4, 2048, 20)])
def test_plain_ragged_shapes_match_int64_oracle(M, K, N):
    x, w, fold, _, _ = _operands(M, K, N, M + K + N)
    got = tmm.int8_matmul_plain(*_t(x, w, fold))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  jref.int8_matmul_np(x, w, fold))


def test_plain_extreme_accumulation_is_exact():
    """-128 * -128 over K = 2048 reaches 2**25: past float32's 2**24 but
    exact in the plain version's float64 product."""
    x = np.full((2, 2048), -128, np.int8)
    w = np.full((2048, 8), -128, np.int8)
    fold = np.arange(8, dtype=np.int32)
    got = tmm.int8_matmul_plain(*_t(x, w, fold))
    np.testing.assert_array_equal(got.numpy().astype(np.int64),
                                  jref.int8_matmul_np(x, w, fold))


def test_wrapper_validates_arguments():
    x, w, fold, m0, shift = _t(*_operands(4, 8, 8, 1))
    with pytest.raises(ValueError):
        tmm.int8_matmul(x, w, fold, out_dtype=torch.int8)  # no m0/shift
    with pytest.raises(ValueError):
        tmm.int8_matmul(x, w, fold, m0, shift, out_dtype=torch.float32)
