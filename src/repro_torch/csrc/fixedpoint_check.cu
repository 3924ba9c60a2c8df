// Device-side check of fixedpoint.cuh (not a port of a TPU kernel).
//
// The two kernels of this package reach the gemmlowp arithmetic only through
// the values their data happens to produce.  This file evaluates the header's
// functions on the card over inputs chosen to cover them: tanh_q15 and
// sigmoid_q15 on every int16 input for each requested integer_bits, the
// LayerNorm rsqrt multiplier on given variances, and MBQM on given
// (x, m0, shift) triples.  chip_smoke.py holds the results against the
// PyTorch port (repro_torch/core/fixedpoint.py), which the CPU tests hold
// against the JAX reference.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void activations(const int32_t* bits, int n_bits, int16_t* tanh_out,
                            int16_t* sigmoid_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;  // n_bits x 65536 inputs
  if (i >= n_bits * 65536) return;
  const int32_t x = (i & 0xffff) - 32768;
  tanh_out[i] = fp::tanh_q15(x, bits[i >> 16]);
  sigmoid_out[i] = fp::sigmoid_q15(x, bits[i >> 16]);
}

__global__ void rsqrt_multipliers(const int64_t* v, int n, int extra_pow2,
                                  int32_t* m0, int32_t* shift) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) fp::rsqrt_multiplier((uint64_t)v[i], extra_pow2, &m0[i], &shift[i]);
}

__global__ void mbqms(const int32_t* x, const int32_t* m0, const int32_t* shift,
                      int n, int32_t* out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n) out[i] = fp::mbqm(x[i], m0[i], shift[i]);
}

int blocks(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Plain C entry point (bound with ctypes).  Any count may be 0.
//   activations: bits[n_bits] -> tanh_out, sigmoid_out [n_bits][65536] int16
//   rsqrt:       v[n_v] int64 -> m0, shift [n_v] int32 (extra_pow2 fixed)
//   mbqm:        x, m0, shift [n_m] int32 -> out [n_m] int32
// Returns cudaGetLastError().
extern "C" int fixedpoint_check_launch(
    const void* bits, int n_bits, void* tanh_out, void* sigmoid_out,
    const void* v, int n_v, int extra_pow2, void* rsqrt_m0, void* rsqrt_shift,
    const void* x, const void* m0, const void* shift, int n_m, void* mbqm_out,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_bits > 0)
    activations<<<blocks(n_bits * 65536), kThreads, 0, s>>>(
        static_cast<const int32_t*>(bits), n_bits, static_cast<int16_t*>(tanh_out),
        static_cast<int16_t*>(sigmoid_out));
  if (n_v > 0)
    rsqrt_multipliers<<<blocks(n_v), kThreads, 0, s>>>(
        static_cast<const int64_t*>(v), n_v, extra_pow2,
        static_cast<int32_t*>(rsqrt_m0), static_cast<int32_t*>(rsqrt_shift));
  if (n_m > 0)
    mbqms<<<blocks(n_m), kThreads, 0, s>>>(
        static_cast<const int32_t*>(x), static_cast<const int32_t*>(m0),
        static_cast<const int32_t*>(shift), n_m, static_cast<int32_t*>(mbqm_out));
  return static_cast<int>(cudaGetLastError());
}
