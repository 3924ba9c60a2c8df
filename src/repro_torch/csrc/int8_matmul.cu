// int8 x int8 -> int32 GEMM with the fused requantize epilogue.
//
// Replaces the TPU kernel `int8_matmul_pallas` (repro/kernels/int8_matmul.py,
// body `_kernel`): out = x @ w + fold, returned as int32, or rescaled per
// output channel by MBQM(m0[n], shift[n]) + zp_out and clipped to int8 or
// int16.  On the serving path it is the hoisted input stage of every layer
// (M = B*T rows, K = 2048 or 640, N = 8192, int32 out).
//
// What bounds it on an H100: at decode (M = B = 4) the whole cost is reading
// the K x N int8 weight once (16.8 MB at K = 2048): bytes.  At prefill
// (M = 128) it is still bytes-bound by a wide margin against the int8 tensor
// cores (1979 TOP/s).  The design keeps the weight read to one pass per
// BM-row block of M: BM = 16 for decode-size M (so the padding rows cost
// little), 64 otherwise.  Each block owns 64 output columns and walks K in
// 128-deep slabs staged in shared memory; the next slab's 16-byte global
// loads are issued before the current slab is multiplied.  Each thread
// multiplies 4 k at a time with __dp4a, packing the weight's k-major bytes
// with `transpose4`.  Ragged M, N and K are masked (byte loads when a row is
// not 16-byte aligned); the padding is 0, never the zero point, which lives
// in `fold`.  Tensor-core (mma/wgmma) tiles are later work.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "int8_pack.cuh"

namespace {

constexpr int BN = 64;
constexpr int BK = 128;
constexpr int kAs = BK + 16;  // padded row of the x slab: no bank conflicts
constexpr int kThreads = 256;  // 16 x 16; thread (ty, tx) owns 4 columns

// Stages one BM x BK slab of x and one BK x BN slab of w.  With `vec`, every
// 16-byte chunk is either wholly inside the matrix or wholly outside it.
template <int BM>
struct Slabs {
  static constexpr int kA = BM * BK / 16;  // 16-byte chunks per slab
  static constexpr int kB = BK * BN / 16;
  static constexpr int kPerThread = (kA + kB + kThreads - 1) / kThreads;
  int4 reg[kPerThread];

  __device__ void fetch(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                        int M, int N, int K, int m_base, int n_base, int k0) {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      int4 val = make_int4(0, 0, 0, 0);
      if (e < kA) {
        const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
        if (m_base + r < M && k0 + c < K)
          val = __ldg(reinterpret_cast<const int4*>(x + (size_t)(m_base + r) * K + k0 + c));
      } else if (e < kA + kB) {
        const int r = (e - kA) / (BN / 16), c = ((e - kA) % (BN / 16)) * 16;
        if (k0 + r < K && n_base + c < N)
          val = __ldg(reinterpret_cast<const int4*>(w + (size_t)(k0 + r) * N + n_base + c));
      }
      reg[i] = val;
    }
  }

  __device__ void store(int8_t (*As)[kAs], int8_t (*Bs)[BN]) const {
#pragma unroll
    for (int i = 0; i < kPerThread; ++i) {
      const int e = threadIdx.x + i * kThreads;
      if (e < kA) {
        *reinterpret_cast<int4*>(&As[e / (BK / 16)][(e % (BK / 16)) * 16]) = reg[i];
      } else if (e < kA + kB) {
        *reinterpret_cast<int4*>(&Bs[(e - kA) / (BN / 16)][((e - kA) % (BN / 16)) * 16]) = reg[i];
      }
    }
  }
};

// Byte-wise staging for shapes whose rows are not 16-byte aligned.
template <int BM>
__device__ void stage_bytes(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                            int M, int N, int K, int m_base, int n_base, int k0,
                            int8_t (*As)[kAs], int8_t (*Bs)[BN]) {
  for (int e = threadIdx.x; e < BM * BK; e += kThreads) {
    const int r = e / BK, c = e % BK;
    const int gm = m_base + r, gk = k0 + c;
    As[r][c] = (gm < M && gk < K) ? x[(size_t)gm * K + gk] : (int8_t)0;
  }
  for (int e = threadIdx.x; e < BK * BN; e += kThreads) {
    const int r = e / BN, c = e % BN;
    const int gk = k0 + r, gn = n_base + c;
    Bs[r][c] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : (int8_t)0;
  }
}

// out_kind: 0 int32 (acc + fold), 1 int8, 2 int16 (MBQM epilogue)
template <int BM>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                   const int32_t* __restrict__ fold,
                   const int32_t* __restrict__ m0,
                   const int32_t* __restrict__ shift, void* __restrict__ out,
                   int M, int N, int K, int out_kind, int zp_out, int vec) {
  constexpr int RM = BM / 16;  // rows per thread
  __shared__ __align__(16) int8_t As[BM][kAs];  // row m, k contiguous
  __shared__ __align__(16) int8_t Bs[BK][BN];  // row k, n contiguous
  const int tx = threadIdx.x % 16;  // columns 4 tx .. 4 tx + 3
  const int ty = threadIdx.x / 16;  // rows ty + 16 i
  const int m_base = blockIdx.y * BM;
  const int n_base = blockIdx.x * BN;
  int acc[RM][4];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  Slabs<BM> slabs;
  if (vec) slabs.fetch(x, w, M, N, K, m_base, n_base, 0);
  for (int k0 = 0; k0 < K; k0 += BK) {
    if (vec) {
      slabs.store(As, Bs);
    } else {
      stage_bytes<BM>(x, w, M, N, K, m_base, n_base, k0, As, Bs);
    }
    __syncthreads();
    if (vec && k0 + BK < K) slabs.fetch(x, w, M, N, K, m_base, n_base, k0 + BK);
#pragma unroll 4
    for (int kq = 0; kq < BK / 4; ++kq) {
      int cols[4];
      pack::transpose4(*reinterpret_cast<const int*>(&Bs[4 * kq + 0][4 * tx]),
                       *reinterpret_cast<const int*>(&Bs[4 * kq + 1][4 * tx]),
                       *reinterpret_cast<const int*>(&Bs[4 * kq + 2][4 * tx]),
                       *reinterpret_cast<const int*>(&Bs[4 * kq + 3][4 * tx]), cols);
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const int a = *reinterpret_cast<const int*>(&As[ty + 16 * i][4 * kq]);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, cols[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int gm = m_base + ty + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n_base + 4 * tx + j;
      if (gn >= N) continue;
      const size_t o = (size_t)gm * N + gn;
      const int32_t v = fp::wrap32((int64_t)acc[i][j] + fold[gn]);
      if (out_kind == 0) {
        static_cast<int32_t*>(out)[o] = v;
        continue;
      }
      const int64_t y = fp::wrap32((int64_t)fp::mbqm(v, m0[gn], shift[gn]) + zp_out);
      if (out_kind == 1) {
        static_cast<int8_t*>(out)[o] = fp::sat8(y);
      } else {
        static_cast<int16_t*>(out)[o] = fp::sat16(y);
      }
    }
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* w, const void* fold, const void* m0,
                   const void* shift, void* out, int M, int N, int K, int out_kind,
                   int zp_out, int vec, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(fold), static_cast<const int32_t*>(m0),
      static_cast<const int32_t*>(shift), out, M, N, K, out_kind, zp_out, vec);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Returns cudaGetLastError().
extern "C" int int8_matmul_launch(const void* x, const void* w,
                                  const void* fold, const void* m0,
                                  const void* shift, void* out, int M, int N,
                                  int K, int out_kind, int zp_out,
                                  void* stream) {
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  const int vec = aligned && K % 16 == 0 && N % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      M <= 16 ? launch<16>(x, w, fold, m0, shift, out, M, N, K, out_kind, zp_out, vec, s)
              : launch<64>(x, w, fold, m0, shift, out, M, N, K, out_kind, zp_out, vec, s);
  return static_cast<int>(err);
}
