// Code shared by the row kernels of the stepwise LSTM step (the gate pass
// and LayerNorm of int_layernorm.cu, the cell's LN form of
// quant_lstm_cell.cu): their cluster launch, and the exact LayerNorm
// statistics of a row split over a thread-block cluster (ln_plan.cuh).
// Each CTA reduces its partial Sum q and Sum q^2 through warp shuffles,
// pushes them into the shared memory of every CTA of its cluster
// (distributed shared memory), and after one cluster barrier each CTA sums
// the C partials -- exact int64 sums, so any order gives the same bits --
// and every thread forms V = n Sum q^2 - (Sum q)^2 and its rsqrt
// multiplier itself: no serial step is broadcast back.
#pragma once
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

#include "fixedpoint.cuh"
#include "ln_plan.cuh"

namespace blk {

namespace cg = cooperative_groups;

constexpr int kWarps = lnp::kMaxThreads / 32;

// The two halves of a cluster barrier (every thread of the CTA calls each)
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

struct RowShared {
  long long warp_s[kWarps], warp_q[kWarps];
  long long part_s[lnp::kMaxCluster], part_q[lnp::kMaxCluster];
};

// A row's LayerNorm constants (fp::layernorm_apply's arguments)
struct RowNorm {
  int32_t sum, m0, shift;
  bool deg;
};

// The row's exact statistics from each thread's partial sums.  With C > 1
// the CTA must have called cluster_arrive_relaxed() once at its start (so
// every CTA of the cluster has started before its shared memory is
// written); every thread of every CTA of the cluster calls this once.
__device__ __forceinline__ RowNorm row_norm(long long s, long long q, int n, int C,
                                            int rank, RowShared* sh) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xffffffffu, s, off);
    q += __shfl_down_sync(0xffffffffu, q, off);
  }
  if (lane == 0) {
    sh->warp_s[warp] = s;
    sh->warp_q[warp] = q;
  }
  __syncthreads();
  const int warps = blockDim.x / 32;
  long long a = 0, b = 0;
  if (C > 1) {
    cluster_wait();  // every CTA of the cluster has started
    if ((int)threadIdx.x < C) {
      for (int w = 0; w < warps; ++w) {
        a += sh->warp_s[w];
        b += sh->warp_q[w];
      }
      cg::cluster_group cluster = cg::this_cluster();
      *cluster.map_shared_rank(&sh->part_s[rank], (int)threadIdx.x) = a;
      *cluster.map_shared_rank(&sh->part_q[rank], (int)threadIdx.x) = b;
    }
    cluster_arrive_release();  // the pushes are visible to their owners
    cluster_wait();
    a = b = 0;
    for (int r = 0; r < C; ++r) {
      a += sh->part_s[r];
      b += sh->part_q[r];
    }
  } else {
    for (int w = 0; w < warps; ++w) {
      a += sh->warp_s[w];
      b += sh->warp_q[w];
    }
  }
  RowNorm r;
  const long long v = (long long)n * b - a * a;  // >= 0, < 2**59
  r.sum = (int32_t)a;
  r.deg = v == 0;
  fp::rsqrt_multiplier((uint64_t)v, 10, &r.m0, &r.shift);
  return r;
}

// Launch `kernel(args...)` over the row plan `pl`: pl.ctas CTAs of
// pl.threads threads in clusters of pl.C, pl.smem dynamic shared bytes.
// Where the plan's shared memory and the statistics' exceed the default
// 48 KiB, the kernel's ceiling is first raised to the most any plan asks.
template <typename... KArgs, typename... Args>
cudaError_t launch_rows(void (*kernel)(KArgs...), const lnp::Plan& pl,
                        cudaStream_t stream, Args&&... args) {
  if (pl.smem + (int)sizeof(RowShared) > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        2 * lnp::kMaxRow * (int)sizeof(int16_t));
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)pl.ctas);
  cfg.blockDim = dim3(pl.threads);
  cfg.dynamicSmemBytes = pl.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = pl.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pl.C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace blk
