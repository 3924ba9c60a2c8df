// int8 x int8 -> int32 GEMM with the fused requantize epilogue, on the int8
// tensor cores of an H100.
//
// Replaces the TPU kernel `int8_matmul_pallas` (repro/kernels/int8_matmul.py,
// body `_kernel`): out = x @ w + fold, returned as int32 (wrapping), or
// rescaled per output channel by MBQM(m0[n], shift[n]) + zp_out and clipped
// to int8 or int16.  On the serving paths it is every layer's input stage
// (M = B T rows, K = 2048 or 640, N = 8192 or 6144), the stepwise pass's
// recurrent product (M = 4, K = 640) and the LSTM projection (M = 4,
// K = 2048, N = 640, int8 out).
//
// What bounds it on an H100: bytes.  At M <= 32 the whole cost is reading
// the K x N weight once (16.8 MB at K 2048, N 8192: 5.0 us at 3.35 TB/s);
// at M = 128 it is still the weight and the int32 output (6.3 us) against
// 1.3 us of int8 tensor-core work at the 1979 TOP/s peak.  So the design is
// about SMs in use and bytes in flight, with the products on the tensor
// cores so they never become the limit.  The plan (gemm_plan.cuh) picks:
//
// * the weight-streaming form for M <= 32: x zero-padded to 16 or 32 rows
//   (the padding is zero-filled by the copy, never read from memory), BN in
//   {128, 64, 32} columns a CTA and K split over up to 8 CTAs, so that every
//   SM gets a CTA at the serving shapes (N 640, 6144, 8192; K 640, 2048), and
//   a ring of up to 4 stages of 64 k (8 KB of weight each at BN = 128): 24
//   KB in flight a CTA, two or three CTAs an SM;
// * the tensor-core form for M > 32: 64 x 128 output tiles (128 x 128
//   past M 128), 8 multiplying warps and 4 that only issue the copies, a
//   6-stage ring, K not split.
//
// What limits it on the card (PERF.md): the tensor form by the rate at
// which an SM takes in its CTA's copies (each CTA reads 384 KB of x and w
// at M 128, and a CTA's time does not fall when the grid has fewer CTAs),
// the weight-streaming form by the weight's bytes and the launch floor.
//
// Both copy x and w into shared memory as they are stored (cp.async, 16
// bytes a thread, zero-filled past M, N and K) and multiply with mma.sync
// m16n8k32 (int8 in, int32 accumulate).  The weight is (K, N), n-contiguous,
// while the B operand wants 4 consecutive k of one column in a register:
// a transposing ldmatrix over 16-bit column pairs brings 2 rows of 2
// columns a word, and two byte permutes (pack::split_pairs) give the even
// and the odd column's words, each the B operand of its own n8 tile; the
// epilogue puts the columns back in order (gemm::frag_col).  No weight is
// repacked in memory, and x never goes through __dp4a.
//
// The split of K is reduced exactly in the same launch: the CTAs of one
// output tile form a thread-block cluster; each pushes every 4-column
// piece of its int32 partial tile into the shared memory of the CTA that
// finishes that piece (distributed shared memory), and after one cluster
// barrier each sums its pieces over the cluster's partials, adds fold and
// runs the epilogue.  (A first barrier, whose arrive is issued at the
// kernel's start and whose wait comes after the products, makes sure every
// CTA of the cluster has started before its shared memory is written.)
// The sums are int32 with wrap (unsigned arithmetic: the integers mod
// 2**32, a ring), so any order of the partial sums, the tensor cores'
// included, gives the plain version's bits.  The kernel's waits are the
// cluster barrier and cp.async's group wait, both hardware barriers that
// every CTA of the cluster reaches unconditionally; it polls nothing.
// Ragged M, N and K are masked (byte copies where a row of x or w is not
// 16-byte aligned); the padding is 0, never the zero point, which lives in
// `fold`.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fixedpoint.cuh"
#include "gemm_plan.cuh"
#include "int8_pack.cuh"

namespace cg = cooperative_groups;

namespace {

using gemm::kBK;

struct Args {
  const int8_t* x;
  const int8_t* w;
  const int32_t* fold;
  const int32_t* m0;
  const int32_t* shift;
  void* out;
  int M, N, K;
  int out_kind;  // 0 int32 (acc + fold), 1 int8, 2 int16 (MBQM epilogue)
  int zp_out;
  int vec;  // rows of x and w 16-byte aligned: cp.async, else byte copies
  int steps, split, stages;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; with ok false the 16 bytes are
// zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most n of this thread's copy groups are pending (n is an
// immediate of the instruction; n = stages - 2 <= 4)
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a (16 x 32, row) . b (32 x 8, col), int8 in, int32 accumulate with
// wrap (no .satfinite)
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], int b0,
                                       int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

// A copying thread's share (thread `tid` of kCopiers) of the 16-byte
// copies of one stage (cp.async path): the same chunks of x and w at every
// step, so their shared-memory offsets and global addresses are computed
// once and a step only adds k0.
template <int BM, int BN, int kCopiers>
struct Copies {
  static constexpr int kAChunks = BM * kBK / 16, kBChunks = kBK * BN / 16;
  static constexpr int kNA = (kAChunks + kCopiers - 1) / kCopiers;
  static constexpr int kNB = (kBChunks + kCopiers - 1) / kCopiers;
  const int8_t* ga[kNA];
  const int8_t* gb[kNB];
  int sa[kNA], sb[kNB];  // offsets in the stage, -1: no chunk
  int ka[kNA], kb[kNB];  // k of the chunk within the step
  bool va[kNA], vb[kNB];  // its row of x / columns of w exist

  __device__ __forceinline__ void init(const Args& a, int m_base, int n_base, int tid) {
#pragma unroll
    for (int j = 0; j < kNA; ++j) {
      const int e = tid + j * kCopiers, r = e >> 2, c = e & 3;
      va[j] = e < kAChunks && m_base + r < a.M;
      sa[j] = e < kAChunks ? gemm::a_offset(r, c) : -1;
      ka[j] = 16 * c;
      ga[j] = a.x + (va[j] ? (size_t)(m_base + r) * a.K + 16 * c : 0);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const int e = tid + j * kCopiers, k = e / (BN / 16), c = e % (BN / 16);
      vb[j] = e < kBChunks && n_base + 16 * c < a.N;
      sb[j] = e < kBChunks ? BM * kBK + gemm::b_offset(k, c, BN) : -1;
      kb[j] = k;
      gb[j] = a.w + (vb[j] ? (size_t)k * a.N + n_base + 16 * c : 0);
    }
  }

  // step `step` of K into the stage at `slot`; zeros past M, N and K
  __device__ __forceinline__ void issue(const Args& a, int8_t* slot, int step) const {
    const int k0 = step * kBK;
#pragma unroll
    for (int j = 0; j < kNA; ++j) {
      const bool ok = va[j] && k0 + ka[j] < a.K;
      if (sa[j] >= 0) cp_async16(slot + sa[j], ok ? ga[j] + k0 : a.x, ok);
    }
#pragma unroll
    for (int j = 0; j < kNB; ++j) {
      const bool ok = vb[j] && k0 + kb[j] < a.K;
      if (sb[j] >= 0) cp_async16(slot + sb[j], ok ? gb[j] + (size_t)k0 * a.N : a.w, ok);
    }
  }
};

// The byte copies of one stage, for x or w whose rows are not 16-byte
// aligned (ragged K or N): the same layout, synchronous.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ void copy_bytes(const Args& a, int8_t* slot, int step,
                                           int m_base, int n_base) {
  const int k0 = step * kBK;
  for (int e = threadIdx.x; e < BM * kBK; e += kThreads) {
    const int r = e / kBK, kb = e % kBK;
    const int gm = m_base + r, gk = k0 + kb;
    slot[gemm::a_offset(r, kb >> 4) + (kb & 15)] =
        gm < a.M && gk < a.K ? a.x[(size_t)gm * a.K + gk] : (int8_t)0;
  }
  int8_t* Bs = slot + BM * kBK;
  for (int e = threadIdx.x; e < kBK * BN; e += kThreads) {
    const int k = e / BN, n = e % BN;
    const int gk = k0 + k, gn = n_base + n;
    Bs[gemm::b_offset(k, n >> 4, BN) + (n & 15)] =
        gk < a.K && gn < a.N ? a.w[(size_t)gk * a.N + gn] : (int8_t)0;
  }
}

// acc += half `h` (k 32 h .. 32 h + 31) of the stage's x slab . w slab: the
// warp's MT A fragments (ldmatrix), then per n16 chunk the B fragments of
// its even and odd columns (transposing ldmatrix + split_pairs) and 2 MT
// mma.sync.  aoff / boff: the lane's ldmatrix offsets in the A and B slabs.
template <int MT, int NC>
__device__ __forceinline__ void multiply(const int8_t* As, const int8_t* Bs, int h,
                                         const int (&aoff)[2][MT], const int (&boff)[2][NC],
                                         int (&acc)[MT][NC][2][4]) {
  uint32_t af[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) ldsm_x4(af[mt], As + aoff[h][mt]);
#pragma unroll
  for (int nc = 0; nc < NC; ++nc) {
    uint32_t r[4];
    ldsm_x4_trans(r, Bs + boff[h][nc]);
    int lo[2], hi[2];  // [even, odd column] words of k 0..15, 16..31
    pack::split_pairs(static_cast<int>(r[0]), static_cast<int>(r[1]), lo);
    pack::split_pairs(static_cast<int>(r[2]), static_cast<int>(r[3]), hi);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      mma_s8(acc[mt][nc][0], af[mt], lo[0], hi[0]);
      mma_s8(acc[mt][nc][1], af[mt], lo[1], hi[1]);
    }
  }
}

// out[gm, n_base + col .. + 3] from the piece's sums s; `epi` holds the
// tile's fold, m0 and shift (columns past N skipped)
__device__ __forceinline__ void store_piece(const Args& a, const int32_t* epi, int bn,
                                            int gm, int n_base, int col,
                                            const uint32_t (&s)[4]) {
  const int gn = n_base + col;
  const int nv = a.N - gn < 4 ? a.N - gn : 4;
  const bool vec = nv == 4 && (a.N & 3) == 0;  // aligned to the 4 elements
  const size_t o = (size_t)gm * a.N + gn;
  int32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)  // acc + fold, wrapping like the reference
    v[j] = static_cast<int32_t>(s[j] + static_cast<uint32_t>(epi[col + j]));
  if (a.out_kind == 0) {
    int32_t* out = static_cast<int32_t*>(a.out) + o;
    if (vec) {
      *reinterpret_cast<int4*>(out) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int j = 0; j < nv; ++j) out[j] = v[j];
    }
    return;
  }
  int32_t y[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    y[j] = fp::wrap32((int64_t)fp::mbqm(v[j], epi[bn + col + j], epi[2 * bn + col + j]) +
                      a.zp_out);
  if (a.out_kind == 1) {
    int8_t* out = static_cast<int8_t*>(a.out) + o;
    if (vec) {
      *reinterpret_cast<char4*>(out) =
          make_char4(fp::sat8(y[0]), fp::sat8(y[1]), fp::sat8(y[2]), fp::sat8(y[3]));
    } else {
      for (int j = 0; j < nv; ++j) out[j] = fp::sat8(y[j]);
    }
  } else {
    int16_t* out = static_cast<int16_t*>(a.out) + o;
    if (vec) {
      *reinterpret_cast<short4*>(out) = make_short4(fp::sat16(y[0]), fp::sat16(y[1]),
                                                    fp::sat16(y[2]), fp::sat16(y[3]));
    } else {
      for (int j = 0; j < nv; ++j) out[j] = fp::sat16(y[j]);
    }
  }
}

// One CTA: output tile (blockIdx.y, blockIdx.z) of BM x BN, split
// blockIdx.x of a.split along K (the CTA's rank in its cluster).  WM x WN
// multiplying warps, each (BM / WM) x (BN / WN): MT m16 blocks by NC n16
// chunks; then CW copying warps, which issue every cp.async of the ring
// (CW = 0: the multiplying warps copy too).  A copy instruction waits to
// issue while the SM has many bytes in flight (hundreds of cycles a
// stage); in warps of their own the copies no longer hold up the tensor
// form's mma.sync.
template <int BM, int BN, int WM, int WN, int CW>
__global__ void __launch_bounds__(32 * (WM * WN + CW)) gemm_kernel(const Args a) {
  constexpr int kCompute = 32 * WM * WN;
  constexpr int kCopiers = CW > 0 ? 32 * CW : kCompute;
  constexpr int kThreads = 32 * (WM * WN + CW);
  constexpr int MT = BM / WM / 16, NC = BN / WN / 16;
  constexpr int kStage = BM * kBK + kBK * BN;
  constexpr int kQ = BN / 4;  // pieces (4 columns) a row
  extern __shared__ __align__(128) int8_t smem[];
  const int rank = blockIdx.x;
  // a split CTA's partial sums go to the other CTAs' shared memory, which
  // exists once they have all started: the barrier's first half now, its
  // second half (cluster_wait) after the products
  if (a.split > 1) cluster_arrive_relaxed();
  const int m_base = blockIdx.y * BM, n_base = blockIdx.z * BN;
  const int s_lo = gemm::split_lo(rank, a.steps, a.split);
  const int nst = gemm::split_lo(rank + 1, a.steps, a.split) - s_lo;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // whole warps; with CW = 0 every thread does both
  const bool copier = CW == 0 || threadIdx.x >= kCompute;
  const bool multiplier = CW == 0 || threadIdx.x < kCompute;
  const int wr = (warp / WN) * (BM / WM), wc = (warp % WN) * NC;
  int32_t* epi = reinterpret_cast<int32_t*>(smem + a.stages * kStage);

  int aoff[2][MT], boff[2][NC];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) aoff[h][mt] = gemm::a_lane_offset(lane, wr + 16 * mt, 32 * h);
#pragma unroll
    for (int nc = 0; nc < NC; ++nc) boff[h][nc] = gemm::b_lane_offset(lane, 32 * h, wc + nc, BN);
  }
  int acc[MT][NC][2][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nc = 0; nc < NC; ++nc)
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nc][t][i] = 0;

  // the tile's fold, m0, shift for the epilogue: loaded while the ring fills
  auto load_epi = [&]() {
    for (int c = threadIdx.x; c < BN; c += kThreads) {
      const int gn = n_base + c;
      const bool in = gn < a.N;
      epi[c] = in ? a.fold[gn] : 0;
      if (a.out_kind != 0) {
        epi[BN + c] = in ? a.m0[gn] : 0;
        epi[2 * BN + c] = in ? a.shift[gn] : 0;
      }
    }
  };

  if (a.vec) {
    // the ring: stages - 1 slabs in flight while one is multiplied
    Copies<BM, BN, kCopiers> copies;
    if (copier) {
      copies.init(a, m_base, n_base, CW > 0 ? threadIdx.x - kCompute : threadIdx.x);
      for (int i = 0; i < a.stages - 1; ++i) {
        if (i < nst) copies.issue(a, smem + i * kStage, s_lo + i);
        cp_async_commit();
      }
    }
    load_epi();
    int slot = 0, fill = a.stages - 1;  // the stage multiplied, the one filled
    for (int i = 0; i < nst; ++i) {
      if (copier) cp_async_wait(a.stages - 2);  // the copies of step i landed
      __syncthreads();  // and are visible to all; stage `fill` is free
      if (copier) {
        if (i + a.stages - 1 < nst) copies.issue(a, smem + fill * kStage, s_lo + i + a.stages - 1);
        cp_async_commit();
      }
      if (multiplier) {
        const int8_t* As = smem + slot * kStage;
        multiply<MT, NC>(As, As + BM * kBK, 0, aoff, boff, acc);
        multiply<MT, NC>(As, As + BM * kBK, 1, aoff, boff, acc);
      }
      slot = slot + 1 == a.stages ? 0 : slot + 1;
      fill = fill + 1 == a.stages ? 0 : fill + 1;
    }
    if (copier) cp_async_wait(0);
  } else {
    load_epi();
    for (int i = 0; i < nst; ++i) {
      copy_bytes<BM, BN, kThreads>(a, smem, s_lo + i, m_base, n_base);
      __syncthreads();
      if (multiplier) {
        multiply<MT, NC>(smem, smem + BM * kBK, 0, aoff, boff, acc);
        multiply<MT, NC>(smem, smem + BM * kBK, 1, aoff, boff, acc);
      }
      __syncthreads();
    }
  }
  __syncthreads();  // `epi` is written

  const int rows = a.M - m_base < BM ? a.M - m_base : BM;
  if (a.split == 1) {  // the epilogue straight from the accumulators
    if (!multiplier) return;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gemm::frag_row(lane, wr + 16 * mt, h);
          const int col = gemm::frag_col(lane, wc + nc);
          if (r >= rows || n_base + col >= a.N) continue;
          const int (&t0)[4] = acc[mt][nc][0];
          const int (&t1)[4] = acc[mt][nc][1];
          const uint32_t s[4] = {static_cast<uint32_t>(t0[2 * h]), static_cast<uint32_t>(t1[2 * h]),
                                 static_cast<uint32_t>(t0[2 * h + 1]),
                                 static_cast<uint32_t>(t1[2 * h + 1])};
          store_piece(a, epi, BN, m_base + r, n_base, col, s);
        }
    return;
  }

  // split K: push each piece of the partial tile to the CTA that finishes
  // it (slot `rank` of its receive buffer), then that CTA sums its pieces
  cg::cluster_group cluster = cg::this_cluster();
  const int pieces = rows * kQ;
  const int share = gemm::recv_share(pieces, a.split);
  int4* recv = reinterpret_cast<int4*>(smem + a.stages * kStage + gemm::epi_bytes(BN));
  cluster_wait();  // every CTA of the cluster has started
  if (multiplier) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nc = 0; nc < NC; ++nc)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = gemm::frag_row(lane, wr + 16 * mt, h);
          if (r >= rows) continue;
          const int e = r * kQ + gemm::frag_col(lane, wc + nc) / 4;
          const int q = gemm::piece_owner(e, pieces, a.split);
          const int (&t0)[4] = acc[mt][nc][0];
          const int (&t1)[4] = acc[mt][nc][1];
          *(cluster.map_shared_rank(recv, q) + rank * share +
            (e - gemm::split_lo(q, pieces, a.split))) =
              make_int4(t0[2 * h], t1[2 * h], t0[2 * h + 1], t1[2 * h + 1]);
        }
  }
  cluster_arrive_release();  // the pushes are visible to their owners
  cluster_wait();
  const int lo = gemm::split_lo(rank, pieces, a.split);
  const int hi = gemm::split_lo(rank + 1, pieces, a.split);
  for (int j = threadIdx.x; j < hi - lo; j += kThreads) {
    const int e = lo + j, r = e / kQ, col = (e % kQ) * 4;
    if (n_base + col >= a.N) continue;
    uint32_t s[4] = {0u, 0u, 0u, 0u};
    for (int src = 0; src < a.split; ++src) {
      const int4 v = recv[src * share + j];
      s[0] += static_cast<uint32_t>(v.x);
      s[1] += static_cast<uint32_t>(v.y);
      s[2] += static_cast<uint32_t>(v.z);
      s[3] += static_cast<uint32_t>(v.w);
    }
    store_piece(a, epi, BN, m_base + r, n_base, col, s);
  }
}

template <int BM, int BN, int WM, int WN, int CW>
cudaError_t launch(const Args& a, const gemm::Plan& p, cudaStream_t stream) {
  auto kernel = gemm_kernel<BM, BN, WM, WN, CW>;
  // the dynamic shared-memory ceiling, raised once a device
  static bool raised[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64 || !raised[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               gemm::kSmemMax);
    if (err != cudaSuccess) return err;
    if (dev >= 0 && dev < 64) raised[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.split, p.tiles_m, p.tiles_n);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // a cluster only where K is split
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the kernel instance of gemm::kTiles[T]
template <int T>
cudaError_t launch_tile(const Args& a, const gemm::Plan& p, cudaStream_t stream) {
  static_assert(T >= 0 && T < gemm::kNumTiles, "no such tile");
  constexpr gemm::Tile tl = gemm::kTiles[T];
  return launch<tl.bm, tl.bn, tl.wm, tl.wn, tl.cw>(a, p, stream);
}

}  // namespace

// The plan of a launch at (M, N, K) on n_sm SMs: out = {form, bm, bn,
// threads, tiles_m, tiles_n, split, steps, stages, smem}.  Returns 0, or the
// gemm::PlanError that refuses the shape.
extern "C" int int8_matmul_plan(int M, int N, int K, int n_sm, long long* out) {
  const gemm::Plan p = gemm::plan(M, N, K, n_sm);
  const long long vals[10] = {p.form,    p.bm,    p.bn,    p.threads, p.tiles_m,
                              p.tiles_n, p.split, p.steps, p.stages,  p.smem};
  for (int i = 0; i < 10; ++i) out[i] = vals[i];
  return p.err;
}

// Plain C entry point (bound with ctypes).  Returns a cudaError_t: the
// launch's, or cudaErrorInvalidValue where the plan refuses the shape.
extern "C" int int8_matmul_launch(const void* x, const void* w, const void* fold,
                                  const void* m0, const void* shift, void* out, int M,
                                  int N, int K, int out_kind, int zp_out, int n_sm,
                                  void* stream) {
  const gemm::Plan p = gemm::plan(M, N, K, n_sm);
  if (p.err != gemm::kPlanOk) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const int8_t*>(x);
  a.w = static_cast<const int8_t*>(w);
  a.fold = static_cast<const int32_t*>(fold);
  a.m0 = static_cast<const int32_t*>(m0);
  a.shift = static_cast<const int32_t*>(shift);
  a.out = out;
  a.M = M;
  a.N = N;
  a.K = K;
  a.out_kind = out_kind;
  a.zp_out = zp_out;
  a.vec = K % 16 == 0 && N % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w)) & 15) == 0;
  a.steps = p.steps;
  a.split = p.split;
  a.stages = p.stages;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (p.tile) {
    case 0: err = launch_tile<0>(a, p, s); break;
    case 1: err = launch_tile<1>(a, p, s); break;
    case 2: err = launch_tile<2>(a, p, s); break;
    case 3: err = launch_tile<3>(a, p, s); break;
    case 4: err = launch_tile<4>(a, p, s); break;
    case 5: err = launch_tile<5>(a, p, s); break;
    case 6: err = launch_tile<6>(a, p, s); break;
    default: err = launch_tile<7>(a, p, s); break;
  }
  return static_cast<int>(err);
}
