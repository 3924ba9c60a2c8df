// Blockwise online-softmax attention, forward (causal / sliding window, GQA).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (repro/kernels/flash_attention.py, body `_kernel`).  Per (batch, head)
// and per tile of q rows, over the key tiles in order:
//   logits = (q . k^T, float32) * scale, masked to -1e30
//            (causal: k <= q + q_offset; window: k > q + q_offset - window;
//             keys past Sk take no weight, so any Sq/Sk is taken)
//   m' = max(m, rowmax);  alpha = exp(m - m');  p = exp(logits - m')
//   l  = l * alpha + rowsum(p);  acc = acc * alpha + bf16_or_f32(p) . v
//   out = acc / max(l, 1e-30), cast to the input type
//   lse = m + log(max(l, 1e-30))   (float32 (B, Sq, H), where asked for:
//         what the backward, flash_attention_bwd.cu, reads)
// in float32 registers, as the TPU kernel keeps them in VMEM scratch.
// q is (B, Sq, H, D), k and v (B, Sk, KVH, D), read through their strides
// (no transpose, no repeat_kv copy: head h reads KV head h / (H / KVH)).
//
// What bounds it on an H100: at the prefill shape (B 2, H 32, S 4096,
// D 128, causal) operations, 2*B*H*S^2*D = 275 GFLOP against 168 MB of
// q/k/v/o: 0.28 ms at the 989 TFLOP/s of the bf16 tensor cores.  Two forms:
//  * the tensor-core form (bf16, D 64, 112, 128 or 256, rows 16-byte
//    aligned: every tensor the model passes; flash_wgmma_kernel), shaped after
//    FlashAttention-3.  One CTA of two warpgroups per (128-row q tile,
//    head, batch); thread 0 issues TMA copies: the q tile once, then each
//    K and V tile (128 keys; 64 at D 256, where the q tile and two stages
//    of 128-key K and V tiles would need 320 KB of shared memory, the
//    64-key ring 192 KB) into a two-stage ring guarded by full/empty
//    mbarriers, refilling a stage as soon as both warpgroups are done with
//    it, so the next tile is in flight while the tensor cores work on this
//    one.  The tensor maps are 4-D (D, heads, S, B) over the tensors' own
//    strides, so GQA and strided views are read in place; 128-byte
//    swizzle, a 256-byte bf16 row taking two 64-column boxes; TMA fills
//    rows past Sq or Sk with zeros, and at D 112 (kimi) columns 112-127 of
//    the second box, so the tiles are D 128's (tiles::tc_padded): S takes
//    D / 16 = 7 k-steps, P v the n128 product, and 112 columns are stored.
//    Each warpgroup owns 64 q rows (with all of its 255 registers: a separate producer warpgroup, its
//    registers handed over by setmaxnreg, measured slower, as did
//    overlapping one tile's softmax with the next tile's products, which
//    ptxas serializes: PERF.md): S = q k^T is wgmma m64n128k16 with both
//    operands in shared memory (m64n64k16 at D 256); P is formed from the S
//    accumulators in registers, rounded to bf16 (the TPU kernel's cast; l
//    sums the unrounded float32 p) and fed as the register A operand of
//    O += P v, v being the MN-major shared-memory B operand (at D 256 two
//    m64n128k16 halves: a warpgroup's 64 x 256 float32 O takes 128 of a
//    thread's 255 registers, S 32 and P 16).  Only key tiles that
//    cross the causal diagonal, the window edge or Sk run the mask
//    (tiles::tile_masked); exponentials are exp2f with log2(e) folded into
//    the scale; causal q tiles are scheduled longest first.
//  * the FMA form (float32, other head widths, unaligned rows) stages 64 x
//    64 tiles as float32 and runs the products on the float32 FMA units
//    (67 TFLOP/s), 256 threads each holding a 4 x 4 block of logits
//    (flash_kernel; a thread's output columns 4-wide where D is a multiple
//    of 64, else strided by 16, as at D 16 and 112); two CTAs an SM, one at
//    D 256 (194 KB of tiles).
// Both skip the key tiles that the mask empties for every row of the q
// tile (tiles::tile_range, exact; flash_tiles.cuh).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;       // FMA form: query rows per block
constexpr int kBK = 64;       // FMA form: key rows per step
constexpr int kThreads = 256;  // FMA form: 16 x 16, tx owns columns, ty rows
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, Sq, H), or null: not written
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;  // element strides
  int B, Sq, Sk, H, KVH, causal, window, q_offset;
  float scale;
};

__host__ __device__ __forceinline__ tiles::Mask mask_of(const Args& a) {
  return tiles::Mask{a.Sq, a.Sk, a.causal, a.window, a.q_offset};
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// shared-memory layout (floats): Q [kBQ][D+4], K [kBK][D+4] (later reused
// for P [kBQ][kBK+4]), V [kBK][D]; the +4 keeps 16-byte loads of
// neighbouring rows on distinct banks
template <int D>
struct Smem {
  static constexpr int kRow = D + 4;
  static constexpr int kPRow = kBK + 4;
  static constexpr int kQ = kBQ * kRow;
  static constexpr int kKP = (kBK * kRow > kBQ * kPRow) ? kBK * kRow : kBQ * kPRow;
  static constexpr int kV = kBK * D;
  static constexpr size_t kBytes = sizeof(float) * (kQ + kKP + kV);
  // CTAs an SM that the tiles leave room for (227 KB a block, 228 an SM)
  static constexpr int kMinBlocks = 2 * kBytes <= 227 * 1024 ? 2 : 1;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Smem<D>::kMinBlocks)
    flash_kernel(Args a) {
  using S = Smem<D>;
  constexpr int kVec = D % 64 == 0 ? 4 : 1;  // accumulator columns a group
  constexpr int kCols = D / 16;          // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + S::kQ;
  float* Ps = Ks;  // P reuses K's space once the logits are formed
  float* Vs = Ks + S::kKP;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
  const T* k = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* v = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D, s = q0 + r;
    Qs[r * S::kRow + d] = s < a.Sq ? to_f32(q[s * a.qss + d]) : 0.f;
  }

  const tiles::Mask mk = mask_of(a);
  int kt0, kt1;
  tiles::tile_range(mk, q0, kBQ, kBK, &kt0, &kt1);

  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last step's P and V reads are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int r = e / D, d = e % D, s = k0 + r;
      const bool in = s < a.Sk;
      Ks[r * S::kRow + d] = in ? to_f32(k[s * a.kss + d]) : 0.f;
      Vs[r * D + d] = in ? to_f32(v[s * a.vss + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * S::kRow + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * S::kRow + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
    __syncthreads();  // every thread is done reading K: P may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qp = q0 + r + a.q_offset;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = tiles::attends(mk, qp, k0 + tx + 16 * j) ? s[i][j] * a.scale
                                                    : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of this row
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        Ps[r * S::kPRow + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * S::kPRow + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* vrow = Vs + (kk + e) * D;
        float vv[kCols];
#pragma unroll
        for (int g = 0; g < kCols / kVec; ++g) {
          if constexpr (kVec == 4) {
            const float4 t = *reinterpret_cast<const float4*>(&vrow[g * 64 + tx * 4]);
            vv[4 * g] = t.x;
            vv[4 * g + 1] = t.y;
            vv[4 * g + 2] = t.z;
            vv[4 * g + 3] = t.w;
          } else {
            vv[g] = vrow[g * 16 + tx];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = e == 0 ? p4[i].x : e == 1 ? p4[i].y : e == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

  T* o = static_cast<T*>(a.o);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= a.Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* dst = o + ((static_cast<size_t>(b) * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = kVec == 4 ? (c / 4) * 64 + tx * 4 + (c % 4) : c * 16 + tx;
      dst[col] = from_f32<T>(acc[i][c] / den);
    }
    if (a.lse != nullptr && tx == 0)  // m, l are the 16 lanes' common values
      a.lse[(static_cast<size_t>(b) * a.Sq + s) * a.H + h] = m[i] + logf(den);
  }
}


// ---- the tensor-core form (bf16, D 64, 112, 128 or 256, 16-byte aligned
// rows) ----

namespace tc {

using namespace hopper;

constexpr int kBQ = tiles::kTcBQ;  // q rows per CTA: 64 a consumer warpgroup
constexpr int kStages = tiles::kTcStages;  // K/V ring depth
constexpr int kConsumers = 2;  // warpgroups of 64 q rows
constexpr int kThreads = 128 * kConsumers;
static_assert(kBox == tiles::kTcBox, "a TMA box is the plan's 64 columns");
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// tile byte sizes; a tile is Dp/64 column blocks of rows x 128 bytes (Dp
// the padded width, tiles::tc_padded), each block 128-byte swizzled by TMA.
// Keys per K/V tile: 128, or 64 at D 256 (tiles::tc_block_k)
template <int D>
struct Layout {
  static_assert(tiles::tc_width_ok(D), "not a tensor-core head width");
  static constexpr int kDp = tiles::tc_padded(D);
  static constexpr int kBK = tiles::tc_block_k(D);
  static constexpr int kQ = kBQ * kDp * 2;
  static constexpr int kKV = kBK * kDp * 2;
  static constexpr size_t kBytes = tiles::tc_smem_bytes(D);
  static_assert(kBytes == kQ + 2 * kStages * kKV + 1024, "layout");
};

struct Params {
  void* o;
  float* lse;  // (B, Sq, H), or null
  int B, Sq, Sk, H, KVH, causal, window, q_offset, n_qt;
  float scale_log2;  // scale * log2(e)
  int q_pos[3], k_pos[3], v_pos[3];  // tensor-map coordinate of (h, s, b)
};

// O (64 x D float32) += P (64 x 16 keys, registers) * v (16 keys x D, the
// MN-major K/V stage at `vt`, its 64-column blocks BK * 128 bytes apart);
// D 256 takes two n128 halves
template <int D, int BK>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2], const uint32_t (&a)[4],
                                         const uint8_t* vt) {
  if constexpr (D == 256) {
    wgmma_rs<128, 0>(d, a, make_desc(vt, BK * 128, 1024));
    wgmma_rs<128, 64>(d, a, make_desc(vt + 2 * BK * 128, BK * 128, 1024));
  } else {
    wgmma_rs<D>(d, a, make_desc(vt, BK * 128, 1024));
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, Params a) {
  using L = Layout<D>;
  constexpr int kDp = L::kDp;    // the width the boxes and P v run at
  constexpr int kBK = L::kBK;    // keys per K/V tile
  constexpr int kS = kBK / 2;    // S accumulators a thread: 64 x kBK
  constexpr int kCB = kDp / kBox;  // column blocks of a row
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_k[kStages], bar_v[kStages],
      bar_empty[kStages];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + L::kQ;
  uint8_t* Vs = Ks + kStages * L::kKV;

  // the q tile of this CTA: heads fastest, so the heads sharing a KV head
  // run side by side; causal tiles longest (last) first
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % a.B;
  int qt = rest / a.B;
  if (a.causal) qt = a.n_qt - 1 - qt;
  const int q0 = qt * kBQ;
  const int kvh = h / (a.H / a.KVH);
  const tiles::Mask mk{a.Sq, a.Sk, a.causal, a.window, a.q_offset};
  int kt0, kt1;
  tiles::tile_range(mk, q0, kBQ, kBK, &kt0, &kt1);
  const int n_kt = kt1 - kt0;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_k[s], 1);
      mbar_init(&bar_v[s], 1);
      mbar_init(&bar_empty[s], 128 * kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  // thread 0 feeds the ring: the q tile and the first kStages K/V tiles
  // now, each later tile as soon as both warpgroups are done with the
  // stage it reuses
  auto load_kv = [&](int i) {
    const int s = i % kStages, k0 = (kt0 + i) * kBK;
    int c[4];
    mbar_expect_tx(&bar_k[s], L::kKV);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.k_pos, cb * kBox, kvh, k0, b);
      tma_load(Ks + s * L::kKV + cb * kBK * 128, &tm_k, c, &bar_k[s]);
    }
    mbar_expect_tx(&bar_v[s], L::kKV);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.v_pos, cb * kBox, kvh, k0, b);
      tma_load(Vs + s * L::kKV + cb * kBK * 128, &tm_v, c, &bar_v[s]);
    }
  };
  if (threadIdx.x == 0) {
    int c[4];
    mbar_expect_tx(&bar_q, L::kQ);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.q_pos, cb * kBox, h, q0, b);
      tma_load(Qs + cb * kBQ * 128, &tm_q, c, &bar_q);
    }
    for (int i = 0; i < kStages && i < n_kt; ++i) load_kv(i);
  }
  {
    // ---- consumer warpgroup wg: q rows [64 wg, 64 wg + 64) of the tile ----
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows r0, r0 + 8
    const int qp0 = q0 + r0 + a.q_offset, qp1 = qp0 + 8;
    const int qp_lo = q0 + wg * 64 + a.q_offset, qp_hi = qp_lo + 63;
    const float sl2 = a.scale_log2;

    float o[kDp / 2];
#pragma unroll
    for (int i = 0; i < kDp / 2; ++i) o[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

    mbar_wait(&bar_q, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages;
      const uint32_t phase = (i / kStages) & 1;
      const int k0 = (kt0 + i) * kBK;
      const uint8_t* Kt = Ks + s * L::kKV;
      const uint8_t* Vt = Vs + s * L::kKV;

      // S = q k^T: 64 rows x kBK keys, D / 16 k-steps of 32 bytes each (the
      // padded columns past D are never read)
      float sacc[kS];
#pragma unroll
      for (int i2 = 0; i2 < kS; ++i2) sacc[i2] = 0.f;  // overwritten: scale_d 0
      mbar_wait(&bar_k[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int cb = kk / 4, kin = (kk % 4) * 32;
        wgmma_ss<kBK>(sacc,
                      make_desc(Qs + cb * kBQ * 128 + wg * 64 * 128 + kin, 16,
                                1024),
                      make_desc(Kt + cb * kBK * 128 + kin, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sacc);

      // logits in log2 units; the mask only on the tiles that need it
      // (keys past Sk take no weight at all: -inf)
#pragma unroll
      for (int i2 = 0; i2 < kS; ++i2) sacc[i2] *= sl2;
      if (tiles::tile_masked(mk, qp_lo, qp_hi, k0, kBK)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + 2 * t4 + e;
            if (kp >= a.Sk) {
              sacc[4 * j + e] = -INFINITY;
              sacc[4 * j + 2 + e] = -INFINITY;
            } else {
              if (!tiles::attends(mk, qp0, kp)) sacc[4 * j + e] = kNegInf;
              if (!tiles::attends(mk, qp1, kp)) sacc[4 * j + 2 + e] = kNegInf;
            }
          }
        }
      }
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float alpha0 = exp2f(m0 - n0), alpha1 = exp2f(m1 - n1);
      float sum0 = 0.f, sum1 = 0.f;
      uint32_t pa[kBK / 16][4];  // P as the A operand; k-step kk = keys 16kk..
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j) {
        const float p00 = exp2f(sacc[4 * j] - n0);
        const float p01 = exp2f(sacc[4 * j + 1] - n0);
        const float p10 = exp2f(sacc[4 * j + 2] - n1);
        const float p11 = exp2f(sacc[4 * j + 3] - n1);
        sum0 += p00 + p01;
        sum1 += p10 + p11;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p00, p01);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p10, p11);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
        sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
      m0 = n0;
      m1 = n1;
#pragma unroll
      for (int c = 0; c < kDp / 8; ++c) {
        o[4 * c] *= alpha0;
        o[4 * c + 1] *= alpha0;
        o[4 * c + 2] *= alpha1;
        o[4 * c + 3] *= alpha1;
      }

      // O += P v: kBK / 16 k-steps of 16 keys; v is MN-major (D
      // contiguous), its 64-column blocks kBK * 128 bytes apart
      mbar_wait(&bar_v[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_pv<kDp, kBK>(o, pa[kk], Vt + kk * 16 * 128);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(&bar_empty[s]);
      if (threadIdx.x == 0 && i + kStages < n_kt) {
        mbar_wait(&bar_empty[s], phase);
        load_kv(i + kStages);
      }
    }

    const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o);
    const int s0 = q0 + r0, s1 = s0 + 8;
#pragma unroll
    for (int c = 0; c < kDp / 8; ++c) {
      const int d = 8 * c + 2 * t4;
      if (d >= D) continue;  // the padded columns (zeros) are not stored
      if (s0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(b) * a.Sq + s0) * a.H + h) * D + d) =
            __floats2bfloat162_rn(o[4 * c] / d0, o[4 * c + 1] / d0);
      if (s1 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(
            out + ((static_cast<size_t>(b) * a.Sq + s1) * a.H + h) * D + d) =
            __floats2bfloat162_rn(o[4 * c + 2] / d1, o[4 * c + 3] / d1);
    }
    // the row's log-sum-exp in natural units (m is in log2 units; a row
    // that attends no key keeps m = -1e30, as the reference's does), from
    // the first of the 4 lanes that share the row
    if (a.lse != nullptr && t4 == 0) {
      if (s0 < a.Sq)
        a.lse[(static_cast<size_t>(b) * a.Sq + s0) * a.H + h] =
            m0 == kNegInf ? kNegInf : m0 * kLn2 + logf(d0);
      if (s1 < a.Sq)
        a.lse[(static_cast<size_t>(b) * a.Sq + s1) * a.H + h] =
            m1 == kNegInf ? kNegInf : m1 * kLn2 + logf(d1);
    }
  }
}

// ---- host: the launch ----

template <int D>
int launch(const Args& a, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  Params p{a.o, a.lse, a.B, a.Sq, a.Sk, a.H, a.KVH, a.causal, a.window, a.q_offset,
           (a.Sq + kBQ - 1) / kBQ, a.scale * kLog2e};
  constexpr int kBK = Layout<D>::kBK;
  if (!make_map(&mq, p.q_pos, a.q, D, a.H, a.Sq, a.B, a.qsh, a.qss, a.qsb,
                kBQ) ||
      !make_map(&mk, p.k_pos, a.k, D, a.KVH, a.Sk, a.B, a.ksh, a.kss, a.ksb,
                kBK) ||
      !make_map(&mv, p.v_pos, a.v, D, a.KVH, a.Sk, a.B, a.vsh, a.vss, a.vsb,
                kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = Layout<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = static_cast<long long>(p.n_qt) * a.H * a.B;
  flash_wgmma_kernel<D><<<static_cast<unsigned>(grid), kThreads, smem,
                          stream>>>(mq, mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// TMA reads every row of q, k and v in place
bool rows_aligned(const Args& a) {
  return hopper::rows_aligned(a.q, a.qsb, a.qss, a.qsh) &&
         hopper::rows_aligned(a.k, a.ksb, a.kss, a.ksh) &&
         hopper::rows_aligned(a.v, a.vsb, a.vss, a.vsh);
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_kernel<T, D><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int D, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(a, stream);
    case 64: return launch<T, 64>(a, stream);
    case 112: return launch<T, 112>(a, stream);
    case 128: return launch<T, 128>(a, stream);
    case 256: return launch<T, 256>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 = float32, 1 = bfloat16.
// Strides are in elements; the last axis of q, k, v is contiguous and the
// output is a contiguous (B, Sq, H, D); lse, where not null, a contiguous
// float32 (B, Sq, H).  Returns cudaGetLastError() (or
// cudaErrorInvalidValue where a tensor map cannot be made).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, void* lse,
    long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int B, int Sq, int Sk, int H,
    int KVH, int D, int dtype, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   k,   v,   o,  static_cast<float*>(lse), qsb, qss, qsh,
               ksb, kss, ksh, vsb, vss, vsh, B,   Sq,  Sk,  H,   KVH,
               causal, window, q_offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && rows_aligned(a)) {
    switch (D) {
      case 64: return tc::launch<64>(a, st);
      case 112: return tc::launch<112>(a, st);
      case 128: return tc::launch<128>(a, st);
      case 256: return tc::launch<256>(a, st);
      default: break;
    }
  }
  return dtype == 1 ? launch_dim<__nv_bfloat16>(a, D, st)
                    : launch_dim<float>(a, D, st);
}
