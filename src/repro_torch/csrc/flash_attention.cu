// Blockwise online-softmax attention, forward (causal / sliding window, GQA).
//
// Replaces the TPU kernel `flash_attention_pallas`
// (repro/kernels/flash_attention.py, body `_kernel`).  Per (batch, head)
// and per tile of kBQ query rows, over the key tiles of kBK rows in order:
//   logits = (q . k^T, float32) * scale, masked to -1e30
//            (causal: k <= q + q_offset; window: k > q + q_offset - window;
//             keys past Sk are masked too, so any Sq/Sk is taken)
//   m' = max(m, rowmax);  alpha = exp(m - m');  p = exp(logits - m')
//   l  = l * alpha + rowsum(p);  acc = acc * alpha + bf16_or_f32(p) . v
//   out = acc / max(l, 1e-30), cast to the input type
// in float32 registers, as the TPU kernel keeps them in VMEM scratch.
// q is (B, Sq, H, D), k and v (B, Sk, KVH, D), read through their strides
// (no transpose, no repeat_kv copy: head h reads KV head h / (H / KVH)).
//
// What bounds it on an H100: at the prefill shape (B 2, H 32, S 4096,
// D 128, causal) operations, 2*B*H*S^2*D = 275 GFLOP against 168 MB of
// q/k/v/o: 0.28 ms at the 989 TFLOP/s of the bf16 tensor cores.  Two forms
// of one design, one block per (64-row q tile, head, batch) walking 64-row
// key tiles staged in shared memory, with the running max, denominator
// and accumulator of each row in registers:
//  * the tensor-core form (bf16, D 64 or 128, rows 16-byte aligned: every
//    tensor the model passes) runs both products as mma.sync.m16n8k16 with
//    float32 accumulation, 4 warps of 16 q rows each (flash_mma_kernel);
//  * the FMA form (float32, other head widths, unaligned rows) stages the
//    tiles as float32 and runs the products on the float32 FMA units (67
//    TFLOP/s), 256 threads each holding a 4 x 4 block of logits
//    (flash_kernel).
// Both skip the key tiles that the mask empties for every row of the q
// tile (after the diagonal for causal, before the window): the result is
// the same, since there alpha = 1 and p = 0 (causal) or a later alpha = 0
// wipes what they added (window).  Asynchronous tile loads (cp.async /
// TMA), wgmma and a pipelined ring of tiles are the later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per step
constexpr int kThreads = 256;  // 16 x 16: tx owns columns, ty rows
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;  // element strides
  int B, Sq, Sk, H, KVH, causal, window, q_offset;
  float scale;
};

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
};

// does the row at position qp have a key in [0, Sk) under the mask?
__device__ __forceinline__ bool row_attends(const Args& a, int qp) {
  const int lo = a.window > 0 ? max(qp - a.window + 1, 0) : 0;
  const int hi = a.causal ? min(qp, a.Sk - 1) : a.Sk - 1;
  return lo <= hi;
}

// The key tiles [kt0, kt1) the q tile at row q0 visits: all of them, or
// (when every row of the tile has a key; the count of keys a row attends
// is concave in its position, so the first and last rows decide) those
// the mask leaves non-empty for some row.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int& kt0,
                                           int& kt1) {
  const int n_tiles = (a.Sk + kBK - 1) / kBK;
  const int first = q0 + a.q_offset;
  const int last = min(q0 + kBQ, a.Sq) - 1 + a.q_offset;
  kt0 = 0;
  kt1 = n_tiles;
  if (row_attends(a, first) && row_attends(a, last)) {
    if (a.causal) kt1 = min(n_tiles, last / kBK + 1);
    if (a.window > 0) kt0 = max(0, (first - a.window + 1) / kBK);
  }
}

// the mask of key position kp for the row at position qp
__device__ __forceinline__ bool attends(const Args& a, int qp, int kp) {
  return kp < a.Sk && (!a.causal || kp <= qp) &&
         (a.window <= 0 || kp > qp - a.window);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2) flash_kernel(Args a) {
  using S = Smem<D>;
  constexpr int kVec = D >= 64 ? 4 : 1;  // accumulator columns per group
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

  int kt0, kt1;
  tile_range(a, q0, kt0, kt1);

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
        s[i][j] = attends(a, qp, k0 + tx + 16 * j) ? s[i][j] * a.scale
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
  }
}

// ---- the tensor-core form (bf16, D = 64 or 128, 16-byte aligned rows) ----
//
// One 128-thread block per (q tile, head, batch); warp w owns q rows
// 16w..16w+15.  The q tile's mma.sync A fragments stay in registers; each
// key tile is staged in shared memory as bf16 (rows padded by 8 values, so
// the fragment loads of 8 neighbouring rows fall on distinct banks).
// S = q k^T and O += P v run as mma.sync.m16n8k16 (bf16 in, float32
// accumulate); P is formed in registers from the S accumulators, rounded
// to bf16 as the A operand of the second product (the cast the TPU kernel
// makes), while the row sums l take the unrounded float32 p.  The online
// softmax statistics of a thread's two rows (g and g + 8 of its warp's 16)
// are reduced over the four lanes that share them.

__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8 x 8 bf16 matrices, transposed: the B fragments of two n-tiles
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const __nv_bfloat16* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

template <int D>
struct MmaSmem {
  static constexpr int kRow = D + 8;  // bf16 values per staged row
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * 3 * kBQ * kRow;
};

// one tile of rows [r0, r0 + 64) of a (S, D) bf16 matrix into shared
// memory, 16 bytes a load; rows past n are zeros
template <int D>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           long long stride, int r0, int n) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < kBQ * kChunks; c += 128) {
    const int r = c / kChunks, d = (c % kChunks) * 8, s = r0 + r;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < n) v = *reinterpret_cast<const uint4*>(src + s * stride + d);
    *reinterpret_cast<uint4*>(dst + r * MmaSmem<D>::kRow + d) = v;
  }
}

template <int D>
__global__ void __launch_bounds__(128) flash_mma_kernel(Args a) {
  constexpr int kRow = MmaSmem<D>::kRow;
  constexpr int kSteps = D / 16;  // k-steps of the q k^T product
  constexpr int kTiles = D / 8;   // n-tiles of the output
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_u4);
  __nv_bfloat16* Ks = Qs + kBQ * kRow;
  __nv_bfloat16* Vs = Ks + kBK * kRow;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;  // mma groupID, thread in group
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.KVH);
  using bf16 = __nv_bfloat16;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.qsb + h * a.qsh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;

  stage_rows<D>(Qs, q, a.qss, q0, a.Sq);
  __syncthreads();
  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
    const bf16* row = Qs + r0 * kRow + 16 * ks + 2 * t;
    qa[ks][0] = ld_u32(row);
    qa[ks][1] = ld_u32(row + 8 * kRow);
    qa[ks][2] = ld_u32(row + 8);
    qa[ks][3] = ld_u32(row + 8 * kRow + 8);
  }

  int kt0, kt1;
  tile_range(a, q0, kt0, kt1);
  const int qp0 = q0 + r0 + a.q_offset, qp1 = qp0 + 8;
  float o[kTiles][4];
#pragma unroll
  for (int n = 0; n < kTiles; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the last step's K and V reads are done
    stage_rows<D>(Ks, k, a.kss, k0, a.Sk);
    stage_rows<D>(Vs, v, a.vss, k0, a.Sk);
    __syncthreads();

    float s[8][4];  // 16 rows x 64 keys: n-tile j holds keys 8j..8j+7
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bf16* row = Ks + (8 * j + g) * kRow + 16 * ks + 2 * t;
        mma_bf16(s[j], qa[ks], ld_u32(row), ld_u32(row + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kp = k0 + 8 * j + 2 * t + e;
        s[j][e] = attends(a, qp0, kp) ? s[j][e] * a.scale : kNegInf;
        s[j][2 + e] = attends(a, qp1, kp) ? s[j][2 + e] * a.scale : kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {  // the 4 lanes of a row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - n0), alpha1 = expf(m1 - n1);
    float sum0 = 0.f, sum1 = 0.f;
    uint32_t pa[4][4];  // P as the A operand, k-step kk = keys 16kk..16kk+15
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p00 = expf(s[j][0] - n0), p01 = expf(s[j][1] - n0);
      const float p10 = expf(s[j][2] - n1), p11 = expf(s[j][3] - n1);
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
    for (int n = 0; n < kTiles; ++n) {
      o[n][0] *= alpha0;
      o[n][1] *= alpha0;
      o[n][2] *= alpha1;
      o[n][3] *= alpha1;
    }

    // lanes 0-7 / 8-15 address keys 0-7 / 8-15 of the k-step at column n,
    // lanes 16-31 the same keys at column n + 1
    const int key = (lane & 7) + ((lane >> 3) & 1) * 8;
    const int col = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int n = 0; n < kTiles; n += 2) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (16 * kk + key) * kRow + 8 * n + col);
        mma_bf16(o[n], pa[kk], vb[0], vb[1]);
        mma_bf16(o[n + 1], pa[kk], vb[2], vb[3]);
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* out = static_cast<bf16*>(a.o);
  const int s0 = q0 + r0, s1 = s0 + 8;
#pragma unroll
  for (int n = 0; n < kTiles; ++n) {
    const int d = 8 * n + 2 * t;
    if (s0 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<size_t>(b) * a.Sq + s0) * a.H + h) * D + d) =
          __floats2bfloat162_rn(o[n][0] / d0, o[n][1] / d0);
    if (s1 < a.Sq)
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<size_t>(b) * a.Sq + s1) * a.H + h) * D + d) =
          __floats2bfloat162_rn(o[n][2] / d1, o[n][3] / d1);
  }
}

template <int D>
int launch_mma(const Args& a, cudaStream_t stream) {
  const size_t smem = MmaSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.H, a.B);
  flash_mma_kernel<D><<<grid, 128, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads of every staged row: the bases and the strides of the
// batch, sequence and head axes are multiples of 8 bf16 values
bool rows_aligned(const Args& a) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(a.q) |
                         reinterpret_cast<uintptr_t>(a.k) |
                         reinterpret_cast<uintptr_t>(a.v);
  const long long strides =
      a.qsb | a.qss | a.qsh | a.ksb | a.kss | a.ksh | a.vsb | a.vss | a.vsh;
  return ptrs % 16 == 0 && strides % 8 == 0;
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
    case 128: return launch<T, 128>(a, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Plain C entry point (bound with ctypes).  dtype 0 = float32, 1 = bfloat16.
// Strides are in elements; the last axis of q, k, v is contiguous and the
// output is a contiguous (B, Sq, H, D).  Returns cudaGetLastError().
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, long long qsb,
    long long qss, long long qsh, long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh, int B, int Sq, int Sk, int H,
    int KVH, int D, int dtype, int causal, int window, int q_offset,
    float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || KVH < 1 || H % KVH != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q,   k,   v,   o,  qsb, qss, qsh,    ksb,    kss,      ksh,  vsb,
               vss, vsh, B,   Sq, Sk,  H,   KVH,    causal, window,   q_offset,
               scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (D == 64 || D == 128) && rows_aligned(a))
    return D == 64 ? launch_mma<64>(a, st) : launch_mma<128>(a, st);
  return dtype == 1 ? launch_dim<__nv_bfloat16>(a, D, st)
                    : launch_dim<float>(a, D, st);
}
