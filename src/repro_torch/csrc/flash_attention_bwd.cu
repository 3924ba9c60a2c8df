// Blockwise attention, backward (causal / sliding window, GQA).
//
// Replaces no TPU kernel: it is the reference's custom VJP of its flash
// attention, `_flash_bwd` in repro/layers/attention.py, which the reference
// runs in XLA.  It is written by hand because its forward,
// flash_attention.cu, is.  From the forward's saved q, k, v, out and
// lse = m + log(max(l, 1e-30)) (float32 (B, Sq, H), which the forward
// writes) and the output's gradient dout:
//   delta = rowsum(dout * out)                     (delta pass)
//   qf = q * scale (float32, unrounded), p = exp(qf . k^T - lse) with the
//        masked logits at -1e30 (causal: k <= q + q_offset; window:
//        k > q + q_offset - window; keys past Sk take no part)
//   dp = dout . v^T;  ds = p * (dp - delta)
//   dk = ds^T . qf;  dv = p^T . dout               (dk/dv kernel)
//   dq = ds . k * scale                            (dq kernel)
// q, out, dout are (B, Sq, H, D), k and v (B, Sk, KVH, D), read through
// their strides (last axis contiguous; head h reads KV head h / (H / KVH)
// in place); dq, dk, dv are written contiguous in the inputs' type.
//
// What bounds it on an H100: operations.  At a qwen3-4b training layer
// (B 1, H 32, KVH 8, S 4096, D 128, causal) the five products of the
// gradient take 5 x 2 x 8.39 M pairs x 128 x 32 = 343.7 GFLOP against ~100
// MB of inputs and outputs: 0.3475 ms at the bf16 tensor cores' 989
// TFLOP/s.  Both forms are deterministic and free of atomics: the dk/dv
// kernel runs one CTA per (key tile, KV head, batch, head split), the key
// tile's K and V held while it walks its share of the group's query heads
// (heads split, split + n_split, ...) and the q tiles that reach the key
// tile; the dq kernel one CTA per (q tile, head, batch), walking the key
// tiles the q tile reaches.  Fusing dq into the dk/dv pass would take
// atomics or float32 dq partials per key tile (4.3 GB at qwen3-4b's
// layer), so the logits are formed in both: 7 products for 5.  Where
// (key tile, KV head, batch) CTAs fill fewer than two waves of the card's
// SMs (MQA: one KV head) the wrapper splits the heads (dkdv_splits), each
// split writes float32 partials and dkdv_sum_kernel adds them in split
// order and rounds once: a KV head's query heads sum in float32 either
// way.  Both visit only tiles inside tiles::tile_range (flash_tiles.cuh),
// outside of which every p is exactly 0.  Two forms:
//  * the tensor-core form (bf16, D 64, 112, 128 or 256, q, k, v, out and
//    dout rows 16-byte aligned: every tensor the model passes;
//    delta_lse_kernel, dkdv_wgmma_kernel, dq_wgmma_kernel): the products
//    on wgmma with float32 sums, p and ds rounded to bf16 for the three
//    gradient products, as FlashAttention-2/3 and SDPA's backward do (the
//    reference's einsums on its TPU multiply float32 operands in one bf16
//    pass; q k^T and dout v^T take their bf16 inputs exactly).  Two
//    warpgroups a CTA; thread 0 issues TMA copies of 128-byte-swizzled
//    tiles (64-column boxes; at D 112 the boxes of D 128, TMA zero-filling
//    columns 112-127, of which none is stored) and bulk copies of lse and
//    delta, which the delta pass lays out per head ([B][H][Sq rounded up
//    to 128]), into a two-stage ring guarded by full/empty mbarriers, so
//    the next tile is in flight while the tensor cores work on this one.
//    The dk/dv kernel forms S^T = K Q^T and dP^T = V dout^T (both operands
//    in shared memory), so its accumulator rows are keys and P^T, dS^T
//    land in registers as the A operand of dv += P^T dout and dk += dS^T q
//    (dout and q MN-major); dk is scaled once at the end.  The dq kernel
//    forms S = Q K^T and dP = dout V^T and adds dq += dS K (K MN-major).
//    Up to D 128 each warpgroup owns 64 rows of every column (at D 128
//    192 float32 registers a thread of accumulators and logits: 64 x 128
//    of dk and of dv, 64 x 64 of S^T and of dP^T); at D 256 64 x 256 of dk
//    and dv would be 256 registers a thread, so the two warpgroups split
//    the columns, each forms half of the logits' columns, and the halves
//    meet in shared memory as bf16, the A operand of the products.  The
//    plan (tiles, stages, shared memory, registers) is tiles::tc_bwd_* in
//    flash_tiles.cuh;
//  * the FMA form (float32, D 16, unaligned rows; delta_kernel,
//    dkdv_kernel, dq_kernel) keeps p and ds in float32 as the reference
//    does and runs every product on the float32 FMA units (67 TFLOP/s; a
//    floor of ~7 ms at qwen3-4b's layer): tiles kB x kB (64, or 32 past
//    head_dim 128 where four float32 tiles of 64 rows would need 272 KB of
//    shared memory), 256 threads as 16 x 16, each holding a kB/16 x kB/16
//    block of the logits and kB/16 rows x D/16 columns of its
//    accumulators.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16: tx owns columns, ty rows
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;  // (B, Sq, H)
  float* delta;      // (B, Sq, H), written by delta_kernel
  void* dq;
  void* dk;
  void* dv;
  float* part;  // n_split > 1: float32 dk then dv partials, [2][n_split][B
                // Sk KVH D]
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, oss, osh, dsb,
      dss, dsh;  // element strides
  int B, Sq, Sk, H, KVH, causal, window, q_offset, n_split;
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

// the tiles of a head width: kB q rows and kB keys; shared-memory rows of
// D + 4 floats (and kB + 4 for p and ds) keep 16-byte loads of
// neighbouring rows on distinct banks
template <int D>
struct Tile {
  static constexpr int kB = D > 128 ? 32 : 64;
  static constexpr int kR = kB / 16;  // logit rows (and columns) a thread
  static constexpr int kCols = D / 16;  // accumulator columns a thread
  static constexpr int kRow = D + 4;
  static constexpr int kPRow = kB + 4;
  static constexpr size_t kBytesKV =  // dkdv_kernel: K, V, Q, dO, p^T, ds^T
      sizeof(float) * (4 * kB * kRow + 2 * kB * kPRow + 2 * kB);
  static constexpr size_t kBytesQ =  // dq_kernel: Q, dO, K, V, ds
      sizeof(float) * (4 * kB * kRow + kB * kPRow + 2 * kB);
  static_assert(kBytesKV <= 227 * 1024, "tiles exceed shared memory");
};

// the accumulator column c of thread tx: 4-wide groups where D is a
// multiple of 64, else strided by 16
template <int D>
__device__ __forceinline__ int out_col(int c, int tx) {
  return D % 64 == 0 ? (c / 4) * 64 + tx * 4 + (c % 4) : c * 16 + tx;
}

template <int D>
__device__ __forceinline__ void load_cols(float (&v)[D / 16], const float* row,
                                          int tx) {
  if constexpr (D % 64 == 0) {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(&row[g * 64 + tx * 4]);
      v[4 * g] = t.x;
      v[4 * g + 1] = t.y;
      v[4 * g + 2] = t.z;
      v[4 * g + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int c = 0; c < D / 16; ++c) v[c] = row[c * 16 + tx];
  }
}

__device__ __forceinline__ float lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// rows r0 .. r0 + kB of one head of a (B, S, heads, D) tensor (src at the
// head's first row, rows ss apart) into dst [kB][kRow] as float32 times
// mul; rows past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          long long ss, int r0, int S,
                                          float mul) {
  using L = Tile<D>;
  for (int e = threadIdx.x; e < L::kB * D; e += kThreads) {
    const int r = e / D, d = e % D, s = r0 + r;
    dst[r * L::kRow + d] = s < S ? to_f32(src[s * ss + d]) * mul : 0.f;
  }
}

// acc[i][j] = A[ty + 16 i] . Bm[tx + 16 j] over D (both [kB][kRow])
template <int D>
__device__ __forceinline__ void rows_dot(float (&acc)[Tile<D>::kR][Tile<D>::kR],
                                         const float* A, const float* Bm,
                                         int tx, int ty) {
  using L = Tile<D>;
#pragma unroll
  for (int i = 0; i < L::kR; ++i)
#pragma unroll
    for (int j = 0; j < L::kR; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[L::kR], bv[L::kR];
#pragma unroll
    for (int i = 0; i < L::kR; ++i)
      av[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * L::kRow + d]);
#pragma unroll
    for (int j = 0; j < L::kR; ++j)
      bv[j] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * j) * L::kRow + d]);
#pragma unroll
    for (int i = 0; i < L::kR; ++i)
#pragma unroll
      for (int j = 0; j < L::kR; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// p and ds of the thread's logits: s = qf . k^T and dp = dout . v^T for the
// rows q0 + ty + 16 i (lse and delta in Ls, Es) and keys k0 + tx + 16 j;
// zero for a row past Sq or a key past Sk
template <int D>
__device__ __forceinline__ void grad_logits(
    float (&s)[Tile<D>::kR][Tile<D>::kR], float (&dp)[Tile<D>::kR][Tile<D>::kR],
    const float* Ls, const float* Es, const tiles::Mask& mk, int q0, int k0,
    int tx, int ty) {
  using L = Tile<D>;
#pragma unroll
  for (int i = 0; i < L::kR; ++i) {
    const int r = ty + 16 * i, qrow = q0 + r;
    const float lse = Ls[r], delta = Es[r];
#pragma unroll
    for (int j = 0; j < L::kR; ++j) {
      const int key = k0 + tx + 16 * j;
      float p = 0.f, ds = 0.f;
      if (qrow < mk.Sq && key < mk.Sk) {
        const float logit =
            tiles::attends(mk, qrow + mk.q_offset, key) ? s[i][j] : kNegInf;
        p = expf(logit - lse);
        ds = p * (dp[i][j] - delta);
      }
      s[i][j] = p;
      dp[i][j] = ds;
    }
  }
}

// lse and delta of the rows q0 .. q0 + kB of head h into Ls, Es
template <int D>
__device__ __forceinline__ void load_rows(float* Ls, float* Es, const Args& a,
                                          int b, int h, int q0) {
  for (int r = threadIdx.x; r < Tile<D>::kB; r += kThreads) {
    const int s = q0 + r;
    const size_t idx = (static_cast<size_t>(b) * a.Sq + s) * a.H + h;
    Ls[r] = s < a.Sq ? a.lse[idx] : 0.f;
    Es[r] = s < a.Sq ? a.delta[idx] : 0.f;
  }
}

// delta = rowsum(dout * out) in float32: one thread a row (b, s, h), its
// products summed in rows_dot's order (fmaf over d ascending), so that
// where out equals one row of v (a query that attends a single key) the
// FMA form's dp and delta are the same bits and ds is exactly 0, as in the
// plain version.  The tensor-core form's dp sums in another order, so
// there such a row's ds is rounding noise, which the checks' floor of a
// gradient row (2^-12 of the tensor's largest, ROADMAP F12) covers
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(Args a, int D) {
  const long long row =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= static_cast<long long>(a.B) * a.Sq * a.H) return;
  const int h = static_cast<int>(row % a.H);
  const long long bs = row / a.H;
  const int s = static_cast<int>(bs % a.Sq), b = static_cast<int>(bs / a.Sq);
  const T* o = static_cast<const T*>(a.o) + b * a.osb + s * a.oss + h * a.osh;
  const T* d =
      static_cast<const T*>(a.dout) + b * a.dsb + s * a.dss + h * a.dsh;
  float acc = 0.f;
  for (int i = 0; i < D; ++i) acc = fmaf(to_f32(d[i]), to_f32(o[i]), acc);
  a.delta[row] = acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dkdv_kernel(Args a) {
  using L = Tile<D>;
  constexpr int kB = L::kB, kR = L::kR, kCols = L::kCols;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [kB][kRow]
  float* Vs = Ks + kB * L::kRow;
  float* Qs = Vs + kB * L::kRow;  // q * scale
  float* Ds = Qs + kB * L::kRow;  // dout
  float* Pt = Ds + kB * L::kRow;  // [kB keys][kPRow]: p transposed
  float* St = Pt + kB * L::kPRow;  // ds transposed
  float* Ls = St + kB * L::kPRow;  // [kB] lse of the q tile's rows
  float* Es = Ls + kB;             // [kB] delta

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // KV heads fastest, key tiles slowest: under a causal mask the first key
  // tiles, which every later q tile reaches, start first
  const int kvh = blockIdx.x % a.KVH;
  int rest = blockIdx.x / a.KVH;
  const int split = rest % a.n_split;
  rest /= a.n_split;
  const int b = rest % a.B, kt = rest / a.B, k0 = kt * kB;
  const int G = a.H / a.KVH;
  const tiles::Mask mk{a.Sq, a.Sk, a.causal, a.window, a.q_offset};

  load_tile<T, D>(Ks, static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh,
                  a.kss, k0, a.Sk, 1.f);
  load_tile<T, D>(Vs, static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh,
                  a.vss, k0, a.Sk, 1.f);

  float dk[kR][kCols], dv[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (a.Sq + kB - 1) / kB;
  for (int g = split; g < G; g += a.n_split) {
    const int h = kvh * G + g;
    const T* q = static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh;
    const T* dout = static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kB;
      int kt0, kt1;
      tiles::tile_range(mk, q0, kB, kB, &kt0, &kt1);
      if (kt < kt0 || kt >= kt1) continue;  // every p of the pair is 0
      __syncthreads();  // the last pair's reads of Qs, Ds, Pt, St are done
      load_tile<T, D>(Qs, q, a.qss, q0, a.Sq, a.scale);
      load_tile<T, D>(Ds, dout, a.dss, q0, a.Sq, 1.f);
      load_rows<D>(Ls, Es, a, b, h, q0);
      __syncthreads();

      float s[kR][kR], dp[kR][kR];
      rows_dot<D>(s, Qs, Ks, tx, ty);
      rows_dot<D>(dp, Ds, Vs, tx, ty);
      grad_logits<D>(s, dp, Ls, Es, mk, q0, k0, tx, ty);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kR; ++j) {
          Pt[(tx + 16 * j) * L::kPRow + ty + 16 * i] = s[i][j];
          St[(tx + 16 * j) * L::kPRow + ty + 16 * i] = dp[i][j];
        }
      __syncthreads();

      // dv[key] += sum_r p[r][key] dout[r];  dk[key] += sum_r ds[r][key] qf[r]
#pragma unroll 2
      for (int rr = 0; rr < kB; rr += 4) {
        float4 p4[kR], s4[kR];
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          p4[i] = *reinterpret_cast<const float4*>(&Pt[(ty + 16 * i) * L::kPRow + rr]);
          s4[i] = *reinterpret_cast<const float4*>(&St[(ty + 16 * i) * L::kPRow + rr]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float dov[kCols], qv[kCols];
          load_cols<D>(dov, Ds + (rr + e) * L::kRow, tx);
          load_cols<D>(qv, Qs + (rr + e) * L::kRow, tx);
#pragma unroll
          for (int i = 0; i < kR; ++i) {
            const float pe = lane(p4[i], e), se = lane(s4[i], e);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              dv[i][c] = fmaf(pe, dov[c], dv[i][c]);
              dk[i][c] = fmaf(se, qv[c], dk[i][c]);
            }
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
  const size_t n = static_cast<size_t>(a.B) * a.Sk * a.KVH * D;
  float* pk = a.part + split * n;  // this split's partials (n_split > 1)
  float* pv = a.part + (a.n_split + split) * n;
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= a.Sk) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sk + key) * a.KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = out_col<D>(c, tx);
      if (a.n_split == 1) {
        dkp[base + col] = from_f32<T>(dk[i][c]);
        dvp[base + col] = from_f32<T>(dv[i][c]);
      } else {
        pk[base + col] = dk[i][c];
        pv[base + col] = dv[i][c];
      }
    }
  }
}

// dk and dv from the n_split float32 partials, added in split order and
// rounded once: one thread an element
template <typename T>
__global__ void __launch_bounds__(kThreads) dkdv_sum_kernel(Args a, long long n) {
  const long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (e >= n) return;
  float dk = 0.f, dv = 0.f;
  for (int s = 0; s < a.n_split; ++s) {
    dk += a.part[s * n + e];
    dv += a.part[(a.n_split + s) * n + e];
  }
  static_cast<T*>(a.dk)[e] = from_f32<T>(dk);
  static_cast<T*>(a.dv)[e] = from_f32<T>(dv);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1) dq_kernel(Args a) {
  using L = Tile<D>;
  constexpr int kB = L::kB, kR = L::kR, kCols = L::kCols;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // q * scale, [kB][kRow]
  float* Ds = Qs + kB * L::kRow;                // dout
  float* Ks = Ds + kB * L::kRow;
  float* Vs = Ks + kB * L::kRow;
  float* Ss = Vs + kB * L::kRow;  // [kB rows][kPRow]: ds
  float* Ls = Ss + kB * L::kPRow;
  float* Es = Ls + kB;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  // heads fastest; under a causal mask the last (longest) q tiles first
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % a.B;
  const int n_qt = (a.Sq + kB - 1) / kB;
  int qt = rest / a.B;
  if (a.causal) qt = n_qt - 1 - qt;
  const int q0 = qt * kB, kvh = h / (a.H / a.KVH);
  const tiles::Mask mk{a.Sq, a.Sk, a.causal, a.window, a.q_offset};

  load_tile<T, D>(Qs, static_cast<const T*>(a.q) + b * a.qsb + h * a.qsh,
                  a.qss, q0, a.Sq, a.scale);
  load_tile<T, D>(Ds, static_cast<const T*>(a.dout) + b * a.dsb + h * a.dsh,
                  a.dss, q0, a.Sq, 1.f);
  load_rows<D>(Ls, Es, a, b, h, q0);
  const T* kp = static_cast<const T*>(a.k) + b * a.ksb + kvh * a.ksh;
  const T* vp = static_cast<const T*>(a.v) + b * a.vsb + kvh * a.vsh;

  float dq[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dq[i][c] = 0.f;

  int kt0, kt1;
  tiles::tile_range(mk, q0, kB, kB, &kt0, &kt1);
  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kB;
    __syncthreads();  // the q tile is staged; the last step's reads are done
    load_tile<T, D>(Ks, kp, a.kss, k0, a.Sk, 1.f);
    load_tile<T, D>(Vs, vp, a.vss, k0, a.Sk, 1.f);
    __syncthreads();

    float s[kR][kR], dp[kR][kR];
    rows_dot<D>(s, Qs, Ks, tx, ty);
    rows_dot<D>(dp, Ds, Vs, tx, ty);
    grad_logits<D>(s, dp, Ls, Es, mk, q0, k0, tx, ty);
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kR; ++j)
        Ss[(ty + 16 * i) * L::kPRow + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // dq[r] += sum_key ds[r][key] k[key]
#pragma unroll 2
    for (int kk = 0; kk < kB; kk += 4) {
      float4 s4[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        s4[i] = *reinterpret_cast<const float4*>(&Ss[(ty + 16 * i) * L::kPRow + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float kv[kCols];
        load_cols<D>(kv, Ks + (kk + e) * L::kRow, tx);
#pragma unroll
        for (int i = 0; i < kR; ++i) {
          const float se = lane(s4[i], e);
#pragma unroll
          for (int c = 0; c < kCols; ++c) dq[i][c] = fmaf(se, kv[c], dq[i][c]);
        }
      }
    }
  }

  T* dqp = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int s = q0 + ty + 16 * i;
    if (s >= a.Sq) continue;
    const size_t base = ((static_cast<size_t>(b) * a.Sq + s) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dqp[base + out_col<D>(c, tx)] = from_f32<T>(dq[i][c] * a.scale);
  }
}

template <typename T, int D>
int launch(const Args& a, cudaStream_t st) {
  using L = Tile<D>;
  const long long rows = static_cast<long long>(a.B) * a.Sq * a.H;
  delta_kernel<T><<<static_cast<unsigned>((rows + kThreads - 1) / kThreads),
                    kThreads, 0, st>>>(a, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kBytesKV));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_kt = (a.Sk + L::kB - 1) / L::kB;
  dkdv_kernel<T, D><<<static_cast<unsigned>(n_kt * a.KVH * a.B * a.n_split),
                      kThreads, L::kBytesKV, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (a.n_split > 1) {
    const long long n = static_cast<long long>(a.B) * a.Sk * a.KVH * D;
    dkdv_sum_kernel<T><<<static_cast<unsigned>((n + kThreads - 1) / kThreads),
                         kThreads, 0, st>>>(a, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(L::kBytesQ));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qt = (a.Sq + L::kB - 1) / L::kB;
  dq_kernel<T, D><<<static_cast<unsigned>(n_qt * a.H * a.B), kThreads,
                    L::kBytesQ, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(const Args& a, int D, cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(a, st);
    case 64: return launch<T, 64>(a, st);
    case 112: return launch<T, 112>(a, st);
    case 128: return launch<T, 128>(a, st);
    case 256: return launch<T, 256>(a, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---- the tensor-core form (bf16, D 64, 112, 128 or 256; q, k, v, out and
// dout rows 16-byte aligned) ----

namespace tc {

using namespace hopper;

constexpr int kConsumers = 2;  // warpgroups
constexpr int kTcThreads = 128 * kConsumers;
constexpr int kStages = tiles::kTcBwdStages;
constexpr float kLog2e = 1.4426950408889634f;
static_assert(kBox == tiles::kTcBox, "a TMA box is the plan's 64 columns");

template <int D>
struct Plan {
  static_assert(tiles::tc_bwd_width_ok(D), "not a tensor-core head width");
  static constexpr int kDp = tiles::tc_padded(D);  // the width boxes run at
  static constexpr int kCB = kDp / kBox;  // column blocks of a row
  static constexpr bool kSplit = tiles::tc_bwd_split(D);
  static constexpr int kAcc = tiles::tc_bwd_acc_cols(D);  // a warpgroup's
  // the dk/dv kernel: keys a CTA, q rows a step, logit columns a warpgroup
  static constexpr int kKeys = tiles::tc_bwd_kv_keys(D);
  static constexpr int kRows = tiles::tc_bwd_kv_rows(D);
  static constexpr int kKvN = tiles::tc_bwd_logit_cols(D, kRows);
  // the dq kernel: q rows a CTA, keys a step, logit columns a warpgroup
  static constexpr int kQRows = tiles::tc_bwd_q_rows(D);
  static constexpr int kQKeys = tiles::tc_bwd_q_keys(D);
  static constexpr int kQN = tiles::tc_bwd_logit_cols(D, kQKeys);
  static_assert(kAcc + kKvN == tiles::tc_bwd_kv_regs(D) &&
                    kAcc / 2 + kQN == tiles::tc_bwd_q_regs(D),
                "registers: the plan's count");
  // delta_lse_kernel: threads a row, each summing 16-byte chunks
  static constexpr int kGroup = D / 8 > 16 ? 32 : D / 8 > 8 ? 16 : 8;
};

struct Params {
  void* dq;
  void* dk;
  void* dv;
  float* part;     // n_split > 1: float32 dk then dv partials
  float* lse_t;    // [B][H][Sqp]: lse, zero past Sq
  float* delta_t;  // [B][H][Sqp]: delta, zero past Sq
  int B, Sq, Sk, H, KVH, causal, window, q_offset, n_split, Sqp;
  float scale;
  int q_pos[3], k_pos[3], v_pos[3], d_pos[3];  // map coordinate of (h, s, b)
};

// delta = rowsum(dout * out) in float32, and the forward's lse, into
// [B][H][Sqp] (zero past Sq), where a stage's bulk copy reads a q tile's
// rows of one head at once: kGroup threads a row (b, h, s), s fastest,
// each summing 16-byte chunks, the group's sums added by shuffles
template <int D>
__global__ void __launch_bounds__(kThreads) delta_lse_kernel(Args a,
                                                             Params p) {
  constexpr int kChunks = D / 8, kG = Plan<D>::kGroup;
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long row = t / kG;
  const int j = static_cast<int>(t % kG);
  const bool valid = row < static_cast<long long>(p.B) * p.H * p.Sqp;
  const int s = static_cast<int>(row % p.Sqp);
  const long long bh = row / p.Sqp;
  const int h = static_cast<int>(bh % p.H), b = static_cast<int>(bh / p.H);
  const bool in = valid && s < p.Sq;
  float acc = 0.f;
  if (in) {
    const __nv_bfloat16* o = static_cast<const __nv_bfloat16*>(a.o) +
                             b * a.osb + s * a.oss + h * a.osh;
    const __nv_bfloat16* d = static_cast<const __nv_bfloat16*>(a.dout) +
                             b * a.dsb + s * a.dss + h * a.dsh;
    for (int c = j; c < kChunks; c += kG) {
      const uint4 x = *reinterpret_cast<const uint4*>(o + 8 * c);
      const uint4 y = *reinterpret_cast<const uint4*>(d + 8 * c);
      const __nv_bfloat162* xo = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* yd = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 fo = __bfloat1622float2(xo[e]);
        const float2 fd = __bfloat1622float2(yd[e]);
        acc = fmaf(fd.x, fo.x, acc);
        acc = fmaf(fd.y, fo.y, acc);
      }
    }
  }
#pragma unroll
  for (int off = kG / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (valid && j == 0) {
    p.delta_t[row] = acc;
    p.lse_t[row] =
        in ? a.lse[(static_cast<size_t>(b) * p.Sq + s) * p.H + h] : 0.f;
  }
}

// p of one logit s (q . k, unscaled): exp(s scale - lse) at an attended
// pair (sl2 = scale log2(e)); at a masked pair inside Sq x Sk the
// reference's exp(-1e30 - lse), 1 in a row that attends no key (lse =
// -1e30) and 0 elsewhere; 0 past Sq or Sk.  `masked` is false only where
// every pair of the tile is attended
__device__ __forceinline__ float grad_p(float s, float sl2, float lse,
                                        bool masked, const tiles::Mask& mk,
                                        int qrow, int key) {
  if (masked) {
    if (qrow >= mk.Sq || key >= mk.Sk) return 0.f;
    if (!tiles::attends(mk, qrow + mk.q_offset, key))
      return lse == kNegInf ? 1.f : 0.f;
  }
  return exp2f(fmaf(s, sl2, -lse * kLog2e));
}

// advance (g, qt) to the first (query head, q tile) pair at or after it,
// heads `step` apart, whose q tile of `rows` reaches key tile kt of `keys`
// (tiles::tile_range); false past the last
__device__ __forceinline__ bool seek(int& g, int& qt, int G, int step,
                                     int n_qt, const tiles::Mask& mk, int kt,
                                     int rows, int keys) {
  for (; g < G; g += step, qt = 0)
    for (; qt < n_qt; ++qt) {
      int kt0, kt1;
      tiles::tile_range(mk, qt * rows, rows, keys, &kt0, &kt1);
      if (kt >= kt0 && kt < kt1) return true;
    }
  return false;
}

// a 64-row fragment of kN columns (the accumulator layout) as the register
// A operand, bf16, of kN / 16 k-steps
template <int kN>
__device__ __forceinline__ void to_a(uint32_t (&a)[kN / 16][4],
                                     const float (&d)[kN / 2]) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    a[j / 2][(j % 2) * 2] = pack_bf16(d[4 * j], d[4 * j + 1]);
    a[j / 2][(j % 2) * 2 + 1] = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// a warpgroup's 64-row fragment of kN columns (rows r, r + 8 a thread)
// into columns c0 .. c0 + kN of a [64][64] bf16 tile in the 128-byte
// swizzle: the K-major A operand of the products
template <int kN>
__device__ __forceinline__ void to_smem(uint8_t* tile, const float (&d)[kN / 2],
                                        int r, int c0, int t4) {
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int c = c0 + 8 * j + 2 * t4;
    *swizzled(tile, r, c) = pack_bf16(d[4 * j], d[4 * j + 1]);
    *swizzled(tile, r + 8, c) = pack_bf16(d[4 * j + 2], d[4 * j + 3]);
  }
}

// k-step kk (16 columns) of a K-major operand: 64 rows from row r0 of a
// tile of `rows` rows
__device__ __forceinline__ uint64_t kdesc(const uint8_t* tile, int rows,
                                          int r0, int kk) {
  return make_desc(tile + (kk / 4) * rows * 128 + r0 * 128 + (kk % 4) * 32,
                   16, 1024);
}
// k-step kk (rows 16 kk ..) of an MN-major operand from column block cb
// on, of a tile of `rows` rows
__device__ __forceinline__ uint64_t mdesc(const uint8_t* tile, int rows,
                                          int cb, int kk) {
  return make_desc(tile + cb * rows * 128 + kk * 16 * 128, rows * 128, 1024);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do, Params a) {
  using P = Plan<D>;
  constexpr int kKeys = P::kKeys, kRows = P::kRows, kN = P::kKvN;
  constexpr int kAcc = P::kAcc, kCB = P::kCB;
  constexpr int kKV = kKeys * P::kDp * 2;  // bytes of K (or V)
  constexpr int kQT = kRows * P::kDp * 2;  // bytes of a Q (or dout) stage
  static_assert(2 * kKV + kStages * (2 * kQT + 2 * kRows * 4) +
                        (P::kSplit ? 2 * 64 * 128 : 0) + 1024 ==
                    tiles::tc_bwd_kv_smem(D),
                "layout: the plan's shared memory");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_kv, bar_full[kStages],
      bar_empty[kStages];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + kKV;
  uint8_t* Qs = Vs + kKV;  // [kStages]
  uint8_t* Ds = Qs + kStages * kQT;  // dout, [kStages]
  uint8_t* Pt = Ds + kStages * kQT;  // split: P^T, [64 keys][64 rows] bf16
  uint8_t* St = Pt + 64 * 128;  // split: dS^T
  float* Ls = reinterpret_cast<float*>(P::kSplit ? St + 64 * 128 : Pt);
  float* Es = Ls + kStages * kRows;  // [kStages][kRows] lse, then delta

  // KV heads fastest, key tiles slowest: under a causal mask the first key
  // tiles, which every later q tile reaches, start first
  const int kvh = blockIdx.x % a.KVH;
  int rest = blockIdx.x / a.KVH;
  const int split = rest % a.n_split;
  rest /= a.n_split;
  const int b = rest % a.B, kt = rest / a.B, k0 = kt * kKeys;
  const int G = a.H / a.KVH, n_qt = (a.Sq + kRows - 1) / kRows;
  const tiles::Mask mk{a.Sq, a.Sk, a.causal, a.window, a.q_offset};

  if (threadIdx.x == 0) {
    mbar_init(&bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kTcThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0 feeds the ring: K and V once, then the Q, dout, lse and delta
  // of each (head, q tile) pair as soon as both warpgroups are done with
  // the stage it reuses
  auto load_pair = [&](int i, int g, int qt) {
    const int s = i % kStages, h = kvh * G + g, q0 = qt * kRows;
    int c[4];
    mbar_expect_tx(&bar_full[s], 2 * kQT + 2 * kRows * 4);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.q_pos, cb * kBox, h, q0, b);
      tma_load(Qs + s * kQT + cb * kRows * 128, &tm_q, c, &bar_full[s]);
      coords(c, a.d_pos, cb * kBox, h, q0, b);
      tma_load(Ds + s * kQT + cb * kRows * 128, &tm_do, c, &bar_full[s]);
    }
    const size_t row = (static_cast<size_t>(b) * a.H + h) * a.Sqp + q0;
    bulk_load(Ls + s * kRows, a.lse_t + row, kRows * 4, &bar_full[s]);
    bulk_load(Es + s * kRows, a.delta_t + row, kRows * 4, &bar_full[s]);
  };
  int pg = split, pqt = 0, issued = 0;  // thread 0: the next pair to load
  if (threadIdx.x == 0) {
    int c[4];
    mbar_expect_tx(&bar_kv, 2 * kKV);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.k_pos, cb * kBox, kvh, k0, b);
      tma_load(Ks + cb * kKeys * 128, &tm_k, c, &bar_kv);
      coords(c, a.v_pos, cb * kBox, kvh, k0, b);
      tma_load(Vs + cb * kKeys * 128, &tm_v, c, &bar_kv);
    }
    for (; issued < kStages &&
           seek(pg, pqt, G, a.n_split, n_qt, mk, kt, kRows, kKeys);
         ++issued, ++pqt)
      load_pair(issued, pg, pqt);
  }

  // ---- warpgroup wg: keys kr0 .. kr0 + 64 of the tile (at D 256 all 64,
  // and columns kAcc wg .. of dk, dv); logit columns c0 .. c0 + kN ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g8 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int kr0 = P::kSplit ? 0 : 64 * wg;
  const int c0 = P::kSplit ? kN * wg : 0;
  const int r = warp * 16 + g8;  // this thread's rows r, r + 8 of the 64
  const int key0 = k0 + kr0 + r, key1 = key0 + 8;
  const float sl2 = a.scale * kLog2e;

  float dk[kAcc / 2], dv[kAcc / 2];
#pragma unroll
  for (int i = 0; i < kAcc / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(&bar_kv, 0);
  int cg = split, cqt = 0;
  for (int i = 0; seek(cg, cqt, G, a.n_split, n_qt, mk, kt, kRows, kKeys);
       ++i, ++cqt) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int q0 = cqt * kRows;
    const uint8_t* Qt = Qs + s * kQT;
    const uint8_t* Dt = Ds + s * kQT;
    const float* Lt = Ls + s * kRows;
    const float* Et = Es + s * kRows;

    // S^T = K Q^T and dP^T = V dout^T: 64 keys x kN q rows, D / 16
    // k-steps (the padded columns are never read)
    float st[kN / 2], dpt[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) st[j] = dpt[j] = 0.f;  // scale_d 0
    mbar_wait(&bar_full[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(st, kdesc(Ks, kKeys, kr0, kk), kdesc(Qt, kRows, c0, kk),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(dpt, kdesc(Vs, kKeys, kr0, kk), kdesc(Dt, kRows, c0, kk),
                   kk > 0);
    wgmma_commit();

    // p (lse per column), then ds = p (dp - delta); the mask only on the
    // tiles that need it, rows past Sq taking no part
    const int qc = q0 + c0;
    const bool masked =
        qc + kN > a.Sq || tiles::tile_masked(mk, qc + a.q_offset,
                                              qc + kN - 1 + a.q_offset,
                                              k0 + kr0, 64);
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * j + 2 * t4 + e;
        const float lse = Lt[c];
        st[4 * j + e] =
            grad_p(st[4 * j + e], sl2, lse, masked, mk, q0 + c, key0);
        st[4 * j + 2 + e] =
            grad_p(st[4 * j + 2 + e], sl2, lse, masked, mk, q0 + c, key1);
      }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float delta = Et[c0 + 8 * j + 2 * t4 + e];
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - delta);
        dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * (dpt[4 * j + 2 + e] - delta);
      }

    // dv += P^T dout, dk += dS^T q: k-steps of 16 q rows, dout and q
    // MN-major
    if constexpr (!P::kSplit) {
      uint32_t pa[kN / 16][4], sa[kN / 16][4];
      to_a<kN>(pa, st);
      to_a<kN>(sa, dpt);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<P::kDp>(dv, pa[kk], mdesc(Dt, kRows, 0, kk));
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<P::kDp>(dk, sa[kk], mdesc(Qt, kRows, 0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(sa);
    } else {
      __syncthreads();  // both warpgroups' last products from Pt, St are done
      to_smem<kN>(Pt, st, r, c0, t4);
      to_smem<kN>(St, dpt, r, c0, t4);
      fence_async_smem();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_ss<128, 1>(dv, kdesc(Pt, 64, 0, kk),
                         mdesc(Dt, kRows, 2 * wg, kk), 1);
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk)
        wgmma_ss<128, 1>(dk, kdesc(St, 64, 0, kk),
                         mdesc(Qt, kRows, 2 * wg, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(dv);
    fence_regs(dk);
    mbar_arrive(&bar_empty[s]);
    if (threadIdx.x == 0 &&
        seek(pg, pqt, G, a.n_split, n_qt, mk, kt, kRows, kKeys)) {
      mbar_wait(&bar_empty[s], phase);  // pair `issued` reuses stage s
      load_pair(issued, pg, pqt);
      ++issued;
      ++pqt;
    }
  }

  // dk = (dS^T q) scale, dv: rounded to bf16, or float32 partials of this
  // split; keys past Sk and the padded columns are not stored
  const int col0 = P::kSplit ? kAcc * wg : 0;
  const size_t n = static_cast<size_t>(a.B) * a.Sk * a.KVH * D;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = hf ? key1 : key0;
    if (key >= a.Sk) continue;
    const size_t base =
        ((static_cast<size_t>(b) * a.Sk + key) * a.KVH + kvh) * D;
#pragma unroll
    for (int c = 0; c < kAcc / 8; ++c) {
      const int d = col0 + 8 * c + 2 * t4;
      if (d >= D) continue;
      const float k_lo = dk[4 * c + 2 * hf] * a.scale;
      const float k_hi = dk[4 * c + 2 * hf + 1] * a.scale;
      const float v_lo = dv[4 * c + 2 * hf], v_hi = dv[4 * c + 2 * hf + 1];
      if (a.n_split == 1) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.dk) +
                                           base + d) =
            __floats2bfloat162_rn(k_lo, k_hi);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.dv) +
                                           base + d) =
            __floats2bfloat162_rn(v_lo, v_hi);
      } else {
        *reinterpret_cast<float2*>(a.part + split * n + base + d) =
            make_float2(k_lo, k_hi);
        *reinterpret_cast<float2*>(a.part + (a.n_split + split) * n + base +
                                   d) = make_float2(v_lo, v_hi);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
    dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do, Params a) {
  using P = Plan<D>;
  constexpr int kRows = P::kQRows, kKeys = P::kQKeys, kN = P::kQN;
  constexpr int kAcc = P::kAcc, kCB = P::kCB;
  constexpr int kQT = kRows * P::kDp * 2;  // bytes of Q (or dout)
  constexpr int kKV = kKeys * P::kDp * 2;  // bytes of a K (or V) stage
  static_assert(2 * kQT + 2 * kStages * kKV + (P::kSplit ? 64 * 128 : 0) +
                        1024 ==
                    tiles::tc_bwd_q_smem(D),
                "layout: the plan's shared memory");
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_q, bar_full[kStages],
      bar_empty[kStages];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ds = Qs + kQT;  // dout
  uint8_t* Ks = Ds + kQT;  // [kStages]
  uint8_t* Vs = Ks + kStages * kKV;  // [kStages]
  uint8_t* Ss = Vs + kStages * kKV;  // split: dS, [64 rows][64 keys] bf16

  // heads fastest; under a causal mask the last (longest) q tiles first
  const int h = blockIdx.x % a.H;
  const int rest = blockIdx.x / a.H;
  const int b = rest % a.B;
  const int n_qt = (a.Sq + kRows - 1) / kRows;
  int qt = rest / a.B;
  if (a.causal) qt = n_qt - 1 - qt;
  const int q0 = qt * kRows, kvh = h / (a.H / a.KVH);
  const tiles::Mask mk{a.Sq, a.Sk, a.causal, a.window, a.q_offset};
  int kt0, kt1;
  tiles::tile_range(mk, q0, kRows, kKeys, &kt0, &kt1);
  const int n_kt = kt1 - kt0;

  if (threadIdx.x == 0) {
    mbar_init(&bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&bar_full[s], 1);
      mbar_init(&bar_empty[s], kTcThreads);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0 feeds the ring: Q and dout once, then each key tile's K and V
  // as soon as both warpgroups are done with the stage it reuses
  auto load_kv = [&](int i) {
    const int s = i % kStages, k0 = (kt0 + i) * kKeys;
    int c[4];
    mbar_expect_tx(&bar_full[s], 2 * kKV);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.k_pos, cb * kBox, kvh, k0, b);
      tma_load(Ks + s * kKV + cb * kKeys * 128, &tm_k, c, &bar_full[s]);
      coords(c, a.v_pos, cb * kBox, kvh, k0, b);
      tma_load(Vs + s * kKV + cb * kKeys * 128, &tm_v, c, &bar_full[s]);
    }
  };
  if (threadIdx.x == 0) {
    int c[4];
    mbar_expect_tx(&bar_q, 2 * kQT);
    for (int cb = 0; cb < kCB; ++cb) {
      coords(c, a.q_pos, cb * kBox, h, q0, b);
      tma_load(Qs + cb * kRows * 128, &tm_q, c, &bar_q);
      coords(c, a.d_pos, cb * kBox, h, q0, b);
      tma_load(Ds + cb * kRows * 128, &tm_do, c, &bar_q);
    }
    for (int i = 0; i < kStages && i < n_kt; ++i) load_kv(i);
  }

  // ---- warpgroup wg: q rows rr0 .. rr0 + 64 of the tile (at D 256 all 64,
  // and columns kAcc wg .. of dq); logit columns kc .. kc + kN ----
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32;
  const int g8 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
  const int rr0 = P::kSplit ? 0 : 64 * wg;
  const int kc = P::kSplit ? kN * wg : 0;
  const int r = warp * 16 + g8;  // this thread's rows r, r + 8 of the 64
  const int s0 = q0 + rr0 + r, s1 = s0 + 8;
  const float sl2 = a.scale * kLog2e;
  const size_t lrow = (static_cast<size_t>(b) * a.H + h) * a.Sqp + s0;
  const float lse0 = a.lse_t[lrow], lse1 = a.lse_t[lrow + 8];
  const float dl0 = a.delta_t[lrow], dl1 = a.delta_t[lrow + 8];

  float dq[kAcc / 2];
#pragma unroll
  for (int i = 0; i < kAcc / 2; ++i) dq[i] = 0.f;

  mbar_wait(&bar_q, 0);
  for (int i = 0; i < n_kt; ++i) {
    const int s = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int k0 = (kt0 + i) * kKeys;
    const uint8_t* Kt = Ks + s * kKV;
    const uint8_t* Vt = Vs + s * kKV;

    // S = Q K^T and dP = dout V^T: 64 q rows x kN keys
    float sc[kN / 2], dp[kN / 2];
#pragma unroll
    for (int j = 0; j < kN / 2; ++j) sc[j] = dp[j] = 0.f;  // scale_d 0
    mbar_wait(&bar_full[s], phase);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(sc, kdesc(Qs, kRows, rr0, kk), kdesc(Kt, kKeys, kc, kk),
                   kk > 0);
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<kN>(dp, kdesc(Ds, kRows, rr0, kk), kdesc(Vt, kKeys, kc, kk),
                   kk > 0);
    wgmma_commit();

    // p, then ds = p (dp - delta); rows past Sq are not stored (their p
    // and ds are finite: Q, dout, lse and delta are zero there)
    const int qp_lo = q0 + rr0 + a.q_offset;
    const bool masked = tiles::tile_masked(mk, qp_lo, qp_lo + 63, k0 + kc, kN);
    wgmma_wait<1>();
    fence_regs(sc);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + kc + 8 * j + 2 * t4 + e;
        sc[4 * j + e] = grad_p(sc[4 * j + e], sl2, lse0, masked, mk, s0, key);
        sc[4 * j + 2 + e] =
            grad_p(sc[4 * j + 2 + e], sl2, lse1, masked, mk, s1, key);
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        dp[4 * j + e] = sc[4 * j + e] * (dp[4 * j + e] - dl0);
        dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * (dp[4 * j + 2 + e] - dl1);
      }

    // dq += dS K: k-steps of 16 keys, K MN-major
    if constexpr (!P::kSplit) {
      uint32_t sa[kN / 16][4];
      to_a<kN>(sa, dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)
        wgmma_rs<P::kDp>(dq, sa[kk], mdesc(Kt, kKeys, 0, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sa);
    } else {
      __syncthreads();  // both warpgroups' last products from Ss are done
      to_smem<kN>(Ss, dp, r, kc, t4);
      fence_async_smem();
      __syncthreads();
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk)
        wgmma_ss<128, 1>(dq, kdesc(Ss, 64, 0, kk),
                         mdesc(Kt, kKeys, 2 * wg, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
    }
    fence_regs(dq);
    mbar_arrive(&bar_empty[s]);
    if (threadIdx.x == 0 && i + kStages < n_kt) {
      mbar_wait(&bar_empty[s], phase);
      load_kv(i + kStages);
    }
  }

  // dq = (dS k) scale, rounded to bf16; rows past Sq and the padded
  // columns are not stored
  const int col0 = P::kSplit ? kAcc * wg : 0;
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.dq);
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int srow = hf ? s1 : s0;
    if (srow >= a.Sq) continue;
    const size_t base =
        ((static_cast<size_t>(b) * a.Sq + srow) * a.H + h) * D;
#pragma unroll
    for (int c = 0; c < kAcc / 8; ++c) {
      const int d = col0 + 8 * c + 2 * t4;
      if (d >= D) continue;
      *reinterpret_cast<__nv_bfloat162*>(out + base + d) =
          __floats2bfloat162_rn(dq[4 * c + 2 * hf] * a.scale,
                                dq[4 * c + 2 * hf + 1] * a.scale);
    }
  }
}

// the delta pass, the dk/dv kernel (and the split sum), the dq kernel;
// lse_t and delta_t take the scratch the FMA form's delta takes
template <int D>
int launch(const Args& args, cudaStream_t st) {
  using P = Plan<D>;
  constexpr int kPad = tiles::kTcBwdSeqPad;
  const int Sqp = (args.Sq + kPad - 1) / kPad * kPad;
  const size_t plane = static_cast<size_t>(args.B) * args.H * Sqp;
  Params p{args.dq,     args.dk,     args.dv,       args.part,
           args.delta,  args.delta + plane,         args.B,
           args.Sq,     args.Sk,     args.H,        args.KVH,
           args.causal, args.window, args.q_offset, args.n_split,
           Sqp,         args.scale};
  const long long threads = static_cast<long long>(plane) * P::kGroup;
  delta_lse_kernel<D>
      <<<static_cast<unsigned>((threads + kThreads - 1) / kThreads), kThreads,
         0, st>>>(args, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  CUtensorMap mq, mk, mv, md;
  auto maps = [&](int rows, int keys) {
    return make_map(&mq, p.q_pos, args.q, D, args.H, args.Sq, args.B,
                    args.qsh, args.qss, args.qsb, rows) &&
           make_map(&md, p.d_pos, args.dout, D, args.H, args.Sq, args.B,
                    args.dsh, args.dss, args.dsb, rows) &&
           make_map(&mk, p.k_pos, args.k, D, args.KVH, args.Sk, args.B,
                    args.ksh, args.kss, args.ksb, keys) &&
           make_map(&mv, p.v_pos, args.v, D, args.KVH, args.Sk, args.B,
                    args.vsh, args.vss, args.vsb, keys);
  };
  if (!maps(P::kRows, P::kKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kv_smem = tiles::tc_bwd_kv_smem(D);
  err = cudaFuncSetAttribute(dkdv_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_kt = (args.Sk + P::kKeys - 1) / P::kKeys;
  dkdv_wgmma_kernel<D>
      <<<static_cast<unsigned>(n_kt * args.KVH * args.B * args.n_split),
         kTcThreads, kv_smem, st>>>(mq, mk, mv, md, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (args.n_split > 1) {
    const long long n =
        static_cast<long long>(args.B) * args.Sk * args.KVH * D;
    dkdv_sum_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>((n + kThreads - 1) / kThreads), kThreads, 0,
           st>>>(args, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  if (!maps(P::kQRows, P::kQKeys))
    return static_cast<int>(cudaErrorInvalidValue);
  const int q_smem = tiles::tc_bwd_q_smem(D);
  err = cudaFuncSetAttribute(dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_qt = (args.Sq + P::kQRows - 1) / P::kQRows;
  dq_wgmma_kernel<D><<<static_cast<unsigned>(n_qt * args.H * args.B),
                       kTcThreads, q_smem, st>>>(mq, mk, mv, md, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

// does the tensor-core form take these inputs?  bf16 at a width it is
// built for, every row of q, k, v, out and dout readable by TMA in place
bool tensor_core_form(const Args& a, int D, int dtype) {
  return dtype == 1 && (D == 64 || D == 112 || D == 128 || D == 256) &&
         hopper::rows_aligned(a.q, a.qsb, a.qss, a.qsh) &&
         hopper::rows_aligned(a.k, a.ksb, a.kss, a.ksh) &&
         hopper::rows_aligned(a.v, a.vsb, a.vss, a.vsh) &&
         hopper::rows_aligned(a.o, a.osb, a.oss, a.osh) &&
         hopper::rows_aligned(a.dout, a.dsb, a.dss, a.dsh);
}

}  // namespace

// Plain C entry point (bound with ctypes).  ptrs: q, k, v, out, dout, lse,
// delta (scratch, float32: 2 x B x H x Sq rounded up to
// tiles::kTcBwdSeqPad, of which the FMA form takes (B, Sq, H)), dq, dk, dv,
// part (scratch, float32 2 x n_split x (B, Sk, KVH, D); unused with one
// split).  vals (element strides of the batch, sequence and head axes,
// then sizes and flags): q(3), k(3), v(3), out(3), dout(3), B, Sq, Sk, H,
// KVH, D, dtype (0 float32, 1 bfloat16), causal, window, q_offset, n_split
// (1 .. H / KVH), form (1: the caller expects the tensor-core form, which
// the inputs alone choose; 0: the FMA form).  Three launches on `stream`
// (four with n_split > 1); returns the first launch error
// (cudaGetLastError()), or cudaErrorInvalidValue for sizes it does not
// take, a form other than the caller's, or a tensor map it cannot make.
extern "C" int flash_attention_bwd_launch(void* const* ptrs,
                                          const long long* vals, float scale,
                                          void* stream) {
  Args a{ptrs[0], ptrs[1], ptrs[2], ptrs[3], ptrs[4],
         static_cast<const float*>(ptrs[5]), static_cast<float*>(ptrs[6]),
         ptrs[7], ptrs[8], ptrs[9], static_cast<float*>(ptrs[10]),
         vals[0], vals[1], vals[2], vals[3], vals[4], vals[5], vals[6],
         vals[7], vals[8], vals[9], vals[10], vals[11], vals[12], vals[13],
         vals[14],
         static_cast<int>(vals[15]), static_cast<int>(vals[16]),
         static_cast<int>(vals[17]), static_cast<int>(vals[18]),
         static_cast<int>(vals[19]), static_cast<int>(vals[22]),
         static_cast<int>(vals[23]), static_cast<int>(vals[24]),
         static_cast<int>(vals[25]), scale};
  const int D = static_cast<int>(vals[20]), dtype = static_cast<int>(vals[21]);
  const bool tc_form = tensor_core_form(a, D, dtype);
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.KVH < 1 || a.H % a.KVH != 0 ||
      a.n_split < 1 || a.n_split > a.H / a.KVH ||
      (a.n_split > 1 && a.part == nullptr) || vals[26] != (tc_form ? 1 : 0))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tc_form) {
    switch (D) {
      case 64: return tc::launch<64>(a, st);
      case 112: return tc::launch<112>(a, st);
      case 128: return tc::launch<128>(a, st);
      default: return tc::launch<256>(a, st);
    }
  }
  return dtype == 1 ? launch_dim<__nv_bfloat16>(a, D, st)
                    : launch_dim<float>(a, D, st);
}
