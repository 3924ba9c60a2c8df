// Blockwise attention, backward (causal / sliding window, GQA).
//
// Replaces no TPU kernel: it is the reference's custom VJP of its flash
// attention, `_flash_bwd` in repro/layers/attention.py, which the reference
// runs in XLA.  It is written by hand because its forward,
// flash_attention.cu, is.  From the forward's saved q, k, v, out and
// lse = m + log(max(l, 1e-30)) (float32 (B, Sq, H), which the forward
// writes) and the output's gradient dout, all in float32:
//   delta = rowsum(dout * out)                     (delta_kernel)
//   qf = q * scale (float32, unrounded), p = exp(qf . k^T - lse) with the
//        masked logits at -1e30 (causal: k <= q + q_offset; window:
//        k > q + q_offset - window; keys past Sk take no part)
//   dp = dout . v^T;  ds = p * (dp - delta)
//   dk = ds^T . qf;  dv = p^T . dout               (dkdv_kernel)
//   dq = ds . k * scale                            (dq_kernel)
// q, out, dout are (B, Sq, H, D), k and v (B, Sk, KVH, D), read through
// their strides (last axis contiguous; head h reads KV head h / (H / KVH)
// in place); dq, dk, dv are written contiguous in the inputs' type.
//
// What bounds it on an H100: operations.  At a qwen3-4b training layer
// (B 1, H 32, KVH 8, S 4096, D 128, causal) the five products of the
// gradient take 5 x 2 x 8.39 M pairs x 128 x 32 = 343.7 GFLOP against ~100
// MB of inputs and outputs: 0.35 ms at the bf16 tensor cores' 989
// TFLOP/s.  This first form runs every product on the float32 FMA units
// (67 TFLOP/s), as the reference keeps p and ds in float32, so its floor
// is ~7 ms (it recomputes q k^T and dout v^T in both kernels: 7 products).
// Deterministic and free of atomics:
//  * dkdv_kernel: one CTA per (key tile, KV head, batch, head split), the
//    key tile's K and V staged once; it walks its share of the group's
//    query heads (heads split, split + n_split, ...) and the q tiles that
//    reach the key tile and accumulates dk and dv in registers.  With one
//    split it rounds them to the output; where (key tile, KV head, batch)
//    CTAs would fill fewer than two waves of the card's SMs (MQA: one KV
//    head) the wrapper splits the heads (dkdv_splits), each split writes
//    float32 partials and dkdv_sum_kernel adds them in split order and rounds
//    once: a KV head's query heads sum in float32 either way;
//  * dq_kernel: one CTA per (q tile, head, batch) walks the key tiles
//    that the q tile reaches and accumulates dq in registers.
// Tiles are kB x kB (64, or 32 past head_dim 128 where four float32 tiles
// of 64 rows would need 272 KB of shared memory), 256 threads as 16 x 16,
// each holding a kB/16 x kB/16 block of the logits and kB/16 rows x D/16
// columns of its accumulators.  Both skip only tiles outside
// tiles::tile_range (flash_tiles.cuh), where every p is exactly 0.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_tiles.cuh"

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
// where out equals one row of v (a query that attends a single key) dp and
// delta are the same bits and ds is exactly 0, as in the plain version
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

}  // namespace

// Plain C entry point (bound with ctypes).  ptrs: q, k, v, out, dout, lse,
// delta (scratch, float32 (B, Sq, H)), dq, dk, dv, part (scratch, float32
// 2 x n_split x (B, Sk, KVH, D); unused with one split).  vals (element
// strides of the batch, sequence and head axes, then sizes and flags):
// q(3), k(3), v(3), out(3), dout(3), B, Sq, Sk, H, KVH, D, dtype (0
// float32, 1 bfloat16), causal, window, q_offset, n_split (1 .. H / KVH).
// Three launches on `stream` (four with n_split > 1); returns the first
// launch error (cudaGetLastError()), or cudaErrorInvalidValue for sizes it
// does not take.
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
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.KVH < 1 || a.H % a.KVH != 0 ||
      a.n_split < 1 || a.n_split > a.H / a.KVH ||
      (a.n_split > 1 && a.part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_dim<__nv_bfloat16>(a, D, st)
                    : launch_dim<float>(a, D, st);
}
