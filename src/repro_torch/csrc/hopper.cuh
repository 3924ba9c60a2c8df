// Hopper building blocks shared by the flash-attention kernels
// (flash_attention.cu, flash_attention_bwd.cu): mbarriers, TMA loads of
// 128-byte-swizzled bf16 tiles through 4-D tensor maps, bulk copies, and
// wgmma in the forms the two kernels use.  Device code only (sm_90a): no
// host test compiles this header.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

namespace hopper {

constexpr int kBox = 64;  // bf16 columns a TMA box: the 128-byte swizzle's span

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// dynamic shared memory rounded up to the 1024-byte alignment of a
// 128-byte swizzle atom (8 rows of 128 bytes)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// spin until the phase of parity `parity` of the barrier has completed; a
// wait that outlasts any tile by orders of magnitude traps (a launch
// error) instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (spins == (1u << 26)) __trap();
  }
}

// one TMA box of the 4-D map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         const int (&c)[4], uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c[0]), "r"(c[1]), "r"(c[2]),
      "r"(c[3]), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global
// into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// the coordinates of column block col of row s of head h, batch b
__device__ __forceinline__ void coords(int (&c)[4], const int (&pos)[3], int col,
                                       int h, int s, int b) {
  c[0] = col;
  c[pos[0]] = h;
  c[pos[1]] = s;
  c[pos[2]] = b;
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets (all in 16-byte units)
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // SWIZZLE_128B
  return d;
}

// the 4 bytes at (row r, even column c) of a tile of 64-column bf16 rows
// in the layout the 128-byte swizzle gives (16-byte chunk c / 8 of row r
// sits at chunk (c / 8) ^ (r % 8)); the tile is 1024-byte aligned
__device__ __forceinline__ uint32_t* swizzled(uint8_t* tile, int r, int c) {
  return reinterpret_cast<uint32_t*>(tile + r * 128 +
                                     ((((c >> 3) ^ r) & 7) << 4) + (c & 7) * 2);
}

// generic-proxy writes to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }

// keep the compiler from moving uses of wgmma operands across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---- wgmma m64nNk16, bf16 in, float32 accumulators ----
//
// The accumulator fragment of a thread (warp w of the warpgroup, lane =
// 4 g + t): d[4 j + e] is (row 16 w + g, column 8 j + 2 t + e), d[4 j + 2
// + e] is (row 16 w + g + 8, the same column), e in {0, 1}.  The register
// A operand of a k-step over columns 16 kk .. 16 kk + 15 of such a
// fragment is {pack(d[8kk], d[8kk+1]), pack(d[8kk+2], d[8kk+3]),
// pack(d[8kk+4], d[8kk+5]), pack(d[8kk+6], d[8kk+7])}.  N columns take N /
// 2 accumulators a thread; d[kOff, kOff + N / 2) of a longer array is
// updated.  B is K-major (kTransB 0: each of its N rows holds K
// contiguous values) or MN-major (kTransB 1: each of its K rows holds N
// contiguous values, in 64-column blocks `lbo` bytes apart).

#define HP_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"
#define HP_R32                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HP_R64                                                               \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define HP_D4(o) "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3])
#define HP_D16(o) HP_D4(o), HP_D4(o + 4), HP_D4(o + 8), HP_D4(o + 12)
#define HP_D32(o) HP_D16(o), HP_D16(o + 16)
#define HP_D64(o) HP_D32(o), HP_D32(o + 32)

// d (+)= A (64 x 16, shared memory, K-major) * B (16 x N, shared memory);
// d is overwritten when scale_d is 0
template <int N, int kTransB = 0, int kOff = 0, int kLen>
__device__ __forceinline__ void wgmma_ss(float (&d)[kLen], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  static_assert(kOff + N / 2 <= kLen, "accumulator slice out of range");
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " HP_R16
        ", %16, %17, p, 1, 1, 0, %19;\n}\n"
        : HP_D16(kOff)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_R32
        ", %32, %33, p, 1, 1, 0, %35;\n}\n"
        : HP_D32(kOff)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  } else {
    static_assert(N == 128, "wgmma_ss: N is 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HP_R64
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : HP_D64(kOff)
        : "l"(desc_a), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
}

// d += A (64 x 16 bf16, registers) * B (16 x N bf16, shared memory,
// MN-major)
template <int N, int kOff = 0, int kLen>
__device__ __forceinline__ void wgmma_rs(float (&d)[kLen], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  static_assert(kOff + N / 2 <= kLen, "accumulator slice out of range");
  if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HP_R32
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : HP_D32(kOff)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  } else {
    static_assert(N == 128, "wgmma_rs: N is 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " HP_R64
        ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : HP_D64(kOff)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
  }
}

#undef HP_R16
#undef HP_R32
#undef HP_R64
#undef HP_D4
#undef HP_D16
#undef HP_D32
#undef HP_D64

// ---- host: tensor maps ----

using EncodeFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver library the process already holds
inline EncodeFn encode_fn() {
  static EncodeFn fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      fn = reinterpret_cast<EncodeFn>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// The 4-D map of a (B, S, heads, D) bf16 tensor with element strides
// (sb, ss, sh): axis 0 is D, axes 1-3 are (heads, S, B) ordered by stride
// (extent-1 axes last), which `pos` records for the kernel's coordinates.
// Boxes of 64 columns x `rows` rows, 128-byte swizzle, zero fill past the
// edges.
inline bool make_map(CUtensorMap* map, int (&pos)[3], const void* ptr, int D,
                     int heads, int S, int B, long long sh, long long ss,
                     long long sb, int rows) {
  const EncodeFn fn = encode_fn();
  if (fn == nullptr) return false;
  long long ext[3] = {heads, S, B}, str[3] = {sh, ss, sb};
  int order[3] = {0, 1, 2};
  auto key = [&](int i) {  // extent-1 axes sort last
    return ext[i] == 1 ? (1LL << 62) : str[i];
  };
  for (int i = 0; i < 3; ++i)
    for (int j = i + 1; j < 3; ++j)
      if (key(order[j]) < key(order[i])) {
        const int t = order[i];
        order[i] = order[j];
        order[j] = t;
      }
  cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), 1, 1, 1};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {kBox, 1, 1, 1};
  long long span = static_cast<long long>(D);  // elements under the axis
  for (int i = 0; i < 3; ++i) {
    const int ax = order[i];
    pos[ax] = i + 1;
    dims[i + 1] = static_cast<cuuint64_t>(ext[ax]);
    long long st = ext[ax] == 1 ? span : str[ax];  // any stride serves
    strides[i] = static_cast<cuuint64_t>(st * 2);
    span = st * ext[ax] > span ? st * ext[ax] : span;
    box[i + 1] = ax == 1 ? rows : 1;
  }
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// TMA reads a tensor's rows in place: its base and the strides of its
// batch, sequence and head axes are multiples of 8 bf16 values (16 bytes)
inline bool rows_aligned(const void* p, long long sb, long long ss,
                         long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (sb | ss | sh) % 8 == 0;
}

}  // namespace hopper
