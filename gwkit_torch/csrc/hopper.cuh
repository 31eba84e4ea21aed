// Hopper (sm_90a) building blocks for the gwkit_torch kernels: warpgroup
// matrix multiply (wgmma), the Tensor Memory Accelerator (TMA) and the
// shared-memory barriers (mbarrier) that tie them together.
//
// Kernel A (attention.cu) and kernel D (attention_bwd.cu) use it. The
// redesigns queued after them are meant to reuse it as it stands: kernel E
// (int8: the same TMA ring; an s8 wgmma form is added beside the bf16 ones),
// kernel C (fused MLP) and kernel B (LayerNorm + GEMM).
//
// What is here:
//  * shared-memory matrix descriptors for tiles written by a TMA load with
//    128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes
//    apart, the tile 1024-byte aligned. K-major (the depth dimension
//    contiguous: Q and K for S = Q K^T) and MN-major (the output dimension
//    contiguous: V as B of O = P V, read with the transpose flag);
//  * wgmma.fence / commit_group / wait_group and a register fence that
//    keeps the compiler from moving accumulators across an async product;
//  * m64n64k16 bf16 wgmma with A from shared memory (SS) or from registers
//    (RS), f32 accumulation in 32 registers a thread;
//  * mbarrier init, arrive, arrive with an expected byte count, and the
//    parity wait;
//  * the 4-D TMA tile load and the plain bulk copy (contiguous bytes), and
//    on the host the tensor-map encoding through cudaGetDriverEntryPoint,
//    so no library links libcuda; the (64, H, T, B) map of attention's
//    row-strided q, k, v and dO;
//  * accumulator-fragment helpers shared by the attention kernels: quad
//    max, sum and transpose, column masking, and the correctly rounded
//    division through a reciprocal (div_rn).
//
// Fragment layouts (PTX ISA, "wgmma" register fragments), for thread
// `lane` of warp w of the warpgroup, g = lane / 4, x = lane % 4:
//  * accumulator of m64nN: d[4j + 2i + e] holds row 16w + g + 8i, column
//    8j + 2x + e (j < N / 8, i, e in {0, 1});
//  * A of m64nNk16 from registers, four 32-bit registers of two bf16 each
//    (low half first): a[0] row 16w + g, columns 2x, 2x+1; a[1] row
//    16w + g + 8, the same columns; a[2], a[3] the same rows at columns
//    8 + 2x, 8 + 2x + 1.
// So the accumulator blocks j = 2k, 2k + 1 of a product, converted to bf16
// pairs in place, are the A fragment of depth step k of the next product.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace gw {
namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- matrix descriptors ------------------------------------------------------
// bits 0-13 start address >> 4, 16-29 leading byte offset >> 4, 32-45 stride
// byte offset >> 4, 62-63 layout (1 = 128-byte swizzle). Base offset 0: the
// tiles are 1024-byte aligned.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// K-major tile (rows x 64 bf16, depth contiguous): the leading offset is
// unused under swizzle, 8-row groups 1024 bytes apart. Depth step k (16
// elements, 32 bytes) adds 2k to the descriptor.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile) { return desc_sw128(tile, 16, 1024); }
// MN-major tile (depth rows x 64 bf16 columns, columns contiguous): one
// 128-byte swizzle atom spans the 64 columns, 8 depth rows form a group
// 1024 bytes apart. Both offsets are 1024, which reads the same under
// either naming of the two fields (a 64-wide tile has one atom across).
// Depth step k (16 rows, 2048 bytes) adds 128k to the descriptor.
__device__ __forceinline__ uint64_t desc_mnmajor(const void* tile) { return desc_sw128(tile, 1024, 1024); }

// --- wgmma ordering ------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pin registers at this point of the program: the compiler may not move
// their reads or writes across it (around an asynchronous product).
template <int N> __device__ __forceinline__ void reg_fence(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N> __device__ __forceinline__ void reg_fence(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define GW_D32                                                                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, " \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define GW_D32_OPS(d)                                                                            \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),           \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),   \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),             \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),             \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

// d (64 x 64, f32) = (accumulate ? d : 0) + A (64 x 16) B (16 x 64), A and B
// bf16 in shared memory by descriptor; TRANS_B = 1 reads B MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GW_D32
      ", %32, %33, p, 1, 1, 0, %35;\n}\n"
      : GW_D32_OPS(d)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// The same with A from registers (the fragment layout at the top).
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GW_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : GW_D32_OPS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate), "n"(TRANS_B));
}
#undef GW_D32
#undef GW_D32_OPS

// two floats as one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// --- mbarrier ----------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}
// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// arrive and add `bytes` to the transaction count the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint64_t globaltimer_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// wait until the phase of parity `parity` has completed (a fresh barrier is
// in phase 0, so waiting on parity 1 returns at once). A wait that lasts 10 s
// is a fault in the kernel's protocol: it traps, so the launch fails instead
// of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = globaltimer_ns();
    else if (globaltimer_ns() - t0 > 10000000000ull)
      __trap();
  }
}

// A ring of `n` stages: the stage index and the parity of its current use.
struct Ring {
  int n, idx = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ explicit Ring(int stages) : n(stages) {}
  __device__ __forceinline__ void advance() {
    if (++idx == n) {
      idx = 0;
      phase ^= 1u;
    }
  }
};

// --- TMA -----------------------------------------------------------------------
// Copy the box at coordinates (c0, c1, c2, c3) (innermost first) of the
// tensor `map` into shared memory at dst, completing `bytes` on `bar`.
// Elements outside the tensor arrive as zeros and count as bytes all the same.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Copy `bytes` contiguous bytes from global memory to shared memory at dst,
// completing them on `bar` (both addresses 16-byte aligned, bytes a
// multiple of 16).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
               ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// --- accumulator fragments -------------------------------------------------------
// A quad is the four lanes x = lane % 4 that share rows g and g + 8.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Transpose a 4 x 4 block of 32-bit words across the four lanes of a quad:
// afterwards lane x holds in a[y] what lane y held in a[x].
__device__ __forceinline__ void quad_transpose(uint32_t (&a)[4], int x) {
#pragma unroll
  for (int d = 1; d <= 2; d <<= 1) {
    const bool upper = (x & d) != 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i & d) continue;
      const uint32_t recv = __shfl_xor_sync(0xffffffffu, upper ? a[i] : a[i | d], d);
      if (upper)
        a[i] = recv;
      else
        a[i | d] = recv;
    }
  }
}

// Columns at or beyond `limit` of a 64-column accumulator tile whose first
// column is col0 become -inf (d[4j + 2i + e] is column 8j + 2x + e).
__device__ __forceinline__ void mask_cols(float (&s)[32], int col0, int limit, int x) {
  if (col0 + 64 <= limit) return;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (col0 + 8 * j + 2 * x + e >= limit) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
}

// a / b correctly rounded, given rb = 1 / b correctly rounded, b >= 1:
// Markstein's correction of a rb by the exact remainder a - b q, in five
// instructions (UNIT) instead of the division's subroutine. The remainder must not
// underflow, so a is first scaled by 2^64 (exact) and the quotient scaled
// back: every quotient in the normal range is the IEEE quotient (theory and
// gw_attention_div in attention.cu, which chip_smoke.py holds against the
// IEEE division); one below 2^-126 may differ in its last bit.
// UNIT: 0 <= a <= 1 (K1's e), always scaled; else any a (K3's output),
// scaled when |a| < 2^-64.
template <bool UNIT>
__device__ __forceinline__ float div_rn(float a, float b, float rb) {
  const bool scale = UNIT || fabsf(a) < 0x1p-64f;
  if (scale) a = __fmul_rn(a, 0x1p64f);
  const float q = __fmul_rn(a, rb);
  const float r = __fmaf_rn(__fmaf_rn(-q, b, a), rb, q);
  return scale ? __fmul_rn(r, 0x1p-64f) : r;
}

// --- host: tensor maps ---------------------------------------------------------
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime (no -lcuda)
inline EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 tensor map with 128-byte swizzle. dims and box innermost first;
// strides in bytes of dims 1..3 (multiples of 16), base 16-byte aligned.
// Out-of-bounds elements load as zeros. Returns a cudaError_t.
inline int tma_map_bf16_4d(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[4],
                           const cuuint64_t (&strides)[3], const cuuint32_t (&box)[4]) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
                  box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The map (64, H, T, B) of a row-strided (B, T, H, 64) bf16 view: row t of
// sequence b, head h at base + (b T + t) ld + 64 h; a box is 64 rows of one
// (sequence, head), rows at or beyond T arriving as zeros.
inline int tma_map_heads(CUtensorMap* map, const void* base, int B, int T_len, int H, int ld) {
  const cuuint64_t dims[4] = {64, (cuuint64_t)H, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[3] = {64 * sizeof(__nv_bfloat16), (cuuint64_t)ld * sizeof(__nv_bfloat16),
                                 (cuuint64_t)T_len * ld * sizeof(__nv_bfloat16)};
  const cuuint32_t box[4] = {64, 1, 64, 1};
  return tma_map_bf16_4d(map, base, dims, strides, box);
}

}  // namespace hopper
}  // namespace gw
