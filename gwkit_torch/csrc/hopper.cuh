// Hopper (sm_90a) building blocks for the gwkit_torch kernels: warpgroup
// matrix multiply (wgmma), the Tensor Memory Accelerator (TMA) and the
// shared-memory barriers (mbarrier) that tie them together.
//
// Kernels A (attention.cu), D (attention_bwd.cu), B (ln_gemm.cu) and C
// (fused_mlp.cu) use it in bf16; kernel E (int8_gemm.cu) takes its TMA
// ring, clusters, LayerNorm pass and TMA store with the s8 wgmma forms.
//
// What is here:
//  * shared-memory matrix descriptors for tiles written by a TMA load with
//    128-byte swizzle: rows of 64 bf16 (128 bytes), 8-row groups 1024 bytes
//    apart, the tile 1024-byte aligned. K-major (the depth dimension
//    contiguous: Q and K for S = Q K^T) and MN-major (the output dimension
//    contiguous: V as B of O = P V, read with the transpose flag), the
//    latter also over several 64-column atoms (B wider than 64); sw128, the
//    byte offset of an element in such an atom, and sw128_byte for 1-byte
//    elements (an int8 atom row holds 128 values of depth);
//  * wgmma.fence / commit_group / wait_group and a register fence that
//    keeps the compiler from moving accumulators across an async product;
//  * bf16 wgmma with f32 accumulation: m64n64k16 with A from shared memory
//    (SS) or from registers (RS), and m64nNk16 SS for N = 128, 192, 256;
//  * s8 wgmma with s32 accumulation: m64nNk32 SS for N = 64, 128 (both
//    operands K-major: 8-bit types have no transpose);
//  * mbarrier init, arrive (also on another block of the cluster), arrive
//    with an expected byte count, and the parity wait;
//  * TMA: the 4-D and 2-D tile loads, the 2-D load multicast to every block
//    of a cluster, the 2-D tile store with its bulk-group waits, the plain
//    bulk copy (contiguous bytes), the proxy fence and named barriers; on
//    the host the tensor-map encoding through cudaGetDriverEntryPoint, so
//    no library links libcuda: the (64, H, T, B) map of attention's
//    row-strided q, k, v and dO, and 2-D maps of row-major bf16 or 1-byte
//    matrices;
//  * cluster rank, id, count and barrier;
//  * LayerNorm in place over a swizzled K-major panel (kernels B, C, E);
//  * accumulator-fragment helpers shared by the attention kernels: quad
//    max, sum and transpose, column masking, and the correctly rounded
//    division through a reciprocal (div_rn).
//
// Fragment layouts (PTX ISA, "wgmma" register fragments), for thread
// `lane` of warp w of the warpgroup, g = lane / 4, x = lane % 4:
//  * accumulator of m64nN (f32, or s32 of the s8 forms): d[4j + 2i + e]
//    holds row 16w + g + 8i, column 8j + 2x + e (j < N / 8, i, e in {0, 1});
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
// MN-major B wider than 64 columns (wgmma n128 and up): 64-column atoms of
// `depth` rows x 128 bytes laid one after another, so the leading offset is
// the atom's size (the stride between atoms along N) and the stride offset
// the 8-row group's 1024 bytes (CUTLASS's canonical GMMA layout for
// MN-major 128-byte swizzle: ((8,8,m),(8,k)):((1,8,LBO),(64,SBO)) elements).
// Depth step k (16 rows) adds 128k, as for one atom.
__device__ __forceinline__ uint64_t desc_mnmajor_atoms(const void* tile, uint32_t atom_bytes) {
  return desc_sw128(tile, atom_bytes, 1024);
}

// Byte offset of element (r, c), c < 64, in a 128-byte-swizzled atom of
// rows of 64 bf16 (as TMA writes it and desc_kmajor reads it): the 16-byte
// chunk c / 8 of row r is stored at chunk (c / 8) ^ (r % 8).
__device__ __forceinline__ uint32_t sw128(int r, int c) {
  return (uint32_t)r * 128u + ((((uint32_t)c >> 3) ^ ((uint32_t)r & 7u)) << 4) + (((uint32_t)c & 7u) << 1);
}
// The same for byte b (< 128) of row r, for 1-byte elements: an int8 atom
// row holds 128 values of depth, and a k32 step is 32 bytes (as bf16's k16).
__device__ __forceinline__ uint32_t sw128_byte(int r, int b) {
  return (uint32_t)r * 128u + ((((uint32_t)b >> 4) ^ ((uint32_t)r & 7u)) << 4) + ((uint32_t)b & 15u);
}

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
template <int N> __device__ __forceinline__ void reg_fence(int (&r)[N]) {
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

// d (64 x N, f32: N / 2 registers a thread) = (accumulate ? d : 0) + A (64 x 16) B (16 x N),
// A and B bf16 in shared memory by descriptor; TRANS_B = 1 reads B MN-major. N = 128, 192, 256
// (kernels B and C); N = 64 is wgmma_m64n64k16_ss above.
#define GW_OPS4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define GW_OPS16(i) GW_OPS4(i), GW_OPS4(i + 4), GW_OPS4(i + 8), GW_OPS4(i + 12)
#define GW_OPS32(i) GW_OPS16(i), GW_OPS16(i + 16)
template <int N> struct WgmmaSS;
template <> struct WgmmaSS<128> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p, 1, 1, 0, %67;\n}\n"
        : GW_OPS32(0), GW_OPS32(32)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};
template <> struct WgmmaSS<192> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[96], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95}"
        ", %96, %97, p, 1, 1, 0, %99;\n}\n"
        : GW_OPS32(0), GW_OPS32(32), GW_OPS32(64)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};
template <> struct WgmmaSS<256> {
  template <int TRANS_B>
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
        "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, "
        "%87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
        "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"
        ", %128, %129, p, 1, 1, 0, %131;\n}\n"
        : GW_OPS32(0), GW_OPS32(32), GW_OPS32(64), GW_OPS32(96)
        : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
  }
};
#undef GW_OPS4
#undef GW_OPS16
#undef GW_OPS32

template <int N, int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n64k16_ss<TRANS_B>(d, a, b, accumulate);
  else
    WgmmaSS<N>::template run<TRANS_B>(d, a, b, accumulate);
}

// d (64 x N, s32: N / 2 registers a thread, the accumulator layout at the
// top) = (accumulate ? d : 0) + A (64 x 32) B (32 x N), A and B int8 in
// shared memory by descriptor, both K-major (B as N rows of depth): the
// PTX ISA has no transpose for 8-bit types. A k32 step is 32 bytes, +2 in
// a descriptor. N = 64, 128 (kernel E).
#define GW_IOPS4(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3])
#define GW_IOPS16(i) GW_IOPS4(i), GW_IOPS4(i + 4), GW_IOPS4(i + 8), GW_IOPS4(i + 12)
#define GW_IOPS32(i) GW_IOPS16(i), GW_IOPS16(i + 16)
template <int N> struct WgmmaS8;
template <> struct WgmmaS8<64> {
  static __device__ __forceinline__ void run(int (&d)[32], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
        ", %32, %33, p;\n}\n"
        : GW_IOPS32(0)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
template <> struct WgmmaS8<128> {
  static __device__ __forceinline__ void run(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
        "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
        ", %64, %65, p;\n}\n"
        : GW_IOPS32(0), GW_IOPS32(32)
        : "l"(a), "l"(b), "r"(accumulate));
  }
};
#undef GW_IOPS4
#undef GW_IOPS16
#undef GW_IOPS32

// two floats as one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// two floats each rounded to bf16 (nearest even), as floats: one packed
// conversion for the pair (a quarter-rate instruction) and two shifts
__device__ __forceinline__ float2 round_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return make_float2(__low2float(v), __high2float(v));
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

// The 2-D box at (c0, c1) (column, row) of `map` into shared memory at dst,
// completing on `bar`; out-of-bounds elements arrive as zeros.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// The same box written to the same shared-memory offset of every block of
// the cluster in `mask`, completing on the barrier at bar's offset in each.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar,
                                                      int c0, int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes.multicast::cluster "
      "[%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// Shared memory at src to the 2-D box at (c0, c1) of `map`; elements outside
// the tensor are not written. Completion is tracked by bulk groups.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() { asm volatile("cp.async.bulk.commit_group;\n" ::: "memory"); }
// wait until this thread's stores have read their shared memory (it may be written again)
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }
// wait until this thread's stores have completed
__device__ __forceinline__ void bulk_wait() { asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory"); }

// Order this thread's shared-memory writes before later reads by the async
// proxy (wgmma operands, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` (1-15; 0 is __syncthreads) over `threads` threads, whole warps
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// --- clusters ------------------------------------------------------------------------
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t n_clusters_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}
// every thread of every block of the cluster meets here (shared memory and
// barriers of the other blocks are usable after it, and stay so until all
// have met again)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// arrive on the barrier at bar's offset in block `rank` of the cluster
// (release at CTA scope, as CUTLASS's ClusterBarrier::arrive: the release
// at cluster scope measured about 0.8 us a stage in kernels B and C)
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_u32(bar)),
      "r"(rank)
      : "memory");
}

// --- the consumer side of a ring shared by a cluster ---------------------------------------
// Each consumed stage is one wgmma group. After a stage's products are
// issued, the consumer waits for the previous stage's and releases that one:
// lane 0 of every consumer warp arrives on the stage's empty barrier in each
// block of the cluster (whose producers each fill part of it). So one
// stage's products are in flight while the next stage's are issued. The
// wait is unconditional and the release straight-line: a wgmma wait under a
// branch, or a release loop of data-dependent length, made kernels B and C
// measurably slower (ptxas then keeps fewer products in flight).
template <int CLUSTER>
struct RingConsumer {
  Ring at;  // the next stage to consume
  int pending = -1;  // the stage whose products may still run
  uint64_t* empty;
  uint32_t rank;
  bool lane0;
  __device__ __forceinline__ RingConsumer(int stages, uint64_t* empty_bars, uint32_t cta_rank, int lane)
      : at(stages), empty(empty_bars), rank(cta_rank), lane0(lane == 0) {}
  __device__ __forceinline__ void release(int s) {
    if (lane0)
      for (uint32_t r = 0; r < CLUSTER; ++r) {
        if (r == rank)
          mbar_arrive(&empty[s]);
        else
          mbar_arrive_cluster(&empty[s], r);
      }
  }
  // the products of stage `at` are issued
  __device__ __forceinline__ void committed() {
    wgmma_commit();
    wgmma_wait<1>();
    if (pending >= 0) release(pending);
    pending = at.idx;
    at.advance();
  }
  // stage `at` was read by plain loads (no products): released at once;
  // only with no product pending (after drain), and after the warp's reads
  __device__ __forceinline__ void consumed() {
    release(at.idx);
    at.advance();
  }
  // every product issued is complete and its stage released
  __device__ __forceinline__ void drain() {
    wgmma_wait<0>();
    if (pending >= 0) release(pending);
    pending = -1;
  }
};

// --- LayerNorm in place on a swizzled panel ----------------------------------------------
// The rows r_begin, r_begin + r_step, ... < r_end of a K-wide bf16 panel held
// as K / 64 atoms (atom a: columns 64a..64a+63, `atom_bytes` apart; element
// (r, c) at sw128(r, c)), normalized in place by one warp a row, where the
// products read them. gwkit's in-kernel LayerNorm (fused_block.py:66-71):
// f32 mean and biased variance, normalize, round to bf16, then scale and
// shift in bf16. Lane l takes the 16-byte chunks l and l + 32 of each row
// (K <= 512); a warp takes ROWS rows at a time, so their shuffle
// reductions overlap, and rounds pairs with one conversion.
template <int ROWS>
__device__ __forceinline__ void ln_rows_sw128(unsigned char* panel, uint32_t atom_bytes, int r_begin,
                                              int r_step, int r_end, int K, const __nv_bfloat16* g,
                                              const __nv_bfloat16* b, int lane) {
  const int nq = K >> 3;
  float gv[2][8], bv[2][8];
  const bool vec = ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(b)) & 15) == 0;
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const int q = lane + 32 * t;
    if (q < nq && vec) {
      const uint4 gr = *reinterpret_cast<const uint4*>(g + 8 * q), br = *reinterpret_cast<const uint4*>(b + 8 * q);
      const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&gr);
      const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&br);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gv[t][2 * e] = __low2float(g2[e]);
        gv[t][2 * e + 1] = __high2float(g2[e]);
        bv[t][2 * e] = __low2float(b2[e]);
        bv[t][2 * e + 1] = __high2float(b2[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        gv[t][e] = q < nq ? __bfloat162float(g[8 * q + e]) : 0.f;
        bv[t][e] = q < nq ? __bfloat162float(b[8 * q + e]) : 0.f;
      }
    }
  }
  for (int r0 = r_begin; r0 < r_end; r0 += ROWS * r_step) {
    float v[ROWS][2][8], s[ROWS], var[ROWS], mean[ROWS], rstd[ROWS];
    uint4* chunk[ROWS][2];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * r_step;
      s[u] = 0.f;
      var[u] = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int q = lane + 32 * t;
        chunk[u][t] = reinterpret_cast<uint4*>(panel + (q >> 3) * atom_bytes + sw128(r, 8 * (q & 7)));
        uint4 raw = q < nq && r < r_end ? *chunk[u][t] : make_uint4(0, 0, 0, 0);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[u][t][2 * e] = __low2float(h[e]);
          v[u][t][2 * e + 1] = __high2float(h[e]);
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) s[u] += v[u][t][e];
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      mean[u] = s[u] / (float)K;
#pragma unroll
      for (int t = 0; t < 2; ++t)
        if (lane + 32 * t < nq)
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = v[u][t][e] - mean[u];
            var[u] += d * d;
          }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) var[u] += __shfl_xor_sync(0xffffffffu, var[u], o);
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      rstd[u] = 1.f / sqrtf(var[u] / (float)K + 1e-5f);
      if (r0 + u * r_step >= r_end) continue;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        if (lane + 32 * t >= nq) continue;
        uint32_t w[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 2 * e;
          const float2 y = round_bf16x2((v[u][t][k] - mean[u]) * rstd[u], (v[u][t][k + 1] - mean[u]) * rstd[u]);
          const float2 z = round_bf16x2(y.x * gv[t][k], y.y * gv[t][k + 1]);
          w[e] = pack_bf16(z.x + bv[t][k], z.y + bv[t][k + 1]);
        }
        *chunk[u][t] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
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

// A 2-D tensor map with 128-byte swizzle over a row-major (rows, cols)
// matrix of `elem`-byte elements with row stride `ld` elements: boxes of
// box_rows x box_cols (box_cols x elem <= 128 bytes, one swizzle row). Base
// 16-byte aligned, ld x elem a multiple of 16. Returns a cudaError_t.
inline int tma_map_2d(CUtensorMap* map, CUtensorMapDataType type, size_t elem, const void* base, long long rows,
                      long long cols, long long ld, int box_rows, int box_cols) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                  CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}
// bf16: box_cols <= 64
inline int tma_map_bf16_2d(CUtensorMap* map, const void* base, long long rows, long long cols, long long ld,
                           int box_rows, int box_cols) {
  return tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(__nv_bfloat16), base, rows, cols, ld, box_rows,
                    box_cols);
}
// 1-byte elements (int8 moves as uint8): box_cols <= 128
inline int tma_map_u8_2d(CUtensorMap* map, const void* base, long long rows, long long cols, long long ld,
                         int box_rows, int box_cols) {
  return tma_map_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, base, rows, cols, ld, box_rows, box_cols);
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
