// Shared device helpers for the gwkit_torch Hopper kernels.
//
// Every kernel runs 256 threads (8 warps) per block and builds its products
// from one primitive, Acc<T, BM, BN>: a (BM, BN) float32 accumulator tile
// that adds A_s (BM, depth) x B_s (depth, BN), both operands in shared
// memory, and finally stores itself to a float32 tile in shared memory.
//  * bfloat16: WMMA 16x16x16 tensor-core fragments with f32 accumulation
//    (mma.sync underneath); each warp owns a 32-row by BN/4-column tile, so
//    every A fragment it loads serves BN/64 products and every B fragment 2.
//  * float32: plain f32 FMA, register-blocked per thread (no TF32), so the
//    f32 path can be held to f32 tolerances.
// Epilogues then work element-wise on the f32 tile, so both types share one
// arithmetic order for everything but the products themselves.
// Global -> shared copies are 16-byte cp.async (zero-filled outside the
// valid rows and columns), so kernels can overlap the next tile's copy
// with the current tile's products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace gw {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// value rounded to the compute type T (round to nearest even), kept as float
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// Row padding of shared tiles, in elements: 16 bytes, so every row starts
// 16-byte aligned (cp.async, WMMA) and consecutive rows shift banks.
template <typename T> struct Pad { static constexpr int v = 16 / sizeof(T); };

__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// --- cp.async (sm_80+): 16-byte global -> shared copies ---------------------
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: no read, the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most one committed group of this thread is still in flight
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }
// --- end cp.async -------------------------------------------------------------

// Issue the copy dst[r][c] = src[r * lds + c] for r < row_lim and
// c < col_lim, zeros elsewhere, as 16-byte cp.async. Needs cols, col_lim and
// lds multiples of 16 bytes, src 16-byte aligned (the wrappers check).
template <typename T>
__device__ __forceinline__ void load_tile_async(T* dst, int ldd, const T* src, long long lds,
                                                int rows, int cols, int row_lim, int col_lim) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int r = e / per_row, c = (e - r * per_row) * VEC;
    const bool ok = r < row_lim && c < col_lim;
    cp_async16(dst + r * ldd + c, ok ? src + (long long)r * lds + c : src, ok);
  }
}

// The same copy, completed before it returns (with a block barrier).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int ldd, const T* src, long long lds,
                                          int rows, int cols, int row_lim, int col_lim) {
  load_tile_async(dst, ldd, src, lds, rows, cols, row_lim, col_lim);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
}

// LayerNorm of `rows` rows of width K held in shared memory, in place, with
// the semantics of gwkit's in-kernel _ln_f32 (fused_block.py:66-71): f32 mean
// and biased variance, normalize, round to T, then scale and shift in T.
template <typename T>
__device__ void ln_rows(T* a, int lda, int rows, int K, const T* g, const T* b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    T* row = a + r * lda;
    float s = 0.f;
    for (int c = lane; c < K; c += 32) s += to_f(row[c]);
    const float mean = warp_sum(s) / (float)K;
    float v = 0.f;
    for (int c = lane; c < K; c += 32) {
      const float d = to_f(row[c]) - mean;
      v += d * d;
    }
    const float var = warp_sum(v) / (float)K;
    const float rstd = 1.f / sqrtf(var + 1e-5f);
    for (int c = lane; c < K; c += 32) {
      const float y = rnd<T>((to_f(row[c]) - mean) * rstd);
      row[c] = from_f<T>(rnd<T>(y * to_f(g[c])) + to_f(b[c]));
    }
  }
}

template <typename T, int BM, int BN> struct Acc;

// float32: thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i, cols tx + 16 j.
template <int BM, int BN> struct Acc<float, BM, BN> {
  static_assert(BM % 16 == 0 && BN % 16 == 0, "f32 tile must be a multiple of 16");
  static constexpr int RM = BM / 16, RN = BN / 16;
  float c[RM][RN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) c[i][j] = 0.f;
  }

  // c += A (BM x depth, row stride lda) * B; B is (depth x BN) row-major with
  // stride ldb, or with BT its transpose stored (BN x depth) row-major.
  template <bool BT>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B, int ldb, int depth) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
    for (int k = 0; k < depth; ++k) {
      float a[RM], b[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < RN; ++j) b[j] = BT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = c[i][j];
  }
};

// bfloat16: WMMA fragments; the 8 warps form a (BM/32) x WN grid, warp w
// owning rows (w % WM) * 32 (two fragments) and NF column fragments from
// (w / WM) * (BN / WN).
template <int BM, int BN> struct Acc<bf16, BM, BN> {
  static constexpr int WM = BM / 32, WN = kWarps / WM, NF = BN / WN / 16;
  static_assert(BM % 32 == 0 && kWarps % WM == 0 && WN * NF * 16 == BN, "bad WMMA tiling");
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> c[2][NF];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f) nvcuda::wmma::fill_fragment(c[i][f], 0.f);
  }

  template <bool BT>
  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B, int ldb, int depth) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp % WM) * 32, col0 = (warp / WM) * (BN / WN);
    typedef typename std::conditional<BT, wmma::col_major, wmma::row_major>::type BLayout;
    for (int k0 = 0; k0 < depth; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], A + row0 * lda + k0, lda);
      wmma::load_matrix_sync(a[1], A + (row0 + 16) * lda + k0, lda);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b;
        const int n0 = col0 + f * 16;
        wmma::load_matrix_sync(b, BT ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
        wmma::mma_sync(c[0][f], a[0], b, c[0][f]);
        wmma::mma_sync(c[1][f], a[1], b, c[1][f]);
      }
    }
  }

  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp % WM) * 32, col0 = (warp / WM) * (BN / WN);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        nvcuda::wmma::store_matrix_sync(C + (row0 + 16 * i) * ldc + col0 + f * 16, c[i][f], ldc,
                                        nvcuda::wmma::mem_row_major);
  }
};

}  // namespace gw

// dtype codes shared with the Python wrappers
#define GW_F32 0
#define GW_BF16 1
