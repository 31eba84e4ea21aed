// Kernel E: y = epilogue(dequant(rowquant([LN](x)) . Wq)), the int8
// projections of one encoder layer.
//
// Replaces: the quant branch of gwkit/ops/fused_block.py::_attn_block_kernel
// (K6): `_quantize_rows` (:79), `_quantize_cols` (:89, done once at load by
// the wrapper's caller) and `_qdot` (:99), used by the stages `ln_qkv_tile`,
// `o_tile` and `mlp_tile` (:154-157, :238-241, :257-261). On the TPU they
// live inside the one whole-layer kernel; on Hopper each projection is one
// launch of this kernel: LN1 + QKV, o + residual, LN2 + fc1 + GELU,
// fc2 + residual.
//
// Arithmetic, as gwkit's: h = [LN](x) rounded to T; per row
// sx = max(max|h|, 1e-6) / 127 in f32; q = clip(rint(h / sx), +-127) (a true
// division, round half to even); acc = q . Wq summed in int32 (exact);
// y = (f32(acc) * sx) * sw + bias in f32 with no fused multiply-add, rounded
// to T; then GELU in f32 on that value rounded to T, or + residual in T.
//
// Bound on the H100: bytes. At the main path's shapes (M = 65,536 rows,
// D = 384, F = 1536, bf16) the int8 products are 2MNK = 58 / 19 / 77 / 77
// GOP (0.03 / 0.01 / 0.04 / 0.04 ms at 1,979 TOPS), while the activations
// in and out move 200 / 150 / 250 / 300 MB (0.06 / 0.045 / 0.075 / 0.09 ms).
// fc2 quantizes each activation row by its maximum over all of F, so the
// (M, F) GELU output goes through device memory between the two MLP
// launches (keeping it on chip is a later redesign).
// Design: a block owns 64 rows and walks every 128-column tile of N. Its
// prologue takes one row per warp (with LN staged and normalized in shared
// memory as kernel B's), takes the row's absolute maximum by a warp
// reduction and writes the row, quantized, into an int8 (64, K) panel, so
// each row is read from device memory and quantized once per launch (read
// twice, maximum then values, without LN: at K = 1536 a staged f32 panel
// would not fit beside the buffers). Int8 W slices
// (64 x 128) stream through two shared buffers with cp.async across all
// column tiles (the next slice's copy overlaps the current slice's
// products; the weights, <= 0.6 MB, stay L2-resident). Products are int8
// WMMA 16x16x16 fragments with int32 accumulators (mma.sync on the int8
// tensor cores); the epilogue dequantizes from an int32 tile in shared
// memory. No TMA / wgmma yet.
#include "common.cuh"

namespace gw {

typedef signed char i8;

struct I8Gemm {
  static constexpr int BM = 64, BN = 128, BK = 64;
  static constexpr int LDB = BN + 16, LDC = BN + 4;  // int8 W slice, int32 result tile
  static constexpr size_t B_TILE = align128((size_t)BK * LDB);
  static constexpr size_t C_TILE = align128((size_t)BM * LDC * sizeof(int));
  static constexpr size_t SX = align128(BM * sizeof(float));
  static __host__ __device__ int lda(int K) { return K + 16; }
  static __host__ __device__ size_t panel(int K) { return align128((size_t)BM * lda(K)); }
  template <typename T> static __host__ __device__ size_t rows(int K) {
    return align128((size_t)kWarps * K * sizeof(T));
  }
  // the staging rows are needed only for the LayerNorm (K = d_model there)
  template <typename T> static __host__ __device__ size_t smem(int K, bool ln) {
    return panel(K) + (ln ? rows<T>(K) : 0) + 2 * B_TILE + C_TILE + SX;
  }
};

// int8 x int8 -> int32 accumulator of a (64, 128) tile: the 8 warps form a
// 2 x 4 grid, each owning 32 rows x 32 columns (2 x 2 fragments).
struct AccI8 {
  static constexpr int NF = 2;
  nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, int> c[2][NF];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f) nvcuda::wmma::fill_fragment(c[i][f], 0);
  }

  // c += A (64 x depth int8, row stride lda) * B (depth x 128 int8, row stride ldb)
  __device__ __forceinline__ void mma(const i8* A, int lda, const i8* B, int ldb, int depth) {
    using namespace nvcuda;
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 32;
    for (int k0 = 0; k0 < depth; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, i8, wmma::row_major> a[2];
      wmma::load_matrix_sync(a[0], A + row0 * lda + k0, lda);
      wmma::load_matrix_sync(a[1], A + (row0 + 16) * lda + k0, lda);
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, i8, wmma::row_major> b;
        wmma::load_matrix_sync(b, B + k0 * ldb + col0 + f * 16, ldb);
        wmma::mma_sync(c[0][f], a[0], b, c[0][f]);
        wmma::mma_sync(c[1][f], a[1], b, c[1][f]);
      }
    }
  }

  __device__ __forceinline__ void store(int* C, int ldc) const {
    const int warp = threadIdx.x >> 5;
    const int row0 = (warp & 1) * 32, col0 = (warp >> 1) * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int f = 0; f < NF; ++f)
        nvcuda::wmma::store_matrix_sync(C + (row0 + 16 * i) * ldc + col0 + f * 16, c[i][f], ldc,
                                        nvcuda::wmma::mem_row_major);
  }
};

// act: 0 none, 1 GELU (tanh), 2 GELU (erf)
template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                 const i8* __restrict__ w, const float* __restrict__ sw,
                 const float* __restrict__ bias, const T* __restrict__ res, T* __restrict__ y,
                 int M, int N, int K, int act) {
  typedef I8Gemm L;
  extern __shared__ __align__(128) unsigned char smem[];
  i8* As = reinterpret_cast<i8*>(smem);  // (BM, K) quantized panel
  const bool ln = g != nullptr;
  unsigned char* p = smem + L::panel(K);
  T* rows = reinterpret_cast<T*>(p);     // with LN: one staging row of K per warp
  p += ln ? L::rows<T>(K) : 0;
  i8* Bs[2] = {reinterpret_cast<i8*>(p), reinterpret_cast<i8*>(p + L::B_TILE)};
  p += 2 * L::B_TILE;
  int* Cs = reinterpret_cast<int*>(p);   // (BM, BN) int32 result of one column tile
  float* sxs = reinterpret_cast<float*>(p + L::C_TILE);  // per-row scales
  const int lda = L::lda(K);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int m0 = blockIdx.x * L::BM;
  const int nk = K / L::BK, ntiles = (N + L::BN - 1) / L::BN, total = nk * ntiles;
  // stage t is W slice t % nk of column tile t / nk
  auto issue = [&](int t) {
    const int nt = t / nk, s = t - nt * nk;
    load_tile_async(Bs[t & 1], L::LDB, w + (long long)s * L::BK * N + nt * L::BN, N, L::BK, L::BN,
                    L::BK, N - nt * L::BN);
  };
  issue(0);  // the first W slice is in flight during the prologue
  cp_async_commit();

  // prologue: each warp quantizes its rows, read from device memory twice
  // (maximum, then values), or with LN staged and normalized in shared
  // memory first
  for (int r = warp; r < L::BM; r += kWarps) {
    const int m = m0 + r;
    i8* qrow = As + r * lda;
    if (m >= M) {  // past the last row: zeros, never stored
      for (int c = lane; c < K; c += 32) qrow[c] = 0;
      if (lane == 0) sxs[r] = 1.f;
      continue;
    }
    const T* h = x + (long long)m * K;
    if (ln) {
      T* row = rows + warp * K;
      for (int c = lane; c < K; c += 32) row[c] = h[c];
      ln_row(row, K, g, b);
      h = row;
    }
    float amax = 0.f;
    for (int c = lane; c < K; c += 32) amax = fmaxf(amax, fabsf(to_f(h[c])));
    const float sx = fmaxf(warp_max(amax), 1e-6f) / 127.f;
    for (int c = lane; c < K; c += 32) {
      const float v = fminf(fmaxf(rintf(to_f(h[c]) / sx), -127.f), 127.f);
      qrow[c] = static_cast<i8>(static_cast<int>(v));
    }
    if (lane == 0) sxs[r] = sx;
  }
  __syncthreads();

  AccI8 acc;
  for (int nt = 0; nt < ntiles; ++nt) {
    acc.zero();
    for (int s = 0; s < nk; ++s) {
      const int t = nt * nk + s;
      if (t + 1 < total) issue(t + 1);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      acc.mma(As + s * L::BK, lda, Bs[t & 1], L::LDB, L::BK);
      __syncthreads();
    }
    acc.store(Cs, L::LDC);
    __syncthreads();
    const int n0 = nt * L::BN;
    for (int e = threadIdx.x; e < L::BM * L::BN; e += kThreads) {
      const int r = e / L::BN, c = e - r * L::BN;
      const int m = m0 + r, n = n0 + c;
      if (m < M && n < N) {
        // (f32(acc) * sx) * sw + bias, each step rounded (no FMA), as gwkit's _qdot
        const float d = __fmul_rn(__fmul_rn(__int2float_rn(Cs[r * L::LDC + c]), sxs[r]), sw[n]);
        float o = rnd<T>(__fadd_rn(d, bias[n]));
        if (act != 0) o = gelu(o, act == 1);
        if (res != nullptr) o = to_f(res[(long long)m * N + n]) + o;
        y[(long long)m * N + n] = from_f<T>(o);
      }
    }
    __syncthreads();
  }
}

template <typename T>
static int launch(const void* x, const void* g, const void* b, const void* w, const void* sw,
                  const void* bias, const void* res, void* y, int M, int N, int K, int act,
                  cudaStream_t stream) {
  const size_t smem = I8Gemm::smem<T>(K, g != nullptr);
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + I8Gemm::BM - 1) / I8Gemm::BM;
  int8_gemm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<const i8*>(w), static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const T*>(res), static_cast<T*>(y), M, N, K, act);
  return (int)cudaGetLastError();
}

}  // namespace gw

// x (M, K), g/b (K,) or null (no LayerNorm), w (K, N) int8, sw and bias (N,)
// float32, res (M, N) or null, y (M, N); act 0 none, 1 GELU tanh, 2 GELU
// erf (with no residual). K a multiple of 64 and, by shared memory, at most
// 2752 (with LN 1856 in f32, 2176 in bf16); N a multiple of 16; x and w
// 16-byte aligned. Returns a cudaError_t.
extern "C" int gw_int8_gemm(const void* x, const void* g, const void* b, const void* w,
                            const void* sw, const void* bias, const void* res, void* y, int M,
                            int N, int K, int act, int dtype, void* stream) {
  if (K % gw::I8Gemm::BK != 0 || N % 16 != 0 || act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32) return gw::launch<float>(x, g, b, w, sw, bias, res, y, M, N, K, act, s);
  if (dtype == GW_BF16) return gw::launch<gw::bf16>(x, g, b, w, sw, bias, res, y, M, N, K, act, s);
  return (int)cudaErrorInvalidValue;
}
