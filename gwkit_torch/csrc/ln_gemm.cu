// Kernel B: y = [LN(x)] . W + bias [+ residual], the projection stages of
// one encoder layer.
//
// Replaces: gwkit/ops/fused_block.py::_attn_block_kernel (and
// _attn_only_kernel), stages `ln_qkv_tile` (LN1 + the single (D, 3D) QKV
// product with DoRA and the 1/sqrt(hd) query scale folded into W) and
// `o_tile` (o-projection + bias + residual). On the TPU both live inside the
// one whole-layer kernel; on Hopper each is one launch of this kernel.
//
// Bound on the H100: at the main path's shapes (M = 256 x 256 rows, K = 384,
// N = 1152 or 384, bf16) the FLOPs (2MNK: 58 / 19 GFLOP) and the bytes (x
// read once, y written once: ~200 / ~150 MB) put both at ~0.06 / ~0.045 ms,
// i.e. the stage sits near the ridge of the roofline; the bytes bound is the
// larger for the o-projection.
// Design: a block owns 64 rows x 128 columns. It stages its 64 x K panel of x
// in shared memory once, normalizes it there (so LN(x) never reaches HBM),
// streams W through two shared buffers in 64-deep slices with cp.async (the
// next slice's copy overlaps the current slice's products), accumulates in
// f32 (tensor-core WMMA for bf16, FMA for f32), and fuses bias, rounding and
// the residual add into the store. The weights (<= 1.3 MB) stay L2-resident
// across blocks. No TMA / wgmma yet.
#include "common.cuh"

namespace gw {

template <typename T> struct LnGemm {
  static constexpr int BM = 64, BN = 128, BK = 64;
  static constexpr int LDB = BN + Pad<T>::v, LDC = BN + 4;
  static constexpr size_t B_TILE = align128((size_t)BK * LDB * sizeof(T));
  static __host__ __device__ int lda(int K) { return K + Pad<T>::v; }
  static __host__ __device__ size_t region0(int K) {
    const size_t a = align128((size_t)BM * lda(K) * sizeof(T));
    const size_t c = align128((size_t)BM * LDC * sizeof(float));
    return a > c ? a : c;
  }
  static __host__ __device__ size_t smem(int K) { return region0(K) + 2 * B_TILE; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_gemm_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
               const T* __restrict__ w, const float* __restrict__ bias,
               const T* __restrict__ res, T* __restrict__ y, int M, int N, int K) {
  typedef LnGemm<T> L;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);          // (BM, K) panel of x, then LN(x)
  float* Cs = reinterpret_cast<float*>(smem);  // (BM, BN) f32 result; aliases As
  T* Bs[2] = {reinterpret_cast<T*>(smem + L::region0(K)),
              reinterpret_cast<T*>(smem + L::region0(K) + L::B_TILE)};
  const int lda = L::lda(K);
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * L::BN;
  const int nk = K / L::BK;
  auto issue_w = [&](int s) {  // W rows [s*BK, (s+1)*BK), columns [n0, n0+BN)
    load_tile_async(Bs[s & 1], L::LDB, w + (long long)s * L::BK * N + n0, N, L::BK, L::BN,
                    L::BK, N - n0);
  };

  // the x panel, then the first W slice, as two copy groups
  load_tile_async(As, lda, x + (long long)m0 * K, K, L::BM, K, M - m0, K);
  cp_async_commit();
  issue_w(0);
  cp_async_commit();
  cp_async_wait1();
  __syncthreads();
  if (g != nullptr) ln_rows(As, lda, L::BM, K, g, b);

  // W streams through two buffers: slice s+1 is in flight while s multiplies
  Acc<T, L::BM, L::BN> acc;
  acc.zero();
  for (int s = 0; s < nk; ++s) {
    if (s + 1 < nk) issue_w(s + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    acc.template mma<false>(As + s * L::BK, lda, Bs[s & 1], L::LDB, L::BK);
    __syncthreads();
  }
  acc.store(Cs, L::LDC);
  __syncthreads();

  for (int e = threadIdx.x; e < L::BM * L::BN; e += kThreads) {
    const int r = e / L::BN, c = e - r * L::BN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) {
      float o = rnd<T>(Cs[r * L::LDC + c] + bias[n]);
      if (res != nullptr) o = to_f(res[(long long)m * N + n]) + o;
      y[(long long)m * N + n] = from_f<T>(o);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* g, const void* b, const void* w, const void* bias,
                  const void* res, void* y, int M, int N, int K, cudaStream_t stream) {
  const size_t smem = LnGemm<T>::smem(K);
  cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + LnGemm<T>::BN - 1) / LnGemm<T>::BN, (M + LnGemm<T>::BM - 1) / LnGemm<T>::BM);
  ln_gemm_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<const T*>(w), static_cast<const float*>(bias), static_cast<const T*>(res),
      static_cast<T*>(y), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace gw

// x (M, K), g/b (K,) or null (no LayerNorm), w (K, N), bias (N,) float32,
// res (M, N) or null, y (M, N); K a multiple of 64, N of 8, x and w 16-byte
// aligned. Returns a cudaError_t.
extern "C" int gw_ln_gemm(const void* x, const void* g, const void* b, const void* w,
                          const void* bias, const void* res, void* y, int M, int N, int K,
                          int dtype, void* stream) {
  if (K % gw::LnGemm<float>::BK != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32) return gw::launch<float>(x, g, b, w, bias, res, y, M, N, K, s);
  if (dtype == GW_BF16) return gw::launch<gw::bf16>(x, g, b, w, bias, res, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
}
