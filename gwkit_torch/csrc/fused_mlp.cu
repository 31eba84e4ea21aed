// Kernel C: out = x + gelu(LN(x) . W1 + b1) . W2 + b2, the MLP half of one
// encoder layer.
//
// Replaces: gwkit/ops/fused_mlp.py::_mlp_kernel (K2) and the `mlp_tile`
// stage of gwkit/ops/fused_block.py::_attn_block_kernel (K3).
//
// Bound on the H100: FLOPs. At the main path's shapes (M = 65,536 rows,
// D = 384, F = 1536, bf16) the two products are 4MDF = 155 GFLOP (0.16 ms at
// the 989 TFLOP/s bf16 peak) against ~100 MB of x in and out (0.03 ms).
// Unfused, the (M, F) activation would add 2 x 200 MB of HBM traffic.
// Design: a block owns a tile of rows (64 for bf16, 32 for f32) and every
// output column. It normalizes its rows in shared memory once, then walks F
// in 64-wide chunks: fc1 for the chunk (f32 accumulation) -> bias -> round ->
// GELU in the compute type -> a (rows, 64) activation tile in shared memory
// -> accumulated straight into the fc2 result held in registers. So the
// (M, F) activation never reaches device memory, as in the TPU kernel. The
// weights (2.4 MB bf16) are re-read from L2 by every block, streamed through
// double buffers with cp.async so the next slice's copy overlaps the current
// slice's products; TMA multicast and wgmma are later work.
#include "common.cuh"

namespace gw {

template <typename T, int D> struct Mlp {
  static constexpr int BM = sizeof(T) == 4 ? 32 : 64;
  // F is walked in FC-wide chunks; fc1 takes D in BK1-deep slices, fc2 the
  // chunk in BK2-deep slices (16 at D = 512, to fit shared memory)
  static constexpr int FC = 64, BK1 = 64, BK2 = D <= 384 ? 32 : 16;
  static constexpr int N1 = D / BK1, N2 = FC / BK2, NS = N1 + N2;  // stages per chunk
  static_assert(N1 % 2 == 0 && N2 % 2 == 0, "buffer parity must repeat every chunk");
  static constexpr int P = Pad<T>::v;
  static constexpr int LDA = D + P, LDW1 = FC + P, LDH = FC + 4, LDHD = FC + P, LDW2 = D + P,
                       LDC = D + 4;
  static constexpr size_t R0 =
      align128((size_t)BM * LDA * sizeof(T)) > align128((size_t)BM * LDC * sizeof(float))
          ? align128((size_t)BM * LDA * sizeof(T))
          : align128((size_t)BM * LDC * sizeof(float));
  static constexpr size_t W1S = align128((size_t)BK1 * LDW1 * sizeof(T));
  static constexpr size_t HS = align128((size_t)BM * LDH * sizeof(float));
  static constexpr size_t HDS = align128((size_t)BM * LDHD * sizeof(T));
  static constexpr size_t W2S = align128((size_t)BK2 * LDW2 * sizeof(T));
  static constexpr size_t SMEM = R0 + 2 * W1S + HS + HDS + 2 * W2S;
};

__device__ __forceinline__ float gelu(float h, int approx) {
  if (approx) return 0.5f * h * (1.f + tanhf(0.7978845608028654f * (h + 0.044715f * h * h * h)));
  return 0.5f * h * (1.f + erff(h * 0.7071067811865476f));
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ g, const T* __restrict__ b,
                 const T* __restrict__ w1, const float* __restrict__ b1,
                 const T* __restrict__ w2, const float* __restrict__ b2, T* __restrict__ out,
                 int M, int F, int approx) {
  typedef Mlp<T, D> L;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem);          // (BM, D) LN(x)
  float* Cs = reinterpret_cast<float*>(smem);  // (BM, D) f32 fc2 result; aliases As
  unsigned char* p = smem + L::R0;
  T* W1s[2] = {reinterpret_cast<T*>(p), reinterpret_cast<T*>(p + L::W1S)};
  p += 2 * L::W1S;
  float* Hs = reinterpret_cast<float*>(p);
  T* Hd = reinterpret_cast<T*>(p + L::HS);
  p += L::HS + L::HDS;
  T* W2s[2] = {reinterpret_cast<T*>(p), reinterpret_cast<T*>(p + L::W2S)};
  const int m0 = blockIdx.x * L::BM;
  const int n_chunks = F / L::FC;

  // stage st < N1 of a chunk is fc1's W1 slice st; stage N1 + j is fc2's W2 slice j
  auto issue = [&](int chunk, int st) {
    const int f0 = chunk * L::FC;
    if (st < L::N1)
      load_tile_async(W1s[st & 1], L::LDW1, w1 + (long long)st * L::BK1 * F + f0, F, L::BK1,
                      L::FC, L::BK1, L::FC);
    else {
      const int j = st - L::N1;
      load_tile_async(W2s[j & 1], L::LDW2, w2 + (long long)(f0 + j * L::BK2) * D, D, L::BK2, D,
                      L::BK2, D);
    }
  };

  load_tile_async(As, L::LDA, x + (long long)m0 * D, D, L::BM, D, M - m0, D);
  cp_async_commit();
  issue(0, 0);
  cp_async_commit();
  cp_async_wait1();
  __syncthreads();
  ln_rows(As, L::LDA, L::BM, D, g, b);

  Acc<T, L::BM, D> acc2;
  Acc<T, L::BM, L::FC> acc1;
  acc2.zero();
  for (int chunk = 0; chunk < n_chunks; ++chunk) {
    acc1.zero();
    for (int st = 0; st < L::NS; ++st) {
      // keep the next stage's weights in flight (the next chunk's first W1
      // slice after this chunk's last stage)
      if (st + 1 < L::NS)
        issue(chunk, st + 1);
      else if (chunk + 1 < n_chunks)
        issue(chunk + 1, 0);
      cp_async_commit();
      cp_async_wait1();
      __syncthreads();
      if (st < L::N1) {
        acc1.template mma<false>(As + st * L::BK1, L::LDA, W1s[st & 1], L::LDW1, L::BK1);
      } else {
        const int j = st - L::N1;
        acc2.template mma<false>(Hd + j * L::BK2, L::LDHD, W2s[j & 1], L::LDW2, L::BK2);
      }
      __syncthreads();
      if (st == L::N1 - 1) {  // fc1 done: bias, round, GELU in T -> Hd
        acc1.store(Hs, L::LDH);
        __syncthreads();
        const int f0 = chunk * L::FC;
        for (int e = threadIdx.x; e < L::BM * L::FC; e += kThreads) {
          const int r = e / L::FC, c = e - r * L::FC;
          const float h = rnd<T>(Hs[r * L::LDH + c] + b1[f0 + c]);
          Hd[r * L::LDHD + c] = from_f<T>(gelu(h, approx));
        }
        __syncthreads();
      }
    }
  }
  acc2.store(Cs, L::LDC);
  __syncthreads();

  for (int e = threadIdx.x; e < L::BM * D; e += kThreads) {
    const int r = e / D, c = e - r * D;
    const int m = m0 + r;
    if (m < M) {
      const float yv = rnd<T>(Cs[r * L::LDC + c] + b2[c]);
      out[(long long)m * D + c] = from_f<T>(to_f(x[(long long)m * D + c]) + yv);
    }
  }
}

template <typename T, int D>
static int launch(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* out, int M, int F, int approx,
                  cudaStream_t stream) {
  typedef Mlp<T, D> L;
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int grid = (M + L::BM - 1) / L::BM;
  fused_mlp_kernel<T, D><<<grid, kThreads, L::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const T*>(b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out), M, F, approx);
  return (int)cudaGetLastError();
}

template <typename T>
static int dispatch(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                    const void* w2, const void* b2, void* out, int M, int D, int F, int approx,
                    cudaStream_t s) {
  if (D == 384) return launch<T, 384>(x, g, b, w1, b1, w2, b2, out, M, F, approx, s);
  if (D == 512) return launch<T, 512>(x, g, b, w1, b1, w2, b2, out, M, F, approx, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace gw

// x (M, D), g/b (D,), w1 (D, F), b1 (F,) f32, w2 (F, D), b2 (D,) f32, out (M, D).
// D is 384 (whisper-tiny) or 512 (whisper-base); F a multiple of 64; x, w1
// and w2 16-byte aligned.
extern "C" int gw_fused_mlp(const void* x, const void* g, const void* b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, int M,
                            int D, int F, int approx, int dtype, void* stream) {
  if (F % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32) return gw::dispatch<float>(x, g, b, w1, b1, w2, b2, out, M, D, F, approx, s);
  if (dtype == GW_BF16)
    return gw::dispatch<gw::bf16>(x, g, b, w1, b1, w2, b2, out, M, D, F, approx, s);
  return (int)cudaErrorInvalidValue;
}
