// Kernel A: O = softmax(Q K^T) V per (sequence, head), q pre-scaled.
//
// Replaces: gwkit/ops/attention.py::_attn_kernel (K1) and the attention
// stage (per-head q_block loop) of gwkit/ops/fused_block.py::
// _attn_block_kernel (K3) / _attn_only_kernel (K4).
//
// Contract kept from the TPU kernels: scores in f32; keys at or beyond T
// masked; the EXACT row max (two passes over the key tiles: the first finds
// the max, the second forms p = exp(round(s - m)) in the compute type, sums
// the rounded p in f32 and accumulates p . V in f32); the (64, hd) output is
// divided by the f32 denominator (fused_block.py:167-170, :209). Masking is
// by T itself: there is no padding of T to 128.
//
// Bound on the H100: at the main path's T = 256, hd = 64 (bf16, 1536
// sequence-heads) the work is 4 T^2 hd FLOPs per head (26 GFLOP, 0.026 ms)
// against q, k, v read and o written once (~200 MB, 0.06 ms): bytes bound.
// At T = 1500 the FLOPs dominate.
// Design: one block per (64-query tile, sequence-head). K and V stream
// through double-buffered shared memory in 64-key tiles (cp.async, the next
// tile's copy overlapping the current tile's products), so any T fits (the
// TPU kernel held all of K and V in VMEM, which 227 KB of shared memory
// cannot at T = 1500).
// The two-pass max recomputes Q K^T once more (1.5x the FLOPs of one pass)
// in exchange for p values identical to a softmax with the exact max; q, k,
// v are read straight out of the fused QKV projection via row strides, and o
// is written in the (B, T, H*hd) layout the o-projection reads.
#include "common.cuh"

namespace gw {

template <typename T> struct Attn {
  static constexpr int HD = 64, BQ = 64, BKV = 64;
  static constexpr int LDT = HD + Pad<T>::v;  // q/k/v tiles
  static constexpr int LDS = BKV + 4;         // f32 scores / output
  static constexpr int LDP = BKV + Pad<T>::v; // probabilities
  static constexpr size_t TILE = align128((size_t)BQ * LDT * sizeof(T));
  static constexpr size_t SS = align128((size_t)BQ * LDS * sizeof(float));
  static constexpr size_t PS = align128((size_t)BQ * LDP * sizeof(T));
  static constexpr size_t SMEM = 5 * TILE + SS + PS + 2 * align128(BQ * sizeof(float));
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int T_len, int H, int ld_in, int ld_out) {
  typedef Attn<T> L;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks[2] = {reinterpret_cast<T*>(smem + L::TILE), reinterpret_cast<T*>(smem + 2 * L::TILE)};
  T* Vs[2] = {reinterpret_cast<T*>(smem + 3 * L::TILE), reinterpret_cast<T*>(smem + 4 * L::TILE)};
  float* Ss = reinterpret_cast<float*>(smem + 5 * L::TILE);
  T* Ps = reinterpret_cast<T*>(smem + 5 * L::TILE + L::SS);
  float* mrow = reinterpret_cast<float*>(smem + 5 * L::TILE + L::SS + L::PS);
  float* lrow = mrow + align128(L::BQ * sizeof(float)) / sizeof(float);

  const int t0 = blockIdx.x * L::BQ;
  const int bh = blockIdx.y, seq = bh / H, head = bh - seq * H;
  const long long base_in = (long long)seq * T_len * ld_in + (long long)head * L::HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRowsPerWarp = L::BQ / kWarps;
  const int n_tiles = (T_len + L::BKV - 1) / L::BKV;

  // Stages 0..n-1 stream K tiles for pass 1 (exact row max); stages n..2n-1
  // stream K and V tiles again for pass 2. Stage st uses buffer st & 1, and
  // stage st + 1 is copied while stage st computes.
  auto issue = [&](int st) {
    const int k0 = (st < n_tiles ? st : st - n_tiles) * L::BKV;
    const long long off = base_in + (long long)k0 * ld_in;
    load_tile_async(Ks[st & 1], L::LDT, k + off, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
    if (st >= n_tiles)
      load_tile_async(Vs[st & 1], L::LDT, v + off, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
  };

  load_tile_async(Qs, L::LDT, q + base_in + (long long)t0 * ld_in, ld_in, L::BQ, L::HD, T_len - t0, L::HD);
  cp_async_commit();
  issue(0);
  cp_async_commit();
  if (threadIdx.x < L::BQ) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }

  Acc<T, L::BQ, L::BKV> s;
  Acc<T, L::BQ, L::HD> acc;
  acc.zero();
  for (int st = 0; st < 2 * n_tiles; ++st) {
    if (st + 1 < 2 * n_tiles) issue(st + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int buf = st & 1;
    const int k0 = (st < n_tiles ? st : st - n_tiles) * L::BKV;
    s.zero();
    s.template mma<true>(Qs, L::LDT, Ks[buf], L::LDT, L::HD);
    s.store(Ss, L::LDS);
    __syncthreads();
    if (st < n_tiles) {  // pass 1: running exact max of the masked scores
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float mx = -INFINITY;
        for (int c = lane; c < L::BKV; c += 32)
          if (k0 + c < T_len) mx = fmaxf(mx, Ss[r * L::LDS + c]);
        mx = warp_max(mx);
        if (lane == 0) mrow[r] = fmaxf(mrow[r], mx);
      }
    } else {  // pass 2: p = exp(round(s - m)) in T, f32 row sums, o += p . V in f32
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        const float m = mrow[r];
        float sum = 0.f;
        for (int c = lane; c < L::BKV; c += 32) {
          float p = 0.f;
          if (k0 + c < T_len) p = rnd<T>(expf(rnd<T>(Ss[r * L::LDS + c] - m)));
          Ps[r * L::LDP + c] = from_f<T>(p);
          sum += p;
        }
        sum = warp_sum(sum);
        if (lane == 0) lrow[r] += sum;
      }
      __syncthreads();
      acc.template mma<false>(Ps, L::LDP, Vs[buf], L::LDT, L::BKV);
    }
    __syncthreads();
  }

  acc.store(Ss, L::LDS);
  __syncthreads();
  const long long base_out = (long long)seq * T_len * ld_out + (long long)head * L::HD;
  for (int e = threadIdx.x; e < L::BQ * L::HD; e += kThreads) {
    const int r = e / L::HD, c = e - r * L::HD;
    const int t = t0 + r;
    if (t < T_len)
      o[base_out + (long long)t * ld_out + c] = from_f<T>(Ss[r * L::LDS + c] / lrow[r]);
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* o, int B, int T_len, int H,
                  int ld_in, int ld_out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)Attn<T>::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + Attn<T>::BQ - 1) / Attn<T>::BQ, B * H);
  attention_kernel<T><<<grid, kThreads, Attn<T>::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), T_len, H, ld_in, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace gw

// q, k, v: row t of sequence b, head h starts at ptr + (b*T + t)*ld_in + h*64
// (so (B, T, H, 64) contiguous tensors pass ld_in = H*64, and the fused QKV
// projection passes its three column blocks with ld_in = 3*H*64); o likewise
// with ld_out. Head dim 64; ld_in a multiple of 8 and the pointers 16-byte
// aligned. Returns a cudaError_t.
extern "C" int gw_attention(const void* q, const void* k, const void* v, void* o, int B,
                            int T_len, int H, int ld_in, int ld_out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32) return gw::launch<float>(q, k, v, o, B, T_len, H, ld_in, ld_out, s);
  if (dtype == GW_BF16) return gw::launch<gw::bf16>(q, k, v, o, B, T_len, H, ld_in, ld_out, s);
  return (int)cudaErrorInvalidValue;
}
