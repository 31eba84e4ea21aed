// Kernel D: the attention backward, dQ, dK, dV of O = softmax(Q K^T) V per
// (sequence, head), q pre-scaled, under K1's softmax contract.
//
// Replaces: gwkit/ops/attention.py::_attn_bwd_kernel (K5), called through
// _flash_bwd_impl (attention.py:141-169) from the custom_vjp of K1.
//
// What it computes, as the TPU kernel does: s = q k^T in f32, keys at or
// beyond T masked; p = exp(s - m) / l in f32 with the EXACT row max m and
// the f32 row sum l; p_lo = p rounded to the compute type;
//   dV = p_lo^T dO,  dP = dO V^T,  o = p_lo V (f32, recomputed: the forward
//   saves no output),  D = rowsum(dO * o),  dS = round(p * (dP - D)),
//   dQ = dS K,  dK = dS^T Q,
// every product accumulated in f32 and every output rounded once.
//
// Bound on the H100: at the training shapes (768 sequence-heads, T = 256,
// hd = 64, bf16) the function reads q, k, v, dO and writes dq, dk, dv once,
// 7 T hd 2 bytes per sequence-head (176 MB, 0.053 ms), against its six
// T x T x hd products, 12 T^2 hd FLOPs per sequence-head (38.7 GFLOP, 0.039
// ms): bytes bound; at T = 1500 the FLOPs dominate.
//
// Design (FlashAttention-2's split): two launches, no float atomics, so two
// runs give the same gradients bit for bit.
//  * dq_kernel: one block per (64-query tile, sequence-head). K and V stream
//    through double-buffered shared memory in 64-key tiles (cp.async), three
//    passes: (1) the exact row max with the online f32 row sum, (2) o = p_lo V
//    and then D, (3) dS and dQ += dS K. It writes m, l and D of its rows to a
//    (3, BH, Tp) f32 scratch for the second launch.
//  * dkdv_kernel: one block per (64-key tile, sequence-head) holds its K and
//    V tiles and walks the query tiles (Q, dO and the row statistics
//    double-buffered), computing S^T = K Q^T and dP^T = V dO^T so that P^T
//    and dS^T land in shared memory as the A operands of dV += P^T dO and
//    dK += dS^T Q; dK and dV accumulate in f32 registers.
// 227 KB of shared memory cannot hold all of K and V at T = 1500, as the
// TPU kernel held them in VMEM: both launches stream tiles instead. q, k, v
// and dO are read in place through row strides (the fused QKV projection
// passes its column blocks), as kernel A reads them.
#include "common.cuh"

namespace gw {

template <typename T> struct Bwd {
  static constexpr int HD = 64, BQ = 64, BKV = 64;
  static constexpr int LDT = HD + Pad<T>::v;  // q/k/v/dO tiles
  static constexpr int LDS = BKV + 4;         // f32 scores, dP, o
  static constexpr int LDP = BKV + Pad<T>::v; // probabilities, dS
  static constexpr size_t TILE = align128((size_t)BQ * LDT * sizeof(T));
  static constexpr size_t SS = align128((size_t)BQ * LDS * sizeof(float));
  static constexpr size_t PS = align128((size_t)BQ * LDP * sizeof(T));
  static constexpr size_t ROW = align128(BQ * sizeof(float));
  // dq: Q, dO, K x2, V x2 | S, dP | P/dS | m, l, D
  static constexpr size_t SMEM_DQ = 6 * TILE + 2 * SS + PS + 3 * ROW;
  // dkdv: K, V, Q x2, dO x2 | S^T, dP^T | P^T, dS^T | (m, l, D) x2
  static constexpr size_t SMEM_DKDV = 6 * TILE + 2 * SS + 2 * PS + 6 * ROW;
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ stats, int T_len,
          int Tp, int H, int ld_in, int ld_do, int ld_out) {
  typedef Bwd<T> L;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* dOs = reinterpret_cast<T*>(smem + L::TILE);
  T* Ks[2] = {reinterpret_cast<T*>(smem + 2 * L::TILE), reinterpret_cast<T*>(smem + 3 * L::TILE)};
  T* Vs[2] = {reinterpret_cast<T*>(smem + 4 * L::TILE), reinterpret_cast<T*>(smem + 5 * L::TILE)};
  float* Ss = reinterpret_cast<float*>(smem + 6 * L::TILE);
  float* dPs = reinterpret_cast<float*>(smem + 6 * L::TILE + L::SS);
  T* Ps = reinterpret_cast<T*>(smem + 6 * L::TILE + 2 * L::SS);
  float* mrow = reinterpret_cast<float*>(smem + 6 * L::TILE + 2 * L::SS + L::PS);
  float* lrow = mrow + L::ROW / sizeof(float);
  float* drow = lrow + L::ROW / sizeof(float);

  const int t0 = blockIdx.x * L::BQ;
  const int bh = blockIdx.y, seq = bh / H, head = bh - seq * H;
  const long long base_in = (long long)seq * T_len * ld_in + (long long)head * L::HD;
  const long long base_do = (long long)seq * T_len * ld_do + (long long)head * L::HD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int kRowsPerWarp = L::BQ / kWarps;
  const int n_tiles = (T_len + L::BKV - 1) / L::BKV;

  // stage st streams key tile st % n_tiles of pass st / n_tiles: K alone for
  // pass 0 (row statistics), K and V for passes 1 (o, D) and 2 (dQ)
  auto issue = [&](int st) {
    const int pass = st / n_tiles;
    const int k0 = (st - pass * n_tiles) * L::BKV;
    const long long off = base_in + (long long)k0 * ld_in;
    load_tile_async(Ks[st & 1], L::LDT, k + off, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
    if (pass > 0)
      load_tile_async(Vs[st & 1], L::LDT, v + off, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
  };

  load_tile_async(Qs, L::LDT, q + base_in + (long long)t0 * ld_in, ld_in, L::BQ, L::HD, T_len - t0, L::HD);
  load_tile_async(dOs, L::LDT, dout + base_do + (long long)t0 * ld_do, ld_do, L::BQ, L::HD, T_len - t0,
                  L::HD);
  cp_async_commit();
  issue(0);
  cp_async_commit();
  if (threadIdx.x < L::BQ) {
    mrow[threadIdx.x] = -INFINITY;
    lrow[threadIdx.x] = 0.f;
  }

  Acc<T, L::BQ, L::BKV> s, dp;
  Acc<T, L::BQ, L::HD> acc;  // o in pass 1, then dQ in pass 2
  acc.zero();
  for (int st = 0; st < 3 * n_tiles; ++st) {
    if (st + 1 < 3 * n_tiles) issue(st + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int buf = st & 1, pass = st / n_tiles;
    const int k0 = (st - pass * n_tiles) * L::BKV;
    s.zero();
    s.template mma<true>(Qs, L::LDT, Ks[buf], L::LDT, L::HD);
    s.store(Ss, L::LDS);
    if (pass == 2) {
      dp.zero();
      dp.template mma<true>(dOs, L::LDT, Vs[buf], L::LDT, L::HD);
      dp.store(dPs, L::LDS);
    }
    __syncthreads();
    if (pass == 0) {  // exact running max and the f32 row sum rescaled to it
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float mx = -INFINITY;
        for (int c = lane; c < L::BKV; c += 32)
          if (k0 + c < T_len) mx = fmaxf(mx, Ss[r * L::LDS + c]);
        mx = warp_max(mx);
        const float m_old = mrow[r], m_new = fmaxf(m_old, mx);
        float sum = 0.f;
        for (int c = lane; c < L::BKV; c += 32)
          if (k0 + c < T_len) sum += expf(Ss[r * L::LDS + c] - m_new);
        sum = warp_sum(sum);
        __syncwarp();
        if (lane == 0) {
          lrow[r] = lrow[r] * expf(m_old - m_new) + sum;
          mrow[r] = m_new;
        }
      }
    } else if (pass == 1) {  // p_lo = round(exp(s - m) / l); o += p_lo V
      for (int e = threadIdx.x; e < L::BQ * L::BKV; e += kThreads) {
        const int r = e / L::BKV, c = e - r * L::BKV;
        Ps[r * L::LDP + c] = from_f<T>(k0 + c < T_len ? expf(Ss[r * L::LDS + c] - mrow[r]) / lrow[r] : 0.f);
      }
      __syncthreads();
      acc.template mma<false>(Ps, L::LDP, Vs[buf], L::LDT, L::BKV);
    } else {  // dS = round(p * (dP - D)); dQ += dS K
      for (int e = threadIdx.x; e < L::BQ * L::BKV; e += kThreads) {
        const int r = e / L::BKV, c = e - r * L::BKV;
        const float p = k0 + c < T_len ? expf(Ss[r * L::LDS + c] - mrow[r]) / lrow[r] : 0.f;
        Ps[r * L::LDP + c] = from_f<T>(p * (dPs[r * L::LDS + c] - drow[r]));
      }
      __syncthreads();
      acc.template mma<false>(Ps, L::LDP, Ks[buf], L::LDT, L::BKV);
    }
    __syncthreads();
    if (st == 2 * n_tiles - 1) {  // o is complete: D = rowsum(dO * o) in f32
      acc.store(dPs, L::LDS);
      acc.zero();
      __syncthreads();
      for (int rr = 0; rr < kRowsPerWarp; ++rr) {
        const int r = warp * kRowsPerWarp + rr;
        float d = 0.f;
        for (int c = lane; c < L::HD; c += 32) d += to_f(dOs[r * L::LDT + c]) * dPs[r * L::LDS + c];
        d = warp_sum(d);
        if (lane == 0) drow[r] = d;
      }
      __syncthreads();
      if (threadIdx.x < L::BQ) {  // every row of the tile, padding included
        const long long at = (long long)bh * Tp + t0 + threadIdx.x;
        const long long plane = (long long)gridDim.y * Tp;
        stats[at] = mrow[threadIdx.x];
        stats[plane + at] = lrow[threadIdx.x];
        stats[2 * plane + at] = drow[threadIdx.x];
      }
    }
  }

  acc.store(Ss, L::LDS);
  __syncthreads();
  const long long base_out = (long long)seq * T_len * ld_out + (long long)head * L::HD;
  for (int e = threadIdx.x; e < L::BQ * L::HD; e += kThreads) {
    const int r = e / L::HD, c = e - r * L::HD;
    if (t0 + r < T_len) dq[base_out + (long long)(t0 + r) * ld_out + c] = from_f<T>(Ss[r * L::LDS + c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ dout, const float* __restrict__ stats, T* __restrict__ dk,
            T* __restrict__ dv, int T_len, int Tp, int H, int ld_in, int ld_do, int ld_out) {
  typedef Bwd<T> L;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + L::TILE);
  T* Qs[2] = {reinterpret_cast<T*>(smem + 2 * L::TILE), reinterpret_cast<T*>(smem + 3 * L::TILE)};
  T* dOs[2] = {reinterpret_cast<T*>(smem + 4 * L::TILE), reinterpret_cast<T*>(smem + 5 * L::TILE)};
  float* St = reinterpret_cast<float*>(smem + 6 * L::TILE);
  float* dPt = reinterpret_cast<float*>(smem + 6 * L::TILE + L::SS);
  T* Pt = reinterpret_cast<T*>(smem + 6 * L::TILE + 2 * L::SS);
  T* dSt = reinterpret_cast<T*>(smem + 6 * L::TILE + 2 * L::SS + L::PS);
  float* rows = reinterpret_cast<float*>(smem + 6 * L::TILE + 2 * L::SS + 2 * L::PS);
  constexpr int kRow = L::ROW / sizeof(float);  // (m, l, D) of buffer b at rows + (3 b + i) kRow

  const int k0 = blockIdx.x * L::BKV;
  const int bh = blockIdx.y, seq = bh / H, head = bh - seq * H;
  const long long base_in = (long long)seq * T_len * ld_in + (long long)head * L::HD;
  const long long base_do = (long long)seq * T_len * ld_do + (long long)head * L::HD;
  const long long plane = (long long)gridDim.y * Tp;
  const int n_tiles = (T_len + L::BQ - 1) / L::BQ;

  auto issue = [&](int j) {
    const int q0 = j * L::BQ, b = j & 1;
    load_tile_async(Qs[b], L::LDT, q + base_in + (long long)q0 * ld_in, ld_in, L::BQ, L::HD, T_len - q0, L::HD);
    load_tile_async(dOs[b], L::LDT, dout + base_do + (long long)q0 * ld_do, ld_do, L::BQ, L::HD, T_len - q0,
                    L::HD);
    for (int i = 0; i < 3; ++i)  // the stats rows are padded to Tp: no masking
      load_tile_async(rows + (3 * b + i) * kRow, L::BQ, stats + i * plane + (long long)bh * Tp + q0, 0, 1,
                      L::BQ, 1, L::BQ);
  };

  load_tile_async(Ks, L::LDT, k + base_in + (long long)k0 * ld_in, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
  load_tile_async(Vs, L::LDT, v + base_in + (long long)k0 * ld_in, ld_in, L::BKV, L::HD, T_len - k0, L::HD);
  cp_async_commit();
  issue(0);
  cp_async_commit();

  Acc<T, L::BKV, L::BQ> s, dp;
  Acc<T, L::BKV, L::HD> dk_acc, dv_acc;
  dk_acc.zero();
  dv_acc.zero();
  for (int j = 0; j < n_tiles; ++j) {
    if (j + 1 < n_tiles) issue(j + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const int b = j & 1, q0 = j * L::BQ;
    s.zero();
    s.template mma<true>(Ks, L::LDT, Qs[b], L::LDT, L::HD);    // S^T = K Q^T
    s.store(St, L::LDS);
    dp.zero();
    dp.template mma<true>(Vs, L::LDT, dOs[b], L::LDT, L::HD);  // dP^T = V dO^T
    dp.store(dPt, L::LDS);
    __syncthreads();
    const float* m = rows + 3 * b * kRow;
    const float* l = m + kRow;
    const float* d = l + kRow;
    for (int e = threadIdx.x; e < L::BKV * L::BQ; e += kThreads) {
      const int kr = e / L::BQ, qc = e - kr * L::BQ;
      const bool ok = k0 + kr < T_len && q0 + qc < T_len;
      const float p = ok ? expf(St[kr * L::LDS + qc] - m[qc]) / l[qc] : 0.f;
      Pt[kr * L::LDP + qc] = from_f<T>(p);
      dSt[kr * L::LDP + qc] = from_f<T>(p * (dPt[kr * L::LDS + qc] - d[qc]));
    }
    __syncthreads();
    dv_acc.template mma<false>(Pt, L::LDP, dOs[b], L::LDT, L::BQ);  // dV += P^T dO
    dk_acc.template mma<false>(dSt, L::LDP, Qs[b], L::LDT, L::BQ);  // dK += dS^T Q
    __syncthreads();
  }

  const long long base_out = (long long)seq * T_len * ld_out + (long long)head * L::HD;
  dk_acc.store(St, L::LDS);
  dv_acc.store(dPt, L::LDS);
  __syncthreads();
  for (int e = threadIdx.x; e < L::BKV * L::HD; e += kThreads) {
    const int r = e / L::HD, c = e - r * L::HD;
    if (k0 + r < T_len) {
      const long long at = base_out + (long long)(k0 + r) * ld_out + c;
      dk[at] = from_f<T>(St[r * L::LDS + c]);
      dv[at] = from_f<T>(dPt[r * L::LDS + c]);
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, const void* dout, void* dq, void* dk,
                  void* dv, void* stats, int B, int T_len, int H, int ld_in, int ld_do, int ld_out,
                  cudaStream_t stream) {
  typedef Bwd<T> L;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)L::SMEM_DQ);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dkdv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)L::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (T_len + L::BQ - 1) / L::BQ, Tp = n_tiles * L::BQ;
  const dim3 grid(n_tiles, B * H);
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* do_ = static_cast<const T*>(dout);
  dq_kernel<T><<<grid, kThreads, L::SMEM_DQ, stream>>>(q_, k_, v_, do_, static_cast<T*>(dq),
                                                      static_cast<float*>(stats), T_len, Tp, H, ld_in,
                                                      ld_do, ld_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dkdv_kernel<T><<<grid, kThreads, L::SMEM_DKDV, stream>>>(q_, k_, v_, do_, static_cast<const float*>(stats),
                                                          static_cast<T*>(dk), static_cast<T*>(dv), T_len,
                                                          Tp, H, ld_in, ld_do, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace gw

// q, k, v: row t of sequence b, head h starts at ptr + (b*T + t)*ld_in + h*64;
// dout with ld_do; dq, dk, dv (written) with ld_out. stats: a float32
// scratch of 3 * B*H * Tp values, Tp = T rounded up to 64. Head dim 64; the
// row strides multiples of 8 and the pointers 16-byte aligned. Two launches
// on `stream`; returns a cudaError_t.
extern "C" int gw_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                void* dq, void* dk, void* dv, void* stats, int B, int T_len, int H,
                                int ld_in, int ld_do, int ld_out, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32)
    return gw::launch<float>(q, k, v, dout, dq, dk, dv, stats, B, T_len, H, ld_in, ld_do, ld_out, s);
  if (dtype == GW_BF16)
    return gw::launch<gw::bf16>(q, k, v, dout, dq, dk, dv, stats, B, T_len, H, ld_in, ld_do, ld_out, s);
  return (int)cudaErrorInvalidValue;
}
