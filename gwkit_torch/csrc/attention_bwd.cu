// Kernel D: the attention backward, dQ, dK, dV of O = softmax(Q K^T) V per
// (sequence, head), q pre-scaled, under K1's softmax contract.
//
// Replaces: gwkit/ops/attention.py::_attn_bwd_kernel (K5), called through
// _flash_bwd_impl (attention.py:141-169) from the custom_vjp of K1.
//
// What it computes, as the TPU kernel does: s = q k^T in f32, keys at or
// beyond T masked; p = exp(s - m) / l in f32 with the EXACT row max m and
// the f32 row sum l; p_lo = p rounded to the compute type;
//   dV = p_lo^T dO,  dP = dO V^T,  o = p_lo V (f32),  D = rowsum(dO * o),
//   dS = round(p * (dP - D)),  dQ = dS K,  dK = dS^T Q,
// every product accumulated in f32 and every output rounded once.
//
// bfloat16 (hopper_dq_kernel, then hopper_dkdv_kernel: training). The
// forward, kernel A under K1 (attention.cu), saves each row's m and l and
// the f32 o = p_lo V from its registers, so neither launch recomputes them.
// Bound of K5's function on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at the
// training shapes (768 sequence-heads, T = 256) it reads q, k, v, dO and
// writes dq, dk, dv once, 896 bytes a row (176 MB, 0.0526 ms), against five
// T x T x 64 products (S, dP, dV, dQ, dK: 32 GFLOP, 0.033 ms): bytes bound.
// At 192 sequence-heads x T = 1500 the products bound it (276 GFLOP, 0.279
// ms). The saved state this design reads (o, m, l: 264 bytes a row) is not
// part of that function.
// Both are persistent, as kernel A is: a block takes work items blockIdx.x,
// + gridDim.x, ..., and its producer loads the next item's tiles into the
// other half of a double buffer while the consumers finish the current one.
//  * hopper_dq_kernel: an item is a 64-query tile of one (sequence, head).
//    One consumer warpgroup and a producer warp whose first lane loads the
//    Q and dO tiles and streams 64-key tiles of K and V through a 4-stage
//    ring by TMA (4-D maps over the row strides, 128-byte swizzle); two
//    blocks an SM. The consumer first makes D for its rows from dO and the
//    saved o, and writes D and 1/l for the second launch. Then one pass over
//    the key tiles: S = Q K^T and dP = dO V^T as SS wgmma; p = exp(s - m) / l
//    by K1's division through the reciprocal (div_rn, exact, as kernel A's
//    p); dS = round(p (dP - D)) packed in registers as the A fragment of
//    dQ += dS K (RS wgmma, K read MN-major).
//  * hopper_dkdv_kernel: an item is 128 keys of one (sequence, head). Two
//    consumer warpgroups of 64 keys hold their K and V tiles; the producer
//    warp streams the (Q, dO) tiles and the rows' m, l, 1/l and D (bulk
//    copies) through the ring. S^T = K Q^T and dP^T = V dO^T as SS wgmma;
//    P^T and dS^T in registers are the A fragments of dV += round(P^T) dO
//    and dK += dS^T Q (RS, dO and Q read MN-major). 1/l comes from the first
//    launch: taking it with __frcp_rn in this loop made D 15-22% slower.
// Seven products instead of the ten of a backward that recomputes the row
// state, one exp and one division a score in each launch instead of four
// exps and three divisions in all, and no score goes through shared
// memory. A warpgroup waits for its products before it touches their
// registers (no product is in flight across a branch); the other warpgroup
// of the SM (the second block, or the second consumer) computes while it
// waits. No float atomics: each output element
// is one block's sum in a fixed order, so two runs give the same bits.
// q, k, v and dO are read in place through row strides (the fused QKV
// projection passes its column blocks), as kernel A reads them.
#include "common.cuh"
#include "hopper.cuh"

namespace gw {

// ---- bfloat16: wgmma, TMA, the forward's row state ------------------------------

struct HopperBwd {
  static constexpr int HD = 64, ROWS = 64;  // a warpgroup's rows; a streamed tile's rows
  static constexpr uint32_t TILE = ROWS * HD * sizeof(bf16);  // 8 KB, one TMA box
  static constexpr int STAGES = 4;
  // hopper_dq_kernel: a consumer warpgroup and a producer warp, two blocks an
  // SM; [item parity]: Q, dO; then the ring (a stage: K, then V)
  static constexpr int DQ_THREADS = 128 + 32, DQ_BLOCKS_PER_SM = 2;
  static constexpr size_t DQ_STAGE_OFF = 2 * 2 * TILE;
  static constexpr size_t DQ_BAR_OFF = DQ_STAGE_OFF + (size_t)STAGES * 2 * TILE;
  static constexpr size_t DQ_SMEM = 1024 + DQ_BAR_OFF + (4 + 2 * STAGES) * sizeof(uint64_t);
  // hopper_dkdv_kernel: two consumer warpgroups of 64 keys and a producer
  // warp; [item parity]: K[2], V[2]; then the ring (a stage: Q, dO, then 64
  // rows each of m, l, 1/l and D)
  static constexpr int CONSUMERS = 2, KEYS = CONSUMERS * ROWS, KV_THREADS = CONSUMERS * 128 + 32;
  static constexpr uint32_t ROW_BYTES = ROWS * sizeof(float);
  static constexpr uint32_t KV_STAGE = 2 * TILE + 4 * ROW_BYTES;
  static constexpr size_t KV_STAGE_OFF = 2 * 2 * CONSUMERS * TILE;
  static constexpr size_t KV_BAR_OFF = KV_STAGE_OFF + (size_t)STAGES * KV_STAGE;
  static constexpr size_t KV_SMEM = 1024 + KV_BAR_OFF + (4 + 2 * STAGES) * sizeof(uint64_t);
  static_assert(KV_STAGE % 1024 == 0, "a stage's TMA tiles must stay 1024-byte aligned");
};

// A warpgroup's 64 x 64 f32 accumulator stored as bf16 rows: tile row
// r = 16 wl + g + 8 i goes to base + r * ld, rows with row0 + r >= limit are
// skipped. Each quad transposes its words so a lane stores 16 contiguous bytes.
__device__ __forceinline__ void store_tile_bf16(const float (&acc)[32], bf16* base, long long ld, int row0,
                                                int limit, int wl, int g, int x) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wl * 16 + g + 8 * i;
    uint32_t wv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wv[j] = hopper::pack_bf16(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
#pragma unroll
    for (int grp = 0; grp < 2; ++grp) {
      uint32_t a4[4] = {wv[4 * grp], wv[4 * grp + 1], wv[4 * grp + 2], wv[4 * grp + 3]};
      hopper::quad_transpose(a4, x);
      if (row0 + r < limit)
        *reinterpret_cast<uint4*>(base + r * ld + 8 * (4 * grp + x)) = make_uint4(a4[0], a4[1], a4[2], a4[3]);
    }
  }
}

// S (or S^T) and dP (or dP^T) of one tile pair: two SS products of depth 64
// from K-major tiles, waited for before the registers are read.
__device__ __forceinline__ void scores_ss(float (&s)[32], float (&dp)[32], uint64_t a_s, uint64_t b_s,
                                          uint64_t a_dp, uint64_t b_dp) {
  using namespace hopper;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(s, a_s + 2 * kk, b_s + 2 * kk, kk > 0);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(dp, a_dp + 2 * kk, b_dp + 2 * kk, kk > 0);
  wgmma_commit();
  wgmma_wait<0>();
  reg_fence(s);
  reg_fence(dp);
}

__global__ void __launch_bounds__(HopperBwd::DQ_THREADS, HopperBwd::DQ_BLOCKS_PER_SM)
hopper_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                 const bf16* __restrict__ dout, const float* __restrict__ o32,
                 const float* __restrict__ row_m, const float* __restrict__ row_l,
                 float* __restrict__ rows_out, bf16* __restrict__ dq, int T_len, int Tp, int H, int BH,
                 int ld_do, int ld_out) {
  typedef HopperBwd L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto q_tile = [&](int qb) { return smem + (size_t)qb * 2 * L::TILE; };
  auto do_tile = [&](int qb) { return q_tile(qb) + L::TILE; };
  auto k_tile = [&](int st) { return smem + L::DQ_STAGE_OFF + (size_t)st * 2 * L::TILE; };
  auto v_tile = [&](int st) { return k_tile(st) + L::TILE; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::DQ_BAR_OFF);
  uint64_t *q_full = bars, *q_empty = bars + 2, *full = bars + 4, *empty = bars + 4 + L::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], 4);
    }
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // a work item is one 64-query tile of one (sequence, head); a persistent
  // block takes items blockIdx.x, + gridDim.x, ...; the producer loads the
  // next item's Q and dO (the other parity's buffers) and K and V tiles
  // while the consumers finish the current one
  const int n_qt = Tp / L::ROWS, n_items = n_qt * BH;
  const int nt = (T_len + L::ROWS - 1) / L::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4) {  // producer: one thread issues every load
    if (lane == 0) {
      Ring ring(L::STAGES);
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int bh = w / n_qt, t0 = (w - bh * n_qt) * L::ROWS, b = bh / H, h = bh - b * H, qb = it & 1;
        mbar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], 2 * L::TILE);
        tma_load_4d(q_tile(qb), &qmap, &q_full[qb], 0, h, t0, b);
        tma_load_4d(do_tile(qb), &domap, &q_full[qb], 0, h, t0, b);
        for (int j = 0; j < nt; ++j) {
          mbar_wait(&empty[ring.idx], ring.phase ^ 1);
          mbar_arrive_expect_tx(&full[ring.idx], 2 * L::TILE);
          tma_load_4d(k_tile(ring.idx), &kmap, &full[ring.idx], 0, h, j * L::ROWS, b);
          tma_load_4d(v_tile(ring.idx), &vmap, &full[ring.idx], 0, h, j * L::ROWS, b);
          ring.advance();
        }
      }
    }
  } else {
    const int g = lane >> 2, x = lane & 3;
    Ring ring(L::STAGES);
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int bh = w / n_qt, t0 = (w - bh * n_qt) * L::ROWS, b = bh / H, h = bh - b * H, qb = it & 1;
      // each row's m, l, 1/l, and D = rowsum(dO o) from this lane's 16
      // columns summed over the quad; rows past T (zero Q and dO tiles) take
      // m = 0, l = 1, D = 0, finite, and their dQ rows are not stored
      float m[2], l[2], rl[2], dd[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int t = t0 + warp * 16 + g + 8 * i;
        float part = 0.f;
        m[i] = 0.f;
        l[i] = 1.f;
        if (t < T_len) {
          m[i] = row_m[(long long)bh * Tp + t];
          l[i] = row_l[(long long)bh * Tp + t];
          const long long row = (long long)b * T_len + t;
          const uint4* dov = reinterpret_cast<const uint4*>(dout + row * ld_do + (long long)h * L::HD + 16 * x);
          const float4* ov = reinterpret_cast<const float4*>(o32 + (row * H + h) * L::HD + 16 * x);
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const uint4 wd = dov[c];
            const uint32_t words[4] = {wd.x, wd.y, wd.z, wd.w};
            const float4 o0 = ov[2 * c], o1 = ov[2 * c + 1];
            const float os[8] = {o0.x, o0.y, o0.z, o0.w, o1.x, o1.y, o1.z, o1.w};
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const __nv_bfloat162 pr = *reinterpret_cast<const __nv_bfloat162*>(&words[e]);
              part += __low2float(pr) * os[2 * e];
              part += __high2float(pr) * os[2 * e + 1];
            }
          }
        }
        rl[i] = __frcp_rn(l[i]);
        dd[i] = quad_sum(part);
        if (x == 0) {  // planes 0 and 1 of the scratch
          rows_out[(long long)bh * Tp + t] = rl[i];
          rows_out[(long long)BH * Tp + (long long)bh * Tp + t] = dd[i];
        }
      }

      mbar_wait(&q_full[qb], (it >> 1) & 1);
      const uint64_t qdesc = desc_kmajor(q_tile(qb)), dodesc = desc_kmajor(do_tile(qb));
      float dq_acc[32], s[32], dp[32];
      uint32_t a[4][4];
      for (int j = 0; j < nt; ++j) {
        mbar_wait(&full[ring.idx], ring.phase);
        unsigned char* kt = k_tile(ring.idx);
        scores_ss(s, dp, qdesc, desc_kmajor(kt), dodesc, desc_kmajor(v_tile(ring.idx)));
        mask_cols(s, j * L::ROWS, T_len, x);
        // dS = round(p (dP - D)) with p = exp(s - m) / l, packed as the A
        // fragments of dS K (accumulator blocks 2kk and 2kk + 1 make step kk)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int r = 4 * (2 * kk + hh) + 2 * i;
              const float p0 = div_rn<true>(expf(s[r] - m[i]), l[i], rl[i]);
              const float p1 = div_rn<true>(expf(s[r + 1] - m[i]), l[i], rl[i]);
              a[kk][2 * hh + i] = pack_bf16(p0 * (dp[r] - dd[i]), p1 * (dp[r + 1] - dd[i]));
            }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) reg_fence(a[kk]);
        const uint64_t kdesc_mn = desc_mnmajor(kt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<1>(dq_acc, a[kk], kdesc_mn + 128 * kk, j > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dq_acc);
        if (lane == 0) mbar_arrive(&empty[ring.idx]);
        ring.advance();
      }
      if (lane == 0) mbar_arrive(&q_empty[qb]);  // this item's Q and dO are read
      store_tile_bf16(dq_acc, dq + ((long long)b * T_len + t0) * ld_out + (long long)h * L::HD, ld_out, t0,
                      T_len, warp, g, x);
    }
  }
}

__global__ void __launch_bounds__(HopperBwd::KV_THREADS, 1)
hopper_dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                   const float* __restrict__ row_m, const float* __restrict__ row_l,
                   const float* __restrict__ rows_in, bf16* __restrict__ dk, bf16* __restrict__ dv,
                   int T_len, int Tp, int H, int BH, int ld_out) {
  typedef HopperBwd L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  auto k_tile = [&](int kb, int c) { return smem + (size_t)(kb * 2 * L::CONSUMERS + c) * L::TILE; };
  auto v_tile = [&](int kb, int c) { return k_tile(kb, c) + L::CONSUMERS * L::TILE; };
  auto stage = [&](int st) { return smem + L::KV_STAGE_OFF + (size_t)st * L::KV_STAGE; };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::KV_BAR_OFF);
  uint64_t *kv_full = bars, *kv_empty = bars + 2, *full = bars + 4, *empty = bars + 4 + L::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&kv_full[i], 1);
      mbar_init(&kv_empty[i], 4 * L::CONSUMERS);
    }
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4 * L::CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  // a work item is 128 keys of one (sequence, head), taken by a persistent
  // block as in hopper_dq_kernel; K and V of the next item load into the
  // other parity's buffers
  const int n_kt = (T_len + L::KEYS - 1) / L::KEYS, n_items = n_kt * BH;
  const int nq = Tp / L::ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (warp == 4 * L::CONSUMERS) {  // producer: one thread issues every load
    if (lane == 0) {
      const long long plane = (long long)BH * Tp;
      Ring ring(L::STAGES);
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int bh = w / n_kt, k0 = (w - bh * n_kt) * L::KEYS, b = bh / H, h = bh - b * H, kb = it & 1;
        mbar_wait(&kv_empty[kb], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&kv_full[kb], 2 * L::CONSUMERS * L::TILE);
        for (int c = 0; c < L::CONSUMERS; ++c) {  // a tile wholly past T arrives as zeros
          tma_load_4d(k_tile(kb, c), &kmap, &kv_full[kb], 0, h, k0 + c * L::ROWS, b);
          tma_load_4d(v_tile(kb, c), &vmap, &kv_full[kb], 0, h, k0 + c * L::ROWS, b);
        }
        for (int i = 0; i < nq; ++i) {
          mbar_wait(&empty[ring.idx], ring.phase ^ 1);
          mbar_arrive_expect_tx(&full[ring.idx], L::KV_STAGE);
          unsigned char* st = stage(ring.idx);
          tma_load_4d(st, &qmap, &full[ring.idx], 0, h, i * L::ROWS, b);
          tma_load_4d(st + L::TILE, &domap, &full[ring.idx], 0, h, i * L::ROWS, b);
          float* rows = reinterpret_cast<float*>(st + 2 * L::TILE);
          const long long at = (long long)bh * Tp + i * L::ROWS;  // rows padded to Tp: no masking
          bulk_load(rows, row_m + at, L::ROW_BYTES, &full[ring.idx]);
          bulk_load(rows + L::ROWS, row_l + at, L::ROW_BYTES, &full[ring.idx]);
          bulk_load(rows + 2 * L::ROWS, rows_in + at, L::ROW_BYTES, &full[ring.idx]);
          bulk_load(rows + 3 * L::ROWS, rows_in + plane + at, L::ROW_BYTES, &full[ring.idx]);
          ring.advance();
        }
      }
    }
  } else {
    // consumer c owns keys k0 + 64 c .. k0 + 64 c + 63 of each item:
    // accumulator rows are keys, columns queries
    const int c = warp >> 2, wl = warp & 3, g = lane >> 2, x = lane & 3;
    Ring ring(L::STAGES);
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int bh = w / n_kt, k0 = (w - bh * n_kt) * L::KEYS, b = bh / H, h = bh - b * H, kb = it & 1;
      mbar_wait(&kv_full[kb], (it >> 1) & 1);
      const uint64_t kdesc = desc_kmajor(k_tile(kb, c)), vdesc = desc_kmajor(v_tile(kb, c));
      float dk_acc[32], dv_acc[32], s[32], dp[32];
      uint32_t pa[4][4], sa[4][4];
      for (int i = 0; i < nq; ++i) {
        mbar_wait(&full[ring.idx], ring.phase);
        unsigned char* st = stage(ring.idx);
        scores_ss(s, dp, kdesc, desc_kmajor(st), vdesc, desc_kmajor(st + L::TILE));
        mask_cols(s, i * L::ROWS, T_len, x);  // queries past T: p = 0
        const float* rows = reinterpret_cast<const float*>(st + 2 * L::TILE);
        // P^T and dS^T of the tile; a column's m, l, 1/l and D are a query row's
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int j = 2 * kk + hh, col = 8 * j + 2 * x;
            const float2 mm = *reinterpret_cast<const float2*>(rows + col);
            const float2 ll = *reinterpret_cast<const float2*>(rows + L::ROWS + col);
            const float2 rr = *reinterpret_cast<const float2*>(rows + 2 * L::ROWS + col);
            const float2 dd = *reinterpret_cast<const float2*>(rows + 3 * L::ROWS + col);
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
              const int r = 4 * j + 2 * ii;
              const float p0 = div_rn<true>(expf(s[r] - mm.x), ll.x, rr.x);
              const float p1 = div_rn<true>(expf(s[r + 1] - mm.y), ll.y, rr.y);
              pa[kk][2 * hh + ii] = pack_bf16(p0, p1);
              sa[kk][2 * hh + ii] = pack_bf16(p0 * (dp[r] - dd.x), p1 * (dp[r + 1] - dd.y));
            }
          }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          reg_fence(pa[kk]);
          reg_fence(sa[kk]);
        }
        const uint64_t qdesc_mn = desc_mnmajor(st), dodesc_mn = desc_mnmajor(st + L::TILE);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<1>(dv_acc, pa[kk], dodesc_mn + 128 * kk, i > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<1>(dk_acc, sa[kk], qdesc_mn + 128 * kk, i > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(dk_acc);
        reg_fence(dv_acc);
        if (lane == 0) mbar_arrive(&empty[ring.idx]);
        ring.advance();
      }
      if (lane == 0) mbar_arrive(&kv_empty[kb]);  // this item's K and V are read
      const int r0 = k0 + c * L::ROWS;
      const long long at = ((long long)b * T_len + r0) * ld_out + (long long)h * L::HD;
      store_tile_bf16(dk_acc, dk + at, ld_out, r0, T_len, wl, g, x);
      store_tile_bf16(dv_acc, dv + at, ld_out, r0, T_len, wl, g, x);
    }
  }
}

static int launch_bf16(const void* q, const void* k, const void* v, const void* dout, const void* row_m,
                       const void* row_l, const void* o32, void* dq, void* dk, void* dv, void* rows,
                       int B, int T_len, int Tp, int H, int ld_in, int ld_do, int ld_out,
                       cudaStream_t stream) {
  typedef HopperBwd L;
  if (row_m == nullptr || row_l == nullptr || o32 == nullptr) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  const void* bases[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    const int err = hopper::tma_map_heads(&maps[i], bases[i], B, T_len, H, i == 3 ? ld_do : ld_in);
    if (err) return err;
  }
  // once a device: the shared-memory attributes and the SM count (0 until
  // done, then -1, or the cudaError_t it met)
  static int setup[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    err = cudaFuncSetAttribute(hopper_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::DQ_SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(hopper_dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)L::KV_SMEM);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  if (setup[dev] > 0) return setup[dev];
  const long long dq_items = (long long)(Tp / L::ROWS) * B * H;
  const long long kv_items = (long long)((T_len + L::KEYS - 1) / L::KEYS) * B * H;
  if (dq_items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const long long dq_slots = (long long)L::DQ_BLOCKS_PER_SM * sms[dev];
  const float* m_ = static_cast<const float*>(row_m);
  const float* l_ = static_cast<const float*>(row_l);
  float* rows_ = static_cast<float*>(rows);
  hopper_dq_kernel<<<(int)(dq_items < dq_slots ? dq_items : dq_slots), L::DQ_THREADS, L::DQ_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(dout), static_cast<const float*>(o32), m_,
      l_, rows_, static_cast<bf16*>(dq), T_len, Tp, H, B * H, ld_do, ld_out);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  hopper_dkdv_kernel<<<(int)(kv_items < sms[dev] ? kv_items : sms[dev]), L::KV_THREADS, L::KV_SMEM, stream>>>(
      maps[0], maps[1], maps[2], maps[3], m_, l_, rows_, static_cast<bf16*>(dk), static_cast<bf16*>(dv), T_len,
      Tp, H, B * H, ld_out);
  return (int)cudaGetLastError();
}

}  // namespace gw

// q, k, v: row t of sequence b, head h starts at ptr + (b*T + t)*ld_in + h*64;
// dout with ld_do; dq, dk, dv (written) with ld_out. Head dim 64; the row
// strides multiples of 8 and the pointers 16-byte aligned. ld_state, the
// row stride of the per-row planes below, must be T rounded up to 64.
// row_m, row_l, o32: the forward's row state (gw_attention under K1 with
// its outputs requested). stats is a float32 scratch of 3 planes of B*H *
// ld_state values that the first launch writes for the second: 1/l and D
// of every row (the third plane is not used). dtype must be GW_BF16: the
// kernels take bfloat16 only, and any other value returns
// cudaErrorInvalidValue. Two launches on `stream`; returns a cudaError_t.
extern "C" int gw_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                const void* row_m, const void* row_l, const void* o32, void* dq, void* dk,
                                void* dv, void* stats, int B, int T_len, int H, int ld_in, int ld_do,
                                int ld_out, int ld_state, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || H <= 0 || ld_state != (T_len + 63) / 64 * 64 || dtype != GW_BF16)
    return (int)cudaErrorInvalidValue;
  return gw::launch_bf16(q, k, v, dout, row_m, row_l, o32, dq, dk, dv, stats, B, T_len, ld_state, H, ld_in,
                         ld_do, ld_out, s);
}
