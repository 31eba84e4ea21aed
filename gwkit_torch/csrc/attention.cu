// Kernel A: O = softmax(Q K^T) V per (sequence, head), q pre-scaled, head
// dim 64.
//
// Replaces: gwkit/ops/attention.py::_attn_kernel (K1) and the attention
// stage (per-head q_block loop) of gwkit/ops/fused_block.py::
// _attn_block_kernel (K3) / _attn_only_kernel (K4).
//
// Contract kept from the TPU kernels: scores in f32; keys at or beyond T
// masked; the EXACT row max. The launch argument `k1` picks which TPU
// kernel's softmax is reproduced:
//  * K3/K4 (k1 = 0, the fused layer): p = exp(round(s - m)) rounded to the
//    compute type, the f32 sum of the rounded p, p . V accumulated in f32
//    and the output divided by that sum (fused_block.py:167-170, :206-209);
//  * K1 (k1 = 1, attention.py:46-52): the f32 row sum l of exp(s - m), then
//    p = exp(s - m) / l (a true division) rounded to the compute type, p . V
//    accumulated in f32, the output cast with no division.
// Masking is by T itself: there is no padding of T to 128.
//
// Bound on the H100 (989 TFLOP/s bf16, 3.35 TB/s): at the main path's
// 256 sequences x 6 heads x T = 256 the work is 4 T^2 64 FLOPs a head
// (26 GFLOP, 0.026 ms) against q, k, v read and o written once (201 MB,
// 0.060 ms): bytes bound. At 64 x 6 x T = 1500 it is 221 GFLOP, 0.224 ms:
// operations bound, and the two passes below make the floor 1.5x that.
//
// bfloat16 (hopper_attention_kernel: the search, the int8 search and
// training): one persistent block on each SM, two consumer warpgroups and a
// producer warpgroup whose first thread issues every load. A work item is
// 128 query rows of one (sequence, head); each consumer warpgroup owns 64 of
// them. What the design does about the four limits of the first one (WMMA
// fragments, three shared-memory trips per key tile, two passes always,
// small blocks):
//  1. Products run on wgmma (hopper.cuh): S = Q K^T with Q and K read from
//     shared memory, O += P V with P in registers and V read MN-major.
//  2. Only the TMA tiles go through shared memory. The f32 scores stay in
//     the wgmma accumulator registers; the row max and sums are quad
//     shuffles; p is converted in place into wgmma A fragments; the output
//     is transposed across each quad by shuffles and stored with 16-byte
//     stores. There is no block barrier after the set-up: the warps meet
//     only at mbarriers.
//  3. For T <= 256 (every main path) one pass: the warpgroup's 64 x T f32
//     scores are held in 128 registers a thread (setmaxnreg gives the
//     consumers 232), so the exact max, the sums and p come from them with
//     nothing recomputed. For T > 256 two passes stream the key tiles
//     through the ring: pass 1 keeps the running exact max (and K1's online
//     f32 row sum) in registers, pass 2 recomputes each S tile and
//     accumulates P V. With the max exact, K3's p is the one-pass p bit for
//     bit; the extra Q K^T is the price. In both, S of tile i + 1 is in
//     flight while tile i is reduced. At T = 256 one pass takes 0.86x (K3)
//     and 0.73x (K1) of the two-pass path's device time on an H100
//     (scripts/torch_attention_passes.py builds with GW_TWO_PASS_ONLY).
//  4. Blocks are large and persistent: the producer keeps the next items'
//     Q and key tiles coming into a ring of 12 stages (K and V, 16 KB each)
//     while the consumers compute. Two items of a head run side by side on
//     two SMs, so K and V come from L2 the second time.
// The contract's arithmetic, at fewer instructions (the softmax, not the
// products, bounds this kernel):
//  * K3's exp(x) is ex2.approx(x log2 e): its argument is a bf16 value, and
//    for every bf16 x <= 0 the bf16-rounded result equals round(expf(x))
//    (gw_attention_exp_bf16 below lets chip_smoke.py check all 2^15), so p
//    is unchanged. Each pair of keys takes one packed conversion a rounding.
//  * K1's p = e / l divides by Markstein's correction of e (1 / l): the IEEE
//    quotient for every quotient in the normal range (div_rn; chip_smoke.py
//    holds gw_attention_div against the IEEE division). Every exp of K1,
//    the row sum's and p's, is expf, on both paths.
// q, k and v are read in place through 4-D tensor maps (64, H, T, B) over
// their row strides; rows at or beyond T arrive as zeros (keys are masked
// by index, query rows are not stored).
// Under K1 a caller may ask for the backward's row state (the training
// recompute does): each row's exact max m and f32 sum l and the f32 output
// before its rounding, stored from the epilogue's registers. Kernel D
// (attention_bwd.cu) reads them instead of recomputing them.
#include "common.cuh"
#include "hopper.cuh"

namespace gw {

using hopper::div_rn;
using hopper::mask_cols;
using hopper::quad_max;
using hopper::quad_sum;
using hopper::quad_transpose;

// ---- bfloat16: wgmma, TMA, scores in registers -------------------------------

struct HopperAttn {
  static constexpr int HD = 64, ROWS = 64, KEYS = 64;  // rows a warpgroup; keys a stage
  static constexpr int CONSUMERS = 2, ITEM_ROWS = CONSUMERS * ROWS;
  // + a producer warpgroup (setmaxnreg works on whole warpgroups): its first
  // thread issues the loads on 40 registers, the consumers get 232. The
  // three warpgroups share what the block was given, 3 x 168 (384 threads,
  // one block an SM), so 40 + 2 x 232 = 504 is all of it.
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232, BLOCK_REGS = 168;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr int STAGES = 12;  // three one-pass items
  static constexpr int ONE_PASS_MAX_T = 256;  // 4 key tiles: 128 score registers a thread
  static constexpr int MAX_TILES = ONE_PASS_MAX_T / KEYS;
  static constexpr uint32_t TILE = ROWS * HD * sizeof(bf16);  // 8 KB, one TMA box
  static constexpr size_t Q_OFF = 0;                            // [item parity][warpgroup]
  static constexpr size_t STAGE_OFF = Q_OFF + 2 * CONSUMERS * TILE;  // [stage]: K, then V
  static constexpr size_t BAR_OFF = STAGE_OFF + (size_t)STAGES * 2 * TILE;
  static constexpr int N_BARS = 4 + 2 * STAGES;  // q_full[2], q_empty[2], full[S], empty[S]
  static constexpr size_t SMEM = 1024 + BAR_OFF + N_BARS * sizeof(uint64_t);  // + alignment
  static constexpr uint32_t CONSUMER_WARPS = CONSUMERS * 4;
};

// the thread's max over its values of rows g (i = 0) and g + 8 (i = 1)
__device__ __forceinline__ void tile_max(const float (&s)[32], float (&mx)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) mx[i] = fmaxf(mx[i], fmaxf(s[4 * j + 2 * i], s[4 * j + 2 * i + 1]));
}

// exp(x) for a bf16 x <= 0: 2^(x log2 e) by one FMUL and ex2.approx (with
// subnormal results). Rounded to bf16 it is round(expf(x)) for every such
// x, all 2^15 of them (gw_attention_exp_bf16 below; chip_smoke.py checks
// it), so K3's p is what expf would give at a third of its instructions.
__device__ __forceinline__ float exp_bf16_arg(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// K3's p of one 64-key tile: p = round(exp(round(s - m))), summed into this
// thread's share of l (f32) and packed as the A fragments of the tile's four
// depth steps of 16 keys (accumulator blocks 2k and 2k + 1 make step k).
// Each pair of neighbouring keys is rounded by one packed conversion, twice,
// and the second is the fragment register itself.
__device__ __forceinline__ void p_k3(const float (&s)[32], const float (&m)[2], float (&l)[2],
                                     uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * (2 * kk + h) + 2 * i;
        const __nv_bfloat162 x = __floats2bfloat162_rn(s[r] - m[i], s[r + 1] - m[i]);
        const __nv_bfloat162 e = __floats2bfloat162_rn(exp_bf16_arg(__low2float(x)),
                                                       exp_bf16_arg(__high2float(x)));
        l[i] += __low2float(e);
        l[i] += __high2float(e);
        p[kk][2 * h + i] = *reinterpret_cast<const uint32_t*>(&e);
      }
}

// K1's e = expf(s - m) of one tile in place, summed into l when SUM
template <bool SUM>
__device__ __forceinline__ void exp_k1(float (&s)[32], const float (&m)[2], float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    s[r] = expf(s[r] - m[(r >> 1) & 1]);
    if (SUM) l[(r >> 1) & 1] += s[r];
  }
}

// K1's p of one tile from e = exp(s - m): p = round(e / l), packed as in p_k3.
__device__ __forceinline__ void p_k1(const float (&e)[32], const float (&l)[2], const float (&rl)[2],
                                     uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * (2 * kk + h) + 2 * i;
        p[kk][2 * h + i] =
            hopper::pack_bf16(div_rn<true>(e[r], l[i], rl[i]), div_rn<true>(e[r + 1], l[i], rl[i]));
      }
}

template <bool K1, bool ONE_PASS>
__global__ void __launch_bounds__(HopperAttn::THREADS, 1)
hopper_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int T_len,
                        int H, int n_qt, int n_items, int ld_out, float* __restrict__ row_m,
                        float* __restrict__ row_l, float* __restrict__ o32, int Tp) {
  typedef HopperAttn L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t *q_full = bars, *q_empty = bars + 2, *full = bars + 4, *empty = bars + 4 + L::STAGES;
  auto q_tile = [&](int qb, int wg) { return smem + L::Q_OFF + (size_t)(2 * qb + wg) * L::TILE; };
  auto k_tile = [&](int st) { return smem + L::STAGE_OFF + (size_t)st * 2 * L::TILE; };
  auto v_tile = [&](int st) { return smem + L::STAGE_OFF + (size_t)st * 2 * L::TILE + L::TILE; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], L::CONSUMER_WARPS);
    }
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // key tiles; two passes take an even count (a last tile past T is all
  // zeros and masked whole) so their S pipeline alternates two buffers
  // without a branch
  const int nt0 = (T_len + L::KEYS - 1) / L::KEYS;
  const int nt = ONE_PASS ? L::MAX_TILES : nt0 + (nt0 & 1);

  // the two roles are the two branches of one if, as setmaxnreg needs
  if (warp >= L::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == L::CONSUMER_WARPS && lane == 0) {
      Ring ring(L::STAGES);
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int bh = w / n_qt, qt = w - bh * n_qt, b = bh / H, h = bh - b * H;
        const int qb = it & 1;
        mbar_wait(&q_empty[qb], ((it >> 1) & 1) ^ 1);
        mbar_arrive_expect_tx(&q_full[qb], L::CONSUMERS * L::TILE);
        for (int c = 0; c < L::CONSUMERS; ++c)
          tma_load_4d(q_tile(qb, c), &qmap, &q_full[qb], 0, h, qt * L::ITEM_ROWS + c * L::ROWS, b);
        // one pass: the nt tiles with K and V; two passes: the nt K tiles,
        // then K and V
        for (int st = 0; st < (ONE_PASS ? nt : 2 * nt); ++st) {
          const int tile = ONE_PASS || st < nt ? st : st - nt;
          const bool with_v = ONE_PASS || st >= nt;
          mbar_wait(&empty[ring.idx], ring.phase ^ 1);
          mbar_arrive_expect_tx(&full[ring.idx], with_v ? 2 * L::TILE : L::TILE);
          tma_load_4d(k_tile(ring.idx), &kmap, &full[ring.idx], 0, h, tile * L::KEYS, b);
          if (with_v) tma_load_4d(v_tile(ring.idx), &vmap, &full[ring.idx], 0, h, tile * L::KEYS, b);
          ring.advance();
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, x = lane & 3;
    Ring ring(L::STAGES);
    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int bh = w / n_qt, qt = w - bh * n_qt, b = bh / H, h = bh - b * H;
      const int qb = it & 1;
      mbar_wait(&q_full[qb], (it >> 1) & 1);
      const uint64_t qdesc = desc_kmajor(q_tile(qb, wg));
      // o_acc: the output; m, l: the row max and sum; rl: 1 / l
      float o_acc[32], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, rl[2];

      if constexpr (ONE_PASS) {
        // the item's MAX_TILES tiles sit in stages ring.idx, ring.idx + 1, ...
        // (mod STAGES); tiles past T arrive as zeros and are masked whole
        int sidx[L::MAX_TILES];
#pragma unroll
        for (int c = 0; c < L::MAX_TILES; ++c) {
          sidx[c] = ring.idx + c < L::STAGES ? ring.idx + c : ring.idx + c - L::STAGES;
          mbar_wait(&full[sidx[c]], ring.phase ^ (ring.idx + c >= L::STAGES ? 1u : 0u));
        }
        // S in two groups of two tiles: the first pair is masked and reduced
        // while the second is multiplied
        float s[L::MAX_TILES][32];
        wgmma_fence();
#pragma unroll
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int c = 2 * half; c < 2 * half + 2; ++c)
              wgmma_m64n64k16_ss<0>(s[c], qdesc + 2 * kk, desc_kmajor(k_tile(sidx[c])) + 2 * kk, kk > 0);
          wgmma_commit();
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (half == 0)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
#pragma unroll
          for (int c = 2 * half; c < 2 * half + 2; ++c) {
            reg_fence(s[c]);
            mask_cols(s[c], c * L::KEYS, T_len, x);
            tile_max(s[c], m);
          }
        }
        if (lane == 0) mbar_arrive(&q_empty[qb]);
        m[0] = quad_max(m[0]);
        m[1] = quad_max(m[1]);

        uint32_t p[L::MAX_TILES][4][4];
        if constexpr (K1) {
#pragma unroll
          for (int c = 0; c < L::MAX_TILES; ++c) exp_k1<true>(s[c], m, l);
          l[0] = quad_sum(l[0]);
          l[1] = quad_sum(l[1]);
          rl[0] = __frcp_rn(l[0]);
          rl[1] = __frcp_rn(l[1]);
#pragma unroll
          for (int c = 0; c < L::MAX_TILES; ++c) p_k1(s[c], l, rl, p[c]);
        } else {
#pragma unroll
          for (int c = 0; c < L::MAX_TILES; ++c) p_k3(s[c], m, l, p[c]);
        }
#pragma unroll
        for (int c = 0; c < L::MAX_TILES; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) reg_fence(p[c][kk]);
        wgmma_fence();
#pragma unroll
        for (int c = 0; c < L::MAX_TILES; ++c)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs<1>(o_acc, p[c][kk], desc_mnmajor(v_tile(sidx[c])) + 128 * kk,
                                  c > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(o_acc);
#pragma unroll
        for (int c = 0; c < L::MAX_TILES; ++c) {
          if (lane == 0) mbar_arrive(&empty[ring.idx]);
          ring.advance();
        }
      } else {
        // Two S buffers: S of tile i + 1 is multiplied while tile i is reduced
        // (pass 1) or turned into p and multiplied by V (pass 2). The stream
        // of S products runs on from pass 1 into pass 2, so the last step of
        // pass 1 issues pass 2's first tile. `ring` is the stage of the oldest
        // tile not yet released, `ahead` the next whose K is multiplied.
        float sa[32], sb[32];
        uint32_t p[4][4];
        Ring ahead = ring;
        auto issue_s = [&](float (&acc)[32]) {
          mbar_wait(&full[ahead.idx], ahead.phase);
          const uint64_t kdesc = desc_kmajor(k_tile(ahead.idx));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(acc, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
          wgmma_commit();
          ahead.advance();
        };
        auto release = [&]() {
          if (lane == 0) mbar_arrive(&empty[ring.idx]);
          ring.advance();
        };
        // pass 1 on tile i, its S complete: the exact max (and K1's row sum)
        auto take1 = [&](float (&cur)[32], int i) {
          reg_fence(cur);
          release();
          mask_cols(cur, i * L::KEYS, T_len, x);
          float mx[2] = {-INFINITY, -INFINITY};
          tile_max(cur, mx);
#pragma unroll
          for (int ii = 0; ii < 2; ++ii) {
            const float m_new = fmaxf(m[ii], quad_max(mx[ii]));
            if constexpr (K1) {  // this thread's share of the f32 row sum, rescaled to the new max
              float sum = 0.f;
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                sum += expf(cur[4 * j + 2 * ii] - m_new);
                sum += expf(cur[4 * j + 2 * ii + 1] - m_new);
              }
              l[ii] = l[ii] * expf(m[ii] - m_new) + sum;
            }
            m[ii] = m_new;
          }
        };
        // pass 2 on tile i, its S and tile i - 1's P V complete: p, O += P V
        auto take2 = [&](float (&cur)[32], int i) {
          reg_fence(cur);
          if (i > 0) release();
          mask_cols(cur, i * L::KEYS, T_len, x);
          if constexpr (K1) {
            exp_k1<false>(cur, m, l);
            p_k1(cur, l, rl, p);
          } else {
            p_k3(cur, m, l, p);
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) reg_fence(p[kk]);
          const uint64_t vdesc = desc_mnmajor(v_tile(ring.idx));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs<1>(o_acc, p[kk], vdesc + 128 * kk, i > 0 || kk > 0);
          wgmma_commit();
        };

        issue_s(sa);
        for (int i = 0; i < nt; i += 2) {
          issue_s(sb);
          wgmma_wait<1>();
          take1(sa, i);
          issue_s(sa);  // at the last pair, pass 2's first tile
          wgmma_wait<1>();
          take1(sb, i + 1);
        }
        if constexpr (K1) {
          l[0] = quad_sum(l[0]);
          l[1] = quad_sum(l[1]);
          rl[0] = __frcp_rn(l[0]);
          rl[1] = __frcp_rn(l[1]);
        }
        for (int i = 0; i < nt - 2; i += 2) {
          issue_s(sb);
          wgmma_wait<1>();
          take2(sa, i);
          issue_s(sa);
          wgmma_wait<1>();
          take2(sb, i + 1);
        }
        issue_s(sb);
        wgmma_wait<1>();
        take2(sa, nt - 2);
        wgmma_wait<0>();
        take2(sb, nt - 1);
        wgmma_wait<0>();
        reg_fence(o_acc);
        release();
        if (lane == 0) mbar_arrive(&q_empty[qb]);
      }
      // epilogue: K3 divides by the f32 sum, K1 casts; each quad transposes
      // its row's words so a lane stores 16 contiguous bytes
      if constexpr (!K1) {
        l[0] = quad_sum(l[0]);
        l[1] = quad_sum(l[1]);
        rl[0] = __frcp_rn(l[0]);
        rl[1] = __frcp_rn(l[1]);
      }
      const int row0 = qt * L::ITEM_ROWS + wg * L::ROWS + wl * 16 + g;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        uint32_t wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float a = o_acc[4 * j + 2 * i], c = o_acc[4 * j + 2 * i + 1];
          wv[j] = K1 ? pack_bf16(a, c)
                     : pack_bf16(div_rn<false>(a, l[i], rl[i]), div_rn<false>(c, l[i], rl[i]));
        }
        const int t = row0 + 8 * i;
        if constexpr (K1) {
          if (o32 != nullptr) {  // the backward's row state (attention_bwd.cu)
            if (x == 0 && t < Tp) {
              row_m[(long long)bh * Tp + t] = m[i];
              row_l[(long long)bh * Tp + t] = l[i];
            }
            float* dst32 = o32 + (((long long)b * T_len + t) * H + h) * L::HD + 2 * x;
#pragma unroll
            for (int j = 0; j < 8; ++j)
              if (t < T_len)
                *reinterpret_cast<float2*>(dst32 + 8 * j) =
                    make_float2(o_acc[4 * j + 2 * i], o_acc[4 * j + 2 * i + 1]);
          }
        }
        bf16* dst = o + ((long long)b * T_len + t) * ld_out + (long long)h * L::HD;
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          uint32_t a4[4] = {wv[4 * grp], wv[4 * grp + 1], wv[4 * grp + 2], wv[4 * grp + 3]};
          quad_transpose(a4, x);
          if (t < T_len)
            *reinterpret_cast<uint4*>(dst + 8 * (4 * grp + x)) = make_uint4(a4[0], a4[1], a4[2], a4[3]);
        }
      }
    }
  }
}

template <bool K1, bool ONE_PASS>
static int launch_hopper(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                         void* o, int B, int T_len, int H, int ld_out, float* const (&state)[3],
                         int ld_state, cudaStream_t stream) {
  typedef HopperAttn L;
  auto kernel = hopper_attention_kernel<K1, ONE_PASS>;
  // once a device: the shared-memory attribute, the register check and the
  // SM count (0 until done, then -1, or the cudaError_t it met)
  static int setup[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    // setmaxnreg.inc waits for registers the producer gave back: a block
    // compiled with fewer than BLOCK_REGS a thread would wait forever
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs < L::BLOCK_REGS) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  if (setup[dev] > 0) return setup[dev];
  const int n_qt = (T_len + L::ITEM_ROWS - 1) / L::ITEM_ROWS;
  const long long items = (long long)B * H * n_qt;
  if (items > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(items < sms[dev] ? items : sms[dev]);
  kernel<<<grid, L::THREADS, L::SMEM, stream>>>(qm, km, vm, static_cast<bf16*>(o), T_len, H, n_qt,
                                                (int)items, ld_out, state[0], state[1], state[2], ld_state);
  return (int)cudaGetLastError();
}

// the tensor maps (64, H, T, B) of q, k and v over their row strides
static int encode_maps(CUtensorMap (&maps)[3], const void* q, const void* k, const void* v, int B,
                       int T_len, int H, int ld_in) {
  const void* bases[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const int err = hopper::tma_map_heads(&maps[i], bases[i], B, T_len, H, ld_in);
    if (err) return err;
  }
  return 0;
}

static int launch_bf16(const void* q, const void* k, const void* v, void* o, int B, int T_len,
                       int H, int ld_in, int ld_out, int k1, float* const (&state)[3], int ld_state,
                       cudaStream_t stream) {
  CUtensorMap maps[3];
  const int err = encode_maps(maps, q, k, v, B, T_len, H, ld_in);
  if (err) return err;
#ifdef GW_TWO_PASS_ONLY  // a comparison build: every T takes the two-pass path
  const bool one = false;
#else
  const bool one = T_len <= HopperAttn::ONE_PASS_MAX_T;
#endif
  if (k1)
    return one ? launch_hopper<true, true>(maps[0], maps[1], maps[2], o, B, T_len, H, ld_out, state, ld_state,
                                           stream)
               : launch_hopper<true, false>(maps[0], maps[1], maps[2], o, B, T_len, H, ld_out, state, ld_state,
                                            stream);
  return one ? launch_hopper<false, true>(maps[0], maps[1], maps[2], o, B, T_len, H, ld_out, state, ld_state,
                                          stream)
             : launch_hopper<false, false>(maps[0], maps[1], maps[2], o, B, T_len, H, ld_out, state, ld_state,
                                           stream);
}

// out[i] = round(exp(x)) in bf16 as K3's p takes it, x the bf16 with bits i
__global__ void exp_bf16_kernel(uint16_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536) {
    const float x = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
    out[i] = __bfloat16_as_ushort(__float2bfloat16(exp_bf16_arg(x)));
  }
}

// out[i] = a[i] / b[i] as K1's p divides, for 0 <= a <= 1 <= b
__global__ void div_kernel(const float* a, const float* b, float* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = div_rn<true>(a[i], b[i], __frcp_rn(b[i]));
}

}  // namespace gw

// K1's division on n pairs (f32 on the device), for comparison with the
// IEEE quotient. Returns a cudaError_t.
extern "C" int gw_attention_div(const void* a, const void* b, void* out, int n, void* stream) {
  gw::div_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

// The host work of the bf16 path before its launch: the three tensor maps,
// encoded n times (for timing). Returns a cudaError_t.
extern "C" int gw_attention_encode_maps(const void* q, const void* k, const void* v, int B, int T_len,
                                        int H, int ld_in, int n) {
  CUtensorMap maps[3];
  for (int i = 0; i < n; ++i) {
    const int err = gw::encode_maps(maps, q, k, v, B, T_len, H, ld_in);
    if (err) return err;
  }
  return 0;
}

// K3's exp on every bf16 input: out is 65536 uint16 on the device (bf16
// bits), for comparison with round(expf(x)). Returns a cudaError_t.
extern "C" int gw_attention_exp_bf16(void* out, void* stream) {
  gw::exp_bf16_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint16_t*>(out));
  return (int)cudaGetLastError();
}

// q, k, v: row t of sequence b, head h starts at ptr + (b*T + t)*ld_in + h*64
// (so (B, T, H, 64) contiguous tensors pass ld_in = H*64, and the fused QKV
// projection passes its three column blocks with ld_in = 3*H*64); o likewise
// with ld_out. Head dim 64; ld_in and ld_out multiples of 8 and the pointers
// 16-byte aligned. k1 = 1 takes K1's softmax contract, 0 K3's (see the top
// of this file). dtype must be GW_BF16: the kernel takes bfloat16 only, and
// any other value returns cudaErrorInvalidValue.
// row_m, row_l, o32: null, or (under K1 only) the row state the
// backward (attention_bwd.cu) reads instead of recomputing it: the exact
// row max and the f32 row sum, B*H x ld_state f32 each (ld_state, the
// caller's, must be T rounded up to 64; every row below it is written, rows
// past T of a zero query), and the f32 output before its rounding,
// (B, T, H, 64) contiguous. Values the kernel holds in registers anyway; the
// output's bits do not change. ld_state is ignored without the state.
// Returns a cudaError_t.
extern "C" int gw_attention(const void* q, const void* k, const void* v, void* o, void* row_m,
                            void* row_l, void* o32, int B, int T_len, int H, int ld_in, int ld_out,
                            int ld_state, int dtype, int k1, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || T_len <= 0 || H <= 0 || dtype != GW_BF16) return (int)cudaErrorInvalidValue;
  const bool save = row_m != nullptr || row_l != nullptr || o32 != nullptr;
  if (save && (row_m == nullptr || row_l == nullptr || o32 == nullptr || !k1 ||
               ld_state != (T_len + 63) / 64 * 64))
    return (int)cudaErrorInvalidValue;
  float* const state[3] = {static_cast<float*>(row_m), static_cast<float*>(row_l), static_cast<float*>(o32)};
  return gw::launch_bf16(q, k, v, o, B, T_len, H, ld_in, ld_out, k1, state, ld_state, s);
}
