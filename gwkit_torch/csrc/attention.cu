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
//     nothing recomputed. At T = 256 one pass takes 0.95x (K3) and 0.75x
//     (K1) of the two-pass path's device time on an H100
//     (scripts/torch_attention_passes.py builds with GW_TWO_PASS_ONLY).
//     For T > 256 two passes stream the key tiles through the ring: pass 1
//     keeps the exact max (and K1's online f32 row sum) in registers, pass 2
//     recomputes each S tile, forms p and accumulates P V. With the max
//     exact, K3's p is the one-pass p bit for bit, and O is never rescaled;
//     the extra Q K^T is the price. The two passes are one software
//     pipeline (two_pass_attention below), so that the tensor core never
//     waits for a tile's softmax:
//      - step i of an item's pass 2 issues three products: P V of tile
//        i - 1, S of tile i + 1 and S of the next item's tile i (its pass
//        1); then one wait retires the previous step's three (S of tile i,
//        the next item's S of tile i - 1, P V of tile i - 2), and while the
//        new three run the consumers form p of tile i and take the next
//        item's masked max of tile i - 1. Two buffers each of S, of p and of
//        the next item's S: 240 registers a consumer (setmaxnreg leaves the
//        producer thread 24). P V accumulates in the same order as one pass
//        would, so O keeps its bits;
//      - so each step queues about 384 tensor cycles a warpgroup around one
//        softmax, where pass 1 alone was a tensor-only stretch and pass 2
//        had MUFU as a co-limit. A block's first item runs its pass 1
//        alone; its last item's pass 2 multiplies a tile whose max it drops.
//        K1's pass 1 takes 32 expf a tile for its row sum: it runs alone
//        before each item's pass 2 (riding measured slower);
//      - a ring stage holds K and V of the item in pass 2 and K of the next
//        item (24 KB, 7 stages), so each K tile is read twice and each V
//        tile once, as before; Q has three slots (the item in pass 2, the
//        next, and one loading), so a slot is refilled an item ahead;
//      - the softmax's instructions, not the products, set the pace (on an
//        H100 a build of this path without its products took 0.74x the time
//        of one with them, and one without loads 0.97x): only the first and
//        last pairs of steps mask (a middle tile ends before T), each step is
//        one basic block, and K3's exp and bf16 widening take fewer
//        instructions (below).
//  4. Blocks are large and persistent: the producer keeps the next items'
//     Q and key tiles coming into the ring (one pass: 12 stages of K and V,
//     16 KB each) while the consumers compute. Two items of a head run side
//     by side on two SMs, so K and V come from L2 the second time.
// The contract's arithmetic, at fewer instructions (the softmax, not the
// products, bounds this kernel):
//  * K3's exp(x) is ex2.approx(x log2 e): its argument is a bf16 value, and
//    for every bf16 x <= 0 the bf16-rounded result equals round(expf(x))
//    (gw_attention_exp_bf16 below lets chip_smoke.py check all 2^15), so p
//    is unchanged. Each pair of keys takes one packed conversion a rounding.
//    The two-pass path takes (2^(x log2 e / 2))^2 (exp_bf16_sq), which
//    rounds to the same bf16 for all 2^15 (gw_attention_exp_bf16_sq) without
//    ex2.approx's test for a subnormal result.
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
  static constexpr int STAGES = 12;  // three one-pass items (the two-pass path: TwoPassAttn)
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

// The two-pass path's shared memory (design note 3): Q in three slots of an
// item's two 64-row tiles, and a ring of stages of three tiles: K and V of
// the item in pass 2 and K of the next item (in its pass 1). 1024 + 48 KB +
// 7 x 24 KB + the barriers: 222,368 bytes of the 232,448 a block may have.
struct TwoPassAttn {
  static constexpr int STAGES = 7, Q_SLOTS = 3;
  // the consumers hold two S, two p, two of the next item's S and O in
  // flight: 24 registers for the producer thread, 240 for them (504 = 3 x 168)
  static constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
  static_assert(PRODUCER_REGS + HopperAttn::CONSUMERS * CONSUMER_REGS <=
                    (HopperAttn::CONSUMERS + 1) * HopperAttn::BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t TILE = HopperAttn::TILE;
  static constexpr size_t K_OFF = 0, V_OFF = TILE, KN_OFF = 2 * TILE, STAGE_BYTES = 3 * TILE;
  static constexpr size_t Q_OFF = 0;  // [slot][warpgroup]
  static constexpr size_t STAGE_OFF = Q_OFF + (size_t)Q_SLOTS * HopperAttn::CONSUMERS * TILE;
  static constexpr size_t BAR_OFF = STAGE_OFF + (size_t)STAGES * STAGE_BYTES;
  static constexpr int N_BARS = 2 * Q_SLOTS + 2 * STAGES;  // q_full[Q], q_empty[Q], full[S], empty[S]
  static constexpr size_t SMEM = 1024 + BAR_OFF + N_BARS * sizeof(uint64_t);
  static_assert(SMEM <= 232448, "the two-pass ring exceeds a block's shared memory");
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

// exp(x) for a bf16 x <= 0 as the two-pass path takes it: (2^(y / 2))^2 for
// y = x log2 e, by one FMUL (by log2 e / 2, exact: the product is the FMUL's
// y halved), ex2.approx.ftz and one FMUL. 2^(y / 2) is normal for every
// y >= -252, so the square is the subnormal handling that ex2.approx takes
// a test and two predicated multiplies for. Rounded to bf16 it is
// round(expf(x)) for every such x, all 2^15 of them, as exp_bf16_arg is
// (gw_attention_exp_bf16_sq below; chip_smoke.py checks both): p keeps its
// bits at three instructions an exp instead of five.
__device__ __forceinline__ float exp_bf16_sq(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(__fmul_rn(x, 0.7213475204444817f)));
  return __fmul_rn(y, y);
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

// p_k3 for the two-pass pipeline, the same bits at fewer instructions: the
// exp is exp_bf16_sq, and each bf16 of a pair widens to f32 by one integer
// instruction (u << 16, or u & 0xffff0000 for the high half) where
// __high2float takes two.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ void p_k3_two_pass(const float (&s)[32], const float (&m)[2], float (&l)[2],
                                              uint32_t (&p)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 4 * (2 * kk + h) + 2 * i;
        const uint32_t x = hopper::pack_bf16(s[r] - m[i], s[r + 1] - m[i]);
        const uint32_t e = hopper::pack_bf16(exp_bf16_sq(bf16_lo(x)), exp_bf16_sq(bf16_hi(x)));
        l[i] += bf16_lo(e);
        l[i] += bf16_hi(e);
        p[kk][2 * h + i] = e;
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

// The two-pass path's epilogue of an item (sequence b, head h, query tile
// qt), for one consumer warpgroup: K3 divides by the f32 sum, K1 casts (and
// stores the backward's row state when asked); each quad transposes its
// row's words so a lane stores 16 contiguous bytes. The one-pass path's
// epilogue in the kernel below is the same code: called from there as a
// function it compiled to other SASS, and that path is kept as it was.
template <bool K1>
__device__ __forceinline__ void store_item(const float (&o_acc)[32], const float (&m)[2], float (&l)[2],
                                           float (&rl)[2], bf16* __restrict__ o, int T_len, int H, int ld_out,
                                           float* __restrict__ row_m, float* __restrict__ row_l,
                                           float* __restrict__ o32, int Tp, int bh, int qt, int b, int h, int wg,
                                           int wl, int g, int x) {
  typedef HopperAttn L;
  using namespace hopper;
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

// T > 256: two passes as one software pipeline (design note 3). RIDE (K3):
// the next item's pass 1 rides in this item's pass 2; else (K1) each item
// runs its pass 1 alone, then its pass 2.
template <bool K1>
__device__ __forceinline__ void two_pass_attention(const CUtensorMap& qmap, const CUtensorMap& kmap,
                                                   const CUtensorMap& vmap, bf16* __restrict__ o, int T_len, int H,
                                                   int n_qt, int n_items, int ld_out, float* __restrict__ row_m,
                                                   float* __restrict__ row_l, float* __restrict__ o32, int Tp) {
  typedef HopperAttn A;
  typedef TwoPassAttn L;
  using namespace hopper;
  constexpr bool RIDE = !K1;  // K1's pass 1 takes 32 expf a tile: riding measured slower
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t *q_full = bars, *q_empty = bars + L::Q_SLOTS, *full = bars + 2 * L::Q_SLOTS,
           *empty = bars + 2 * L::Q_SLOTS + L::STAGES;
  auto q_tile = [&](int slot, int wg) { return smem + L::Q_OFF + (size_t)(A::CONSUMERS * slot + wg) * L::TILE; };
  auto stage = [&](int st) { return smem + L::STAGE_OFF + (size_t)st * L::STAGE_BYTES; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::Q_SLOTS; ++i) {
      mbar_init(&q_full[i], 1);
      mbar_init(&q_empty[i], A::CONSUMER_WARPS);
    }
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], A::CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // key tiles: an even count, so the pipeline alternates its two S and two p
  // buffers without a branch (a last tile past T is all zeros and masked
  // whole), and at least 4, as the pipeline peels its first and last pairs
  const int nt0 = (T_len + A::KEYS - 1) / A::KEYS;
  const int nt = nt0 < 4 ? 4 : nt0 + (nt0 & 1);

  // the two roles are the two branches of one if, as setmaxnreg needs
  if (warp >= A::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == A::CONSUMER_WARPS && lane == 0) {
      Ring ring(L::STAGES), qs(L::Q_SLOTS);
      auto load_q = [&](int w) {
        const int bh = w / n_qt, qt = w - bh * n_qt, b = bh / H, h = bh - b * H;
        mbar_wait(&q_empty[qs.idx], qs.phase ^ 1);
        mbar_arrive_expect_tx(&q_full[qs.idx], A::CONSUMERS * L::TILE);
        for (int c = 0; c < A::CONSUMERS; ++c)
          tma_load_4d(q_tile(qs.idx, c), &qmap, &q_full[qs.idx], 0, h, qt * A::ITEM_ROWS + c * A::ROWS, b);
        qs.advance();
      };
      // the nt stages of a pass, tile by tile: K and V of item w (none for
      // w < 0) and K of item wn (none for wn < 0)
      auto load_pass = [&](int w, int wn) {
        const int b = w / n_qt / H, h = w / n_qt - b * H, bn = wn / n_qt / H, hn = wn / n_qt - bn * H;
        const uint32_t bytes = ((w >= 0 ? 2u : 0u) + (wn >= 0 ? 1u : 0u)) * L::TILE;
        for (int tile = 0; tile < nt; ++tile) {
          mbar_wait(&empty[ring.idx], ring.phase ^ 1);
          mbar_arrive_expect_tx(&full[ring.idx], bytes);
          unsigned char* st = stage(ring.idx);
          if (w >= 0) {
            tma_load_4d(st + L::K_OFF, &kmap, &full[ring.idx], 0, h, tile * A::KEYS, b);
            tma_load_4d(st + L::V_OFF, &vmap, &full[ring.idx], 0, h, tile * A::KEYS, b);
          }
          if (wn >= 0) tma_load_4d(st + L::KN_OFF, &kmap, &full[ring.idx], 0, hn, tile * A::KEYS, bn);
          ring.advance();
        }
      };
      int it = 0;
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int wn = RIDE && w + (int)gridDim.x < n_items ? w + (int)gridDim.x : -1;
        if (!RIDE || it == 0) {  // pass 1 alone
          load_q(w);
          load_pass(-1, w);
        }
        if (wn >= 0) load_q(wn);
        load_pass(w, wn);  // pass 2, and the next item's pass 1
      }
    }
  } else {
    // consumers: warpgroup wg owns rows 64 wg .. 64 wg + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    // wg through a shuffle, so the compiler knows it (and the Q descriptors)
    // to be warp-uniform and keeps them in uniform registers
    const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0), wl = warp & 3, g = lane >> 2, x = lane & 3;
    // ring: the oldest stage not released; ahead: the stage whose K the
    // next S product of this item reads; at and prev: the stages of tiles i
    // and i - 1 in pass 2's step i; qs: this item's Q slot
    Ring ring(L::STAGES), ahead(L::STAGES), at(L::STAGES), qs(L::Q_SLOTS);
    int prev = 0;
    // o_acc: the output; s: S of tiles i and i + 1; t: the next item's S of
    // tiles i - 1 and i; p: p of tiles i and i - 1 (the latter in its P V)
    float o_acc[32], s[2][32], t[2][32];
    uint32_t p[2][4][4];
    // m, l: the row max and sum (K1: the f32 sum of exp(s - m), from pass 1;
    // K3: the f32 sum of the rounded p, in pass 2); rl: 1 / l; mn, ln: the
    // next item's, built in its pass 1
    float m[2], l[2], rl[2], mn[2], ln[2];
    uint64_t qdesc = 0, qn_desc = 0;
    bool ride = false;  // a next item rides in this item's pass 2

    auto release = [&]() {
      if (lane == 0) mbar_arrive(&empty[ring.idx]);
      ring.advance();
    };
    // S of this item's tile in stage `ahead`, from the K tile at `slot`
    auto issue_s = [&](float (&acc)[32], size_t slot) {
      mbar_wait(&full[ahead.idx], ahead.phase);
      const uint64_t kdesc = desc_kmajor(stage(ahead.idx) + slot);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(acc, qdesc + 2 * kk, kdesc + 2 * kk, kk > 0);
      wgmma_commit();
      ahead.advance();
    };
    // pass 1 on tile i, its S complete: the masked max into mm (K1: with
    // the f32 row sum ll, rescaled to each new max of the quad, in place;
    // K3: this thread's share, the quad's max taken once the pass ends)
    auto take1 = [&](float (&cur)[32], int i, float (&mm)[2], float (&ll)[2], bool mask) {
      reg_fence(cur);
      if (mask) mask_cols(cur, i * A::KEYS, T_len, x);
      if constexpr (K1) {
        float mx[2] = {-INFINITY, -INFINITY};
        tile_max(cur, mx);
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          const float m_new = fmaxf(mm[ii], quad_max(mx[ii]));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            sum += expf(cur[4 * j + 2 * ii] - m_new);
            sum += expf(cur[4 * j + 2 * ii + 1] - m_new);
          }
          ll[ii] = ll[ii] * expf(mm[ii] - m_new) + sum;
          mm[ii] = m_new;
        }
      } else {
        tile_max(cur, mm);
        reg_fence(mm);  // the max taken here, before the next product into cur
      }
    };
    // pass 2 on tile i, its S complete: p into pc (K3: summed into l)
    auto take2 = [&](float (&cur)[32], int i, uint32_t (&pc)[4][4], bool mask) {
      reg_fence(cur);
      if (mask) mask_cols(cur, i * A::KEYS, T_len, x);
      if constexpr (K1) {
        exp_k1<false>(cur, m, l);
        p_k1(cur, l, rl, pc);
      } else {
        p_k3_two_pass(cur, m, l, pc);
        reg_fence(l);  // the sum taken here, as take1's max
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) reg_fence(pc[kk]);
    };
    // pass 2's step i: issue P V of tile i - 1 (pv), S of tile i + 1 (more)
    // and the next item's S of tile i into tn (without a next item, of this
    // item's tile, its max unused); retire the previous step's products: S of
    // tile i, the next item's S of tile i - 1 (in tp) and P V of tile i - 2;
    // release tile i - 2's stage (rel); then, while the three run, form p of
    // tile i and take the next item's max of tile i - 1 (take). One wait a
    // step, right after the products it lets run. cur, nxt: S of tiles i and
    // i + 1; pc, pp: p of tiles i and i - 1. Without RIDE only P V and S are
    // issued. mask: tiles i and i - 1 may reach past T (in the first and last
    // pairs of steps only: a middle tile i <= nt - 3 <= nt0 - 2 ends before T).
    auto step = [&](float (&cur)[32], float (&nxt)[32], float (&tp)[32], float (&tn)[32], uint32_t (&pc)[4][4],
                    uint32_t (&pp)[4][4], int i, bool pv, bool rel, bool more, bool take, bool mask) {
      wgmma_fence();
      if (pv) {
        const uint64_t vdesc = desc_mnmajor(stage(prev) + L::V_OFF);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<1>(o_acc, pp[kk], vdesc + 128 * kk, i > 1 || kk > 0);
      }
      wgmma_commit();
      if (more)
        issue_s(nxt, L::K_OFF);
      else
        wgmma_commit();
      if constexpr (RIDE) {
        const uint64_t kdesc = desc_kmajor(stage(at.idx) + (ride ? L::KN_OFF : L::K_OFF));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_ss<0>(tn, qn_desc + 2 * kk, kdesc + 2 * kk, kk > 0);
        wgmma_commit();
        wgmma_wait<3>();
      } else {
        wgmma_wait<2>();
      }
      if (rel) release();
      take2(cur, i, pc, mask);
      if constexpr (RIDE)
        if (take) take1(tp, i - 1, mn, ln, mask);
      prev = at.idx;
      at.advance();
    };

    int it = 0;
    for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
      const int bh = w / n_qt, qt = w - bh * n_qt, b = bh / H, h = bh - b * H;
      ride = RIDE && w + (int)gridDim.x < n_items;
      mbar_wait(&q_full[qs.idx], qs.phase);
      qdesc = desc_kmajor(q_tile(qs.idx, wg));
      if (!RIDE || it == 0) {
        // pass 1 alone, S of tile i + 1 multiplied while tile i is reduced;
        // its last product is pass 2's first
        m[0] = m[1] = -INFINITY;
        l[0] = l[1] = 0.f;
        issue_s(s[0], L::KN_OFF);
        for (int i = 0; i < nt; i += 2) {
          issue_s(s[1], L::KN_OFF);
          wgmma_wait<1>();
          take1(s[0], i, m, l, true);
          release();
          issue_s(s[0], i + 2 < nt ? L::KN_OFF : L::K_OFF);
          wgmma_wait<1>();
          take1(s[1], i + 1, m, l, true);
          release();
        }
      } else {  // pass 1 rode in the last item's pass 2
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
          m[ii] = mn[ii];
          l[ii] = ln[ii];
        }
        issue_s(s[0], L::K_OFF);
      }
      // the next item's Q (loaded after this item's pass 1 alone, if any)
      Ring qn = qs;
      qn.advance();
      if (ride) mbar_wait(&q_full[qn.idx], qn.phase);
      qn_desc = ride ? desc_kmajor(q_tile(qn.idx, wg)) : qdesc;
#pragma unroll
      for (int ii = 0; ii < 2; ++ii) {
        if constexpr (K1) {
          l[ii] = quad_sum(l[ii]);
          rl[ii] = __frcp_rn(l[ii]);
        } else {
          m[ii] = quad_max(m[ii]);
          l[ii] = 0.f;
        }
        mn[ii] = -INFINITY;
        ln[ii] = 0.f;
      }

      // pass 2, S of tile 0 in flight
      at = ring;
      step(s[0], s[1], t[1], t[0], p[0], p[1], 0, false, false, true, false, true);
      step(s[1], s[0], t[0], t[1], p[1], p[0], 1, true, false, true, true, true);
      for (int i = 2; i < nt - 2; i += 2) {
        step(s[0], s[1], t[1], t[0], p[0], p[1], i, true, true, true, true, false);
        step(s[1], s[0], t[0], t[1], p[1], p[0], i + 1, true, true, true, true, false);
      }
      step(s[0], s[1], t[1], t[0], p[0], p[1], nt - 2, true, true, true, true, true);
      step(s[1], s[0], t[0], t[1], p[1], p[0], nt - 1, true, true, false, true, true);
      // P V of the last tile, then every product of the item is complete
      wgmma_fence();
      const uint64_t vdesc = desc_mnmajor(stage(prev) + L::V_OFF);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_m64n64k16_rs<1>(o_acc, p[1][kk], vdesc + 128 * kk, 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(o_acc);
      if constexpr (RIDE) take1(t[1], nt - 1, mn, ln, true);
      release();
      release();
      if (lane == 0) mbar_arrive(&q_empty[qs.idx]);
      qs.advance();
      store_item<K1>(o_acc, m, l, rl, o, T_len, H, ld_out, row_m, row_l, o32, Tp, bh, qt, b, h, wg, wl, g, x);
    }
  }
}

template <bool K1, bool ONE_PASS>
__global__ void __launch_bounds__(HopperAttn::THREADS, 1)
hopper_attention_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int T_len,
                        int H, int n_qt, int n_items, int ld_out, float* __restrict__ row_m,
                        float* __restrict__ row_l, float* __restrict__ o32, int Tp) {
  if constexpr (!ONE_PASS) {
    two_pass_attention<K1>(qmap, kmap, vmap, o, T_len, H, n_qt, n_items, ld_out, row_m, row_l, o32, Tp);
  } else {
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
}

template <bool K1, bool ONE_PASS>
static int launch_hopper(const CUtensorMap& qm, const CUtensorMap& km, const CUtensorMap& vm,
                         void* o, int B, int T_len, int H, int ld_out, float* const (&state)[3],
                         int ld_state, cudaStream_t stream) {
  typedef HopperAttn L;
  constexpr size_t smem = ONE_PASS ? L::SMEM : TwoPassAttn::SMEM;
  auto kernel = hopper_attention_kernel<K1, ONE_PASS>;
  // once a device: the shared-memory attribute, the register check and the
  // SM count (0 until done, then -1, or the cudaError_t it met)
  static int setup[64] = {}, sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  kernel<<<grid, L::THREADS, smem, stream>>>(qm, km, vm, static_cast<bf16*>(o), T_len, H, n_qt,
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

// the same as the two-pass path takes it
__global__ void exp_bf16_sq_kernel(uint16_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < 65536) {
    const float x = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
    out[i] = __bfloat16_as_ushort(__float2bfloat16(exp_bf16_sq(x)));
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

// The same for the two-pass path's exp (exp_bf16_sq). Returns a cudaError_t.
extern "C" int gw_attention_exp_bf16_sq(void* out, void* stream) {
  gw::exp_bf16_sq_kernel<<<256, 256, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<uint16_t*>(out));
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
