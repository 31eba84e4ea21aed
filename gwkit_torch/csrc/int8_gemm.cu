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
// launches; fc1's launch hands each row's maximum over to fc2's, so fc2
// reads its input once.
//
// bfloat16 (hopper_int8_gemm_kernel: the search and serving): one persistent
// block on each SM, two consumer warpgroups and a producer warpgroup whose
// first thread issues every load (setmaxnreg 40/232, as kernel B). The
// weight is read K-major, as W^T (N, K) int8 (`wt`): 8-bit wgmma has no
// transpose. W^T streams through a ring of 128 x 128-byte slices (16 KB:
// 128 output columns x 128 of depth, four k32 steps), which clusters of two
// blocks fill by multicast, each block loading half of a slice. A block
// quantizes a panel of rows once into an int8, K-major, 128-byte-swizzled
// panel in shared memory and then walks every 128-column tile of N over it,
// so x is read from device memory once. Two modes:
//  * panel (K <= 512: QKV, o, fc1): a 128-row panel, consumer c owning rows
//    64c..64c+63. The producer loads the bf16 rows by TMA (K/64 boxes of
//    64 x 64 a warpgroup); each warp normalizes its rows in place
//    (ln_rows_sw128, kernel B's LayerNorm) if asked, takes each row's
//    maximum, and writes the row, quantized, over its own bf16 atoms (int8
//    atom a of a row sits where bf16 atom a of the row was, read before).
//    Products m64n128k32. Optionally each row's max |y| goes out (fc1: the
//    block sees all N of its rows), an (M,) f32 vector.
//  * stream (fc2, K <= 2048, with each row's maximum handed over): a
//    64-row panel shared by both consumers, consumer c computing columns
//    64c..64c+63 of each tile (m64n64k32). The bf16 rows come in through
//    the same ring in 128-column chunks and are quantized chunk by chunk
//    with the scale from the handed-over maximum, so no bf16 panel is
//    held: at K = 2048 the int8 panel alone is 128 KB.
// Shared memory (1024-aligned): barriers and the rows' scales (1 KB) |
// output tiles, one a consumer (panel: 64 x 128 bf16, 16 KB; stream:
// 64 x 64, 8 KB) | the panel (panel: 2 x K/64 bf16 atoms of 8 KB, 96 KB at
// K = 384, 128 KB at 512; stream: K/128 int8 atoms of 64 x 128 bytes, 96 KB
// at K = 1536, 128 KB at 2048) | the ring, as many 16 KB stages as fit up
// to 8 (6 at K = 384, 4 at 512; 7 at 1536, 5 at 2048).
// Epilogue: the residual tile arrives by TMA in the consumer's output tile;
// dequantization, bias, rounding, GELU or the residual run on the
// accumulator registers; the result goes back to the tile and out by a TMA
// store, which completes while the next tile's products run. The
// epilogue's kind (none, GELU, residual) is a template argument, so each
// mode has three kernels, each with one compact epilogue; GELU is a lookup
// of its bf16 result in a table the same gelu() fills (gelu_table). The
// quantization uses no division and no conversion instruction in its loop
// (quantize8). Rows past M load as zeros (or are not loaded), are quantized
// with whatever scale and are never stored: the store clips at M. N is a
// multiple of 128.
#include "common.cuh"
#include "hopper.cuh"

#ifndef GW_INT8_CLUSTER  // a comparison build may set another cluster size (1 or 2)
#define GW_INT8_CLUSTER 2
#endif

namespace gw {

typedef signed char i8;

// ---- bfloat16: s8 wgmma, TMA, the row panel quantized once on chip ------------

struct HopperI8 {
  static constexpr int CONSUMERS = 2, BN = 128, BK = 128;  // a W^T slice: 128 columns x 128 bytes of depth
  static constexpr int CLUSTER = GW_INT8_CLUSTER;  // blocks sharing each W^T slice by multicast
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232, BLOCK_REGS = 168;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t CONSUMER_WARPS = CONSUMERS * 4;
  // 8 KB: 64 rows x 128 bytes, a bf16 box of 64 x 64 or an int8 atom of 64 x 128
  static constexpr uint32_t ATOM = 64 * 128;
  static constexpr uint32_t STAGE = 2 * ATOM;  // a W^T slice, or 64 rows x 128 bf16 columns of x
  static constexpr int MAX_STAGES = 8, PANEL_MAX_K = 512, STREAM_MAX_K = 2048;
  static constexpr size_t BAR_BYTES = 1024, SX_OFF = 512;  // barriers, then 128 row scales
  static constexpr size_t SMEM_LIMIT = 232448;             // the most a block may have on the H100
  static __host__ __device__ constexpr int panel_rows(bool stream) { return stream ? 64 : 128; }
  static __host__ __device__ constexpr int cols(bool stream) { return stream ? 64 : 128; }  // a consumer's, of a tile
  static __host__ __device__ constexpr uint32_t out_tile(bool stream) { return cols(stream) / 64 * ATOM; }
  static __host__ __device__ size_t panel_off(bool stream) { return BAR_BYTES + CONSUMERS * out_tile(stream); }
  static __host__ __device__ size_t ring_off(bool stream, int K) {
    return panel_off(stream) + (stream ? (size_t)(K / BK) : (size_t)CONSUMERS * (K / 64)) * ATOM;
  }
  static int stages(bool stream, int K) {
    const long n = ((long)SMEM_LIMIT - 1024 - (long)ring_off(stream, K)) / STAGE;  // 1024: alignment slack
    return n < MAX_STAGES ? (int)n : MAX_STAGES;
  }
  static size_t smem(bool stream, int K) { return 1024 + ring_off(stream, K) + (size_t)stages(stream, K) * STAGE; }
};
static_assert((4 + 2 * HopperI8::MAX_STAGES) * sizeof(uint64_t) <= HopperI8::SX_OFF, "barriers");
static_assert(HopperI8::SX_OFF + 128 * sizeof(float) <= HopperI8::BAR_BYTES, "row scales");

// GELU of every bf16 input, rounded to bf16, by the same gelu() as kernels
// B and C ([0] tanh, [1] erf): the epilogue's input is a bf16 value and its
// output is rounded to bf16, so a lookup gives the same bits (64 inlined
// copies of tanhf and erff made the epilogue's code outgrow the instruction
// cache, and slowed even the launches without GELU). Filled once a device;
// the entries in use stay in L1.
__device__ uint16_t gelu_table[2][65536];

__global__ void gelu_table_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float h = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
#pragma unroll
  for (int t = 0; t < 2; ++t) gelu_table[t][i] = __bfloat16_as_ushort(__float2bfloat16(gelu(h, t == 0)));
}

// GELU of a bf16 pair through gelu_table (act 1 tanh, 2 erf)
__device__ __forceinline__ __nv_bfloat162 gelu_bf16x2(__nv_bfloat162 h, int act) {
  const uint32_t bits = *reinterpret_cast<const uint32_t*>(&h);
  const uint16_t* tab = gelu_table[act - 1];
  const uint32_t o = (uint32_t)__ldg(tab + (bits & 0xffffu)) | ((uint32_t)__ldg(tab + (bits >> 16)) << 16);
  return *reinterpret_cast<const __nv_bfloat162*>(&o);
}

// v[8] = the bf16 values of a 16-byte chunk
__device__ __forceinline__ void unpack_bf16x8(uint4 raw, float (&v)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[2 * e] = __low2float(h[e]);
    v[2 * e + 1] = __high2float(h[e]);
  }
}
// clip(rint(v / sx), +-127) of 8 values as 8 int8, v / sx the IEEE
// quotient and rint rounding half to even, given r = 1 / sx correctly
// rounded, branch-free and with no conversion instruction (those issue at
// an eighth of the FP32 rate and bounded this pass):
//  * the quotient: Markstein's correction q1 = q0 + (v - q0 sx) r of
//    q0 = v r, the remainder exact by FMA, is the correctly rounded
//    quotient wherever the remainder does not underflow, i.e. wherever
//    |v / sx| >= 2^-100 (kernel A's div_rn rests on the same theorem);
//    smaller quotients round to 0 either way. |v| <= 127 sx (1 + 2^-23)
//    holds for a row's own maximum, so nothing overflows. gw_int8_quantize
//    holds this against the IEEE division (chip_smoke.py);
//  * rint: adding 1.5 x 2^23 to |q| <= 127 rounds q to an integer, half to
//    even (the add's own rounding), and leaves it in the sum's low byte.
// (Checking the product v r for a near tie instead, with the division as
// a fallback, was several times slower: bf16 inputs put v / sx at or near
// k + 1/2 often, e.g. v = amax / 2.)
constexpr float RINT_MAGIC = 12582912.0f;
__device__ __forceinline__ uint32_t rint_bits(float q) {  // q clipped to +-127, + RINT_MAGIC, as bits
  return __float_as_uint(__fadd_rn(fminf(fmaxf(q, -127.f), 127.f), RINT_MAGIC));
}
// the low bytes of four words as one word
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t b0, uint32_t b1, uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040), 0x5410);
}
__device__ __forceinline__ uint2 quantize8(const float (&v)[8], float sx, float r) {
  uint32_t b[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float q0 = __fmul_rn(v[e], r);
    b[e] = rint_bits(__fmaf_rn(__fmaf_rn(-q0, sx, v[e]), r, q0));
  }
  return make_uint2(pack_low_bytes(b[0], b[1], b[2], b[3]), pack_low_bytes(b[4], b[5], b[6], b[7]));
}
// a row's scale from its maximum, as gwkit's (a true division), and its reciprocal
__device__ __forceinline__ float row_scale(float amax) { return fmaxf(amax, 1e-6f) / 127.f; }

// Panel mode: the rows r_begin, r_begin + r_step, ... < r_end of a consumer's
// K-wide bf16 panel (K / 64 atoms ATOM apart, element (r, c) at sw128(r, c)),
// each quantized by one warp and written over itself as K / 128 int8 atoms
// (int8 atom a at bf16 atom a's place; byte c at sw128_byte(r, c)); sx[r]
// its scale. Lane l takes the 16-byte chunks l and l + 32 (K <= 512); a warp
// takes ROWS rows at a time, so their reductions overlap; a row's reads all
// precede the writes over it.
template <int ROWS>
__device__ __forceinline__ void quantize_panel_rows(unsigned char* panel, int r_begin, int r_step, int r_end, int K,
                                                    float* sx, int lane) {
  const int nq = K >> 3;
  for (int r0 = r_begin; r0 < r_end; r0 += ROWS * r_step) {
    float v[ROWS][2][8], amax[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * r_step;
      amax[u] = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int q = lane + 32 * t;
        const uint4 raw = q < nq && r < r_end
                              ? *reinterpret_cast<const uint4*>(panel + (q >> 3) * HopperI8::ATOM + hopper::sw128(r, 8 * (q & 7)))
                              : make_uint4(0, 0, 0, 0);
        unpack_bf16x8(raw, v[u][t]);
#pragma unroll
        for (int e = 0; e < 8; ++e) amax[u] = fmaxf(amax[u], fabsf(v[u][t][e]));
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < ROWS; ++u) amax[u] = fmaxf(amax[u], __shfl_xor_sync(0xffffffffu, amax[u], o));
    __syncwarp();  // every lane has read the rows
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const int r = r0 + u * r_step;
      if (r >= r_end) continue;
      const float s = row_scale(amax[u]), rs = 1.f / s;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int q = lane + 32 * t;
        if (q < nq)
          *reinterpret_cast<uint2*>(panel + (q >> 4) * HopperI8::ATOM + hopper::sw128_byte(r, 8 * (q & 15))) =
              quantize8(v[u][t], s, rs);
      }
      if (lane == 0) sx[r] = s;
    }
  }
}

// Stream mode: one 64-row x 128-column chunk of x (two bf16 boxes of 64 x 64
// at `chunk`) quantized with the rows' scales sx into the int8 atom `dst`
// (64 x 128 bytes); warp w of the 8 takes rows w, w + 8, ..., half a warp a
// row (lane & 15 is the 16-byte chunk).
__device__ __forceinline__ void quantize_chunk(const unsigned char* chunk, unsigned char* dst, const float* sx,
                                               const float* rsx, int warp, int lane) {
  const int q = lane & 15;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r = warp + 8 * (2 * k + (lane >> 4));
    float v[8];
    unpack_bf16x8(*reinterpret_cast<const uint4*>(chunk + (q >> 3) * HopperI8::ATOM + hopper::sw128(r, 8 * (q & 7))), v);
    *reinterpret_cast<uint2*>(dst + hopper::sw128_byte(r, 8 * q)) = quantize8(v, sx[r], rsx[r]);
  }
}

// The epilogue after dequantization and rounding: nothing, GELU, or + the
// residual. A template argument, so each kernel carries one compact
// epilogue with no branch per value.
enum Epilogue { EPI_NONE = 0, EPI_GELU = 1, EPI_RESIDUAL = 2 };

// STREAM: see the note at the top. amax_in (M,): each row's max |x| (stream
// mode); amax_out (M,) or null: each row's max |y| (panel mode); act 1 tanh,
// 2 erf (EPI_GELU).
template <bool STREAM, int EPI>
__global__ void __launch_bounds__(HopperI8::THREADS, 1)
hopper_int8_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap ymap,
                        const bf16* __restrict__ g, const bf16* __restrict__ b, const float* __restrict__ sw,
                        const float* __restrict__ bias, const float* __restrict__ amax_in,
                        float* __restrict__ amax_out, int act, int M, int N, int K, int n_stages) {
  typedef HopperI8 L;
  using namespace hopper;
  constexpr int PANEL_ROWS = L::panel_rows(STREAM), CN = L::cols(STREAM);
  constexpr uint32_t OUT_TILE = L::out_tile(STREAM);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // panel_full: the producer, + bytes; panel_empty: every consumer warp (panel
  // mode); out_ready[wg]: the warpgroup's first thread (+ the residual's
  // bytes); full[s]: the producer, + bytes (a W^T slice from every block's
  // half); empty[s]: every consumer warp of every block of the cluster
  uint64_t *panel_full = bars, *panel_empty = bars + 1, *out_ready = bars + 2, *full = bars + 4,
           *empty = bars + 4 + n_stages;
  float* sxs = reinterpret_cast<float*>(smem + L::SX_OFF);
  const int kb = K / L::BK, ka = K / 64;  // int8 atoms (ring stages a tile) and bf16 boxes across a row
  unsigned char* panel_base = smem + L::panel_off(STREAM);
  // int8 atom s of consumer wg's rows (panel mode: over the rows' bf16 box s)
  auto panel_atom = [&](int wg, int s) {
    return panel_base + (size_t)(STREAM ? s : wg * ka + s) * L::ATOM;
  };
  auto out_tile = [&](int wg) { return smem + L::BAR_BYTES + (size_t)wg * OUT_TILE; };
  unsigned char* ring_base = smem + L::ring_off(STREAM, K);
  auto stage = [&](int s) { return ring_base + (size_t)s * L::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(panel_full, 1);
    mbar_init(panel_empty, L::CONSUMER_WARPS);
    for (int i = 0; i < L::CONSUMERS; ++i) mbar_init(&out_ready[i], 1);
    for (int i = 0; i < n_stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::CONSUMER_WARPS * L::CLUSTER);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the partner's barriers are initialized before any multicast or remote arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nt = N / L::BN, n_panels = (M + PANEL_ROWS - 1) / PANEL_ROWS;
  const int rank = (int)cluster_rank();
  // the blocks of a cluster walk the same rounds (see kernel B)
  const int first = (int)cluster_id_x() * L::CLUSTER, step = (int)n_clusters_x() * L::CLUSTER;

  if (warp >= (int)L::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == (int)L::CONSUMER_WARPS && lane == 0) {
      Ring ring(n_stages);
      const uint16_t mask = (1u << L::CLUSTER) - 1;
      constexpr int PIECE = L::BN / L::CLUSTER;  // W^T rows this block loads for the cluster
      int it = 0;
      for (int base = first; base < n_panels; base += step, ++it) {
        const int row0 = (base + rank) * PANEL_ROWS;
        if constexpr (STREAM) {  // x in 128-column chunks through the ring
          for (int s = 0; s < kb; ++s) {
            mbar_wait(&empty[ring.idx], ring.phase ^ 1);
            if (row0 < M) {
              mbar_arrive_expect_tx(&full[ring.idx], L::STAGE);
              for (int a = 0; a < 2; ++a)
                tma_load_2d(stage(ring.idx) + a * L::ATOM, &xmap, &full[ring.idx], s * L::BK + a * 64, row0);
            } else {
              mbar_arrive(&full[ring.idx]);
            }
            ring.advance();
          }
        } else {  // the whole bf16 panel
          mbar_wait(panel_empty, (it & 1) ^ 1);
          uint32_t bytes = 0;
          for (int c = 0; c < L::CONSUMERS; ++c)
            if (row0 + c * 64 < M) bytes += ka * L::ATOM;
          mbar_arrive_expect_tx(panel_full, bytes);
          for (int c = 0; c < L::CONSUMERS; ++c)
            if (row0 + c * 64 < M)
              for (int a = 0; a < ka; ++a) tma_load_2d(panel_atom(c, a), &xmap, panel_full, a * 64, row0 + c * 64);
        }
        for (int j = 0; j < nt; ++j)
          for (int s = 0; s < kb; ++s) {
            mbar_wait(&empty[ring.idx], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.idx], L::STAGE);
            tma_load_2d_multicast(stage(ring.idx) + rank * PIECE * 128, &wmap, &full[ring.idx], s * L::BK,
                                  j * L::BN + rank * PIECE, mask);
            ring.advance();
          }
      }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, x4 = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    const int col_off = STREAM ? 64 * wg : 0;  // this consumer's columns of each tile
    float* sx = sxs + (STREAM ? 0 : 64 * wg);  // its rows' scales
    RingConsumer<L::CLUSTER> ring(n_stages, empty, rank, lane);
    int it = 0;
    uint32_t out_phase = 0;
    for (int base = first; base < n_panels; base += step, ++it) {
      const int prow0 = (base + rank) * PANEL_ROWS;
      const int row0 = prow0 + (STREAM ? 0 : 64 * wg);  // this consumer's first row
      if constexpr (STREAM) {
        named_bar_sync(3, L::CONSUMERS * 128);  // both consumers are done with the last panel
        if (threadIdx.x < 64) {  // the rows' scales and their reciprocals
          const int m = prow0 + threadIdx.x;
          const float s = row_scale(m < M ? amax_in[m] : 0.f);
          sx[threadIdx.x] = s;
          sx[64 + threadIdx.x] = 1.f / s;
        }
        named_bar_sync(3, L::CONSUMERS * 128);
        for (int s = 0; s < kb; ++s) {
          mbar_wait(&full[ring.at.idx], ring.at.phase);
          quantize_chunk(stage(ring.at.idx), panel_atom(0, s), sx, sx + 64, warp, lane);
          __syncwarp();
          ring.consumed();
        }
        fence_proxy_async();
        named_bar_sync(3, L::CONSUMERS * 128);
      } else {
        mbar_wait(panel_full, it & 1);
        if (row0 < M) {
          if (g != nullptr) {
            ln_rows_sw128<4>(panel_atom(wg, 0), L::ATOM, wl, 4, 64, K, g, b, lane);
            __syncwarp();
          }
          quantize_panel_rows<4>(panel_atom(wg, 0), wl, 4, 64, K, sx, lane);
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      }
      const float sx_row[2] = {sx[wl * 16 + gq], sx[wl * 16 + gq + 8]};
      float ymax[2] = {0.f, 0.f};
      for (int j = 0; j < nt; ++j) {
        const int col0 = j * L::BN + col_off;
        if (leader) {  // the output tile is free once the last store has read it
          bulk_wait_read();
          if (EPI == EPI_RESIDUAL && row0 < M) {
            mbar_arrive_expect_tx(&out_ready[wg], OUT_TILE);
            for (int a = 0; a < CN / 64; ++a)
              tma_load_2d(out_tile(wg) + a * L::ATOM, &rmap, &out_ready[wg], col0 + a * 64, row0);
          } else {
            mbar_arrive(&out_ready[wg]);
          }
        }
        float2 bias_v[CN / 8], sw_v[CN / 8];  // this thread's column pairs, loaded while the products run
#pragma unroll
        for (int jj = 0; jj < CN / 8; ++jj) {
          const int n = col0 + jj * 8 + 2 * x4;
          bias_v[jj] = *reinterpret_cast<const float2*>(bias + n);
          sw_v[jj] = *reinterpret_cast<const float2*>(sw + n);
        }
        int acc[CN / 2];
        for (int s = 0; s < kb; ++s) {
          mbar_wait(&full[ring.at.idx], ring.at.phase);
          const uint64_t adesc = desc_kmajor(panel_atom(wg, s));
          const uint64_t bdesc = desc_kmajor(stage(ring.at.idx) + (STREAM ? wg * L::ATOM : 0));
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) WgmmaS8<CN>::run(acc, adesc + 2 * kk, bdesc + 2 * kk, s > 0 || kk > 0);
          ring.committed();
        }
        ring.drain();
        reg_fence(acc);
        if (!STREAM && j == nt - 1 && lane == 0) mbar_arrive(panel_empty);  // the panel is read for the last time

        // epilogue: y = round((f32(acc) * sx) * sw + bias), then GELU or + residual, in the output tile
        mbar_wait(&out_ready[wg], out_phase);
        out_phase ^= 1u;
        unsigned char* tile = out_tile(wg);
#pragma unroll
        for (int jj = 0; jj < CN / 8; ++jj) {
          const int col = jj * 8 + 2 * x4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wl * 16 + gq + 8 * i;
            __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(tile + (col >> 6) * L::ATOM + sw128(r, col & 63));
            const float a0 = __int2float_rn(acc[4 * jj + 2 * i]), a1 = __int2float_rn(acc[4 * jj + 2 * i + 1]);
            const float d0 = __fadd_rn(__fmul_rn(__fmul_rn(a0, sx_row[i]), sw_v[jj].x), bias_v[jj].x);
            const float d1 = __fadd_rn(__fmul_rn(__fmul_rn(a1, sx_row[i]), sw_v[jj].y), bias_v[jj].y);
            __nv_bfloat162 o = __floats2bfloat162_rn(d0, d1);
            if constexpr (EPI == EPI_GELU) {
              o = gelu_bf16x2(o, act);
            } else if constexpr (EPI == EPI_RESIDUAL) {
              const __nv_bfloat162 rv = *dst;
              o = __floats2bfloat162_rn(__low2float(rv) + __low2float(o), __high2float(rv) + __high2float(o));
            }
            *dst = o;
            ymax[i] = fmaxf(ymax[i], fmaxf(fabsf(__low2float(o)), fabsf(__high2float(o))));
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (leader && row0 < M) {
          for (int a = 0; a < CN / 64; ++a) tma_store_2d(&ymap, tile + a * L::ATOM, col0 + a * 64, row0);
          bulk_commit();
        }
      }
      if (!STREAM && amax_out != nullptr) {  // the consumer saw every column of its rows
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float mx = quad_max(ymax[i]);
          const int m = row0 + wl * 16 + gq + 8 * i;
          if (x4 == 0 && m < M) amax_out[m] = mx;
        }
      }
    }
    if (leader) bulk_wait();
    cluster_sync();
  }
}

// Once a device and mode: the shared-memory limit, the register check
// (setmaxnreg.inc waits for registers the producer gave back: a block
// compiled with fewer than BLOCK_REGS a thread would wait forever) and the
// number of clusters that fit on the card at once. Returns a cudaError_t.
template <bool STREAM, int EPI> static int hopper_setup(int* clusters) {
  typedef HopperI8 L;
  static int setup[64] = {}, n_clusters[64] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    auto kernel = hopper_int8_gemm_kernel<STREAM, EPI>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM_LIMIT);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs < L::BLOCK_REGS) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = L::CLUSTER;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(L::CLUSTER * 256);
      cfg.blockDim = dim3(L::THREADS);
      cfg.dynamicSmemBytes = L::smem(STREAM, STREAM ? L::STREAM_MAX_K : L::PANEL_MAX_K);
      cfg.attrs = at;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n_clusters[dev], (void*)kernel, &cfg);
      if (err == cudaSuccess && n_clusters[dev] < 1) err = cudaErrorInvalidConfiguration;
    }
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  *clusters = n_clusters[dev];
  return setup[dev] > 0 ? setup[dev] : 0;
}

// Fill gelu_table once a device, on `stream`, and wait for it (once).
static int gelu_table_setup(cudaStream_t stream) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    gelu_table_kernel<<<65536 / 256, 256, 0, stream>>>();
    err = cudaGetLastError();
    if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) return (int)err;
    ready[dev] = true;
  }
  return 0;
}

template <bool STREAM, int EPI>
static int launch_bf16(const void* x, const void* g, const void* b, const void* wt, const void* sw,
                       const void* bias, const void* res, const void* amax_in, void* amax_out, void* y, int M,
                       int N, int K, int act, cudaStream_t stream) {
  typedef HopperI8 L;
  int clusters = 0;
  int err = hopper_setup<STREAM, EPI>(&clusters);
  if (!err && EPI == EPI_GELU) err = gelu_table_setup(stream);
  if (err) return err;
  // x (M, K) in 64 x 64 boxes, W^T (N, K) int8 in slices of BN / CLUSTER rows x 128 bytes,
  // the residual and y (M, N) in 64 x 64 boxes
  CUtensorMap maps[4];
  err = hopper::tma_map_bf16_2d(&maps[0], x, M, K, K, 64, 64);
  if (!err) err = hopper::tma_map_u8_2d(&maps[1], wt, N, K, K, L::BN / L::CLUSTER, L::BK);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[2], res != nullptr ? res : y, M, N, N, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[3], y, M, N, N, 64, 64);
  if (err) return err;
  const int n_panels = (M + L::panel_rows(STREAM) - 1) / L::panel_rows(STREAM);
  const int need = (n_panels + L::CLUSTER - 1) / L::CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = L::CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(L::CLUSTER * (need < clusters ? need : clusters));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::smem(STREAM, K);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, hopper_int8_gemm_kernel<STREAM, EPI>, maps[0], maps[1], maps[2], maps[3], static_cast<const bf16*>(g),
      static_cast<const bf16*>(b), static_cast<const float*>(sw), static_cast<const float*>(bias),
      static_cast<const float*>(amax_in), static_cast<float*>(amax_out), act, M, N, K, L::stages(STREAM, K));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the epilogue's kernel: GELU (act != 0, no residual), + the residual, or neither
template <bool STREAM>
static int launch_bf16_epi(const void* x, const void* g, const void* b, const void* wt, const void* sw,
                           const void* bias, const void* res, const void* amax_in, void* amax_out, void* y, int M,
                           int N, int K, int act, cudaStream_t stream) {
  if (act != 0)
    return launch_bf16<STREAM, EPI_GELU>(x, g, b, wt, sw, bias, res, amax_in, amax_out, y, M, N, K, act, stream);
  if (res != nullptr)
    return launch_bf16<STREAM, EPI_RESIDUAL>(x, g, b, wt, sw, bias, res, amax_in, amax_out, y, M, N, K, act, stream);
  return launch_bf16<STREAM, EPI_NONE>(x, g, b, wt, sw, bias, res, amax_in, amax_out, y, M, N, K, act, stream);
}

}  // namespace gw

namespace gw {
// rows x K bf16 values (K a multiple of 8), each row quantized by its given
// maximum with the bf16 kernel's arithmetic (row_scale, quantize8)
__global__ void quantize_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ amax, i8* __restrict__ q,
                                     int rows, int K) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x, per_row = K / 8;
  if (i >= rows * per_row) return;
  const int row = (int)(i / per_row);
  const float s = row_scale(amax[row]), r = 1.f / s;
  float v[8];
  unpack_bf16x8(*reinterpret_cast<const uint4*>(x + 8 * i), v);
  *reinterpret_cast<uint2*>(q + 8 * i) = quantize8(v, s, r);
}
}  // namespace gw

// For the card's check of the quantization against the IEEE division:
// x (rows, K) bf16, amax (rows,) f32 (each row's |x| at most its maximum),
// q (rows, K) int8 out; K a multiple of 8. Returns a cudaError_t.
extern "C" int gw_int8_quantize(const void* x, const void* amax, void* q, int rows, int K, void* stream) {
  if (rows < 0 || K <= 0 || K % 8) return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * (K / 8);
  if (n == 0) return 0;
  gw::quantize_rows_kernel<<<(unsigned)((n + 255) / 256), 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const gw::bf16*>(x), static_cast<const float*>(amax), static_cast<gw::i8*>(q), rows, K);
  return (int)cudaGetLastError();
}

// x (M, K), g/b (K,) or null (no LayerNorm), w (K, N) int8 (not read by
// the kernel) and wt its transpose (N, K) contiguous, sw and bias (N,)
// float32, res (M, N) or null, amax_in (M,) f32 or null: each row's max
// |x|, handed over by an earlier launch's amax_out (stream mode); amax_out
// (M,) f32 or null: each row's max |y|; y (M, N); act 0 none, 1 GELU tanh,
// 2 GELU erf (with no residual). K and N multiples of 128; K at most 512
// without amax_in, at most 2048 with it (then no LN and no amax_out). x,
// wt, res and y 16-byte aligned. dtype must be GW_BF16: the kernel takes
// bfloat16 only, and any other value returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int gw_int8_gemm(const void* x, const void* g, const void* b, const void* w, const void* wt,
                            const void* sw, const void* bias, const void* res, const void* amax_in, void* amax_out,
                            void* y, int M, int N, int K, int act, int dtype, void* stream) {
  if (M < 0 || N <= 0 || K <= 0 || act < 0 || act > 2 || dtype != GW_BF16) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K % 128 != 0 || N % 128 != 0) return (int)cudaErrorInvalidValue;
  if (amax_in != nullptr) {
    if (g != nullptr || amax_out != nullptr || K > gw::HopperI8::STREAM_MAX_K) return (int)cudaErrorInvalidValue;
    return gw::launch_bf16_epi<true>(x, g, b, wt, sw, bias, res, amax_in, amax_out, y, M, N, K, act, s);
  }
  if (K > gw::HopperI8::PANEL_MAX_K) return (int)cudaErrorInvalidValue;
  return gw::launch_bf16_epi<false>(x, g, b, wt, sw, bias, res, amax_in, amax_out, y, M, N, K, act, s);
}
