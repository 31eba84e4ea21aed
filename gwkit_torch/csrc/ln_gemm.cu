// Kernel B: y = [LN(x)] . W + bias [+ residual], the projection stages of
// one encoder layer.
//
// Replaces: gwkit/ops/fused_block.py::_attn_block_kernel (and
// _attn_only_kernel), stages `ln_qkv_tile` (LN1 + the single (D, 3D) QKV
// product with DoRA and the 1/sqrt(hd) query scale folded into W) and
// `o_tile` (o-projection + bias + residual). On the TPU both live inside the
// one whole-layer kernel; on Hopper each is one launch of this kernel.
//
// Contract (fused_block.py:66-77, :151-161, :236-246): LN in f32 mean and
// biased variance, normalized and rounded to the compute type, then scaled
// and shifted in it; the product accumulated in f32; + bias in f32, rounded;
// + the residual in f32, rounded once.
//
// Bound on the H100: at the main path's shapes (M = 256 x 256 rows, K = 384,
// N = 1152 or 384, bf16) the FLOPs (2MNK: 58 / 19 GFLOP) and the bytes (x
// read once, y written once: ~200 / ~150 MB) put both at ~0.06 / ~0.045 ms,
// i.e. the stage sits near the ridge of the roofline; the bytes bound is the
// larger for the o-projection.
//
// bfloat16 (hopper_ln_gemm_kernel: the search and training): one persistent
// block on each SM, two consumer warpgroups and a producer warpgroup whose
// first thread issues every load (setmaxnreg 40/232, as kernel A). A work
// item is a panel of 128 rows; consumer warpgroup c owns rows 64c..64c+63.
//  * The producer loads the x panel once by TMA (K/64 swizzled 64 x 64
//    atoms a warpgroup); the consumers normalize it in place once (no LN for
//    the o-projection) and the block then walks ALL N/128 column tiles of
//    the panel, so x is read and normalized once, not once a column tile.
//  * W streams through a ring of 64 x 128 slices (two MN-major atoms, read
//    with the transpose flag) for m64n128k16 wgmma, A the panel in shared
//    memory. Blocks run in clusters of two along M: each block loads half
//    of a slice's rows and multicasts it to both, so one read from L2 feeds
//    256 rows. A stage is released to both producers once its products
//    complete (the next stage's products are already in flight).
//  * Epilogue: the residual tile arrives by TMA in the warpgroup's 64 x 128
//    staging tile; bias, rounding and the residual add run on the
//    accumulator registers; the result goes back to the same tile and out
//    by a TMA store, which completes while the next tile's products run.
//  * Ragged M needs no masking: rows past M load as zeros (or a panel half
//    past M is not loaded at all) and the store clips them.
//
// Past K = 512 (the 1280-wide layer of whisper-large-v3, its fc2 at K =
// 5120) and wherever a GELU follows the bias, bf16 takes a second kernel,
// hopper_wide_ln_gemm_kernel (below), which streams x beside W and folds
// LayerNorm into the epilogue; the panel kernel above keeps K <= 512 as it
// was.
#include "common.cuh"
#include "hopper.cuh"

#ifndef GW_LN_GEMM_CLUSTER  // a comparison build may set another cluster size (1, 2 or 4)
#define GW_LN_GEMM_CLUSTER 2
#endif

namespace gw {

// ---- bfloat16: wgmma, TMA, one normalized panel, W multicast in a cluster ------

struct HopperLnGemm {
  static constexpr int ROWS = 64, CONSUMERS = 2, PANEL_ROWS = CONSUMERS * ROWS;
  static constexpr int BN = 128, BK = 64, MAX_K = 512;
  static constexpr int CLUSTER = GW_LN_GEMM_CLUSTER;  // blocks sharing each W slice by multicast
  // + a producer warpgroup: 40 + 2 x 232 = 504 = 3 x 168, all of the block's registers
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232, BLOCK_REGS = 168;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t CONSUMER_WARPS = CONSUMERS * 4;
  static constexpr uint32_t ATOM = 64 * 64 * sizeof(bf16);  // 8 KB: one 64 x 64 swizzled box
  static constexpr uint32_t STAGE = 2 * ATOM;               // a 64 x 128 slice of W, or an output tile
  static constexpr int MAX_STAGES = 8;
  // shared memory, 1024-aligned: barriers | staging[warpgroup] | panel[warpgroup][K/64] | ring
  static constexpr size_t BAR_BYTES = 1024, OUT_OFF = BAR_BYTES;
  static constexpr size_t PANEL_OFF = OUT_OFF + CONSUMERS * STAGE;
  static constexpr size_t SMEM_LIMIT = 232448;  // the most a block may have on the H100
  static __host__ __device__ size_t ring_off(int K) { return PANEL_OFF + (size_t)CONSUMERS * (K / BK) * ATOM; }
  static int stages(int K) {
    const long n = ((long)SMEM_LIMIT - 1024 - (long)ring_off(K)) / STAGE;  // 1024: alignment slack
    return n < MAX_STAGES ? (int)n : MAX_STAGES;
  }
  static size_t smem(int K) { return 1024 + ring_off(K) + (size_t)stages(K) * STAGE; }
};
static_assert(HopperLnGemm::BAR_BYTES >= (4 + 2 * HopperLnGemm::MAX_STAGES) * sizeof(uint64_t), "barriers");

__global__ void __launch_bounds__(HopperLnGemm::THREADS, 1)
hopper_ln_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap ymap,
                      const bf16* __restrict__ g, const bf16* __restrict__ b, const float* __restrict__ bias,
                      int has_res, int M, int N, int K, int n_stages) {
  typedef HopperLnGemm L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // panel_full: the producer, + bytes; panel_empty: every consumer warp;
  // out_ready[wg]: the warpgroup's first thread (+ the residual's bytes);
  // full[s]: the producer, + bytes from every block's half; empty[s]: every
  // consumer warp of every block of the cluster
  uint64_t *panel_full = bars, *panel_empty = bars + 1, *out_ready = bars + 2, *full = bars + 4,
           *empty = bars + 4 + n_stages;
  const int kt = K / L::BK;
  auto panel = [&](int wg, int a) { return smem + L::PANEL_OFF + (size_t)(wg * kt + a) * L::ATOM; };
  auto out_tile = [&](int wg) { return smem + L::OUT_OFF + (size_t)wg * L::STAGE; };
  unsigned char* ring_base = smem + L::ring_off(K);
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
  const int nt = (N + L::BN - 1) / L::BN, n_panels = (M + L::PANEL_ROWS - 1) / L::PANEL_ROWS;
  const int rank = (int)cluster_rank();
  // the blocks of a cluster walk the same rounds (panels rank, rank + 1 of
  // each round's pair), so each takes part in every multicast; a panel past
  // M computes on whatever its tile holds and stores nothing
  const int first = (int)cluster_id_x() * L::CLUSTER, step = (int)n_clusters_x() * L::CLUSTER;

  if (warp >= (int)L::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == (int)L::CONSUMER_WARPS && lane == 0) {
      Ring ring(n_stages);
      const uint16_t mask = (1u << L::CLUSTER) - 1;
      constexpr int PIECE_ROWS = L::BK / L::CLUSTER;  // W rows this block loads for the cluster
      int it = 0;
      for (int base = first; base < n_panels; base += step, ++it) {
        const int p = base + rank;
        mbar_wait(panel_empty, (it & 1) ^ 1);
        uint32_t bytes = 0;
        for (int c = 0; c < L::CONSUMERS; ++c)
          if (p * L::PANEL_ROWS + c * L::ROWS < M) bytes += kt * L::ATOM;
        mbar_arrive_expect_tx(panel_full, bytes);
        for (int c = 0; c < L::CONSUMERS; ++c) {
          const int row0 = p * L::PANEL_ROWS + c * L::ROWS;
          if (row0 < M)
            for (int a = 0; a < kt; ++a) tma_load_2d(panel(c, a), &xmap, panel_full, a * L::BK, row0);
        }
        for (int j = 0; j < nt; ++j)
          for (int s = 0; s < kt; ++s) {
            mbar_wait(&empty[ring.idx], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.idx], L::STAGE);
            for (int a = 0; a < 2; ++a)
              tma_load_2d_multicast(stage(ring.idx) + a * L::ATOM + rank * PIECE_ROWS * 128, &wmap,
                                    &full[ring.idx], j * L::BN + a * 64, s * L::BK + rank * PIECE_ROWS, mask);
            ring.advance();
          }
      }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, x = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    RingConsumer<L::CLUSTER> ring(n_stages, empty, rank, lane);
    int it = 0;
    uint32_t out_phase = 0;
    for (int base = first; base < n_panels; base += step, ++it) {
      const int row0 = (base + rank) * L::PANEL_ROWS + wg * L::ROWS;
      mbar_wait(panel_full, it & 1);
      if (g != nullptr) {
        ln_rows_sw128<4>(panel(wg, 0), L::ATOM, wl, 4, L::ROWS, K, g, b, lane);
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      }
      for (int j = 0; j < nt; ++j) {
        if (leader) {  // the staging tile is free once the last store has read it
          bulk_wait_read();
          if (has_res && row0 < M) {
            mbar_arrive_expect_tx(&out_ready[wg], L::STAGE);
            for (int a = 0; a < 2; ++a) tma_load_2d(out_tile(wg) + a * L::ATOM, &rmap, &out_ready[wg], j * L::BN + a * 64, row0);
          } else {
            mbar_arrive(&out_ready[wg]);
          }
        }
        float2 bias_v[16];  // this thread's bias pairs, loaded while the products run
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int n = j * L::BN + jj * 8 + 2 * x;
          bias_v[jj] = n < N ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
        }
        float acc[64];
        for (int s = 0; s < kt; ++s) {
          mbar_wait(&full[ring.at.idx], ring.at.phase);
          const uint64_t adesc = desc_kmajor(panel(wg, s));
          const uint64_t bdesc = desc_mnmajor_atoms(stage(ring.at.idx), L::ATOM);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) wgmma_ss<128, 1>(acc, adesc + 2 * kk, bdesc + 128 * kk, s > 0 || kk > 0);
          ring.committed();
        }
        ring.drain();
        reg_fence(acc);
        if (j == nt - 1 && lane == 0) mbar_arrive(panel_empty);  // the panel is read for the last time

        // epilogue: y = round(acc + bias) [+ residual, rounded once], in the staging tile
        mbar_wait(&out_ready[wg], out_phase);
        out_phase ^= 1u;
        unsigned char* tile = out_tile(wg);
#pragma unroll
        for (int jj = 0; jj < 16; ++jj) {
          const int col = jj * 8 + 2 * x;
          const float2 bv = bias_v[jj];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = wl * 16 + gq + 8 * i;
            __nv_bfloat162* dst =
                reinterpret_cast<__nv_bfloat162*>(tile + (col >> 6) * L::ATOM + sw128(r, col & 63));
            const float2 v = round_bf16x2(acc[4 * jj + 2 * i] + bv.x, acc[4 * jj + 2 * i + 1] + bv.y);
            float v0 = v.x, v1 = v.y;
            if (has_res) {
              const __nv_bfloat162 rv = *dst;
              v0 = __low2float(rv) + v0;
              v1 = __high2float(rv) + v1;
            }
            *dst = __floats2bfloat162_rn(v0, v1);
          }
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
        if (leader && row0 < M) {
          for (int a = 0; a < 2; ++a)
            if (j * L::BN + a * 64 < N) tma_store_2d(&ymap, tile + a * L::ATOM, j * L::BN + a * 64, row0);
          bulk_commit();
        }
      }
    }
    if (leader) bulk_wait();
    cluster_sync();
  }
}

// Once a device: the shared-memory limit, the register check (setmaxnreg.inc
// waits for registers the producer gave back: a block compiled with fewer
// than BLOCK_REGS a thread would wait forever) and the number of clusters
// that fit on the card at once. 0 until done, then -1, or the cudaError_t
// it met.
static int hopper_setup(int* clusters) {
  typedef HopperLnGemm L;
  static int setup[64] = {}, n_clusters[64] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(hopper_ln_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::SMEM_LIMIT);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, hopper_ln_gemm_kernel);
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
      cfg.dynamicSmemBytes = L::smem(L::MAX_K);
      cfg.attrs = at;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n_clusters[dev], (void*)hopper_ln_gemm_kernel, &cfg);
      if (err == cudaSuccess && n_clusters[dev] < 1) err = cudaErrorInvalidConfiguration;
    }
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  *clusters = n_clusters[dev];
  return setup[dev] > 0 ? setup[dev] : 0;
}

// the tensor maps of one call: x (M, K), w (K, N), the residual and y (M, N)
static int encode_maps(CUtensorMap (&maps)[4], const void* x, const void* w, const void* res, const void* y,
                       int M, int N, int K) {
  typedef HopperLnGemm L;
  int err = hopper::tma_map_bf16_2d(&maps[0], x, M, K, K, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[1], w, K, N, N, L::BK / L::CLUSTER, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[2], res != nullptr ? res : y, M, N, N, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[3], y, M, N, N, 64, 64);
  return err;
}

static int launch_bf16(const void* x, const void* g, const void* b, const void* w, const void* bias,
                       const void* res, void* y, int M, int N, int K, cudaStream_t stream) {
  typedef HopperLnGemm L;
  if (K > L::MAX_K) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  int err = hopper_setup(&clusters);
  if (err) return err;
  CUtensorMap maps[4];
  err = encode_maps(maps, x, w, res, y, M, N, K);
  if (err) return err;
  const int n_panels = (M + L::PANEL_ROWS - 1) / L::PANEL_ROWS;
  const int need = (n_panels + L::CLUSTER - 1) / L::CLUSTER;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = L::CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(L::CLUSTER * (need < clusters ? need : clusters));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::smem(K);
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hopper_ln_gemm_kernel, maps[0], maps[1], maps[2], maps[3],
                         static_cast<const bf16*>(g), static_cast<const bf16*>(b), static_cast<const float*>(bias),
                         (int)(res != nullptr), M, N, K, L::stages(K));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// ---- bfloat16 past the panel: x and W both stream (fc1, fc2 and K > 512) ----------
//
// hopper_wide_ln_gemm_kernel: K any multiple of 64 up to 5120, an optional
// GELU after the bias (kernel C's rounding: round(acc + bias), GELU, round).
// At K = 1280 a 128-row panel of x is 320 KB and no longer fits shared
// memory, so nothing is held whole: x and W both stream through a ring of
// stages, each a 128 x 64 slice of x (two K-major atoms) and the matching
// 64 x 128 slice of W (two MN-major atoms), five stages deep.
//
// Four warpgroups: two consumers, a statistics warpgroup and a load
// warpgroup (one thread issues every TMA load).
//
// Ping-pong: a tile is 128 x 128 outputs (128 x 192 would need 192
// accumulator registers a thread, too many beside the epilogue's), and one
// consumer warpgroup owns it whole: it accumulates the tile's two 64-row
// halves in 2 x 64 registers (m64n128k16 on each) and runs its epilogue (residual by TMA into its own
// 128 x 128 staging tile, the LayerNorm correction, bias, rounding, GELU,
// residual add, TMA store). A block's tiles alternate between the two, and
// the load thread fills the ring in that order, so a warpgroup skips the
// other's stages. A pair of named barriers orders the mainloops: a
// warpgroup issues its tile's products only after the other has issued all
// of its previous tile's, so one warpgroup feeds the tensor cores at a time
// while the other runs its epilogue. At K = 1280 a mainloop is 20 steps
// (about 20 thousand cycles); the epilogue takes about 6 without a GELU and
// about 25 with the tanh GELU, so of the four launches only fc1 is not
// wholly hidden.
//
// LayerNorm is folded, as a row panel cannot be normalized in place:
// LN(x) W + bias = rstd (x W' - mean colsum(W')) + bias + b W, with
// W' = g (.) W rounded to bf16 and colsum(W') and bias + b W in f32, made
// once by the wrapper (fused_block.py::ln_fold). The row statistics are the
// statistics warpgroup's: it reads each x slice as it lands, every lane 16
// columns of a row, sums them and their squared deviations pairwise and
// keeps a running mean and sum of squared deviations by Chan's update (per
// slice: no cancellation at large means); a stage is released only after
// it has read it. With LayerNorm a block takes a panel's column tiles two at
// a time, one a consumer warpgroup, so the statistics are taken once for
// both: after the first tile's last slice the quad's four lanes combine
// theirs, and the (mean, rstd) go to both warpgroups through shared memory
// before their epilogues. So the warpgroup that feeds the tensor cores reads
// no x itself, and LN costs no pass of its own. The function differs from
// the panel path's only where that path rounds LN(x) to bf16 before the
// product (this one keeps x exact and rounds g (.) W instead). Warps that do
// not feed the tensor cores sleep between polls of a barrier.
//
// Clusters of two blocks on two row panels of the same column tiles: each
// block loads half of W's slice and multicasts it to both. Items are walked
// panel-major (the column tiles of a panel run on neighbouring clusters, so
// x is read from HBM about once).
//
// What was tried, on the H100 (80GB HBM3, 700 W): a 1280-wide layer's four
// launches over 16 x 1500 rows, qkv + o + fc1 (tanh) + fc2, device ms, each
// beside the kernel this one replaced (cooperative 128 x 192 tiles, the
// statistics in the consumers) in the same process: 2.54-2.63.
//  * ping-pong, statistics in three spare warps of a producer warpgroup:
//    4.16-4.19 (the statistics took 1.9-2.9 thousand cycles a slice, the
//    epilogue 16-25 us a tile: bias loaded per column block, both GELUs
//    inline); then one instantiation a GELU, the bias shuffled from two
//    loads a lane, the statistics' divisions hoisted and sums pairwise: 3.18;
//  * the statistics in a warpgroup of their own (four warps): 2.28-2.30;
//    shared by a chunk of two tiles: 2.13-2.16; the epilogue's reads,
//    arithmetic and writes apart for two column blocks at a time: 2.16
//    (four at a time spill); the other warps sleeping between polls: fc1
//    0.93-0.98 against 1.04; all that, in a build generic over the
//    cluster's shape, 2.15-2.20, and with the cluster fixed at two (this
//    one) 2.05-2.11, of which fc1 0.92-0.94;
//  * not kept, against the generic build: clusters of 2 x 2, x multicast
//    too, 2.35 (fc2 0.525 against 0.549, qkv and fc1
//    slower); mbarriers in place of the named barriers 2.18; the GELU of
//    half the rows by the load warpgroup's three spare warps 2.19-2.28; the
//    GELU deferred into the warpgroup's next mainloop 2.24; the statistics
//    shared with those spare warps (which spill at 32 registers) 2.39-2.42.
struct WideLnGemm {
  static constexpr int ROWS = 128, BN = 128, BK = 64, MAX_K = 5120, MAX_STAGES = 8;
  static constexpr int CLUSTER = 2;  // blocks sharing each W slice by multicast
  // warpgroups: CONSUMERS consumers, then the statistics warpgroup, then the load warpgroup
  static constexpr int CONSUMERS = 2, STATS_WARPS = 4, THREADS = (CONSUMERS + 2) * 128;
  // 2 x 200 + 80 + 32 = 512 = 4 x 128, all of the block's registers
  static constexpr int CONSUMER_REGS = 200, STATS_REGS = 80, LOAD_REGS = 32, BLOCK_REGS = 128;
  static_assert(CONSUMERS * CONSUMER_REGS + STATS_REGS + LOAD_REGS <= (CONSUMERS + 2) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t ATOM = 64 * 64 * sizeof(bf16);  // 8 KB
  static constexpr int X_ATOMS = ROWS / 64, W_ATOMS = BN / 64;
  static constexpr uint32_t X_BYTES = X_ATOMS * ATOM;        // a stage's 128 x 64 slice of x
  static constexpr uint32_t STAGE = X_BYTES + W_ATOMS * ATOM;  // + its 64 x 128 slice of W: 32 KB
  static constexpr uint32_t OUT_TILE = X_ATOMS * W_ATOMS * ATOM;  // a warpgroup's 128 x 128 tile
  // shared memory, 1024-aligned: barriers | the tile's row statistics | staging[warpgroup] | ring
  static constexpr size_t BAR_BYTES = 1024, STATS_OFF = BAR_BYTES, OUT_OFF = STATS_OFF + 1024;
  static constexpr size_t RING_OFF = OUT_OFF + CONSUMERS * OUT_TILE;
  static constexpr int FIT = (int)((HopperLnGemm::SMEM_LIMIT - 1024 - RING_OFF) / STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;  // 5
  static constexpr size_t SMEM = 1024 + RING_OFF + STAGES * STAGE;  // 1024: alignment slack
  static constexpr int ORDER_BAR = 3;  // named barriers 3, 4: warpgroup w may issue; 1, 2: the epilogues
};
static_assert(WideLnGemm::STAGES >= 4 && WideLnGemm::SMEM <= HopperLnGemm::SMEM_LIMIT, "shared memory");
static_assert(WideLnGemm::BAR_BYTES >= (2 * WideLnGemm::STAGES + 5) * sizeof(uint64_t), "barriers");
static_assert(WideLnGemm::ROWS * sizeof(float2) <= WideLnGemm::OUT_OFF - WideLnGemm::STATS_OFF &&
                  WideLnGemm::ROWS % (8 * WideLnGemm::STATS_WARPS) == 0,
              "statistics");

// Chan's update of a running (mean, m2) over n values with the 16 values of
// row r, columns 16x .. 16x + 15, of a swizzled 64 x 64 atom of x; w =
// 16 / (n + 16) and nw = 16 n / (n + 16), the same for every row of a slice.
// The slice's sum and sum of squared deviations are taken pairwise (a
// dependent chain of 4 additions, not 16).
__device__ __forceinline__ void row_stats16(const unsigned char* atom, int r, int x, float w, float nw,
                                            float& mean, float& m2) {
  using namespace hopper;
  float v[16];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    const uint4 raw = *reinterpret_cast<const uint4*>(atom + sw128(r, 16 * x + 8 * t));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[8 * t + 2 * e] = __low2float(h[e]);
      v[8 * t + 2 * e + 1] = __high2float(h[e]);
    }
  }
  float p[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) p[e] = v[2 * e] + v[2 * e + 1];
#pragma unroll
  for (int k = 4; k > 0; k >>= 1)
#pragma unroll
    for (int e = 0; e < k; ++e) p[e] += p[e + k];
  const float mb = p[0] * (1.f / 16.f);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float d0 = v[2 * e] - mb, d1 = v[2 * e + 1] - mb;
    p[e] = d0 * d0 + d1 * d1;
  }
#pragma unroll
  for (int k = 4; k > 0; k >>= 1)
#pragma unroll
    for (int e = 0; e < k; ++e) p[e] += p[e + k];
  const float delta = mb - mean;
  mean += delta * w;
  m2 += p[0] + delta * delta * nw;
}

// column tiles a block takes in a row from one panel: with LayerNorm one a
// consumer warpgroup, which share the panel's row statistics
__host__ __device__ __forceinline__ int wide_chunk(int has_ln) { return has_ln ? WideLnGemm::CONSUMERS : 1; }

// mbar_wait for the warps that do not feed the tensor cores: between polls
// the warp sleeps, so that its spinning takes no issue slots from the
// warpgroups that do. A wait that lasts 10 s traps, as mbar_wait's.
__device__ __forceinline__ void mbar_wait_sleep(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = hopper::smem_u32(bar);
  uint64_t t0 = 0;
  while (true) {
    uint32_t done = 0;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0)
      t0 = hopper::globaltimer_ns();
    else if (hopper::globaltimer_ns() - t0 > 10000000000ull)
      __trap();
    __nanosleep(64);
  }
}

// arrive on named barrier `id` without waiting (the waiting side calls named_bar_sync)
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// the ring's stage and parity at position `pos` of the fill order
__device__ __forceinline__ void ring_seek(hopper::Ring& ring, int pos) {
  ring.idx = pos % ring.n;
  ring.phase = (uint32_t)(pos / ring.n) & 1u;
}

// ACT: 0 no GELU, 1 tanh, 2 erf (one instantiation each, so the epilogue
// carries only its own GELU)
template <int ACT>
__global__ void __launch_bounds__(WideLnGemm::THREADS, 1)
hopper_wide_ln_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap ymap,
                           const float* __restrict__ colsum, const float* __restrict__ bias, int has_ln, int has_res,
                           int M, int N, int K) {
  typedef WideLnGemm L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // full[s]: the load thread, + bytes (x from this block, W from both);
  // empty[s]: the owning warpgroup's warps and the statistics warps, of every
  // block of the cluster; out_ready[wg]: the warpgroup's first thread (+ the
  // residual's bytes); stats_full[wg]: every statistics thread, once a
  // chunk; stats_empty: every thread of a chunk's warpgroups, once they
  // have read them (chunks are read in order: each is written after the last
  // is read)
  uint64_t *full = bars, *empty = bars + L::STAGES, *out_ready = bars + 2 * L::STAGES;
  uint64_t *stats_full = out_ready + L::CONSUMERS, *stats_empty = stats_full + L::CONSUMERS;
  float2* stats = reinterpret_cast<float2*>(smem + L::STATS_OFF);  // (mean, rstd) of the tile's rows
  auto out_tile = [&](int wg) { return smem + L::OUT_OFF + (size_t)wg * L::OUT_TILE; };
  auto x_atom = [&](int s, int a) { return smem + L::RING_OFF + (size_t)s * L::STAGE + (size_t)a * L::ATOM; };
  auto w_slice = [&](int s) { return smem + L::RING_OFF + (size_t)s * L::STAGE + L::X_BYTES; };
  const int readers = has_ln ? 4 + L::STATS_WARPS : 4;  // warps that release a stage, per block

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::CONSUMERS; ++i) mbar_init(&out_ready[i], 1);
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], readers * L::CLUSTER);
    }
    for (int i = 0; i < L::CONSUMERS; ++i) mbar_init(&stats_full[i], L::STATS_WARPS * 32);
    mbar_init(stats_empty, L::CONSUMERS * 128);
    mbar_init_fence();
  }
  cluster_sync();  // the partners' barriers are initialized before any multicast or remote arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = K / L::BK, nt = (N + L::BN - 1) / L::BN;
  const int n_panels = (M + L::ROWS - 1) / L::ROWS;
  // With LayerNorm a block takes a panel's column tiles in chunks of one
  // tile a consumer warpgroup, so the chunk's tiles share their row
  // statistics, taken once. Cluster item i: panels 2 (i / pn) + rank of
  // column tiles chunk (i % pn) + u for u < chunk; the blocks of a cluster
  // walk the same items, so each takes part in every multicast; a tile past
  // M or N computes on whatever its stages hold and stores nothing
  const int chunk = wide_chunk(has_ln), pn = (nt + chunk - 1) / chunk;
  const int n_items = (n_panels + L::CLUSTER - 1) / L::CLUSTER * pn;
  const int rank = (int)cluster_rank();
  const int first = (int)cluster_id_x(), step = (int)n_clusters_x();
  const int n_tiles = (first < n_items ? (n_items - first + step - 1) / step : 0) * chunk;  // this block's
  auto tile_at = [&](int t, int& p, int& j) {
    const int item = first + t / chunk * step;
    p = item / pn * L::CLUSTER + rank;
    j = item % pn * chunk + t % chunk;
  };

  if (warp >= 4 * (L::CONSUMERS + 1)) {  // load warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::LOAD_REGS));
    if (warp == 4 * (L::CONSUMERS + 1)) {
      if (lane == 0) {
        Ring ring(L::STAGES);
        const uint16_t mask = (1u << L::CLUSTER) - 1;
        constexpr int PIECE_ROWS = L::BK / L::CLUSTER;  // W rows this block loads for the cluster
        for (int t = 0; t < n_tiles; ++t) {
          int p, j;
          tile_at(t, p, j);
          uint32_t bytes = 0;  // every atom of the tile that starts inside x or W
          for (int a = 0; a < L::X_ATOMS; ++a)
            if (p * L::ROWS + a * 64 < M) bytes += L::ATOM;
          for (int a = 0; a < L::W_ATOMS; ++a)
            if (j * L::BN + a * 64 < N) bytes += L::ATOM;
          for (int s = 0; s < kt; ++s) {
            mbar_wait_sleep(&empty[ring.idx], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.idx], bytes);
            for (int a = 0; a < L::X_ATOMS; ++a) {
              const int row0 = p * L::ROWS + a * 64;
              if (row0 < M) tma_load_2d(x_atom(ring.idx, a), &xmap, &full[ring.idx], s * L::BK, row0);
            }
            for (int a = 0; a < L::W_ATOMS; ++a)
              if (j * L::BN + a * 64 < N)
                tma_load_2d_multicast(w_slice(ring.idx) + a * L::ATOM + rank * PIECE_ROWS * 128, &wmap,
                                      &full[ring.idx], j * L::BN + a * 64, s * L::BK + rank * PIECE_ROWS, mask);
            ring.advance();
          }
        }
      }
    }
    cluster_sync();
  } else if (warp >= 4 * L::CONSUMERS) {  // statistics warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::STATS_REGS));
    const int sw = warp - 4 * L::CONSUMERS;
    if (has_ln) {
      // The row statistics, by warp `sw` of the statistics warpgroup: rows
      // 8g .. 8g + 7 of a tile for g = sw, sw + 4, ... < 16; lane (gq, x) takes
      // row 8g + gq, columns 16x .. 16x + 15 of every slice
      const int gq = lane >> 2, x = lane & 3;
      constexpr int GROUPS = L::ROWS / 8 / L::STATS_WARPS;  // 4
      RingConsumer<L::CLUSTER> ring(L::STAGES, empty, rank, lane);
      for (int t = 0; t < n_tiles; ++t) {
        if (t % L::CONSUMERS) {  // the chunk's next tile: the same rows, their statistics taken
          for (int s = 0; s < kt; ++s) {
            mbar_wait_sleep(&full[ring.at.idx], ring.at.phase);
            ring.consumed();
          }
          continue;
        }
        float mean[GROUPS], m2[GROUPS];
#pragma unroll
        for (int i = 0; i < GROUPS; ++i) mean[i] = m2[i] = 0.f;
        for (int s = 0; s < kt; ++s) {
          const float n = 16.f * (float)s, w = 16.f / (n + 16.f), nw = n * 16.f / (n + 16.f);
          mbar_wait_sleep(&full[ring.at.idx], ring.at.phase);
#pragma unroll
          for (int i = 0; i < GROUPS; ++i) {
            const int g = sw + L::STATS_WARPS * i;
            row_stats16(x_atom(ring.at.idx, g >> 3), 8 * (g & 7) + gq, x, w, nw, mean[i], m2[i]);
          }
          __syncwarp();
          ring.consumed();
        }
        float rstd[GROUPS];
#pragma unroll
        for (int i = 0; i < GROUPS; ++i) {
          float n = 16.f * (float)kt;  // values each lane holds
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {  // the quad's four lanes share the row
            const float mo = __shfl_xor_sync(0xffffffffu, mean[i], o), qo = __shfl_xor_sync(0xffffffffu, m2[i], o);
            const float d = mo - mean[i];
            m2[i] = m2[i] + qo + d * d * (0.5f * n);
            mean[i] = 0.5f * (mean[i] + mo);
            n *= 2.f;
          }
          rstd[i] = 1.f / sqrtf(m2[i] / (float)K + 1e-5f);
        }
        // the previous chunk's warpgroups have read theirs
        mbar_wait_sleep(stats_empty, ((t / L::CONSUMERS) & 1) ^ 1);
        if (x == 0)
#pragma unroll
          for (int i = 0; i < GROUPS; ++i) {
            const int g = sw + L::STATS_WARPS * i;
            stats[8 * g + gq] = make_float2(mean[i], rstd[i]);
          }
        for (int i = 0; i < L::CONSUMERS; ++i) mbar_arrive(&stats_full[i]);
      }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, x = lane & 3;
    const bool leader = (threadIdx.x & 127) == 0;
    RingConsumer<L::CLUSTER> ring(L::STAGES, empty, rank, lane);
    uint32_t out_phase = 0;
    unsigned char* tile = out_tile(wg);  // atom (h, a): rows 64h.., columns 64a.. at (h W_ATOMS + a) ATOM
    for (int t = wg; t < n_tiles; t += L::CONSUMERS) {
      int p, j;
      tile_at(t, p, j);
      const int row0 = p * L::ROWS;
      // the tile's bias and colsum, a pair of columns a lane in each 64-column
      // half (column 2 lane, 64 + 2 lane: lane 4 jj + x holds what lane x's
      // accumulator pair jj (and jj + 8) needs, handed over by shuffles)
      const int c_lo = j * L::BN + 2 * lane, c_hi = c_lo + 64;  // N is a multiple of 8: a pair is whole
      const float2 zero2 = make_float2(0.f, 0.f);
      const float2 b_lo = c_lo < N ? *reinterpret_cast<const float2*>(bias + c_lo) : zero2;
      const float2 b_hi = c_hi < N ? *reinterpret_cast<const float2*>(bias + c_hi) : zero2;
      const float2 s_lo = has_ln && c_lo < N ? *reinterpret_cast<const float2*>(colsum + c_lo) : zero2;
      const float2 s_hi = has_ln && c_hi < N ? *reinterpret_cast<const float2*>(colsum + c_hi) : zero2;
      if (leader) {  // the staging tile is free once the last store has read it
        bulk_wait_read();
        if (has_res) {
          uint32_t bytes = 0;
          for (int h = 0; h < L::X_ATOMS; ++h)
            for (int a = 0; a < L::W_ATOMS; ++a)
              if (row0 + h * 64 < M && j * L::BN + a * 64 < N) bytes += L::ATOM;
          mbar_arrive_expect_tx(&out_ready[wg], bytes);
          for (int h = 0; h < L::X_ATOMS; ++h)
            for (int a = 0; a < L::W_ATOMS; ++a)
              if (row0 + h * 64 < M && j * L::BN + a * 64 < N)
                tma_load_2d(tile + (h * L::W_ATOMS + a) * L::ATOM, &rmap, &out_ready[wg], j * L::BN + a * 64,
                            row0 + h * 64);
        } else {
          mbar_arrive(&out_ready[wg]);
        }
      }
      ring_seek(ring.at, t * kt);  // the other warpgroup's tiles fill the stages between
      if (t > 0) named_bar_sync(L::ORDER_BAR + wg, 2 * 128);  // its previous tile's products are issued
      float acc[L::X_ATOMS][L::BN / 2];
      for (int s = 0; s < kt; ++s) {
        mbar_wait(&full[ring.at.idx], ring.at.phase);
        const uint64_t a0 = desc_kmajor(x_atom(ring.at.idx, 0)), a1 = desc_kmajor(x_atom(ring.at.idx, 1));
        const uint64_t bdesc = desc_mnmajor_atoms(w_slice(ring.at.idx), L::ATOM);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          wgmma_ss<L::BN, 1>(acc[0], a0 + 2 * kk, bdesc + 128 * kk, s > 0 || kk > 0);
          wgmma_ss<L::BN, 1>(acc[1], a1 + 2 * kk, bdesc + 128 * kk, s > 0 || kk > 0);
        }
        ring.committed();
      }
      if (t + 1 < n_tiles) named_bar_arrive(L::ORDER_BAR + (wg ^ 1), 2 * 128);  // the next tile's owner may issue
      ring.drain();
      reg_fence(acc[0]);
      reg_fence(acc[1]);
      // this thread's rows 64h + 16 wl + gq + 8i
      float mean[2][2] = {{0.f, 0.f}, {0.f, 0.f}}, rstd[2][2] = {{1.f, 1.f}, {1.f, 1.f}};
      if (has_ln) {
        mbar_wait(&stats_full[wg], (uint32_t)((t / L::CONSUMERS) & 1));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 st = stats[64 * h + 16 * wl + gq + 8 * i];
            mean[h][i] = st.x;
            rstd[h][i] = st.y;
          }
        mbar_arrive(stats_empty);
      }

      // epilogue: y = round(rstd (acc - mean colsum) + bias) [GELU, round]
      // [+ residual, rounded once], in the staging tile. Two column blocks
      // jj at a time, each phase (residual reads, arithmetic, writes) apart,
      // so the arithmetic of the 16 values interleaves (a write could alias
      // a later read for all the compiler knows).
      mbar_wait(&out_ready[wg], out_phase);
      out_phase ^= 1u;
      constexpr int JG = 2;
#pragma unroll
      for (int j0 = 0; j0 < L::BN / 8; j0 += JG) {
        // this thread's pair (u, h, i): row 64h + 16 wl + gq + 8i, columns 8 (j0 + u) + 2x, + 1
        auto dst = [&](int u, int h, int i) {
          const int col = (j0 + u) * 8 + 2 * x;
          return reinterpret_cast<__nv_bfloat162*>(tile + (h * L::W_ATOMS + (col >> 6)) * L::ATOM +
                                                   sw128(wl * 16 + gq + 8 * i, col & 63));
        };
        __nv_bfloat162 rv[JG][2][2];
        if (has_res)
#pragma unroll
          for (int u = 0; u < JG; ++u)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < 2; ++i) rv[u][h][i] = *dst(u, h, i);
        __nv_bfloat162 out[JG][2][2];
#pragma unroll
        for (int u = 0; u < JG; ++u) {
          const int jj = j0 + u, src = 4 * (jj & 7) + x;
          const float2 bh = jj < 8 ? b_lo : b_hi, sh = jj < 8 ? s_lo : s_hi;
          const float2 bv = make_float2(__shfl_sync(0xffffffffu, bh.x, src), __shfl_sync(0xffffffffu, bh.y, src));
          float2 cv = zero2;
          if (has_ln) cv = make_float2(__shfl_sync(0xffffffffu, sh.x, src), __shfl_sync(0xffffffffu, sh.y, src));
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float a0 = acc[h][4 * jj + 2 * i], a1 = acc[h][4 * jj + 2 * i + 1];
              if (has_ln) {
                a0 = (a0 - mean[h][i] * cv.x) * rstd[h][i];
                a1 = (a1 - mean[h][i] * cv.y) * rstd[h][i];
              }
              float2 v = round_bf16x2(a0 + bv.x, a1 + bv.y);
              if (ACT) v = round_bf16x2(gelu(v.x, ACT == 1), gelu(v.y, ACT == 1));
              if (has_res) {
                v.x = __low2float(rv[u][h][i]) + v.x;
                v.y = __high2float(rv[u][h][i]) + v.y;
              }
              out[u][h][i] = __floats2bfloat162_rn(v.x, v.y);
            }
        }
#pragma unroll
        for (int u = 0; u < JG; ++u)
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int i = 0; i < 2; ++i) *dst(u, h, i) = out[u][h][i];
      }
      fence_proxy_async();
      named_bar_sync(1 + wg, 128);
      if (leader) {
        for (int h = 0; h < L::X_ATOMS; ++h)
          for (int a = 0; a < L::W_ATOMS; ++a)
            if (row0 + h * 64 < M && j * L::BN + a * 64 < N)
              tma_store_2d(&ymap, tile + (h * L::W_ATOMS + a) * L::ATOM, j * L::BN + a * 64, row0 + h * 64);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
    cluster_sync();
  }
}

typedef void (*WideKernel)(CUtensorMap, CUtensorMap, CUtensorMap, CUtensorMap, const float*, const float*, int, int,
                           int, int, int);
static const WideKernel wide_kernels[3] = {hopper_wide_ln_gemm_kernel<0>, hopper_wide_ln_gemm_kernel<1>,
                                           hopper_wide_ln_gemm_kernel<2>};

// As hopper_setup, for the streamed kernel's three instantiations.
static int wide_setup(int* clusters) {
  typedef WideLnGemm L;
  static int setup[64] = {}, n_clusters[64] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    cudaError_t err = cudaSuccess;
    for (int a = 0; a < 3 && err == cudaSuccess; ++a) {
      err = cudaFuncSetAttribute(wide_kernels[a], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
      cudaFuncAttributes attr;
      if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, wide_kernels[a]);
      if (err == cudaSuccess && attr.numRegs < L::BLOCK_REGS) err = cudaErrorInvalidConfiguration;
    }
    if (err == cudaSuccess) {
      cudaLaunchConfig_t cfg = {};
      cudaLaunchAttribute at[1];
      at[0].id = cudaLaunchAttributeClusterDimension;
      at[0].val.clusterDim.x = L::CLUSTER;
      at[0].val.clusterDim.y = 1;
      at[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(L::CLUSTER * 256);
      cfg.blockDim = dim3(L::THREADS);
      cfg.dynamicSmemBytes = L::SMEM;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n_clusters[dev], (void*)wide_kernels[0], &cfg);
      if (err == cudaSuccess && n_clusters[dev] < 1) err = cudaErrorInvalidConfiguration;
    }
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  *clusters = n_clusters[dev];
  return setup[dev] > 0 ? setup[dev] : 0;
}

static int launch_wide(const void* x, const void* w, const void* colsum, const void* bias, const void* res, void* y,
                       int M, int N, int K, int has_ln, int act, cudaStream_t stream) {
  typedef WideLnGemm L;
  int clusters = 0;
  int err = wide_setup(&clusters);
  if (err) return err;
  CUtensorMap maps[4];  // x (M, K), w (K, N) in pieces of 64 / CLUSTER rows, the residual and y (M, N)
  err = hopper::tma_map_bf16_2d(&maps[0], x, M, K, K, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[1], w, K, N, N, L::BK / L::CLUSTER, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[2], res != nullptr ? res : y, M, N, N, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[3], y, M, N, N, 64, 64);
  if (err) return err;
  const int n_panels = (M + L::ROWS - 1) / L::ROWS, nt = (N + L::BN - 1) / L::BN;
  const int chunk = wide_chunk(has_ln);
  const int need = (n_panels + L::CLUSTER - 1) / L::CLUSTER * ((nt + chunk - 1) / chunk);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = L::CLUSTER;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(L::CLUSTER * (need < clusters ? need : clusters));
  cfg.blockDim = dim3(L::THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, wide_kernels[act], maps[0], maps[1], maps[2], maps[3],
                                           static_cast<const float*>(colsum), static_cast<const float*>(bias),
                                           has_ln, (int)(res != nullptr), M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gw

// x (M, K), g/b (K,) or null (no LayerNorm), w (K, N), bias (N,) float32,
// res (M, N) or null, y (M, N); K a multiple of 64 up to 512, N of 8;
// x, w, res and y 16-byte aligned. dtype must be GW_BF16: the kernel takes
// bfloat16 only, and any other value returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int gw_ln_gemm(const void* x, const void* g, const void* b, const void* w,
                          const void* bias, const void* res, void* y, int M, int N, int K,
                          int dtype, void* stream) {
  if (K % 64 != 0 || K <= 0 || K > 512 || N % 8 != 0 || N <= 0 || M < 0 || dtype != GW_BF16)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return gw::launch_bf16(x, g, b, w, bias, res, y, M, N, K, static_cast<cudaStream_t>(stream));
}

// The streamed bfloat16 path (hopper_wide_ln_gemm_kernel): x (M, K), w (K,
// N) (with LayerNorm g (.) W as fused_block.py::ln_fold makes it), colsum
// (N,) float32, or null for no LayerNorm, bias (N,) float32 (with LayerNorm
// bias + b W), res (M, N) or null, y (M, N); act 0 none, 1 tanh GELU, 2 erf
// GELU; K a multiple of 64 up to 5120, N of 8; x, w, res and y 16-byte
// aligned. Returns a cudaError_t.
extern "C" int gw_ln_gemm_wide(const void* x, const void* w, const void* colsum, const void* bias,
                               const void* res, void* y, int M, int N, int K, int act, void* stream) {
  if (K % 64 != 0 || K <= 0 || K > gw::WideLnGemm::MAX_K || N % 8 != 0 || N <= 0 || M < 0 || act < 0 || act > 2)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  return gw::launch_wide(x, w, colsum, bias, res, y, M, N, K, (int)(colsum != nullptr), act,
                         static_cast<cudaStream_t>(stream));
}

// The bf16 kernel's cluster size and the number of its clusters resident
// on the card at once (the persistent grid is at most that many). Returns a
// cudaError_t.
extern "C" int gw_ln_gemm_clusters(int* cluster_size, int* clusters) {
  *cluster_size = gw::HopperLnGemm::CLUSTER;
  return gw::hopper_setup(clusters);
}

// The streamed kernel's cluster size, its tile (rows, columns) and the
// number of its clusters resident on the card at once. Returns a
// cudaError_t.
extern "C" int gw_ln_gemm_wide_clusters(int* cluster_size, int* tile_rows, int* tile_cols, int* clusters) {
  *cluster_size = gw::WideLnGemm::CLUSTER;
  *tile_rows = gw::WideLnGemm::ROWS;
  *tile_cols = gw::WideLnGemm::BN;
  return gw::wide_setup(clusters);
}