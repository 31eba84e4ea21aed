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
//
// float32 (ln_gemm_kernel, CPU-equivalent checks and the f32 tasks): PR 1's
// kernel. A block owns 64 rows x 128 columns, stages its 64 x K panel of x
// in shared memory, normalizes it there, streams W through two shared
// buffers with cp.async and accumulates with plain f32 FMA (no TF32), then
// fuses bias, rounding and the residual add into the store.
#include "common.cuh"
#include "hopper.cuh"

#ifndef GW_LN_GEMM_CLUSTER  // a comparison build may set another cluster size (1, 2 or 4)
#define GW_LN_GEMM_CLUSTER 2
#endif

namespace gw {

// ---- float32: FMA tiles in shared memory -------------------------------------


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

static int launch_f32(const void* x, const void* g, const void* b, const void* w, const void* bias,
                      const void* res, void* y, int M, int N, int K, cudaStream_t stream) {
  typedef LnGemm<float> L;
  static bool attr_set = false;  // once a process: the shared-memory limit of the largest K
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(ln_gemm_kernel<float>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)L::smem(512));
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  if (K > 512) return (int)cudaErrorInvalidValue;
  dim3 grid((N + L::BN - 1) / L::BN, (M + L::BM - 1) / L::BM);
  ln_gemm_kernel<float><<<grid, kThreads, L::smem(K), stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<const float*>(w), static_cast<const float*>(bias), static_cast<const float*>(res),
      static_cast<float*>(y), M, N, K);
  return (int)cudaGetLastError();
}

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
// memory, so nothing is held whole: an item is a 128 x 192 output tile,
// and each ring stage brings its 128 x 64 slice of x (one K-major atom a
// consumer warpgroup) and the matching 64 x 192 slice of W (three MN-major
// atoms; the two blocks of a cluster work on panels 2p, 2p + 1 of the same
// column tile, each loading half of W's slice and multicasting it), four
// stages deep. A consumer accumulates its 64 x 192 tile in 96 registers
// (m64n192k16). On the H100 at the 1280-wide layer's launches, 192 columns
// with four stages measured 1.31x faster over the four launches than 256
// with three, and 1.10x faster than 128 with six; clusters of 4 or 1 were
// slower than 2 (PERF.md, section 6).
//
// LayerNorm is folded, as a row panel cannot be normalized in place:
// LN(x) W + bias = rstd (x W' - mean colsum(W')) + bias + b W, with
// W' = g (.) W rounded to bf16 and colsum(W') and bias + b W in f32, made
// once by the wrapper (fused_block.py::ln_fold). While the products of a
// stage run, each consumer thread reads its two accumulator rows' 16 x
// values of the slice and adds them to a running mean and sum of squared
// deviations (Chan's update, per slice: no cancellation at large means),
// after the stage's products are committed and the previous stage's waited
// for (1.07x faster over the four launches than before the commit);
// the quad's four lanes combine theirs after the last slice, and the
// epilogue applies rstd and the mean's correction. So LN costs no pass of
// its own, and the function differs from the panel path's only where that
// path rounds LN(x) to bf16 before the product (this one keeps x exact and
// rounds g (.) W instead).
//
// Items are walked panel-major (the column tiles of a panel pair run on
// neighbouring clusters, so x is read from HBM about once); the epilogue
// is B's: residual by TMA into the warpgroup's 64 x 192 staging tile,
// bias, rounding, GELU, residual add on the accumulators, TMA store.
struct WideLnGemm {
  static constexpr int ROWS = 64, CONSUMERS = 2, PANEL_ROWS = CONSUMERS * ROWS;
  static constexpr int BN = 192, BK = 64, MAX_K = 5120, MAX_STAGES = 8;
  static constexpr int CLUSTER = GW_LN_GEMM_CLUSTER;
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232, BLOCK_REGS = 168;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t CONSUMER_WARPS = CONSUMERS * 4;
  static constexpr uint32_t ATOM = 64 * 64 * sizeof(bf16);  // 8 KB
  static constexpr int W_ATOMS = BN / 64;
  static constexpr uint32_t X_BYTES = CONSUMERS * ATOM;     // a stage's 128 x 64 slice of x
  static constexpr uint32_t STAGE = X_BYTES + W_ATOMS * ATOM;  // + its 64 x 192 slice of W: 40 KB
  static constexpr uint32_t OUT_TILE = W_ATOMS * ATOM;      // a warpgroup's 64 x 192 output tile
  // shared memory, 1024-aligned: barriers | staging[warpgroup] | ring
  static constexpr size_t BAR_BYTES = 1024, OUT_OFF = BAR_BYTES, RING_OFF = OUT_OFF + CONSUMERS * OUT_TILE;
  static constexpr int FIT = (int)((HopperLnGemm::SMEM_LIMIT - 1024 - RING_OFF) / STAGE);
  static constexpr int STAGES = FIT < MAX_STAGES ? FIT : MAX_STAGES;  // 4
  static constexpr size_t SMEM = 1024 + RING_OFF + STAGES * STAGE;  // 1024: alignment slack
};
static_assert(WideLnGemm::STAGES >= 2 && WideLnGemm::SMEM <= HopperLnGemm::SMEM_LIMIT, "shared memory");
static_assert(WideLnGemm::BAR_BYTES >= (2 + 2 * WideLnGemm::STAGES) * sizeof(uint64_t), "barriers");

// Chan's update of a running (mean, m2) over n values with the 16 values of
// row r, columns 16x .. 16x + 15, of a swizzled 64 x 64 atom of x.
__device__ __forceinline__ void row_stats16(const unsigned char* atom, int r, int x, float n, float& mean,
                                            float& m2) {
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
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) s += v[e];
  const float mb = s * (1.f / 16.f);
  float q = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) q += (v[e] - mb) * (v[e] - mb);
  const float delta = mb - mean, total = n + 16.f;
  mean += delta * (16.f / total);
  m2 += q + delta * delta * (n * 16.f / total);
}

__global__ void __launch_bounds__(WideLnGemm::THREADS, 1)
hopper_wide_ln_gemm_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                           const __grid_constant__ CUtensorMap rmap, const __grid_constant__ CUtensorMap ymap,
                           const float* __restrict__ colsum, const float* __restrict__ bias, int has_ln, int act,
                           int has_res, int M, int N, int K) {
  typedef WideLnGemm L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // full[s]: the producer, + bytes (x from this block, W from every block);
  // empty[s]: every consumer warp of every block of the cluster;
  // out_ready[wg]: the warpgroup's first thread (+ the residual's bytes)
  uint64_t *full = bars, *empty = bars + L::STAGES, *out_ready = bars + 2 * L::STAGES;
  auto out_tile = [&](int wg) { return smem + L::OUT_OFF + (size_t)wg * L::OUT_TILE; };
  auto x_atom = [&](int s, int wg) { return smem + L::RING_OFF + (size_t)s * L::STAGE + (size_t)wg * L::ATOM; };
  auto w_slice = [&](int s) { return smem + L::RING_OFF + (size_t)s * L::STAGE + L::X_BYTES; };

  if (threadIdx.x == 0) {
    for (int i = 0; i < L::CONSUMERS; ++i) mbar_init(&out_ready[i], 1);
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::CONSUMER_WARPS * L::CLUSTER);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the partner's barriers are initialized before any multicast or remote arrive

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kt = K / L::BK, nt = (N + L::BN - 1) / L::BN;
  const int n_panels = (M + L::PANEL_ROWS - 1) / L::PANEL_ROWS;
  // item i: panels CLUSTER (i / nt) + rank of column tile i % nt; the
  // blocks of a cluster walk the same items, so each takes part in every
  // multicast; a panel past M computes on whatever its stages hold and
  // stores nothing
  const int n_items = (n_panels + L::CLUSTER - 1) / L::CLUSTER * nt;
  const int rank = (int)cluster_rank();
  const int first = (int)cluster_id_x(), step = (int)n_clusters_x();

  if (warp >= (int)L::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == (int)L::CONSUMER_WARPS && lane == 0) {
      Ring ring(L::STAGES);
      const uint16_t mask = (1u << L::CLUSTER) - 1;
      constexpr int PIECE_ROWS = L::BK / L::CLUSTER;  // W rows this block loads for the cluster
      for (int item = first; item < n_items; item += step) {
        const int p = item / nt * L::CLUSTER + rank, j = item % nt;
        uint32_t x_bytes = 0;
        for (int c = 0; c < L::CONSUMERS; ++c)
          if (p * L::PANEL_ROWS + c * L::ROWS < M) x_bytes += L::ATOM;
        int w_atoms = 0;  // the atoms of the column tile that start inside N
        for (int a = 0; a < L::W_ATOMS; ++a)
          if (j * L::BN + a * 64 < N) ++w_atoms;
        for (int s = 0; s < kt; ++s) {
          mbar_wait(&empty[ring.idx], ring.phase ^ 1);
          mbar_arrive_expect_tx(&full[ring.idx], x_bytes + (uint32_t)w_atoms * L::ATOM);
          for (int c = 0; c < L::CONSUMERS; ++c) {
            const int row0 = p * L::PANEL_ROWS + c * L::ROWS;
            if (row0 < M) tma_load_2d(x_atom(ring.idx, c), &xmap, &full[ring.idx], s * L::BK, row0);
          }
          for (int a = 0; a < w_atoms; ++a)
            tma_load_2d_multicast(w_slice(ring.idx) + a * L::ATOM + rank * PIECE_ROWS * 128, &wmap,
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
    RingConsumer<L::CLUSTER> ring(L::STAGES, empty, rank, lane);
    uint32_t out_phase = 0;
    for (int item = first; item < n_items; item += step) {
      const int p = item / nt * L::CLUSTER + rank, j = item % nt;
      const int row0 = p * L::PANEL_ROWS + wg * L::ROWS;
      if (leader) {  // the staging tile is free once the last store has read it
        bulk_wait_read();
        if (has_res && row0 < M) {
          uint32_t bytes = 0;
          for (int a = 0; a < L::W_ATOMS; ++a)
            if (j * L::BN + a * 64 < N) bytes += L::ATOM;
          mbar_arrive_expect_tx(&out_ready[wg], bytes);
          for (int a = 0; a < L::W_ATOMS; ++a)
            if (j * L::BN + a * 64 < N)
              tma_load_2d(out_tile(wg) + a * L::ATOM, &rmap, &out_ready[wg], j * L::BN + a * 64, row0);
        } else {
          mbar_arrive(&out_ready[wg]);
        }
      }
      // this thread's accumulator rows wl * 16 + gq + 8 i: running mean and
      // sum of squared deviations over its 16 columns of each slice
      float mean[2] = {0.f, 0.f}, m2[2] = {0.f, 0.f};
      float acc[L::BN / 2];
      for (int s = 0; s < kt; ++s) {
        mbar_wait(&full[ring.at.idx], ring.at.phase);
        const unsigned char* xs = x_atom(ring.at.idx, wg);
        const uint64_t adesc = desc_kmajor(xs);
        const uint64_t bdesc = desc_mnmajor_atoms(w_slice(ring.at.idx), L::ATOM);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_ss<L::BN, 1>(acc, adesc + 2 * kk, bdesc + 128 * kk, s > 0 || kk > 0);
        ring.committed();
        if (has_ln) {  // read while the products run; the stage is released only after the next stage's
#pragma unroll
          for (int i = 0; i < 2; ++i) row_stats16(xs, wl * 16 + gq + 8 * i, x, 16.f * (float)s, mean[i], m2[i]);
        }
      }
      ring.drain();
      reg_fence(acc);
      float rstd[2] = {1.f, 1.f};
      if (has_ln) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
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
      }

      // epilogue: y = round(rstd (acc - mean colsum) + bias) [GELU, round]
      // [+ residual, rounded once], in the staging tile
      mbar_wait(&out_ready[wg], out_phase);
      out_phase ^= 1u;
      unsigned char* tile = out_tile(wg);
#pragma unroll
      for (int jj = 0; jj < L::BN / 8; ++jj) {
        const int col = jj * 8 + 2 * x, n = j * L::BN + col;
        const bool inside = n < N;
        const float2 bv = inside ? *reinterpret_cast<const float2*>(bias + n) : make_float2(0.f, 0.f);
        const float2 cv = inside && has_ln ? *reinterpret_cast<const float2*>(colsum + n) : make_float2(0.f, 0.f);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = wl * 16 + gq + 8 * i;
          float a0 = acc[4 * jj + 2 * i], a1 = acc[4 * jj + 2 * i + 1];
          if (has_ln) {
            a0 = (a0 - mean[i] * cv.x) * rstd[i];
            a1 = (a1 - mean[i] * cv.y) * rstd[i];
          }
          float2 v = round_bf16x2(a0 + bv.x, a1 + bv.y);
          if (act) v = round_bf16x2(gelu(v.x, act == 1), gelu(v.y, act == 1));
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(tile + (col >> 6) * L::ATOM + sw128(r, col & 63));
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
        for (int a = 0; a < L::W_ATOMS; ++a)
          if (j * L::BN + a * 64 < N) tma_store_2d(&ymap, tile + a * L::ATOM, j * L::BN + a * 64, row0);
        bulk_commit();
      }
    }
    if (leader) bulk_wait();
    cluster_sync();
  }
}

// As hopper_setup, for the streamed kernel.
static int wide_setup(int* clusters) {
  typedef WideLnGemm L;
  static int setup[64] = {}, n_clusters[64] = {};
  int dev = 0;
  const cudaError_t derr = cudaGetDevice(&dev);
  if (derr != cudaSuccess) return (int)derr;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    cudaError_t err = cudaFuncSetAttribute(hopper_wide_ln_gemm_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, hopper_wide_ln_gemm_kernel);
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
      cfg.dynamicSmemBytes = L::SMEM;
      cfg.attrs = at;
      cfg.numAttrs = 1;
      err = cudaOccupancyMaxActiveClusters(&n_clusters[dev], (void*)hopper_wide_ln_gemm_kernel, &cfg);
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
  CUtensorMap maps[4];
  err = encode_maps(maps, x, w, res, y, M, N, K);
  if (err) return err;
  const int n_panels = (M + L::PANEL_ROWS - 1) / L::PANEL_ROWS;
  const int need = (n_panels + L::CLUSTER - 1) / L::CLUSTER * ((N + L::BN - 1) / L::BN);
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
  const cudaError_t e = cudaLaunchKernelEx(&cfg, hopper_wide_ln_gemm_kernel, maps[0], maps[1], maps[2], maps[3],
                                           static_cast<const float*>(colsum), static_cast<const float*>(bias),
                                           has_ln, act, (int)(res != nullptr), M, N, K);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gw

// x (M, K), g/b (K,) or null (no LayerNorm), w (K, N), bias (N,) float32,
// res (M, N) or null, y (M, N); K a multiple of 64 up to 512, N of 8;
// x, w, res and y 16-byte aligned. Returns a cudaError_t.
extern "C" int gw_ln_gemm(const void* x, const void* g, const void* b, const void* w,
                          const void* bias, const void* res, void* y, int M, int N, int K,
                          int dtype, void* stream) {
  if (K % 64 != 0 || K <= 0 || K > 512 || N % 8 != 0 || N <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == GW_F32) return gw::launch_f32(x, g, b, w, bias, res, y, M, N, K, s);
  if (dtype == GW_BF16) return gw::launch_bf16(x, g, b, w, bias, res, y, M, N, K, s);
  return (int)cudaErrorInvalidValue;
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
