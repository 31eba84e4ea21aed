// Kernel C: out = x + gelu(LN(x) . W1 + b1) . W2 + b2, the MLP half of one
// encoder layer.
//
// Replaces: gwkit/ops/fused_mlp.py::_mlp_kernel (K2) and the `mlp_tile`
// stage of gwkit/ops/fused_block.py::_attn_block_kernel (K3).
//
// Contract (fused_mlp.py:23-44): LN as kernel B's; fc1 accumulated in f32,
// + b1 in f32, rounded, GELU (tanh or erf by `approx`) on the rounded value,
// rounded again; fc2 accumulated in f32, + b2 in f32, rounded; + the
// UN-normalized x in f32, rounded once.
//
// Bound on the H100: FLOPs. At the main path's shapes (M = 65,536 rows,
// D = 384, F = 1536, bf16) the two products are 4MDF = 155 GFLOP (0.16 ms at
// the 989 TFLOP/s bf16 peak) against ~100 MB of x in and out (0.03 ms).
// Unfused, the (M, F) activation would add 2 x 200 MB of HBM traffic.
//
// bfloat16 (hopper_fused_mlp_kernel: the search and training): one
// persistent block on each SM, two consumer warpgroups sharing a panel of 64
// rows and a TMA producer warpgroup (setmaxnreg 40/232). The panel is loaded
// by TMA and normalized in place once; the block then walks F in 128-wide
// chunks:
//  * fc1: consumer c computes chunk columns 64c..64c+63 (m64n64k16, A the
//    normalized panel, B one MN-major atom of a W1 slice);
//  * + b1, round, GELU, round in registers, written as bf16 into its half
//    of a 64 x 128 swizzled K-major tile (two of them, alternating), and a
//    barrier of the 256 consumer threads;
//  * fc2: consumer c accumulates output columns (D/2)c..(D/2)(c+1)-1 in
//    registers (m64n192k16 at D = 384, 96 registers; m64n256k16 at
//    D = 512, 128), A the GELU tile, B its atoms of a W2 slice.
// So the (M, F) activation never reaches device memory, as in the TPU
// kernel, and a consumer holds at most fc1's 32 and fc2's 96 or 128
// accumulator registers. W1 and W2 stream through one ring of equal slices
// (D/4 rows of W1's chunk columns, or 32 rows of W2's; four of each a
// chunk); a slice is released to the producers as soon as its products
// complete, while the next slice's run. Every panel needs all of W1 and W2
// (2.36 MB at D = 384): blocks run in clusters of two along M, and each
// slice is read from L2 once a cluster, each block loading half its rows
// and multicasting them to both (L2 reads M / 128 x 2.36 MB a call, against
// M / 64 x 2.36 MB when each block reads its own). Once a panel's last fc1
// is done the producer loads the next panel's x, while the last fc2 and
// the epilogue run. Epilogue: + b2, round, + x (read again from global
// memory: the panel holds LN(x)), round, stored from registers, a quad's
// four column blocks transposed so a lane stores 16 bytes. Rows past M load
// as zeros and are not stored.
#include "common.cuh"
#include "hopper.cuh"

#ifndef GW_MLP_CLUSTER  // a comparison build may set another cluster size (1, 2 or 4)
#define GW_MLP_CLUSTER 2
#endif

namespace gw {

// ---- bfloat16: wgmma, TMA, the activation on chip, weights multicast -----------

template <int D> struct HopperMlp {
  static constexpr int ROWS = 64, CONSUMERS = 2, FC = 128;  // panel rows; F chunk (64 a consumer)
  static constexpr int CLUSTER = GW_MLP_CLUSTER;  // blocks sharing each W slice by multicast
  static constexpr int THREADS = CONSUMERS * 128 + 128;
  static constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232, BLOCK_REGS = 168;
  static_assert(PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= (CONSUMERS + 1) * BLOCK_REGS,
                "setmaxnreg budget exceeds the block's registers");
  static constexpr uint32_t CONSUMER_WARPS = CONSUMERS * 4;
  static constexpr int KA = D / 64;            // 64-column atoms across the panel (and across W2)
  static constexpr int NOUT = D / CONSUMERS;   // fc2 output columns a consumer: 192 or 256
  static constexpr int OUT_ATOMS = NOUT / 64;
  static constexpr uint32_t ATOM = 64 * 64 * sizeof(bf16);  // 8 KB: a 64 x 64 panel or GELU atom
  // A W2 ring slice: 32 rows (F) of all D columns, as KA atoms of 32 rows;
  // a W1 slice fills the same bytes: D / 4 rows (D) of the chunk's 128
  // columns, as two atoms of D / 4 rows. Either takes 4 stages a chunk.
  static constexpr int W2_ROWS = 32, W1_ROWS = D / 4;
  static constexpr uint32_t W2_ATOM = W2_ROWS * 64 * sizeof(bf16), W1_ATOM = W1_ROWS * 64 * sizeof(bf16);
  static constexpr int W1_STAGES = D / W1_ROWS, W2_STAGES = FC / W2_ROWS;
  static constexpr uint32_t STAGE = KA * W2_ATOM;
  static_assert(2 * W1_ATOM == STAGE, "a W1 slice fills a stage");
  // shared memory, 1024-aligned: barriers | panel (KA atoms) | GELU tiles [2][2 atoms] | ring
  static constexpr size_t BAR_BYTES = 1024, PANEL_OFF = BAR_BYTES;
  static constexpr size_t H_OFF = PANEL_OFF + (size_t)KA * ATOM;
  static constexpr size_t RING_OFF = H_OFF + 4 * (size_t)ATOM;
  static constexpr size_t SMEM_LIMIT = 232448;
  static constexpr int MAX_STAGES = 8;
  static constexpr int LN_ROWS = D == 384 ? 4 : 2;  // rows a warp normalizes at once (registers at D = 512)
  static constexpr int STAGES_FIT = (int)((SMEM_LIMIT - 1024 - RING_OFF) / STAGE);
  static constexpr int STAGES = STAGES_FIT < MAX_STAGES ? STAGES_FIT : MAX_STAGES;
  static constexpr size_t SMEM = 1024 + RING_OFF + (size_t)STAGES * STAGE;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BAR_BYTES >= (2 + 2 * MAX_STAGES) * sizeof(uint64_t), "barriers");
};

template <int D>
__global__ void __launch_bounds__(HopperMlp<D>::THREADS, 1)
hopper_fused_mlp_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap w1map,
                        const __grid_constant__ CUtensorMap w2map, const bf16* __restrict__ x,
                        bf16* __restrict__ out, const bf16* __restrict__ g, const bf16* __restrict__ b,
                        const float* __restrict__ b1, const float* __restrict__ b2, int M, int F, int approx) {
  typedef HopperMlp<D> L;
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  // panel_full: the producer, + bytes; panel_empty: every consumer warp,
  // its last product on the panel complete; full[s]: the producer, + bytes
  // from every block's half; empty[s]: every consumer warp of every block of
  // the cluster
  uint64_t *panel_full = bars, *panel_empty = bars + 1, *full = bars + 2, *empty = bars + 2 + L::STAGES;
  auto panel = [&](int a) { return smem + L::PANEL_OFF + (size_t)a * L::ATOM; };
  auto h_tile = [&](int buf) { return smem + L::H_OFF + (size_t)buf * 2 * L::ATOM; };
  auto stage = [&](int s) { return smem + L::RING_OFF + (size_t)s * L::STAGE; };

  if (threadIdx.x == 0) {
    mbar_init(panel_full, 1);
    mbar_init(panel_empty, L::CONSUMER_WARPS);
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], L::CONSUMER_WARPS * L::CLUSTER);
    }
    mbar_init_fence();
  }
  cluster_sync();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_chunks = F / L::FC, n_panels = (M + L::ROWS - 1) / L::ROWS;
  const int rank = (int)cluster_rank();
  // the blocks of a cluster walk the same rounds (see kernel B)
  const int first = (int)cluster_id_x() * L::CLUSTER, step = (int)n_clusters_x() * L::CLUSTER;

  if (warp >= (int)L::CONSUMER_WARPS) {  // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(L::PRODUCER_REGS));
    if (warp == (int)L::CONSUMER_WARPS && lane == 0) {
      Ring ring(L::STAGES);
      const uint16_t mask = (1u << L::CLUSTER) - 1;
      constexpr int P1 = L::W1_ROWS / L::CLUSTER, P2 = L::W2_ROWS / L::CLUSTER;  // rows this block loads
      int it = 0;
      for (int base = first; base < n_panels; base += step, ++it) {
        const int row0 = (base + rank) * L::ROWS;
        mbar_wait(panel_empty, (it & 1) ^ 1);
        if (row0 < M) {
          mbar_arrive_expect_tx(panel_full, L::KA * L::ATOM);
          for (int a = 0; a < L::KA; ++a) tma_load_2d(panel(a), &xmap, panel_full, a * 64, row0);
        } else {
          mbar_arrive(panel_full);
        }
        for (int ci = 0; ci < n_chunks; ++ci) {
          for (int s = 0; s < L::W1_STAGES; ++s) {  // W1 rows (D) of the slice, the chunk's columns as two atoms
            mbar_wait(&empty[ring.idx], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.idx], L::STAGE);
            for (int a = 0; a < 2; ++a)
              tma_load_2d_multicast(stage(ring.idx) + a * L::W1_ATOM + rank * P1 * 128, &w1map, &full[ring.idx],
                                    ci * L::FC + a * 64, s * L::W1_ROWS + rank * P1, mask);
            ring.advance();
          }
          for (int s = 0; s < L::W2_STAGES; ++s) {  // W2 rows (F) of the chunk, all D columns
            mbar_wait(&empty[ring.idx], ring.phase ^ 1);
            mbar_arrive_expect_tx(&full[ring.idx], L::STAGE);
            for (int a = 0; a < L::KA; ++a)
              tma_load_2d_multicast(stage(ring.idx) + a * L::W2_ATOM + rank * P2 * 128, &w2map, &full[ring.idx],
                                    a * 64, ci * L::FC + s * L::W2_ROWS + rank * P2, mask);
            ring.advance();
          }
        }
      }
    }
    cluster_sync();
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(L::CONSUMER_REGS));
    const int c = warp >> 2, wl = warp & 3, gq = lane >> 2, x4 = lane & 3;
    RingConsumer<L::CLUSTER> ring(L::STAGES, empty, rank, lane);
    int it = 0;
    for (int base = first; base < n_panels; base += step, ++it) {
      const int row0 = (base + rank) * L::ROWS;
      mbar_wait(panel_full, it & 1);
      ln_rows_sw128<L::LN_ROWS>(panel(0), L::ATOM, warp, L::CONSUMER_WARPS, L::ROWS, D, g, b, lane);
      fence_proxy_async();
      named_bar_sync(1, L::CONSUMERS * 128);

      float acc2[L::NOUT / 2];
      for (int ci = 0; ci < n_chunks; ++ci) {
        float2 bv[8];  // this thread's b1 pairs of the chunk, loaded while fc1 runs
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = *reinterpret_cast<const float2*>(b1 + ci * L::FC + c * 64 + 8 * j + 2 * x4);
        // fresh accumulators: their registers are not live across the LN,
        // the GELU or the epilogue (the first product overwrites them anyway)
        float acc1[32];
#pragma unroll
        for (int q = 0; q < 32; ++q) acc1[q] = 0.f;
        if (ci == 0)
#pragma unroll
          for (int q = 0; q < L::NOUT / 2; ++q) acc2[q] = 0.f;
        for (int s = 0; s < L::W1_STAGES; ++s) {
          mbar_wait(&full[ring.at.idx], ring.at.phase);
          const uint64_t bdesc = desc_mnmajor(stage(ring.at.idx) + c * L::W1_ATOM);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < L::W1_ROWS / 16; ++kk) {
            const int k16 = s * (L::W1_ROWS / 16) + kk;  // depth step over D (16 columns of the panel)
            wgmma_ss<64, 1>(acc1, desc_kmajor(panel(k16 >> 2)) + 2 * (k16 & 3), bdesc + 128 * kk, s > 0 || kk > 0);
          }
          ring.committed();
        }
        ring.drain();
        reg_fence(acc1);
        // the panel's last read: the producer may load the next panel's x
        // while this one's last fc2 and epilogue run
        if (ci == n_chunks - 1 && lane == 0) mbar_arrive(panel_empty);
        // + b1, round, GELU, round: this consumer's 64 columns of the chunk's tile
        unsigned char* ht = h_tile(ci & 1) + c * L::ATOM;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = 8 * j + 2 * x4;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const float2 h = round_bf16x2(acc1[4 * j + 2 * i] + bv[j].x, acc1[4 * j + 2 * i + 1] + bv[j].y);
            *reinterpret_cast<uint32_t*>(ht + sw128(wl * 16 + gq + 8 * i, col)) =
                pack_bf16(gelu(h.x, approx), gelu(h.y, approx));
          }
        }
        fence_proxy_async();
        named_bar_sync(1, L::CONSUMERS * 128);  // both halves of the tile written
        const unsigned char* hbase = h_tile(ci & 1);
        for (int s = 0; s < L::W2_STAGES; ++s) {
          mbar_wait(&full[ring.at.idx], ring.at.phase);
          const uint64_t bdesc = desc_mnmajor_atoms(stage(ring.at.idx) + c * L::OUT_ATOMS * L::W2_ATOM, L::W2_ATOM);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < L::W2_ROWS / 16; ++kk) {
            const int k16 = s * (L::W2_ROWS / 16) + kk;  // depth step of the chunk (16 F columns)
            wgmma_ss<L::NOUT, 1>(acc2, desc_kmajor(hbase + (k16 >> 2) * L::ATOM) + 2 * (k16 & 3),
                                 bdesc + 128 * kk, ci > 0 || s > 0 || kk > 0);
          }
          ring.committed();
        }
      }
      ring.drain();
      reg_fence(acc2);

      // epilogue: out = round(x + round(acc2 + b2)), stored from registers:
      // each quad transposes four column blocks so a lane stores 16
      // contiguous bytes
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + wl * 16 + gq + 8 * i;
#pragma unroll
        for (int grp = 0; grp < L::NOUT / 32; ++grp) {
          const int col16 = c * L::NOUT + 32 * grp + 8 * x4;  // this lane's 16 bytes after the transpose
          uint32_t xw[4] = {0u, 0u, 0u, 0u};  // x at this thread's columns of blocks 4 grp + q
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (row < M)
              xw[q] = *reinterpret_cast<const uint32_t*>(x + (long long)row * D + c * L::NOUT + 8 * (4 * grp + q) + 2 * x4);
          uint32_t ow[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int j = 4 * grp + q, col = c * L::NOUT + 8 * j + 2 * x4;
            const float2 bw = *reinterpret_cast<const float2*>(b2 + col);
            const float2 y = round_bf16x2(acc2[4 * j + 2 * i] + bw.x, acc2[4 * j + 2 * i + 1] + bw.y);
            const __nv_bfloat162 xp = *reinterpret_cast<const __nv_bfloat162*>(&xw[q]);
            ow[q] = pack_bf16(__low2float(xp) + y.x, __high2float(xp) + y.y);
          }
          quad_transpose(ow, x4);
          if (row < M)
            *reinterpret_cast<uint4*>(out + (long long)row * D + col16) = make_uint4(ow[0], ow[1], ow[2], ow[3]);
        }
      }
    }
    cluster_sync();
  }
}

// the tensor maps of one call: x (M, D), w1 (D, F), w2 (F, D)
template <int D>
static int encode_maps(CUtensorMap (&maps)[3], const void* x, const void* w1, const void* w2, int M, int F) {
  typedef HopperMlp<D> L;
  int err = hopper::tma_map_bf16_2d(&maps[0], x, M, D, D, 64, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[1], w1, D, F, F, L::W1_ROWS / L::CLUSTER, 64);
  if (!err) err = hopper::tma_map_bf16_2d(&maps[2], w2, F, D, D, L::W2_ROWS / L::CLUSTER, 64);
  return err;
}

// The launch configuration of a cluster of CLUSTER blocks.
template <int D> struct MlpLaunch {
  cudaLaunchAttribute at[1];
  cudaLaunchConfig_t cfg = {};
  MlpLaunch() {
    typedef HopperMlp<D> L;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = L::CLUSTER;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.blockDim = dim3(L::THREADS);
    cfg.dynamicSmemBytes = L::SMEM;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
};

// Once a device: the shared-memory limit, the register check (as kernel
// B's) and the number of clusters that fit on the card at once. Returns a
// cudaError_t.
template <int D> static int mlp_setup(int* clusters) {
  typedef HopperMlp<D> L;
  static int setup[64] = {}, n_clusters[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (setup[dev] == 0) {
    auto kernel = hopper_fused_mlp_kernel<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
    cudaFuncAttributes attr;
    if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
    if (err == cudaSuccess && attr.numRegs < L::BLOCK_REGS) err = cudaErrorInvalidConfiguration;
    if (err == cudaSuccess) {
      MlpLaunch<D> l;
      l.cfg.gridDim = dim3(L::CLUSTER * 256);
      err = cudaOccupancyMaxActiveClusters(&n_clusters[dev], (void*)kernel, &l.cfg);
      if (err == cudaSuccess && n_clusters[dev] < 1) err = cudaErrorInvalidConfiguration;
    }
    setup[dev] = err == cudaSuccess ? -1 : (int)err;
  }
  *clusters = n_clusters[dev];
  return setup[dev] > 0 ? setup[dev] : 0;
}

template <int D>
static int launch_bf16(const void* x, const void* g, const void* b, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int M, int F, int approx, cudaStream_t stream) {
  typedef HopperMlp<D> L;
  int clusters = 0;
  int err = mlp_setup<D>(&clusters);
  if (err) return err;
  CUtensorMap maps[3];
  err = encode_maps<D>(maps, x, w1, w2, M, F);
  if (err) return err;
  const int need = ((M + L::ROWS - 1) / L::ROWS + L::CLUSTER - 1) / L::CLUSTER;
  MlpLaunch<D> l;
  l.cfg.gridDim = dim3(L::CLUSTER * (need < clusters ? need : clusters));
  l.cfg.stream = stream;
  cudaError_t e = cudaLaunchKernelEx(&l.cfg, hopper_fused_mlp_kernel<D>, maps[0], maps[1], maps[2],
                                     static_cast<const bf16*>(x), static_cast<bf16*>(out), static_cast<const bf16*>(g),
                                     static_cast<const bf16*>(b), static_cast<const float*>(b1),
                                     static_cast<const float*>(b2), M, F, approx);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace gw

// x (M, D), g/b (D,), w1 (D, F), b1 (F,) f32, w2 (F, D), b2 (D,) f32, out (M, D).
// D is 384 (whisper-tiny) or 512 (whisper-base); F a multiple of 128; x,
// w1, w2 and out 16-byte aligned. dtype must be GW_BF16: the kernel takes
// bfloat16 only, and any other value returns cudaErrorInvalidValue.
// Returns a cudaError_t.
extern "C" int gw_fused_mlp(const void* x, const void* g, const void* b, const void* w1,
                            const void* b1, const void* w2, const void* b2, void* out, int M,
                            int D, int F, int approx, int dtype, void* stream) {
  if (M < 0 || F <= 0 || F % 128 != 0 || (D != 384 && D != 512) || dtype != GW_BF16)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 384 ? gw::launch_bf16<384>(x, g, b, w1, b1, w2, b2, out, M, F, approx, s)
                  : gw::launch_bf16<512>(x, g, b, w1, b1, w2, b2, out, M, F, approx, s);
}

// The bf16 kernel's cluster size and the number of its clusters resident
// on the card at once (the persistent grid is at most that many); D is 384
// or 512. Returns a cudaError_t.
extern "C" int gw_fused_mlp_clusters(int D, int* cluster_size, int* clusters) {
  if (D != 384 && D != 512) return (int)cudaErrorInvalidValue;
  *cluster_size = gw::HopperMlp<384>::CLUSTER;
  return D == 384 ? gw::mlp_setup<384>(clusters) : gw::mlp_setup<512>(clusters);
}
