// Pieces shared by the wide persistent LSTM kernels (lstm_fwd_wide.cu,
// lstm_bwd_wide.cu): the layout of a block's W_hh slice between registers
// and shared memory, the warp's share of the recurrent product, and the
// launch (cooperative, with or without a thread-block cluster).
//
// The persistent kernels of lstm_persistent.cuh give a block 8 hidden units,
// so at H=2048 their grid (256 blocks) cannot be resident on an H100's 132
// SMs.  Here a block owns kWideUnits = 16 units, and its W_hh slice (K1: 64
// gate columns x H; K2: 16 rows x 4H, or a cluster's 16C rows x 4H/C) is
// 256 KB at H=2048, more than a block's 227 KB of shared memory.  So each
// warp takes a contiguous range of k-pairs (32 k) of the reduction and
// keeps the first kRegPairs of them as mma.sync B fragments in registers
// for the whole call ("Persistent RNNs", Diamos et al., ICML 2016); the
// rest of its range lies in shared memory, copied once a call.  Each warp
// computes all of the block's outputs over its k-range, and the eight
// warps' partial sums meet in shared memory in a fixed order (two calls are
// bit-equal).
//
// The exchange operand (K1: h_{t-1}, K2: dz_{t+1}) is read straight from the
// bf16 ping-pong buffer in device memory with ld.global.cg (L2 only, as in
// lstm_persistent.cuh), each element by exactly one warp of the block, a
// ring of k-pairs ahead of the products that use it.  The next step's
// inputs (x_proj, or K2's saved gates and state) are loaded between the
// grid barrier's two halves, where they overlap the wait.
//
// A profiling build (-DLSTM_WIDE_PHASES, port_tools/kernel_probe.py --kernel
// k1w|k2w --phases) sums, over the blocks, thread 0's clocks in each phase
// of a step: the grid barrier's wait, the products over the register-held
// and the shared-memory k-pairs (with their exchange loads), the warps'
// reduction, the cluster's exchange (K2), the cell epilogue; and the whole
// kernel.  -DLSTM_WIDE_SKIP_MMA leaves the products out (the exchange loads
// alone), -DLSTM_WIDE_SKIP_LOADS the exchange loads (the products alone):
// both give wrong results and exist only to split the product phase.

#pragma once

#include "lstm_persistent.cuh"

namespace lstm_wide {

using lstm_persistent::kPair;
using lstm_persistent::kThreads;
using lstm_persistent::kWarps;
using lstm_persistent::mma_bf16;
using lstm_persistent::round_up;

constexpr int kWideUnits = 16;     // hidden units per block
constexpr int kWideMaxTiles = 2;   // m16 tiles of rows: B <= 32
constexpr int kZSlotFloats = 1024; // a warp's share of the partial-sum tile

// Number of m16 tiles for B rows (1 or 2), 0 when B is too large.
inline int wide_tiles_for(int B) {
  return B <= 16 ? 1 : (B <= 32 ? 2 : 0);
}

// The k-pairs [p0, p1) that warp w takes of a range of n pairs.
__host__ __device__ inline void warp_range(int n, int w, int* p0, int* p1) {
  *p0 = w * n / kWarps;
  *p1 = (w + 1) * n / kWarps;
}

// Shared-memory k-pairs of a block whose range holds n pairs, given that each
// warp keeps its first reg_pairs in registers.  Warps' ranges differ by at
// most one pair, so when any warp has a pair in shared memory every warp
// fills its reg_pairs, and warp w's pair p0 + reg_pairs + i is slot
// p0 - w * reg_pairs + i.
__host__ __device__ constexpr int shared_pairs(int n, int reg_pairs) {
  return n > kWarps * reg_pairs ? n - kWarps * reg_pairs : 0;
}

#ifdef LSTM_WIDE_PHASES
// Phases: 0 barrier wait, 1 products over register-held pairs, 2 products
// over shared-memory pairs, 3 the warps' reduction, 4 the cluster's
// exchange, 5 the cell epilogue (and the next step's loads), 6 the kernel.
constexpr int kPhases = 7;
#define WIDE_TICK(i)                 \
  {                                  \
    const long long now = clock64(); \
    wide_ph[i] += now - wide_last;   \
    wide_last = now;                 \
  }
#else
#define WIDE_TICK(i)
#endif

// This warp's product over its k-pairs [p0, p1) of the exchange operand `a`
// (bf16 in device memory, 16 * kTiles rows of stride lda, zero-padded, read
// with ld.global.cg, kRing pairs ahead of the products) with kN n8 tiles of
// the W slice: the first kRegPairs pairs from `wreg` (B fragments held in
// registers), the rest from shared memory, where pair p0 + kRegPairs + i is
// the tile at ws + i * kN * 256 (kN * 8 columns of 32 k each: a lane's
// 16-byte read of columns grp and grp + 1 of a phase covers 128 contiguous
// bytes, free of bank conflicts).  The k index is permuted within each pair
// as in lstm_persistent.cuh's warp_product, A and B alike.  `mid` is called
// between the two parts.
template <int kTiles, int kN, int kRegPairs, int kRing, typename Mid>
__device__ __forceinline__ void wide_product(
    const __nv_bfloat16* a, int lda, const uint4 (&wreg)[kRegPairs][kN],
    const __nv_bfloat16* ws, int p0, int p1, float (&acc)[kTiles][kN][4],
    unsigned int& sink, Mid mid) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const __nv_bfloat16* ab = a + grp * lda + 8 * tq;
  const int n = p1 - p0;
  constexpr int kStep = kPair / 8;  // uint4 per pair

  auto load = [&](uint4 (&x)[kTiles][2], int p) {
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
#ifdef LSTM_WIDE_SKIP_LOADS
      x[mt][0] = make_uint4(p, mt, 1u, 2u);
      x[mt][1] = make_uint4(p, mt, 3u, 4u);
#else
      const uint4* r0 = reinterpret_cast<const uint4*>(
          ab + static_cast<size_t>(mt * 16) * lda);
      const uint4* r1 = reinterpret_cast<const uint4*>(
          ab + static_cast<size_t>(mt * 16 + 8) * lda);
      x[mt][0] = __ldcg(r0 + p * kStep);
      x[mt][1] = __ldcg(r1 + p * kStep);
#endif
    }
  };
  auto products = [&](const uint4 (&x)[kTiles][2], const uint4& b, int nt) {
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
#ifdef LSTM_WIDE_SKIP_MMA
      sink ^= x[mt][0].x ^ x[mt][0].w ^ x[mt][1].y ^ x[mt][1].z ^ b.x ^ b.w;
#else
      mma_bf16(acc[mt][nt], x[mt][0].x, x[mt][1].x, x[mt][0].y, x[mt][1].y,
               b.x, b.y);
      mma_bf16(acc[mt][nt], x[mt][0].z, x[mt][1].z, x[mt][0].w, x[mt][1].w,
               b.z, b.w);
#endif
    }
  };

  // A ring of kRing pairs of A in registers: pair i lives in slot
  // i % kRing, a compile-time index in both loops.
  uint4 ra[kRing][kTiles][2];
#pragma unroll
  for (int s = 0; s < kRing; ++s)
    if (s < n) load(ra[s], p0 + s);
#pragma unroll
  for (int i = 0; i < kRegPairs; ++i) {
    if (i < n) {
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
        products(ra[i % kRing], wreg[i][nt], nt);
      if (i + kRing < n) load(ra[i % kRing], p0 + i + kRing);
    }
  }
  mid();
  const __nv_bfloat16* wb = ws + grp * kPair + 8 * tq;
  for (int i = kRegPairs; i < n; i += kRing) {
#pragma unroll
    for (int s = 0; s < kRing; ++s) {
      const int ii = i + s;
      if (ii < n) {
        constexpr int kSlot = kN * 8 * kPair;
        const __nv_bfloat16* w = wb + (ii - kRegPairs) * kSlot;
#pragma unroll
        for (int nt = 0; nt < kN; ++nt)
          products(ra[(kRegPairs + s) % kRing],
                   *reinterpret_cast<const uint4*>(w + nt * 8 * kPair), nt);
        if (ii + kRing < n)
          load(ra[(kRegPairs + s) % kRing], p0 + ii + kRing);
      }
    }
  }
}

// Eight bf16 of a source row as one uint4: columns [k, k + 8) of row `row`
// (stride ld), zeros past K or where row < 0.  `vec`: rows start 16-byte
// aligned and K % 8 == 0.
__device__ __forceinline__ uint4 load8(const __nv_bfloat16* src, size_t ld,
                                       int row, int k, int K, bool vec) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (row < 0 || k >= K) return v;
  const __nv_bfloat16* p = src + static_cast<size_t>(row) * ld + k;
  if (vec) return *reinterpret_cast<const uint4*>(p);
  const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = k + i < K ? e[i] : 0u;
  return make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16),
                    w[4] | (w[5] << 16), w[6] | (w[7] << 16));
}

// Copies the block's W slice into registers and shared memory.  The block's
// k-pairs are [b0, b0 + nb) of the source, split over the warps by
// warp_range; column c (of kN * 8) of the slice is source row col_row(c)
// (negative: zeros), k contiguous in a row of stride ld, K valid.
template <int kN, int kRegPairs, typename ColRow>
__device__ __forceinline__ void load_slice(
    uint4 (&wreg)[kRegPairs][kN], __nv_bfloat16* ws,
    const __nv_bfloat16* src, size_t ld, int K, bool vec, int b0, int nb,
    ColRow col_row) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  int p0, p1;
  warp_range(nb, warp, &p0, &p1);
#pragma unroll
  for (int i = 0; i < kRegPairs; ++i)
#pragma unroll
    for (int nt = 0; nt < kN; ++nt)
      wreg[i][nt] = p0 + i < p1
                        ? load8(src, ld, col_row(nt * 8 + grp),
                                (b0 + p0 + i) * kPair + 8 * tq, K, vec)
                        : make_uint4(0u, 0u, 0u, 0u);
  // Shared slots: warp v's pairs past its first kRegPairs, in order.
  const int slots = shared_pairs(nb, kRegPairs);
  constexpr int kChunks = kN * 8 * (kPair / 8);  // 16-byte chunks a slot
  for (int idx = threadIdx.x; idx < slots * kChunks; idx += kThreads) {
    const int s = idx / kChunks;
    const int c = (idx % kChunks) / (kPair / 8);
    const int q = idx % (kPair / 8);
    // The warp v whose shared pairs hold slot s, and the pair.
    int v = 0, v0 = 0, v1 = 0;
    for (; v < kWarps; ++v) {
      warp_range(nb, v, &v0, &v1);
      const int first = v0 - v * kRegPairs;
      if (s >= first && s < first + (v1 - v0 - kRegPairs)) break;
    }
    const int p = b0 + v0 + kRegPairs + (s - (v0 - v * kRegPairs));
    *reinterpret_cast<uint4*>(ws + (static_cast<size_t>(s) * kN * 8 + c)
                                       * kPair + 8 * q) =
        load8(src, ld, col_row(c), p * kPair + 8 * q, K, vec);
  }
}

// Adds the eight warps' partial sums, written in fragment order (warp w's
// value i of lane l at zb[(w * kFrag + i) * 32 + l], kFrag values a lane),
// in a fixed order into warp 0's slot: each thread sums the positions
// tid, tid + kThreads, ...  Called between two __syncthreads.
template <int kFrag>
__device__ __forceinline__ void reduce_warps(float* zb) {
  constexpr int kPos = kFrag * 32;
#pragma unroll
  for (int pos = threadIdx.x; pos < kPos; pos += kThreads) {
    float s = zb[pos];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += zb[w * kPos + pos];
    zb[pos] = s;
  }
}

// Position in fragment order (as in reduce_warps's slots) of the sum for
// row r (0-15) of m16 tile mt and column col of kN n8 tiles: mma.sync's
// accumulator layout, lane grp * 4 + tq holding rows grp and grp + 8 and
// columns 2 tq and 2 tq + 1 of each n8 tile.
__device__ __forceinline__ int frag_pos(int mt, int kN, int r, int col) {
  const int c = col & 7;
  const int e = (r >> 3) * 2 + (c & 1);
  const int i = (mt * kN + (col >> 3)) * 4 + e;
  return i * 32 + (r & 7) * 4 + (c >> 1);
}

// Launches `kernel` cooperatively on `blocks` blocks of kThreads with `smem`
// bytes of dynamic shared memory, in clusters of `cluster` blocks (1: none;
// the H100 takes the cooperative and cluster attributes together), after
// checking that the whole grid can be resident at once (with clusters, by
// cudaOccupancyMaxActiveClusters, which counts the placements the GPCs
// allow); returns a CUDA error code (0: accepted).  The shared-memory limit
// is raised and the residency queried once per (kernel, smem, device), as in
// lstm_persistent.cuh's launch_cooperative.
inline int launch_wide(const void* kernel, int blocks, int cluster,
                       size_t smem, void** args, cudaStream_t stream) {
  struct Checked { const void* kernel; size_t smem; int dev; int resident; };
  static Checked checked[32];
  static int n_checked = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attrs[2];
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = cluster;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;

  int resident = -1;
  for (int i = 0; i < n_checked; ++i)
    if (checked[i].kernel == kernel && checked[i].smem == smem
        && checked[i].dev == dev)
      resident = checked[i].resident;
  if (resident < 0) {
    int optin = 0;
    resident = 0;
    if ((err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
            != cudaSuccess
        || (err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
               != cudaSuccess)
      return static_cast<int>(err);
    if (smem <= static_cast<size_t>(optin)) {
      if (cluster > 1) {
        cfg.attrs = attrs;
        cfg.numAttrs = 1;
        int clusters = 0;
        if ((err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg))
            != cudaSuccess)
          return static_cast<int>(err);
        resident = clusters * cluster;
      } else {
        int sms = 0, per_sm = 0;
        if ((err = cudaDeviceGetAttribute(
                 &sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess
            || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                    &per_sm, kernel, kThreads, smem)) != cudaSuccess)
          return static_cast<int>(err);
        resident = per_sm * sms;
      }
    }
    if (n_checked < 32) checked[n_checked++] = {kernel, smem, dev, resident};
  }
  if (resident < blocks || blocks > kThreads || blocks % cluster)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  // The cluster attribute only where there is a cluster.
  cfg.attrs = cluster > 1 ? attrs : attrs + 1;
  cfg.numAttrs = cluster > 1 ? 2 : 1;
  err = cudaLaunchKernelExC(&cfg, kernel, args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// lstm_persistent.cuh's grid barrier in two halves, so that a block can
// issue work that needs no other block between them.  grid_arrive: the
// block's writes are released and its flag published; a load issued before
// it would hold the release (thread 0's fence waits for its own loads), one
// issued after it overlaps the wait.  grid_wait: thread i < gridDim.x waits
// for block i's flag, then the block meets.
__device__ __forceinline__ void grid_arrive(unsigned int* flags,
                                            unsigned int epoch) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(flags + blockIdx.x * lstm_persistent::kFlagStride),
                    "r"(epoch)
                 : "memory");
}

__device__ __forceinline__ void grid_wait(const unsigned int* flags,
                                          unsigned int epoch) {
  if (threadIdx.x < gridDim.x) {
    const unsigned int* f = flags + threadIdx.x * lstm_persistent::kFlagStride;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(f) : "memory");
    } while (seen < epoch);
  }
  __syncthreads();
}

// The cluster's barrier: every thread of every block of the cluster arrives
// (release: its shared-memory writes become visible) and waits (acquire).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned int cluster_rank() {
  unsigned int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// The address of `p` (this block's shared memory) in block `rank`'s shared
// memory, in the cluster's shared window.
__device__ __forceinline__ unsigned int cluster_addr(const void* p,
                                                     unsigned int rank) {
  const unsigned int local =
      static_cast<unsigned int>(__cvta_generic_to_shared(p));
  unsigned int remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}

__device__ __forceinline__ float ld_cluster(unsigned int addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr)
               : "memory");
  return v;
}

}  // namespace lstm_wide
