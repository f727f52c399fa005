// K2, wide persistent: the backward LSTM recurrence (BPTT) in one launch per
// call at H up to 2,048 and B <= 32, written by hand for Hopper (sm_90a).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_bwd_kernel (reached
// through _bwd_pallas_call), with the same function and rounding points as
// the per-step and persistent K2 (lstm_bwd.cu, lstm_bwd_persistent.cu).
// Walking t from T-1 down to 0, with dh and dc the carries into row t:
//
//   dh     = bf16(dz_{t+1}) @ W_hh^T + (1 - v_{t+1}) * dh    (t < T-1)
//   dh_tot = dys[t] + dh;     tc = tanh(c_t)
//   do     = dh_tot * tc;     dc_tot = dc + dh_tot * o * (1 - tc^2)
//   dz_t   = [dc_tot*g * i(1-i), dc_tot*c_{t-1} * f(1-f),
//             dc_tot*i * (1-g^2), do * o(1-o)] * v_t          (fp32 out)
//   dc    <- dc_tot * f * v_t + (1 - v_t) * dc
//
// and, with need_dh0, dh0 = bf16(dz_0) @ W_hh^T + (1 - v_0) * dh as a last
// phase of the same launch.  Outputs: dz (T,B,4H) fp32, dh0 and dc0 (B,H).
// DeepSpeech1's BiLSTM-2048 takes this route in training.
//
// What bounds it on the card: a serial chain of T steps, each a (B x 4H) @
// (4H x H) product that needs all of dz_{t+1} (32 x 8192 bf16: 512 KB at
// B=32, H=2048), four times the h that K1 exchanges.  The per-step K2 read
// that broadcast from L2 into each of its 256 blocks, some 134 MB a step
// beside its W_hh slices.
//
// What the design does about it (lstm_wide.cuh):
// - one launch; blocks in clusters of C (1 or 2; the route takes 2): a
//   cluster owns 16C hidden units j for all B <= 32 rows, and its block of
//   rank r takes the r-th C-th of the reduction index k (4H): it holds rows
//   j of W_hh (16C x 4H/C bf16, 256 KB at H=2048 whatever C) on chip for the
//   whole call, each warp's first 8/C k-pairs as B fragments in registers
//   (64 registers a thread), the rest in shared memory (192 KB), and it
//   reads only its k-range of dz_{t+1}: 512 KB / C a block a step, 33.5 MB
//   a step over 128 blocks at C=2 (67 MB at C=1);
// - the eight warps' partial sums (each warp over its eighth of the block's
//   k, all rows, the cluster's 16C units) meet in shared memory in a fixed
//   order; the cluster's barrier then makes each block's sums visible to the
//   others, and each block adds the C blocks' sums for its own 16 units, in
//   rank order, through distributed shared memory;
// - dh and dc of its cells in fp32 registers for the whole sequence; dz_t
//   written once in fp32 (the output) and once in bf16 to a ping-pong
//   buffer (2, 16 * tiles, 4H padded to 32); one grid barrier a step; the
//   next row's ifgo, cs, c_{t-1}, dys and valid are loaded while the block
//   waits at it.
// The grid is ceil(H / 16C) clusters (128 blocks at H=2048), one block an
// SM, launched cooperatively with the cluster attribute after checking that
// every cluster can be resident at once.

#include "lstm_wide.cuh"

namespace {

using namespace lstm_wide;

__host__ __device__ constexpr size_t bwd_wide_smem_bytes(int H, int C) {
  // n8 tiles 2C, k-pairs in registers 8 / C; a block's range of k-pairs at
  // most ceil(pairs / C); the partial sums of two m16 tiles.
  return static_cast<size_t>(shared_pairs(
             (round_up(4 * H, kPair) / kPair + C - 1) / C, 8 / C))
             * (2 * C * 8 * kPair * 2)
         + static_cast<size_t>(kWarps) * 32 * (kWideMaxTiles * 2 * C * 4)
               * 4;
}

#ifdef LSTM_WIDE_PHASES
__device__ unsigned long long lstm_bwd_wide_phase_clocks[kPhases];
#endif

template <int kTiles, int kC>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_wide_kernel(const float* __restrict__ valid,        // (T,B)
                     const __nv_bfloat16* __restrict__ w,    // (H,4H)
                     const float* __restrict__ c0,           // (B,H)
                     const float* __restrict__ cs,           // (T,B,H)
                     const __nv_bfloat16* __restrict__ ifgo, // (T,B,4H)
                     const __nv_bfloat16* __restrict__ dys,  // (T,B,H)
                     const float* __restrict__ dhT,          // (B,H)
                     const float* __restrict__ dcT,          // (B,H)
                     float* __restrict__ dz,                 // (T,B,4H)
                     float* __restrict__ dh0,                // (B,H)
                     float* __restrict__ dc0,                // (B,H)
                     __nv_bfloat16* dzb,  // (2, 16*kTiles, Kp), zeros
                     unsigned int* flags,  // grid * kFlagStride zeros
                     int T, int B, int H, int need_dh0) {
  constexpr int kN = 2 * kC;           // n8 tiles: the cluster's units
  constexpr int kRegPairs = 8 / kC;    // k-pairs a warp holds in registers
  constexpr int kRing = 2;             // k-pairs of dz loaded ahead
  constexpr int kSlot = kN * 8 * kPair;  // bf16 of a shared slot
  constexpr int kFrag = kTiles * kN * 4;  // partial sums a lane
  constexpr int kRowsP = 16 * kTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * H;
  const int Kp = round_up(K, kPair);
  const int kpairs = Kp / kPair;
  const unsigned int rank = kC > 1 ? cluster_rank() : 0u;
  const int b0 = rank * kpairs / kC;             // the block's k-pairs
  const int nb = (rank + 1) * kpairs / kC - b0;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zb = reinterpret_cast<float*>(
      smem + static_cast<size_t>(shared_pairs((kpairs + kC - 1) / kC,
                                              kRegPairs)) * kSlot * 2);

  const int cj0 = (blockIdx.x / kC) * kWideUnits * kC;  // the cluster's
  const int j0 = cj0 + rank * kWideUnits;               // the block's own
  uint4 wreg[kRegPairs][kN];
  load_slice<kN, kRegPairs>(wreg, ws, w, static_cast<size_t>(K), K,
                            (H & 1) == 0, b0, nb, [&](int c) {
                              return cj0 + c < H ? cj0 + c : -1;
                            });

  const int u = threadIdx.x % kWideUnits;
  const int r = threadIdx.x / kWideUnits;
  const int j = j0 + u;
  const size_t G = static_cast<size_t>(K);
  const size_t slab = static_cast<size_t>(kRowsP) * Kp;
  const size_t BH = static_cast<size_t>(B) * H;

  bool live[kTiles];
  // Carries, and row t's inputs (loaded a row ahead): gates, c_t, c_{t-1},
  // dys, v_t; v_{t+1} for the carry into row t.
  float dh[kTiles], dc[kTiles], gt[kTiles][4], ct[kTiles], cp[kTiles],
      dy[kTiles], vt[kTiles], vn[kTiles];
  auto load_row = [&](int t) {
#pragma unroll
    for (int ci = 0; ci < kTiles; ++ci) {
      if (!live[ci]) continue;
      const int b = ci * 16 + r;
      const size_t tb = static_cast<size_t>(t) * B + b;
      const __nv_bfloat16* g = ifgo + tb * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gt[ci][q] = __bfloat162float(g[static_cast<size_t>(q) * H]);
      const size_t bj = static_cast<size_t>(b) * H + j;
      ct[ci] = cs[t * BH + bj];
      cp[ci] = t > 0 ? cs[(t - 1) * BH + bj] : c0[bj];
      dy[ci] = __bfloat162float(dys[t * BH + bj]);
      vt[ci] = valid[tb];
    }
  };
#pragma unroll
  for (int ci = 0; ci < kTiles; ++ci) {
    const int b = ci * 16 + r;
    live[ci] = b < B && j < H;
    dh[ci] = dc[ci] = vn[ci] = 0.f;
    if (live[ci]) {
      const size_t bj = static_cast<size_t>(b) * H + j;
      dh[ci] = dhT[bj];
      dc[ci] = dcT[bj];
    }
  }
  load_row(T - 1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int p0, p1;
  warp_range(nb, warp, &p0, &p1);
  const __nv_bfloat16* wsw =
      ws + static_cast<ptrdiff_t>(p0 - warp * kRegPairs) * kSlot;
  float* zw = zb + warp * kFrag * 32;
  unsigned int sink = 0;
  unsigned int epoch = 0;
#ifdef LSTM_WIDE_PHASES
  long long wide_ph[kPhases] = {0, 0, 0, 0, 0, 0, 0};
  const long long wide_start = clock64();
  long long wide_last = wide_start;
#endif

  // dz_next @ W_hh^T over this block's k-range for the cluster's 16C units,
  // summed over the warps into zb's first slot (fragment order), and made
  // visible to the cluster.
  auto product = [&](const __nv_bfloat16* dz_next) {
    float acc[kTiles][kN][4];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    wide_product<kTiles, kN, kRegPairs, kRing>(
        dz_next + static_cast<size_t>(b0) * kPair, Kp, wreg, wsw, p0, p1,
        acc, sink, [&] { WIDE_TICK(1) });
    WIDE_TICK(2)
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          zw[((mt * kN + nt) * 4 + e) * 32 + lane] = acc[mt][nt][e];
    __syncthreads();
    reduce_warps<kFrag>(zb);
    WIDE_TICK(3)
    if (kC > 1) {
      cluster_sync();
    } else {
      __syncthreads();
    }
    WIDE_TICK(4)
  };
  // The sum for cell ci's row and this thread's unit: the C blocks' sums in
  // rank order.
  auto summed = [&](int ci) {
    const int pos = frag_pos(ci, kN, r, static_cast<int>(rank) * kWideUnits
                                            + u);
    if (kC == 1) return zb[pos];
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kC; ++q) s += ld_cluster(cluster_addr(zb + pos, q));
    return s;
  };

  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) product(dzb + ((t + 1) & 1) * slab);
    __nv_bfloat16* dzb_t = dzb + (t & 1) * slab;
#pragma unroll
    for (int ci = 0; ci < kTiles; ++ci) {
      if (!live[ci]) continue;
      const int b = ci * 16 + r;
      if (t < T - 1) dh[ci] = summed(ci) + (1.f - vn[ci]) * dh[ci];
      const float gi = gt[ci][0], gf = gt[ci][1], gg = gt[ci][2],
                  go = gt[ci][3];
      const float tc = tanhf(ct[ci]);
      const float v = vt[ci];
      const float dh_tot = dy[ci] + dh[ci];
      const float d_o = dh_tot * tc;
      const float dc_tot = dc[ci] + dh_tot * go * (1.f - tc * tc);
      const float di = dc_tot * gg;
      const float dg = dc_tot * gi;
      const float df = dc_tot * cp[ci];
      const float z[4] = {di * gi * (1.f - gi) * v, df * gf * (1.f - gf) * v,
                          dg * (1.f - gg * gg) * v, d_o * go * (1.f - go) * v};
      float* dz_row = dz + (static_cast<size_t>(t) * B + b) * G + j;
      __nv_bfloat16* dzb_row = dzb_t + static_cast<size_t>(b) * Kp + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dz_row[static_cast<size_t>(q) * H] = z[q];
        dzb_row[q * H] = __float2bfloat16_rn(z[q]);
      }
      dc[ci] = dc_tot * gf * v + (1.f - v) * dc[ci];
      vn[ci] = v;
    }
    if (t > 0 || need_dh0) {
      WIDE_TICK(5)
      grid_arrive(flags, ++epoch);
      if (t > 0) load_row(t - 1);  // while the block waits
      grid_wait(flags, epoch);
      WIDE_TICK(0)
    }
  }
  if (need_dh0) product(dzb);
#pragma unroll
  for (int ci = 0; ci < kTiles; ++ci) {
    if (!live[ci]) continue;
    const size_t bj = static_cast<size_t>(ci * 16 + r) * H + j;
    dh0[bj] = need_dh0 ? summed(ci) + (1.f - vn[ci]) * dh[ci] : dh[ci];
    dc0[bj] = dc[ci];
  }
  // No block leaves while another of its cluster may read its sums.
  if (kC > 1) cluster_sync();
#ifdef LSTM_WIDE_SKIP_MMA
  if (sink == 0x9e3779b9u) dc0[0] += 1.f;  // keeps the loads
#endif
#ifdef LSTM_WIDE_PHASES
  wide_ph[kPhases - 1] = clock64() - wide_start;
  if (threadIdx.x == 0)
    for (int q = 0; q < kPhases; ++q)
      atomicAdd(&lstm_bwd_wide_phase_clocks[q],
                static_cast<unsigned long long>(wide_ph[q]));
#endif
}

template <int kTiles, int kC>
int launch(void** args, int H, cudaStream_t s) {
  const int clusters = (H + kWideUnits * kC - 1) / (kWideUnits * kC);
  return launch_wide(
      reinterpret_cast<const void*>(&lstm_bwd_wide_kernel<kTiles, kC>),
      clusters * kC, kC, bwd_wide_smem_bytes(H, kC), args, s);
}

}  // namespace

// All T reverse steps, and dh0's product with need_dh0, in one launch on
// `stream`, in clusters of `cluster` blocks (1 or 2); returns the launch's
// CUDA error code (0 when accepted).  It neither synchronises nor allocates:
// dzb is (2, 16 * tiles(B), round_up(4H, 32)) bf16 of zeros and flags
// ceil(H / (16 * cluster)) * cluster * 32 zeroed 32-bit words (the grid
// barrier's), both from the caller.  Without need_dh0, dh0 receives the
// carry into row 0.  B > 32, another cluster size, a grid that cannot be
// resident at once and shared memory beyond the card's limit are refused
// with an error.
extern "C" int lstm_bwd_wide(const void* valid, const void* w, const void* c0,
                             const void* cs, const void* ifgo,
                             const void* dys, const void* dhT,
                             const void* dcT, void* dz, void* dh0, void* dc0,
                             void* dzb, void* flags, int T, int B, int H,
                             int need_dh0, int cluster, void* stream) {
  void* args[] = {&valid, &w,   &c0,  &cs,  &ifgo,    &dys, &dhT, &dcT, &dz,
                  &dh0,   &dc0, &dzb, &flags, &T, &B,  &H,   &need_dh0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = wide_tiles_for(B);
  if (tiles == 1 && cluster == 1) return launch<1, 1>(args, H, s);
  if (tiles == 2 && cluster == 1) return launch<2, 1>(args, H, s);
  if (tiles == 1 && cluster == 2) return launch<1, 2>(args, H, s);
  if (tiles == 2 && cluster == 2) return launch<2, 2>(args, H, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" unsigned long long lstm_bwd_wide_smem_bytes(int H, int cluster) {
  return bwd_wide_smem_bytes(H, cluster);
}

extern "C" const char* lstm_bwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LSTM_WIDE_PHASES
// The profiling build's phase clocks into out[0..6]; zeroes them after.
extern "C" int lstm_bwd_wide_phase_clocks_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, lstm_bwd_wide_phase_clocks,
                                         kPhases * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(lstm_bwd_wide_phase_clocks, zero,
                                             sizeof(zero)));
}
#endif
