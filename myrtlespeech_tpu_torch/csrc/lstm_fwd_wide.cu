// K1, wide persistent: the forward LSTM recurrence in one launch per call at
// H up to 2,048 and B <= 32, written by hand for Hopper (sm_90a).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel (reached
// through _lstm_pallas_fwd_call), with the same function and rounding points
// as the per-step and persistent K1 (lstm_fwd.cu, lstm_fwd_persistent.cu):
//
//   z     = x_proj[t, b] + bf16(h_{t-1}[b]) @ W_hh (+ bias)   fp32 sums
//   i,f,o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)     gate order i, f, g, o
//   c_t   = f * c_{t-1} + i * g;     h_t = o * tanh(c_t)
//   where valid[t, b] is 0 the state is held (h, c frozen) and ys[t, b] = 0.
//
// Outputs: ys (T,B,H) bf16, cs (T,B,H) fp32, ifgo (T,B,4H) bf16, hT, cT fp32.
// DeepSpeech1's BiLSTM-2048 takes this route in training and serving.
//
// What bounds it on the card: a serial chain of T steps, each a (B x H) @
// (H x 4H) product (0.54 GFLOP at B=32, H=2048) that needs all of h_{t-1}.
// Over a call the bound (bytes once, products at peak) is some 1 us a step;
// what the card waits on is the chain: one grid barrier a step and every
// block reading all of h_{t-1} (32 x 2048 bf16, 128 KB) from L2.  The
// per-step K1 at this width re-read its W_hh^T slice and h in fp32 from L2
// at every step, some 100 MB a step over its 256 blocks.
//
// What the design does about it (lstm_wide.cuh):
// - one cooperative launch; a block owns 16 hidden units (64 gate columns)
//   for all B <= 32 rows, so the grid is ceil(H / 16) blocks (128 at
//   H=2048), one an SM, resident together;
// - the block's W_hh^T slice (64 x H bf16, 256 KB at H=2048) stays on chip
//   for the whole call: each warp's first 2 k-pairs as B fragments in
//   registers (64 registers a thread), the other 48 of the block's 64
//   k-pairs in shared memory (192 KB), copied once;
// - h is exchanged in bf16 (2, 16 * tiles, H padded to 32) through L2; each
//   element is read by one warp of each block, 16.8 MB a step over 128
//   blocks at B=32;
// - the products run on mma.sync (m16n8k16, bf16 in, fp32 accumulate), each
//   warp over its eighth of k for all 64 columns and all rows; the eight
//   partial sums of one m16 tile meet in a 32 KB tile in a fixed order;
// - each thread keeps the c and h of its cells in fp32 registers; ys, cs,
//   ifgo are written once; the next step's x_proj and valid are loaded
//   while the block waits at the grid barrier.
// No cluster: each warp computes all 64 of the block's columns over its
// k-range, so a cluster that split k between blocks would double every
// warp's accumulators (128 registers a thread beside 64 of W_hh).
// H up to 2,048 (the slice's shared memory) and B <= 32 are taken; the
// caller's route sends other shapes elsewhere.

#include "lstm_wide.cuh"

namespace {

using namespace lstm_wide;
using lstm_persistent::grid_barrier;

constexpr int kN = 4 * kWideUnits / 8;  // n8 tiles: the block's 64 columns
constexpr int kRegPairs = 2;            // k-pairs a warp holds in registers
constexpr int kRing = 2;                // k-pairs of h loaded ahead
constexpr int kSlotBytes = kN * 8 * kPair * 2;

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr size_t fwd_wide_smem_bytes(int H) {
  return static_cast<size_t>(shared_pairs(round_up(H, kPair) / kPair,
                                          kRegPairs)) * kSlotBytes
         + static_cast<size_t>(kWarps) * kZSlotFloats * 4;
}

#ifdef LSTM_WIDE_PHASES
__device__ unsigned long long lstm_fwd_wide_phase_clocks[kPhases];
#endif

template <int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_wide_kernel(const __nv_bfloat16* __restrict__ x,   // (T,B,4H)
                     const float* __restrict__ valid,       // (T,B)
                     const __nv_bfloat16* __restrict__ wt,  // (4H,H)
                     const float* __restrict__ bias,        // (4H,) or null
                     const float* __restrict__ h0,          // (B,H)
                     const float* __restrict__ c0,          // (B,H)
                     __nv_bfloat16* __restrict__ ys,        // (T,B,H)
                     float* __restrict__ cs,                // (T,B,H)
                     __nv_bfloat16* __restrict__ ifgo,      // (T,B,4H)
                     float* __restrict__ hT,                // (B,H)
                     float* __restrict__ cT,                // (B,H)
                     __nv_bfloat16* hbuf,  // (2, 16*kTiles, Hp), zeros
                     unsigned int* flags,  // grid * kFlagStride zeros
                     int T, int B, int H) {
  constexpr int kRowsP = 16 * kTiles;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = round_up(H, kPair);
  const int kpairs = Hp / kPair;
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zb = reinterpret_cast<float*>(
      smem + static_cast<size_t>(shared_pairs(kpairs, kRegPairs))
                 * kSlotBytes);

  const int j0 = blockIdx.x * kWideUnits;
  // Column c of the slice is gate c / 16 of unit j0 + c % 16: W_hh^T row
  // (c / 16) * H + j0 + c % 16.
  uint4 wreg[kRegPairs][kN];
  load_slice<kN, kRegPairs>(wreg, ws, wt, static_cast<size_t>(H), H,
                            (H & 7) == 0, 0, kpairs, [&](int c) {
                              const int jj = j0 + c % kWideUnits;
                              return jj < H ? (c / kWideUnits) * H + jj : -1;
                            });

  // This thread's cells: rows ci * 16 + r, unit j; state in registers.
  const int u = threadIdx.x % kWideUnits;
  const int r = threadIdx.x / kWideUnits;
  const int j = j0 + u;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t hslab = static_cast<size_t>(kRowsP) * Hp;
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bq[q] = (bias != nullptr && j < H) ? bias[q * H + j] : 0.f;
  bool live[kTiles];
  float h[kTiles], c[kTiles], xv[kTiles][4], vv[kTiles];
#pragma unroll
  for (int ci = 0; ci < kTiles; ++ci) {
    const int b = ci * 16 + r;
    live[ci] = b < B && j < H;
    h[ci] = c[ci] = vv[ci] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) xv[ci][q] = 0.f;
    if (live[ci]) {
      const size_t bj = static_cast<size_t>(b) * H + j;
      h[ci] = h0[bj];
      c[ci] = c0[bj];
      hbuf[static_cast<size_t>(b) * Hp + j] = __float2bfloat16_rn(h[ci]);
      const __nv_bfloat16* xr = x + b * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[ci][q] = __bfloat162float(xr[static_cast<size_t>(q) * H]);
      vv[ci] = valid[b];
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int p0, p1;
  warp_range(kpairs, warp, &p0, &p1);
  // This warp's first shared slot (unused when it has none).
  const __nv_bfloat16* wsw =
      ws + static_cast<ptrdiff_t>(p0 - warp * kRegPairs) * (kSlotBytes / 2);
  float* zw = zb + warp * kZSlotFloats;
  unsigned int sink = 0;
  unsigned int epoch = 0;
#ifdef LSTM_WIDE_PHASES
  long long wide_ph[kPhases] = {0, 0, 0, 0, 0, 0, 0};
  const long long wide_start = clock64();
  long long wide_last = wide_start;
#endif
  grid_barrier(flags, ++epoch);  // h0 published, W_hh slice loaded
  WIDE_TICK(0)

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hin = hbuf + (t & 1) * hslab;
    __nv_bfloat16* hout = hbuf + ((t + 1) & 1) * hslab;
    float acc[kTiles][kN][4];
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt)
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    wide_product<kTiles, kN, kRegPairs, kRing>(hin, Hp, wreg, wsw, p0, p1,
                                               acc, sink,
                                               [&] { WIDE_TICK(1) });
    WIDE_TICK(2)

    const size_t tb = static_cast<size_t>(t) * B;
#pragma unroll
    for (int mt = 0; mt < kTiles; ++mt) {
      // m16 tile mt: the warps' partial sums, then its cells.
#pragma unroll
      for (int nt = 0; nt < kN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          zw[(nt * 4 + e) * 32 + lane] = acc[mt][nt][e];
      __syncthreads();
      reduce_warps<kN * 4>(zb);
      __syncthreads();
      WIDE_TICK(3)
      if (live[mt]) {
        const int b = mt * 16 + r;
        float z[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          z[q] = zb[frag_pos(0, kN, r, q * kWideUnits + u)] + xv[mt][q]
                 + bq[q];
        const float gi = sigmoid(z[0]);
        const float gf = sigmoid(z[1]);
        const float gg = tanhf(z[2]);
        const float go = sigmoid(z[3]);
        __nv_bfloat16* ifgo_row = ifgo + (tb + b) * G + j;
        ifgo_row[0] = __float2bfloat16_rn(gi);
        ifgo_row[H] = __float2bfloat16_rn(gf);
        ifgo_row[2 * static_cast<size_t>(H)] = __float2bfloat16_rn(gg);
        ifgo_row[3 * static_cast<size_t>(H)] = __float2bfloat16_rn(go);
        const float c_new = gf * c[mt] + gi * gg;
        const float h_new = go * tanhf(c_new);
        const bool v = vv[mt] > 0.5f;
        if (v) {
          c[mt] = c_new;
          h[mt] = h_new;
        }
        const size_t out = (tb + b) * H + j;
        cs[out] = c[mt];
        ys[out] = __float2bfloat16_rn(v ? h_new : 0.f);
        hout[static_cast<size_t>(b) * Hp + j] = __float2bfloat16_rn(h[mt]);
      }
      if (mt + 1 < kTiles) __syncthreads();  // zb is read; free it
      WIDE_TICK(5)
    }

    if (t + 1 < T) {
      WIDE_TICK(5)
      grid_arrive(flags, ++epoch);
      // The next step's inputs, loaded while the block waits.
      const size_t tn = static_cast<size_t>(t + 1) * B;
#pragma unroll
      for (int ci = 0; ci < kTiles; ++ci) {
        if (!live[ci]) continue;
        const int b = ci * 16 + r;
        const __nv_bfloat16* xr = x + (tn + b) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[ci][q] = __bfloat162float(xr[static_cast<size_t>(q) * H]);
        vv[ci] = valid[tn + b];
      }
      grid_wait(flags, epoch);
      WIDE_TICK(0)
    }
  }
#pragma unroll
  for (int ci = 0; ci < kTiles; ++ci) {
    if (!live[ci]) continue;
    const size_t bj = static_cast<size_t>(ci * 16 + r) * H + j;
    hT[bj] = h[ci];
    cT[bj] = c[ci];
  }
#ifdef LSTM_WIDE_SKIP_MMA
  if (sink == 0x9e3779b9u) hT[0] += 1.f;  // keeps the loads
#endif
#ifdef LSTM_WIDE_PHASES
  wide_ph[kPhases - 1] = clock64() - wide_start;
  if (threadIdx.x == 0)
    for (int q = 0; q < kPhases; ++q)
      atomicAdd(&lstm_fwd_wide_phase_clocks[q],
                static_cast<unsigned long long>(wide_ph[q]));
#endif
}

template <int kTiles>
int launch(void** args, int H, cudaStream_t s) {
  return launch_wide(
      reinterpret_cast<const void*>(&lstm_fwd_wide_kernel<kTiles>),
      (H + kWideUnits - 1) / kWideUnits, 1, fwd_wide_smem_bytes(H), args, s);
}

}  // namespace

// The whole recurrence in one cooperative launch on `stream`; returns the
// launch's CUDA error code (0 when accepted).  It neither synchronises nor
// allocates: hbuf is (2, 16 * tiles(B), round_up(H, 32)) bf16 of zeros and
// flags ceil(H / 16) * 32 zeroed 32-bit words (the grid barrier's), both
// from the caller (tiles(B) is 1 for B <= 16, else 2).  B > 32, a grid that
// cannot be resident at once and shared memory beyond the card's limit
// (H over 2,048) are refused with an error, never run another way.
extern "C" int lstm_fwd_wide(const void* x_proj, const void* valid,
                             const void* w_t, const void* bias,
                             const void* h0, const void* c0, void* ys,
                             void* cs, void* ifgo, void* hT, void* cT,
                             void* hbuf, void* flags, int T, int B, int H,
                             void* stream) {
  void* args[] = {&x_proj, &valid, &w_t, &bias, &h0,   &c0, &ys, &cs,
                  &ifgo,   &hT,    &cT,  &hbuf, &flags, &T, &B, &H};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (wide_tiles_for(B)) {
    case 1: return launch<1>(args, H, s);
    case 2: return launch<2>(args, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" unsigned long long lstm_fwd_wide_smem_bytes(int H) {
  return fwd_wide_smem_bytes(H);
}

extern "C" const char* lstm_fwd_wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#ifdef LSTM_WIDE_PHASES
// The profiling build's phase clocks into out[0..6]; zeroes them after.
extern "C" int lstm_fwd_wide_phase_clocks_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, lstm_fwd_wide_phase_clocks,
                                         kPhases * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[kPhases] = {};
  return static_cast<int>(cudaMemcpyToSymbol(lstm_fwd_wide_phase_clocks, zero,
                                             sizeof(zero)));
}
#endif
