// K1, persistent: the forward LSTM recurrence in one launch per call,
// written by hand for Hopper (sm_90a).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel (reached
// through _lstm_pallas_fwd_call), with the same function and rounding points
// as the per-step K1 (lstm_fwd.cu), for every time step t and row b:
//
//   z     = x_proj[t, b] + bf16(h_{t-1}[b]) @ W_hh (+ bias)   fp32 sums
//   i,f,o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)     gate order i, f, g, o
//   c_t   = f * c_{t-1} + i * g;     h_t = o * tanh(c_t)
//   where valid[t, b] is 0 the state is held (h, c frozen) and ys[t, b] = 0.
//
// Outputs: ys (T,B,H) bf16, cs (T,B,H) fp32, ifgo (T,B,4H) bf16, hT, cT fp32.
//
// What bounds it on the card: each step is a (B x H) @ (H x 4H) product
// (0.27 GFLOP at B=32, H=1024) in a serial chain of T steps, and every block
// needs all of h_{t-1} before it can start step t.  The bound over a call
// (bytes once, products at peak) is a fraction of a microsecond a step; what
// the card waits on is the chain: a grid-wide barrier and an all-to-all
// exchange of h every step.
//
// What the design does about it (the TPU kernel's own idea: W_hh stays in
// fast memory for the whole sequence):
// - one cooperative launch per call; a block owns kUnits = 8 hidden units
//   (columns j, H+j, 2H+j, 3H+j of W_hh) for all B <= 128 rows, so the grid
//   is ceil(H / 8) blocks, resident together (128 at H=1024 on 132 SMs);
// - the block's W_hh^T slice (32 x H bf16, 64 KB at H=1024) is copied into
//   shared memory once per call;
// - each thread keeps the c and h of its cells in fp32 registers for the
//   whole sequence; ys, cs, ifgo are written once and never read back;
// - h_t goes to a bf16 ping-pong buffer (2, 16 * tiles, H padded to 32):
//   each block writes its units, then one grid barrier, then every block
//   reads all of it with ld.global.cg (lstm_persistent.cuh);
// - the product runs on mma.sync (m16n8k16, bf16 in, fp32 accumulate): warp
//   w takes m16 tile w / (8 / tiles) and a k-range, with its A operand
//   loaded from L2 a batch ahead of the products; the k-split partial sums
//   meet in shared memory in a fixed order (so two calls are bit-equal);
// - the next step's x_proj and valid are loaded into registers before the
//   barrier, so their latency hides behind it.
// Any H and B <= 128 are taken (the caller's route sends larger B, and grids
// that do not fit, to the per-step K1).

#include "lstm_persistent.cuh"

namespace {

using namespace lstm_persistent;

constexpr int kCols = 4 * kUnits;       // gate columns per block
constexpr int kZStride = kCols + 8;     // row of the partial-sum tile
constexpr int kBatch = 4;               // k-pairs of A loaded ahead

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

__host__ __device__ constexpr size_t fwd_smem_bytes(int H) {
  return static_cast<size_t>(kCols) * smem_stride(round_up(H, kPair)) * 2
         + static_cast<size_t>(kProductRows) * kZStride * 4;
}

template <int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_kernel(const __nv_bfloat16* __restrict__ x,   // (T,B,4H)
                           const float* __restrict__ valid,       // (T,B)
                           const __nv_bfloat16* __restrict__ wt,  // (4H,H)
                           const float* __restrict__ bias,  // (4H,) or null
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
  constexpr int kSplitK = kWarps / kTiles;
  constexpr int kRowsP = 16 * kTiles;
  constexpr int kCells = (kRowsP * kUnits + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int Hp = round_up(H, kPair);
  const int ldw = smem_stride(Hp);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zbuf = reinterpret_cast<float*>(smem + static_cast<size_t>(kCols)
                                         * ldw * 2);

  const int j0 = blockIdx.x * kUnits;
  // Tile row q * kUnits + u is W_hh^T row q * H + j0 + u.
  load_tile(ws, ldw, kCols, Hp, wt, static_cast<size_t>(H), H,
            (H & 7) == 0, [&](int r) {
              const int jj = j0 + r % kUnits;
              return jj < H ? (r / kUnits) * H + jj : -1;
            });

  const int u = threadIdx.x % kUnits;
  const int j = j0 + u;
  const size_t G = 4 * static_cast<size_t>(H);
  const size_t hslab = static_cast<size_t>(kRowsP) * Hp;
  float bq[4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
    bq[q] = (bias != nullptr && j < H) ? bias[q * H + j] : 0.f;

  // This thread's cells: rows b[i], unit j; state in registers.
  int rows[kCells];
  bool live[kCells];
  float h[kCells], c[kCells], xv[kCells][4], vv[kCells];
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    rows[i] = (threadIdx.x + i * kThreads) / kUnits;
    live[i] = rows[i] < B && j < H;
    h[i] = c[i] = vv[i] = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) xv[i][q] = 0.f;
    if (live[i]) {
      const size_t bj = static_cast<size_t>(rows[i]) * H + j;
      h[i] = h0[bj];
      c[i] = c0[bj];
      hbuf[static_cast<size_t>(rows[i]) * Hp + j] = __float2bfloat16_rn(h[i]);
      const __nv_bfloat16* xr = x + rows[i] * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        xv[i][q] = __bfloat162float(xr[static_cast<size_t>(q) * H]);
      vv[i] = valid[rows[i]];
    }
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int mt = warp / kSplitK;
  const int ks = warp % kSplitK;
  const int kpairs = Hp / kPair;
  const int p0 = ks * kpairs / kSplitK;
  const int p1 = (ks + 1) * kpairs / kSplitK;
  unsigned int epoch = 0;
  grid_barrier(flags, ++epoch);  // h0 published, W_hh slice loaded

  for (int t = 0; t < T; ++t) {
    const __nv_bfloat16* hin = hbuf + (t & 1) * hslab;
    __nv_bfloat16* hout = hbuf + ((t + 1) & 1) * hslab;
    float acc[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[q][e] = 0.f;
    warp_product<4, kBatch>(hin + static_cast<size_t>(mt) * 16 * Hp, Hp, ws,
                            ldw, p0, p1, acc);
    float* zp = zbuf + (ks * kRowsP + mt * 16) * kZStride;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int col = q * kUnits + 2 * tq;
      zp[grp * kZStride + col] = acc[q][0];
      zp[grp * kZStride + col + 1] = acc[q][1];
      zp[(grp + 8) * kZStride + col] = acc[q][2];
      zp[(grp + 8) * kZStride + col + 1] = acc[q][3];
    }
    __syncthreads();

    const size_t tb = static_cast<size_t>(t) * B;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      if (!live[i]) continue;
      const int b = rows[i];
      float z[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kSplitK; ++w)
          s += zbuf[(w * kRowsP + b) * kZStride + q * kUnits + u];
        z[q] = s + xv[i][q] + bq[q];
      }
      const float gi = sigmoid(z[0]);
      const float gf = sigmoid(z[1]);
      const float gg = tanhf(z[2]);
      const float go = sigmoid(z[3]);
      __nv_bfloat16* ifgo_row = ifgo + (tb + b) * G + j;
      ifgo_row[0] = __float2bfloat16_rn(gi);
      ifgo_row[H] = __float2bfloat16_rn(gf);
      ifgo_row[2 * static_cast<size_t>(H)] = __float2bfloat16_rn(gg);
      ifgo_row[3 * static_cast<size_t>(H)] = __float2bfloat16_rn(go);
      const float c_new = gf * c[i] + gi * gg;
      const float h_new = go * tanhf(c_new);
      const bool v = vv[i] > 0.5f;
      if (v) {
        c[i] = c_new;
        h[i] = h_new;
      }
      const size_t out = (tb + b) * H + j;
      cs[out] = c[i];
      ys[out] = __float2bfloat16_rn(v ? h_new : 0.f);
      hout[static_cast<size_t>(b) * Hp + j] = __float2bfloat16_rn(h[i]);
    }

    if (t + 1 < T) {
      // The next step's inputs, loaded before the barrier.
      const size_t tn = static_cast<size_t>(t + 1) * B;
#pragma unroll
      for (int i = 0; i < kCells; ++i) {
        if (!live[i]) continue;
        const __nv_bfloat16* xr = x + (tn + rows[i]) * G + j;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          xv[i][q] = __bfloat162float(xr[static_cast<size_t>(q) * H]);
        vv[i] = valid[tn + rows[i]];
      }
      grid_barrier(flags, ++epoch);
    }
  }
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (!live[i]) continue;
    const size_t bj = static_cast<size_t>(rows[i]) * H + j;
    hT[bj] = h[i];
    cT[bj] = c[i];
  }
}

template <int kTiles>
int launch(void** args, int H, cudaStream_t s) {
  return launch_cooperative(
      reinterpret_cast<const void*>(&lstm_fwd_persistent_kernel<kTiles>), H,
      fwd_smem_bytes(H), args, s);
}

}  // namespace

// The whole recurrence in one cooperative launch on `stream`; returns the
// launch's CUDA error code (0 when accepted).  It neither synchronises nor
// allocates: hbuf is (2, 16 * tiles(B), round_up(H, 32)) bf16 of zeros and
// flags ceil(H / 8) * 32 zeroed 32-bit words (the grid barrier's), both
// from the caller (tiles(B) is the least of 1, 2, 4, 8 with 16 * tiles >=
// B).  B > 128, a grid that cannot be
// resident at once and shared memory beyond the card's limit are refused
// with an error, never run another way.
extern "C" int lstm_fwd_persistent(const void* x_proj, const void* valid,
                                   const void* w_t, const void* bias,
                                   const void* h0, const void* c0, void* ys,
                                   void* cs, void* ifgo, void* hT, void* cT,
                                   void* hbuf, void* flags, int T, int B,
                                   int H, void* stream) {
  void* args[] = {&x_proj, &valid, &w_t, &bias, &h0,   &c0, &ys, &cs,
                  &ifgo,   &hT,    &cT,  &hbuf, &flags, &T, &B, &H};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiles_for(B)) {
    case 1: return launch<1>(args, H, s);
    case 2: return launch<2>(args, H, s);
    case 4: return launch<4>(args, H, s);
    case 8: return launch<8>(args, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" unsigned long long lstm_fwd_persistent_smem_bytes(int H) {
  return fwd_smem_bytes(H);
}

extern "C" const char* lstm_fwd_persistent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
