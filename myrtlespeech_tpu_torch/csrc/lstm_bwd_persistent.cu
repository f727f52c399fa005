// K2, persistent: the backward LSTM recurrence (BPTT) in one launch per
// call, written by hand for Hopper (sm_90a).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_bwd_kernel (reached
// through _bwd_pallas_call), with the same function and rounding points as
// the per-step K2 (lstm_bwd.cu).  Walking t from T-1 down to 0, with dh and
// dc the carries into row t:
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
//
// What bounds it on the card: each step is a (B x 4H) @ (4H x H) product in
// a serial chain, and every block needs all of dz_{t+1} (B x 4H bf16: 256 KB
// at B=32, 1 MB at B=128), four times the h that K1 exchanges.  The bound
// over a call (bytes once, products at peak) is a fraction of a microsecond
// a step; what the card waits on is the barrier and that broadcast.
//
// What the design does about it, as K1's (lstm_fwd_persistent.cu):
// - one cooperative launch; a block owns kUnits = 8 hidden units j for all
//   B <= 128 rows; grid ceil(H / 8), resident together;
// - rows j of W_hh (8 x 4H bf16, the weight's own (H, 4H) layout: 64 KB at
//   H=1024) copied into shared memory once;
// - dh and dc of its cells in fp32 registers for the whole sequence;
// - dz_t written once in fp32 (the output) and once in bf16 to a ping-pong
//   buffer (2, 16 * tiles, 4H padded to 32); one grid barrier a step; every
//   block then reads all of dz_t with ld.global.cg, eight 16-byte loads a
//   lane in flight, for mma.sync (m16n8k16, bf16 in, fp32 accumulate);
//   k-split partial sums meet in shared memory in a fixed order;
// - the next row's ifgo, cs, c_{t-1}, dys and valid are loaded into
//   registers before the barrier.

#include "lstm_persistent.cuh"

namespace {

using namespace lstm_persistent;

constexpr int kZStride = kUnits;  // row of the partial-sum tile
constexpr int kBatch = 8;         // k-pairs of A loaded ahead

__host__ __device__ constexpr size_t bwd_smem_bytes(int H) {
  return static_cast<size_t>(kUnits) * smem_stride(round_up(4 * H, kPair)) * 2
         + static_cast<size_t>(kProductRows) * kZStride * 4;
}

template <int kTiles>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent_kernel(const float* __restrict__ valid,        // (T,B)
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
  constexpr int kSplitK = kWarps / kTiles;
  constexpr int kRowsP = 16 * kTiles;
  constexpr int kCells = (kRowsP * kUnits + kThreads - 1) / kThreads;
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = 4 * H;
  const int Kp = round_up(K, kPair);
  const int ldw = smem_stride(Kp);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  float* zbuf = reinterpret_cast<float*>(smem + static_cast<size_t>(kUnits)
                                         * ldw * 2);

  const int j0 = blockIdx.x * kUnits;
  load_tile(ws, ldw, kUnits, Kp, w, static_cast<size_t>(K), K,
            (H & 1) == 0, [&](int r) { return j0 + r < H ? j0 + r : -1; });

  const int u = threadIdx.x % kUnits;
  const int j = j0 + u;
  const size_t G = static_cast<size_t>(K);
  const size_t slab = static_cast<size_t>(kRowsP) * Kp;
  const size_t BH = static_cast<size_t>(B) * H;

  int rows[kCells];
  bool live[kCells];
  // Carries, and row t's inputs (loaded a row ahead): gates, c_t, c_{t-1},
  // dys, v_t; v_{t+1} for the carry into row t.
  float dh[kCells], dc[kCells], gt[kCells][4], ct[kCells], cp[kCells],
      dy[kCells], vt[kCells], vn[kCells];
  auto load_row = [&](int t) {
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      if (!live[i]) continue;
      const size_t tb = static_cast<size_t>(t) * B + rows[i];
      const __nv_bfloat16* g = ifgo + tb * G + j;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        gt[i][q] = __bfloat162float(g[static_cast<size_t>(q) * H]);
      const size_t bj = static_cast<size_t>(rows[i]) * H + j;
      ct[i] = cs[t * BH + bj];
      cp[i] = t > 0 ? cs[(t - 1) * BH + bj] : c0[bj];
      dy[i] = __bfloat162float(dys[t * BH + bj]);
      vt[i] = valid[tb];
    }
  };
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    rows[i] = (threadIdx.x + i * kThreads) / kUnits;
    live[i] = rows[i] < B && j < H;
    dh[i] = dc[i] = vn[i] = 0.f;
    if (live[i]) {
      const size_t bj = static_cast<size_t>(rows[i]) * H + j;
      dh[i] = dhT[bj];
      dc[i] = dcT[bj];
    }
  }
  load_row(T - 1);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int mt = warp / kSplitK;
  const int ks = warp % kSplitK;
  const int kpairs = Kp / kPair;
  const int p0 = ks * kpairs / kSplitK;
  const int p1 = (ks + 1) * kpairs / kSplitK;
  unsigned int epoch = 0;

  // dz_next @ W_hh[j, :]^T for this block's units, summed over the k-split
  // into zbuf (rows b, columns u).
  auto product = [&](const __nv_bfloat16* dz_next) {
    float acc[1][4] = {{0.f, 0.f, 0.f, 0.f}};
    __syncthreads();  // the W_hh tile is loaded; zbuf is free
    warp_product<1, kBatch>(dz_next + static_cast<size_t>(mt) * 16 * Kp, Kp,
                            ws, ldw, p0, p1, acc);
    float* zp = zbuf + (ks * kRowsP + mt * 16) * kZStride;
    zp[grp * kZStride + 2 * tq] = acc[0][0];
    zp[grp * kZStride + 2 * tq + 1] = acc[0][1];
    zp[(grp + 8) * kZStride + 2 * tq] = acc[0][2];
    zp[(grp + 8) * kZStride + 2 * tq + 1] = acc[0][3];
    __syncthreads();
  };
  auto summed = [&](int b) {
    float s = 0.f;
#pragma unroll
    for (int w2 = 0; w2 < kSplitK; ++w2)
      s += zbuf[(w2 * kRowsP + b) * kZStride + u];
    return s;
  };

  for (int t = T - 1; t >= 0; --t) {
    if (t < T - 1) product(dzb + ((t + 1) & 1) * slab);
    __nv_bfloat16* dzb_t = dzb + (t & 1) * slab;
#pragma unroll
    for (int i = 0; i < kCells; ++i) {
      if (!live[i]) continue;
      const int b = rows[i];
      if (t < T - 1) dh[i] = summed(b) + (1.f - vn[i]) * dh[i];
      const float gi = gt[i][0], gf = gt[i][1], gg = gt[i][2], go = gt[i][3];
      const float tc = tanhf(ct[i]);
      const float v = vt[i];
      const float dh_tot = dy[i] + dh[i];
      const float d_o = dh_tot * tc;
      const float dc_tot = dc[i] + dh_tot * go * (1.f - tc * tc);
      const float di = dc_tot * gg;
      const float dg = dc_tot * gi;
      const float df = dc_tot * cp[i];
      const float z[4] = {di * gi * (1.f - gi) * v, df * gf * (1.f - gf) * v,
                          dg * (1.f - gg * gg) * v, d_o * go * (1.f - go) * v};
      float* dz_row = dz + (static_cast<size_t>(t) * B + b) * G + j;
      __nv_bfloat16* dzb_row = dzb_t + static_cast<size_t>(b) * Kp + j;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dz_row[static_cast<size_t>(q) * H] = z[q];
        dzb_row[q * H] = __float2bfloat16_rn(z[q]);
      }
      dc[i] = dc_tot * gf * v + (1.f - v) * dc[i];
      vn[i] = v;
    }
    if (t > 0 || need_dh0) {
      if (t > 0) load_row(t - 1);
      grid_barrier(flags, ++epoch);
    }
  }
  if (need_dh0) product(dzb);
#pragma unroll
  for (int i = 0; i < kCells; ++i) {
    if (!live[i]) continue;
    const size_t bj = static_cast<size_t>(rows[i]) * H + j;
    dh0[bj] = need_dh0 ? summed(rows[i]) + (1.f - vn[i]) * dh[i] : dh[i];
    dc0[bj] = dc[i];
  }
}

template <int kTiles>
int launch(void** args, int H, cudaStream_t s) {
  return launch_cooperative(
      reinterpret_cast<const void*>(&lstm_bwd_persistent_kernel<kTiles>), H,
      bwd_smem_bytes(H), args, s);
}

}  // namespace

// All T reverse steps, and dh0's product with need_dh0, in one cooperative
// launch on `stream`; returns the launch's CUDA error code (0 when
// accepted).  It neither synchronises nor allocates: dzb is (2, 16 *
// tiles(B), round_up(4H, 32)) bf16 of zeros and flags ceil(H / 8) * 32
// zeroed 32-bit words (the grid barrier's), both from the caller.  Without
// need_dh0, dh0 receives the carry into row 0.  B > 128, a grid that
// cannot be resident at once and shared memory beyond the card's limit are
// refused with an error.
extern "C" int lstm_bwd_persistent(const void* valid, const void* w,
                                   const void* c0, const void* cs,
                                   const void* ifgo, const void* dys,
                                   const void* dhT, const void* dcT, void* dz,
                                   void* dh0, void* dc0, void* dzb,
                                   void* flags, int T, int B, int H,
                                   int need_dh0, void* stream) {
  void* args[] = {&valid, &w,   &c0,  &cs,  &ifgo,    &dys, &dhT, &dcT, &dz,
                  &dh0,   &dc0, &dzb, &flags, &T, &B,  &H,   &need_dh0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (tiles_for(B)) {
    case 1: return launch<1>(args, H, s);
    case 2: return launch<2>(args, H, s);
    case 4: return launch<4>(args, H, s);
    case 8: return launch<8>(args, H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" unsigned long long lstm_bwd_persistent_smem_bytes(int H) {
  return bwd_smem_bytes(H);
}

extern "C" const char* lstm_bwd_persistent_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
