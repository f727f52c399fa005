// K2, per-step route: the backward LSTM recurrence (BPTT), one launch per
// reverse step, written by hand for Hopper (sm_90a).
//
// The main paths run an on-chip K2, the persistent one
// (lstm_bwd_persistent.cu) or, for DeepSpeech1's BiLSTM-2048, the wide one
// (lstm_bwd_wide.cu); this route takes the shapes that neither holds (see
// lstm_fwd.cu's note).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_bwd_kernel (reached
// through _bwd_pallas_call).  It walks time in reverse over the forward's
// saved tensors (bf16 post-activation gates ifgo, fp32 cell states cs) and
// recomputes no gate.  For row t, with dh and dc the carries into it:
//
//   dh_tot = dys[t] + dh;     tc = tanh(c_t)
//   do     = dh_tot * tc;     dc_tot = dc + dh_tot * o * (1 - tc^2)
//   dz_t   = [dc_tot*g * i(1-i), dc_tot*c_{t-1} * f(1-f),
//             dc_tot*i * (1-g^2), do * o(1-o)] * v_t          (fp32 out)
//   dh    <- dz_t @ W_hh^T + (1 - v_t) * dh                   bf16 operands,
//   dc    <- dc_tot * f * v_t + (1 - v_t) * dc                fp32 sums
//
// so on a padded step (v_t = 0) dz is 0 and dh, dc pass through unchanged.
// Outputs: dz (T,B,4H) fp32, and the carries out of row 0 as dh0, dc0.
// dW_hh = h_prev^T @ dz and db = sum(dz) are large products outside the
// kernel, as in the TPU version.
//
// What bounds it on the card: each step is a (B x 4H) @ (4H x H) product
// (at B=32, H=1024: 0.27 GFLOP) plus a read of all of W_hh (8 MiB in bf16,
// L2-resident), in a serial chain of T steps; over a flagship batch the
// products outweigh the bytes that must move (dz, ifgo, cs, dys), so the
// bound is the tensor-core products.  The chain of dependent steps, not the
// rate, is what the card actually waits on.
//
// What the design does about it: one launch per reverse step, so that the
// boundary between launches is the grid-wide barrier the recurrence needs.
// The launch for row t first forms, for the kUnits hidden units j that its
// block owns, dz_{t+1} @ W_hh[j, :]^T over K = 4H with mma.sync (m16n8k16,
// bf16 in, fp32 accumulate; warps split K, partial sums meet in shared
// memory), reading dz_{t+1} from a bf16 copy that the launch before wrote.
// The same block then computes dz_t for its units' four gate columns and
// writes it (fp32 for the output, bf16 for the next launch's product).  dh
// and dc of a unit are read and written by the same thread only, so they are
// carried in place in the dh0/dc0 outputs.  W_hh is read as (H, 4H) bf16, the
// weight's own layout: row j of W_hh is column j of W_hh^T, contiguous in k.
// When dh0 is wanted one more launch forms dz_0 @ W_hh^T alone.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 8;           // hidden units per block (one n8 tile)
constexpr int kRows = 32;           // batch rows per block (two m16 tiles)
constexpr int kWarps = 8;           // warps that split the reduction over 4H
constexpr int kThreads = kWarps * 32;
constexpr int kStride = kUnits + 1;  // padded row of the partial-sum tile

static_assert(kRows * kUnits == kThreads, "one epilogue cell per thread");

// Four consecutive bf16 values p[k..k+3] as two packed pairs (zeros past K).
// Rows are 4H long and k % 4 == 0, so k < K means the whole group lies
// inside the row, and the 8-byte load is aligned.
__device__ __forceinline__ void load4(const __nv_bfloat16* __restrict__ row,
                                      int k, int K, uint32_t& lo,
                                      uint32_t& hi) {
  lo = 0u;
  hi = 0u;
  if (k < K) {
    const uint2 v = *reinterpret_cast<const uint2*>(row + k);
    lo = v.x;
    hi = v.y;
  }
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One reverse step.  Grid: (ceil(H / kUnits), ceil(B / kRows)); kThreads.
// With dz_next null (row T-1) there is no product: dh is the carry as given.
// With cell == 0 only the product runs and dh_out = P + (1 - v_next) * dh.
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const __nv_bfloat16* __restrict__ dz_next,  // (B,4H) or null
                     const float* __restrict__ valid_next,       // (B,) or null
                     const __nv_bfloat16* __restrict__ w,        // (H, 4H)
                     const float* __restrict__ valid_t,          // (B,)
                     const float* __restrict__ c_prev,           // (B, H)
                     const float* __restrict__ c_t,              // (B, H)
                     const __nv_bfloat16* __restrict__ ifgo_t,   // (B, 4H)
                     const __nv_bfloat16* __restrict__ dy_t,     // (B, H)
                     float* __restrict__ dz_t,                   // (B, 4H)
                     __nv_bfloat16* __restrict__ dzb_t,          // (B, 4H)
                     float* __restrict__ dh,                     // (B, H) in/out
                     float* __restrict__ dc,                     // (B, H) in/out
                     int B, int H, int cell) {
  __shared__ float partial[kWarps][kRows][kStride];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const int j0 = blockIdx.x * kUnits;
  const int row0 = blockIdx.y * kRows;
  const int K = 4 * H;
  const size_t G = static_cast<size_t>(K);

  if (dz_next != nullptr) {
    float acc[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][e] = 0.f;
    const int jb = j0 + grp;  // this lane's column of W_hh^T
    const __nv_bfloat16* wrow =
        jb < H ? w + static_cast<size_t>(jb) * G : nullptr;
    const int ksteps = (K + 15) / 16;
    for (int ks = warp; ks < ksteps; ks += kWarps) {
      // The k index is permuted inside each 16-wide step so that a lane's
      // four k values are adjacent; A and B use the same permutation.
      const int k = ks * 16 + 4 * tq;
      uint32_t a[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int r0 = row0 + m * 16 + grp;
        const int r1 = r0 + 8;
        a[m][0] = a[m][2] = a[m][1] = a[m][3] = 0u;
        if (r0 < B) load4(dz_next + r0 * G, k, K, a[m][0], a[m][2]);
        if (r1 < B) load4(dz_next + r1 * G, k, K, a[m][1], a[m][3]);
      }
      uint32_t b0 = 0u, b1 = 0u;
      if (wrow != nullptr) load4(wrow, k, K, b0, b1);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m], a[m], b0, b1);
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = m * 16 + grp;
      const int col = 2 * tq;
      partial[warp][r][col] = acc[m][0];
      partial[warp][r][col + 1] = acc[m][1];
      partial[warp][r + 8][col] = acc[m][2];
      partial[warp][r + 8][col + 1] = acc[m][3];
    }
    __syncthreads();
  }

  const int r = threadIdx.x / kUnits;
  const int u = threadIdx.x % kUnits;
  const int b = row0 + r;
  const int j = j0 + u;
  if (b >= B || j >= H) return;
  const size_t bj = static_cast<size_t>(b) * H + j;

  float dh_in = dh[bj];
  if (dz_next != nullptr) {
    float s = 0.f;
#pragma unroll
    for (int wi = 0; wi < kWarps; ++wi) s += partial[wi][r][u];
    dh_in = s + (1.f - valid_next[b]) * dh_in;
  }
  if (!cell) {
    dh[bj] = dh_in;
    return;
  }

  const __nv_bfloat16* g_row = ifgo_t + b * G;
  const float gi = __bfloat162float(g_row[j]);
  const float gf = __bfloat162float(g_row[H + j]);
  const float gg = __bfloat162float(g_row[2 * static_cast<size_t>(H) + j]);
  const float go = __bfloat162float(g_row[3 * static_cast<size_t>(H) + j]);
  const float ct = c_t[bj];
  const float cp = c_prev[bj];
  const float tc = tanhf(ct);
  const float v = valid_t[b];
  const float dc_in = dc[bj];

  const float dh_tot = __bfloat162float(dy_t[bj]) + dh_in;
  const float d_o = dh_tot * tc;
  const float dc_tot = dc_in + dh_tot * go * (1.f - tc * tc);
  const float di = dc_tot * gg;
  const float dg = dc_tot * gi;
  const float df = dc_tot * cp;
  const float z[4] = {di * gi * (1.f - gi) * v, df * gf * (1.f - gf) * v,
                      dg * (1.f - gg * gg) * v, d_o * go * (1.f - go) * v};
  float* dz_row = dz_t + b * G;
  __nv_bfloat16* dzb_row = dzb_t + b * G;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t col = static_cast<size_t>(q) * H + j;
    dz_row[col] = z[q];
    dzb_row[col] = __float2bfloat16_rn(z[q]);
  }
  dh[bj] = dh_in;
  dc[bj] = dc_tot * gf * v + (1.f - v) * dc_in;
}

}  // namespace

// Runs the T reverse steps on `stream`, one launch each, plus one launch for
// dh0 when need_dh0 is set, and returns the first launch error (0 when every
// launch was accepted).  It neither synchronises nor allocates: dh and dc
// hold dhT and dcT on entry and dh0 and dc0 on return (dh0 only with
// need_dh0; otherwise dh holds the carry into row 0), and dzb_scratch is
// (2, B, 4H) bf16 from the caller.
extern "C" int lstm_bwd(const void* valid, const void* w, const void* c0,
                        const void* cs, const void* ifgo, const void* dys,
                        void* dz, void* dh, void* dc, void* dzb_scratch,
                        int T, int B, int H, int need_dh0, void* stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  const dim3 block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t bg = 4 * bh;
  const auto* vd = static_cast<const float*>(valid);
  const auto* w_p = static_cast<const __nv_bfloat16*>(w);
  const auto* cs_p = static_cast<const float*>(cs);
  const auto* ifgo_p = static_cast<const __nv_bfloat16*>(ifgo);
  const auto* dys_p = static_cast<const __nv_bfloat16*>(dys);
  auto* dz_p = static_cast<float*>(dz);
  auto* dzb = static_cast<__nv_bfloat16*>(dzb_scratch);
  auto* dh_p = static_cast<float*>(dh);
  auto* dc_p = static_cast<float*>(dc);
  for (int t = T - 1; t >= 0; --t) {
    const bool first = t == T - 1;
    const __nv_bfloat16* dz_next = first ? nullptr : dzb + ((t + 1) % 2) * bg;
    const float* c_prev = t == 0 ? static_cast<const float*>(c0)
                                 : cs_p + static_cast<size_t>(t - 1) * bh;
    lstm_bwd_step_kernel<<<grid, block, 0, s>>>(
        dz_next, first ? nullptr : vd + static_cast<size_t>(t + 1) * B, w_p,
        vd + static_cast<size_t>(t) * B, c_prev, cs_p + t * bh,
        ifgo_p + t * bg, dys_p + t * bh, dz_p + t * bg, dzb + (t % 2) * bg,
        dh_p, dc_p, B, H, 1);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (need_dh0) {
    lstm_bwd_step_kernel<<<grid, block, 0, s>>>(
        dzb, vd, w_p, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
        nullptr, dh_p, dc_p, B, H, 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

extern "C" const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
