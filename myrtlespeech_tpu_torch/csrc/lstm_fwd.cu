// K1: the forward LSTM recurrence, written by hand for Hopper (sm_90a).
//
// Replaces myrtlespeech_tpu/ops/pallas/lstm_kernel.py::_lstm_kernel (reached
// through _lstm_pallas_fwd_call).  For every time step t and every row b:
//
//   z     = x_proj[t, b] + h_{t-1}[b] @ W_hh (+ bias)   bf16 operands, fp32 sums
//   i,f,o = sigmoid(z_i, z_f, z_o);  g = tanh(z_g)      gate order i, f, g, o
//   c_t   = f * c_{t-1} + i * g;     h_t = o * tanh(c_t)
//   where valid[t, b] is 0 the state is held (h, c frozen) and ys[t, b] = 0.
//
// Outputs, as the TPU kernel's: ys (T,B,H) bf16, cs (T,B,H) fp32, the
// post-activation gates ifgo (T,B,4H) bf16, hT and cT (B,H) fp32.
//
// What bounds it on the card: at the flagship's B=32, H=1024 each step is a
// (32 x 1024) @ (1024 x 4096) product on the tensor cores plus a read of the
// whole of W_hh (8 MiB in bf16, which stays in the 50 MB L2), and the steps
// form a serial chain.  Over a 5 s batch the products (about 0.47 TFLOP) take
// longer at peak than the bytes that must move (about 1.3 GB), so the bound
// is the tensor-core products plus the W_hh reads.
//
// What the design does about it: one launch per time step, so that the
// boundary between launches is the grid-wide barrier the recurrence needs
// (the TPU grid ran its steps in order on one core; blocks on the card run in
// no order).  Each block owns kUnits hidden units j across all four gates
// (columns j, H+j, 2H+j, 3H+j) for kRows batch rows.  Its warps split the
// reduction over H and run mma.sync (m16n8k16, bf16 in, fp32 accumulate) on
// operands read straight from device memory and L2; the partial sums meet in
// shared memory, and the same block then applies the bias, the cell update
// and the length mask for its units, so no gate pre-activation goes back to
// device memory.  h lives in ping-pong buffers; c_{t-1} is read back from
// cs[t-1].  Any B and any H are taken: ragged rows, units and the tail of the
// reduction are masked here.  The TPU kernel's Mosaic workarounds (the
// lane-128 mask broadcast, the bias folded into x_proj, the B%8 / H%128 gate)
// are not carried over.  Keeping each block's W_hh slice resident in shared
// memory across steps with a persistent kernel is later work.
//
// Reduction order: the reduction index k is permuted inside each 16-wide
// step so that a thread's four k values are contiguous (one 16-byte load of
// h, one 8-byte load of W_hh^T); A and B use the same permutation, so the
// sum over k is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUnits = 8;            // hidden units per block (one n8 tile per gate)
constexpr int kRows = 32;            // batch rows per block (two m16 tiles)
constexpr int kWarps = 8;            // warps that split the reduction over H
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 4 * kUnits;    // gate columns per block
constexpr int kStride = kCols + 1;   // padded row of the partial-sum tile

static_assert(kRows * kUnits == kThreads, "one epilogue cell per thread");

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Four consecutive fp32 values of h[b, k..k+3], rounded to two bf16 pairs.
__device__ __forceinline__ void load_a(const float* __restrict__ h, int b,
                                       int k, int B, int H, bool vec,
                                       uint32_t& lo, uint32_t& hi) {
  float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
  if (b < B) {
    const float* p = h + static_cast<size_t>(b) * H + k;
    if (vec) {
      if (k < H) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        v0 = t.x; v1 = t.y; v2 = t.z; v3 = t.w;
      }
    } else {
      if (k < H) v0 = p[0];
      if (k + 1 < H) v1 = p[1];
      if (k + 2 < H) v2 = p[2];
      if (k + 3 < H) v3 = p[3];
    }
  }
  lo = pack_bf16x2(v0, v1);
  hi = pack_bf16x2(v2, v3);
}

// Four consecutive bf16 values of W_hh^T[gate * H + j, k..k+3].
__device__ __forceinline__ void load_b(const __nv_bfloat16* __restrict__ wt,
                                       int gate, int j, int k, int H,
                                       bool vec, uint32_t& lo, uint32_t& hi) {
  lo = 0u;
  hi = 0u;
  if (j >= H) return;
  const uint16_t* p = reinterpret_cast<const uint16_t*>(wt)
      + (static_cast<size_t>(gate) * H + j) * H + k;
  if (vec) {
    if (k < H) {
      const uint2 t = *reinterpret_cast<const uint2*>(p);
      lo = t.x;
      hi = t.y;
    }
  } else {
    const uint32_t e0 = k < H ? p[0] : 0u;
    const uint32_t e1 = k + 1 < H ? p[1] : 0u;
    const uint32_t e2 = k + 2 < H ? p[2] : 0u;
    const uint32_t e3 = k + 3 < H ? p[3] : 0u;
    lo = e0 | (e1 << 16);
    hi = e2 | (e3 << 16);
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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One time step.  Grid: (ceil(H / kUnits), ceil(B / kRows)); kThreads threads.
__global__ void __launch_bounds__(kThreads)
lstm_step_kernel(const __nv_bfloat16* __restrict__ x_t,  // (B, 4H)
                 const float* __restrict__ valid_t,      // (B,)
                 const __nv_bfloat16* __restrict__ wt,   // (4H, H) = W_hh^T
                 const float* __restrict__ bias,         // (4H,) or null
                 const float* __restrict__ h_in,         // (B, H)
                 const float* __restrict__ c_in,         // (B, H)
                 __nv_bfloat16* __restrict__ ys_t,       // (B, H)
                 float* __restrict__ cs_t,               // (B, H)
                 __nv_bfloat16* __restrict__ ifgo_t,     // (B, 4H)
                 float* __restrict__ h_out,              // (B, H)
                 float* __restrict__ c_last,             // (B, H) or null
                 int B, int H, int vec) {
  __shared__ float partial[kWarps][kRows][kStride];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;  // row of A / column of B in the mma fragments
  const int tq = lane & 3;
  const int j0 = blockIdx.x * kUnits;
  const int row0 = blockIdx.y * kRows;

  float acc[2][4][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;

  const int ksteps = (H + 15) / 16;
  for (int ks = warp; ks < ksteps; ks += kWarps) {
    const int k = ks * 16 + 4 * tq;
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      load_a(h_in, row0 + m * 16 + grp, k, B, H, vec, a[m][0], a[m][2]);
      load_a(h_in, row0 + m * 16 + grp + 8, k, B, H, vec, a[m][1], a[m][3]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t b0, b1;
      load_b(wt, q, j0 + grp, k, H, vec, b0, b1);
#pragma unroll
      for (int m = 0; m < 2; ++m) mma_bf16(acc[m][q], a[m], b0, b1);
    }
  }

#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = m * 16 + grp;
      const int col = q * kUnits + 2 * tq;
      partial[warp][r][col] = acc[m][q][0];
      partial[warp][r][col + 1] = acc[m][q][1];
      partial[warp][r + 8][col] = acc[m][q][2];
      partial[warp][r + 8][col + 1] = acc[m][q][3];
    }
  __syncthreads();

  const int r = threadIdx.x / kUnits;
  const int u = threadIdx.x % kUnits;
  const int b = row0 + r;
  const int j = j0 + u;
  if (b >= B || j >= H) return;

  const size_t G = 4 * static_cast<size_t>(H);
  float z[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w][r][q * kUnits + u];
    const size_t col = static_cast<size_t>(q) * H + j;
    s += __bfloat162float(x_t[b * G + col]);
    if (bias != nullptr) s += bias[col];
    z[q] = s;
  }
  const float gi = sigmoid(z[0]);
  const float gf = sigmoid(z[1]);
  const float gg = tanhf(z[2]);
  const float go = sigmoid(z[3]);
  __nv_bfloat16* ifgo_row = ifgo_t + b * G;
  ifgo_row[j] = __float2bfloat16_rn(gi);
  ifgo_row[H + j] = __float2bfloat16_rn(gf);
  ifgo_row[2 * static_cast<size_t>(H) + j] = __float2bfloat16_rn(gg);
  ifgo_row[3 * static_cast<size_t>(H) + j] = __float2bfloat16_rn(go);

  const size_t bj = static_cast<size_t>(b) * H + j;
  const float c_prev = c_in[bj];
  const float h_prev = h_in[bj];
  const float c_new = gf * c_prev + gi * gg;
  const float h_new = go * tanhf(c_new);
  const bool v = valid_t[b] > 0.5f;
  const float c_o = v ? c_new : c_prev;
  h_out[bj] = v ? h_new : h_prev;
  cs_t[bj] = c_o;
  ys_t[bj] = __float2bfloat16_rn(v ? h_new : 0.f);
  if (c_last != nullptr) c_last[bj] = c_o;
}

}  // namespace

// Runs all T steps on `stream`, one launch each, and returns the first
// launch error (0 when every launch was accepted).  It neither synchronises
// nor allocates: h_scratch is (2, B, H) fp32 from the caller.  `vec` says
// that H % 4 == 0 and h0 is 16-byte aligned, so the operand loads may be
// vectorised.
extern "C" int lstm_fwd(const void* x_proj, const void* valid,
                        const void* w_t, const void* bias, const void* h0,
                        const void* c0, void* ys, void* cs, void* ifgo,
                        void* hT, void* cT, void* h_scratch, int T, int B,
                        int H, int vec, void* stream) {
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  const dim3 block(kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t bh = static_cast<size_t>(B) * H;
  const size_t bg = 4 * bh;
  const auto* x = static_cast<const __nv_bfloat16*>(x_proj);
  const auto* vd = static_cast<const float*>(valid);
  auto* ys_p = static_cast<__nv_bfloat16*>(ys);
  auto* cs_p = static_cast<float*>(cs);
  auto* ifgo_p = static_cast<__nv_bfloat16*>(ifgo);
  auto* scratch = static_cast<float*>(h_scratch);
  const float* h_in = static_cast<const float*>(h0);
  for (int t = 0; t < T; ++t) {
    const bool last = t == T - 1;
    float* h_out = last ? static_cast<float*>(hT) : scratch + (t % 2) * bh;
    const float* c_in = t == 0 ? static_cast<const float*>(c0)
                               : cs_p + static_cast<size_t>(t - 1) * bh;
    lstm_step_kernel<<<grid, block, 0, s>>>(
        x + t * bg, vd + static_cast<size_t>(t) * B,
        static_cast<const __nv_bfloat16*>(w_t),
        static_cast<const float*>(bias), h_in, c_in, ys_p + t * bh,
        cs_p + t * bh, ifgo_p + t * bg, h_out,
        last ? static_cast<float*>(cT) : nullptr, B, H, vec);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    h_in = h_out;
  }
  return 0;
}

extern "C" const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
