// A measuring build of K7 for port_tools/lattice_variants.py (variant
// "shuffle_layout"): each lane holds kC consecutive columns of the alpha row
// in registers and takes s-1 and s-2 of its first column from the lane
// before by __shfl_up_sync; each warp's lane 31 hands its last two alphas to
// the next warp's lane 0 through shared memory, double-buffered by the
// step's parity, so a step keeps one barrier.  At S=429 that is 4 warps a
// row where K7 runs 14.  The cells, the ring of lp rows and the stores are
// K7's (csrc/ctc_lattice.cu, included below with its entry point renamed),
// so its alphas are bit-equal to K7's.  Not part of the port.

#define ctc_lattice_fwd ctc_lattice_fwd_of_the_port
#include "../myrtlespeech_tpu_torch/csrc/ctc_lattice.cu"
#undef ctc_lattice_fwd

namespace {

constexpr int kC = 4;      // consecutive columns a lane
constexpr int kRing = 16;  // rows of lp in flight a lane

__global__ void __launch_bounds__(kMaxThreads)
    ctc_fwd_shuffle_kernel(const float* __restrict__ lp_ext,
                           const float* __restrict__ can_skip,
                           const int* __restrict__ label_lens,
                           float* __restrict__ alphas,
                           float* __restrict__ ll, int T, int S) {
  extern __shared__ float smem[];
  const int n = blockDim.x;
  const int i = threadIdx.x, lane = i & 31, warp = i >> 5, warps = n >> 5;
  const int b = blockIdx.x;
  const int s0 = i * kC;
  const size_t base = static_cast<size_t>(b) * T * S;
  float* edge = smem;  // [parity][warp][2]: lane 31's last two alphas
  float* ring = smem + 4 * warps + i;
  const int slot_floats = kC * n;

  bool col[kC], skip[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    col[c] = s0 + c < S;
    skip[c] = col[c] && can_skip[static_cast<size_t>(b) * S + s0 + c] > 0.5f;
  }
  int r = 1;
  const float* src = lp_ext + base + S + s0;
  auto stage = [&]() {
    if (r < T) {
      float* slot = ring + (r & (kRing - 1)) * slot_floats;
#pragma unroll
      for (int c = 0; c < kC; ++c)
        if (col[c]) cp_async4(slot + c * n, src + c);
    }
    cp_async_commit();
    ++r;
    src += S;
  };
  auto take = [&](float(&v)[kC]) {
    cp_async_wait<kRing - 1>();
    const float* slot = ring + (r & (kRing - 1)) * slot_floats;
#pragma unroll
    for (int c = 0; c < kC; ++c) v[c] = slot[c * n];
  };

  float* orow = alphas + base + s0;
  for (int j = 0; j < kRing; ++j) stage();
  float own[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    own[c] = col[c] && s0 + c <= 1 ? lp_ext[base + s0 + c] : kNegInf;
    if (col[c]) orow[c] = own[c];
  }
  if (lane == 31) {
    edge[2 * warp] = own[kC - 2];
    edge[2 * warp + 1] = own[kC - 1];
  }
  float lpv[kC];
  take(lpv);
  __syncthreads();

#pragma unroll 4
  for (int t = 1; t < T; ++t) {
    orow += S;
    const float* in = edge + 2 * warps * ((t - 1) & 1);
    float l1 = __shfl_up_sync(0xffffffffu, own[kC - 1], 1);
    float l2 = __shfl_up_sync(0xffffffffu, own[kC - 2], 1);
    if (lane == 0) {
      l1 = warp > 0 ? in[2 * warp - 1] : kNegInf;
      l2 = warp > 0 ? in[2 * warp - 2] : kNegInf;
    }
    float a[kC];
    a[0] = logsumexp3(own[0], l1, skip[0] ? l2 : kNegInf) + lpv[0];
    a[1] = logsumexp3(own[1], own[0], skip[1] ? l1 : kNegInf) + lpv[1];
#pragma unroll
    for (int c = 2; c < kC; ++c)
      a[c] = logsumexp3(own[c], own[c - 1], skip[c] ? own[c - 2] : kNegInf) +
             lpv[c];
#pragma unroll
    for (int c = 0; c < kC; ++c) own[c] = a[c];
    if (lane == 31) {
      float* out_edge = edge + 2 * warps * (t & 1);
      out_edge[2 * warp] = own[kC - 2];
      out_edge[2 * warp + 1] = own[kC - 1];
    }
#pragma unroll
    for (int c = 0; c < kC; ++c)
      if (col[c]) orow[c] = own[c];
    stage();
    take(lpv);
    __syncthreads();
  }

  // The last row, for ll, through the ring's first slot (no longer read).
  cp_async_wait<0>();
  __syncthreads();
  float* last = smem + 4 * warps;
#pragma unroll
  for (int c = 0; c < kC; ++c)
    if (col[c]) last[s0 + c] = own[c];
  __syncthreads();
  if (i == 0) {
    const int u = label_lens[b];
    const int i1 = 2 * u;
    const int i0 = max(2 * u - 1, 0);
    float v = (i1 >= 0 && i1 < S) ? last[i1] : kNegInf;
    if (i0 != i1 && i0 < S) v = logaddexp(v, last[i0]);
    ll[b] = v;
  }
}

}  // namespace

extern "C" int ctc_lattice_fwd(const void* lp_ext, const void* can_skip,
                               const void* label_lens, void* alphas, void* ll,
                               int B, int T, int S, void* stream) {
  const int threads = ((S + kC - 1) / kC + 31) / 32 * 32;
  if (threads > kMaxThreads || S < kC * 32 + 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (4 * static_cast<size_t>(threads / 32) +
                       static_cast<size_t>(kRing) * kC * threads) *
                      sizeof(float);
  cudaError_t err = allow_smem(ctc_fwd_shuffle_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_fwd_shuffle_kernel<<<B, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_ext), static_cast<const float*>(can_skip),
      static_cast<const int*>(label_lens), static_cast<float*>(alphas),
      static_cast<float*>(ll), T, S);
  return static_cast<int>(cudaGetLastError());
}
