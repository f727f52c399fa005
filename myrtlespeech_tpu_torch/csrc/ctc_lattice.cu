// K7 and K8: the CTC lattice forward and backward, written by hand for Hopper
// (sm_90a).
//
// K7 replaces myrtlespeech_tpu/ops/pallas/ctc_kernel.py::_fwd_kernel (reached
// through _fwd_impl), K8 replaces _bwd_kernel there (reached through
// _vjp_bwd).  Both read lp_ext (B, T, S = 2U+1) fp32, the log-probs of the
// extended labels (blank, l1, blank, l2, ..., blank) after the pad-invariant
// rewrite of ops/cuda/ctc_kernel.py::ctc_lattice_inputs: frames at or past
// logit_len give blank positions 0 and label positions -1e30, label positions
// past label_len are -1e30 at every frame, so every path glides to the final
// blank and the terminal row is read at t = T-1 for every row.
//
//   K7: alpha[0, s] = lp[0, s] for s <= 1, else -1e30
//       alpha[t, s] = logaddexp(logaddexp(alpha[t-1, s], alpha[t-1, s-1]),
//                               skip[s] ? alpha[t-1, s-2] : -1e30) + lp[t, s]
//       ll[b]       = logaddexp over the DISTINCT s of {2 U_b, max(2 U_b-1, 0)}
//                     of alpha[T-1, s] (one position when U_b = 0)
//   K8: beta[T-1, s] = lp[T-1, s] at those terminal s, else -1e30
//       beta[t, s]   = logaddexp(logaddexp(beta[t+1, s], beta[t+1, s+1]),
//                                skip[s+2] ? beta[t+1, s+2] : -1e30) + lp[t, s]
//       grad[t, s]   = exp(alpha[t, s] + beta[t, s] - lp[t, s] - ll[b]) * g[b]
//
// skip[s] is can_skip (B, S), 1 at odd s >= 3 whose label differs from the
// one before; K8 reads it at the destination s+2, as _bwd_kernel does.
// -1e30 stands for -inf throughout: at a masked position K8's exponent is
// some -1e30 - 1e30 + 1e30, whose exp is 0, where -inf would give inf - inf,
// a NaN.  logaddexp is max + log1pf(expf(-|a - b|)) with CUDA's precise expf
// and log1pf (no fast math).
//
// What bounds it on the card: the bytes.  K7 reads lp_ext once and writes
// alphas once, K8 reads both and writes the gradient once, with some 15 fp32
// operations per cell; at the DeepSpeech2 step's lattice (B=32, T'=836,
// S=429) that is 91.8 MB and 137.7 MB.  In practice the chain of T dependent
// rows, one barrier each, is what the card waits on.
//
// What the design does about it: rows b are independent, so one block per
// row carries its alpha (beta) row through all T steps inside the kernel (one
// launch, no grid barrier).  Each thread owns kCols columns s = threadIdx.x +
// k * blockDim.x, so any S up to 16 * 1024 works; the row is double-buffered
// in shared memory with two pads of -1e30 at the end the stencil reads from,
// so a step is branch-free and needs one __syncthreads.  K7's threads load
// their columns of the next row into registers before they compute the
// current one.  K8 asks for its rows of lp and alphas several steps ahead
// into L1 by prefetch, which nothing waits for, and exponentiates each row's
// occupancy after the step's barrier.  Outputs are written (B, T, S)
// directly.  The TPU kernel's 8-row slabs, batch padding, (B, S) broadcasts
// of the lengths and logZ, and the terminal log-sum-exp hoisted out of the
// kernel (Mosaic workarounds) are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxCols = 16;

// The NaN case is taken by a select, not a branch: the same bits in fewer
// instructions (port_tools/lattice_variants.py times K8 with the branch:
// PERF.md section 6).
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = a - b;
  const float r = m + log1pf(expf(-fabsf(d)));
  return isnan(d) ? a + b : r;
}

// K7.  Grid: (B); block: ceil(S / kCols) threads rounded up to a warp;
// 2 * (S + 2) floats of dynamic shared memory: two alpha rows, each with two
// leading pads of -1e30 for the reads at s-1 and s-2.
template <int kCols>
__global__ void __launch_bounds__(kMaxThreads)
    ctc_fwd_kernel(const float* __restrict__ lp_ext,    // (B, T, S)
                   const float* __restrict__ can_skip,  // (B, S)
                   const int* __restrict__ label_lens,  // (B,)
                   float* __restrict__ alphas,          // (B, T, S)
                   float* __restrict__ ll,              // (B,)
                   int T, int S) {
  extern __shared__ float smem[];
  const int W = S + 2;
  const int b = blockIdx.x;
  const int n = blockDim.x;
  const size_t base = static_cast<size_t>(b) * T * S;
  const float* lp = lp_ext + base;
  float* out = alphas + base;

  if (threadIdx.x < 2) {
    smem[threadIdx.x] = kNegInf;
    smem[W + threadIdx.x] = kNegInf;
  }
  bool skip[kCols];
  float cur[kCols];  // lp[t, s] of this thread's columns
  float nxt[kCols];  // lp[t + 1, s], loaded a step ahead
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int s = threadIdx.x + k * n;
    skip[k] = s < S && can_skip[static_cast<size_t>(b) * S + s] > 0.5f;
    cur[k] = s < S ? lp[s] : kNegInf;
    nxt[k] = (s < S && T > 1) ? lp[S + s] : kNegInf;
    if (s < S) {
      const float a = s <= 1 ? cur[k] : kNegInf;
      smem[2 + s] = a;
      out[s] = a;
    }
  }
  __syncthreads();

  int p = 0;  // the buffer that holds alpha[t-1]
  for (int t = 1; t < T; ++t) {
    const float* prev = smem + p * W;
    float* next = smem + (p ^ 1) * W;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int s = threadIdx.x + k * n;
      cur[k] = nxt[k];
      nxt[k] = (s < S && t + 1 < T)
                   ? lp[static_cast<size_t>(t + 1) * S + s]
                   : kNegInf;
    }
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int s = threadIdx.x + k * n;
      if (s < S) {
        const float stay = prev[2 + s];
        const float adv = prev[1 + s];
        const float skp = skip[k] ? prev[s] : kNegInf;
        const float a = logaddexp(logaddexp(stay, adv), skp) + cur[k];
        next[2 + s] = a;
        out[static_cast<size_t>(t) * S + s] = a;
      }
    }
    __syncthreads();
    p ^= 1;
  }

  if (threadIdx.x == 0) {
    const float* last = smem + p * W + 2;
    const int u = label_lens[b];
    const int i1 = 2 * u;
    const int i0 = max(2 * u - 1, 0);
    float v = (i1 >= 0 && i1 < S) ? last[i1] : kNegInf;
    if (i0 != i1 && i0 < S) v = logaddexp(v, last[i0]);
    ll[b] = v;
  }
}

// Ask for the line holding *p in L1, without waiting for it: no register
// takes the value, so nothing later waits for it either.
__device__ __forceinline__ void prefetch_l1(const float* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// K8.  Same grid and block as K7; 2 * (S + 2) floats of dynamic shared
// memory: two beta rows, each with two trailing pads of -1e30 for the reads
// at s+1 and s+2.  g (B,) is the cotangent of ll; grad is (B, T, S).
//
// The chain of T rows is what K8 waits on.  Loaded a row ahead into
// registers, as K7 loads lp, lp and alphas still cost each step part of a
// device-memory latency (PERF.md section 6).  So each thread asks for its
// columns of lp and alphas P rows ahead into L1 by prefetch, which no
// register and so nothing waits for, and loads a row only on the step that
// uses it, from L1; P * kCols <= 8 keeps the rows in flight within L1.  The
// steps are unrolled by 8 (up to 4 columns a thread), which saves the
// double buffer's index arithmetic.  The occupancy of row t, whose exponent
// is summed before the barrier in the plain version's order, is
// exponentiated and stored on the next step, beside row t-1's logaddexps.
template <int kCols, int P>
__global__ void __launch_bounds__(kMaxThreads)
    ctc_bwd_kernel(const float* __restrict__ lp_ext,    // (B, T, S)
                   const float* __restrict__ can_skip,  // (B, S)
                   const int* __restrict__ label_lens,  // (B,)
                   const float* __restrict__ alphas,    // (B, T, S)
                   const float* __restrict__ ll,        // (B,)
                   const float* __restrict__ g,         // (B,)
                   float* __restrict__ grad,            // (B, T, S)
                   int T, int S) {
  extern __shared__ float smem[];
  const int W = S + 2;
  const int b = blockIdx.x;
  const int n = blockDim.x;
  const size_t base = static_cast<size_t>(b) * T * S;
  const float* lp = lp_ext + base;
  const float* al = alphas + base;
  float* out = grad + base;
  const float logz = ll[b];
  const float gb = g[b];
  const int u = label_lens[b];
  const int i1 = 2 * u;
  const int i0 = max(2 * u - 1, 0);

  if (threadIdx.x < 2) {
    smem[S + threadIdx.x] = kNegInf;
    smem[W + S + threadIdx.x] = kNegInf;
  }
  // This thread's columns of row r of lp and alphas, into L1.
  auto prefetch_row = [&](int r) {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int s = threadIdx.x + k * n;
      if (r >= 0 && s < S) {
        prefetch_l1(lp + static_cast<size_t>(r) * S + s);
        prefetch_l1(al + static_cast<size_t>(r) * S + s);
      }
    }
  };
#pragma unroll
  for (int i = 0; i < P; ++i) prefetch_row(T - 2 - i);
  bool skip2[kCols];  // can_skip at the destination s + 2
  float y[kCols];     // the occupancy's exponent of the row just done
  const size_t last_row = static_cast<size_t>(T - 1) * S;
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int s = threadIdx.x + k * n;
    skip2[k] = s + 2 < S && can_skip[static_cast<size_t>(b) * S + s + 2] > 0.5f;
    y[k] = kNegInf;
    if (s < S) {
      const float lpv = lp[last_row + s];
      const float beta = (s == i1 || s == i0) ? lpv : kNegInf;
      smem[s] = beta;
      y[k] = al[last_row + s] + beta - lpv - logz;
    }
  }
  __syncthreads();

  int p = 0;  // the buffer that holds beta[t+1]
  // Unrolled by 8 up to 4 columns a thread; wider, the copies of the body
  // would spill.
  constexpr int kStepUnroll = kCols <= 4 ? 8 : 1;
#pragma unroll kStepUnroll
  for (int t = T - 2; t >= 0; --t) {
    const float* nb = smem + p * W;
    float* cb = smem + (p ^ 1) * W;
    const size_t row = static_cast<size_t>(t) * S;
    prefetch_row(t - P);
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int s = threadIdx.x + k * n;
      if (s < S) {
        const float lpv = lp[row + s];
        const float alv = al[row + s];
        const float stay = nb[s];
        const float adv = nb[s + 1];
        const float skp = skip2[k] ? nb[s + 2] : kNegInf;
        // Row t+1's occupancy, off the chain.
        out[row + S + s] = expf(y[k]) * gb;
        const float beta = logaddexp(logaddexp(stay, adv), skp) + lpv;
        cb[s] = beta;
        y[k] = alv + beta - lpv - logz;
      }
    }
    __syncthreads();
    p ^= 1;
  }
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    const int s = threadIdx.x + k * n;
    if (s < S) out[s] = expf(y[k]) * gb;
  }
}

int cols_for(int S) {
  for (int c = 1; c <= kMaxCols; c *= 2)
    if (c * kMaxThreads >= S) return c;
  return 0;
}

int threads_for(int S, int cols) {
  const int t = (S + cols - 1) / cols;
  return ((t + 31) / 32) * 32;
}

size_t smem_for(int S) { return 2 * (static_cast<size_t>(S) + 2) * sizeof(float); }

// Above 48 KB a block's dynamic shared memory must be asked for.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kCols>
int launch_fwd(const float* lp_ext, const float* can_skip,
               const int* label_lens, float* alphas, float* ll, int B, int T,
               int S, cudaStream_t stream) {
  const size_t smem = smem_for(S);
  cudaError_t err = allow_smem(ctc_fwd_kernel<kCols>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_fwd_kernel<kCols><<<B, threads_for(S, kCols), smem, stream>>>(
      lp_ext, can_skip, label_lens, alphas, ll, T, S);
  return static_cast<int>(cudaGetLastError());
}

// K8's rows of lp and alphas asked for ahead: 8 columns of each a thread,
// at least one row.
constexpr int bwd_rows_ahead(int kCols) { return kCols >= 8 ? 1 : 8 / kCols; }

template <int kCols>
int launch_bwd(const float* lp_ext, const float* can_skip,
               const int* label_lens, const float* alphas, const float* ll,
               const float* g, float* grad, int B, int T, int S,
               cudaStream_t stream) {
  constexpr int P = bwd_rows_ahead(kCols);
  const size_t smem = smem_for(S);
  cudaError_t err = allow_smem(ctc_bwd_kernel<kCols, P>, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_bwd_kernel<kCols, P><<<B, threads_for(S, kCols), smem, stream>>>(
      lp_ext, can_skip, label_lens, alphas, ll, g, grad, T, S);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The largest S the kernels take (kMaxCols columns for each of 1024 threads).
extern "C" int ctc_lattice_max_s() { return kMaxCols * kMaxThreads; }

// K7 on `stream`: one launch, one block per batch row.  Returns the launch
// error (0 when it was accepted); neither synchronises nor allocates.
extern "C" int ctc_lattice_fwd(const void* lp_ext, const void* can_skip,
                               const void* label_lens, void* alphas, void* ll,
                               int B, int T, int S, void* stream) {
  const float* lp = static_cast<const float*>(lp_ext);
  const float* sk = static_cast<const float*>(can_skip);
  const int* ul = static_cast<const int*>(label_lens);
  float* a = static_cast<float*>(alphas);
  float* l = static_cast<float*>(ll);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols_for(S)) {
    case 1: return launch_fwd<1>(lp, sk, ul, a, l, B, T, S, st);
    case 2: return launch_fwd<2>(lp, sk, ul, a, l, B, T, S, st);
    case 4: return launch_fwd<4>(lp, sk, ul, a, l, B, T, S, st);
    case 8: return launch_fwd<8>(lp, sk, ul, a, l, B, T, S, st);
    case 16: return launch_fwd<16>(lp, sk, ul, a, l, B, T, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K8 on `stream`, as K7.
extern "C" int ctc_lattice_bwd(const void* lp_ext, const void* can_skip,
                               const void* label_lens, const void* alphas,
                               const void* ll, const void* g, void* grad,
                               int B, int T, int S, void* stream) {
  const float* lp = static_cast<const float*>(lp_ext);
  const float* sk = static_cast<const float*>(can_skip);
  const int* ul = static_cast<const int*>(label_lens);
  const float* a = static_cast<const float*>(alphas);
  const float* l = static_cast<const float*>(ll);
  const float* gg = static_cast<const float*>(g);
  float* d = static_cast<float*>(grad);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cols_for(S)) {
    case 1: return launch_bwd<1>(lp, sk, ul, a, l, gg, d, B, T, S, st);
    case 2: return launch_bwd<2>(lp, sk, ul, a, l, gg, d, B, T, S, st);
    case 4: return launch_bwd<4>(lp, sk, ul, a, l, gg, d, B, T, S, st);
    case 8: return launch_bwd<8>(lp, sk, ul, a, l, gg, d, B, T, S, st);
    case 16: return launch_bwd<16>(lp, sk, ul, a, l, gg, d, B, T, S, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* ctc_lattice_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
