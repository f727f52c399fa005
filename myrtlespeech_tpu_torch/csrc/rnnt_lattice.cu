// K3 and K4: the transducer (RNN-T) lattice forward and backward, written by
// hand for Hopper (sm_90a).
//
// K3 replaces myrtlespeech_tpu/ops/pallas/rnnt_kernel.py::_fwd_kernel
// (reached through _call_fwd), K4 replaces _bwd_kernel there (reached
// through _vjp_bwd).  Both read the blank and emit log-probs (B, T, U+1)
// fp32 and apply the pad-invariant rewrite of _pad_invariant as they load
// them: frames at or past logit_len get blank 0 and emit -1e30, emits at or
// past label_len get -1e30, so paths glide through padding at no cost and the
// terminal condition is uniform at t = T-1.
//
//   K3: alpha[0, u]  = sum_{w<u} emit[0, w]
//       alpha[t, u]  = logaddexp(alpha[t-1, u] + blank[t-1, u],
//                                alpha[t, u-1] + emit[t, u-1])
//       ll[b]        = alpha[T-1, U_b] + blank[T-1, U_b]
//   K4: beta[T, u]   = 0 at u = U_b, else -1e30
//       beta[t, u]   = logaddexp(blank[t, u] + beta[t+1, u],
//                                emit[t, u] + beta[t, u+1])
//       gblank[t, u] = exp(alpha[t,u] + blank[t,u] + beta[t+1,u] - ll) * g
//       gemit[t, u]  = exp(alpha[t,u] + emit[t,u] + beta[t,u+1] - ll) * g
//       both 0 at padded frames, and a NaN gemit is 0 (_vjp_bwd's masking).
//
// Each row along u is a linear recurrence in the (logaddexp, +) semiring,
// solved as the TPU kernel solves it (_linrec_scan): a Hillis-Steele scan
// over affine maps x -> logaddexp(A, C + x), ceil(log2(U+1)) passes.
// -1e30 stands for -inf throughout, so that no -inf - -inf makes a NaN, and
// logaddexp is max + log1pf(expf(-|a - b|)) with CUDA's precise expf and
// log1pf (no fast math).
//
// What bounds it on the card: the bytes.  Each cell is read once or twice
// and written once, with a few dozen flops of scan work on it; at the
// flagship shape (B=32, T'=251, U+1=65) that is 6 MB for K3 and 10 MB for
// K4.  In practice the serial chain of T rows, each some 2 * log2(U+1)
// barriers deep, is what the card waits on.
//
// What the design does about it: rows b are independent, so one block per
// row carries its lattice row through all T steps inside the kernel (one
// launch, no grid barrier), one thread per u, the scan in shared memory
// with __syncthreads between passes.  The TPU kernel's 8-row slabs, batch
// padding and (B, U+1) broadcast of ll (Mosaic workarounds) are not carried
// over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = a - b;
  if (isnan(d)) return a + b;
  return m + log1pf(expf(-fabsf(d)));
}

// Solve x[u] = logaddexp(a[u], x[u-1] + c[u]) (reverse: x[u+1]) for the
// row held one element per thread; A and C are 2 * n floats of shared
// memory (double buffers).  Returns this thread's x[u] (u < n).
__device__ float linrec_scan(float a, float c, float* A, float* C, int n,
                             bool reverse) {
  const int u = threadIdx.x;
  int cur = 0;
  if (u < n) {
    A[u] = a;
    C[u] = c;
  }
  __syncthreads();
  for (int d = 1; d < n; d *= 2) {
    float na = 0.f, nc = 0.f;
    if (u < n) {
      const int src = reverse ? u + d : u - d;
      const bool in = reverse ? src < n : src >= 0;
      const float al = in ? A[cur * n + src] : kNegInf;
      const float cl = in ? C[cur * n + src] : 0.f;
      const float av = A[cur * n + u];
      const float cv = C[cur * n + u];
      na = logaddexp(av, cv + al);
      nc = cv + cl;
    }
    cur ^= 1;
    if (u < n) {
      A[cur * n + u] = na;
      C[cur * n + u] = nc;
    }
    __syncthreads();
  }
  const float x = u < n ? A[cur * n + u] : kNegInf;
  __syncthreads();  // the buffers are reused by the next call
  return x;
}

// Pad-invariant loads (see _pad_invariant).
__device__ __forceinline__ float blank_at(const float* __restrict__ lpb,
                                          int t, int u, int U1, int flen) {
  return t >= flen ? 0.f : lpb[static_cast<size_t>(t) * U1 + u];
}

__device__ __forceinline__ float emit_at(const float* __restrict__ lpe, int t,
                                         int u, int U1, int flen, int ulen) {
  return (t >= flen || u >= ulen) ? kNegInf
                                  : lpe[static_cast<size_t>(t) * U1 + u];
}

// K3.  Grid: (B); block: U1 rounded up to a warp; 4 * U1 floats of dynamic
// shared memory, plus U1 for the emit row shifted by one.
__global__ void rnnt_fwd_kernel(const float* __restrict__ lp_blank,  // (B,T,U1)
                                const float* __restrict__ lp_emit,   // (B,T,U1)
                                const int* __restrict__ logit_lens,  // (B,)
                                const int* __restrict__ label_lens,  // (B,)
                                float* __restrict__ alphas,          // (T,B,U1)
                                float* __restrict__ ll,              // (B,)
                                int B, int T, int U1) {
  extern __shared__ float smem[];
  float* A = smem;
  float* C = smem + 2 * U1;
  float* row = smem + 4 * U1;  // this row's alpha, then its terminal value
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int flen = logit_lens[b];
  const int ulen = label_lens[b];
  const float* lpb = lp_blank + static_cast<size_t>(b) * T * U1;
  const float* lpe = lp_emit + static_cast<size_t>(b) * T * U1;

  float alpha = kNegInf;
  for (int t = 0; t < T; ++t) {
    float a = kNegInf, c = 0.f;
    if (u < U1) {
      const float e_left = u > 0 ? emit_at(lpe, t, u - 1, U1, flen, ulen)
                                 : 0.f;
      if (t == 0) {
        // alpha[0, u] = sum_{w<u} emit[0, w]: a = [0, -inf, ...],
        // c = [0, emit[0, 0], emit[0, 1], ...].
        a = u == 0 ? 0.f : kNegInf;
        c = e_left;
      } else {
        a = alpha + blank_at(lpb, t - 1, u, U1, flen);
        c = u == 0 ? kNegInf : e_left;
      }
    }
    alpha = linrec_scan(a, c, A, C, U1, false);
    if (u < U1)
      alphas[(static_cast<size_t>(t) * B + b) * U1 + u] = alpha;
  }
  // ll = alpha[T-1, ulen] + blank[T-1, ulen]; 0 when ulen lies past the
  // lattice, as the TPU kernel's masked row sum gives.
  if (u < U1) row[u] = alpha + blank_at(lpb, T - 1, u, U1, flen);
  __syncthreads();
  if (u == 0) ll[b] = (ulen >= 0 && ulen < U1) ? row[ulen] : 0.f;
}

// K4.  Same grid, block and shared memory as K3.  g (B,) is the cotangent
// of ll; gblank and gemit are (B, T, U1), the layout of the inputs.
__global__ void rnnt_bwd_kernel(const float* __restrict__ lp_blank,
                                const float* __restrict__ lp_emit,
                                const int* __restrict__ logit_lens,
                                const int* __restrict__ label_lens,
                                const float* __restrict__ alphas,  // (T,B,U1)
                                const float* __restrict__ ll,      // (B,)
                                const float* __restrict__ g,       // (B,)
                                float* __restrict__ gblank,        // (B,T,U1)
                                float* __restrict__ gemit,         // (B,T,U1)
                                int B, int T, int U1) {
  extern __shared__ float smem[];
  float* A = smem;
  float* C = smem + 2 * U1;
  float* row = smem + 4 * U1;  // beta[t] of this row, for the shift left
  const int b = blockIdx.x;
  const int u = threadIdx.x;
  const int flen = logit_lens[b];
  const int ulen = label_lens[b];
  const float logz = ll[b];
  const float gb = g[b];
  const size_t base = static_cast<size_t>(b) * T * U1;
  const float* lpb = lp_blank + base;
  const float* lpe = lp_emit + base;

  float beta_next = u == ulen ? 0.f : kNegInf;  // virtual beta[T]
  for (int t = T - 1; t >= 0; --t) {
    float bb = kNegInf, e = kNegInf, al = kNegInf, blank = 0.f;
    if (u < U1) {
      blank = blank_at(lpb, t, u, U1, flen);
      e = emit_at(lpe, t, u, U1, flen, ulen);
      al = alphas[(static_cast<size_t>(t) * B + b) * U1 + u];
      bb = blank + beta_next;
    }
    const float beta_t = linrec_scan(bb, e, A, C, U1, true);
    if (u < U1) row[u] = beta_t;
    __syncthreads();
    if (u < U1) {
      const float beta_right = u + 1 < U1 ? row[u + 1] : kNegInf;
      const bool pad = t >= flen;
      const float gbk = expf(al + blank + beta_next - logz) * gb;
      float gem = expf(al + e + beta_right - logz) * gb;
      if (isnan(gem)) gem = 0.f;
      const size_t at = base + static_cast<size_t>(t) * U1 + u;
      gblank[at] = pad ? 0.f : gbk;
      gemit[at] = pad ? 0.f : gem;
    }
    __syncthreads();  // row is rewritten by the next step
    beta_next = beta_t;
  }
}

int block_for(int U1) { return ((U1 + 31) / 32) * 32; }

size_t smem_for(int U1) { return 5 * static_cast<size_t>(U1) * sizeof(float); }

}  // namespace

// K3 on `stream`: one launch, one block per batch row.  Returns the launch
// error (0 when it was accepted); neither synchronises nor allocates.
// U1 must be at most 1024 (one thread per lattice column).
extern "C" int rnnt_lattice_fwd(const void* lp_blank, const void* lp_emit,
                                const void* logit_lens, const void* label_lens,
                                void* alphas, void* ll, int B, int T, int U1,
                                void* stream) {
  rnnt_fwd_kernel<<<B, block_for(U1), smem_for(U1),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_blank), static_cast<const float*>(lp_emit),
      static_cast<const int*>(logit_lens), static_cast<const int*>(label_lens),
      static_cast<float*>(alphas), static_cast<float*>(ll), B, T, U1);
  return static_cast<int>(cudaGetLastError());
}

// K4 on `stream`, as K3.
extern "C" int rnnt_lattice_bwd(const void* lp_blank, const void* lp_emit,
                                const void* logit_lens, const void* label_lens,
                                const void* alphas, const void* ll,
                                const void* g, void* gblank, void* gemit,
                                int B, int T, int U1, void* stream) {
  rnnt_bwd_kernel<<<B, block_for(U1), smem_for(U1),
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_blank), static_cast<const float*>(lp_emit),
      static_cast<const int*>(logit_lens), static_cast<const int*>(label_lens),
      static_cast<const float*>(alphas), static_cast<const float*>(ll),
      static_cast<const float*>(g), static_cast<float*>(gblank),
      static_cast<float*>(gemit), B, T, U1);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* rnnt_lattice_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
