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
// K3 walks each row's lattice by anti-diagonals d = t + u: the cells of one
// anti-diagonal are independent, so a row takes T + U steps, each one
// logaddexp deep.  Thread u holds alpha[t-1, u] + blank[t-1, u] in a
// register and receives alpha[t, u-1] + emit[t, u-1] from lane u-1 by a
// shuffle (at a warp's edge, through a shared slot double-buffered by the
// diagonal's parity, so one barrier a diagonal is enough).  A warp's 32
// lanes stand on 32 rows at once, so it keeps its last 32 rows of blank,
// emit and alpha in shared memory: it loads a whole row of its columns
// along u a diagonal, some diagonals ahead, each lane takes its next cell
// from there off the chain, and each row of alphas goes out along u once
// its last lane has it.  (Loaded and stored by each lane on its own
// column, 32 rows a warp instruction, they cost the long step's K3 over a
// third of its time: PERF.md section 6.)  This sums alpha in another order
// than the TPU kernel's scan (alpha[0, u] is the running sum of emit[0, :u]
// from the left; the plain version's scan sums in a tree), and its alphas
// lie closer to a float64 run (PERF.md section 6).
// K4 walks the same anti-diagonals from the end, T + U steps of one
// logaddexp, one shuffle and one barrier, and computes both occupancies of
// a cell on its own diagonal, beside the chain; its rows of inputs come by
// cp.async into each warp's rows of shared memory, and its occupancies go
// out along u through the same rows.  So beta is summed in the mirror of
// K3's order (beta[T-1, u] sums emit[T-1, u:U_b] from the right), not in
// the TPU kernel's scan (_linrec_scan, a Hillis-Steele scan over affine
// maps, which the plain version keeps), and alpha and beta share one order
// again (PERF.md section 6).
// -1e30 stands for -inf throughout, so that no -inf - -inf makes a NaN, and
// logaddexp is max + log1pf(expf(-|a - b|)) with CUDA's precise expf and
// log1pf (no fast math).
//
// What bounds them on the card: the bytes.  Each cell is read once or twice
// and written once, with a few flops on it; at the flagship shape (B=32,
// T'=251, U+1=65) that is 6 MB for K3 and 10 MB for K4.  In practice each
// row's serial chain is what the card waits on: T + U diagonals, each a
// logaddexp, a shuffle and a barrier.
//
// What the design does about it: rows b are independent, so one block per
// row carries its lattice row through the whole lattice inside the kernel
// (one launch, no grid barrier), one thread per u.  The TPU kernel's 8-row
// slabs, batch padding and (B, U+1) broadcast of ll (Mosaic workarounds) are
// not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kPrefetch = 8;  // K3's and K4's diagonals of loads in flight
// K3's warps whose rows of blank, emit and alpha (8 KB a warp) fit in the
// 227 KB of shared memory a block can ask for.
constexpr int kMaxStagedWarps = 28;
// K4's rows of blank, emit and alpha a warp: the 32 its lanes stand on and
// room for the copies in flight ahead of them (a power of two); 24 KB a
// warp, so 9 warps fit.
constexpr int kRowsBwd = 64;
constexpr int kMaxStagedWarpsBwd = 9;

// The NaN case is taken by a select, not a branch: the same bits in fewer
// instructions (port_tools/lattice_variants.py times K4 with the branch:
// PERF.md section 6).
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  const float d = a - b;
  const float r = m + log1pf(expf(-fabsf(d)));
  return isnan(d) ? a + b : r;
}

// cp.async of one float from global to shared memory, in the thread's
// current group: no register takes it, so nothing waits for it but
// cp.async.wait_group.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's newest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// blank[t, u] and emit[t, u] into bl and em when (t, u) lies in the
// lattice; else they are left as they are.
__device__ __forceinline__ void fetch_cell(float& bl, float& em,
                                           const float* __restrict__ lpb,
                                           const float* __restrict__ lpe,
                                           int t, int u, int T, int U1,
                                           int flen, int ulen, bool col) {
  if (col && t >= 0 && t < T) {
    bl = blank_at(lpb, t, u, U1, flen);
    em = emit_at(lpe, t, u, U1, flen, ulen);
  }
}

// K3.  Grid: (B); block: U1 rounded up to a warp (at most 1024 threads);
// 8 KB of dynamic shared memory a warp when STAGED, else 4 KB.  Thread u
// computes alpha[d - u, u] on diagonal d; its warp's lanes are on 32
// consecutive rows t at once.
//
// The warp's rows of its 32 columns live in shared memory by t mod 32
// (every access bank-conflict free: lane l touches column l).  STAGED, each
// diagonal the warp loads the row its lane 0 reaches next, coalesced, kP
// diagonals ahead into registers, then into the rows of blank and emit, and
// each lane takes its next cell from there at the end of the diagonal
// before, off the chain; unSTAGED (above kMaxStagedWarps, where they do not
// fit), each lane loads its own cells kP diagonals ahead.  Either way a
// lane overwrites its cell's blank with alpha, and the warp stores each row
// of alphas along u once its last lane has written it.
template <int P, bool STAGED>
__global__ void __launch_bounds__(1024)
rnnt_fwd_kernel(const float* __restrict__ lp_blank,  // (B, T, U1)
                const float* __restrict__ lp_emit,   // (B, T, U1)
                const int* __restrict__ logit_lens,  // (B,)
                const int* __restrict__ label_lens,  // (B,)
                float* __restrict__ alphas,          // (T, B, U1)
                float* __restrict__ ll,              // (B,)
                int B, int T, int U1) {
  extern __shared__ float ring[];  // (warps, STAGED ? 2 : 1, 32, 32)
  __shared__ float edge[2][32];    // lane 31's send of each warp, by parity
  const int b = blockIdx.x;
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const bool col = u < U1;
  const int flen = logit_lens[b];
  const int ulen = label_lens[b];
  const size_t base = static_cast<size_t>(b) * T * U1;
  const float* lpb = lp_blank + base;
  const float* lpe = lp_emit + base;
  float* out = alphas + static_cast<size_t>(b) * U1 + u;
  const size_t out_stride = static_cast<size_t>(B) * U1;
  float* rows = ring + warp * (STAGED ? 2 : 1) * 32 * 32;  // blank, alpha
  float* erows = rows + 32 * 32;                           // emit (STAGED)
  // The row a lane loads for diagonal d, less d: STAGED, lane 0's row for
  // every lane; else the lane's own.
  const int lag = warp * 32 + (STAGED ? 0 : lane);

  // Registers ahead of the rows: blank and emit of row d - lag + P at
  // column u, loaded on diagonal d into slot d mod P.
  float pb[P], pe[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    pb[j] = 0.f;
    pe[j] = kNegInf;
    fetch_cell(pb[j], pe[j], lpb, lpe, j - lag, u, T, U1, flen, ulen, col);
  }
  if (threadIdx.x < 64) edge[threadIdx.x >> 5][lane] = kNegInf;
  __syncthreads();

  // up = alpha[t-1, u] + blank[t-1, u]; at t = 0 it is -inf but for u = 0,
  // where 0 makes alpha[0, 0] = logaddexp(0, -1e30) = 0 exactly.
  float up = u == 0 ? 0.f : kNegInf;
  float send = kNegInf;  // alpha[t, u] + emit[t, u], for lane u+1
  float bl = 0.f, em = kNegInf;  // blank and emit of this diagonal's cell
  const int D = T + U1 - 1;
  // The warp's last lattice column, whose lane completes each of its rows.
  const int last = min(31, U1 - 1 - warp * 32);
  const bool one_warp = blockDim.x == 32;
  for (int d0 = 0; d0 < D; d0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int d = d0 + j;
      if (d >= D) break;
      const int t = d - u;
      if (STAGED) {
        const int e = d - lag;  // the row lane 0 reaches now
        if (e >= 0 && e < T) {
          rows[(e & 31) * 32 + lane] = pb[j];
          erows[(e & 31) * 32 + lane] = pe[j];
        }
        if (lane == 0) {
          bl = pb[j];
          em = pe[j];
        }
      } else {
        bl = pb[j];
        em = pe[j];
      }
      fetch_cell(pb[j], pe[j], lpb, lpe, d + P - lag, u, T, U1, flen, ulen,
                 col);
      float left = __shfl_up_sync(0xffffffffu, send, 1);
      if (lane == 0) left = warp == 0 ? kNegInf : edge[(d + 1) & 1][warp - 1];
      if (col && t >= 0 && t < T) {
        // At t = 0 (u > 0) logaddexp(-1e30, left) is left exactly.
        const float a = logaddexp(up, left);
        rows[(t & 31) * 32 + lane] = a;
        send = a + em;
        up = a + bl;
      }
      if (lane == 31) edge[d & 1][warp] = send;
      __syncwarp();
      // Row r of the warp's alphas is complete: lane `last` wrote it just
      // now.
      const int r = d - (warp * 32 + last);
#ifndef K3_SKIP_ALPHA_STORES  // a measuring build, port_tools/kernel_probe.py
      if (col && r >= 0 && r < T)
        out[r * out_stride] = rows[(r & 31) * 32 + lane];
#endif
      // The next cell's blank and emit, which lane 0 loaded on an earlier
      // diagonal (on this one for lane 1).
      if (STAGED && lane > 0 && col && t + 1 >= 0 && t + 1 < T) {
        bl = rows[((t + 1) & 31) * 32 + lane];
        em = erows[((t + 1) & 31) * 32 + lane];
      }
      // One barrier a diagonal: the edge slots and a row of the rings are
      // rewritten no sooner than the diagonal after the one that last reads
      // them.
      if (one_warp) __syncwarp();
      else __syncthreads();
    }
  }
  // ll = alpha[T-1, ulen] + blank[T-1, ulen]; 0 when ulen lies past the
  // lattice, as the TPU kernel's masked row sum gives.
  if (col && u == ulen) ll[b] = up;
  if (u == 0 && !(ulen >= 0 && ulen < U1)) ll[b] = 0.f;
}

// blank[t, u], emit[t, u] and alpha[t, u] into bl, em and al when (t, u)
// lies in the lattice; else they are left as they are.  alb is the batch
// row's alphas, row t at t * a_stride.
__device__ __forceinline__ void fetch_bwd_cell(
    float& bl, float& em, float& al, const float* __restrict__ lpb,
    const float* __restrict__ lpe, const float* __restrict__ alb,
    size_t a_stride, int t, int u, int T, int U1, int flen, int ulen,
    bool col) {
  if (col && t >= 0 && t < T) {
    bl = blank_at(lpb, t, u, U1, flen);
    em = emit_at(lpe, t, u, U1, flen, ulen);
    al = alb[static_cast<size_t>(t) * a_stride + u];
  }
}

// K4, K3's wavefront walked from the end.  Grid: (B); block: U1 rounded up
// to a warp (at most 1024 threads); 24 KB of dynamic shared memory a warp
// when STAGED, else none.  g (B,) is the cotangent of ll; gblank and gemit
// are (B, T, U1), the layout of the inputs.  Thread u computes beta[d - u,
// u] on diagonal d, from d = T + U1 - 2 down to 0; its warp's lanes are on
// 32 consecutive rows t at once, the highest column on the lowest row.
//
// Lane u keeps one register, beta: its last cell's beta, which is
// beta[t+1, u] for its next cell and, read by lane u-1 through
// __shfl_down_sync, beta[t, u+1] for lane u-1's (at a warp's edge through a
// shared slot double-buffered by the diagonal's parity, so one barrier a
// diagonal is enough).  Both occupancies of a cell are known on its own
// diagonal, so their exps sit beside the chain, not on it.
//
// On descending diagonals the warp's last lattice column (lane 31 but in
// the last warp) reaches a row first and lane 0 last.  STAGED, each
// diagonal the warp copies the row its last column reaches kP diagonals on
// by cp.async, along u (lane l its column l), into its rows of blank, emit
// and alpha (t mod kRowsBwd), and each lane waits for its own copies only
// when it reaches them; a cell's occupancies overwrite its blank and emit,
// and the warp stores each row of both along u once lane 0 has written it.
// Each lane reads and writes only its own column of the rows, so the warp
// needs no barrier of its own.  (Loaded into registers kP diagonals ahead
// and then stored into the rows, as K3 does, they took the long step's K4
// to 0.62 ms against 0.40 so, on an H100 80GB HBM3 at 700 W: PERF.md
// section 6.)  UnSTAGED (above kMaxStagedWarpsBwd warps, where the rows do
// not fit), each lane loads its own cells kP diagonals ahead into registers
// and stores its own occupancies.
template <int P, bool STAGED>
__global__ void __launch_bounds__(STAGED ? 32 * kMaxStagedWarpsBwd : 1024)
rnnt_bwd_kernel(const float* __restrict__ lp_blank,  // (B, T, U1)
                const float* __restrict__ lp_emit,   // (B, T, U1)
                const int* __restrict__ logit_lens,  // (B,)
                const int* __restrict__ label_lens,  // (B,)
                const float* __restrict__ alphas,    // (T, B, U1)
                const float* __restrict__ ll,        // (B,)
                const float* __restrict__ g,         // (B,)
                float* __restrict__ gblank,          // (B, T, U1)
                float* __restrict__ gemit,           // (B, T, U1)
                int B, int T, int U1) {
  extern __shared__ float ring[];  // STAGED: (warps, 3, kRowsBwd, 32)
  __shared__ float edge[2][32];    // lane 0's beta of each warp, by parity
  constexpr int kR = kRowsBwd;
  const int b = blockIdx.x;
  const int u = threadIdx.x, lane = u & 31, warp = u >> 5;
  const bool col = u < U1;
  const int flen = logit_lens[b];
  const int ulen = label_lens[b];
  const float logz = ll[b];
  const float gb = g[b];
  const size_t base = static_cast<size_t>(b) * T * U1;
  const float* lpb = lp_blank + base;
  const float* lpe = lp_emit + base;
  const float* alb = alphas + static_cast<size_t>(b) * U1;
  const size_t a_stride = static_cast<size_t>(B) * U1;
  float* gbo = gblank + base + u;
  float* geo = gemit + base + u;
  float* brow = ring + warp * 3 * kR * 32 + lane;  // blank, then gblank
  float* erow = brow + kR * 32;                    // emit, then gemit
  float* arow = erow + kR * 32;                    // alpha
  // The warp's last lattice column, whose lane reaches each row first.
  const int last = min(31, U1 - 1 - warp * 32);
  // The row a lane loads for diagonal d is d - lag: STAGED, lane last's row
  // for every lane; else the lane's own.
  const int lag = warp * 32 + (STAGED ? last : lane);
  const int D = T + U1 - 1;

  // STAGED: copy row r's cell of this lane's column into its slot.
  auto stage = [&](int r) {
    if (col && r >= 0 && r < T) {
      const int at = (r & (kR - 1)) * 32;
      cp_async4(brow + at, lpb + static_cast<size_t>(r) * U1 + u);
      cp_async4(erow + at, lpe + static_cast<size_t>(r) * U1 + u);
      cp_async4(arow + at, alb + static_cast<size_t>(r) * a_stride + u);
    }
    cp_async_commit();
  };
  // UnSTAGED: registers ahead of the cells; on step k (diagonal D - 1 -
  // k), slot k mod P holds blank, emit and alpha of the lane's row D - 1 -
  // k - lag, and is then loaded with the row P diagonals further down.
  float pb[STAGED ? 1 : P], pe[STAGED ? 1 : P], pa[STAGED ? 1 : P];
  if constexpr (STAGED) {
    // The rows lane last reaches on the first P diagonals, a group each.
#pragma unroll
    for (int j = 0; j < P; ++j) stage(D - 1 - j - lag);
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      pb[j] = 0.f;
      pe[j] = kNegInf;
      pa[j] = kNegInf;
      fetch_bwd_cell(pb[j], pe[j], pa[j], lpb, lpe, alb, a_stride,
                     D - 1 - j - lag, u, T, U1, flen, ulen, col);
    }
  }
  if (threadIdx.x < 64) edge[threadIdx.x >> 5][lane] = kNegInf;
  __syncthreads();

  // beta[T, u]: 0 at u = ulen, else -inf (also past the lattice's columns,
  // whose lanes lane U1 - 1 reads as beta[t, U1]).
  float beta = (col && u == ulen) ? 0.f : kNegInf;
  const bool last_warp = warp == (blockDim.x >> 5) - 1;
  const bool one_warp = blockDim.x == 32;
  for (int k0 = 0; k0 < D; k0 += P) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int k = k0 + j;
      if (k >= D) break;
      const int d = D - 1 - k;
      const int t = d - u;
      const bool cell = col && t >= 0 && t < T;
      float bl = 0.f, em = kNegInf, al = kNegInf;  // this diagonal's cell
      if constexpr (STAGED) {
        // The lane copied its cell at least P - 1 groups ago (lane last
        // exactly), pad-invariant rewrite on the way out.
        cp_async_wait<P - 1>();
        if (cell) {
          const int at = (t & (kR - 1)) * 32;
          bl = t >= flen ? 0.f : brow[at];
          em = (t >= flen || u >= ulen) ? kNegInf : erow[at];
          al = arow[at];
        }
        stage(d - P - lag);
      } else {
        bl = pb[j];
        em = pe[j];
        al = pa[j];
        fetch_bwd_cell(pb[j], pe[j], pa[j], lpb, lpe, alb, a_stride,
                       d - P - lag, u, T, U1, flen, ulen, col);
      }
      // beta[t, u+1], computed on the diagonal before.
      float right = __shfl_down_sync(0xffffffffu, beta, 1);
      if (lane == 31) right = last_warp ? kNegInf : edge[(d + 1) & 1][warp + 1];
      if (cell) {
        const float next = logaddexp(bl + beta, em + right);
        // The occupancies, summed as the plain version sums them.
        float gbk = expf(al + bl + beta - logz) * gb;
        float gem = expf(al + em + right - logz) * gb;
        if (isnan(gem)) gem = 0.f;
        if (t >= flen) {
          gbk = 0.f;
          gem = 0.f;
        }
        if constexpr (STAGED) {
          brow[(t & (kR - 1)) * 32] = gbk;
          erow[(t & (kR - 1)) * 32] = gem;
        } else {
          gbo[static_cast<size_t>(t) * U1] = gbk;
          geo[static_cast<size_t>(t) * U1] = gem;
        }
        beta = next;
      }
      if (lane == 0) edge[d & 1][warp] = beta;
      if constexpr (STAGED) {
        // Row r of the warp's occupancies is complete: lane 0 wrote it just
        // now.
        const int r = d - warp * 32;
        if (col && r >= 0 && r < T) {
          gbo[static_cast<size_t>(r) * U1] = brow[(r & (kR - 1)) * 32];
          geo[static_cast<size_t>(r) * U1] = erow[(r & (kR - 1)) * 32];
        }
      }
      // One barrier a diagonal: an edge slot is rewritten no sooner than
      // the diagonal after the one that reads it.
      if (one_warp) __syncwarp();
      else __syncthreads();
    }
  }
  if constexpr (STAGED) cp_async_wait<0>();  // no copy outlives the block
}

int block_for(int U1) { return ((U1 + 31) / 32) * 32; }

}  // namespace

// K3 on `stream`: one launch, one block per batch row.  Returns the launch
// error (0 when it was accepted); neither synchronises nor allocates.
// U1 must be at most 1024 (one thread per lattice column).
extern "C" int rnnt_lattice_fwd(const void* lp_blank, const void* lp_emit,
                                const void* logit_lens, const void* label_lens,
                                void* alphas, void* ll, int B, int T, int U1,
                                void* stream) {
  const int threads = block_for(U1);
  const bool staged = threads / 32 <= kMaxStagedWarps;
  const int smem = threads * (staged ? 64 : 32) *
                   static_cast<int>(sizeof(float));
  const auto kernel = staged ? rnnt_fwd_kernel<kPrefetch, true>
                             : rnnt_fwd_kernel<kPrefetch, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(lp_blank), static_cast<const float*>(lp_emit),
      static_cast<const int*>(logit_lens), static_cast<const int*>(label_lens),
      static_cast<float*>(alphas), static_cast<float*>(ll), B, T, U1);
  return static_cast<int>(cudaGetLastError());
}

// K4 on `stream`: one launch, one block per batch row, as K3.
extern "C" int rnnt_lattice_bwd(const void* lp_blank, const void* lp_emit,
                                const void* logit_lens, const void* label_lens,
                                const void* alphas, const void* ll,
                                const void* g, void* gblank, void* gemit,
                                int B, int T, int U1, void* stream) {
  const int threads = block_for(U1);
  const bool staged = threads / 32 <= kMaxStagedWarpsBwd;
  const int smem = staged ? threads * 3 * kRowsBwd *
                                static_cast<int>(sizeof(float))
                          : 0;
  const auto kernel = staged ? rnnt_bwd_kernel<kPrefetch, true>
                             : rnnt_bwd_kernel<kPrefetch, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
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
