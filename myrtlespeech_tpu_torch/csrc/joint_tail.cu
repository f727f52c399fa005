// K5: the transducer joint tail and blank/emit front, forward, written by
// hand for Hopper (sm_90a).
//
// K5 replaces myrtlespeech_tpu/ops/pallas/joint_kernel.py::_fwd_kernel
// (pallas_call in _jt_impl).  After the joint's two first-layer projections
// fp (B, T, K) and gp (B, U+1, K) (bias folded into gp), each lattice cell
// (b, t, u) needs
//
//   h      = act(fp[b, t] + gp[b, u])         add and act in bf16
//   logits = h @ W2 + b2                      bf16 products, fp32 sums
//   lp_blank = logits[blank] - lse(logits),  lp_emit = logits[lab[b, u]] - lse
//
// Neither the (B, T, U+1, K) hidden nor the (B, T, U+1, V) logits is ever
// written to device memory: K5 writes the two (B, T, U+1) fp32 outputs.  Its
// backward, K6, is csrc/joint_tail_bwd.cu; the helpers both use are in
// csrc/joint_tail.cuh.
//
// What bounds it on the card: the tensor-core product, 2 * cells * K * V
// operations.  At the 16.7 s batch of rnn_t_en (B=128, T'=836, U+1=215,
// K=512, V=29: 23.0 M cells) that is 683 GFLOP, some 0.69 ms at 989 TFLOP/s,
// against about 0.10 ms of bytes.  At the flagship 5 s shape (B=32, T'=251,
// U+1=65) the bound is about 0.016 ms.
//
// What the design does about it: every product is mma.sync m16n8k16 (bf16
// in, fp32 sums) fed by ldmatrix from shared memory, with rows padded by 16
// bytes so that the 8 rows of an ldmatrix hit distinct banks.  A block owns
// one batch row b and a t-tile of 32 frames (two mma row tiles); the
// t-tile's fp rows and W2^T (32 columns of V) stay in shared memory for the
// block's life.  Each of its 8 warps walks its own groups of kUG u, for all
// 32 frames and the full K: for every k16 step it loads fp's A fragments of
// both row tiles and W2's B fragments of the 4 n-tiles by ldmatrix.x4, once
// for all kUG x 2 row tiles, and one gp word pair per u, and builds each
// row tile's A fragment of h in registers (fma.rn.relu for ReLU: the add
// and the activation in one instruction).
// That is 20 shared wavefronts for 16 products at kUG = 2 (the kernel it
// replaced, one u a warp over 16 frames, spent 3.5 a product), so the
// tensor pipe, not the load unit, sets the pace.  A warp's next gp rows come
// in by cp.async into its own double buffer while it works, so for V <= 32
// no barrier stops the block after its first.  Each row's log-sum-exp stays
// inside its warp (the quad of threads that holds it); each thread then
// writes one frame's results for the group's u.  For V > 32 the vocabulary
// runs in chunks of 32 columns with an online log-sum-exp across them; the
// warps then take their groups in step, and W2's chunk is loaded between
// two barriers.
// The TPU kernel's 8-row slabs, U+1 padded to 8, V padded to 128 lanes,
// (T, B*U1p, 1) row-columns and TT frames per grid step are not carried over.
//
// Contract (checked by ops/cuda/joint_kernel.py): fp, gp bf16 with K
// zero-padded to Kp, a multiple of 64 and at most 512, rows 16-byte aligned;
// W2 bf16 zero-padded to (Kp, Vp), Vp a multiple of 32, given as (Vp, Kp);
// b2 fp32 (V,); lab int32 (B, U+1) with labels in [0, V); U+1 at most 1024.

#include "joint_tail.cuh"

namespace {

constexpr int kTT = 32;           // frames of a block's t-tile
constexpr int kMT = kTT / 16;     // its m16 row tiles
constexpr int kUG = 2;            // u of a warp's group
constexpr int kNW = 8;            // warps a block
constexpr int kThreads = kNW * 32;

// Running max, sum of exponentials, blank and label logit of the two rows
// (g and g+8) of a row tile that a thread holds; the four threads of a quad
// agree after each update.
struct RowState {
  float m, s, xb, xe;
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fold chunk c's logits (+ b2, -inf past V through b2S) into the state.
__device__ __forceinline__ void online_update(RowState (&st)[2],
                                              const float (&acc)[4][4],
                                              const float* b2S, int c,
                                              int blank, int lab, int q) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float x[8];
    float cmax = -INFINITY, xb = 0.f, xe = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int v = c * kVC + nt * 8 + 2 * q + j;
        const float val = acc[nt][half * 2 + j] + b2S[v];
        x[nt * 2 + j] = val;
        cmax = fmaxf(cmax, val);
        if (v == blank) xb += val;
        if (v == lab) xe += val;
      }
    cmax = quad_max(cmax);  // finite: column c*32 lies inside V
    const float m = fmaxf(st[half].m, cmax);
    float cs = 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) cs += expf(x[i] - m);
    cs = quad_sum(cs);
    // On the first chunk the state is empty: s * exp(-inf - m) is 0.
    st[half].s = c == 0 ? cs : st[half].s * expf(st[half].m - m) + cs;
    st[half].m = m;
    st[half].xb += quad_sum(xb);
    st[half].xe += quad_sum(xe);
  }
}

// act(f + g) on a pair in one instruction where it can: ReLU as
// fma.rn.relu (f * 1 + g, rounded once, then clamped at 0), hardtanh that
// and a min with the clip, the identity an add.  The same bits as hidden2's
// add, then max (for finite pairs), with half its instructions.
template <int ACT>
__device__ __forceinline__ uint32_t hidden_pair(uint32_t f, uint32_t g,
                                                bf162 clip2) {
  uint32_t d;
  if (ACT == kIdentity) {
    asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(f), "r"(g));
    return d;
  }
  asm("fma.rn.relu.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(f), "r"(0x3f803f80u), "r"(g));  // 0x3f80: 1.0 in bf16
  if (ACT == kHardtanh) d = as_u32(__hmin2(as_bf2(d), clip2));
  return d;
}

// 16 bytes from device to shared memory without holding registers, by
// cp.async in commit groups; cp_wait_prior waits for all groups but the
// newest, cp_wait_all for all, each for this thread's own copies.
__device__ __forceinline__ void cp16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A warp's gp rows u0 .. u0 + kUG - 1 (rows past U1 repeat row U1 - 1, and
// their results are dropped) into its buffer `dst`, by cp.async: one commit
// group.
__device__ __forceinline__ void fetch_gp(bf16* dst, int rs, const bf16* gp_b,
                                         int u0, int U1, int Kp, int lane) {
  const int per_row = Kp / 8;
  for (int i = lane; i < kUG * per_row; i += 32) {
    const int j = i / per_row, c = (i - j * per_row) * 8;
    const int u = min(u0 + j, U1 - 1);
    cp16(saddr(dst + j * rs + c), gp_b + static_cast<size_t>(u) * Kp + c);
  }
  cp_commit();
}

// K5.  Grid (ceil(T/32), B); block 8 warps.  Warp w takes the groups of kUG
// u numbered w, w + 8, ...; for V > 32 (CHUNKS) all warps take their groups
// in step, each chunk of W2 loaded between two barriers.
template <int ACT, bool CHUNKS>
__global__ void __launch_bounds__(kThreads, CHUNKS ? 1 : 2)
joint_tail_fwd_kernel(const bf16* __restrict__ fp,   // (B, T, Kp)
                      const bf16* __restrict__ gp,   // (B, U1, Kp)
                      const bf16* __restrict__ w2v,  // (Vp, Kp)
                      const float* __restrict__ b2,  // (V,)
                      const int* __restrict__ lab,   // (B, U1)
                      float* __restrict__ lpb,       // (B, T, U1)
                      float* __restrict__ lpe,       // (B, T, U1)
                      int T, int U1, int Kp, int V, int Vp, int blank,
                      float clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rs = Kp + 8;
  bf16* fpS = reinterpret_cast<bf16*>(smem);          // (32 frames, rs)
  bf16* w2S = fpS + kTT * rs;                         // (32 v, rs)
  bf16* gpS = w2S + kVC * rs;                         // (8 warps, 2, kUG, rs)
  float* b2S = reinterpret_cast<float*>(gpS + kNW * 2 * kUG * rs);  // (Vp,)

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nch = CHUNKS ? Vp / kVC : 1;
  const bf162 clip2 = __float2bfloat162_rn(clip);
  const bf16* gp_b = gp + static_cast<size_t>(b) * U1 * Kp;
  bf16* gpW = gpS + warp * 2 * kUG * rs;

  const int n_groups = (U1 + kUG - 1) / kUG;
  const int n_iter = (n_groups + kNW - 1) / kNW;
  fetch_gp(gpW, rs, gp_b, warp * kUG, U1, Kp, lane);
  load_rows(fpS, rs, fp + (static_cast<size_t>(b) * T + t0) * Kp, Kp, kTT,
            min(kTT, T - t0), Kp);
  load_bias(b2S, b2, V, Vp);
  if (!CHUNKS) load_rows(w2S, rs, w2v, Kp, kVC, kVC, Kp);
  __syncthreads();

  // This lane's ldmatrix addresses: fp's A fragments (row lane & 15, column
  // (lane >> 4) * 8 of a 16x16 block), W2's B fragments (two n-tiles a
  // load).
  const uint32_t fpa = saddr(fpS + (lane & 15) * rs + (lane >> 4) * 8);
  const uint32_t w2a = saddr(w2S + ((lane & 7) + ((lane >> 4) << 3)) * rs +
                             ((lane >> 3) & 1) * 8);
  // The frame whose results this thread writes: row tile q >> 1, row
  // g + 8 (q & 1).
  const int t_out = t0 + (q >> 1) * 16 + (q & 1) * 8 + g;

  for (int it = 0; it < n_iter; ++it) {
    const int u0 = (it * kNW + warp) * kUG;
    const bool active = u0 < U1;
    const bf16* gcur = gpW + (it & 1) * kUG * rs;
    // The next group's gp rows, while this one runs.
    fetch_gp(gpW + ((it + 1) & 1) * kUG * rs, rs, gp_b,
             ((it + 1) * kNW + warp) * kUG, U1, Kp, lane);
    int lab_u[kUG];
#pragma unroll
    for (int j = 0; j < kUG; ++j)
      lab_u[j] = u0 + j < U1 ? lab[b * U1 + u0 + j] : 0;
    cp_wait_prior();  // this group's rows have landed (own copies)
    __syncwarp();     // and the other lanes' too

    RowState st[kUG][kMT][2];
#pragma unroll
    for (int j = 0; j < kUG; ++j)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          st[j][mt][h] = RowState{-INFINITY, 0.f, 0.f, 0.f};

    for (int c = 0; c < nch; ++c) {
      if (CHUNKS) {
        __syncthreads();  // every warp is done with the last chunk
        load_rows(w2S, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp, kVC,
                  kVC, Kp);
        __syncthreads();
      }
      if (!active) continue;
      float acc[kUG][kMT][4][4];
#pragma unroll
      for (int j = 0; j < kUG; ++j)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][mt][nt][e] = 0.f;
      const uint32_t* gw = reinterpret_cast<const uint32_t*>(gcur) + q;
#pragma unroll 4
      for (int ks = 0; ks < Kp / 16; ++ks) {
        uint32_t f[kMT][4], w[2][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm4(f[mt], fpa + (mt * 16 * rs + ks * 16) * 2);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          ldsm4(w[h], w2a + (h * 16 * rs + ks * 16) * 2);
#pragma unroll
        for (int j = 0; j < kUG; ++j) {
          const uint32_t glo = gw[j * rs / 2 + ks * 8];
          const uint32_t ghi = gw[j * rs / 2 + ks * 8 + 4];
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            uint32_t a[4];
            a[0] = hidden_pair<ACT>(f[mt][0], glo, clip2);
            a[1] = hidden_pair<ACT>(f[mt][1], glo, clip2);
            a[2] = hidden_pair<ACT>(f[mt][2], ghi, clip2);
            a[3] = hidden_pair<ACT>(f[mt][3], ghi, clip2);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_bf16(acc[j][mt][nt], a, w[nt >> 1][(nt & 1) * 2],
                       w[nt >> 1][(nt & 1) * 2 + 1]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kUG; ++j)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#ifndef K5_SKIP_SOFTMAX
          online_update(st[j][mt], acc[j][mt], b2S, c, blank, lab_u[j], q);
#else  // a measuring build (port_tools/kernel_probe.py): the products alone
#pragma unroll
          for (int h = 0; h < 2; ++h)
            st[j][mt][h] = RowState{acc[j][mt][0][2 * h] + acc[j][mt][1][2 * h]
                                    + acc[j][mt][2][2 * h + 1]
                                    + acc[j][mt][3][2 * h], 1.f, 0.f, 0.f};
#endif
    }

    if (active && t_out < T) {
      const size_t at = (static_cast<size_t>(b) * T + t_out) * U1 + u0;
#pragma unroll
      for (int j = 0; j < kUG; ++j) {
        // The quad agrees on every row's state: thread q takes row tile
        // q >> 1, half q & 1.
        RowState r = st[j][0][0];
        if (q == 1) r = st[j][0][1];
        if (q == 2) r = st[j][1][0];
        if (q == 3) r = st[j][1][1];
        const float lse = r.m + logf(r.s);
        if (u0 + j < U1) {
          lpb[at + j] = r.xb - lse;
          lpe[at + j] = r.xe - lse;
        }
      }
    }
    __syncwarp();  // gcur is refilled by the next iteration's fetch
  }
  cp_wait_all();
}

size_t fwd_smem(int Kp, int Vp) {
  return static_cast<size_t>(kTT + kVC + kNW * 2 * kUG) * (Kp + 8) *
             sizeof(bf16) +
         Vp * sizeof(float);
}

template <int ACT, bool CHUNKS>
cudaError_t launch(const void* fp, const void* gp, const void* w2v,
                   const void* b2, const void* lab, void* lpb, void* lpe,
                   int B, int T, int U1, int Kp, int V, int Vp, int blank,
                   float clip, cudaStream_t stream) {
  const size_t smem = fwd_smem(Kp, Vp);
  cudaError_t err = cudaFuncSetAttribute(
      joint_tail_fwd_kernel<ACT, CHUNKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((T + kTT - 1) / kTT, B);
  joint_tail_fwd_kernel<ACT, CHUNKS><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(fp), static_cast<const bf16*>(gp),
      static_cast<const bf16*>(w2v), static_cast<const float*>(b2),
      static_cast<const int*>(lab), static_cast<float*>(lpb),
      static_cast<float*>(lpe), T, U1, Kp, V, Vp, blank, clip);
  return cudaGetLastError();
}

template <int ACT>
cudaError_t launch_act(const void* fp, const void* gp, const void* w2v,
                       const void* b2, const void* lab, void* lpb, void* lpe,
                       int B, int T, int U1, int Kp, int V, int Vp, int blank,
                       float clip, cudaStream_t stream) {
  if (Vp > kVC)
    return launch<ACT, true>(fp, gp, w2v, b2, lab, lpb, lpe, B, T, U1, Kp, V,
                             Vp, blank, clip, stream);
  return launch<ACT, false>(fp, gp, w2v, b2, lab, lpb, lpe, B, T, U1, Kp, V,
                            Vp, blank, clip, stream);
}

template <int ACT, bool CHUNKS>
cudaError_t attrs(int Kp, int Vp, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, joint_tail_fwd_kernel<ACT, CHUNKS>);
  if (err != cudaSuccess) return err;
  const int smem = static_cast<int>(fwd_smem(Kp, Vp));
  err = cudaFuncSetAttribute(joint_tail_fwd_kernel<ACT, CHUNKS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, joint_tail_fwd_kernel<ACT, CHUNKS>, kThreads, smem);
  if (err != cudaSuccess) return err;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(a.sharedSizeBytes);
  out[3] = a.maxThreadsPerBlock;
  out[4] = smem;
  out[5] = blocks;
  return cudaSuccess;
}

template <int ACT>
cudaError_t attrs_act(int Kp, int Vp, int* out) {
  return Vp > kVC ? attrs<ACT, true>(Kp, Vp, out)
                  : attrs<ACT, false>(Kp, Vp, out);
}

}  // namespace

// K5 on `stream`: one launch of grid (ceil(T/32), B).  Returns the CUDA
// error (0 when the launch was accepted); neither synchronises nor
// allocates.
extern "C" int joint_tail_fwd(const void* fp, const void* gp, const void* w2v,
                              const void* b2, const void* lab, void* lpb,
                              void* lpe, int B, int T, int U1, int Kp, int V,
                              int Vp, int blank, int act, float clip,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == kRelu)
    err = launch_act<kRelu>(fp, gp, w2v, b2, lab, lpb, lpe, B, T, U1, Kp, V,
                            Vp, blank, clip, s);
  else if (act == kHardtanh)
    err = launch_act<kHardtanh>(fp, gp, w2v, b2, lab, lpb, lpe, B, T, U1, Kp,
                                V, Vp, blank, clip, s);
  else
    err = launch_act<kIdentity>(fp, gp, w2v, b2, lab, lpb, lpe, B, T, U1, Kp,
                                V, Vp, blank, clip, s);
  return static_cast<int>(err);
}

// The kernel's attributes for activation `act` at Kp and Vp: out[0..5] =
// registers a thread, local (spill) bytes a thread, static shared bytes,
// most threads a block, dynamic shared bytes a block, blocks resident on an
// SM.  Returns the CUDA error.
extern "C" int joint_tail_fwd_attrs(int act, int Kp, int Vp, int* out) {
  cudaError_t err;
  if (act == kRelu) err = attrs_act<kRelu>(Kp, Vp, out);
  else if (act == kHardtanh) err = attrs_act<kHardtanh>(Kp, Vp, out);
  else err = attrs_act<kIdentity>(Kp, Vp, out);
  return static_cast<int>(err);
}

extern "C" const char* joint_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
