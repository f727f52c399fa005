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
// in, fp32 sums) in the kernel's body, on operands kept in shared memory
// with rows padded by 16 bytes so that the fragment loads hit 32 distinct
// banks.  A block owns 16 frames t of one batch row b (one mma row tile) and
// walks all u in groups of one u per warp; it has Kp / 64 warps.  Each warp
// builds h for its u straight into A fragments (fp rows of the block, gp row
// of the u) and runs the full K against W2, 32 vocabulary columns at a time.
// An online log-sum-exp across those chunks keeps the blank and label logits
// as they pass, so any V works; for V <= 32 (the main path, V=29) W2 is
// loaded once per block.
// The TPU kernel's 8-row slabs, U+1 padded to 8, V padded to 128 lanes,
// (T, B*U1p, 1) row-columns and TT frames per grid step are not carried over.
//
// Contract (checked by ops/cuda/joint_kernel.py): fp, gp bf16 with K
// zero-padded to Kp, a multiple of 64 and at most 512; W2 bf16 zero-padded
// to (Kp, Vp), Vp a multiple of 32, given as (Vp, Kp); b2 fp32 (V,); lab
// int32 (B, U+1) with labels in [0, V); U+1 at most 1024.

#include "joint_tail.cuh"

namespace {

constexpr int kRows = 16;       // frames t of a block: one mma row tile
constexpr int kKSlice = 64;     // columns of K a warp covers (Kp / 64 warps)
constexpr int kMaxThreads = 256;  // Kp <= 512: at most 8 warps

// One chunk's logits (without b2) of the 16 frames of the block for one u:
// acc[nt] is the C fragment of columns nt*8 .. nt*8+7 of the chunk.  fpS is
// (16, rs) and w2vS (32, rs) with rs = Kp + 8; gp_row is the u's gp row.
__device__ __forceinline__ void chunk_logits(float (&acc)[4][4],
                                             const bf16* fpS,
                                             const bf16* gp_row,
                                             const bf16* w2vS, int Kp,
                                             int rs, int act, bf162 clip2,
                                             int g, int q) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
  const uint32_t* f0 = reinterpret_cast<const uint32_t*>(fpS + g * rs);
  const uint32_t* f1 = reinterpret_cast<const uint32_t*>(fpS + (g + 8) * rs);
  const uint32_t* gr = reinterpret_cast<const uint32_t*>(gp_row);
  const uint32_t* wr[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    wr[nt] = reinterpret_cast<const uint32_t*>(w2vS + (nt * 8 + g) * rs);
#pragma unroll 4
  for (int ks = 0; ks < Kp / 16; ++ks) {
    const int w = ks * 8 + q;  // word of columns ks*16 + 2q, 2q+1
    const uint32_t glo = gr[w], ghi = gr[w + 4];
    uint32_t a[4];
    a[0] = as_u32(hidden2(f0[w], glo, act, clip2));
    a[1] = as_u32(hidden2(f1[w], glo, act, clip2));
    a[2] = as_u32(hidden2(f0[w + 4], ghi, act, clip2));
    a[3] = as_u32(hidden2(f1[w + 4], ghi, act, clip2));
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[nt], a, wr[nt][w], wr[nt][w + 4]);
  }
}

// Running max, sum of exponentials, blank and label logit of the two rows
// (g and g+8) a thread holds; the four threads of a quad agree after each
// update.
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
    st[half].s = st[half].s * expf(st[half].m - m) + cs;
    st[half].m = m;
    st[half].xb += quad_sum(xb);
    st[half].xe += quad_sum(xe);
  }
}

__device__ __forceinline__ void init_state(RowState (&st)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) st[h] = RowState{-INFINITY, 0.f, 0.f, 0.f};
}

// K5.  Grid (ceil(T/16), B); block Kp/64 warps.
__global__ void __launch_bounds__(kMaxThreads)
joint_tail_fwd_kernel(const bf16* __restrict__ fp,   // (B, T, Kp)
                      const bf16* __restrict__ gp,   // (B, U1, Kp)
                      const bf16* __restrict__ w2v,  // (Vp, Kp)
                      const float* __restrict__ b2,  // (V,)
                      const int* __restrict__ lab,   // (B, U1)
                      float* __restrict__ lpb,       // (B, T, U1)
                      float* __restrict__ lpe,       // (B, T, U1)
                      int T, int U1, int Kp, int V, int Vp, int blank,
                      int act, float clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = blockDim.x / 32;
  const int rs = Kp + 8;
  bf16* fpS = reinterpret_cast<bf16*>(smem);
  bf16* w2vS = fpS + kRows * rs;
  bf16* gpS = w2vS + kVC * rs;
  float* outB = reinterpret_cast<float*>(gpS + NW * rs);  // (16, NW)
  float* outE = outB + kRows * NW;
  float* b2S = outE + kRows * NW;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int nch = Vp / kVC;
  const bf162 clip2 = __float2bfloat162_rn(clip);

  load_rows(fpS, rs, fp + (static_cast<size_t>(b) * T + t0) * Kp, Kp, kRows,
            min(kRows, T - t0), Kp);
  load_bias(b2S, b2, V, Vp);
  if (nch == 1) load_rows(w2vS, rs, w2v, Kp, kVC, kVC, Kp);

  for (int ug = 0; ug < U1; ug += NW) {
    __syncthreads();  // the last group's gp rows and outputs are consumed
    load_rows(gpS, rs, gp + (static_cast<size_t>(b) * U1 + ug) * Kp, Kp, NW,
              min(NW, U1 - ug), Kp);
    const int u = ug + warp;
    const int lab_u = u < U1 ? lab[b * U1 + u] : 0;
    RowState st[2];
    init_state(st);
    for (int c = 0; c < nch; ++c) {
      if (nch > 1) {
        __syncthreads();
        load_rows(w2vS, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp, kVC,
                  kVC, Kp);
      }
      __syncthreads();
      if (u < U1) {
        float acc[4][4];
        chunk_logits(acc, fpS, gpS + warp * rs, w2vS, Kp, rs, act, clip2, g,
                     q);
        online_update(st, acc, b2S, c, blank, lab_u, q);
      }
    }
    if (u < U1 && q == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float lse = st[h].m + logf(st[h].s);
        outB[(g + 8 * h) * NW + warp] = st[h].xb - lse;
        outE[(g + 8 * h) * NW + warp] = st[h].xe - lse;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kRows * NW; i += blockDim.x) {
      const int r = i / NW, j = i - r * NW;
      const int t = t0 + r, uu = ug + j;
      if (t < T && uu < U1) {
        const size_t at = (static_cast<size_t>(b) * T + t) * U1 + uu;
        lpb[at] = outB[i];
        lpe[at] = outE[i];
      }
    }
  }
}

size_t fwd_smem(int Kp, int NW, int Vp) {
  return static_cast<size_t>(kRows + kVC + NW) * (Kp + 8) * sizeof(bf16) +
         (2 * kRows * NW + Vp) * sizeof(float);
}

}  // namespace

// K5 on `stream`: one launch.  Returns the CUDA error (0 when the launch was
// accepted); neither synchronises nor allocates.
extern "C" int joint_tail_fwd(const void* fp, const void* gp, const void* w2v,
                              const void* b2, const void* lab, void* lpb,
                              void* lpe, int B, int T, int U1, int Kp, int V,
                              int Vp, int blank, int act, float clip,
                              void* stream) {
  const int NW = Kp / kKSlice;
  const size_t smem = fwd_smem(Kp, NW, Vp);
  cudaError_t err = cudaFuncSetAttribute(
      joint_tail_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, B);
  joint_tail_fwd_kernel<<<grid, NW * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(fp), static_cast<const bf16*>(gp),
      static_cast<const bf16*>(w2v), static_cast<const float*>(b2),
      static_cast<const int*>(lab), static_cast<float*>(lpb),
      static_cast<float*>(lpe), T, U1, Kp, V, Vp, blank, act, clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* joint_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
