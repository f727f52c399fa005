// K5 and K6: the transducer joint tail and blank/emit front, forward and
// backward, written by hand for Hopper (sm_90a).
//
// K5 replaces myrtlespeech_tpu/ops/pallas/joint_kernel.py::_fwd_kernel
// (pallas_call in _jt_impl), K6 replaces _bwd_kernel there (pallas_call in
// _jt_bwd).  After the joint's two first-layer projections fp (B, T, K) and
// gp (B, U+1, K) (bias folded into gp), each lattice cell (b, t, u) needs
//
//   h      = act(fp[b, t] + gp[b, u])         add and act in bf16
//   logits = h @ W2 + b2                      bf16 products, fp32 sums
//   lp_blank = logits[blank] - lse(logits),  lp_emit = logits[lab[b, u]] - lse
//
// and K6, from the cotangents gb, ge of those two outputs,
//
//   dlogits = gb onehot(blank) + ge onehot(lab) - (gb + ge) softmax(logits),
//             rounded to bf16
//   dh      = (dlogits @ W2^T) * act'(h)       (act' read off the bf16 h)
//   dfp[t]  = sum_u dh,  dgp[u] = sum_t dh,  dW2 = h^T @ dlogits,
//   db2     = sum of the rounded dlogits.
//
// Neither the (B, T, U+1, K) hidden nor the (B, T, U+1, V) logits is ever
// written to device memory: K5 writes the two (B, T, U+1) fp32 outputs, K6
// recomputes every tile.
//
// What bounds them on the card: the tensor-core products.  K5 does one,
// 2 * cells * K * V operations; K6 three (the recomputed logits, dh, dW2).
// At the 16.7 s batch of rnn_t_en (B=128, T'=836, U+1=215, K=512, V=29:
// 23.0 M cells) that is 683 GFLOP for K5, some 0.69 ms at 989 TFLOP/s,
// against about 0.10 ms of bytes; K6 about 2.07 ms against 0.18 ms.  At the
// flagship 5 s shape (B=32, T'=251, U+1=65) K5's bound is about 0.016 ms.
//
// What the design does about it: every product is mma.sync m16n8k16 (bf16
// in, fp32 sums) in the kernels' bodies, on operands kept in shared memory
// with rows padded by 16 bytes so that the fragment loads hit 32 distinct
// banks.  A block owns 16 frames t of one batch row b (one mma row tile) and
// walks all u in groups of one u per warp; it has Kp / 64 warps.
//   K5: each warp builds h for its u straight into A fragments (fp rows of
//       the block, gp row of the u) and runs the full K against W2, 32
//       vocabulary columns at a time.  An online log-sum-exp across those
//       chunks keeps the blank and label logits as they pass, so any V works;
//       for V <= 32 (the main path, V=29) W2 is loaded once per block.
//   K6: per group of u, each warp first recomputes its u's logits and writes
//       its bf16 dlogits (16 t x 32 v) to shared memory; then the warps
//       switch to owning 64 columns of K each and run, for every u of the
//       group, dh = dlogits @ W2^T (mask, then dfp summed in registers over
//       all u, dgp summed over the 16 t by shuffles) and dW2 += h^T @
//       dlogits (registers over all u).  Blocks share nothing, so dgp, dW2
//       and db2 go out as per-block partial sums that the wrapper adds up
//       (no atomics: the result does not vary from run to run).  For V > 32
//       the chunks run outermost and a first pass stores each cell's
//       log-sum-exp in shared memory.
// The TPU kernel's 8-row slabs, U+1 padded to 8, V padded to 128 lanes,
// (T, B*U1p, 1) row-columns and TT frames per grid step are not carried over.
//
// Contract (checked by ops/cuda/joint_kernel.py): fp, gp bf16 with K
// zero-padded to Kp, a multiple of 64 and at most 512; W2 bf16 zero-padded
// to (Kp, Vp), Vp a multiple of 32, given as (Vp, Kp) and (Kp, Vp); b2 fp32
// (V,); lab int32 (B, U+1) with labels in [0, V); U+1 at most 1024.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;       // frames t of a block: one mma row tile
constexpr int kKSlice = 64;     // columns of K a warp owns in K6's products
constexpr int kVC = 32;         // vocabulary columns per chunk
constexpr int kVRow = kVC + 8;  // bf16 stride of a chunk-wide shared row
constexpr int kMaxThreads = 256;  // Kp <= 512: at most 8 warps

enum Act { kRelu = 0, kHardtanh = 1, kIdentity = 2 };

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bf162 as_bf2(uint32_t u) {
  return *reinterpret_cast<bf162*>(&u);
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  bf162 v;
  v.x = lo;
  v.y = hi;
  return as_u32(v);
}

// D += A @ B for one m16n8k16 tile, bf16 operands, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// act(f + g) on a pair, the add rounded to bf16 as the TPU kernel's bf16 add.
__device__ __forceinline__ bf162 hidden2(uint32_t f, uint32_t g, int act,
                                         bf162 clip2) {
  const bf162 zero = __float2bfloat162_rn(0.f);
  bf162 a = __hadd2(as_bf2(f), as_bf2(g));
  if (act == kRelu) a = __hmax2(a, zero);
  else if (act == kHardtanh) a = __hmin2(__hmax2(a, zero), clip2);
  return a;
}

__device__ __forceinline__ bf16 hidden1(bf16 f, bf16 g, int act, bf16 clipb) {
  const bf16 zero = __float2bfloat16_rn(0.f);
  bf16 a = __hadd(f, g);
  if (act == kRelu) a = __hmax(a, zero);
  else if (act == kHardtanh) a = __hmin(__hmax(a, zero), clipb);
  return a;
}

// d act(a) / da from h = act(a), compared in fp32 (_act_grad_mask_from_h).
__device__ __forceinline__ float act_grad(float h, int act, float clip) {
  if (act == kRelu) return h > 0.f ? 1.f : 0.f;
  if (act == kHardtanh) return (h > 0.f && h < clip) ? 1.f : 0.f;
  return 1.f;
}

// Copy `rows` rows of `cols` bf16 (cols a multiple of 8, 16-byte aligned
// rows) into shared memory with row stride `dst_stride`; rows at or past
// `valid` become zeros.  All threads of the block take part.
__device__ void load_rows(bf16* dst, int dst_stride, const bf16* src,
                          int src_stride, int rows, int valid, int cols) {
  const int per_row = cols / 8;
  for (int i = threadIdx.x; i < rows * per_row; i += blockDim.x) {
    const int r = i / per_row;
    const int c = (i - r * per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      v = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) *
                                                    src_stride + c);
    *reinterpret_cast<uint4*>(dst + r * dst_stride + c) = v;
  }
}

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

// b2 into shared memory, -inf past V so that pad columns drop out.
__device__ void load_bias(float* b2S, const float* b2, int V, int Vp) {
  for (int v = threadIdx.x; v < Vp; v += blockDim.x)
    b2S[v] = v < V ? b2[v] : -INFINITY;
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

// K6.  Same grid and block as K5; registers capped at 128 so that two
// blocks share an SM (16 warps to hide the latency of the mma, shuffle and
// shared-memory chains), at the price of a few hundred bytes of spills.  Writes dfp (B, T, Kp) and, per block
// blk = b * gridDim.x + blockIdx.x, partial sums dgp_part (B, n_tt, U1, Kp),
// dw2_part (blk, Kp, Vp) and db2_part (blk, Vp).
__global__ void __launch_bounds__(kMaxThreads, 2)
joint_tail_bwd_kernel(const bf16* __restrict__ fp,   // (B, T, Kp)
                      const bf16* __restrict__ gp,   // (B, U1, Kp)
                      const bf16* __restrict__ w2v,  // (Vp, Kp)
                      const bf16* __restrict__ w2k,  // (Kp, Vp)
                      const float* __restrict__ b2,  // (V,)
                      const int* __restrict__ lab,   // (B, U1)
                      const float* __restrict__ gb,  // (B, T, U1)
                      const float* __restrict__ ge,  // (B, T, U1)
                      float* __restrict__ dfp, float* __restrict__ dgp_part,
                      float* __restrict__ dw2_part,
                      float* __restrict__ db2_part, int T, int U1, int Kp,
                      int V, int Vp, int blank, int act, float clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int NW = blockDim.x / 32;
  const int rs = Kp + 8;
  bf16* fpS = reinterpret_cast<bf16*>(smem);
  bf16* w2vS = fpS + kRows * rs;   // (32, rs): chunk rows v
  bf16* gpS = w2vS + kVC * rs;     // (NW, rs): the group's gp rows
  bf16* w2kS = gpS + NW * rs;      // (Kp, kVRow): chunk columns v
  bf16* dlS = w2kS + Kp * kVRow;   // (NW, 16, kVRow): each u's dlogits
  float* b2S = reinterpret_cast<float*>(dlS + NW * kRows * kVRow);  // (Vp)
  float* dbS = b2S + Vp;           // (NW, 32)
  float* lseS = dbS + NW * kVC;    // (16, U1), only when V > 32

  const int b = blockIdx.y, tt = blockIdx.x, n_tt = gridDim.x;
  const size_t blk = static_cast<size_t>(b) * n_tt + tt;
  const int t0 = tt * kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int k0 = warp * kKSlice;  // this warp's columns of K in the products
  const int nch = Vp / kVC;
  const bf162 clip2 = __float2bfloat162_rn(clip);
  const bf16 clipb = __float2bfloat16_rn(clip);

  load_rows(fpS, rs, fp + (static_cast<size_t>(b) * T + t0) * Kp, Kp, kRows,
            min(kRows, T - t0), Kp);
  load_bias(b2S, b2, V, Vp);

  if (nch > 1) {
    // Each cell's log-sum-exp over all chunks, as in K5.
    for (int ug = 0; ug < U1; ug += NW) {
      __syncthreads();
      load_rows(gpS, rs, gp + (static_cast<size_t>(b) * U1 + ug) * Kp, Kp,
                NW, min(NW, U1 - ug), Kp);
      const int u = ug + warp;
      RowState st[2];
      init_state(st);
      for (int c = 0; c < nch; ++c) {
        __syncthreads();
        load_rows(w2vS, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp, kVC,
                  kVC, Kp);
        __syncthreads();
        if (u < U1) {
          float acc[4][4];
          chunk_logits(acc, fpS, gpS + warp * rs, w2vS, Kp, rs, act, clip2,
                       g, q);
          online_update(st, acc, b2S, c, blank, -1, q);
        }
      }
      if (u < U1 && q == 0) {
        lseS[g * U1 + u] = st[0].m + logf(st[0].s);
        lseS[(g + 8) * U1 + u] = st[1].m + logf(st[1].s);
      }
    }
  }

  float dfacc[8][4];  // dfp of rows g, g+8 and this warp's 64 columns
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) dfacc[nt][i] = 0.f;

  for (int c = 0; c < nch; ++c) {
    __syncthreads();
    load_rows(w2vS, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp, kVC,
              kVC, Kp);
    load_rows(w2kS, kVRow, w2k + c * kVC, Vp, Kp, Kp, kVC);
    float dwacc[4][4][4];  // dW2 rows k0 + mt*16 (+g, +g+8), chunk columns
    float dbacc[4][2];     // db2 of the columns this thread holds
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) dwacc[mt][nt][i] = 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) dbacc[nt][0] = dbacc[nt][1] = 0.f;

    for (int ug = 0; ug < U1; ug += NW) {
      __syncthreads();  // the last group's gp rows and dlogits are consumed
      load_rows(gpS, rs, gp + (static_cast<size_t>(b) * U1 + ug) * Kp, Kp,
                NW, min(NW, U1 - ug), Kp);
      __syncthreads();

      // Warp w: the dlogits of u = ug + w for this chunk, into dlS[w].
      const int u = ug + warp;
      if (u < U1) {
        float acc[4][4];
        chunk_logits(acc, fpS, gpS + warp * rs, w2vS, Kp, rs, act, clip2, g,
                     q);
        float lse[2];
        if (nch == 1) {
          RowState st[2];
          init_state(st);
          online_update(st, acc, b2S, 0, blank, -1, q);
          lse[0] = st[0].m + logf(st[0].s);
          lse[1] = st[1].m + logf(st[1].s);
        } else {
          lse[0] = lseS[g * U1 + u];
          lse[1] = lseS[(g + 8) * U1 + u];
        }
        const int lab_u = lab[b * U1 + u];
        float gbv[2], gev[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int t = t0 + g + 8 * h;
          const size_t at = (static_cast<size_t>(b) * T + t) * U1 + u;
          gbv[h] = t < T ? gb[at] : 0.f;
          gev[h] = t < T ? ge[at] : 0.f;
        }
        uint32_t* dlw = reinterpret_cast<uint32_t*>(dlS + warp * kRows * kVRow);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            bf16 d[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int v = c * kVC + nt * 8 + 2 * q + j;
              const float p = expf(acc[nt][h * 2 + j] + b2S[v] - lse[h]);
              const float dl = (v == blank ? gbv[h] : 0.f)
                               + (v == lab_u ? gev[h] : 0.f)
                               - (gbv[h] + gev[h]) * p;
              d[j] = __float2bfloat16_rn(dl);
              dbacc[nt][j] += __bfloat162float(d[j]);
            }
            dlw[((g + 8 * h) * kVRow + nt * 8) / 2 + q] = pack(d[0], d[1]);
          }
        }
      }
      __syncthreads();

      // Warp w: columns k0 .. k0+63 of K, for every u of the group.
      const int nu = min(NW, U1 - ug);
      for (int i = 0; i < nu; ++i) {
        const int ui = ug + i;
        const bf16* dl = dlS + i * kRows * kVRow;
        const uint32_t* dlw = reinterpret_cast<const uint32_t*>(dl);
        const bf16* gpi = gpS + i * rs;
        const uint32_t* gpw = reinterpret_cast<const uint32_t*>(gpi);
        const uint32_t* f0 = reinterpret_cast<const uint32_t*>(fpS + g * rs);
        const uint32_t* f1 =
            reinterpret_cast<const uint32_t*>(fpS + (g + 8) * rs);

        // dh = dlogits @ W2^T over this chunk's 32 v, masked.
        uint32_t a[2][4];
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int w = ks * 8 + q;
          a[ks][0] = dlw[g * (kVRow / 2) + w];
          a[ks][1] = dlw[(g + 8) * (kVRow / 2) + w];
          a[ks][2] = dlw[g * (kVRow / 2) + w + 4];
          a[ks][3] = dlw[(g + 8) * (kVRow / 2) + w + 4];
        }
        float* dgp_row = dgp_part + ((blk * U1) + ui) * Kp;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int kk = k0 + nt * 8;
          float d[4] = {0.f, 0.f, 0.f, 0.f};
          const uint32_t* wr =
              reinterpret_cast<const uint32_t*>(w2kS + (kk + g) * kVRow);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks)
            mma_bf16(d, a[ks], wr[ks * 8 + q], wr[ks * 8 + q + 4]);
          const int kw = kk / 2 + q;  // word of columns kk + 2q, +1
          const float2 hA =
              __bfloat1622float2(hidden2(f0[kw], gpw[kw], act, clip2));
          const float2 hB =
              __bfloat1622float2(hidden2(f1[kw], gpw[kw], act, clip2));
          d[0] *= act_grad(hA.x, act, clip);
          d[1] *= act_grad(hA.y, act, clip);
          d[2] *= act_grad(hB.x, act, clip);
          d[3] *= act_grad(hB.y, act, clip);
#pragma unroll
          for (int r = 0; r < 4; ++r) dfacc[nt][r] += d[r];
          float s0 = d[0] + d[2], s1 = d[1] + d[3];
#pragma unroll
          for (int off = 4; off < 32; off *= 2) {
            s0 += __shfl_xor_sync(0xffffffffu, s0, off);
            s1 += __shfl_xor_sync(0xffffffffu, s1, off);
          }
          if (g == 0) {
            float2* dst = reinterpret_cast<float2*>(dgp_row + kk + 2 * q);
            if (c == 0) {
              *dst = make_float2(s0, s1);
            } else {
              const float2 old = *dst;
              *dst = make_float2(old.x + s0, old.y + s1);
            }
          }
        }

        // dW2[k, v] += sum_t h[t, k] dlogits[t, v]: A = h^T (rows k, cols
        // t), B = dlogits (rows t, cols v).
        uint32_t bfr[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int v = nt * 8 + g;
          bfr[nt][0] = pack(dl[(2 * q) * kVRow + v], dl[(2 * q + 1) * kVRow + v]);
          bfr[nt][1] = pack(dl[(2 * q + 8) * kVRow + v],
                            dl[(2 * q + 9) * kVRow + v]);
        }
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int ka = k0 + mt * 16 + g, kb = ka + 8;
          const bf16 ga = gpi[ka], gbk = gpi[kb];
          const bf16* r0 = fpS + (2 * q) * rs;
          const bf16* r1 = r0 + rs;
          const bf16* r8 = r0 + 8 * rs;
          const bf16* r9 = r0 + 9 * rs;
          uint32_t ha[4];
          ha[0] = pack(hidden1(r0[ka], ga, act, clipb),
                       hidden1(r1[ka], ga, act, clipb));
          ha[1] = pack(hidden1(r0[kb], gbk, act, clipb),
                       hidden1(r1[kb], gbk, act, clipb));
          ha[2] = pack(hidden1(r8[ka], ga, act, clipb),
                       hidden1(r9[ka], ga, act, clipb));
          ha[3] = pack(hidden1(r8[kb], gbk, act, clipb),
                       hidden1(r9[kb], gbk, act, clipb));
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(dwacc[mt][nt], ha, bfr[nt][0], bfr[nt][1]);
        }
      }
    }

    // This chunk's dW2 and db2 partials of the block.
    float* dwp = dw2_part + blk * Kp * Vp;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int k = k0 + mt * 16 + g;
        const int v = c * kVC + nt * 8 + 2 * q;
        *reinterpret_cast<float2*>(dwp + static_cast<size_t>(k) * Vp + v) =
            make_float2(dwacc[mt][nt][0], dwacc[mt][nt][1]);
        *reinterpret_cast<float2*>(dwp + static_cast<size_t>(k + 8) * Vp + v) =
            make_float2(dwacc[mt][nt][2], dwacc[mt][nt][3]);
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float s = dbacc[nt][j];
#pragma unroll
        for (int off = 4; off < 32; off *= 2)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        if (g == 0) dbS[warp * kVC + nt * 8 + 2 * q + j] = s;
      }
    __syncthreads();
    if (threadIdx.x < kVC) {
      float s = 0.f;
      for (int w = 0; w < NW; ++w) s += dbS[w * kVC + threadIdx.x];
      db2_part[blk * Vp + c * kVC + threadIdx.x] = s;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + g + 8 * h;
    if (t < T) {
      float* row = dfp + (static_cast<size_t>(b) * T + t) * Kp + k0 + 2 * q;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
        *reinterpret_cast<float2*>(row + nt * 8) =
            make_float2(dfacc[nt][2 * h], dfacc[nt][2 * h + 1]);
    }
  }
}

size_t fwd_smem(int Kp, int NW, int Vp) {
  return static_cast<size_t>(kRows + kVC + NW) * (Kp + 8) * sizeof(bf16) +
         (2 * kRows * NW + Vp) * sizeof(float);
}

size_t bwd_smem(int Kp, int NW, int Vp, int U1) {
  const int nch = Vp / kVC;
  return static_cast<size_t>(kRows + kVC + NW) * (Kp + 8) * sizeof(bf16) +
         static_cast<size_t>(Kp + NW * kRows) * kVRow * sizeof(bf16) +
         (Vp + NW * kVC + (nch > 1 ? kRows * U1 : 0)) * sizeof(float);
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

// K6 on `stream`, as K5.
extern "C" int joint_tail_bwd(const void* fp, const void* gp, const void* w2v,
                              const void* w2k, const void* b2, const void* lab,
                              const void* gb, const void* ge, void* dfp,
                              void* dgp_part, void* dw2_part, void* db2_part,
                              int B, int T, int U1, int Kp, int V, int Vp,
                              int blank, int act, float clip, void* stream) {
  const int NW = Kp / kKSlice;
  const size_t smem = bwd_smem(Kp, NW, Vp, U1);
  cudaError_t err = cudaFuncSetAttribute(
      joint_tail_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T + kRows - 1) / kRows, B);
  joint_tail_bwd_kernel<<<grid, NW * 32, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(fp), static_cast<const bf16*>(gp),
      static_cast<const bf16*>(w2v), static_cast<const bf16*>(w2k),
      static_cast<const float*>(b2), static_cast<const int*>(lab),
      static_cast<const float*>(gb), static_cast<const float*>(ge),
      static_cast<float*>(dfp), static_cast<float*>(dgp_part),
      static_cast<float*>(dw2_part), static_cast<float*>(db2_part), T, U1, Kp,
      V, Vp, blank, act, clip);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* joint_tail_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
