// K6: the transducer joint tail's backward, written by hand for Hopper
// (sm_90a).
//
// K6 replaces myrtlespeech_tpu/ops/pallas/joint_kernel.py::_bwd_kernel
// (pallas_call in _jt_bwd).  With fp (B, T, K) and gp (B, U+1, K) the joint's
// two first-layer projections (bias folded into gp), and gb, ge (B, T, U+1)
// the cotangents of K5's two outputs, each lattice cell (b, t, u) needs
//
//   h       = act(fp[b, t] + gp[b, u])         add and act in bf16
//   logits  = h @ W2 + b2                      bf16 products, fp32 sums
//   dlogits = gb onehot(blank) + ge onehot(lab[b, u]) - (gb + ge) softmax,
//             rounded to bf16
//   dh      = (dlogits @ W2^T) * act'(h)       (act' read off the bf16 h)
//
// and K6 writes dfp[t] = sum_u dh, dgp[u] = sum_t dh, dW2 = sum h^T dlogits
// and db2 = sum of the rounded dlogits.  Neither h nor the logits ever reach
// device memory.
//
// What bounds it on the card: three tensor-core products per cell (the
// recomputed logits, dh, dW2), 6 * cells * K * V operations.  At the 16.7 s
// batch of rnn_t_en (B=128, T'=836, U+1=215, K=512, V=29: 23.0 M cells) that
// is 2.05 TFLOP, 2.07 ms at 989 TFLOP/s, against some 0.18 ms of bytes.
//
// What the design does about it.  A block owns one batch row b and a range
// of its frames (a split; the wrapper chooses the number of splits per row,
// ops/cuda/joint_kernel.py::k6_plan).  It walks that range in t-tiles of 32
// frames (two m16 row tiles) and, for each t-tile, every u.  8 warps (K is
// zero-padded to 512); warp w owns columns 64w .. 64w+63 of K in all three
// products, so every operand a warp needs of h is its own.  Every product is
// mma.sync m16n8k16 fed by ldmatrix:
//   - h of the t-tile and u is built once, in registers, straight into
//     mma A fragments: fp's fragments by ldmatrix from the t-tile's fp rows
//     in shared memory, plus the u's gp pair, then act, as bf16 pairs.  The
//     same registers are the logits' A operand, the mask of dh (an A
//     fragment of h holds the elements of dh's C fragment) and, after
//     movmatrix.trans, dW2's A operand h^T.  (An h tile in shared memory,
//     written by stmatrix and read back by ldmatrix, adds 64 KB of shared
//     traffic a unit and measured slower on the card: PERF.md, PR 7.)
//   - logits: each warp multiplies its 64 columns of h by W2's 64 rows (B
//     fragments by ldmatrix from W2 in shared memory, each feeding both row
//     tiles) and leaves a partial sum; after a barrier every thread sums the
//     partials of 4 logits of one frame in a fixed order, takes the softmax
//     across the 8 threads of the frame and writes the bf16 dlogits tile.
//   - dh = dlogits @ W2^T: dlogits by ldmatrix, W2^T by ldmatrix.trans of
//     the same W2 tile; masked, added into dfp's registers (summed over all
//     u, written once per t-tile) and summed over the frames (shuffles
//     that leave each lane two columns) into the split's own dgp slab, a
//     (B, n_split, U+1, 512) fp32 scratch that only this block touches.
//   - dW2 += h^T @ dlogits: dlogits by ldmatrix.trans; summed in registers
//     over the block's whole range and written once per block, as is db2.
//   - gb and ge are staged per t-tile and group of 32 u, read along u (the
//     contiguous axis), into shared memory, with the group's gp rows; each
//     lane's old dgp pair arrives by cp.async while the unit runs.
// The wrapper sums the n_split slabs and the per-block dW2 and db2 in a fixed
// order: no atomics, and two calls give the same bits.  For V > 32 the
// vocabulary runs in chunks of 32 columns: per group of u a first pass
// keeps each cell's running max and sum over the chunks (shared memory),
// then each chunk's dW2 and db2 are added to the block's slot in device
// memory, so h is rebuilt once per chunk and pass there.
// The TPU kernel's 8-row slabs, U+1 padded to 8, V padded to 128 lanes and
// dgp and dW2 carried along a sequential T grid axis are not carried over.
//
// Contract (checked by ops/cuda/joint_kernel.py): fp, gp bf16 with K
// zero-padded to 512; W2 bf16 zero-padded to (512, Vp), Vp a multiple of 32,
// given as (Vp, 512); b2 fp32 (V,); lab int32 (B, U+1) with labels in
// [0, V); U+1 at most 1024; n_split at most ceil(T / 32).

#include "joint_tail.cuh"

namespace {

constexpr int kKp = 512;          // K, zero-padded: 8 warps of 64 columns
constexpr int kNW = kKp / 64;     // warps a block
constexpr int kRS = kKp + 8;      // bf16 stride of a K-wide shared row
constexpr int kTT = 32;           // frames of a t-tile
constexpr int kMT = kTT / 16;     // its m16 row tiles
constexpr int kKW = 64;           // columns of K a warp owns
constexpr int kKS = kKW / 16;     // their k16 steps
constexpr int kUG = 32;           // u staged at once
constexpr int kThreads = kNW * 32;
constexpr int kPRow = kVC + 8;    // fp32 stride of a partial-logits row
constexpr int kDRow = kVC + 8;    // bf16 stride of a dlogits row (80 bytes)
constexpr int kGRow = kUG + 1;    // fp32 stride of a staged (frame, u) row

// Byte offsets of the block's shared memory.  bf16 rows of 520 (a stride
// of 16 bytes mod 128) and dlogits rows of 80 bytes put the 8 rows of an
// ldmatrix on distinct banks; partial-logits rows of 40 floats do the same
// for the float2 stores.
struct Layout {
  int fp, w2, gp, dl, part, gb, ge, st_m, st_s, lab, db, dbt, dgo, b2, total;
};

__host__ __device__ inline Layout layout(int Vp) {
  constexpr int rs2 = kRS * 2;
  Layout s;
  int o = 0;
  s.fp = o;   o += kTT * rs2;                 // (32 frames, 512) of fp
  s.w2 = o;   o += kVC * rs2;                 // (32 v, 512) of W2, a chunk
  s.gp = o;   o += kUG * rs2;                 // (32 u, 512) of gp
  s.dl = o;   o += kTT * kDRow * 2;           // (32 frames, 32 v) dlogits
  s.part = o; o += kNW * kTT * kPRow * 4;     // each warp's partial logits
  s.gb = o;   o += kTT * kGRow * 4;           // (32 frames, 32 u) of gb
  s.ge = o;   o += kTT * kGRow * 4;           // and of ge
  s.st_m = o; o += kTT * kGRow * 4;           // V > 32: running max
  s.st_s = o; o += kTT * kGRow * 4;           // and sum of exponentials
  s.lab = o;  o += kUG * 4;                   // the group's labels
  s.db = o;   o += kNW * kVC * 4;             // db2 of each warp
  s.dbt = o;  o += kThreads * 16;             // db2 of each thread (4 v)
  s.dgo = o;  o += kThreads * 8;              // each lane's dgp pair, early
  s.b2 = o;   o += Vp * 4;                    // b2, -inf past V
  s.total = o;
  return s;
}

// A profiling build (-DK6_PHASE_CLOCKS, port_tools/kernel_probe.py --kernel
// k6 --phases) sums thread 0's clocks in each phase of a unit over all
// blocks: build h and the partial logits, wait at the first barrier,
// dlogits, wait at the second, dW2, dh and dgp; and the whole kernel.
#ifdef K6_PHASE_CLOCKS
__device__ unsigned long long k6_phase_clocks[8];
#define K6_TICK(i)                   \
  {                                  \
    const long long now = clock64(); \
    k6_ph[i] += now - k6_last;       \
    k6_last = now;                   \
  }
#else
#define K6_TICK(i)
#endif

// 8 bytes from device to shared memory without holding registers; visible
// to this thread after cp_wait().
__device__ __forceinline__ void cp8(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :
               : "r"(dst), "l"(src));
}

__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// This thread's pair of the transpose of the warp's 8x8 bf16 matrix.
__device__ __forceinline__ uint32_t movt(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(y)
               : "r"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  bf162 v;
  v.x = lo;
  v.y = hi;
  return as_u32(v);
}

__device__ __forceinline__ float lo_f(uint32_t pair) {
  return __uint_as_float(pair << 16);
}

__device__ __forceinline__ float hi_f(uint32_t pair) {
  return __uint_as_float(pair & 0xffff0000u);
}

// act'(a) for a pair of h = act(a), as fp32 ones and zeros, compared in
// fp32 (_act_grad_mask_from_h; hardtanh with the fp32 clip).  For the
// identity, comparing h with itself gives 1 as well (0 only for a NaN h,
// whose dh is NaN either way) and keeps h live into dh as for the other
// activations, which spares its instantiation the spills of its schedule
// without it.  (A bf16x2 compare for ReLU's mask measured slower on the
// card, with spills: PERF.md, PR 7.)
template <int ACT>
__device__ __forceinline__ void masks(uint32_t pair, float clip, float& lo,
                                      float& hi) {
  if (ACT == kRelu) {
    lo = lo_f(pair) > 0.f ? 1.f : 0.f;
    hi = hi_f(pair) > 0.f ? 1.f : 0.f;
  } else if (ACT == kHardtanh) {
    const float l = lo_f(pair), h = hi_f(pair);
    lo = l > 0.f && l < clip ? 1.f : 0.f;
    hi = h > 0.f && h < clip ? 1.f : 0.f;
  } else {
    lo = lo_f(pair) == lo_f(pair) ? 1.f : 0.f;
    hi = hi_f(pair) == hi_f(pair) ? 1.f : 0.f;
  }
}

// As load_rows, with four 16-byte loads of each thread in flight at once.
__device__ void load_rows4(bf16* dst, int dst_stride, const bf16* src,
                           int src_stride, int rows, int valid, int cols) {
  const int per_row = cols / 8, n = rows * per_row;
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    uint4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, r = i / per_row;
      v[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n && r < valid)
        v[k] = *reinterpret_cast<const uint4*>(
            src + static_cast<size_t>(r) * src_stride + (i - r * per_row) * 8);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, r = i / per_row;
      if (i < n)
        *reinterpret_cast<uint4*>(dst + r * dst_stride +
                                  (i - r * per_row) * 8) = v[k];
    }
  }
}

// h = act(fp + gp[u]) of the t-tile's 32 frames and the warp's 64 columns:
// h[mt][ks] is the A fragment of rows 16 mt.., columns k0 + 16 ks...  `fpa`
// is this lane's ldmatrix address in the fp tile, `gw` the u's gp row
// (words, from column k0 + 2q).
template <int ACT>
__device__ __forceinline__ void build_h(uint32_t (&h)[kMT][kKS][4],
                                        uint32_t fpa, const uint32_t* gw,
                                        bf162 clip2) {
#pragma unroll
  for (int ks = 0; ks < kKS; ++ks) {
    const uint32_t glo = gw[ks * 8], ghi = gw[ks * 8 + 4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
      uint32_t f[4];
      ldsm4(f, fpa + (mt * 16 * kRS + ks * 16) * 2);
      h[mt][ks][0] = as_u32(hidden2(f[0], glo, ACT, clip2));
      h[mt][ks][1] = as_u32(hidden2(f[1], glo, ACT, clip2));
      h[mt][ks][2] = as_u32(hidden2(f[2], ghi, ACT, clip2));
      h[mt][ks][3] = as_u32(hidden2(f[3], ghi, ACT, clip2));
    }
  }
}

// The warp's share of the chunk's logits, h (its 64 columns) @ W2 (those 64
// rows), for all 32 frames x 32 columns, into its slice `pw` of the partial
// sums.  Two halves of 16 columns; each W2 fragment feeds both row tiles.
__device__ __forceinline__ void partial_logits(
    const uint32_t (&h)[kMT][kKS][4], uint32_t w2a, float* pw, int g,
    int q) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float acc[kMT][2][4];
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t w[4];  // B fragments of n-tiles 2 half, 2 half + 1
      ldsm4(w, w2a + (half * 16 * kRS + ks * 16) * 2);
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          mma_bf16(acc[mt][n], h[mt][ks], w[2 * n], w[2 * n + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        float* p = pw + (mt * 16 + g) * kPRow + (half * 2 + n) * 8 + 2 * q;
        *reinterpret_cast<float2*>(p) = make_float2(acc[mt][n][0],
                                                    acc[mt][n][1]);
        *reinterpret_cast<float2*>(p + 8 * kPRow) =
            make_float2(acc[mt][n][2], acc[mt][n][3]);
      }
  }
}

// Logits (+ b2) of frame r, chunk columns 4j .. 4j+3, summed over the
// warps' partials in order.
__device__ __forceinline__ void row_logits(float (&x)[4], const float* partS,
                                           const float* b2S, int r, int j,
                                           int c) {
  const float4 bb = *reinterpret_cast<const float4*>(b2S + c * kVC + 4 * j);
  x[0] = bb.x;
  x[1] = bb.y;
  x[2] = bb.z;
  x[3] = bb.w;
#pragma unroll
  for (int w0 = 0; w0 < kNW; w0 += 4) {
    float4 p[4];  // four warps' partials in flight at once
#pragma unroll
    for (int w = 0; w < 4; ++w)
      p[w] = *reinterpret_cast<const float4*>(
          partS + ((w0 + w) * kTT + r) * kPRow + 4 * j);
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      x[0] += p[w].x;
      x[1] += p[w].y;
      x[2] += p[w].z;
      x[3] += p[w].w;
    }
  }
}

// Max and sum of exponentials over the 32 columns of a frame: its 8
// threads are neighbouring lanes.
__device__ __forceinline__ void row_max_sum(const float (&x)[4], float& m,
                                            float& s) {
  m = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  s = __expf(x[0] - m) + __expf(x[1] - m) + __expf(x[2] - m) +
      __expf(x[3] - m);
#pragma unroll
  for (int off = 1; off < 8; off *= 2)
    s += __shfl_xor_sync(0xffffffffu, s, off);
}

// dW2 (the warp's 64 rows, one chunk) from or to the block's slot (512, Vp).
__device__ __forceinline__ void dw_io(float (&dw)[4][4][4], float* slot,
                                      int Vp, int k0, int c, int g, int q,
                                      bool load) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int k = k0 + mt * 16 + g, v = c * kVC + nt * 8 + 2 * q;
      float2* p0 = reinterpret_cast<float2*>(slot + static_cast<size_t>(k) *
                                                        Vp + v);
      float2* p1 = p0 + 4 * Vp;  // row k + 8
      if (load) {
        const float2 a = *p0, b = *p1;
        dw[mt][nt][0] = a.x;
        dw[mt][nt][1] = a.y;
        dw[mt][nt][2] = b.x;
        dw[mt][nt][3] = b.y;
      } else {
        *p0 = make_float2(dw[mt][nt][0], dw[mt][nt][1]);
        *p1 = make_float2(dw[mt][nt][2], dw[mt][nt][3]);
        dw[mt][nt][0] = dw[mt][nt][1] = dw[mt][nt][2] = dw[mt][nt][3] = 0.f;
      }
    }
}

// Adds the block's db2 of chunk c (each thread's sums of columns 4 (tid &
// 7) .. +3 in dbt, zeroed here) into its slot, in a fixed order: lanes, then
// warps.
__device__ void db_flush(float4* dbt, float* dbS, float* slot, int c,
                         bool first) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float4 mine = dbt[threadIdx.x];
  dbt[threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
  const float db[4] = {mine.x, mine.y, mine.z, mine.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float s = db[e];
    s += __shfl_xor_sync(0xffffffffu, s, 8);
    s += __shfl_xor_sync(0xffffffffu, s, 16);
    if (lane < 8) dbS[warp * kVC + 4 * lane + e] = s;
  }
  __syncthreads();
  if (threadIdx.x < kVC) {
    float s = 0.f;
    for (int w = 0; w < kNW; ++w) s += dbS[w * kVC + threadIdx.x];
    float* p = slot + c * kVC + threadIdx.x;
    *p = first ? s : *p + s;
  }
  __syncthreads();
}

// One step of the reduce-scatter of dgp's column sums over the 8 g of a
// warp: lanes whose g has bit `bit` keep the upper half of v (2n values),
// the others the lower half, each adding its partner's.
template <int N>
__device__ __forceinline__ void halve(float (&v)[2 * N], int g, int bit) {
  const bool up = (g >> bit) & 1;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? v[i] : v[i + N];
    const float keep = up ? v[i + N] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4 << bit);
  }
}

// Grid (n_split, B); block 8 warps.  Writes dfp (B, T, 512), the split's
// dgp slab dgp_s (B, n_split, U1, 512) and the block's dW2 and db2, dw2_s
// (B * n_split, 512, Vp) and db2_s (B * n_split, Vp).
template <int ACT, bool CHUNKS>
__global__ void __launch_bounds__(kThreads, 1)
joint_tail_bwd_kernel(const bf16* __restrict__ fp,   // (B, T, 512)
                      const bf16* __restrict__ gp,   // (B, U1, 512)
                      const bf16* __restrict__ w2v,  // (Vp, 512)
                      const float* __restrict__ b2,  // (V,)
                      const int* __restrict__ lab,   // (B, U1)
                      const float* __restrict__ gb,  // (B, T, U1)
                      const float* __restrict__ ge,  // (B, T, U1)
                      float* __restrict__ dfp, float* __restrict__ dgp_s,
                      float* __restrict__ dw2_s, float* __restrict__ db2_s,
                      int T, int U1, int V, int Vp, int blank, float clip) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(Vp);
  constexpr int Kp = kKp, rs = kRS;
  bf16* fpS = reinterpret_cast<bf16*>(smem + L.fp);
  bf16* w2S = reinterpret_cast<bf16*>(smem + L.w2);
  bf16* gpS = reinterpret_cast<bf16*>(smem + L.gp);
  bf16* dlS = reinterpret_cast<bf16*>(smem + L.dl);
  float* partS = reinterpret_cast<float*>(smem + L.part);
  float* gbS = reinterpret_cast<float*>(smem + L.gb);
  float* geS = reinterpret_cast<float*>(smem + L.ge);
  float* stM = reinterpret_cast<float*>(smem + L.st_m);
  float* stS = reinterpret_cast<float*>(smem + L.st_s);
  int* labS = reinterpret_cast<int*>(smem + L.lab);
  float* dbS = reinterpret_cast<float*>(smem + L.db);
  float4* dbt = reinterpret_cast<float4*>(smem + L.dbt);
  float2* dgo = reinterpret_cast<float2*>(smem + L.dgo) + threadIdx.x;
  float* b2S = reinterpret_cast<float*>(smem + L.b2);

  const int split = blockIdx.x, n_split = gridDim.x, b = blockIdx.y;
  const size_t blk = static_cast<size_t>(b) * n_split + split;
  const int n_tiles = (T + kTT - 1) / kTT;
  const int tile_lo = split * n_tiles / n_split;
  const int tile_hi = (split + 1) * n_tiles / n_split;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, q = lane & 3;
  const int k0 = warp * kKW;
  const int nch = CHUNKS ? Vp / kVC : 1;
  const bf162 clip2 = __float2bfloat162_rn(clip);

  // This lane's ldmatrix addresses: A fragments of fp and dlogits (row
  // lane & 15, column (lane >> 4) * 8 of a 16x16 block; the same address
  // with .trans gives dlogits as dW2's B fragments); W2's B fragments for
  // the logits (two n-tiles a load); W2^T's for dh (.trans, rows v = lane).
  const uint32_t fpa = saddr(fpS + (lane & 15) * rs + k0 + (lane >> 4) * 8);
  const uint32_t dla = saddr(dlS + (lane & 15) * kDRow + (lane >> 4) * 8);
  const uint32_t w2a = saddr(w2S + ((lane & 7) + ((lane >> 4) << 3)) * rs +
                             k0 + ((lane >> 3) & 1) * 8);
  const uint32_t w2t = saddr(w2S + lane * rs + k0);

#ifdef K6_PHASE_CLOCKS
  long long k6_ph[7] = {0, 0, 0, 0, 0, 0, 0};
  const long long k6_start = clock64();
  long long k6_last = k6_start;
#endif
  load_bias(b2S, b2, V, Vp);
  if (!CHUNKS) load_rows(w2S, rs, w2v, Kp, kVC, kVC, Kp);

  float dfacc[kMT][8][4];  // dfp of the t-tile, the warp's 64 columns
  float dwacc[4][4][4];    // dW2 of the warp's 64 rows, one chunk
  dbt[threadIdx.x] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) dwacc[i][j][e] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) dfacc[mt][nt][e] = 0.f;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int t0 = tile * kTT;
    __syncthreads();  // the last t-tile's fp rows are consumed
    load_rows4(fpS, rs, fp + (static_cast<size_t>(b) * T + t0) * Kp, Kp, kTT,
               min(kTT, T - t0), Kp);
    for (int ug = 0; ug < U1; ug += kUG) {
      const int nu = min(kUG, U1 - ug);
      __syncthreads();  // the last group's gp rows, gb, ge are consumed
      load_rows4(gpS, rs, gp + (static_cast<size_t>(b) * U1 + ug) * Kp, Kp,
                 nu, nu, Kp);
      for (int e0 = threadIdx.x; e0 < kTT * kUG; e0 += 4 * kThreads) {
        float vb[4], ve[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads, r = e / kUG, j = e - r * kUG;
          const int t = t0 + r;
          vb[k] = ve[k] = 0.f;
          if (e < kTT * kUG && t < T && j < nu) {
            const size_t at = (static_cast<size_t>(b) * T + t) * U1 + ug + j;
            vb[k] = gb[at];
            ve[k] = ge[at];
          }
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kThreads, r = e / kUG, j = e - r * kUG;
          if (e < kTT * kUG) {
            gbS[r * kGRow + j] = vb[k];
            geS[r * kGRow + j] = ve[k];
          }
        }
      }
      for (int e = threadIdx.x; e < kUG; e += kThreads)
        labS[e] = e < nu ? lab[b * U1 + ug + e] : 0;
      __syncthreads();
      const bool first_visit = tile == tile_lo && ug == 0;

      if (CHUNKS) {
        // Each cell's running max and sum of exponentials over the chunks.
        for (int c = 0; c < nch; ++c) {
          __syncthreads();
          load_rows(w2S, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp,
                    kVC, kVC, Kp);
          __syncthreads();
          for (int i = 0; i < nu; ++i) {
            uint32_t h[kMT][kKS][4];
            build_h<ACT>(h, fpa,
                         reinterpret_cast<const uint32_t*>(gpS + i * rs + k0)
                             + q, clip2);
            partial_logits(h, w2a, partS + warp * kTT * kPRow, g, q);
            __syncthreads();
            {
              const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
              float x[4], m, s;
              row_logits(x, partS, b2S, r, j, c);
              row_max_sum(x, m, s);
              if (j == 0) {
                float* pm = stM + r * kGRow + i;
                float* ps = stS + r * kGRow + i;
                if (c == 0) {
                  *pm = m;
                  *ps = s;
                } else {
                  const float mm = fmaxf(*pm, m);
                  *ps = *ps * __expf(*pm - mm) + s * __expf(m - mm);
                  *pm = mm;
                }
              }
            }
            __syncthreads();
          }
        }
      }

      for (int c = 0; c < nch; ++c) {
        if (CHUNKS) {
          __syncthreads();
          load_rows(w2S, rs, w2v + static_cast<size_t>(c) * kVC * Kp, Kp,
                    kVC, kVC, Kp);
          if (!first_visit)
            dw_io(dwacc, dw2_s + blk * Kp * Vp, Vp, k0, c, g, q, true);
          __syncthreads();
        }
        const bool dgp_first = tile == tile_lo && c == 0;
        for (int i = 0; i < nu; ++i) {
          const int u = ug + i;
          float2* dgp_at = reinterpret_cast<float2*>(
              dgp_s + (blk * U1 + u) * Kp + k0 + 2 * lane);
          if (!dgp_first) cp8(saddr(dgo), dgp_at);
#ifdef K6_PHASE_CLOCKS
          k6_last = clock64();
#endif

          uint32_t h[kMT][kKS][4];
          build_h<ACT>(h, fpa,
                       reinterpret_cast<const uint32_t*>(gpS + i * rs + k0) +
                           q,
                       clip2);
          partial_logits(h, w2a, partS + warp * kTT * kPRow, g, q);
          K6_TICK(0);
          __syncthreads();
          K6_TICK(1);

          // dlogits of frame r, columns 4j .. 4j+3 of the chunk.
          {
            const int r = threadIdx.x >> 3, j = threadIdx.x & 7;
            float x[4], lse;
            row_logits(x, partS, b2S, r, j, c);
            if (!CHUNKS) {
              float m, s;
              row_max_sum(x, m, s);
              lse = m + __logf(s);
            } else {
              lse = stM[r * kGRow + i] + __logf(stS[r * kGRow + i]);
            }
            const float gv = gbS[r * kGRow + i], ev = geS[r * kGRow + i];
            const int lb = labS[i];
            bf16 d[4];
            float dr[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int v = c * kVC + 4 * j + e;
              const float p = __expf(x[e] - lse);
              const float dl = (v == blank ? gv : 0.f) + (v == lb ? ev : 0.f)
                               - (gv + ev) * p;
              d[e] = __float2bfloat16_rn(dl);
              dr[e] = __bfloat162float(d[e]);
            }
            *reinterpret_cast<uint2*>(dlS + r * kDRow + 4 * j) =
                make_uint2(pack(d[0], d[1]), pack(d[2], d[3]));
            float4 acc = dbt[threadIdx.x];
            acc.x += dr[0];
            acc.y += dr[1];
            acc.z += dr[2];
            acc.w += dr[3];
            dbt[threadIdx.x] = acc;
          }
          K6_TICK(2);
          __syncthreads();
          K6_TICK(3);

          // dW2 += h^T @ dlogits over the 32 frames: A = h^T by movmatrix,
          // B = dlogits by ldmatrix.trans, each feeding 4 row tiles of K.
          {
            uint32_t db[kMT][4][2];
#pragma unroll
            for (int kk = 0; kk < kMT; ++kk)
#pragma unroll
              for (int np = 0; np < 2; ++np) {
                uint32_t r4[4];
                ldsm4t(r4, dla + (kk * 16 * kDRow + np * 16) * 2);
                db[kk][2 * np][0] = r4[0];
                db[kk][2 * np][1] = r4[1];
                db[kk][2 * np + 1][0] = r4[2];
                db[kk][2 * np + 1][1] = r4[3];
              }
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
#pragma unroll
              for (int kk = 0; kk < kMT; ++kk) {
                const uint32_t a[4] = {movt(h[kk][mt][0]), movt(h[kk][mt][2]),
                                       movt(h[kk][mt][1]), movt(h[kk][mt][3])};
#pragma unroll
                for (int nt = 0; nt < 4; ++nt)
                  mma_bf16(dwacc[mt][nt], a, db[kk][nt][0], db[kk][nt][1]);
              }
          }
          K6_TICK(4);

          // dh = dlogits @ W2^T over the chunk's 32 columns, masked: into
          // dfp's registers and, summed over the frames, into dgp.  n-tiles
          // nt and nt + 4 together, so that the first step of the
          // reduce-scatter over g follows at once.
          {
            uint32_t da[kMT][2][4];
#pragma unroll
            for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
              for (int ks = 0; ks < 2; ++ks)
                ldsm4(da[mt][ks], dla + (mt * 16 * kDRow + ks * 16) * 2);
            float cs[8];
#pragma unroll
            for (int p = 0; p < 4; ++p) {
              float pair[4];
#pragma unroll
              for (int side = 0; side < 2; ++side) {
                const int nt = p + 4 * side, ks = nt >> 1, hh = (nt & 1) * 2;
                uint32_t bw[4];
                ldsm4t(bw, w2t + nt * 16);
                float s0 = 0.f, s1 = 0.f;
#pragma unroll
                for (int mt = 0; mt < kMT; ++mt) {
                  float d[4] = {0.f, 0.f, 0.f, 0.f};
                  mma_bf16(d, da[mt][0], bw[0], bw[1]);
                  mma_bf16(d, da[mt][1], bw[2], bw[3]);
                  const uint32_t h0 = h[mt][ks][hh], h8 = h[mt][ks][hh + 1];
                  float m[4];
                  masks<ACT>(h0, clip, m[0], m[1]);
                  masks<ACT>(h8, clip, m[2], m[3]);
#pragma unroll
                  for (int e = 0; e < 4; ++e)
                    dfacc[mt][nt][e] = fmaf(d[e], m[e], dfacc[mt][nt][e]);
                  s0 = fmaf(d[2], m[2], fmaf(d[0], m[0], s0));
                  s1 = fmaf(d[3], m[3], fmaf(d[1], m[1], s1));
                }
                pair[2 * side] = s0;
                pair[2 * side + 1] = s1;
              }
              // Columns of n-tile p (lanes with g < 4) or p + 4 (g >= 4).
              halve<2>(pair, g, 2);
              cs[2 * p] = pair[0];
              cs[2 * p + 1] = pair[1];
            }
            halve<4>(cs, g, 1);
            float c4[4] = {cs[0], cs[1], cs[2], cs[3]};
            halve<2>(c4, g, 0);
            // Lane 4g + q holds the sums of columns k0 + 8g + 2q, +1.
            float2 old = make_float2(0.f, 0.f);
            if (!dgp_first) {
              cp_wait();
              old = *dgo;
            }
            *dgp_at = make_float2(old.x + c4[0], old.y + c4[1]);
          }
          K6_TICK(5);
        }
        if (CHUNKS) {
          dw_io(dwacc, dw2_s + blk * Kp * Vp, Vp, k0, c, g, q, false);
          db_flush(dbt, dbS, db2_s + blk * Vp, c, first_visit);
        }
      }
    }

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = t0 + mt * 16 + g + 8 * hh;
        float* row = dfp + (static_cast<size_t>(b) * T + t) * Kp + k0 + 2 * q;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          if (t < T)
            *reinterpret_cast<float2*>(row + nt * 8) =
                make_float2(dfacc[mt][nt][2 * hh], dfacc[mt][nt][2 * hh + 1]);
          dfacc[mt][nt][2 * hh] = dfacc[mt][nt][2 * hh + 1] = 0.f;
        }
      }
  }
  if (!CHUNKS) {
    dw_io(dwacc, dw2_s + blk * Kp * Vp, Vp, k0, 0, g, q, false);
    db_flush(dbt, dbS, db2_s + blk * Vp, 0, true);
  }
#ifdef K6_PHASE_CLOCKS
  k6_ph[6] = clock64() - k6_start;
  if (threadIdx.x == 0)
    for (int i = 0; i < 7; ++i)
      atomicAdd(&k6_phase_clocks[i],
                static_cast<unsigned long long>(k6_ph[i]));
#endif
}

template <int ACT, bool CHUNKS>
cudaError_t launch(const void* fp, const void* gp, const void* w2v,
                   const void* b2, const void* lab, const void* gb,
                   const void* ge, void* dfp, void* dgp_s, void* dw2_s,
                   void* db2_s, int B, int T, int U1, int V, int Vp,
                   int blank, float clip, int n_split, cudaStream_t stream) {
  const int smem = layout(Vp).total;
  cudaError_t err = cudaFuncSetAttribute(
      joint_tail_bwd_kernel<ACT, CHUNKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  joint_tail_bwd_kernel<ACT, CHUNKS>
      <<<dim3(n_split, B), kThreads, smem, stream>>>(
          static_cast<const bf16*>(fp), static_cast<const bf16*>(gp),
          static_cast<const bf16*>(w2v), static_cast<const float*>(b2),
          static_cast<const int*>(lab), static_cast<const float*>(gb),
          static_cast<const float*>(ge), static_cast<float*>(dfp),
          static_cast<float*>(dgp_s), static_cast<float*>(dw2_s),
          static_cast<float*>(db2_s), T, U1, V, Vp, blank, clip);
  return cudaGetLastError();
}

// V in one chunk (the main path) or in several.
template <int ACT>
cudaError_t launch_act(const void* fp, const void* gp, const void* w2v,
                       const void* b2, const void* lab, const void* gb,
                       const void* ge, void* dfp, void* dgp_s, void* dw2_s,
                       void* db2_s, int B, int T, int U1, int V, int Vp,
                       int blank, float clip, int n_split,
                       cudaStream_t stream) {
  if (Vp > kVC)
    return launch<ACT, true>(fp, gp, w2v, b2, lab, gb, ge, dfp, dgp_s, dw2_s,
                             db2_s, B, T, U1, V, Vp, blank, clip, n_split,
                             stream);
  return launch<ACT, false>(fp, gp, w2v, b2, lab, gb, ge, dfp, dgp_s, dw2_s,
                            db2_s, B, T, U1, V, Vp, blank, clip, n_split,
                            stream);
}

template <int ACT, bool CHUNKS>
cudaError_t attrs(int Vp, int* out) {
  cudaFuncAttributes a;
  cudaError_t err =
      cudaFuncGetAttributes(&a, joint_tail_bwd_kernel<ACT, CHUNKS>);
  if (err != cudaSuccess) return err;
  const int smem = layout(Vp).total;
  err = cudaFuncSetAttribute(joint_tail_bwd_kernel<ACT, CHUNKS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, joint_tail_bwd_kernel<ACT, CHUNKS>, kThreads, smem);
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
cudaError_t attrs_act(int Vp, int* out) {
  return Vp > kVC ? attrs<ACT, true>(Vp, out) : attrs<ACT, false>(Vp, out);
}

}  // namespace

// K6 on `stream`: one launch of grid (n_split, B).  Returns the CUDA error (0
// when the launch was accepted; cudaErrorInvalidValue for Kp other than
// 512); neither synchronises nor allocates.
extern "C" int joint_tail_bwd(const void* fp, const void* gp, const void* w2v,
                              const void* b2, const void* lab, const void* gb,
                              const void* ge, void* dfp, void* dgp_s,
                              void* dw2_s, void* db2_s, int B, int T, int U1,
                              int Kp, int V, int Vp, int blank, int act,
                              float clip, int n_split, void* stream) {
  if (Kp != kKp) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (act == kRelu)
    err = launch_act<kRelu>(fp, gp, w2v, b2, lab, gb, ge, dfp, dgp_s, dw2_s,
                            db2_s, B, T, U1, V, Vp, blank, clip, n_split, s);
  else if (act == kHardtanh)
    err = launch_act<kHardtanh>(fp, gp, w2v, b2, lab, gb, ge, dfp, dgp_s,
                                dw2_s, db2_s, B, T, U1, V, Vp, blank, clip,
                                n_split, s);
  else
    err = launch_act<kIdentity>(fp, gp, w2v, b2, lab, gb, ge, dfp, dgp_s,
                                dw2_s, db2_s, B, T, U1, V, Vp, blank, clip,
                                n_split, s);
  return static_cast<int>(err);
}

// The kernel's attributes for activation `act` at Vp: out[0..5] =
// registers a thread, local (spill) bytes a thread, static shared bytes,
// most threads a block, dynamic shared bytes a block, blocks resident on an
// SM.  Returns the CUDA error.
extern "C" int joint_tail_bwd_attrs(int act, int Vp, int* out) {
  cudaError_t err;
  if (act == kRelu) err = attrs_act<kRelu>(Vp, out);
  else if (act == kHardtanh) err = attrs_act<kHardtanh>(Vp, out);
  else err = attrs_act<kIdentity>(Vp, out);
  return static_cast<int>(err);
}

#ifdef K6_PHASE_CLOCKS
// The profiling build's phase clocks into out[0..6]; zeroes them after.
extern "C" int joint_tail_bwd_phase_clocks(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, k6_phase_clocks,
                                         7 * sizeof(unsigned long long));
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long zero[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(k6_phase_clocks, zero,
                                             sizeof(zero)));
}
#endif

extern "C" const char* joint_tail_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
