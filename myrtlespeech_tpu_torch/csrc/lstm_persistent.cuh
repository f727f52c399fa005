// Pieces shared by the persistent LSTM kernels (lstm_fwd_persistent.cu,
// lstm_bwd_persistent.cu): the grid barrier, the operand loads and the
// warp's share of the recurrent product.
//
// A block owns kUnits hidden units and all B rows (up to 16 * kMaxTiles),
// so the grid is ceil(H / kUnits) blocks, all resident at once (a
// cooperative launch, which the card refuses when they are not).  Its
// slice of W_hh is copied into shared memory once per call.  The operand
// that every block needs each step (K1: h_{t-1}, K2: dz_{t+1}) goes through
// a zero-padded bf16 ping-pong buffer in device memory: each block writes
// its own columns, passes one grid barrier, and reads all columns back with
// ld.global.cg (through L2 only: L1 is not coherent across SMs, and a plain
// load could return a line of the buffer's other half from two steps back).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_persistent {

constexpr int kUnits = 8;         // hidden units per block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPair = 32;         // k a lane loads as 16 bytes (two k16)
constexpr int kMaxTiles = 8;      // m16 tiles of rows: B <= 128
constexpr int kProductRows = kWarps * 16;  // partial-sum rows (tiles x split)

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row stride (elements) of a bf16 tile in shared memory whose rows are read
// 16 bytes a lane, 8 rows by 4 lanes in one phase: 64 bytes mod 128, so the
// 8 lanes of a phase hit 8 distinct 16-byte bank groups.  `k_padded` is a
// multiple of kPair.
__host__ __device__ constexpr int smem_stride(int k_padded) {
  return k_padded % 64 == 0 ? k_padded + 32 : k_padded;
}

// Number of m16 tiles for B rows (1, 2, 4 or 8), 0 when B is too large.
inline int tiles_for(int B) {
  for (int t = 1; t <= kMaxTiles; t *= 2)
    if (B <= 16 * t) return t;
  return 0;
}

// Words between two blocks' barrier flags: one 128-byte line each.
constexpr int kFlagStride = 32;

// All blocks of the grid meet here for the epoch-th time (1, 2, ...).  Each
// block publishes `epoch` in its own flag with a release store (so the
// block's writes before the barrier are visible to a block that acquires
// the flag), then thread i < gridDim.x waits for block i's flag with
// acquire loads: no atomic, and each poll reads a line of its own.  `flags`
// holds gridDim.x * kFlagStride words, zero at the start of the call.
__device__ __forceinline__ void grid_barrier(unsigned int* flags,
                                             unsigned int epoch) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("st.release.gpu.global.u32 [%0], %1;"
                 :: "l"(flags + blockIdx.x * kFlagStride), "r"(epoch)
                 : "memory");
  if (threadIdx.x < gridDim.x) {
    const unsigned int* f = flags + threadIdx.x * kFlagStride;
    unsigned int seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(f) : "memory");
    } while (seen < epoch);
  }
  __syncthreads();
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// This warp's partial product over k-pairs [p0, p1): rows (grp, grp + 8) of
// the m16 tile at `a` (bf16 in device memory, row stride lda, zero-padded,
// read with ld.global.cg) times kN n8 tiles of `ws` (bf16 in shared memory,
// tile n's column c is row n * 8 + c, row stride ldw), into acc[n].
//
// The k index is permuted inside each 32-wide pair so that a lane's eight k
// values are adjacent (one 16-byte load each of A and B): its first four
// feed the pair's first k16 step, the other four the second.  A and B use
// the same permutation, so the sum over k is unchanged.  kBatch pairs of A
// are loaded ahead of the products that use them (two register buffers), so
// some 2 * kBatch loads a lane are in flight against L2's latency.
template <int kN, int kBatch>
__device__ __forceinline__ void warp_product(
    const __nv_bfloat16* a, int lda, const __nv_bfloat16* ws, int ldw,
    int p0, int p1, float (&acc)[kN][4]) {
  const int lane = threadIdx.x & 31;
  const int grp = lane >> 2;
  const int tq = lane & 3;
  const uint4* r0 = reinterpret_cast<const uint4*>(a + grp * lda + 8 * tq);
  const uint4* r1 = reinterpret_cast<const uint4*>(a + (grp + 8) * lda
                                                   + 8 * tq);
  const __nv_bfloat16* wb = ws + grp * ldw + 8 * tq;
  constexpr int kStep = kPair / 8;  // uint4 per pair

  uint4 cur[kBatch][2], nxt[kBatch][2];
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (p0 + i < p1) {
      cur[i][0] = __ldcg(r0 + (p0 + i) * kStep);
      cur[i][1] = __ldcg(r1 + (p0 + i) * kStep);
    }
  }
  for (int p = p0; p < p1; p += kBatch) {
    const int pn = p + kBatch;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (pn + i < p1) {
        nxt[i][0] = __ldcg(r0 + (pn + i) * kStep);
        nxt[i][1] = __ldcg(r1 + (pn + i) * kStep);
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (p + i < p1) {
        const int k = (p + i) * kPair;
        const uint4 x0 = cur[i][0], x1 = cur[i][1];
#pragma unroll
        for (int n = 0; n < kN; ++n) {
          const uint4 b = *reinterpret_cast<const uint4*>(wb + n * 8 * ldw
                                                          + k);
          mma_bf16(acc[n], x0.x, x1.x, x0.y, x1.y, b.x, b.y);
          mma_bf16(acc[n], x0.z, x1.z, x0.w, x1.w, b.z, b.w);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      cur[i][0] = nxt[i][0];
      cur[i][1] = nxt[i][1];
    }
  }
}

// Copies `rows` rows of a bf16 matrix into shared memory, 16 bytes a thread
// at a time: row r of the tile is source row src_row(r) (or zeros when that
// is negative), columns [0, K) of a source row stride `ld`, zero-padded to
// k_padded; tile row stride ldw.  `vec`: every source row starts 16-byte
// aligned and K % 8 == 0.
template <typename RowFn>
__device__ __forceinline__ void load_tile(__nv_bfloat16* ws, int ldw,
                                          int rows, int k_padded,
                                          const __nv_bfloat16* src,
                                          size_t ld, int K, bool vec,
                                          RowFn src_row) {
  const int chunks = k_padded / 8;
  for (int idx = threadIdx.x; idx < rows * chunks; idx += kThreads) {
    const int r = idx / chunks;
    const int k = (idx % chunks) * 8;
    const int sr = src_row(r);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (sr >= 0 && k < K) {
      const __nv_bfloat16* p = src + static_cast<size_t>(sr) * ld + k;
      if (vec) {
        v = *reinterpret_cast<const uint4*>(p);
      } else {
        const uint16_t* e = reinterpret_cast<const uint16_t*>(p);
        uint32_t w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) w[i] = k + i < K ? e[i] : 0u;
        v = make_uint4(w[0] | (w[1] << 16), w[2] | (w[3] << 16),
                       w[4] | (w[5] << 16), w[6] | (w[7] << 16));
      }
    }
    *reinterpret_cast<uint4*>(ws + r * ldw + k) = v;
  }
}

// Launches `kernel` cooperatively on ceil(H / kUnits) blocks of kThreads
// with `smem` bytes of dynamic shared memory, after checking that the whole
// grid can be resident at once; returns a CUDA error code (0: accepted).
// The kernel's shared-memory limit is raised to the card's opt-in maximum,
// and the residency is queried, once per (kernel, smem, device): a serving
// loop calls the kernel at T=1 some 900 times a batch, and the queries cost
// host time at every call.
inline int launch_cooperative(const void* kernel, int H, size_t smem,
                              void** args, cudaStream_t stream) {
  struct Checked { const void* kernel; size_t smem; int dev; int resident; };
  static Checked checked[64];
  static int n_checked = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int resident = -1;
  for (int i = 0; i < n_checked; ++i)
    if (checked[i].kernel == kernel && checked[i].smem == smem
        && checked[i].dev == dev)
      resident = checked[i].resident;
  if (resident < 0) {
    int sms = 0, optin = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev)) != cudaSuccess
        || (err = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev))
               != cudaSuccess
        || (err = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin))
               != cudaSuccess
        || (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, smem)) != cudaSuccess)
      return static_cast<int>(err);
    resident = smem <= static_cast<size_t>(optin) ? per_sm * sms : 0;
    if (n_checked < 64) checked[n_checked++] = {kernel, smem, dev, resident};
  }
  const int blocks = (H + kUnits - 1) / kUnits;
  if (resident < blocks || blocks > kThreads)
    return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads),
                                    args, smem, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace lstm_persistent
