// Helpers shared by K5 (csrc/joint_tail.cu) and K6 (csrc/joint_tail_bwd.cu),
// the transducer joint tail forward and backward: bf16 pairs, the tensor-core
// product and its ldmatrix loads, the hidden activation, and the copies into
// shared memory.  Each source is its own library, so everything here has
// internal linkage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kVC = 32;  // vocabulary columns per chunk

enum Act { kRelu = 0, kHardtanh = 1, kIdentity = 2 };

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

__device__ __forceinline__ uint32_t as_u32(bf162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ bf162 as_bf2(uint32_t u) {
  return *reinterpret_cast<bf162*>(&u);
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

// The shared-memory address of a generic pointer into shared memory.
__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the address of
// row l & 7 of matrix l >> 3; r[i] is this thread's pair of matrix i.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
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

// b2 into shared memory, -inf past V so that pad columns drop out.
__device__ void load_bias(float* b2S, const float* b2, int V, int Vp) {
  for (int v = threadIdx.x; v < Vp; v += blockDim.x)
    b2S[v] = v < V ? b2[v] : -INFINITY;
}

}  // namespace
