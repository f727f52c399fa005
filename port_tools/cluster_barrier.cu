// A measuring kernel for port_tools/lattice_variants.py --cluster-barrier:
// n rounds of one shared-memory exchange and one barrier, across a cluster
// of 4 blocks (barrier.cluster, each block reading its neighbour's row
// through distributed shared memory) or within a block (__syncthreads).  It
// prices the cluster barrier a step that K8 would need to spread one batch
// row over several SMs.  Not part of the port.

#include <cuda_runtime.h>

namespace {

constexpr int kRow = 256;  // floats exchanged a round, one a thread at most

__global__ void __cluster_dims__(4, 1, 1) cluster_rounds(int n, float* out) {
  __shared__ float buf[2][kRow];
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  float acc = static_cast<float>(threadIdx.x);
  buf[0][threadIdx.x] = acc;
  buf[1][threadIdx.x] = acc;
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  // The neighbour's buf, in the cluster's shared window.
  unsigned local = static_cast<unsigned>(__cvta_generic_to_shared(&buf[0][0]));
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(local), "r"((rank + 1) & 3));
  for (int i = 0; i < n; ++i) {
    const int q = i & 1;
    const unsigned at = q * kRow + (threadIdx.x + 1) % blockDim.x;
    float v;
    asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
                 : "=f"(v)
                 : "r"(remote + 4u * at));
    acc += v * 1e-9f;
    buf[q ^ 1][threadIdx.x] = acc;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

__global__ void block_rounds(int n, float* out) {
  __shared__ float buf[2][kRow];
  float acc = static_cast<float>(threadIdx.x);
  buf[0][threadIdx.x] = acc;
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    const int q = i & 1;
    acc += buf[q][(threadIdx.x + 1) % blockDim.x] * 1e-9f;
    buf[q ^ 1][threadIdx.x] = acc;
    __syncthreads();
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}

}  // namespace

// blocks a multiple of 4 for the cluster, threads at most kRow; out holds
// blocks * threads floats.  Returns the launch error.
extern "C" int rounds(int cluster, int blocks, int threads, int n, void* out,
                      void* stream) {
  if (threads > kRow || (cluster && blocks % 4)) return 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster)
    cluster_rounds<<<blocks, threads, 0, s>>>(n, static_cast<float*>(out));
  else
    block_rounds<<<blocks, threads, 0, s>>>(n, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
