// Helpers shared by DAG-ERC's block kernels: K3 (dag_block.cu) and K4
// (dag_block_bwd.cu).  Each source compiles into its own library, so
// everything here has internal linkage.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr long long kMaxSmem = 232448;  // shared memory one block may use on Hopper (227 KB)
constexpr int kClusterBlocks = 16;      // thread blocks a cluster of either kernel's cluster variant

enum Variant { kStream = 0, kCluster = 1 };  // mirrored by _VARIANTS in ops/kernels/dag_block.py

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// raise a kernel's shared-memory limit once per size, so that launches
// captured into a CUDA graph after a first call make no attribute call
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// a 16-block cluster a kernel may launch only once this is set (a non-portable size)
template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, bool& allowed) {
  if (allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute((const void*)kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess) allowed = true;
  return err;
}

cudaLaunchConfig_t cluster_config(int clusters, int threads, size_t smem, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * kClusterBlocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kClusterBlocks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace
