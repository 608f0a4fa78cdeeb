// What the one-pass InstanceNorm kernels share (instance_norm.cu, the
// forward, and instance_norm_bwd.cu, its gradient), and quant.cu's strip
// route with them: a (sample, channel tile) plane, or a strip of columns,
// staged by 16-byte cp.async copies into the shared memory of a
// thread-block cluster, whose blocks exchange per-channel (per-column)
// reductions through distributed shared memory; and the checks before a
// cluster launch.
#pragma once

#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "common.cuh"

namespace p2p {
namespace {

constexpr int kOnepassThreads = 512;
constexpr int kOnepassWarps = kOnepassThreads / 32;
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxCluster = 16;     // above 8 only as a non-portable size

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}
// The two halves of cluster.sync(), issued apart.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait_acquire() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// log2 of the 16-byte vectors in a tile of `tile` elements of `elem` bytes,
// or -1 where that is no power of two of at most 32 vectors.
inline int tile_log2v(int tile, int elem) {
  const int bytes = tile * elem;
  if (tile <= 0 || bytes % 16) return -1;
  int log2v = 0;
  while ((1 << log2v) < bytes / 16) ++log2v;
  return ((1 << log2v) == bytes / 16 && log2v <= 5) ? log2v : -1;
}

// cudaOccupancyMaxActiveClusters for a launch, asked once per (kernel,
// device, K, shared memory): 0 means no GPC can hold one cluster.
int max_active_clusters(const void* kernel, const cudaLaunchConfig_t& cfg,
                        int* clusters) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, unsigned, size_t>, int> cache;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return err;
  const auto key =
      std::make_tuple(kernel, dev, cfg.attrs[0].val.clusterDim.x,
                      cfg.dynamicSmemBytes);
  std::lock_guard<std::mutex> lock(mu);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *clusters = it->second;
    return cudaSuccess;
  }
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err) return err;
  cache[key] = *clusters;
  return cudaSuccess;
}

// Fills cfg (and its one attribute, attr) for a launch of `kernel` on
// `grid` in clusters of K blocks along x, `threads` threads and `smem`
// bytes of dynamic shared memory each, after allowing both on the kernel.
// Returns cudaErrorInvalidConfiguration when no cluster of the plan fits
// the card.
int cluster_config(const void* kernel, dim3 grid, unsigned K, size_t smem,
                   cudaStream_t stream, cudaLaunchConfig_t* cfg,
                   cudaLaunchAttribute* attr, int threads = kOnepassThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (!err)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = K;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = grid;
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  int clusters = 0;
  err = (cudaError_t)max_active_clusters(kernel, *cfg, &clusters);
  if (err) return err;
  return clusters == 0 ? cudaErrorInvalidConfiguration : cudaSuccess;
}

}  // namespace
}  // namespace p2p
