// The Hopper copy machinery of K2 (geglu_ff.cu), K6 (int8_dense.cu) and K7
// (fused_conv.cu): mbarriers, 2-D tiled TMA loads (cp.async.bulk.tensor)
// that complete on an mbarrier, alone or multicast to a cluster, the
// cluster's barrier, and the host's tensor maps, encoded with the driver's
// cuTensorMapEncodeTiled reached through the runtime (no -lcuda); and the
// cluster pieces of K1's and K3's cluster plans: reads of another CTA's
// shared memory and the host's cluster launch.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace sdt {

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Waits for the phase of parity `parity` to complete; traps (a launch
// error, not a hang) if it has not after about 2^24 tries.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0;; ++tries) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrives and adds `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// The box of a 2-D map at (c0 innermost, c1) into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// The box of a 4-D map at (c0 innermost, c1, c2, c3) into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_addr(bar))
      : "memory");
}

// The same box into the same shared-memory offset of every CTA of the
// cluster in `mask`, completing on each one's barrier at `bar`'s offset.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, int c0,
                                                      int c1, uint64_t* bar, unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar)), "h"(mask)
      : "memory");
}

// Arrives on the barrier at `bar`'s offset in CTA `rank` of the cluster.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar, unsigned rank) {
  asm volatile(
      "{\n .reg .b32 remote;\n mapa.shared::cluster.u32 remote, %0, %1;\n"
      " mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(smem_addr(bar)),
      "r"(rank)
      : "memory");
}

// `p`'s offset in the shared memory of CTA `rank` of the cluster, as a
// generic address (distributed shared memory). Plain loads through it are
// scheduled as any others, many in flight at once; the cluster's barrier
// (cluster_sync, a compiler barrier too) orders them after the stores they
// read.
template <typename T>
__device__ __forceinline__ const T* cluster_ptr(const T* p, unsigned rank) {
  uint64_t r;
  asm("mapa.u64 %0, %1, %2;\n" : "=l"(r) : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(r);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n"
               ::: "memory");
}

// A named barrier over `threads` threads (a multiple of 32) of the block.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline cudaError_t tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&cached), 12000, cudaEnableDefault,
        &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&cached), cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || cached == nullptr) {
      cached = nullptr;
      return cudaErrorSymbolNotFound;
    }
  }
  *fn = cached;
  return cudaSuccess;
}

// The 2-D map of a row-major [rows, cols] matrix of `elem_bytes` elements,
// boxes of box_cols x box_rows, 128-byte swizzled (box_cols * elem_bytes
// must be 128), zero-filled out of bounds: wgmma's K-major operand tiles.
inline cudaError_t matrix_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                              const void* base, int rows, int cols, int box_cols, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = encode(map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The 4-D map of a contiguous bf16 [batch, n, heads, d] tensor (d
// innermost, then heads, rows, batch elements), boxes of 64 head-dim
// columns x 1 head x box_rows rows x 1 batch element, 128-byte swizzled,
// zero-filled out of bounds (rows past n, columns past d): a block of 64
// columns of box_rows rows of one (batch, head) slice in wgmma's K-major
// layout. d must be a multiple of 8.
inline cudaError_t head_map(CUtensorMap* map, const void* base, int batch, int n, int heads,
                            int d, int box_rows) {
  EncodeTiled encode;
  const cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)n,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)d * 2, (cuuint64_t)heads * d * 2,
                                 (cuuint64_t)n * heads * d * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                              dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// head_map, remembered for the calling thread's last 16 distinct arguments:
// a map is a function of them alone (the tensor's address and shape), so a
// later tensor at the same address and shape has the same map, and a call
// at small shapes saves the encodes.
inline cudaError_t cached_head_map(CUtensorMap* map, const void* base, int batch, int n,
                                   int heads, int d, int box_rows) {
  struct Entry {
    const void* base;
    int batch, n, heads, d, box_rows;
    CUtensorMap map;
  };
  thread_local Entry cache[16];
  thread_local int used = 0, next = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.batch == batch && e.n == n && e.heads == heads && e.d == d &&
        e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  const cudaError_t err = head_map(map, base, batch, n, heads, d, box_rows);
  if (err != cudaSuccess) return err;
  cache[next] = {base, batch, n, heads, d, box_rows, *map};
  next = (next + 1) % 16;
  if (used < 16) ++used;
  return cudaSuccess;
}

// Raises a kernel's dynamic shared-memory limit to `bytes` on the current
// device, once per (kernel, device, bytes) in a table of 64 entries (a host
// call a launch saves).
inline cudaError_t smem_limit(const void* kernel, int bytes) {
  struct Entry {
    const void* kernel;
    int dev, bytes;
  };
  static Entry done[64];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i)
    if (done[i].kernel == kernel && done[i].dev == dev && done[i].bytes >= bytes)
      return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && used < 64) done[used++] = {kernel, dev, bytes};
  return err;
}

// The largest number of `cluster`-CTA clusters of `kernel` (at `threads` and
// `bytes` of dynamic shared memory) that the current device co-schedules,
// once per (kernel, device, cluster, bytes) in a table of 32 entries.
inline cudaError_t active_clusters(const void* kernel, int threads, int bytes, int cluster,
                                   int* clusters) {
  struct Entry {
    const void* kernel;
    int dev, cluster, bytes, clusters;
  };
  static Entry done[32];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i)
    if (done[i].kernel == kernel && done[i].dev == dev && done[i].cluster == cluster &&
        done[i].bytes == bytes) {
      *clusters = done[i].clusters;
      return cudaSuccess;
    }
  err = smem_limit(kernel, bytes);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (err == cudaSuccess && used < 32) done[used++] = {kernel, dev, cluster, bytes, *clusters};
  return err;
}

// Launches `kernel` over `grid` in clusters of `cluster` CTAs along x. A
// cluster the device cannot co-schedule (no cluster of this size fits)
// returns cudaErrorInvalidClusterSize; nothing is launched in its place.
template <typename... Params, typename... Args>
inline cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads,
                                    int bytes, int cluster, cudaStream_t stream,
                                    Args... args) {
  int clusters = 0;
  cudaError_t err =
      active_clusters(reinterpret_cast<const void*>(kernel), threads, bytes, cluster, &clusters);
  if (err != cudaSuccess) return err;
  if (clusters < 1) return cudaErrorInvalidClusterSize;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err == cudaSuccess ? cudaGetLastError() : err;
}

}  // namespace sdt
