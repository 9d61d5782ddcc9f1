// Pieces shared by the sparse FFN kernels that split a reduction over the
// blocks of a thread-block cluster (sparse_ffn_v7u.cu, sparse_ffn_v6q.cu,
// sparse_ffn_v6.cu, sparse_ffn_v1.cu):
// cp.async copies into a ring, the cluster barriers, stores into another
// block's shared memory and the rank-order sum over the cluster's blocks
// through distributed shared memory, the launch
// of a cluster grid (a programmatic dependent launch on request), and the
// pick of the cluster size from the occupancy query.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; bytes = 0 writes zeros (past an edge)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// The two halves of a barrier over the block's cluster, so that work can
// run between them: arrive with release (the block's shared-memory stores
// before it are seen by the other blocks after their wait) or relaxed (no
// ordering), and wait with acquire.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// barrier over the block's cluster, ordering shared-memory stores before
// the other blocks' loads after it
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// barrier over the block's cluster without memory ordering: a block's
// shared memory stays until every block of the cluster has used what it
// loaded from it (its loads have completed, the values being consumed)
__device__ __forceinline__ void cluster_hold() {
  cluster_arrive_relaxed();
  cluster_wait();
}

// the same 16 bytes in cluster block `rank`
__device__ __forceinline__ float4 ld_cluster4(uint32_t a, int rank) {
  uint32_t d;
  float4 v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(d));
  return v;
}

// store 16 bytes at a (16-byte aligned) in cluster block `rank`
__device__ __forceinline__ void st_cluster4(uint32_t a, int rank, float4 v) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
               ::"r"(d), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w) : "memory");
}

// store 16 bytes at a (16-byte aligned) in cluster block `rank`, the store
// completing 16 bytes of the transaction count of that block's barrier at
// bar (Hopper's st.async: the storing thread does not wait for it)
__device__ __forceinline__ void st_async4(uint32_t a, uint32_t bar, int rank, float4 v) {
  uint32_t da, db;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(da) : "r"(a), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(db) : "r"(bar), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(da), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(db) : "memory");
}

// sums over the KS (<= MAXK) blocks of the cluster of the 4 words at a
// (16-byte aligned), in rank order; every load is issued before the first add
template <int MAXK>
__device__ __forceinline__ float4 cluster_sum4(uint32_t a, int KS) {
  float4 v[MAXK];
#pragma unroll
  for (int k = 0; k < MAXK; ++k) v[k] = k < KS ? ld_cluster4(a, k) : make_float4(0, 0, 0, 0);
  float4 tot = v[0];
#pragma unroll
  for (int k = 1; k < MAXK; ++k)
    if (k < KS) { tot.x += v[k].x; tot.y += v[k].y; tot.z += v[k].z; tot.w += v[k].w; }
  return tot;
}

// a launch of `grid` (blocks of `threads`) as clusters of ks blocks along x;
// dependent = 1 lets it start before the previous kernel on the stream ends
// (it waits for that kernel with griddepcontrol.wait)
cudaLaunchConfig_t cluster_config(dim3 grid, int threads, int smem, int ks, cudaStream_t st,
                                  cudaLaunchAttribute* attr, int dependent = 0) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = dependent ? 2 : 1;
  return cfg;
}

// Raise a kernel's dynamic shared-memory limit to `bytes` on the current
// device (never lowering it, also once the cache is full; clusters above 8
// blocks are allowed once ks asks for one), then the clusters of ks blocks
// of it that are resident at once. Both cached.
cudaError_t max_clusters(const void* fn, int threads, int bytes, int ks, int* n) {
  struct Entry { const void* fn; int dev, bytes, ks, n; };
  constexpr int kEntries = 512;
  static Entry cache[kEntries];
  static int used = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int limit = 0;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.fn != fn || e.dev != dev) continue;
    limit = e.bytes > limit ? e.bytes : limit;
    if (e.bytes == bytes && e.ks == ks) { *n = e.n; return cudaSuccess; }
  }
  if (bytes > limit) {  // the cache may be full: ask the function's own limit
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, fn);
    if (err != cudaSuccess) return err;
    if (bytes > fa.maxDynamicSharedSizeBytes) {
      err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
      if (err != cudaSuccess) return err;
    }
  }
  if (ks > 8) {
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(ks), threads, bytes, ks, 0, attr);
  err = cudaOccupancyMaxActiveClusters(n, fn, &cfg);
  if (err != cudaSuccess) return err;
  if (used < kEntries) cache[used++] = Entry{fn, dev, bytes > limit ? bytes : limit, ks, *n};
  return cudaSuccess;
}

// The K split of `tiles` output tiles (one cluster each) over `steps`
// stages: KS in 1 .. max_ks (powers of two only where pow2) with the least
// wave ratio, the stages the busiest SM streams over an even share:
// clusters run in rounds of the C resident at once, and a round of b blocks
// puts ceil(b / SMs) on the busiest SM, each streaming ceil(steps / KS)
// stages. An SM with fewer than min_blocks blocks has too few loads in
// flight to take its share of the bandwidth (measured for v7u's cp.async
// ring: 1.8 blocks an SM pull 1.5 TB/s in all, 3-4 pull 1.9-2.2), so a
// first round of fewer blocks counts as slower by that shortfall (score). A
// tie takes the more splits. KS starts at min_ks. packed: the hardware may
// place the clusters of a grid that runs in one round on as few SMs as
// they fit in (measured for v6 by tools/v6_stamps.py --splits 11: 12
// clusters of 11 blocks that fit 2 an SM left 30 of 132 SMs idle and put 2
// blocks on 30), so such a round of b
// blocks counts as min(b, the blocks an SM holds) on the busiest SM.
struct Split {
  int ks, per, rem;
  long long blocks;
  float ratio, score;
};

cudaError_t plan_split(const void* fn, int threads, int bytes, int max_ks, int min_blocks,
                       long long tiles, int steps, int sms, Split* best, bool pow2 = false,
                       int min_ks = 1, bool packed = false) {
  *best = Split{0, 0, 0, 0, 0.f, 0.f};
  for (int ks = min_ks; ks <= max_ks && ks <= steps; ks = pow2 ? 2 * ks : ks + 1) {
    int C = 0;
    const cudaError_t err = max_clusters(fn, threads, bytes, ks, &C);
    if (err != cudaSuccess) return err;
    if (C <= 0) continue;
    const int most = (steps + ks - 1) / ks;
    long long busiest = 0;  // blocks on the busiest SM, summed over rounds
    for (long long left = tiles; left > 0; left -= C) {
      const long long b = (left < C ? left : C) * ks;
      const long long held = ((long long)C * ks + sms - 1) / sms;  // blocks an SM holds
      busiest += packed && tiles <= C ? (b < held ? b : held) : (b + sms - 1) / sms;
    }
    const float ratio = (float)((double)busiest * sms * most / ((double)steps * tiles));
    const long long first = (tiles < C ? tiles : C) * ks;
    const float score = ratio * (float)fmax(1.0, (double)min_blocks * sms / first);
    if (best->ks == 0 || score <= best->score * 1.001f)
      *best = Split{ks, steps / ks, steps % ks, tiles * ks, ratio, score};
  }
  return best->ks ? cudaSuccess : cudaErrorInvalidConfiguration;
}

}  // namespace
