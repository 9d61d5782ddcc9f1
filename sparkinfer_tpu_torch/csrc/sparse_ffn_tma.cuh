// Loads through the Tensor Memory Accelerator, shared by the sparse FFN
// kernels that stream their weights into a ring of shared-memory slots
// (sparse_ffn_v6.cu, sparse_ffn_v6q.cu, sparse_ffn_v1.cu): the ring's
// mbarriers, bulk copies of contiguous bytes, boxes of a 2-D tensor map, the
// bounded wait for a slot, and the host-side encoding of a tensor map
// (cached by store).

#pragma once

#include <cudaTypedefs.h>  // cuTensorMapEncodeTiled's type (reached at run time)
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// The ring's barriers: each slot's completes when the bytes a thread
// announced (expect_tx) have landed by bulk copies (the Tensor Memory
// Accelerator, cp.async.bulk), and `count` arrivals were made (one by the
// announcing thread, unless a barrier counts other arrivals).
__device__ __forceinline__ void ring_init(uint32_t bars, int slots, int count = 1) {
  for (int s = 0; s < slots; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bars + 8 * s), "r"(count));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival on a barrier of this block
__device__ __forceinline__ void arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void expect_bytes(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

// bytes (a multiple of 16, 16-byte aligned both sides) from global to shared
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, int bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One box of a 2-D tensor map (columns x.., rows y..) into shared memory;
// columns past the tensor's edge are zero-filled and count as landed bytes
__device__ __forceinline__ void box_copy(uint32_t dst, const CUtensorMap* map, int x, int y,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar) : "memory");
}

// Wait for the phase of a barrier; a copy that never lands (a fault of the
// kernel) traps after 2^24 polls instead of hanging the card.
__device__ __forceinline__ void wait_phase(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (long long spin = 0; !done; ++spin) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spin > (1LL << 24)) __trap();
  }
}

// The tensor map of a row-major (rows, cols) store of `type` (elem bytes a
// value) in boxes of box_rows x box_cols, encoded on the host through
// cudaGetDriverEntryPoint (no libcuda link) and cached by store and shape.
cudaError_t tensor_map_2d(const void* base, CUtensorMapDataType type, int elem, long long rows,
                          int cols, int box_cols, int box_rows, CUtensorMap* map) {
  struct Entry {
    const void* base;
    int dev, type, cols, box_cols, box_rows;
    long long rows;
    CUtensorMap map;
  };
  constexpr int kEntries = 64;
  static Entry cache[kEntries];
  static int used = 0, next = 0;
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.base == base && e.dev == dev && e.type == (int)type && e.rows == rows &&
        e.cols == cols && e.box_cols == box_cols && e.box_rows == box_rows) {
      *map = e.map;
      return cudaSuccess;
    }
  }
  if (!encode) {
    cudaDriverEntryPointQueryResult found;
    err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode),
                                  cudaEnableDefault, &found);
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || !encode) return cudaErrorNotSupported;
  }
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t boxdim[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(base), dims, strides, boxdim, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  cache[next] = Entry{base, dev, (int)type, cols, box_cols, box_rows, rows, *map};
  next = (next + 1) % kEntries;
  used = used < kEntries ? used + 1 : kEntries;
  return cudaSuccess;
}

}  // namespace
