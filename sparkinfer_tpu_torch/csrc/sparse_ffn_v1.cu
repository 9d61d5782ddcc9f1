// Predictor-gated sparse FFN over neuron-row weight stores, for Hopper
// (sm_90a): one strided kernel for five TPU kernels.
//
// Replaces the Pallas TPU kernels of sparkinfer_tpu/ops/sparse_ffn_pallas.py
// that read neuron rows (G, E) per selected group:
//   sparse_ffn_block    "v1" (:124, kernel body :61), the serving Scheduler's
//                       decode: three (R, G, E) stores, auto-pipelined;
//   sparse_ffn_block_v3 (:306, body :232): v1's stores, a manual W-deep DMA
//                       window;
//   sparse_ffn_block_v5 (:888, body :809): v1's stores, double-buffered waves
//                       of Wv blocks;
//   sparse_ffn_block_v4 (:446, body :392): one interleaved (R, P, G, E)
//                       store, [up, (gate,) down] per row;
//   sparse_ffn_block_v2 (:1044, body :986): one concatenated (P*R, G, E)
//                       store [up; (gate;) down], a (N, C, P) grid.
// They compute one function and differ only in where a row lives and in how
// the TPU's DMA engine is scheduled to fetch it. A CUDA kernel has no DMA
// schedule to choose (the memory system pipelines the loads of many warps),
// so one kernel serves all five: projection p of row r, neuron g starts at
// element off_p + r * row_stride + g * E of its store:
//   v1, v3, v5  three pointers, row_stride G*E, every offset 0;
//   v4          one pointer,    row_stride P*G*E, offsets 0, G*E, (P-1)*G*E;
//   v2          one pointer,    row_stride G*E, offsets 0, R*G*E, (P-1)*R*G*E.
// For each token n and selection c, with r = idx[n, c]:
//     up   = x[n] . Wu[r, g, :] + bu[n, c, g]     f32 sums of exact products
//     gate = x[n] . Wg[r, g, :] + bg[n, c, g]     gated activations only
//     h    = combine(act, gate, up) * mask        mask = gp >= thr, or gp
//     h    = h rounded to the store dtype         (every one of them: :105,
//                                                  :289, :430, :874, :1026)
//     out[n] = sum_c sum_g h[g] * Wd[r, g, :]     f32
// The gate bias bg is v1's alone (the others pass null).
//
// What bounds it: the weight bytes, n_proj * N * C * G * E * sizeof(w) when
// every token reads its own rows: 3 * 12 * 128 * 4096 * 2 = 37.7 MB for the
// ProSparse-Llama-2-7B decode shape at N = 1, about 11.3 us at 3.35 TB/s.
// Two flops per weight: far below the tensor-core line, so plain FMAs on the
// CUDA cores suffice and the design only has to keep 16-byte loads in flight.
//
// Design. In this layout every neuron g of a selected group is one contiguous
// E-row of up and of gate, so the up/gate products are row dot products:
//   A  one warp per (n, c, g): each lane reads 8 consecutive e (16 bytes of
//      bf16) of the up and gate rows per step, the warp sums by a fixed
//      butterfly, and lane 0 applies bias, activation, mask and the rounding
//      and writes hidden[n, c, g]. N*C*G / 8 blocks: 192 at N = 1.
//   D  grid (ceil(E / 256), RS, N): block (tile, chunk, n) takes its chunk of
//      the C*G down rows; its 8 warps split the rows, each lane reading 8
//      consecutive e of a row, and sum in shared memory in warp order.
//   F  out[n, e] = sum over the RS chunk sums, in chunk order.
// No atomics: the result is the same on every run. Out-of-range row ids are
// clamped into [0, R), as XLA clamps a gather (for v2 that keeps a row inside
// its own projection).

#include "sparse_ffn_common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                // values per lane per load
constexpr int kTileE = 32 * kVec;      // output columns per block in kernel D
constexpr int kRowChunks = 16;         // least row chunks of the down product
constexpr int kMaxChunkRows = 1024;    // most down rows per block in kernel D

int row_chunks(int K) {
  const int need = (K + kMaxChunkRows - 1) / kMaxChunkRows;
  return need > kRowChunks ? need : kRowChunks;
}

template <typename T> __device__ __forceinline__ float to_store(float v);
template <> __device__ __forceinline__ float to_store<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_store<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

// Kernel A: hidden[n, c, g], one warp per row
template <typename T>
__global__ void __launch_bounds__(kThreads)
v1_hidden(const float* __restrict__ x, const int* __restrict__ idx,
          const float* __restrict__ gp, const float* __restrict__ bu,
          const float* __restrict__ bg, const T* __restrict__ wu,
          const T* __restrict__ wg, float* __restrict__ hidden, int NCG, int C,
          int E, int G, int R, size_t row_stride, int act, float fat_thr,
          float prob_thr, int mask_scale) {
  const int row = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= NCG) return;  // whole warps leave together
  const int nc = row / G;
  const int g = row - nc * G;
  const int n = nc / C;
  const size_t off = clamp_row(idx[nc], R) * row_stride + (size_t)g * E;
  const float* xn = x + (size_t)n * E;
  const T* ur = wu + off;
  const T* gr = wg ? wg + off : nullptr;
  float au = 0.f, ag = 0.f;
#pragma unroll 4
  for (int e = lane * kVec; e < E; e += 32 * kVec) {
    float xv[kVec], w[kVec];
    load8(xn + e, xv);
    load8(ur + e, w);
#pragma unroll
    for (int i = 0; i < kVec; ++i) au = fmaf(xv[i], w[i], au);
    if (gr) {
      load8(gr + e, w);
#pragma unroll
      for (int i = 0; i < kVec; ++i) ag = fmaf(xv[i], w[i], ag);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    au += __shfl_xor_sync(0xffffffffu, au, o);
    ag += __shfl_xor_sync(0xffffffffu, ag, o);
  }
  if (lane == 0) {
    const size_t k = (size_t)nc * G + g;
    const float up = bu ? au + bu[k] : au;
    const float gate = gr && bg ? ag + bg[k] : ag;
    const float p = gp[k];
    const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
    hidden[k] = to_store<T>(combine(act, fat_thr, gate, up) * mask);
  }
}

// Kernel D: chunk sums of out[n, e-tile] over the chunk's (c, g) rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
v1_down(const float* __restrict__ hidden, const int* __restrict__ idx,
        const T* __restrict__ wd, float* __restrict__ part_out, int C, int E,
        int G, int R, size_t row_stride, int RS) {
  __shared__ float hs[kMaxChunkRows];
  __shared__ const T* rows_ptr[kMaxChunkRows];
  __shared__ float red[kWarps][kTileE];
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n = blockIdx.z;
  const int K = C * G;
  const int kb = (K + RS - 1) / RS;
  const int k0 = chunk * kb;
  const int nk = max(0, min(K, k0 + kb) - k0);
  const int e = tile * kTileE + (threadIdx.x % 32) * kVec;

  for (int t = threadIdx.x; t < nk; t += kThreads) {
    const int k = k0 + t;
    const int c = k / G;
    const int g = k - c * G;
    hs[t] = hidden[(size_t)n * K + k];
    rows_ptr[t] =
        wd + clamp_row(idx[n * C + c], R) * row_stride + (size_t)g * E;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  float acc[kVec] = {};
  if (e < E) {
#pragma unroll 2
    for (int t = warp; t < nk; t += kWarps) {
      const float hk = hs[t];
      float w[kVec];
      load8(rows_ptr[t] + e, w);
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc[i] = fmaf(hk, w[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) red[warp][(threadIdx.x % 32) * kVec + i] = acc[i];
  __syncthreads();
  for (int col = threadIdx.x; col < kTileE; col += kThreads) {  // warp order
    const int ee = tile * kTileE + col;
    if (ee >= E) continue;
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[w][col];
    part_out[((size_t)n * RS + chunk) * E + ee] = tot;
  }
}

template <typename T>
cudaError_t launch(const float* x, const int* idx, const float* gp,
                   const float* bu, const float* bg, const T* wu, const T* wg,
                   const T* wd, float* out, float* scratch, int N, int C, int E,
                   int G, int R, size_t row_stride, int act, float fat_thr,
                   float prob_thr, int mask_scale, cudaStream_t stream) {
  const int NCG = N * C * G;
  const int RS = row_chunks(C * G);
  float* hidden = scratch;
  float* part_out = hidden + (size_t)NCG;
  v1_hidden<T><<<(NCG + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      x, idx, gp, bu, bg, wu, wg, hidden, NCG, C, E, G, R, row_stride, act,
      fat_thr, prob_thr, mask_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  v1_down<T><<<dim3((E + kTileE - 1) / kTileE, RS, N), kThreads, 0, stream>>>(
      hidden, idx, wd, part_out, C, E, G, R, row_stride, RS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_row_chunks<<<dim3((E + 255) / 256, N), 256, 0, stream>>>(part_out, out,
                                                                E, RS);
  return cudaGetLastError();
}

template <typename T>
const T* at(const void* base, long long off) {
  return base ? static_cast<const T*>(base) + off : nullptr;
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: the hidden (N, C, G) and
// the chunk sums (N, RS, E).
long long sparse_ffn_v1_scratch_floats(int N, int C, int E, int G) {
  return (long long)N * C * G + (long long)N * row_chunks(C * G) * E;
}

const char* sparse_ffn_v1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x f32 (N, E); idx int32 (N, C); gp, bu, bg f32 (N, C, G), bu and bg may be
// null; wu, wg, wd the up, gate and down stores in __nv_bfloat16 (w_bf16 = 1)
// or float, wg null where the gate is not read; they may be one pointer.
// Neuron g of row r of projection p starts at element
// off_p + r * row_stride + g * E of its store. Requires E a multiple of 8,
// 16-byte aligned x and stores, and offsets and row_stride multiples of 8.
// Returns the CUDA error of the launches (0 on success); it does not
// synchronise.
int sparse_ffn_v1(const void* x, const void* idx, const void* gp,
                  const void* bu, const void* bg, const void* wu,
                  const void* wg, const void* wd, void* out, void* scratch,
                  int N, int C, int E, int G, int R, int w_bf16, int act,
                  long long row_stride, long long off_u, long long off_g,
                  long long off_d, float fat_thr, float prob_thr,
                  int mask_scale, void* stream) {
  if (E % kVec != 0 || N <= 0 || C <= 0 || G <= 0 || R <= 0 ||
      row_stride % kVec != 0 || off_u % kVec != 0 || off_g % kVec != 0 ||
      off_d % kVec != 0 || row_stride < (long long)G * E || off_u < 0 ||
      off_g < 0 || off_d < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto* xs = static_cast<const float*>(x);
  auto* is = static_cast<const int*>(idx);
  auto* gs = static_cast<const float*>(gp);
  auto* bus = static_cast<const float*>(bu);
  auto* bgs = static_cast<const float*>(bg);
  auto* os = static_cast<float*>(out);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  const size_t rs = static_cast<size_t>(row_stride);
  if (w_bf16)
    return launch(xs, is, gs, bus, bgs, at<__nv_bfloat16>(wu, off_u),
                  at<__nv_bfloat16>(wg, off_g), at<__nv_bfloat16>(wd, off_d),
                  os, sc, N, C, E, G, R, rs, act, fat_thr, prob_thr,
                  mask_scale, st);
  return launch(xs, is, gs, bus, bgs, at<float>(wu, off_u),
                at<float>(wg, off_g), at<float>(wd, off_d), os, sc, N, C, E,
                G, R, rs, act, fat_thr, prob_thr, mask_scale, st);
}

}  // extern "C"
