// Predictor-gated sparse FFN over flat (layer, group) weight stores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v6
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:564, kernel body :522). It
// computes the same function, in f32: for each token n and selection c, with
// r = idx[n, c],
//     up   = x[n] . WuT[r] + bu[n, c]          WuT[r] is (E, G)
//     gate = x[n] . WgT[r]                     (gated activations only)
//     h    = combine(act, gate, up) * mask     mask = gp >= thr, or gp itself
//     out[n] = sum_c h . Wd[r]                 Wd[r] is (G, E)
//
// What bounds it: the weight bytes. At decode (N = 1) every selected row is
// read once, n_proj * N * C * G * E * sizeof(w) bytes: 3 * 12 * 128 * 4096 * 2
// = 37.7 MB for the ProSparse-Llama-2-7B decode shape, about 11.3 us at the
// H100's 3.35 TB/s. The arithmetic (2 flops per weight) is far below the
// tensor-core line, so plain FMAs on CUDA cores suffice; what matters is
// keeping enough 16-byte loads in flight on every SM.
//
// Design. The TPU kernel walks a sequential (N, C) grid and accumulates the
// down product in its output block. Blocks on the H100 run in no order, so the
// work is split in three launches that each sum in a fixed order (no atomics,
// so the result is the same on every run):
//   A  grid (S, N*C): block (s, n*C+c) reads E-slice s (256 rows) of WuT[r]
//      and WgT[r], each thread 8 consecutive g with 16-byte loads, and writes
//      partial dot products part_up/part_gate[n, c, s, :] after a fixed-order
//      sum in shared memory. S = ceil(E / 256): 192 blocks at N = 1.
//   D  grid (ceil(E / 256), RS, N): block (tile, chunk, n) first forms the
//      hidden of its chunk of the C*G down rows (sums the S partials in
//      order, adds the bias, applies activation and mask), then its 8 warps
//      split the chunk's rows, each lane reading 8 consecutive e of a row
//      (16 bytes), and combine their sums in shared memory in warp order.
//      RS = 16 row chunks: 256 blocks at N = 1.
//   F  out[n, e] = sum over the RS chunk sums, in chunk order.
// Out-of-range row ids are clamped into [0, R), as XLA clamps a gather.

#include "sparse_ffn_common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block in kernels A and D
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                // values per thread per load (16 B of bf16)
constexpr int kSliceE = 256;           // E rows per block in kernel A
constexpr int kTileE = 32 * kVec;      // output columns per block in kernel D
constexpr int kRowChunks = 16;         // least row chunks of the down product
constexpr int kMaxChunkRows = 1024;    // most down rows per block in kernel D

int slices(int E) { return (E + kSliceE - 1) / kSliceE; }

int row_chunks(int K) {
  const int need = (K + kMaxChunkRows - 1) / kMaxChunkRows;
  return need > kRowChunks ? need : kRowChunks;
}

// Kernel A: part[nc, s, :] = x[n, e-slice] . W[r, e-slice, :] for up and gate
template <typename T>
__global__ void __launch_bounds__(kThreads)
v6_partial_dots(const float* __restrict__ x, const int* __restrict__ idx,
                const T* __restrict__ wu, const T* __restrict__ wg,
                float* __restrict__ part_up, float* __restrict__ part_gate,
                int C, int E, int G, int R, int S) {
  __shared__ float su[kThreads * kVec];
  __shared__ float sg[kThreads * kVec];
  const int s = blockIdx.x;
  const int nc = blockIdx.y;
  const int n = nc / C;
  const int r = clamp_row(idx[nc], R);
  const int lanes = G / kVec;          // threads per E row
  const int rows = kThreads / lanes;   // E rows per pass
  const int t = threadIdx.x;
  const int lane = t % lanes;
  const int ro = t / lanes;
  const int e0 = s * kSliceE;
  const int e1 = min(E, e0 + kSliceE);
  const float* xn = x + (size_t)n * E;
  const T* wur = wu + (size_t)r * E * G + kVec * lane;
  const T* wgr = wg ? wg + (size_t)r * E * G + kVec * lane : nullptr;
  float au[kVec] = {}, ag[kVec] = {};
  if (ro < rows) {
#pragma unroll 2
    for (int e = e0 + ro; e < e1; e += rows) {
      const float xe = xn[e];
      float w[kVec];
      load8(wur + (size_t)e * G, w);
#pragma unroll
      for (int i = 0; i < kVec; ++i) au[i] = fmaf(xe, w[i], au[i]);
      if (wgr) {
        load8(wgr + (size_t)e * G, w);
#pragma unroll
        for (int i = 0; i < kVec; ++i) ag[i] = fmaf(xe, w[i], ag[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    su[t * kVec + i] = au[i];
    sg[t * kVec + i] = ag[i];
  }
  __syncthreads();
  for (int col = t; col < G; col += kThreads) {  // fixed-order sum over rows
    const int l = col / kVec, i = col % kVec;
    float tu = 0.f, tg = 0.f;
    for (int k = 0; k < rows; ++k) {
      tu += su[(k * lanes + l) * kVec + i];
      tg += sg[(k * lanes + l) * kVec + i];
    }
    part_up[((size_t)nc * S + s) * G + col] = tu;
    if (wgr) part_gate[((size_t)nc * S + s) * G + col] = tg;
  }
}

// Kernel D: chunk sums of out[n, e-tile] over the chunk's (c, g) rows
template <typename T>
__global__ void __launch_bounds__(kThreads)
v6_down(const float* __restrict__ part_up, const float* __restrict__ part_gate,
        const float* __restrict__ gp, const float* __restrict__ bu,
        const int* __restrict__ idx, const T* __restrict__ wd,
        float* __restrict__ part_out, int C, int E, int G, int R, int S,
        int RS, int act, int gated, float fat_thr, float prob_thr,
        int mask_scale) {
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

  // hidden of this chunk's rows, and where each row's E-tile starts
  for (int t = threadIdx.x; t < nk; t += kThreads) {
    const int k = k0 + t;
    const int c = k / G;
    const int g = k - c * G;
    const size_t nc = (size_t)n * C + c;
    float up = 0.f, gate = 0.f;
    for (int s = 0; s < S; ++s) {
      up += part_up[(nc * S + s) * G + g];
      if (gated) gate += part_gate[(nc * S + s) * G + g];
    }
    if (bu) up += bu[nc * G + g];
    const float p = gp[nc * G + g];
    const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
    hs[t] = combine(act, fat_thr, gate, up) * mask;
    rows_ptr[t] = wd + ((size_t)clamp_row(idx[nc], R) * G + g) * E;
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
                   const float* bu, const void* wu, const void* wg,
                   const void* wd, float* out, float* scratch, int N, int C,
                   int E, int G, int R, int act, float fat_thr, float prob_thr,
                   int mask_scale, cudaStream_t stream) {
  const int S = slices(E);
  const int RS = row_chunks(C * G);
  float* part_up = scratch;
  float* part_gate = part_up + (size_t)N * C * S * G;
  float* part_out = part_gate + (size_t)N * C * S * G;
  v6_partial_dots<T><<<dim3(S, N * C), kThreads, 0, stream>>>(
      x, idx, static_cast<const T*>(wu), static_cast<const T*>(wg), part_up,
      part_gate, C, E, G, R, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  v6_down<T><<<dim3((E + kTileE - 1) / kTileE, RS, N), kThreads, 0, stream>>>(
      part_up, part_gate, gp, bu, idx, static_cast<const T*>(wd), part_out, C,
      E, G, R, S, RS, act, wg != nullptr, fat_thr, prob_thr, mask_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // kernel F: out[n, e] = sum of the RS chunk sums, in chunk order
  sum_row_chunks<<<dim3((E + 255) / 256, N), 256, 0, stream>>>(part_out, out,
                                                                E, RS);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: the up and gate partials
// (N, C, S, G) each and the chunk sums (N, RS, E).
long long sparse_ffn_v6_scratch_floats(int N, int C, int E, int G) {
  return 2LL * N * C * slices(E) * G + (long long)N * row_chunks(C * G) * E;
}

const char* sparse_ffn_v6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// w_bf16 selects __nv_bfloat16 (1) or float (0) stores. wg may be null
// (ungated activation); bu may be null (no up bias). Requires G and E to be
// multiples of 8, G at most 2048, and 16-byte aligned stores. Returns the
// CUDA error of the launches (0 on success); it does not synchronise.
int sparse_ffn_v6(const void* x, const void* idx, const void* gp,
                  const void* bu, const void* wu, const void* wg,
                  const void* wd, void* out, void* scratch, int N, int C,
                  int E, int G, int R, int w_bf16, int act, float fat_thr,
                  float prob_thr, int mask_scale, void* stream) {
  auto* xs = static_cast<const float*>(x);
  auto* is = static_cast<const int*>(idx);
  auto* gs = static_cast<const float*>(gp);
  auto* bs = static_cast<const float*>(bu);
  auto* os = static_cast<float*>(out);
  auto* sc = static_cast<float*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  if (w_bf16)
    return launch<__nv_bfloat16>(xs, is, gs, bs, wu, wg, wd, os, sc, N, C, E,
                                 G, R, act, fat_thr, prob_thr, mask_scale, st);
  return launch<float>(xs, is, gs, bs, wu, wg, wd, os, sc, N, C, E, G, R, act,
                       fat_thr, prob_thr, mask_scale, st);
}

}  // extern "C"
