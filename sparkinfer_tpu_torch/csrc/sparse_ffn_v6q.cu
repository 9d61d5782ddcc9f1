// Predictor-gated sparse FFN over flat (layer, group) Q8_0 weight stores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v6q
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:706, kernel body :661). It
// computes v6's function over int8 stores with one f32 scale per 32
// elements, dequantized in f32 (nothing is rounded to bf16): for each token
// n and selection c, with r = idx[n, c],
//     up   = x[n] . (QuT[r] * SuT[r]) + bu[n, c]    QuT[r] (E, G) int8,
//                                                   SuT[r] (E/32, G) f32
//     gate = x[n] . (QgT[r] * SgT[r])               gated activations only
//     h    = combine(act, gate, up) * mask          mask = gp >= thr, or gp
//     out[n] = sum_c h . (Qd[r] * Sd[r])            Qd[r] (G, E) int8,
//                                                   Sd[r] (G/32, E) f32
// The scales of up/gate run along E (one per 32 rows e of a column g), those
// of down along G (one per 32 rows g of a column e). Each scale is applied
// once to the sum over the rows it covers (8 rows for up/gate, 16 for down),
// which is the same f32 function summed in another order.
//
// What bounds it: the weight bytes, 1.125 bytes per weight with the scales:
// 3 * C * G * E * 1.125 = 35.4 MB at the ProSparse-Llama-2-13B decode shape
// (N = 1, C = 16, G = 128, E = 5120), 10.6 us at 3.35 TB/s. The arithmetic
// (2 flops per weight) is far below the tensor-core line: plain FMAs.
//
// Design: v6's three fixed-order launches (csrc/sparse_ffn_v6.cu), no atomics,
// with 16 int8 values per 16-byte load:
//   A  grid (S, N*C): block (s, n*C+c) reads E-slice s of QuT[r] and QgT[r];
//      each thread owns 16 consecutive g and 8 consecutive e rows (inside one
//      ggml block, so one scale load), and the block sums its row threads in
//      order into part_up/part_gate[n, c, s, :]. For G = 128 a slice is 256
//      rows: S = 20 slices, 320 blocks at N = 1 and E = 5120.
//   D  grid (ceil(E / 512), RS, N): block (tile, chunk, n) forms the hidden of
//      its chunk of 8 * 16 down rows (the S partials summed in order, bias,
//      activation, mask), then each of its 8 warps takes one 16-row unit (one
//      scale row), each lane 16 consecutive e, and the warps' sums are added
//      in warp order. RS = ceil(C*G / 128): 16 chunks, 160 blocks at N = 1.
//   F  out[n, e] = sum over the RS chunk sums, in chunk order.
// Out-of-range row ids are clamped into [0, R), as XLA clamps a gather.

#include "sparse_ffn_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 16;             // int8 values per 16-byte load
constexpr int kUnitA = 8;            // e rows per thread in kernel A
constexpr int kUnitD = 16;           // down rows per warp in kernel D
constexpr int kChunkRows = kWarps * kUnitD;  // 128 down rows per block
constexpr int kTileE = 32 * kVec;    // 512 output columns per block in D
constexpr int kQK = 32;

static_assert(kQK % kUnitA == 0 && kQK % kUnitD == 0,
              "a unit of rows lies inside one ggml block");

__device__ __forceinline__ void load_scales(const float* p, float* s) {
#pragma unroll
  for (int c = 0; c < kVec; c += 4) {
    const float4 f = *reinterpret_cast<const float4*>(p + c);
    s[c] = f.x; s[c + 1] = f.y; s[c + 2] = f.z; s[c + 3] = f.w;
  }
}

int lanes_a(int G) { return G / kVec; }               // threads along g
int rows_a(int G) { return kThreads / lanes_a(G); }   // row threads
int slice_e(int G) { return kUnitA * rows_a(G); }     // e rows per block
int slices(int E, int G) { return (E + slice_e(G) - 1) / slice_e(G); }
int row_chunks(int C, int G) { return (C * G + kChunkRows - 1) / kChunkRows; }

// sum over this thread's 8 rows of x[e] * Q[e, g..g+16], times the block scale
__device__ __forceinline__ void dot_unit(const float* xe, const int8_t* q,
                                         const float* sp, int G, float* acc) {
  uint4 raw[kUnitA];
#pragma unroll
  for (int j = 0; j < kUnitA; ++j)
    raw[j] = *reinterpret_cast<const uint4*>(q + (size_t)j * G);
  float part[kVec] = {};
#pragma unroll
  for (int j = 0; j < kUnitA; ++j) {
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw[j]);
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      part[i] = fmaf(xe[j], static_cast<float>(v[i]), part[i]);
  }
  float s[kVec];
  load_scales(sp, s);
#pragma unroll
  for (int i = 0; i < kVec; ++i) acc[i] = s[i] * part[i];
}

// Kernel A: part[nc, s, :] = x[n, e-slice] . W[r, e-slice, :] for up and gate
__global__ void __launch_bounds__(kThreads)
v6q_partial_dots(const float* __restrict__ x, const int* __restrict__ idx,
                 const int8_t* __restrict__ qu, const float* __restrict__ su,
                 const int8_t* __restrict__ qg, const float* __restrict__ sg,
                 float* __restrict__ part_up, float* __restrict__ part_gate,
                 int C, int E, int G, int R, int S) {
  __shared__ float redu[kThreads * kVec];
  __shared__ float redg[kThreads * kVec];
  const int s = blockIdx.x;
  const int nc = blockIdx.y;
  const int n = nc / C;
  const int r = clamp_row(idx[nc], R);
  const int lanes = G / kVec;  // as lanes_a(G), rows_a(G) on the host
  const int rows = kThreads / lanes;
  const int t = threadIdx.x;
  const int lane = t % lanes;
  const int ro = t / lanes;
  const int e0 = s * kUnitA * rows + ro * kUnitA;
  float au[kVec] = {}, ag[kVec] = {};
  if (ro < rows && e0 < E) {
    float xe[kUnitA];
#pragma unroll
    for (int j = 0; j < kUnitA; ++j) xe[j] = x[(size_t)n * E + e0 + j];
    const size_t wo = ((size_t)r * E + e0) * G + lane * kVec;
    const size_t so = ((size_t)r * (E / kQK) + e0 / kQK) * G + lane * kVec;
    dot_unit(xe, qu + wo, su + so, G, au);
    if (qg) dot_unit(xe, qg + wo, sg + so, G, ag);
  }
  // thread t's values land at ro * G + g (t * kVec = ro * G + lane * kVec)
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    redu[t * kVec + i] = au[i];
    redg[t * kVec + i] = ag[i];
  }
  __syncthreads();
  for (int col = t; col < G; col += kThreads) {  // fixed-order sum over rows
    float tu = 0.f, tg = 0.f;
    for (int k = 0; k < rows; ++k) {
      tu += redu[k * G + col];
      tg += redg[k * G + col];
    }
    part_up[((size_t)nc * S + s) * G + col] = tu;
    if (qg) part_gate[((size_t)nc * S + s) * G + col] = tg;
  }
}

// Kernel D: chunk sums of out[n, e-tile] over the chunk's (c, g) rows
__global__ void __launch_bounds__(kThreads)
v6q_down(const float* __restrict__ part_up, const float* __restrict__ part_gate,
         const float* __restrict__ gp, const float* __restrict__ bu,
         const int* __restrict__ idx, const int8_t* __restrict__ qd,
         const float* __restrict__ sd, float* __restrict__ part_out, int C,
         int E, int G, int R, int S, int RS, int act, int gated,
         float fat_thr, float prob_thr, int mask_scale) {
  __shared__ float hs[kChunkRows];
  __shared__ float red[kWarps][kTileE];
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int n = blockIdx.z;
  const int K = C * G;
  const int k0 = chunk * kChunkRows;
  const int nk = max(0, min(K, k0 + kChunkRows) - k0);

  // hidden of this chunk's rows
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
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int e = tile * kTileE + lane * kVec;
  const int ku = k0 + warp * kUnitD;  // this warp's 16 rows (C*G % 16 == 0)
  float acc[kVec] = {};
  if (ku < K && e < E) {
    const int c = ku / G;
    const int g0 = ku - c * G;
    const int r = clamp_row(idx[(size_t)n * C + c], R);
    const int8_t* p = qd + ((size_t)r * G + g0) * E + e;
    uint4 raw[kUnitD];
#pragma unroll
    for (int j = 0; j < kUnitD; ++j)
      raw[j] = *reinterpret_cast<const uint4*>(p + (size_t)j * E);
    float part[kVec] = {};
#pragma unroll
    for (int j = 0; j < kUnitD; ++j) {
      const float h = hs[warp * kUnitD + j];
      const int8_t* v = reinterpret_cast<const int8_t*>(&raw[j]);
#pragma unroll
      for (int i = 0; i < kVec; ++i)
        part[i] = fmaf(h, static_cast<float>(v[i]), part[i]);
    }
    float sc[kVec];
    load_scales(sd + ((size_t)r * (G / kQK) + g0 / kQK) * E + e, sc);
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = sc[i] * part[i];
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) red[warp][lane * kVec + i] = acc[i];
  __syncthreads();
  for (int col = threadIdx.x; col < kTileE; col += kThreads) {  // warp order
    const int ee = tile * kTileE + col;
    if (ee >= E) continue;
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red[w][col];
    part_out[((size_t)n * RS + chunk) * E + ee] = tot;
  }
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: the up and gate partials
// (N, C, S, G) each and the chunk sums (N, RS, E).
long long sparse_ffn_v6q_scratch_floats(int N, int C, int E, int G) {
  return 2LL * N * C * slices(E, G) * G + (long long)N * row_chunks(C, G) * E;
}

const char* sparse_ffn_v6q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x f32 (N, E); idx int32 (N, C); gp, bu f32 (N, C, G) (bu may be null);
// qu, qg int8 (R, E, G) with su, sg f32 (R, E/32, G) (qg, sg null for an
// ungated activation); qd int8 (R, G, E) with sd f32 (R, G/32, E). Requires
// G and E multiples of 32, G at most 4096, and 16-byte aligned stores.
// Returns the CUDA error of the launches (0 on success); no synchronise.
int sparse_ffn_v6q(const void* x, const void* idx, const void* gp,
                   const void* bu, const void* qu, const void* su,
                   const void* qg, const void* sg, const void* qd,
                   const void* sd, void* out, void* scratch, int N, int C,
                   int E, int G, int R, int act, float fat_thr, float prob_thr,
                   int mask_scale, void* stream) {
  if (G % kQK != 0 || E % kQK != 0 || G > kThreads * kVec || N <= 0 || C <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = slices(E, G);
  const int RS = row_chunks(C, G);
  auto* sc = static_cast<float*>(scratch);
  float* part_up = sc;
  float* part_gate = part_up + (size_t)N * C * S * G;
  float* part_out = part_gate + (size_t)N * C * S * G;
  auto st = static_cast<cudaStream_t>(stream);
  const auto* is = static_cast<const int*>(idx);
  v6q_partial_dots<<<dim3(S, N * C), kThreads, 0, st>>>(
      static_cast<const float*>(x), is, static_cast<const int8_t*>(qu),
      static_cast<const float*>(su), static_cast<const int8_t*>(qg),
      static_cast<const float*>(sg), part_up, part_gate, C, E, G, R, S);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  v6q_down<<<dim3((E + kTileE - 1) / kTileE, RS, N), kThreads, 0, st>>>(
      part_up, part_gate, static_cast<const float*>(gp),
      static_cast<const float*>(bu), is, static_cast<const int8_t*>(qd),
      static_cast<const float*>(sd), part_out, C, E, G, R, S, RS, act,
      qg != nullptr, fat_thr, prob_thr, mask_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // kernel F: out[n, e] = sum of the RS chunk sums, in chunk order
  sum_row_chunks<<<dim3((E + 255) / 256, N), 256, 0, st>>>(
      part_out, static_cast<float*>(out), E, RS);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
