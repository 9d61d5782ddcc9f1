// Cross-token union sparse FFN for batched decode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v7u
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:1172, kernel body :1122). Each
// group in the batch's union of selected groups is read once for all B
// tokens; a per-(token, union slot) probability masks the groups a token did
// not select. With r = union[u] and flat stores WuT, WgT (R, E, G), Wd (R, G, E):
//     up[b, u]   = x[b] . WuT[r] + bu[b, u]        WuT cast to x's dtype first
//     gate[b, u] = x[b] . WgT[r]                   gated activations only
//     h[b, u]    = bf16(combine(act, gate, up) * mask)   mask = gp >= thr, or gp
//     out[b]     = sum_u h[b, u] . bf16(Wd[r])     f32 sums
// The two bf16 roundings and the cast of the up/gate stores to x's dtype are
// the TPU kernel's (:1135, :1144, :1153-1156); the rounding here is
// __float2bfloat16_rn, the round-to-nearest-even of the plain version.
//
// What bounds it: the weight bytes, n_proj * Cu * G * E * sizeof(w), read once
// whatever B is: 3 * 48 * 128 * 4096 * 2 = 151 MB at ProSparse-Llama-2-7B
// widths with Cu = 48, about 45 us at 3.35 TB/s. 2 * B flops per weight:
// 1.2 GFLOP at B = 8, 18 us even at the f32 CUDA-core peak, so the kernel is
// bound by memory and each weight loaded is used for all the block's tokens
// from registers.
//
// Design, four launches that each sum in a fixed order (no atomics):
//   A  grid (S, Cu, P * TB): block (s, u, p, tb) reads E-slice s (256 rows) of
//      projection p of union row u once, each thread 8 consecutive g by
//      16-byte loads, and multiplies every weight into the NT <= 8 tokens of
//      token chunk tb (x staged in shared memory); then per token a
//      fixed-order sum over the block's rows gives part[p][b, u, s, :].
//      S = ceil(E / 256): 1536 blocks at E = 4096, Cu = 48, gated, B <= 8.
//   H  hidden[b, u, g]: the S partials summed in order, bias, activation,
//      mask, bf16 rounding.
//   D  grid (ceil(E / 256), RS, TB): block (tile, chunk, tb) takes its chunk of
//      the Cu*G down rows, each read once for the chunk's NT tokens (16-byte
//      loads, rounded to bf16); 8 warps split the rows and, token by token,
//      sum in shared memory in warp order.
//   F  out[b, e] = sum over the RS chunk sums, in chunk order.
// Out-of-range row ids are clamped into [0, R), as XLA clamps a gather.

#include "sparse_ffn_common.cuh"

namespace {

constexpr int kThreads = 256;          // threads per block in kernels A and D
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;                // values per thread per load
constexpr int kSliceE = 256;           // E rows per block in kernel A
constexpr int kTileE = 32 * kVec;      // output columns per block in kernel D
constexpr int kMaxTok = 8;             // most tokens per block
constexpr int kRowChunks = 16;         // least row chunks of the down product
constexpr int kMaxChunkRows = 512;     // most down rows per block in kernel D

int slices(int E) { return (E + kSliceE - 1) / kSliceE; }

int row_chunks(int K) {
  const int need = (K + kMaxChunkRows - 1) / kMaxChunkRows;
  return need > kRowChunks ? need : kRowChunks;
}

template <typename T> __device__ __forceinline__ float to_bf16(float v);
template <> __device__ __forceinline__ float to_bf16<float>(float v) {
  return round_bf16(v);
}
template <> __device__ __forceinline__ float to_bf16<__nv_bfloat16>(float v) {
  return v;  // already a bf16 value
}

// Kernel A: part[p][b, u, s, :] = x[b, e-slice] . W_p[r, e-slice, :]
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
v7u_partial_dots(const float* __restrict__ x, const int* __restrict__ urows,
                 const T* __restrict__ wu, const T* __restrict__ wg,
                 float* __restrict__ part_up, float* __restrict__ part_gate,
                 int B, int Cu, int E, int G, int R, int S, int P,
                 int round_w) {
  __shared__ float xs[NT][kSliceE];
  __shared__ float red[kThreads * kVec];
  const int s = blockIdx.x;
  const int u = blockIdx.y;
  const int p = blockIdx.z % P;
  const int b0 = (blockIdx.z / P) * NT;
  const int nb = min(NT, B - b0);
  const int r = clamp_row(urows[u], R);
  const int lanes = G / kVec;          // threads per E row
  const int rows = kThreads / lanes;   // E rows per pass
  const int t = threadIdx.x;
  const int lane = t % lanes;
  const int ro = t / lanes;
  const int e0 = s * kSliceE;
  const int e1 = min(E, e0 + kSliceE);
  for (int i = t; i < NT * kSliceE; i += kThreads) {
    const int b = i / kSliceE, j = i % kSliceE;
    xs[b][j] = (b < nb && e0 + j < E) ? x[(size_t)(b0 + b) * E + e0 + j] : 0.f;
  }
  __syncthreads();

  const T* w = (p == 0 ? wu : wg) + (size_t)r * E * G + kVec * lane;
  float acc[NT][kVec] = {};
  if (ro < rows) {
    for (int e = e0 + ro; e < e1; e += rows) {
      float wv[kVec];
      load8(w + (size_t)e * G, wv);
      if (round_w) {  // an f32 store cast to a bf16 x's dtype
#pragma unroll
        for (int i = 0; i < kVec; ++i) wv[i] = round_bf16(wv[i]);
      }
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        const float xe = xs[b][e - e0];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[b][i] = fmaf(xe, wv[i], acc[b][i]);
      }
    }
  }
  float* part = p == 0 ? part_up : part_gate;
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    if (b >= nb) break;  // the same for the whole block
#pragma unroll
    for (int i = 0; i < kVec; ++i) red[t * kVec + i] = acc[b][i];
    __syncthreads();
    for (int col = t; col < G; col += kThreads) {  // fixed-order sum over rows
      const int l = col / kVec, i = col % kVec;
      float tot = 0.f;
      for (int k = 0; k < rows; ++k) tot += red[(k * lanes + l) * kVec + i];
      part[(((size_t)(b0 + b) * Cu + u) * S + s) * G + col] = tot;
    }
    __syncthreads();
  }
}

// Kernel H: hidden[b, u, g] from the partials
__global__ void v7u_hidden(const float* __restrict__ part_up,
                           const float* __restrict__ part_gate,
                           const float* __restrict__ gp,
                           const float* __restrict__ bu,
                           float* __restrict__ hidden, int BUG, int G, int S,
                           int act, int gated, float fat_thr, float prob_thr,
                           int mask_scale) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= BUG) return;
  const size_t bu_i = k / G;  // (b, u)
  const int g = k - (int)bu_i * G;
  float up = 0.f, gate = 0.f;
  for (int s = 0; s < S; ++s) {
    up += part_up[(bu_i * S + s) * G + g];
    if (gated) gate += part_gate[(bu_i * S + s) * G + g];
  }
  if (bu) up += bu[k];
  const float p = gp[k];
  const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
  hidden[k] = round_bf16(combine(act, fat_thr, gate, up) * mask);
}

// Kernel D: chunk sums of out[b, e-tile] over the chunk's (u, g) rows
template <typename T, int NT>
__global__ void __launch_bounds__(kThreads)
v7u_down(const float* __restrict__ hidden, const int* __restrict__ urows,
         const T* __restrict__ wd, float* __restrict__ part_out, int B, int Cu,
         int E, int G, int R, int RS) {
  __shared__ float hs[NT][kMaxChunkRows];
  __shared__ const T* rows_ptr[kMaxChunkRows];
  __shared__ float red[kWarps][kTileE];
  const int tile = blockIdx.x;
  const int chunk = blockIdx.y;
  const int b0 = blockIdx.z * NT;
  const int nb = min(NT, B - b0);
  const int K = Cu * G;
  const int kb = (K + RS - 1) / RS;
  const int k0 = chunk * kb;
  const int nk = max(0, min(K, k0 + kb) - k0);
  const int e = tile * kTileE + (threadIdx.x % 32) * kVec;

  for (int t = threadIdx.x; t < nk; t += kThreads) {
    const int k = k0 + t;
    const int u = k / G;
    const int g = k - u * G;
    rows_ptr[t] = wd + ((size_t)clamp_row(urows[u], R) * G + g) * E;
#pragma unroll
    for (int b = 0; b < NT; ++b)
      hs[b][t] = b < nb ? hidden[(size_t)(b0 + b) * K + k] : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  float acc[NT][kVec] = {};
  if (e < E) {
    for (int t = warp; t < nk; t += kWarps) {
      float w[kVec];
      load8(rows_ptr[t] + e, w);
#pragma unroll
      for (int i = 0; i < kVec; ++i) w[i] = to_bf16<T>(w[i]);
#pragma unroll
      for (int b = 0; b < NT; ++b) {
        const float hk = hs[b][t];
#pragma unroll
        for (int i = 0; i < kVec; ++i) acc[b][i] = fmaf(hk, w[i], acc[b][i]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NT; ++b) {
    if (b >= nb) break;  // the same for the whole block
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      red[warp][(threadIdx.x % 32) * kVec + i] = acc[b][i];
    __syncthreads();
    for (int col = threadIdx.x; col < kTileE; col += kThreads) {  // warp order
      const int ee = tile * kTileE + col;
      if (ee >= E) continue;
      float tot = 0.f;
      for (int w = 0; w < kWarps; ++w) tot += red[w][col];
      part_out[((size_t)(b0 + b) * RS + chunk) * E + ee] = tot;
    }
    __syncthreads();
  }
}

struct Args {
  const float* x;
  const int* urows;
  const float* gp;
  const float* bu;
  const void* wu;
  const void* wg;
  const void* wd;
  float* out;
  float* scratch;
  int B, Cu, E, G, R, round_w, act;
  float fat_thr, prob_thr;
  int mask_scale;
  cudaStream_t stream;
};

template <typename T, int NT>
cudaError_t launch(const Args& a) {
  const int S = slices(a.E);
  const int K = a.Cu * a.G;
  const int RS = row_chunks(K);
  const int P = a.wg ? 2 : 1;
  const int TB = (a.B + NT - 1) / NT;
  float* part_up = a.scratch;
  float* part_gate = part_up + (size_t)a.B * a.Cu * S * a.G;
  float* hidden = part_gate + (size_t)a.B * a.Cu * S * a.G;
  float* part_out = hidden + (size_t)a.B * K;
  v7u_partial_dots<T, NT><<<dim3(S, a.Cu, P * TB), kThreads, 0, a.stream>>>(
      a.x, a.urows, static_cast<const T*>(a.wu), static_cast<const T*>(a.wg),
      part_up, part_gate, a.B, a.Cu, a.E, a.G, a.R, S, P, a.round_w);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int BUG = a.B * K;
  v7u_hidden<<<(BUG + 255) / 256, 256, 0, a.stream>>>(
      part_up, part_gate, a.gp, a.bu, hidden, BUG, a.G, S, a.act, P == 2,
      a.fat_thr, a.prob_thr, a.mask_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  v7u_down<T, NT><<<dim3((a.E + kTileE - 1) / kTileE, RS, TB), kThreads, 0,
                    a.stream>>>(hidden, a.urows, static_cast<const T*>(a.wd),
                                part_out, a.B, a.Cu, a.E, a.G, a.R, RS);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_row_chunks<<<dim3((a.E + 255) / 256, a.B), 256, 0, a.stream>>>(
      part_out, a.out, a.E, RS);
  return cudaGetLastError();
}

// the fewest tokens per block that still take all of B at once (8 past it)
template <typename T>
cudaError_t dispatch(const Args& a) {
  if (a.B == 1) return launch<T, 1>(a);
  if (a.B == 2) return launch<T, 2>(a);
  if (a.B <= 4) return launch<T, 4>(a);
  return launch<T, kMaxTok>(a);
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: the up and gate partials
// (B, Cu, S, G) each, the hidden (B, Cu, G) and the chunk sums (B, RS, E).
long long sparse_ffn_v7u_scratch_floats(int B, int Cu, int E, int G) {
  const long long K = (long long)Cu * G;
  return 2LL * B * K * slices(E) + B * K + (long long)B * row_chunks(K) * E;
}

const char* sparse_ffn_v7u_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x f32 (B, E); union_rows int32 (Cu,); gp, bu f32 (B, Cu, G), bu may be
// null; wu, wg (R, E, G) and wd (R, G, E) in __nv_bfloat16 (w_bf16 = 1) or
// float, wg null for an ungated activation. round_w = 1 rounds the up/gate
// weights to bf16 (an f32 store with a bf16 x). Requires G and E multiples of
// 8, G at most 2048, and 16-byte aligned stores. Returns the CUDA error of
// the launches (0 on success); it does not synchronise.
int sparse_ffn_v7u(const void* x, const void* union_rows, const void* gp,
                   const void* bu, const void* wu, const void* wg,
                   const void* wd, void* out, void* scratch, int B, int Cu,
                   int E, int G, int R, int w_bf16, int round_w, int act,
                   float fat_thr, float prob_thr, int mask_scale,
                   void* stream) {
  if (G % kVec != 0 || E % kVec != 0 || G > kThreads * kVec || B <= 0 ||
      Cu <= 0 || R <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{static_cast<const float*>(x), static_cast<const int*>(union_rows),
               static_cast<const float*>(gp), static_cast<const float*>(bu),
               wu, wg, wd, static_cast<float*>(out), static_cast<float*>(scratch),
               B, Cu, E, G, R, round_w, act, fat_thr, prob_thr, mask_scale,
               static_cast<cudaStream_t>(stream)};
  return w_bf16 ? static_cast<int>(dispatch<__nv_bfloat16>(a))
                : static_cast<int>(dispatch<float>(a));
}

}  // extern "C"
