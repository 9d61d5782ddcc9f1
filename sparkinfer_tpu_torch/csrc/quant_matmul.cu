// Fused dequantize + matrix product over packed Q8_0 / Q4_0 weights, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels quant_matmul_2d and quant_matmul_flat
// (sparkinfer_tpu/ops/quant_matmul.py:149 and :243, kernel bodies :111 and
// :227). Both compute, for x (N, IN) and a packed IN-major weight store,
//     out[n, o] = sum_i bf16(x[n, i]) * bf16(bf16(q[i, o]) * bf16(s[i / 32, o]))
// with the exact products summed in f32. The store is (IN / div, ld) packed
// bytes plus (IN / 32, ld) f32 scales: div = 1 for Q8_0 (int8), 2 for Q4_0
// (byte j of a column holds input rows 2j (low nibble) and 2j+1 (high), each
// value nibble - 8). The output is the column stripe col0 .. col0 + OUT of
// the store: col0 = 0 and OUT = ld for quant_matmul_2d, col0 = il * OUT for
// layer il of quant_matmul_flat's layer-stacked store.
//
// The rounding matches the TPU kernel bit for bit before the sum: an int8
// (or nibble) times a bf16 scale is exact in f32, so __float2bfloat16_rn of
// that product is the bf16 multiply of the TPU kernel, and a bf16 x times a
// bf16 weight is exact in f32 too.
//
// What bounds it: at decode (N = 1) the packed bytes, 1.125 bytes per
// weight for Q8_0 and 0.625 for Q4_0 with their f32 scales: 29.5 MB for a
// 5120 x 5120 Q8_0 projection, 8.8 us at the H100's 3.35 TB/s. At N = 32 the
// products (2 * N * IN * OUT flops) come near the bytes at the bf16
// tensor-core rate; this kernel does them with f32 FMAs on the CUDA cores,
// a first design that is right and simple (wgmma and TMA come later).
//
// Design. A block owns 256 output columns and 256 input rows (a K split):
// 16 threads along the columns, each loading 16 consecutive bytes of a row
// (coalesced, 16-byte loads), times 16 threads along the rows, each with 16
// consecutive input rows that lie inside one ggml block, so each thread
// reads its 16 scales once. A thread keeps NT tokens' sums (NT = 1, 2 or 4;
// wider batches are split across blockIdx.x). The block then sums its 16
// row threads in a fixed order, and a second launch sums the K splits in a
// fixed order: no atomics, so results are the same on every run. At decode a
// 5120 x 5120 product runs 20 x 20 = 400 blocks on the 132 SMs. Columns
// that are not 16-byte aligned (OUT or ld not a multiple of 16) are read a
// byte at a time with bounds checks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kColThreads = 16;                       // threads along out
constexpr int kCols = 16;                             // columns per thread
constexpr int kTileO = kColThreads * kCols;           // 256 columns a block
constexpr int kRowThreads = kThreads / kColThreads;   // 16
constexpr int kRowsPerThread = 16;                    // inside one ggml block
constexpr int kChunkK = kRowThreads * kRowsPerThread; // 256 input rows a block
constexpr int kQK = 32;

static_assert(kThreads == kTileO, "the block sums one column per thread");
static_assert(kQK % kRowsPerThread == 0, "a thread's rows share one scale");

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

int k_splits(int IN) { return (IN + kChunkK - 1) / kChunkK; }

int tokens_per_block(int N) { return N >= 3 ? 4 : N; }

// 16 bytes of one packed row, at column oc; `vec` = aligned and in bounds
__device__ __forceinline__ uint4 load_row(const uint8_t* p, int vec, int left) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  uint8_t* b = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
  for (int c = 0; c < kCols; ++c) b[c] = c < left ? p[c] : 0;
  return r;
}

// Partial sums of one K split. dst is out (N, OUT) when there is one split,
// else the scratch (KS, N, OUT).
// The decode variant (NT = 1) is held to 128 registers, two blocks per SM,
// so one block's dequantize arithmetic overlaps the other's loads.
template <bool Q4, int NT>
__global__ void __launch_bounds__(kThreads, NT == 1 ? 2 : 1)
qmm_partial(const void* __restrict__ xv, int x_bf16,
            const uint8_t* __restrict__ qw, const float* __restrict__ sc,
            float* __restrict__ dst, int N, int IN, int OUT, int ld, int col0,
            int vec) {
  __shared__ float xs[NT][kChunkK];
  __shared__ float red[kRowThreads][kTileO];
  const int n0 = blockIdx.x * NT;
  const int o0 = blockIdx.y * kTileO;
  const int kz = blockIdx.z;
  const int k0 = kz * kChunkK;
  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;

  // this block's x rows, rounded to bf16 (zero past N and IN)
  for (int t = threadIdx.x; t < NT * kChunkK; t += kThreads) {
    const int nt = t / kChunkK, i = k0 + t % kChunkK, n = n0 + nt;
    float v = 0.f;
    if (n < N && i < IN) {
      const size_t at = (size_t)n * IN + i;
      v = x_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(xv)[at])
                 : bf16r(static_cast<const float*>(xv)[at]);
    }
    xs[nt][t % kChunkK] = v;
  }
  __syncthreads();

  float acc[NT][kCols];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[nt][c] = 0.f;

  const int oc = o0 + tx * kCols;           // this thread's first column
  const int i0 = k0 + ty * kRowsPerThread;  // and first input row
  if (oc < OUT && i0 < IN) {
    const int left = OUT - oc;
    float s[kCols];
    const float* sp = sc + (size_t)(i0 / kQK) * ld + col0 + oc;
    if (vec) {
#pragma unroll
      for (int c = 0; c < kCols; c += 4) {
        const float4 f = *reinterpret_cast<const float4*>(sp + c);
        s[c] = f.x; s[c + 1] = f.y; s[c + 2] = f.z; s[c + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] = c < left ? sp[c] : 0.f;
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = bf16r(s[c]);
    const float* xr = &xs[0][ty * kRowsPerThread];

    if (!Q4) {
      const uint8_t* p = qw + (size_t)i0 * ld + col0 + oc;
      uint4 raw[kRowsPerThread];
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j)
        raw[j] = load_row(p + (size_t)j * ld, vec, left);
#pragma unroll
      for (int j = 0; j < kRowsPerThread; ++j) {
        const int8_t* q = reinterpret_cast<const int8_t*>(&raw[j]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float w = bf16r(static_cast<float>(q[c]) * s[c]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            acc[nt][c] = fmaf(xr[nt * kChunkK + j], w, acc[nt][c]);
        }
      }
    } else {
      constexpr int kByteRows = kRowsPerThread / 2;
      const uint8_t* p = qw + (size_t)(i0 / 2) * ld + col0 + oc;
      uint4 raw[kByteRows];
#pragma unroll
      for (int j = 0; j < kByteRows; ++j)
        raw[j] = load_row(p + (size_t)j * ld, vec, left);
#pragma unroll
      for (int j = 0; j < kByteRows; ++j) {
        const uint8_t* q = reinterpret_cast<const uint8_t*>(&raw[j]);
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float lo = bf16r(static_cast<float>((q[c] & 15) - 8) * s[c]);
          const float hi = bf16r(static_cast<float>((q[c] >> 4) - 8) * s[c]);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            acc[nt][c] = fmaf(xr[nt * kChunkK + 2 * j], lo, acc[nt][c]);
            acc[nt][c] = fmaf(xr[nt * kChunkK + 2 * j + 1], hi, acc[nt][c]);
          }
        }
      }
    }
  }

  // fixed-order sum over the row threads, one token at a time
  const size_t split = (size_t)kz * N * OUT;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[ty][tx * kCols + c] = acc[nt][c];
    __syncthreads();
    const int n = n0 + nt, o = o0 + threadIdx.x;
    if (n < N && o < OUT) {
      float tot = 0.f;
      for (int k = 0; k < kRowThreads; ++k) tot += red[k][threadIdx.x];
      dst[split + (size_t)n * OUT + o] = tot;
    }
    __syncthreads();
  }
}

// out[n, o] = sum of the KS split sums, in split order
__global__ void qmm_sum_splits(const float* __restrict__ part,
                               float* __restrict__ out, long long NO, int KS) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= NO) return;
  float tot = 0.f;
  for (int k = 0; k < KS; ++k) tot += part[(size_t)k * NO + t];
  out[t] = tot;
}

template <bool Q4, int NT>
cudaError_t launch_partial(const void* x, int x_bf16, const uint8_t* qw,
                           const float* sc, float* dst, int N, int IN, int OUT,
                           int ld, int col0, int vec, cudaStream_t stream) {
  const dim3 grid((N + NT - 1) / NT, (OUT + kTileO - 1) / kTileO, k_splits(IN));
  qmm_partial<Q4, NT><<<grid, kThreads, 0, stream>>>(x, x_bf16, qw, sc, dst, N,
                                                     IN, OUT, ld, col0, vec);
  return cudaGetLastError();
}

template <bool Q4>
cudaError_t launch_nt(int NT, const void* x, int x_bf16, const uint8_t* qw,
                           const float* sc, float* dst, int N, int IN, int OUT,
                           int ld, int col0, int vec, cudaStream_t stream) {
  switch (NT) {
    case 1: return launch_partial<Q4, 1>(x, x_bf16, qw, sc, dst, N, IN, OUT, ld, col0, vec, stream);
    case 2: return launch_partial<Q4, 2>(x, x_bf16, qw, sc, dst, N, IN, OUT, ld, col0, vec, stream);
    default: return launch_partial<Q4, 4>(x, x_bf16, qw, sc, dst, N, IN, OUT, ld, col0, vec, stream);
  }
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: the K-split sums
// (KS, N, OUT), or nothing when IN fits one split.
long long quant_matmul_scratch_floats(int N, int IN, int OUT) {
  const int ks = k_splits(IN);
  return ks > 1 ? (long long)ks * N * OUT : 0;
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, IN) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1). qw: (IN / div, ld)
// bytes, div = 2 when q4 else 1; sc: (IN / 32, ld) f32. out: (N, OUT) f32,
// columns col0 .. col0 + OUT of the store. Requires IN % 32 == 0. Returns
// the CUDA error of the launches (0 on success); it does not synchronise.
int quant_matmul(const void* x, int x_bf16, const void* qw, const void* sc,
                 void* out, void* scratch, int N, int IN, int OUT, int ld,
                 int col0, int q4, void* stream) {
  if (N <= 0 || IN <= 0 || IN % kQK != 0 || OUT <= 0 || col0 < 0 ||
      col0 + OUT > ld)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* q = static_cast<const uint8_t*>(qw);
  const auto* s = static_cast<const float*>(sc);
  const int vec = (OUT % kCols == 0 && ld % kCols == 0 && col0 % kCols == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(s) % 16 == 0);
  auto st = static_cast<cudaStream_t>(stream);
  const int ks = k_splits(IN);
  float* dst = ks > 1 ? static_cast<float*>(scratch) : static_cast<float*>(out);
  const int nt = tokens_per_block(N);
  cudaError_t err =
      q4 ? launch_nt<true>(nt, x, x_bf16, q, s, dst, N, IN, OUT, ld, col0, vec, st)
         : launch_nt<false>(nt, x, x_bf16, q, s, dst, N, IN, OUT, ld, col0, vec, st);
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  const long long no = (long long)N * OUT;
  qmm_sum_splits<<<(unsigned)((no + 255) / 256), 256, 0, st>>>(
      dst, static_cast<float*>(out), no, ks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
