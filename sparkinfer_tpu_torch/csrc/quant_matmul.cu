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
// tensor-core rate.
//
// Two kernels. Decode (N <= 4) runs qmm_decode, one launch per call. Before
// it, every call at N <= 4 took two launches (the K-split kernel and a split
// sum) with per-call scratch; its blocks were fixed at 256 x 256, so the
// 13B shapes ran 1.02 to 2.64 waves; and each weight cost an I2F and an F2F.
//   1. One launch. The block owns a column tile and a K split (a range of
//      16- or 8-row stages). It sums its row threads in shared memory in a
//      fixed order and writes its (N, tile) partial to a workspace; after a
//      barrier, thread 0 adds 1 to the tile's counter with a release-acquire
//      atomic. The block that arrives last adds the KS partials in split
//      order 0 .. KS-1, writes out and sets the counter back to 0. The order
//      of every sum is fixed, so results are the same on every run; only
//      which block adds the splits varies. With one split the block writes
//      out directly. The workspace (counters, then partials) is one buffer
//      per device that the caller allocates zeroed once; two streams must
//      not run this kernel at the same time on one device. (A cluster of
//      the KS blocks adding through distributed shared memory was the other
//      way; it caps KS at 8 and slowed the many-wave head, see PERF.md.)
//   2. Full waves. The host picks the tile (64 to 512 columns) and the
//      number of K splits (at most 16) per shape, so that the block count B
//      fills R = SMs x resident blocks (from the occupancy query) to within
//      ceil(B / R) / (B / R) <= 1.15 where a shape can. 128 threads and at
//      most 128 registers (168 at N >= 3), so 4 (3) blocks per SM. A thread
//      loads 16 bytes of neighbouring columns per row, 16 rows at once at
//      N = 1 (8 above), so 256 bytes are in flight before the first is used;
//      a warp reads at least 64 contiguous bytes of a row.
//   3. No conversion instructions. int8 -> f32: the byte q ^ 0x80 is placed
//      into the low byte of 0x4B000000 (PRMT) and 2^23 + 128 subtracted,
//      which is exact. The pair (q[c], q[c+1]) is then exact in bf16 (the
//      upper halves of the two f32s), and one fma.rn.bf16x2 by the bf16
//      scale pair (plus -0) rounds both products once, to nearest even: the
//      TPU kernel's bf16(bf16(q) * bf16(s)). A Q4_0 nibble n goes into the
//      mantissa of bf16 128.0 (LOP3), and n - 8 = (128 + n) - 136 is exact
//      in bf16. The scales and x are rounded to bf16 in integers
//      (u += 0x7FFF + bit 16 of u; u &= 0xFFFF0000), and bf16 -> f32 is a
//      16-bit shift. Products are summed with f32 FMAs, in input-row order
//      in each thread, then across threads in a fixed order.
//   The prefill (N > 4) runs the first design: qmm_partial and a second
//   launch, qmm_sum_splits. A block owns 256 output columns and 256 input
//   rows (a K split): 16 threads along the columns, each loading 16
//   consecutive bytes of a row (coalesced, 16-byte loads), times 16 threads
//   along the rows, each with 16 consecutive input rows that lie inside one
//   ggml block, so each thread reads its 16 scales once. A thread keeps NT
//   tokens' sums (NT = 4; wider batches are split across blockIdx.x). The
//   block then sums its 16 row threads in a fixed order, and the second
//   launch sums the K splits in a fixed order. It runs f32 FMAs on the CUDA
//   cores (tensor cores come later).
// Columns that are not 16-byte aligned (OUT or ld not a multiple of 16) are
// read a byte at a time with bounds checks, in both kernels.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py; PERF.md),
// qmm_decode at N = 1: 0.01728 ms for 5120 x 5120 Q8_0 (1.96x its 0.00881
// bound; the first design took 0.02585), 0.01605 ms for pred_down
// 1280 x 13824 (2.69x; 0.02127 before), 0.01506 ms for 5120 x 5120 Q4_0,
// 0.07219 ms for the 5120 x 32000 head. What remains above the bound at
// these sizes is a fixed cost per call (launch, x staging, the block sums
// and the last block's split sum) that a single wave of blocks does not
// hide, and dequantization FMAs that run after the loads they wait for.

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

// 16 bytes of one packed row, at column oc; `vec` = aligned and in bounds
__device__ __forceinline__ uint4 load_row(const uint8_t* p, int vec, int left) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  uint8_t* b = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
  for (int c = 0; c < kCols; ++c) b[c] = c < left ? p[c] : 0;
  return r;
}

// Partial sums of one K split, for N > 4 (launched at NT = 4). dst is out
// (N, OUT) when there is one split, else the scratch (KS, N, OUT).
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

// --------------------------------------------------------------------------
// decode: qmm_decode, one launch per call for N <= 4

constexpr int kDecThreads = 128;
constexpr int kDecMaxN = 4;
constexpr int kDecSmemFloats = 8192;           // 32 KB: x rows, then row sums
constexpr int kDecMaxSplits = 16;              // K splits a tile's last block adds
constexpr long long kCounterTiles = 65536;     // workspace: tile counters (int32)
constexpr long long kPartialFloats = 1LL << 22;  // then (KS, N, OUT) partials
constexpr int kDecTx[] = {32, 16, 8, 4};       // threads along the columns
constexpr float kWaveSlack = 1.15f;

static_assert(kDecThreads * kCols * kDecMaxN <= kDecSmemFloats,
              "the row sums of one block fit the shared buffer");

// packed rows a thread loads at once (one stage): 16 x 16 B at N = 1; 8
// above, where the N x 16 sums need the registers
__host__ __device__ constexpr int dec_rows(int NT) { return NT == 1 ? 16 : 8; }

// blocks per SM the register budget is set for: 128 registers, 168 at N >= 3
__host__ __device__ constexpr int dec_blocks(int NT) { return NT <= 2 ? 4 : 3; }

// f32 -> bf16, round to nearest even, in integers: the f32 bits of the
// bf16 value (low half zero). Finite inputs only (NaN and Inf never occur
// for finite scales and activations).
__device__ __forceinline__ uint32_t bf16_bits(float v) {
  uint32_t u = __float_as_uint(v);
  u += 0x7FFFu + ((u >> 16) & 1u);
  return u & 0xFFFF0000u;
}

// a * b + (-0) on bf16 pairs, rounded once to nearest even
__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(0x80008000u));
  return d;
}

// a * b + c on bf16 pairs
__device__ __forceinline__ uint32_t bf16x2_fma(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ float lo_f32(uint32_t p) { return __uint_as_float(p << 16); }
__device__ __forceinline__ float hi_f32(uint32_t p) { return __uint_as_float(p & 0xFFFF0000u); }

// two int8 of u (already ^ 0x80: byte = q + 128) at byte selectors SA, SB
// -> the bf16 pair (q_a, q_b), exact
template <uint32_t SA, uint32_t SB>
__device__ __forceinline__ uint32_t q8_pair(uint32_t u) {
  const float a = __uint_as_float(__byte_perm(u, 0x4B000000u, SA)) - 8388736.0f;
  const float b = __uint_as_float(__byte_perm(u, 0x4B000000u, SB)) - 8388736.0f;
  return __byte_perm(__float_as_uint(a), __float_as_uint(b), 0x7632);
}

// the 16 bf16 scales of a thread's columns from one scale row, as 8 pairs
__device__ __forceinline__ void load_scales(const float* sp, int vec, int left,
                                            uint32_t (&s2)[8]) {
  float s[kCols];
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
  for (int p = 0; p < 8; ++p)
    s2[p] = __byte_perm(bf16_bits(s[2 * p]), bf16_bits(s[2 * p + 1]), 0x7632);
}

// acc[n][c] += x[n][row] * w[row][c] over one stage, in row order. xr: the
// stage's x rows in shared memory (token n at xr[n * xrows]); s2: the 8 bf16
// scale pairs of the thread's 16 columns
template <bool Q4, int NT, int RF>
__device__ __forceinline__ void fma_stage(const uint4 (&raw)[RF], const uint32_t (&s2)[8],
                                          const float* xr, int xrows,
                                          float (&acc)[NT][kCols]) {
#pragma unroll
  for (int j = 0; j < RF; ++j) {
    const uint32_t w[4] = {raw[j].x, raw[j].y, raw[j].z, raw[j].w};
#pragma unroll
    for (int h = 0; h < 4; ++h) {  // columns 4h .. 4h+3
      if (!Q4) {
        const uint32_t u = w[h] ^ 0x80808080u;
        const uint32_t p01 = bf16x2_mul(q8_pair<0x7540, 0x7541>(u), s2[2 * h]);
        const uint32_t p23 = bf16x2_mul(q8_pair<0x7542, 0x7543>(u), s2[2 * h + 1]);
        const float wv[4] = {lo_f32(p01), hi_f32(p01), lo_f32(p23), hi_f32(p23)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float xx = xr[n * xrows + j];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[n][4 * h + c] = fmaf(xx, wv[c], acc[n][4 * h + c]);
        }
      } else {
        // byte = lo | hi << 4: input rows 2j and 2j + 1 of the stage
        const uint32_t t01 = __byte_perm(w[h], 0, 0x4140);  // bytes 0, 1 -> halves
        const uint32_t t23 = __byte_perm(w[h], 0, 0x4342);
        const uint32_t m = 0x000F000Fu, b128 = 0x43004300u;
        const uint32_t one = 0x3F803F80u, m136 = 0xC308C308u;  // 1.0, -136.0
        const uint32_t n01l = (t01 & m) | b128, n01h = ((t01 >> 4) & m) | b128;
        const uint32_t n23l = (t23 & m) | b128, n23h = ((t23 >> 4) & m) | b128;
        const uint32_t pl01 = bf16x2_mul(bf16x2_fma(n01l, one, m136), s2[2 * h]);
        const uint32_t ph01 = bf16x2_mul(bf16x2_fma(n01h, one, m136), s2[2 * h]);
        const uint32_t pl23 = bf16x2_mul(bf16x2_fma(n23l, one, m136), s2[2 * h + 1]);
        const uint32_t ph23 = bf16x2_mul(bf16x2_fma(n23h, one, m136), s2[2 * h + 1]);
        const float wl[4] = {lo_f32(pl01), hi_f32(pl01), lo_f32(pl23), hi_f32(pl23)};
        const float wh[4] = {lo_f32(ph01), hi_f32(ph01), lo_f32(ph23), hi_f32(ph23)};
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float xl = xr[n * xrows + 2 * j], xh = xr[n * xrows + 2 * j + 1];
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            acc[n][4 * h + c] = fmaf(xl, wl[c], acc[n][4 * h + c]);
            acc[n][4 * h + c] = fmaf(xh, wh[c], acc[n][4 * h + c]);
          }
        }
      }
    }
  }
}

// The (N = NT, tile) products of K split blockIdx.y over column tile
// blockIdx.x; ws = kCounterTiles int32 counters, then the f32 partials. The
// tile is (1 << tx_log2) x 16 columns; split kz takes per + (kz < rem)
// stages of RF packed rows, which its row threads take in turn. No division
// by a runtime value: nvcc builds one from I2F and F2I.
template <bool Q4, int NT>
__global__ void __launch_bounds__(kDecThreads, dec_blocks(NT))
qmm_decode(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ qw,
           const float* __restrict__ sc, float* __restrict__ out,
           int* __restrict__ ws, int IN, int OUT, int ld, int col0, int vec, int tx_log2,
           int per, int rem) {
  constexpr int RF = dec_rows(NT);     // packed rows per stage
  constexpr int DIV = Q4 ? 2 : 1;      // input rows per packed row
  constexpr int XR = RF * DIV;         // input rows per stage
  __shared__ __align__(16) float smem[kDecSmemFloats];
  __shared__ int last;
  const int KS = gridDim.y, kz = blockIdx.y;
  const int tc_log2 = tx_log2 + 4, TC = 1 << tc_log2;
  const int ty_log2 = 7 - tx_log2, TY = 1 << ty_log2;  // kDecThreads = 128
  const int tx = threadIdx.x & ((1 << tx_log2) - 1), ty = threadIdx.x >> tx_log2;
  const int o0 = blockIdx.x * TC;
  const int kb = kz * per + min(kz, rem);  // this split's stages kb .. ke-1
  const int ke = kb + per + (kz < rem);
  const int xrows = (ke - kb) * XR, i0 = kb * XR;

  // this split's x rows, rounded to bf16: smem[n * xrows + r]
#pragma unroll
  for (int n = 0; n < NT; ++n)
    for (int r = threadIdx.x; r < xrows; r += kDecThreads) {
      const size_t at = (size_t)n * IN + i0 + r;
      smem[n * xrows + r] =
          x_bf16 ? __uint_as_float((uint32_t)static_cast<const uint16_t*>(xv)[at] << 16)
                 : __uint_as_float(bf16_bits(static_cast<const float*>(xv)[at]));
    }
  __syncthreads();

  float acc[NT][kCols];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[n][c] = 0.f;

  const int oc = o0 + tx * kCols;  // this thread's first column
  if (oc < OUT) {
    const int left = OUT - oc;
    for (int k = kb + ty; k < ke; k += TY) {
      const uint8_t* p = qw + (size_t)k * RF * ld + col0 + oc;
      uint4 raw[RF];
#pragma unroll
      for (int j = 0; j < RF; ++j) raw[j] = load_row(p + (size_t)j * ld, vec, left);
      uint32_t s2[8];  // a stage lies inside one ggml block: one scale row
      load_scales(sc + (size_t)(k * XR / kQK) * ld + col0 + oc, vec, left, s2);
      fma_stage<Q4, NT, RF>(raw, s2, smem + (k - kb) * XR, xrows, acc);
    }
  }
  __syncthreads();  // x rows done: the buffer takes the row sums

  // row sums smem[(ty * NT + n) * TC + column], added over ty in order
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int c = 0; c < kCols; c += 4)
      *reinterpret_cast<float4*>(&smem[(ty * NT + n) * TC + tx * kCols + c]) =
          make_float4(acc[n][c], acc[n][c + 1], acc[n][c + 2], acc[n][c + 3]);
  __syncthreads();
  float* part = reinterpret_cast<float*>(ws + kCounterTiles);
  for (int v = threadIdx.x; v < NT * TC; v += kDecThreads) {
    const int n = v >> tc_log2, c = v & (TC - 1), o = o0 + c;
    if (o >= OUT) continue;
    float tot = 0.f;
    for (int r = 0; r < TY; ++r) tot += smem[(r * NT + n) * TC + c];
    if (KS == 1) out[(size_t)n * OUT + o] = tot;
    else part[((size_t)kz * NT + n) * OUT + o] = tot;
  }
  if (KS == 1) return;

  // The last block of this tile adds the KS partials in split order. The
  // barrier orders the block's partial stores before thread 0's atomic,
  // whose release (cumulative) publishes them and whose acquire lets the
  // last block read everyone's.
  __syncthreads();
  if (threadIdx.x == 0) {
    int prev;
    asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                 : "=r"(prev) : "l"(ws + blockIdx.x) : "memory");
    last = prev == KS - 1;
  }
  __syncthreads();
  if (!last) return;
  for (int v = threadIdx.x; v < NT * TC; v += kDecThreads) {
    const int n = v >> tc_log2, o = o0 + (v & (TC - 1));
    if (o >= OUT) continue;
    const float* pk = part + (size_t)n * OUT + o;
    const size_t stride = (size_t)NT * OUT;
    float tot = 0.f;
    for (int k0 = 0; k0 < KS; k0 += 8) {  // 8 loads in flight, added in order
      float p8[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) p8[u] = k0 + u < KS ? __ldcg(pk + (k0 + u) * stride) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (k0 + u < KS) tot += p8[u];
    }
    out[(size_t)n * OUT + o] = tot;
  }
  if (threadIdx.x == 0) ws[blockIdx.x] = 0;  // ready for the next launch
}

template <bool Q4, int NT>
const void* dec_fn() { return reinterpret_cast<const void*>(&qmm_decode<Q4, NT>); }

const void* dec_kernel(int q4, int nt) {
  static const void* const k[2][kDecMaxN] = {
      {dec_fn<false, 1>(), dec_fn<false, 2>(), dec_fn<false, 3>(), dec_fn<false, 4>()},
      {dec_fn<true, 1>(), dec_fn<true, 2>(), dec_fn<true, 3>(), dec_fn<true, 4>()}};
  return k[q4 ? 1 : 0][nt - 1];
}

// A launch shape of qmm_decode and the wave ratio it gives.
struct DecPlan {
  int tx, ks, tiles, steps, slots;
  float ratio;
};

// R = SMs x resident blocks, queried once per device and kernel
cudaError_t dec_slots(int q4, int nt, int* slots) {
  constexpr int kMaxDev = 64;
  static int cache[kMaxDev][2][kDecMaxN];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int* c = dev < kMaxDev ? &cache[dev][q4 ? 1 : 0][nt - 1] : nullptr;
  if (c && *c > 0) { *slots = *c; return cudaSuccess; }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dec_kernel(q4, nt),
                                                        kDecThreads, 0);
  if (err != cudaSuccess) return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (c) *c = *slots;
  return cudaSuccess;
}

// The tile (kDecTx) and the K split. Candidates: at most kDecMaxSplits
// splits, each giving every row thread a stage, with the split's x rows in
// the shared buffer. Among them the fewest blocks with a wave ratio <=
// kWaveSlack, else the least ratio; on a tie the wider tile. The ratio
// counts bytes: ceil(B / R) waves of the largest split, over the whole
// store spread on R slots.
DecPlan dec_plan(int N, int IN, int OUT, int q4, int slots) {
  const int rf = dec_rows(N), div = q4 ? 2 : 1;
  const int steps = IN / div / rf;
  DecPlan best{0, 0, 0, steps, slots, 1e30f};
  bool best_ok = false;
  for (int tx : kDecTx) {
    const int tc = tx * kCols, ty = kDecThreads / tx;
    const int tiles = (OUT + tc - 1) / tc;
    for (int ks = 1; ks <= steps && ks <= kDecMaxSplits; ++ks) {
      const int per = (steps + ks - 1) / ks;  // stages of the largest split
      if (ks > 1 && steps / ks < ty) break;   // fewer stages per split as ks grows
      if (N * per * rf * div > kDecSmemFloats) continue;
      const long long B = (long long)tiles * ks;
      const long long waves = (B + slots - 1) / slots;
      const float ratio = (float)((double)waves * slots * per * tc / ((double)steps * OUT));
      const bool ok = ratio <= kWaveSlack;
      const long long bestB = (long long)best.tiles * best.ks;
      if (best.tx == 0 || (ok && (!best_ok || B < bestB)) ||
          (!ok && !best_ok && (ratio < best.ratio || (ratio == best.ratio && B < bestB)))) {
        best = DecPlan{tx, ks, tiles, steps, slots, ratio};
        best_ok = ok;
      }
    }
  }
  return best;
}

// dec_plan for the current device, cached by shape
cudaError_t dec_plan_cached(int N, int IN, int OUT, int q4, DecPlan* plan) {
  struct Entry { int dev, N, IN, OUT, q4; DecPlan plan; };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static bool used[kEntries];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned h = ((unsigned)dev * 31u + (unsigned)N * 7919u + (unsigned)IN * 104729u +
                      (unsigned)OUT * 1299709u + (unsigned)q4) % kEntries;
  Entry& e = cache[h];
  if (used[h] && e.dev == dev && e.N == N && e.IN == IN && e.OUT == OUT && e.q4 == q4) {
    *plan = e.plan;
    return cudaSuccess;
  }
  int slots = 0;
  err = dec_slots(q4, N, &slots);
  if (err != cudaSuccess) return err;
  *plan = dec_plan(N, IN, OUT, q4, slots);
  e = Entry{dev, N, IN, OUT, q4, *plan};
  used[h] = true;
  return cudaSuccess;
}

template <bool Q4>
cudaError_t launch_decode(const DecPlan& pl, int N, const void* x, int x_bf16,
                          const uint8_t* qw, const float* sc, float* out, int* ws,
                          int IN, int OUT, int ld, int col0, int vec, cudaStream_t st) {
  const dim3 grid(pl.tiles, pl.ks);
  int tx_log2 = 0;
  while ((1 << tx_log2) < pl.tx) ++tx_log2;
  const int per = pl.steps / pl.ks, rem = pl.steps % pl.ks;
#define QMM_DEC(NT)                                                                  \
  qmm_decode<Q4, NT><<<grid, kDecThreads, 0, st>>>(x, x_bf16, qw, sc, out, ws, IN, OUT, \
                                                   ld, col0, vec, tx_log2, per, rem)
  switch (N) {
    case 1: QMM_DEC(1); break;
    case 2: QMM_DEC(2); break;
    case 3: QMM_DEC(3); break;
    default: QMM_DEC(4); break;
  }
#undef QMM_DEC
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call at N > 4: the K-split sums
// (KS, N, OUT), or nothing when IN fits one split. Decode (N <= 4) takes
// the per-device workspace instead (quant_matmul_workspace_words).
long long quant_matmul_scratch_floats(int N, int IN, int OUT) {
  if (N <= kDecMaxN) return 0;
  const int ks = k_splits(IN);
  return ks > 1 ? (long long)ks * N * OUT : 0;
}

// The decode workspace of one device, in 4-byte words: kCounterTiles int32
// tile counters, then kPartialFloats f32 partials. The caller allocates it
// zeroed, once per device; the kernel leaves every counter at 0.
long long quant_matmul_workspace_words(void) { return kCounterTiles + kPartialFloats; }

void quant_matmul_workspace_capacity(long long* tiles, long long* floats) {
  *tiles = kCounterTiles;
  *floats = kPartialFloats;
}

// The decode launch shape for N <= 4 on the current device: out6 = {column
// threads per block (tile = 16 x that), K splits, column tiles, resident
// block slots R, steps of the K loop, wave ratio x 1e6}. K splits is 0 when
// no split of at most kDecMaxSplits holds its x rows in shared memory (IN
// too large for the decode kernel); quant_matmul then refuses the call.
// Returns the CUDA error (0 on success).
int quant_matmul_plan(int N, int IN, int OUT, int q4, long long* out6) {
  if (N <= 0 || N > kDecMaxN || IN <= 0 || IN % kQK != 0 || OUT <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  DecPlan pl;
  const cudaError_t err = dec_plan_cached(N, IN, OUT, q4, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  out6[0] = pl.tx; out6[1] = pl.ks; out6[2] = pl.tiles;
  out6[3] = pl.slots; out6[4] = pl.steps;
  out6[5] = pl.ks > 0 ? (long long)(pl.ratio * 1e6) : 0;
  return 0;
}

const char* quant_matmul_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x: (N, IN) f32 (x_bf16 = 0) or bf16 (x_bf16 = 1). qw: (IN / div, ld)
// bytes, div = 2 when q4 else 1; sc: (IN / 32, ld) f32. out: (N, OUT) f32,
// columns col0 .. col0 + OUT of the store. scratch: for N <= 4 the device's
// decode workspace (one launch of qmm_decode), else the f32 scratch of
// quant_matmul_scratch_floats (qmm_partial, then qmm_sum_splits). Requires
// IN % 32 == 0. Returns the CUDA error of the launches (0 on success); it
// does not synchronise.
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
  if (N <= kDecMaxN) {
    DecPlan pl;
    cudaError_t err = dec_plan_cached(N, IN, OUT, q4, &pl);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (pl.ks == 0 || (pl.ks > 1 && (pl.tiles > kCounterTiles ||
                                     (long long)pl.ks * N * OUT > kPartialFloats)))
      return static_cast<int>(cudaErrorInvalidValue);
    auto* ws = static_cast<int*>(scratch);
    auto* o = static_cast<float*>(out);
    err = q4 ? launch_decode<true>(pl, N, x, x_bf16, q, s, o, ws, IN, OUT, ld, col0, vec, st)
             : launch_decode<false>(pl, N, x, x_bf16, q, s, o, ws, IN, OUT, ld, col0, vec, st);
    return static_cast<int>(err);
  }
  const int ks = k_splits(IN);
  float* dst = ks > 1 ? static_cast<float*>(scratch) : static_cast<float*>(out);
  cudaError_t err =  // four tokens a block (blockIdx.x over the tokens)
      q4 ? launch_partial<true, 4>(x, x_bf16, q, s, dst, N, IN, OUT, ld, col0, vec, st)
         : launch_partial<false, 4>(x, x_bf16, q, s, dst, N, IN, OUT, ld, col0, vec, st);
  if (err != cudaSuccess || ks == 1) return static_cast<int>(err);
  const long long no = (long long)N * OUT;
  qmm_sum_splits<<<(unsigned)((no + 255) / 256), 256, 0, st>>>(
      dst, static_cast<float*>(out), no, ks);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
