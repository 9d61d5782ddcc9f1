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
// The rounding matches the TPU kernel bit for bit before the sum: each
// weight is rounded once, as bf16(bf16(q) * bf16(s)), and a bf16 x times a
// bf16 weight is exact in f32. Only the order of the f32 sums differs.
//
// What bounds it. The packed bytes are 1.125 per weight for Q8_0 and 0.625
// for Q4_0 with their f32 scales (29.5 MB for a 5120 x 5120 Q8_0
// projection, 8.8 us at the H100's 3.35 TB/s); the products are 2N flops
// per weight (at 989 TFLOP/s in bf16). So a call is bound by bytes up to
// N = 1.125 * 989 / (2 * 3.35) = 166 tokens for Q8_0 (92 for Q4_0), and by
// the tensor cores above.
//
// Two kernels, one launch per call each.
//
// Decode (N <= 4): qmm_decode, on the CUDA cores, where the products are
// few and the bytes are everything.
//   1. The block owns a column tile and a K split (a range of 16- or 8-row
//      stages). It sums its row threads in shared memory in a fixed order
//      and writes its (N, tile) partial to a workspace; after a barrier,
//      thread 0 adds 1 to the tile's counter with a release-acquire atomic.
//      The block that arrives last adds the KS partials in split order
//      0 .. KS-1, writes out and sets the counter back to 0. The order of
//      every sum is fixed, so results are the same on every run. The
//      workspace (counters, then partials) is one buffer per device that the
//      caller allocates zeroed once; two streams must not run this kernel at
//      the same time on one device.
//   2. Full waves. The host picks the tile (64 to 512 columns) and the
//      number of K splits (at most 16) per shape, so that the block count B
//      fills R = SMs x resident blocks (from the occupancy query) to within
//      ceil(B / R) / (B / R) <= 1.15 where a shape can. 128 threads, at most
//      128 registers (168 at N >= 3). A thread loads 16 bytes of
//      neighbouring columns per row, 16 rows at once at N = 1 (8 above).
//   3. No conversion instructions. int8 -> f32: the byte q ^ 0x80 is placed
//      into the low byte of 0x4B000000 (PRMT) and 2^23 + 128 subtracted,
//      which is exact. The pair (q[c], q[c+1]) is then exact in bf16, and one
//      fma.rn.bf16x2 by the bf16 scale pair (plus -0) rounds both products
//      once, to nearest even. A Q4_0 nibble n goes into the mantissa of bf16
//      128.0 (LOP3), and n - 8 = (128 + n) - 136 is exact in bf16. Scales and
//      x are rounded to bf16 in integers; products are summed with f32 FMAs.
//
// Prefill and batches (N > 4): qmm_prefill, on the tensor cores
// (mma.sync.m16n8k16, bf16 in, f32 sums).
//   1. Read the weights once per token tile. A block owns 128 output
//      columns and a token tile of 16, 32 or 64 (the least padding against
//      one more dequantization per tile), and loops over its K split in
//      stages of 32 input rows: one ggml block, one scale row.
//   2. Keep the load path free. cp.async copies each stage's packed rows,
//      scale row and x rows into a ring of 4-5 slots (3-4 stages ahead of
//      the products), with one barrier a stage; 128 threads, 3-4 blocks per
//      SM. What holds a stage back is the shared-memory pipe that cp.async,
//      ldmatrix and the x copies share: four warps of 32 columns (not eight
//      of 16) halve the x fragments each stage reloads, and bf16 x for
//      Q8_0 is copied straight into the layout the mma reads.
//   3. No dequantized copy of the weights. The weights are the mma's A
//      (M = output columns, "swap AB", so that 8 tokens are the narrowest
//      n) and come straight from the packed bytes in shared memory:
//      ldmatrix.trans of the IN-major byte rows hands a thread, for two
//      input rows, the bytes of two neighbouring columns; taking mma row g
//      as column 2g and row g + 8 as column 2g + 1 makes each column's two
//      bytes one A pair after a PRMT. Q8_0: LOP3 puts q & 127 into the
//      mantissa of bf16 128.0 and a second LOP3 makes -128 or -256 from bit
//      7, whose sum is q exactly (HADD2); one HMUL2 by the scale pair rounds
//      the products once. Q4_0: a byte holds two input rows, so the K order
//      inside 16 rows is permuted (k = 2t, 2t+1 are rows 4t, 4t+2 and k =
//      2t+8, 2t+9 are 4t+1, 4t+3) and x is staged in that order. Other x
//      (f32, or for Q4_0) is rounded to bf16 (cvt.rn.bf16x2) into a
//      double-buffered tile one stage ahead.
//   4. One launch, deterministic, no atomics and no workspace. Where the
//      tiles do not fill the card, K is split (at most 8 ways, picked per
//      shape by the wave ratio of decode's rule) and the KS blocks of a tile
//      run as one thread-block cluster: each leaves its (NT, 128) sums in its
//      shared memory, and after a cluster barrier block kz adds rows kz, kz +
//      KS, ... over the KS blocks in split order through distributed shared
//      memory.
// Columns that are not 16-byte aligned (OUT, ld or col0 not a multiple of
// 16), and x that is not, are copied a byte or an element at a time.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py and
// tools/qmm_compare.py; PERF.md): qmm_decode 0.017 ms for 5120 x 5120 Q8_0
// at N = 1 (1.9x its bound); qmm_prefill about 0.0195 ms at N = 32 (at the
// bf16 library product of the dequantized weight, 2.1x its byte bound) and
// 0.085 ms for the 5120 x 32000 head. Above 64 tokens it is far from the
// tensor cores' rate (about 0.14 ms at N = 512, 3.6x the library): the
// tensor pipe idles while warps dequantize and wait at the stage barrier.
// A producer warp with TMA and wgmma consumers is the next design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 16;  // columns per thread of qmm_decode
constexpr int kQK = 32;    // ggml block: input rows per scale row

// 16 bytes of one packed row, at column oc; `vec` = aligned and in bounds
__device__ __forceinline__ uint4 load_row(const uint8_t* p, int vec, int left) {
  if (vec) return *reinterpret_cast<const uint4*>(p);
  uint4 r = make_uint4(0, 0, 0, 0);
  uint8_t* b = reinterpret_cast<uint8_t*>(&r);
#pragma unroll
  for (int c = 0; c < kCols; ++c) b[c] = c < left ? p[c] : 0;
  return r;
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

// --------------------------------------------------------------------------
// prefill: qmm_prefill, one launch per call for N > 4

constexpr int kPreCols = 128;         // output columns a block owns
constexpr int kPreK = 32;             // input rows a stage: one ggml block, one scale row
constexpr int kPreMaxSplits = 8;      // K splits: the blocks of a portable cluster
constexpr int kPreThreads = 128;      // 4 warps, 32 columns each: a warp reads x once
                                      // for 32 columns
constexpr int kPreTiles[] = {16, 32, 64};  // token tiles (the mma n side)
constexpr int kRawStride = kPreCols + 16;  // packed row in shared memory: 144 B, so the
                                           // 8 rows of an ldmatrix hit distinct banks
constexpr int kXbStride = kPreK + 8;       // bf16 x row: 80 B, likewise
constexpr int kRawBytes = kPreK * kRawStride;    // packed rows of a stage (Q4_0 fills half)
constexpr int kSlotX = kRawBytes + kPreCols * 4;  // x rows after the scale row
constexpr int kRedStride = kPreCols + 4;         // f32 row of a block's sums

static_assert(kPreK == kQK && kPreThreads == 4 * 32 && kPreCols == 4 * 32,
              "a stage is one ggml block; 4 warps of 32 columns");

// ring slots (stages in flight) and blocks per SM the registers are set for
__host__ __device__ constexpr int pre_stages(int NT) { return NT <= 32 ? 5 : 4; }
__host__ __device__ constexpr int pre_blocks(int NT) { return NT <= 32 ? 4 : 3; }

// one ring slot: the stage's packed rows, its scale row (128 f32) and its
// x rows (NT x 32 elements, f32 at most)
__host__ __device__ constexpr int pre_slot_bytes(int NT) { return kSlotX + NT * kPreK * 4; }

// dynamic shared memory: the ring and two bf16 x tiles; the block's f32
// sums reuse the ring after the K loop
__host__ __device__ constexpr int pre_smem_bytes(int NT) {
  return pre_stages(NT) * pre_slot_bytes(NT) + 2 * NT * kXbStride * 2;
}

static_assert(pre_stages(16) * pre_slot_bytes(16) >= 16 * kRedStride * 4 &&
              pre_stages(64) * pre_slot_bytes(64) >= 64 * kRedStride * 4,
              "the sums fit the ring");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(PENDING) : "memory");
}

// (lo, hi) f32 -> bf16 pair, round to nearest even
__device__ __forceinline__ uint32_t bf16x2_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

// (a & b) | c in one LOP3 (b and c in registers)
__device__ __forceinline__ uint32_t and_or(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// The constants of the dequantization, kept in registers for and_or.
struct Dq {
  uint32_t m7f, b128, m80, n128, m0f;
};

// t: two int8 in the low bytes of its halves. 128 + (q & 127) is exact in
// bf16 (its 7 bits in the mantissa of 128.0), and so is subtracting 128
// (q >= 0) or 256 (q < 0, bit 7 set): the bf16 pair (q_a, q_b), then one
// rounding of its product with the scale pair, as bf16(bf16(q) * bf16(s)).
__device__ __forceinline__ uint32_t q8_weights(uint32_t t, uint32_t s2, const Dq& k) {
  const uint32_t v = and_or(t, k.m7f, k.b128);
  const uint32_t c = and_or(t, k.m80, k.n128);  // -128 or -256
  return bf16x2_mul(bf16x2_fma(v, 0x3F803F80u, c), s2);
}

// t: two Q4_0 nibbles in the low bits of its halves: (128 + n) - 136 = n - 8
// exact, then one rounding of the product with the scale pair
__device__ __forceinline__ uint32_t q4_weights(uint32_t t, uint32_t s2, const Dq& k) {
  return bf16x2_mul(bf16x2_fma(and_or(t, k.m0f, k.b128), 0x3F803F80u, 0xC308C308u), s2);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

// barrier over the block's cluster, ordering shared-memory stores before
// the other blocks' loads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// the address of the same shared-memory word in cluster block `rank`
__device__ __forceinline__ uint32_t cluster_map(uint32_t a, int rank) {
  uint32_t d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(rank));
  return d;
}

__device__ __forceinline__ float4 ld_cluster_f4(uint32_t a) {
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ float ld_cluster_f32(uint32_t a) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(a) : "memory");
  return v;
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 products summed in f32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The (tokens n0 .. n0+NT-1) x (columns o0 .. o0+127) products of K split
// blockIdx.z over column tile blockIdx.x and token tile blockIdx.y. The
// weights are the mma's A (M = output columns), x its B (n = tokens). A
// warp owns 32 columns and all NT tokens. Split kz takes stages
// kb .. kb + per + (kz < rem) - 1 of 32 input rows; the KS splits of a tile
// are launched as one cluster. wvec: packed rows and scales 16-byte aligned
// (cp.async), else byte loads; xvec likewise for x.
//
// A fragments come straight from the packed bytes: ldmatrix.trans of the
// IN-major byte rows gives a thread, for input rows (2t, 2t+1) of each 8-row
// matrix, the bytes of columns 2g and 2g+1 of its 16-column group. Row g of
// the mma is taken as column 2g and row g + 8 as column 2g + 1, so the two
// bytes of a column are one A pair after a PRMT. Q4_0: a byte row holds two
// input rows, and the K order within 16 rows is permuted (the mma's k = 2t,
// 2t+1 are input rows 4t, 4t+2 and k = 2t+8, 2t+9 are 4t+1, 4t+3); x is
// staged in the same order.
template <bool Q4, int NT>
__global__ void __launch_bounds__(kPreThreads, pre_blocks(NT))
qmm_prefill(const void* __restrict__ xv, int x_bf16, const uint8_t* __restrict__ qw,
            const float* __restrict__ sc, float* __restrict__ out, int N, int IN, int OUT,
            int ld, int col0, int wvec, int xvec, int per, int rem) {
  constexpr int S = pre_stages(NT), SLOT = pre_slot_bytes(NT), T = kPreThreads;
  constexpr int MI = 2, NI = NT / 8;  // 16-column groups and n8 fragments of a warp
  constexpr int PR = Q4 ? kPreK / 2 : kPreK;  // packed rows a stage
  static_assert(NI % 2 == 0, "x fragments are loaded in pairs");
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t sbase = smem_u32(smem), xbase = sbase + S * SLOT;  // xb: [2][NT][kXbStride]
  const int KS = gridDim.z, kz = blockIdx.z;
  const int o0 = blockIdx.x * kPreCols, n0 = blockIdx.y * NT;
  const int kb = kz * per + min(kz, rem), nst = per + (kz < rem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int xlog = x_bf16 ? 1 : 2;  // log2 of x's element bytes
  const int nn = min(NT, N - n0), mm = min(kPreCols, OUT - o0);
  // bf16 x for Q8_0 needs no conversion: it is copied straight into the
  // bf16 tile's layout in the ring slot
  const bool xdirect = !Q4 && x_bf16 && xvec;

  // This thread's share of a stage's copies, as pointers at stage 0 that
  // advance by one stage each time. Packed rows: chunks tid + T j (16
  // bytes); scales: chunk tid < 32; x: chunks tid + T j of its NT rows.
  const int wr = tid >> 3, wb = (tid & 7) * 16;
  const uint8_t* wsrc = qw + (size_t)(kb * PR + wr) * ld + col0 + o0 + wb;
  const bool wmine = wvec && wb < mm;
  const float* ssrc = sc + (size_t)kb * ld + col0 + o0 + tid * 4;
  const bool smine = wvec && tid < 32 && tid * 4 < mm;
  const int clog = 1 + xlog;  // 16-byte chunks of an x row: 8 (f32) or 4 (bf16)
  const size_t xrow = (size_t)IN << xlog, xstage = (size_t)kPreK << xlog;
  const uint8_t* xsrc = static_cast<const uint8_t*>(xv) +
                        ((size_t)(n0 + (tid >> clog)) * IN + (size_t)kb * kPreK << xlog) +
                        (tid & ((1 << clog) - 1)) * 16;
  const int xrows_j = T >> clog;  // rows between a thread's chunks

  auto issue = [&](int s) {
    if (s >= nst) return;
    const uint32_t slot = sbase + (s % S) * SLOT;
    if (wvec) {
#pragma unroll
      for (int j = 0; j < (PR * 8 + T - 1) / T; ++j)
        if (wmine && wr + j * (T >> 3) < PR)
          cp_async16(slot + (wr + j * (T >> 3)) * kRawStride + wb,
                     wsrc + (size_t)(s * PR + j * (T >> 3)) * ld);
      if (smine) cp_async16(slot + kRawBytes + tid * 16, ssrc + (size_t)s * ld);
    } else {
      uint8_t* sp = smem + (s % S) * SLOT;
      const uint8_t* q = qw + (size_t)(kb + s) * PR * ld + col0 + o0;
#pragma unroll 1
      for (int c = tid; c < PR * kPreCols; c += T) {
        const int r = c >> 7, b = c & (kPreCols - 1);
        if (b < mm) sp[r * kRawStride + b] = q[(size_t)r * ld + b];
      }
      if (tid < mm && tid < kPreCols)
        reinterpret_cast<float*>(sp + kRawBytes)[tid] = sc[(size_t)(kb + s) * ld + col0 + o0 + tid];
    }
    if (xvec) {
#pragma unroll
      for (int j = 0; j < (NT << clog) / T + 1; ++j) {
        const int c = tid + j * T, n = c >> clog;
        const int at = xdirect ? n * kXbStride * 2 + (c & 3) * 16 : c * 16;
        if (c < (NT << clog) && n < nn)
          cp_async16(slot + kSlotX + at, xsrc + s * xstage + (size_t)j * xrows_j * xrow);
      }
    } else {
      uint8_t* xs = smem + (s % S) * SLOT + kSlotX;
      const uint8_t* xp = static_cast<const uint8_t*>(xv) +
                          ((size_t)n0 * IN + (size_t)(kb + s) * kPreK << xlog);
#pragma unroll 1
      for (int c = tid; c < NT * kPreK; c += T) {
        const int n = c >> 5, k = c & (kPreK - 1);
        if (n >= nn) continue;
        if (x_bf16)
          reinterpret_cast<uint16_t*>(xs)[c] = reinterpret_cast<const uint16_t*>(xp + n * xrow)[k];
        else
          reinterpret_cast<uint32_t*>(xs)[c] = reinterpret_cast<const uint32_t*>(xp + n * xrow)[k];
      }
    }
  };

  // stage s's x rows from its slot into the bf16 tile xb[s & 1], 4 elements
  // a thread at a time (Q4_0 in the permuted K order)
  auto convert_x = [&](int s) {
    if (xdirect) return;
    const uint8_t* xs = smem + (s % S) * SLOT + kSlotX;
    uint8_t* xt = smem + S * SLOT + (s & 1) * NT * kXbStride * 2;
    for (int v = tid; v < NT * 8; v += T) {
      const int n = v >> 3, q = v & 7;
      uint32_t e01, e23;
      if (x_bf16) {
        const uint2 p = *reinterpret_cast<const uint2*>(xs + n * kPreK * 2 + q * 8);
        e01 = p.x; e23 = p.y;
      } else {
        const float4 g = *reinterpret_cast<const float4*>(xs + n * kPreK * 4 + q * 16);
        e01 = bf16x2_pack(g.x, g.y); e23 = bf16x2_pack(g.z, g.w);
      }
      uint8_t* row = xt + n * kXbStride * 2;
      if (!Q4) {
        *reinterpret_cast<uint2*>(row + q * 8) = make_uint2(e01, e23);
      } else {  // physical 4t .. 4t+3 of a 16-row group -> k 2t, 2t+1 and 2t+8, 2t+9
        const int k = (q >> 2) * 16 + (q & 3) * 2;
        *reinterpret_cast<uint32_t*>(row + k * 2) = __byte_perm(e01, e23, 0x5410);
        *reinterpret_cast<uint32_t*>(row + (k + 8) * 2) = __byte_perm(e01, e23, 0x7632);
      }
    }
  };

  const int g = lane >> 2, t = lane & 3;
  const Dq dq{0x007F007Fu, 0x43004300u, 0x00800080u, 0xC300C300u, 0x000F000Fu};
  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // The products of stage s: A fragments from its packed rows and scale
  // row, B fragments from xb[s & 1] (or the slot's x rows, xdirect).
  auto mma_stage = [&](int s) {
    const uint32_t slot = sbase + (s % S) * SLOT;
    const uint32_t xt = xdirect ? slot + kSlotX : xbase + (s & 1) * NT * kXbStride * 2;
    uint32_t a[MI][2][4];  // [column group][16-row half][fragment]
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int c = (warp * MI + mi) * 16;  // the group's first column in the tile
      const float2 sf = *reinterpret_cast<const float2*>(smem + (s % S) * SLOT + kRawBytes +
                                                         (c + 2 * g) * 4);
      const uint32_t se = bf16x2_pack(sf.x, sf.x), so = bf16x2_pack(sf.y, sf.y);
      if (!Q4) {
        uint32_t r[4];  // matrices: input rows 0-7, 8-15, 16-23, 24-31
        ldsm_x4_trans(r, slot + (lane & 31) * kRawStride + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          a[mi][h][0] = q8_weights(__byte_perm(r[2 * h], 0, 0x4240), se, dq);
          a[mi][h][1] = q8_weights(__byte_perm(r[2 * h], 0, 0x4341), so, dq);
          a[mi][h][2] = q8_weights(__byte_perm(r[2 * h + 1], 0, 0x4240), se, dq);
          a[mi][h][3] = q8_weights(__byte_perm(r[2 * h + 1], 0, 0x4341), so, dq);
        }
      } else {
        uint32_t r[2];  // byte rows 0-7 (input rows 0-15), 8-15 (16-31)
        ldsm_x2_trans(r, slot + (lane & 15) * kRawStride + c);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t te = __byte_perm(r[h], 0, 0x4240), to = __byte_perm(r[h], 0, 0x4341);
          a[mi][h][0] = q4_weights(te, se, dq);
          a[mi][h][1] = q4_weights(to, so, dq);
          a[mi][h][2] = q4_weights(te >> 4, se, dq);
          a[mi][h][3] = q4_weights(to >> 4, so, dq);
        }
      }
    }
    const int r8 = lane & 7, j0 = (lane >> 3) & 1, j1 = (lane >> 4) & 1;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kk = h * 16;
      uint32_t b[NI][2];
#pragma unroll
      for (int p = 0; p < NI / 2; ++p) {
        uint32_t r[4];
        ldsm_x4(r, xt + ((p * 16 + r8 + j1 * 8) * kXbStride + kk + j0 * 8) * 2);
        b[2 * p][0] = r[0]; b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2]; b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[mi][ni], a[mi][h], b[ni][0], b[ni][1]);
    }
  };

  // Ring of S slots: stage s + S - 1 is issued once stage s - 1 is done,
  // stage s + 1's x is converted while stage s runs on the tensor cores.
  // One barrier a stage.
#pragma unroll 1
  for (int s = 0; s < S - 1; ++s) {
    issue(s);
    cp_async_commit();
  }
  cp_async_wait<S - 2>();
  __syncthreads();
  convert_x(0);
  cp_async_wait<S - 3>();
  __syncthreads();
#pragma unroll 1
  for (int it = 0; it < nst; ++it) {
    issue(it + S - 1);
    cp_async_commit();
    if (it + 1 < nst) convert_x(it + 1);
    mma_stage(it);
    cp_async_wait<S - 3>();
    __syncthreads();
  }

  // The K splits of a tile are one cluster (1, 1, KS). Each block puts its
  // (NT, 128) sums in its shared memory; after a cluster barrier, block kz
  // adds rows kz, kz + KS, ... of the tile over the KS blocks in split order
  // (distributed shared memory) and writes them out; a second barrier keeps
  // every block's sums in place until all are read. acc[mi][ni]: rows g,
  // g + 8 are columns 2g, 2g + 1 of group mi; its columns 2t, 2t + 1 are
  // tokens.
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [NT][kRedStride]
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int m = (warp * MI + mi) * 16 + 2 * g, n = ni * 8 + 2 * t;
      *reinterpret_cast<float2*>(red + n * kRedStride + m) =
          make_float2(acc[mi][ni][0], acc[mi][ni][2]);
      *reinterpret_cast<float2*>(red + (n + 1) * kRedStride + m) =
          make_float2(acc[mi][ni][1], acc[mi][ni][3]);
    }
  cluster_sync();
  const uint32_t rbase = smem_u32(red);
  // block kz's rows kz, kz + KS, ...: one row a warp at a time
#pragma unroll 1
  for (int n = kz + warp * KS; n < nn; n += T / 32 * KS) {
    if (OUT % 4 == 0) {
      const int m = lane * 4;
      if (m >= mm) continue;
      const uint32_t at = rbase + (n * kRedStride + m) * 4;
      float4 tot = ld_cluster_f4(cluster_map(at, 0));
      for (int k = 1; k < KS; ++k) {
        const float4 p = ld_cluster_f4(cluster_map(at, k));
        tot.x += p.x; tot.y += p.y; tot.z += p.z; tot.w += p.w;
      }
      *reinterpret_cast<float4*>(out + (size_t)(n0 + n) * OUT + o0 + m) = tot;
    } else {
      for (int m = lane; m < mm; m += 32) {
        const uint32_t at = rbase + (n * kRedStride + m) * 4;
        float tot = ld_cluster_f32(cluster_map(at, 0));
        for (int k = 1; k < KS; ++k) tot += ld_cluster_f32(cluster_map(at, k));
        out[(size_t)(n0 + n) * OUT + o0 + m] = tot;
      }
    }
  }
  cluster_sync();
}

template <bool Q4, int NT>
const void* pre_fn() { return reinterpret_cast<const void*>(&qmm_prefill<Q4, NT>); }

// qmm_prefill for (q4, token tile index), with its shared-memory limit
// raised once per device
constexpr int kPreNt = sizeof(kPreTiles) / sizeof(kPreTiles[0]);

const void* pre_kernel(int q4, int ti) {
  static const void* const k[2][kPreNt] = {
      {pre_fn<false, 16>(), pre_fn<false, 32>(), pre_fn<false, 64>()},
      {pre_fn<true, 16>(), pre_fn<true, 32>(), pre_fn<true, 64>()}};
  return k[q4 ? 1 : 0][ti];
}

// The token tile of N > 4 tokens: the least ceil(N / NT) * (NT + 32), the
// products a block computes plus a stage's dequantization counted as 32
// tokens (each token tile dequantizes the weights again).
int pre_tile_index(int N) {
  int best = 0;
  long long best_cost = -1;
  for (int i = 0; i < kPreNt; ++i) {
    const int nt = kPreTiles[i];
    const long long cost = (long long)((N + nt - 1) / nt) * (nt + 32);
    if (best_cost < 0 || cost <= best_cost) { best = i; best_cost = cost; }
  }
  return best;
}

// A launch shape and the wave ratio it gives. qmm_decode's column tile is
// 16 x tx columns; qmm_prefill's is kPreCols (tx = 8) by kPreTiles[ti]
// tokens, and its tiles count both.
struct Plan {
  int tx, ks, tiles, steps, slots, ti;
  float ratio;
};

// R = SMs x resident blocks, queried once per device and kernel (N <= 4:
// qmm_decode at N; above: qmm_prefill at N's token tile, whose shared-memory
// limit is raised here first)
cudaError_t kernel_slots(int q4, int N, int* slots) {
  constexpr int kMaxDev = 64;
  static int cache[kMaxDev][2][kDecMaxN + kPreNt];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int idx = N <= kDecMaxN ? N - 1 : kDecMaxN + pre_tile_index(N);
  int* c = dev < kMaxDev ? &cache[dev][q4 ? 1 : 0][idx] : nullptr;
  if (c && *c > 0) { *slots = *c; return cudaSuccess; }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (N <= kDecMaxN) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dec_kernel(q4, N),
                                                        kDecThreads, 0);
  } else {
    const int ti = idx - kDecMaxN, bytes = pre_smem_bytes(kPreTiles[ti]);
    err = cudaFuncSetAttribute(pre_kernel(q4, ti),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pre_kernel(q4, ti),
                                                          kPreThreads, bytes);
  }
  if (err != cudaSuccess) return err;
  *slots = sms * (per_sm > 0 ? per_sm : 1);
  if (c) *c = *slots;
  return cudaSuccess;
}

// qmm_decode: the tile (kDecTx) and the K split. Candidates: at most
// kDecMaxSplits splits, each giving every row thread a stage, with the
// split's x rows in the shared buffer. Among them the fewest blocks with a
// wave ratio <= kWaveSlack, else the least ratio; on a tie the wider tile.
// The ratio counts bytes: ceil(B / R) waves of the largest split, over the
// whole store spread on R slots.
Plan dec_plan(int N, int IN, int OUT, int q4, int slots) {
  const int rf = dec_rows(N), div = q4 ? 2 : 1;
  const int steps = IN / div / rf;
  Plan best{0, 0, 0, steps, slots, -1, 1e30f};
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
        best = Plan{tx, ks, tiles, steps, slots, -1, ratio};
        best_ok = ok;
      }
    }
  }
  return best;
}

// qmm_prefill: the K split for N's token tile. Candidates: at most
// kPreMaxSplits splits; the fewest blocks with a wave ratio <= kWaveSlack,
// else the least ratio (counted as in dec_plan, over whole tiles).
Plan pre_plan(int N, int IN, int OUT, int slots) {
  const int ti = pre_tile_index(N), nt = kPreTiles[ti], steps = IN / kPreK;
  const int tiles = ((OUT + kPreCols - 1) / kPreCols) * ((N + nt - 1) / nt);
  Plan best{kPreCols / kCols, 0, tiles, steps, slots, ti, 1e30f};
  bool best_ok = false;
  for (int ks = 1; ks <= steps && ks <= kPreMaxSplits; ++ks) {
    const int per = (steps + ks - 1) / ks;
    const long long waves = ((long long)tiles * ks + slots - 1) / slots;
    const float ratio = (float)((double)waves * slots * per / ((double)steps * tiles));
    const bool ok = ratio <= kWaveSlack;
    if (best.ks == 0 || (ok && !best_ok) || (!ok && !best_ok && ratio < best.ratio)) {
      best.ks = ks;
      best.ratio = ratio;
      best_ok = ok;
    }
  }
  return best;
}

// the plan for the current device, cached by shape
cudaError_t plan_cached(int N, int IN, int OUT, int q4, Plan* plan) {
  struct Entry { int dev, N, IN, OUT, q4; Plan plan; };
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
  err = kernel_slots(q4, N, &slots);
  if (err != cudaSuccess) return err;
  *plan = N <= kDecMaxN ? dec_plan(N, IN, OUT, q4, slots) : pre_plan(N, IN, OUT, slots);
  e = Entry{dev, N, IN, OUT, q4, *plan};
  used[h] = true;
  return cudaSuccess;
}

template <bool Q4>
cudaError_t launch_decode(const Plan& pl, int N, const void* x, int x_bf16,
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

template <bool Q4, int NT>
cudaError_t launch_prefill_nt(const Plan& pl, int N, const void* x, int x_bf16,
                              const uint8_t* qw, const float* sc, float* out, int IN, int OUT,
                              int ld, int col0, int wvec, int xvec, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((OUT + kPreCols - 1) / kPreCols, (N + NT - 1) / NT, pl.ks);
  cfg.blockDim = dim3(kPreThreads);
  cfg.dynamicSmemBytes = pre_smem_bytes(NT);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = pl.ks;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int per = pl.steps / pl.ks, rem = pl.steps % pl.ks;
  return cudaLaunchKernelEx(&cfg, qmm_prefill<Q4, NT>, x, x_bf16, qw, sc, out, N, IN, OUT,
                            ld, col0, wvec, xvec, per, rem);
}

template <bool Q4>
cudaError_t launch_prefill(const Plan& pl, int N, const void* x, int x_bf16,
                           const uint8_t* qw, const float* sc, float* out, int IN, int OUT,
                           int ld, int col0, int wvec, int xvec, cudaStream_t st) {
  switch (kPreTiles[pl.ti]) {
#define QMM_PRE(NT)                                                                          \
  case NT:                                                                                   \
    return launch_prefill_nt<Q4, NT>(pl, N, x, x_bf16, qw, sc, out, IN, OUT, ld, col0, wvec, \
                                     xvec, st)
    QMM_PRE(16);
    QMM_PRE(32);
    QMM_PRE(64);
#undef QMM_PRE
  }
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// f32 scratch the caller allocates for one call: none since both kernels
// take the per-device workspace (quant_matmul_workspace_words). Kept so that
// a caller built for the earlier two-launch prefill still runs.
long long quant_matmul_scratch_floats(int N, int IN, int OUT) {
  (void)N; (void)IN; (void)OUT;
  return 0;
}

// The workspace of one device, in 4-byte words: kCounterTiles int32 tile
// counters, then kPartialFloats f32 partials. The caller allocates it
// zeroed, once per device; the kernels leave every counter at 0.
long long quant_matmul_workspace_words(void) { return kCounterTiles + kPartialFloats; }

void quant_matmul_workspace_capacity(long long* tiles, long long* floats) {
  *tiles = kCounterTiles;
  *floats = kPartialFloats;
}

// The launch shape on the current device: out6 = {column threads per block
// (tile = 16 x that columns; 8 for qmm_prefill's 128), K splits, tiles
// (column tiles, times token tiles above N = 4), resident block slots R,
// steps of the K loop, wave ratio x 1e6}. K splits is 0 when no split of
// qmm_decode (N <= 4) holds its x rows in shared memory (IN too large);
// quant_matmul then refuses the call. Returns the CUDA error (0 on success).
int quant_matmul_plan(int N, int IN, int OUT, int q4, long long* out6) {
  if (N <= 0 || IN <= 0 || IN % kQK != 0 || OUT <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan pl;
  const cudaError_t err = plan_cached(N, IN, OUT, q4, &pl);
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
// columns col0 .. col0 + OUT of the store. scratch: the device's workspace
// (quant_matmul_workspace_words). One launch: qmm_decode for N <= 4, else
// qmm_prefill. Requires IN % 32 == 0. Returns the CUDA error of the launch
// (0 on success); it does not synchronise.
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
  Plan pl;
  cudaError_t err = plan_cached(N, IN, OUT, q4, &pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<float*>(out);
  if (N > kDecMaxN) {
    const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0;
    err = q4 ? launch_prefill<true>(pl, N, x, x_bf16, q, s, o, IN, OUT, ld, col0, vec, xvec, st)
             : launch_prefill<false>(pl, N, x, x_bf16, q, s, o, IN, OUT, ld, col0, vec, xvec,
                                     st);
    return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
  }
  if (pl.ks == 0 || (pl.ks > 1 && (scratch == nullptr || pl.tiles > kCounterTiles ||
                                   (long long)pl.ks * N * OUT > kPartialFloats)))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* ws = static_cast<int*>(scratch);
  err = q4 ? launch_decode<true>(pl, N, x, x_bf16, q, s, o, ws, IN, OUT, ld, col0, vec, st)
           : launch_decode<false>(pl, N, x, x_bf16, q, s, o, ws, IN, OUT, ld, col0, vec, st);
  return static_cast<int>(err);
}

}  // extern "C"
