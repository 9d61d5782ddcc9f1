// Predictor-gated sparse FFN over flat (layer, group) Q8_0 weight stores, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v6q
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:706, kernel body :661). It
// computes v6's function over int8 stores with one f32 scale per 32
// elements, dequantized in f32 (nothing is rounded to bf16): for each token
// n and selection c, with r = clamp(idx[n, c], 0, R - 1),
//     up   = x[n] . (QuT[r] * SuT[r]) + bu[n, c]    QuT[r] (E, G) int8,
//                                                   SuT[r] (E/32, G) f32
//     gate = x[n] . (QgT[r] * SgT[r])               gated activations only
//     h    = combine(act, gate, up) * mask          mask = gp >= thr, or gp
//     out[n] = sum_c h . (Qd[r] * Sd[r])            Qd[r] (G, E) int8,
//                                                   Sd[r] (G/32, E) f32
// The scales of up/gate run along E (one per 32 rows e of a column g), those
// of down along G (one per 32 rows g of a column e). Each scale is applied
// once to the sum over 8 of the rows it covers, which is the same f32
// function summed in another order.
//
// What bounds it: the weight bytes, 1.125 bytes per weight with the scales:
// 3 * C * G * E * 1.125 = 35.4 MB at the ProSparse-Llama-2-13B decode shape
// (N = 1, C = 16, G = 128, E = 5120), 10.6 us at 3.35 TB/s. The arithmetic
// (2 flops per weight) is far below the FMA pipe's rate: f32 FMAs.
//
// Design: two launches, each a thread-block cluster per output tile whose
// blocks split the reduction and add it in rank order through distributed
// shared memory. No atomics, no f32 partials in device memory, and the same
// bits on every run.
//   U  (v6q_up) grid (KS * G tiles, C, N), cluster (KS, 1, 1). Block kz of
//      selection (n, c) takes its share of the E rows of QuT[r] and QgT[r]
//      over one tile of G columns (the whole row for G <= 256); the cluster
//      adds its KS partials, then bias, activation and mask follow, and the
//      f32 hidden (N, C, G) is written once (8 KB at N = 1).
//   D  (v6q_down) grid (KS, E tiles, N), cluster (KS, 1, 1): block kz of an
//      E tile of 512 columns takes its share of token n's K = C * G rows (row
//      k is row clamp(idx[n, k / G]) * G + k % G of Qd) times the hidden, and
//      the cluster adds its splits in rank order and writes out once, f32.
//      D is a programmatic dependent launch: its blocks start while U's last
//      blocks run, load their first W_down stages, and wait for U's grid
//      (griddepcontrol.wait) only before they load the hidden.
// Loads: the Tensor Memory Accelerator fills a ring of stages in shared
// memory (U 3 slots, D 4; a slot 20 KB) that completes on one mbarrier a
// slot; warp 0 issues a stage's copies as soon as its slot is free (one
// block barrier a stage). A U stage is one bulk copy of 64 contiguous rows
// of each projection (16 KB, from one row block of the store), one of their
// scale rows and one of their x; a D stage is one tensor-map box of 32 rows
// x 256 columns per half tile (rows of one group, so 32 consecutive rows of
// Qd seen as (R * G, E)), one bulk copy of its scale row and one of its
// hidden. On an H100, per-thread 16-byte cp.async copies held each block
// to the same low rate whatever the ring depth, and one bulk copy per D
// row is issued lane by lane (a loop in the SASS); whole stages and boxes
// keep HBM busy with a few instructions.
// Arithmetic: thread t owns one 16-byte chunk (16 columns) of 8 rows a stage
// (rows ru + 4 j of a 32-row scale block, so a quarter warp reads 128
// contiguous bytes); int8 becomes f32 without I2F: byte b of the word ^
// 0x80808080 is q + 128; set under 0x4B000000 (PRMT) it is the f32 2^23 + q
// + 128, and one FADD leaves q exactly. Products and sums are f32 FMAs, the
// 8 rows' sum times its 16 scales once.
// Splits: KS (1-16; above 8 a non-portable cluster; U powers of two, so that
// a block finds its split and tile by shifts) is picked per shape from the
// occupancy query for the least wave ratio (plan_split); U counts a first
// round under 2 blocks an SM as slower. Every index is a shift or a product:
// a runtime division, and the cluster's special registers, compile to I2F.
// Requires G and E multiples of 32, G at most 4096, 16-byte aligned stores
// and x.

#include "sparse_ffn_cluster.cuh"
#include "sparse_ffn_common.cuh"
#include "sparse_ffn_tma.cuh"

namespace {

constexpr int kThreads = 128;   // 4 warps a block, both launches
constexpr int kUnit = 8;        // rows a thread sums before its scale
constexpr int kQK = 32;         // rows a scale covers (one ggml block)
constexpr int kShare = kQK / kUnit;  // threads that share a scale row
constexpr int kStages = 3;      // U's ring slots: 2 stages in flight
constexpr int kDStages = 4;     // D's ring slots
constexpr int kMaxSplits = 16;  // blocks of a cluster (above 8: non-portable)
constexpr int kUMinBlocks = 2;  // blocks an SM needs in flight (plan_split), U
constexpr int kDMinBlocks = 1;  // and D
constexpr int kWBytes = kUnit * kThreads * 16;  // int8 of a stage: 16 KB
constexpr int kSBytes = kWBytes / kQK * 4;      // their scales: 2 KB
constexpr int kVBytes = kUnit * kThreads * 2;   // its vector values (tiles >= 32 columns)
constexpr int kSlot = kWBytes + kSBytes + kVBytes;
constexpr int kMaxTile = 256;   // most columns of a U tile (P * chunks <= 32)
constexpr int kMaxDTile = 512;  // most columns of a D tile (chunks <= 32)

// rows of a stage for P (1 or 2) projections over tiles of 2^lc 16-column
// chunks: P * rows * tile = 16 KB. Tiles, chunks and stages are powers of
// two, so that no index needs a runtime division (which compiles to I2F).
__host__ __device__ constexpr int stage_rows(int P, int lc) {
  return kThreads * kUnit >> (P - 1 + lc);
}

// Thread t's share of a stage: 16-column chunk cw, rows rb * 32 + ru +
// kShare * j (j < kUnit, inside one 32-row scale block rb) of projection p.
// lb: log2 of the 32-row blocks of a stage. Neighbouring threads take
// neighbouring chunks, so a quarter warp reads 128 contiguous bytes.
struct Item {
  int cw, ru, rb, p;
  __device__ Item(int t, int lc, int lb) {
    constexpr int ls = 2;
    static_assert(kShare == 1 << ls, "four threads share a scale row");
    cw = t & ((1 << lc) - 1);
    ru = (t >> lc) & (kShare - 1);
    rb = (t >> (lc + ls)) & ((1 << lb) - 1);
    p = t >> (lc + ls + lb);
  }
  __device__ int row() const { return rb * kQK + ru; }  // first of its rows in the stage
  __device__ int unit() const { return rb * kShare + ru; }
};

__device__ __forceinline__ int log2_of(int v) { return 31 - __clz(v); }

// part[i] += v * q_i over the 16 int8 q of w, each q read as f32 exactly
// without I2F: byte b of w ^ 0x80808080 is q + 128, set under 0x4B000000
// (PRMT) it is the f32 2^23 + q + 128, and 2^23 + 128 is subtracted (FADD)
__device__ __forceinline__ void fma16(const uint4& w, float v, float (&part)[16]) {
  const uint32_t u[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                         w.w ^ 0x80808080u};
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float q = __uint_as_float(__byte_perm(u[k], 0x4B000000u, 0x7440 + b)) - 8388736.0f;
      part[4 * k + b] = fmaf(v, q, part[4 * k + b]);
    }
}

// acc += sum_j v[j] * q[j, :] over the thread's kUnit rows of 16 int8 columns
// (the first at w, the next ld bytes on), times the 16 scales at sc
__device__ __forceinline__ void dot_rows(const uint8_t* w, int ld, const float (&v)[kUnit],
                                         const float* sc, float (&acc)[16]) {
  float part[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) part[i] = 0.f;
  uint4 q[kUnit];  // every row's load issued before the first product
#pragma unroll
  for (int j = 0; j < kUnit; ++j) q[j] = *reinterpret_cast<const uint4*>(w + j * ld);
#pragma unroll
  for (int j = 0; j < kUnit; ++j) fma16(q[j], v[j], part);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 s = reinterpret_cast<const float4*>(sc)[k];
    acc[4 * k] = fmaf(s.x, part[4 * k], acc[4 * k]);
    acc[4 * k + 1] = fmaf(s.y, part[4 * k + 1], acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(s.z, part[4 * k + 2], acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(s.w, part[4 * k + 3], acc[4 * k + 3]);
  }
}

// After the ring: each thread's 16 sums into red[p][unit][tile] (the ring's
// memory), then their fixed-order sum over the units into bsum[p][tile],
// which the cluster reads. Returns bsum.
__device__ __forceinline__ float* block_sums(uint8_t* smem, const Item& me, int t,
                                             const float (&acc)[16], int P, int units,
                                             int lc) {
  const int tile = 16 << lc;
  float* red = reinterpret_cast<float*>(smem);
  float* rp = red + ((size_t)me.p * units + me.unit()) * tile + me.cw * 16;
#pragma unroll
  for (int i = 0; i < 16; i += 4)
    *reinterpret_cast<float4*>(rp + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  __syncthreads();
  float* bsum = red + (size_t)P * units * tile;
  for (int i = t; i < P * tile / 4; i += kThreads) {
    const int p = i >> (lc + 2), m = (i & ((4 << lc) - 1)) * 4;
    const float* col = red + (size_t)p * units * tile + m;
    float4 s = *reinterpret_cast<const float4*>(col);
    for (int u = 1; u < units; ++u) {
      const float4 v = *reinterpret_cast<const float4*>(col + (size_t)u * tile);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(bsum + p * tile + m) = s;
  }
  cluster_sync();
  return bsum;
}

// Launch U: hidden[n, c, g] over one tile of 16 << lc columns of G for
// selection c of token n; grid (KS * G tiles, C, N) with KS = 2^lks blocks a
// cluster: block x is split x % KS of tile x / KS (the cluster's registers
// would cost an I2F each). XF32: f32 x, else bf16. Block kz takes
// stages kb .. kb + nst - 1 of the E rows; a stage holds its rows of the up
// (and gate) tile, their scale rows and their x values, copied by warp 0.
template <bool XF32>
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
v6q_up(const void* __restrict__ x, const int* __restrict__ idx, const float* __restrict__ gp,
       const float* __restrict__ bu, const int8_t* __restrict__ qu,
       const float* __restrict__ su, const int8_t* __restrict__ qg,
       const float* __restrict__ sg, float* __restrict__ hidden, int C, int E, int G, int R,
       int lc, int lks, int per, int rem, int act, float fat_thr, float prob_thr,
       int mask_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int xs = XF32 ? 4 : 2;
  const int P = qg ? 2 : 1, tile = 16 << lc;
  const int rows = stage_rows(P, lc);
  const int KS = 1 << lks, kz = blockIdx.x & (KS - 1);
  const int g0 = (blockIdx.x >> lks) * tile, n = blockIdx.z;
  const int nc = n * C + blockIdx.y;
  const int kb = kz * per + min(kz, rem), nst = per + (kz < rem);
  const int t = threadIdx.x, lane = t & 31;
  const Item me(t, lc, log2_of(rows / kQK));
  const size_t r = clamp_row(idx[nc], R);
  // a tile that covers G is copied whole (one copy a projection), rows of
  // G bytes; a narrower one row by row, rows of `tile` bytes
  const bool whole = tile >= G;
  const int ws = whole ? G : tile, cv = whole ? G : min(tile, G - g0);
  const bool cin = me.cw * 16 < cv;
  const uint32_t sbase = smem_u32(smem), bars = sbase + kStages * kSlot;
  // thread t of block kz finishes the group of 4 columns t * KS + kz (a tile
  // has at most 64 groups); its mask and bias are read before the loop
  const int m = (t * KS + kz) * 4;
  const bool fin = m < tile && g0 + m < G;
  const size_t o = (size_t)nc * G + g0 + m;
  float gp4[4] = {}, bu4[4] = {};
  if (fin)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gp4[k] = gp[o + k];
      if (bu) bu4[k] = bu[o + k];
    }
  if (t == 0) ring_init(bars, kStages);
  __syncthreads();
  // D may start once every U block runs: it streams W_down meanwhile and
  // waits for this grid before it reads the hidden
  asm volatile("griddepcontrol.launch_dependents;");

  auto issue = [&](int s) {  // warp 0
    if (s >= nst) return;
    const int e0 = (kb + s) * rows, valid = min(rows, E - e0);  // a multiple of 32
    const uint32_t slot = sbase + (s % kStages) * kSlot, bar = bars + (s % kStages) * 8;
    if (lane == 0) expect_bytes(bar, P * valid * cv + P * (valid / kQK) * cv * 4 + valid * xs);
    __syncwarp();
    for (int p = 0; p < P; ++p) {
      const int8_t* q = (p ? qg : qu) + (r * E + e0) * G + g0;
      const float* sc = (p ? sg : su) + (r * (E / kQK) + e0 / kQK) * G + g0;
      const uint32_t wd = slot + p * rows * ws, sd = slot + kWBytes + p * (rows / kQK) * ws * 4;
      if (whole) {
        if (lane == 0) {
          bulk_copy(wd, q, valid * G, bar);
          bulk_copy(sd, sc, valid / kQK * G * 4, bar);
        }
      } else {
        for (int i = lane; i < valid; i += 32) bulk_copy(wd + i * ws, q + (size_t)i * G, cv, bar);
        for (int i = lane; i < valid / kQK; i += 32)
          bulk_copy(sd + i * ws * 4, sc + (size_t)i * G, cv * 4, bar);
      }
    }
    if (lane == 0)
      bulk_copy(slot + kWBytes + kSBytes,
                static_cast<const uint8_t*>(x) + ((size_t)n * E + e0) * xs, valid * xs, bar);
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  auto compute = [&](int s) {
    const int e0 = (kb + s) * rows;
    if (!cin || e0 + me.rb * kQK >= E) return;
    const uint8_t* slot = smem + (s % kStages) * kSlot;
    const int rr = me.row();
    float v[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) {
      const int e = rr + kShare * j;
      if (XF32)
        v[j] = reinterpret_cast<const float*>(slot + kWBytes + kSBytes)[e];
      else
        v[j] = __uint_as_float(
            (uint32_t)reinterpret_cast<const uint16_t*>(slot + kWBytes + kSBytes)[e] << 16);
    }
    const float* sc = reinterpret_cast<const float*>(slot + kWBytes);
    dot_rows(slot + (me.p * rows + rr) * ws + me.cw * 16, kShare * ws, v,
             sc + (me.p * (rows / kQK) + me.rb) * ws + me.cw * 16, acc);
  };

  // The ring: warp 0 issues stage it + S - 1 into the slot that stage it - 1
  // used (every thread has left it: the barrier closing the last step), all
  // wait for stage it's bytes, sum it, and meet at one barrier a stage.
  if (t < 32)
    for (int s = 0; s < kStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int it = 0; it < nst; ++it) {
    if (t < 32) issue(it + kStages - 1);
    wait_phase(bars + (it % kStages) * 8, (it / kStages) & 1);
    compute(it);
    __syncthreads();
  }

  const float* bsum = block_sums(smem, me, t, acc, P, rows / kUnit, lc);
  // the KS partials added in rank order, then bias, activation and mask
  const uint32_t bb = smem_u32(bsum);
  if (fin) {
    const float4 up4 = cluster_sum4<kMaxSplits>(bb + m * 4, KS);
    const float4 gate4 =
        P == 2 ? cluster_sum4<kMaxSplits>(bb + (tile + m) * 4, KS) : make_float4(0, 0, 0, 0);
    const float ups[4] = {up4.x, up4.y, up4.z, up4.w};
    const float gates[4] = {gate4.x, gate4.y, gate4.z, gate4.w};
    float h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float up = bu ? ups[k] + bu4[k] : ups[k];
      const float mask = mask_scale ? gp4[k] : (gp4[k] >= prob_thr ? 1.0f : 0.0f);
      h[k] = combine(act, fat_thr, gates[k], up) * mask;
    }
    *reinterpret_cast<float4*>(hidden + o) = make_float4(h[0], h[1], h[2], h[3]);
  }
  cluster_hold();
}

// Launch D: out[n, e] over one tile of 16 << lc columns of E. Block kz
// takes stages kb .. kb + nst - 1 of token n's K = C * G rows; a stage holds
// its rows of the tile, their scale rows and their hidden values. Row k is
// row rid[k / G] * G + k % G of Qd, read through the tensor map qmap over
// Qd as (R * G rows, E columns) in boxes of 32 rows and `box` columns: a
// 32-row block of the tile lies in shared memory as tile / box boxes of
// 32 x box bytes.
__global__ void __launch_bounds__(kThreads, 512 / kThreads)
v6q_down(const __grid_constant__ CUtensorMap qmap, const float* __restrict__ hidden,
         const int* __restrict__ idx, const float* __restrict__ sd, float* __restrict__ out,
         int C, int E, int G, int R, int lc, int per, int rem) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int tile = 16 << lc, rows = stage_rows(1, lc);
  const int K = C * G;
  const int KS = gridDim.x, kz = blockIdx.x;
  const int e0 = blockIdx.y * tile, n = blockIdx.z;
  const int kb = kz * per + min(kz, rem), nst = per + (kz < rem);
  const int t = threadIdx.x, lane = t & 31;
  const Item me(t, lc, log2_of(rows / kQK));
  const int cv = min(tile, E - e0);  // columns of the tile inside E
  const bool cin = me.cw * 16 < cv;
  const int lbox = lc + 4 < 8 ? lc + 4 : 8, box = 1 << lbox;  // columns a box
  const int boxes = (cv + box - 1) >> lbox;                    // boxes a 32-row block
  const uint32_t sbase = smem_u32(smem), bars = sbase + kDStages * kSlot;
  int* rid = reinterpret_cast<int*>(smem + kDStages * kSlot + 8 * kDStages);  // token n's rows
  for (int c = t; c < C; c += kThreads) rid[c] = clamp_row(idx[(size_t)n * C + c], R);
  if (t == 0) ring_init(bars, kDStages);
  __syncthreads();

  // (wc, wg): the selection and group row of the next stage's first row
  // (k = wc * G + wg); issue_w takes the stages in order
  int wc = 0, wg = kb * rows;
  while (wg >= G && wc < C) wg -= G, ++wc;
  auto issue_w = [&](int s) {  // warp 0: the boxes and scale rows of stage s
    if (s < nst) {
      const int valid = min(rows, K - (kb + s) * rows);  // a multiple of 32
      const uint32_t slot = sbase + (s % kDStages) * kSlot, bar = bars + (s % kDStages) * 8;
      if (lane == 0)
        expect_bytes(bar, valid * (boxes << lbox) + valid / kQK * cv * 4 + valid * 4);
      __syncwarp();
      for (int j = 0, c = wc, g = wg; j < valid / kQK; ++j) {
        const int row = rid[c] * G + g;  // the first of 32 rows
        if (lane < boxes)
          box_copy(slot + j * kQK * tile + lane * kQK * box, &qmap, e0 + lane * box, row, bar);
        if (lane == 31)
          bulk_copy(slot + kWBytes + j * tile * 4, sd + (size_t)(row / kQK) * E + e0, cv * 4,
                    bar);
        if ((g += kQK) == G) g = 0, ++c;
      }
    }
    for (int a = 0; a < rows; a += kQK)
      if ((wg += kQK) == G) wg = 0, ++wc;
  };
  auto issue_h = [&](int s) {  // lane 0: the hidden values of stage s
    if (s < nst && lane == 0) {
      const int k0 = (kb + s) * rows;
      bulk_copy(sbase + (s % kDStages) * kSlot + kWBytes + kSBytes, hidden + (size_t)n * K + k0,
                min(rows, K - k0) * 4, bars + (s % kDStages) * 8);
    }
  };

  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  auto compute = [&](int s) {
    if (!cin || (kb + s) * rows + me.rb * kQK >= K) return;
    const uint8_t* slot = smem + (s % kDStages) * kSlot;
    const int rr = me.row(), col = me.cw * 16;
    float v[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j)
      v[j] = reinterpret_cast<const float*>(slot + kWBytes + kSBytes)[rr + kShare * j];
    const uint8_t* w =
        slot + me.rb * kQK * tile + (col >> lbox) * kQK * box + me.ru * box + (col & (box - 1));
    dot_rows(w, kShare * box, v,
             reinterpret_cast<const float*>(slot + kWBytes) + me.rb * tile + col, acc);
  };

  // The first stages' W_down while U may still run; their hidden values once
  // U's grid has completed (griddepcontrol.wait); then the ring as in U.
  if (t < 32)
    for (int s = 0; s < kDStages - 1; ++s) issue_w(s);
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (t < 32)
    for (int s = 0; s < kDStages - 1; ++s) issue_h(s);
#pragma unroll 1
  for (int it = 0; it < nst; ++it) {
    if (t < 32) {
      issue_w(it + kDStages - 1);
      issue_h(it + kDStages - 1);
    }
    wait_phase(bars + (it % kDStages) * 8, (it / kDStages) & 1);
    compute(it);
    __syncthreads();
  }

  const float* bsum = block_sums(smem, me, t, acc, 1, rows / kUnit, lc);
  // thread t of block kz writes the group of 4 columns t * KS + kz (a tile
  // has at most 128 groups), the KS partials added in rank order
  const int m = (t * KS + kz) * 4;
  if (m < tile && e0 + m < E)
    *reinterpret_cast<float4*>(out + (size_t)n * E + e0 + m) =
        cluster_sum4<kMaxSplits>(smem_u32(bsum) + m * 4, KS);
  cluster_hold();
}

// ---------------------------------------------------------------------------
// host: the launch shape and the two launches

struct Shape {
  int sms, ulc, dlc, u_smem, d_smem;  // lc: log2 of a tile's 16-column chunks
  const void* up;
  Split u, d;
};

const void* up_kernel(int x_bf16) {
  return x_bf16 ? reinterpret_cast<const void*>(&v6q_up<false>)
                : reinterpret_cast<const void*>(&v6q_up<true>);
}

// The column tile, the least power of two >= width but at most `most`
// columns (narrower tiles would be copied row by row, which the Tensor
// Memory Accelerator serves far slower), and its split.
cudaError_t plan_tile(const void* fn, int smem, int P, int width, int most, bool pow2,
                      int min_blocks, long long tasks, int depth, int sms, int* lc,
                      Split* split) {
  *lc = 1;  // at least 32 columns
  while ((16 << *lc) < width && (16 << *lc) < most) ++*lc;
  const int rows = stage_rows(P, *lc);
  return plan_split(fn, kThreads, smem, kMaxSplits, min_blocks,
                    tasks * ((width + (16 << *lc) - 1) >> (4 + *lc)),
                    (depth + rows - 1) / rows, sms, split, pow2);
}

// the launch shape on the current device, cached by shape
cudaError_t make_shape(int N, int C, int E, int G, int gated, int x_bf16, Shape* sh) {
  struct Entry { int dev, N, C, E, G, key; Shape sh; };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static bool filled[kEntries];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key = (gated ? 1 : 0) | (x_bf16 ? 2 : 0);
  const unsigned h = ((unsigned)dev * 31u + (unsigned)N * 7919u + (unsigned)C * 104729u +
                      (unsigned)E * 1299709u + (unsigned)G * 15485863u + (unsigned)key) % kEntries;
  Entry& e = cache[h];
  if (filled[h] && e.dev == dev && e.N == N && e.C == C && e.E == E && e.G == G &&
      e.key == key) {
    *sh = e.sh;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sh->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  sh->up = up_kernel(x_bf16);
  sh->u_smem = kStages * kSlot + 8 * kStages;
  sh->d_smem = kDStages * kSlot + 8 * kDStages + C * 4;
  err = plan_tile(sh->up, sh->u_smem, gated ? 2 : 1, G, kMaxTile, true, kUMinBlocks,
                  (long long)N * C, E, sh->sms, &sh->ulc, &sh->u);
  if (err != cudaSuccess) return err;
  err = plan_tile(reinterpret_cast<const void*>(&v6q_down), sh->d_smem, 1, E, kMaxDTile, false,
                  kDMinBlocks, N, C * G, sh->sms, &sh->dlc, &sh->d);
  if (err != cudaSuccess) return err;
  e = Entry{dev, N, C, E, G, key, *sh};
  filled[h] = true;
  return cudaSuccess;
}

bool valid(int N, int C, int E, int G, int R) {
  return G % kQK == 0 && E % kQK == 0 && G > 0 && E > 0 && G <= 4096 && N > 0 && C > 0 &&
         R > 0 && N <= 65535 && C <= 65535 && (long long)C * G < (1LL << 30) &&
         (long long)R * G < (1LL << 31) && C <= 8192;
}

}  // namespace

extern "C" {

// f32 words of the scratch the caller allocates for one call: the hidden
// (N, C, G)
long long sparse_ffn_v6q_scratch_floats(int N, int C, int E, int G) {
  (void)E;
  return (long long)N * C * G;
}

const char* sparse_ffn_v6q_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch shape on the current device: out10 = {SMs, U column tile, U
// splits (cluster size), U blocks, U wave ratio x 1e6, D column tile, D
// splits, D blocks, D wave ratio x 1e6, shared bytes a U block}. Returns
// the CUDA error.
int sparse_ffn_v6q_plan(int N, int C, int E, int G, int gated, int x_bf16, long long* out10) {
  if (!valid(N, C, E, G, 1)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  const cudaError_t err = make_shape(N, C, E, G, gated, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[10] = {sh.sms, 16 << sh.ulc, sh.u.ks, sh.u.blocks,
                           (long long)(sh.u.ratio * 1e6), 16 << sh.dlc, sh.d.ks, sh.d.blocks,
                           (long long)(sh.d.ratio * 1e6), sh.u_smem};
  for (int i = 0; i < 10; ++i) out10[i] = v[i];
  return 0;
}

// x (N, E) bf16 (x_bf16 = 1) or f32; idx int32 (N, C); gp, bu f32
// (N, C, G) (bu may be null); qu, qg int8 (R, E, G) with su, sg f32
// (R, E/32, G) (qg, sg null for an ungated activation); qd int8 (R, G, E)
// with sd f32 (R, G/32, E); out f32 (N, E); scratch:
// sparse_ffn_v6q_scratch_floats words. Two launches on the stream (the
// second may start before the first ends and waits for it); returns their
// CUDA error (0 on success); it does not synchronise.
int sparse_ffn_v6q(const void* x, const void* idx, const void* gp, const void* bu,
                   const void* qu, const void* su, const void* qg, const void* sg,
                   const void* qd, const void* sd, void* out, void* scratch, int N, int C,
                   int E, int G, int R, int x_bf16, int act, float fat_thr, float prob_thr,
                   int mask_scale, void* stream) {
  if (!valid(N, C, E, G, R)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  cudaError_t err = make_shape(N, C, E, G, qg != nullptr, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const int* is = static_cast<const int*>(idx);
  const float* gpf = static_cast<const float*>(gp);
  const float* buf = static_cast<const float*>(bu);
  const int8_t *qu8 = static_cast<const int8_t*>(qu), *qg8 = static_cast<const int8_t*>(qg);
  const float *suf = static_cast<const float*>(su), *sgf = static_cast<const float*>(sg),
              *sdf = static_cast<const float*>(sd);
  auto* hidden = static_cast<float*>(scratch);
  const float* hidden_in = hidden;
  auto* o = static_cast<float*>(out);
  int ulc = sh.ulc, ulks = 31 - __builtin_clz(sh.u.ks), uper = sh.u.per, urem = sh.u.rem;
  int dlc = sh.dlc, dper = sh.d.per, drem = sh.d.rem;
  void* up_args[] = {&x,   &is, &gpf, &buf,  &qu8,  &suf, &qg8, &sgf,    &hidden,   &C,
                     &E,   &G,  &R,   &ulc, &ulks, &uper, &urem, &act, &fat_thr, &prob_thr,
                     &mask_scale};
  CUtensorMap qmap;
  // the down store as R * G rows of E int8, in boxes of 32 rows
  err = tensor_map_2d(qd, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, (long long)R * G, E,
                      dlc + 4 < 8 ? 16 << dlc : 256, kQK, &qmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  void* down_args[] = {&qmap, &hidden_in, &is, &sdf, &o, &C, &E, &G, &R, &dlc, &dper, &drem};
  const int gtiles = (G + (16 << ulc) - 1) >> (4 + ulc);
  const int etiles = (E + (16 << dlc) - 1) >> (4 + dlc);
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(dim3(sh.u.ks * gtiles, C, N), kThreads, sh.u_smem,
                                          sh.u.ks, st, attr);
  err = cudaLaunchKernelExC(&cfg, sh.up, up_args);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = cluster_config(dim3(sh.d.ks, etiles, N), kThreads, sh.d_smem, sh.d.ks, st, attr, 1);
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(&v6q_down), down_args);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // extern "C"
