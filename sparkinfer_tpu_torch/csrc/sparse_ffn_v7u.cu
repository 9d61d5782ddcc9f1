// Cross-token union sparse FFN for batched decode, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v7u
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:1172, kernel body :1122). Each
// group in the batch's union of selected groups is read once for all B
// tokens; a per-(token, union slot) probability masks the groups a token did
// not select. With r = clamp(union[u], 0, R - 1) and flat stores WuT, WgT
// (R, E, G), Wd (R, G, E):
//     up[b, u]   = x[b] . WuT[r] + bu[b, u]        WuT cast to x's dtype first
//     gate[b, u] = x[b] . WgT[r]                   gated activations only
//     h[b, u]    = bf16(combine(act, gate, up) * mask)   mask = gp >= thr, or gp
//     out[b]     = sum_u h[b, u] . bf16(Wd[r])     f32 sums
// The two bf16 roundings and the cast of the up/gate stores to x's dtype are
// the TPU kernel's (:1135, :1144, :1153-1156), rounded to nearest even.
//
// What bounds it: the weight bytes, n_proj * Cu * G * E * sizeof(w), read once
// whatever B is: 3 * 48 * 128 * 4096 * 2 = 151 MB at ProSparse-Llama-2-7B
// widths with Cu = 48, 45 us at 3.35 TB/s. The products are 2 * B flops per
// weight, 1.2 GFLOP at B = 8: 1.2 us on the bf16 tensor cores.
//
// Design: two launches, each a thread-block cluster per output tile whose
// blocks split the reduction and add it in rank order through distributed
// shared memory. No atomics, no f32 partials in device memory, and the same
// bits on every run.
//   U  (v7u_up) grid (KS, Cu * G tiles, token tiles), cluster (KS, 1, 1).
//      Block kz of union row u takes its share of the E rows, in stages of 16
//      rows of the up and gate stores (a G tile of at most 128 columns) and
//      the stage's 16 elements of each token's x. mma.sync.m16n8k16 with the
//      weights as A ("swap AB": M = G columns, by ldmatrix.trans of the (E, G)
//      row-major stage) and the tokens as the n = 8 side, f32 sums in
//      registers; 4 warps own 4 of the 16 (up, gate) m16 tiles each. Then the
//      cluster adds its KS partials in rank order; bias, activation, mask and
//      the bf16 rounding follow, and the hidden (B, Cu, G) is written once
//      as bf16 (98 KB at B = 8).
//   D  (v7u_down) grid (KS, E / 64, token tiles), cluster (KS, 1, 1).
//      out^T (E x B) = Wd^T (E x K) . h^T (K x B), K = Cu * G: block kz of an
//      E tile of 64 columns takes its share of the K rows (row k is row
//      clamp(union[k / G]) * G + k % G of Wd) in stages of 64, ldmatrix.trans
//      of the (K, E) rows as A, the bf16 hidden as B; the cluster adds its
//      splits in rank order and writes out once, f32. D is a programmatic
//      dependent launch: its blocks start while U's last blocks run, stream
//      their first W_down stages, and wait for U's grid (griddepcontrol.wait)
//      only before they read the hidden.
// Weight loads in flight: each stage is copied by cp.async.cg (16 bytes a
// thread, zero-filled past E, G, K or B) into a ring of slots in shared
// memory with one barrier a stage: U 3 slots of 8.5 KB (2 stages ahead,
// 27 KB a block), D 4 slots of 10 KB (3 ahead, 41 KB). Sizing: HBM at
// 3.35 TB/s with about 1 us of latency under load needs 3.35 MB in flight,
// 25 KB an SM; measured on an H100, an SM pulls its share only with 3 or
// more such blocks resident (1.8 blocks an SM reached 1.5 TB/s in all), so
// the rings are kept shallow enough for 5-8 blocks an SM and the splits are
// picked for 3-4 blocks an SM. Deeper rings (4-6 U slots, 6 D slots) and
// TMA bulk copies of single rows measured slower.
// Splits: KS (1-8, a portable cluster) is picked per shape from the
// occupancy query (clusters resident at once) for the least wave ratio, the
// stages the busiest SM streams over an even share (plan_split): 1.03 at
// B <= 8, Cu = 48, E = 4096 (U 384 blocks, D 512) and U 1.03, D 1.13 at
// Cu = 64, E = 5120 (U 512, D 480).
//
// Routes, chosen by dtype:
//   bf16 stores, bf16 x: tensor cores; every product bf16 x bf16, exact in
//     f32 (the batched path over bf16 models);
//   bf16 stores, f32 x: tensor cores, x split into three bf16 terms
//     (hi + mid + lo, exact for normal f32 values) whose three products go
//     into the same f32 sums (JAX multiplies in f32);
//   f32 stores, bf16 x (round_w): each weight rounded to bf16 as its A
//     fragment is built from the f32 stage, then the tensor cores;
//   f32 stores, f32 x: the same tiles, products by f32 FMAs on the CUDA
//     cores (only the f32 tests run it);
//   the down product is bf16 x bf16 on the tensor cores on every route (an
//   f32 Wd is rounded to bf16 as its fragments are built).
// Requires G and E multiples of 8 and 16-byte aligned stores and x.

#include "sparse_ffn_cluster.cuh"
#include "sparse_ffn_common.cuh"

namespace {

constexpr int kThreads = 128;    // 4 warps a block, both launches
constexpr int kUStages = 3;      // U ring slots: 2 stages in flight
constexpr int kDStages = 4;      // D ring slots: 3 stages in flight
constexpr int kMaxSplits = 8;    // blocks of a portable cluster
constexpr int kURows = 16;       // E rows a U stage
constexpr int kDRows = 64;       // K rows a D stage
constexpr int kGTile = 128;      // most G columns of a U block
constexpr int kETile = 64;       // E columns of a D block: 4 warps of 16 columns
constexpr int kMaxTiles = 4;     // m16 tiles a warp owns in U
constexpr int kMinBlocks = 3;    // blocks an SM needs in flight (plan_split)

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
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

// (lo, hi) f32 -> bf16 pair, round to nearest even
__device__ __forceinline__ uint32_t bf16x2_pack(float lo, float hi) {
  uint32_t d;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(d) : "f"(hi), "f"(lo));
  return d;
}

__device__ __forceinline__ float bf_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf_hi(uint32_t v) { return __uint_as_float(v & 0xFFFF0000u); }

// an f32 pair as three bf16 pairs whose sum is the pair (hi + mid + lo)
__device__ __forceinline__ void split3(float a, float b, uint32_t (&s)[3]) {
  s[0] = bf16x2_pack(a, b);
  a -= bf_lo(s[0]);
  b -= bf_hi(s[0]);
  s[1] = bf16x2_pack(a, b);
  s[2] = bf16x2_pack(a - bf_lo(s[1]), b - bf_hi(s[1]));
}

// The A fragment of the m16 x k16 tile whose (k, m) element lies at
// base + k * row + m * sizeof(W) in shared memory (rows are K, columns M):
// ldmatrix.trans for bf16, else f32 values rounded to bf16.
template <bool WF32>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint8_t* base, uint32_t sbase,
                                       int row, int lane) {
  if (!WF32) {
    const int k = ((lane >> 4) << 3) + (lane & 7), m = ((lane >> 3) & 1) << 3;
    ldsm_x4_trans(a, sbase + k * row + m * 2);
  } else {
    const int g = lane >> 2, t = lane & 3;
    auto w = [&](int k, int m) { return *reinterpret_cast<const float*>(base + k * row + m * 4); };
    a[0] = bf16x2_pack(w(2 * t, g), w(2 * t + 1, g));
    a[1] = bf16x2_pack(w(2 * t, g + 8), w(2 * t + 1, g + 8));
    a[2] = bf16x2_pack(w(2 * t + 8, g), w(2 * t + 9, g));
    a[3] = bf16x2_pack(w(2 * t + 8, g + 8), w(2 * t + 9, g + 8));
  }
}

// Shared-memory layout of a U stage: P tiles of kURows x GTW weights, then
// NT x kURows of x; each row padded by 16 bytes so that the 8 rows of an
// ldmatrix, and the 8 tokens of a B fragment, fall on distinct banks. The
// block's sums reuse the ring after the K loop.
struct ULayout {
  int wrow, xoff, xrow, slot, red_row;
  __host__ __device__ ULayout(int P, int GTW, int ws, int xs, int NT)
      : wrow(GTW * ws + 16), xoff(P * kURows * (GTW * ws + 16)), xrow(kURows * xs + 16),
        slot(xoff + NT * (kURows * xs + 16)), red_row(GTW + 4) {}
  __host__ __device__ int smem(int P, int NT) const {
    const int red = P * NT * red_row * 4;
    return kUStages * slot > red ? kUStages * slot : red;
  }
};

// Launch U: hidden[b, u, g] for the G tile and token tile of this cluster.
// WF32: f32 stores; XF32: f32 x. Block kz takes stages kb .. kb + nst - 1.
template <bool WF32, bool XF32, int NT>
__global__ void __launch_bounds__(kThreads)
v7u_up(const void* __restrict__ xv, const int* __restrict__ urows,
       const void* __restrict__ wu, const void* __restrict__ wg,
       const float* __restrict__ gp, const float* __restrict__ bu, int bu_bs,
       __nv_bfloat16* __restrict__ hidden, int B, int Cu, int E, int G, int R, int GTW,
       int per, int rem, int act, float fat_thr, float prob_thr, int mask_scale) {
  constexpr int ws = WF32 ? 4 : 2, xs = XF32 ? 4 : 2, NI = NT / 8, XS = (XF32 && !WF32) ? 3 : 1;
  extern __shared__ __align__(16) uint8_t smem[];
  const int P = wg ? 2 : 1;
  const ULayout ly(P, GTW, ws, xs, NT);
  const int KS = gridDim.x, kz = blockIdx.x;
  const int gtiles = (G + GTW - 1) / GTW;
  const int u = blockIdx.y / gtiles, g0 = (blockIdx.y % gtiles) * GTW;
  const int n0 = blockIdx.z * NT, nn = min(NT, B - n0);
  const int kb = kz * per + min(kz, rem), nst = per + (kz < rem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int mt = GTW / 16, T = P * mt;  // m16 tiles per projection, in all
  const size_t r = clamp_row(urows[u], R);
  const uint32_t sbase = smem_u32(smem);
  // D may start once every U block runs: it streams W_down meanwhile and
  // waits for this grid before it reads the hidden
  asm volatile("griddepcontrol.launch_dependents;");

  // This thread's copies: weight chunk column cw of rows rw + j * (128 / cpr)
  // of each projection, x chunk column cx of tokens nx + j * (128 / cpx),
  // zero-filled past E, G and B.
  const int cpr = GTW * ws / 16, cpx = kURows * xs / 16;
  const int cw = tid & (cpr - 1), rw = tid / cpr, rstep = kThreads / cpr;
  const int gcol = g0 + cw * (16 / ws);
  const bool gin = gcol < G;
  const size_t wofs = ((r * E + (size_t)kb * kURows + rw) * G + gcol) * ws;
  const uint8_t* usrc = static_cast<const uint8_t*>(wu) + wofs;
  const uint8_t* gsrc = static_cast<const uint8_t*>(wg ? wg : wu) + wofs;
  const int cx = tid & (cpx - 1), nx = tid / cpx, nstep = kThreads / cpx;
  const uint8_t* xsrc = static_cast<const uint8_t*>(xv) +
                        ((size_t)(n0 + nx) * E + (size_t)kb * kURows + cx * (16 / xs)) * xs;

  auto issue = [&](int s) {
    if (s < nst) {
      const uint32_t slot = sbase + (s % kUStages) * ly.slot;
      const int e0 = (kb + s) * kURows;
      for (int p = 0; p < P; ++p)
        for (int rr = rw; rr < kURows; rr += rstep) {
          const uint8_t* src = (p ? gsrc : usrc) + ((size_t)s * kURows + rr - rw) * G * ws;
          const bool in = gin && e0 + rr < E;
          cp_async16(slot + (p * kURows + rr) * ly.wrow + cw * 16, in ? src : wu, in ? 16 : 0);
        }
      for (int n = nx; n < NT; n += nstep) {
        const uint8_t* src = xsrc + ((size_t)(n - nx) * E + (size_t)s * kURows) * xs;
        const bool in = n < nn && e0 + cx * (16 / xs) < E;
        cp_async16(slot + ly.xoff + n * ly.xrow + cx * 16, in ? src : xv, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[kMaxTiles][NI][4];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ni][e] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  auto compute = [&](int s) {
    const int so = (s % kUStages) * ly.slot;
    const uint8_t* xsm = smem + so + ly.xoff;
#pragma unroll
    for (int kk = 0; kk < kURows; kk += 16) {
      if (WF32 && XF32) {  // CUDA-core route: f32 FMAs in the mma's layout
#pragma unroll
        for (int i = 0; i < kMaxTiles; ++i) {
          const int j = warp + 4 * i;
          if (j >= T) break;
          const uint8_t* wt = smem + so + ((j / mt) * kURows + kk) * ly.wrow + (j % mt) * 64;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const float* x0 = reinterpret_cast<const float*>(xsm + (ni * 8 + 2 * t) * ly.xrow) + kk;
            const float* x1 = reinterpret_cast<const float*>(reinterpret_cast<const uint8_t*>(x0) + ly.xrow);
#pragma unroll
            for (int k = 0; k < 16; ++k) {
              const float wa = *reinterpret_cast<const float*>(wt + k * ly.wrow + g * 4);
              const float wb = *reinterpret_cast<const float*>(wt + k * ly.wrow + (g + 8) * 4);
              acc[i][ni][0] = fmaf(wa, x0[k], acc[i][ni][0]);
              acc[i][ni][1] = fmaf(wa, x1[k], acc[i][ni][1]);
              acc[i][ni][2] = fmaf(wb, x0[k], acc[i][ni][2]);
              acc[i][ni][3] = fmaf(wb, x1[k], acc[i][ni][3]);
            }
          }
        }
        continue;
      }
      uint32_t b[NI][XS][2];  // token g of n-tile ni, k = 2t, 2t+1 and 2t+8, 2t+9
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint8_t* xr = xsm + (ni * 8 + g) * ly.xrow;
        if (!XF32) {
          b[ni][0][0] = *reinterpret_cast<const uint32_t*>(xr + (kk + 2 * t) * 2);
          b[ni][0][1] = *reinterpret_cast<const uint32_t*>(xr + (kk + 2 * t + 8) * 2);
        } else {
          const float2 v0 = *reinterpret_cast<const float2*>(xr + (kk + 2 * t) * 4);
          const float2 v1 = *reinterpret_cast<const float2*>(xr + (kk + 2 * t + 8) * 4);
          uint32_t s0[3], s1[3];
          split3(v0.x, v0.y, s0);
          split3(v1.x, v1.y, s1);
#pragma unroll
          for (int q = 0; q < XS; ++q) { b[ni][q][0] = s0[q]; b[ni][q][1] = s1[q]; }
        }
      }
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        const int j = warp + 4 * i;
        if (j >= T) break;
        const int off = so + ((j / mt) * kURows + kk) * ly.wrow + (j % mt) * 16 * ws;
        uint32_t a[4];
        a_frag<WF32>(a, smem + off, sbase + off, ly.wrow, lane);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int q = 0; q < XS; ++q) mma_bf16(acc[i][ni], a, b[ni][q][0], b[ni][q][1]);
      }
    }
  };

  // The ring: stage it is waited for, then stage it + S - 1 is issued into
  // the slot that stage it - 1 used, then stage it is multiplied; one block
  // barrier a stage.
#pragma unroll 1
  for (int s = 0; s < kUStages - 1; ++s) issue(s);
#pragma unroll 1
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<kUStages - 2>();
    __syncthreads();
    issue(it + kUStages - 1);
    compute(it);
  }
  cp_async_wait<0>();
  __syncthreads();

  // the block's (P, NT, GTW) sums into its shared memory: acc[i][ni] rows
  // g, g + 8 of m16 tile j are columns, its columns 2t, 2t + 1 tokens
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int j = warp + 4 * i;
    if (j >= T) break;
    float* rp = red + (j / mt) * NT * ly.red_row + (j % mt) * 16 + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = ni * 8 + 2 * t;
      rp[n * ly.red_row] = acc[i][ni][0];
      rp[(n + 1) * ly.red_row] = acc[i][ni][1];
      rp[n * ly.red_row + 8] = acc[i][ni][2];
      rp[(n + 1) * ly.red_row + 8] = acc[i][ni][3];
    }
  }
  cluster_sync();
  // block kz finishes groups of 4 columns kz * 128 + tid, then every KS *
  // 128th (G and the tile are multiples of 8): the KS partials added in rank
  // order, then bias, activation, mask and the bf16 rounding
  const int gw4 = min(GTW, G - g0) / 4;
  const uint32_t rbase = smem_u32(red);
#pragma unroll 1
  for (int i = kz * kThreads + tid; i < nn * gw4; i += KS * kThreads) {
    const int n = i / gw4, m = (i - n * gw4) * 4;
    const uint32_t at = rbase + (n * ly.red_row + m) * 4;
    const float4 up4 = cluster_sum4<kMaxSplits>(at, KS);
    const float4 gate4 = P == 2 ? cluster_sum4<kMaxSplits>(at + NT * ly.red_row * 4, KS)
                                : make_float4(0, 0, 0, 0);
    const float ups[4] = {up4.x, up4.y, up4.z, up4.w};
    const float gates[4] = {gate4.x, gate4.y, gate4.z, gate4.w};
    const size_t bug = ((size_t)(n0 + n) * Cu + u) * G + g0 + m;
    const float* bup = bu ? bu + (size_t)(n0 + n) * bu_bs + (size_t)u * G + g0 + m : nullptr;
    float h[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float up = bup ? ups[q] + bup[q] : ups[q];
      const float p = gp[bug + q];
      const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
      h[q] = combine(act, fat_thr, gates[q], up) * mask;
    }
    *reinterpret_cast<uint2*>(hidden + bug) = make_uint2(bf16x2_pack(h[0], h[1]),
                                                        bf16x2_pack(h[2], h[3]));
  }
  cluster_sync();  // every block's sums stay until all are read
}

// Shared-memory layout of a D stage: kDRows x kETile weights, then NT x
// kDRows of the bf16 hidden, each row padded by 16 bytes.
struct DLayout {
  int arow, hoff, hrow, slot, red_row;
  __host__ __device__ DLayout(int ws, int NT)
      : arow(kETile * ws + 16), hoff(kDRows * (kETile * ws + 16)), hrow(kDRows * 2 + 16),
        slot(kDRows * (kETile * ws + 16) + NT * (kDRows * 2 + 16)), red_row(kETile + 4) {}
  __host__ __device__ int smem(int NT) const {
    const int red = NT * red_row * 4;
    return kDStages * slot > red ? kDStages * slot : red;
  }
};

// Launch D: out[b, e] for the E tile and token tile of this cluster; warp w
// owns the E columns of m16 tiles w, w + 4, ... Block kz takes K stages kb ..
// kb + nst - 1.
template <bool WF32, int NT>
__global__ void __launch_bounds__(kThreads)
v7u_down(const __nv_bfloat16* __restrict__ hidden, const int* __restrict__ urows,
         const void* __restrict__ wd, float* __restrict__ out, int B, int Cu, int E, int G,
         int R, int per, int rem) {
  constexpr int ws = WF32 ? 4 : 2, NI = NT / 8;
  extern __shared__ __align__(16) uint8_t smem[];
  const DLayout ly(ws, NT);
  const int K = Cu * G;
  const int KS = gridDim.x, kz = blockIdx.x;
  const int e0 = blockIdx.y * kETile, n0 = blockIdx.z * NT, nn = min(NT, B - n0);
  const int kb = kz * per + min(kz, rem), nst = per + (kz < rem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const uint32_t sbase = smem_u32(smem);
  const uint8_t* w8 = static_cast<const uint8_t*>(wd);

  // this thread's copies: weight chunk column cw of rows rw + j * rstep,
  // hidden chunk column ch of tokens nh + j * (128 / cph), zero-filled past
  // E, K and B
  constexpr int cpr = kETile * ws / 16, rstep = kThreads / cpr;
  const int cw = tid & (cpr - 1), rw = tid / cpr;
  const int ecol = e0 + cw * (16 / ws);
  const bool ein = ecol < E;
  constexpr int cph = kDRows * 2 / 16;
  const int ch = tid & (cph - 1), nh = tid / cph;

  // the stage's W_down rows, then its hidden rows (uncommitted)
  auto issue_w = [&](int s) {
    if (s < nst) {
      const uint32_t slot = sbase + (s % kDStages) * ly.slot;
      const int k0 = (kb + s) * kDRows;
      for (int rr = rw; rr < kDRows; rr += rstep) {
        const int k = k0 + rr;
        const bool in = ein && k < K;
        const uint8_t* src = w8;
        if (in) {
          const int uu = k / G;
          src = w8 + (((size_t)clamp_row(urows[uu], R) * G + (k - uu * G)) * E + ecol) * ws;
        }
        cp_async16(slot + rr * ly.arow + cw * 16, src, in ? 16 : 0);
      }
    }
  };
  auto issue_h = [&](int s) {
    if (s < nst) {
      const uint32_t slot = sbase + (s % kDStages) * ly.slot;
      const int k0 = (kb + s) * kDRows;
      for (int n = nh; n < NT; n += kThreads / cph) {
        const int k = k0 + ch * 8;
        const bool in = n < nn && k < K;
        cp_async16(slot + ly.hoff + n * ly.hrow + ch * 16,
                   in ? hidden + (size_t)(n0 + n) * K + k : hidden, in ? 16 : 0);
      }
    }
  };

  constexpr int MD = kETile / 64;  // m16 tiles a warp: columns (warp + 4 i) * 16
  float acc[MD][NI][4];
#pragma unroll
  for (int i = 0; i < MD; ++i)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][ni][e] = 0.f;

  const int g = lane >> 2, t = lane & 3;
  auto compute = [&](int s) {
    const int so = (s % kDStages) * ly.slot;
#pragma unroll
    for (int kk = 0; kk < kDRows; kk += 16) {
      uint32_t b[NI][2];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const uint8_t* hr = smem + so + ly.hoff + (ni * 8 + g) * ly.hrow;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(hr + (kk + 2 * t) * 2);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(hr + (kk + 2 * t + 8) * 2);
      }
#pragma unroll
      for (int i = 0; i < MD; ++i) {
        const int off = so + kk * ly.arow + (warp + 4 * i) * 16 * ws;
        uint32_t a[4];
        a_frag<WF32>(a, smem + off, sbase + off, ly.arow, lane);
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) mma_bf16(acc[i][ni], a, b[ni][0], b[ni][1]);
      }
    }
  };

  // The first stages' W_down while U may still run; then, after U's grid
  // has completed (griddepcontrol.wait), their hidden rows. Commit groups:
  // W 0 .. S-2, H 0 .. S-2, then one group a stage, so stage it is group
  // S - 1 + it throughout and S - 2 groups may stay pending.
#pragma unroll 1
  for (int s = 0; s < kDStages - 1; ++s) {
    issue_w(s);
    cp_async_commit();
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll 1
  for (int s = 0; s < kDStages - 1; ++s) {
    issue_h(s);
    cp_async_commit();
  }
#pragma unroll 1
  for (int it = 0; it < nst; ++it) {
    cp_async_wait<kDStages - 2>();
    __syncthreads();
    issue_w(it + kDStages - 1);
    issue_h(it + kDStages - 1);
    cp_async_commit();
    compute(it);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* red = reinterpret_cast<float*>(smem);  // [NT][red_row]
#pragma unroll
  for (int i = 0; i < MD; ++i) {
    const int m = (warp + 4 * i) * 16 + g;
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = ni * 8 + 2 * t;
      red[n * ly.red_row + m] = acc[i][ni][0];
      red[(n + 1) * ly.red_row + m] = acc[i][ni][1];
      red[n * ly.red_row + m + 8] = acc[i][ni][2];
      red[(n + 1) * ly.red_row + m + 8] = acc[i][ni][3];
    }
  }
  cluster_sync();
  const int ew4 = min(kETile, E - e0) / 4;  // groups of 4 columns (E % 8 == 0)
  const uint32_t rbase = smem_u32(red);
#pragma unroll 1
  for (int i = kz * kThreads + tid; i < nn * ew4; i += KS * kThreads) {
    const int n = i / ew4, c = (i - n * ew4) * 4;
    *reinterpret_cast<float4*>(out + (size_t)(n0 + n) * E + e0 + c) =
        cluster_sum4<kMaxSplits>(rbase + (n * ly.red_row + c) * 4, KS);
  }
  cluster_sync();
}

// ---------------------------------------------------------------------------
// host: the launch shape and the two launches

template <bool WF32, bool XF32, int NT>
const void* up_fn() { return reinterpret_cast<const void*>(&v7u_up<WF32, XF32, NT>); }
template <bool WF32, int NT>
const void* down_fn() { return reinterpret_cast<const void*>(&v7u_down<WF32, NT>); }

constexpr int kTokenTiles[] = {8, 16, 32};  // tokens a block: B <= 8, <= 16, else 32

int token_tile_index(int B) { return B <= 8 ? 0 : (B <= 16 ? 1 : 2); }

// the kernels of (f32 stores, f32 x, token tile index)
const void* up_kernel(int wf32, int xf32, int ti) {
  static const void* const k[2][2][3] = {
      {{up_fn<false, false, 8>(), up_fn<false, false, 16>(), up_fn<false, false, 32>()},
       {up_fn<false, true, 8>(), up_fn<false, true, 16>(), up_fn<false, true, 32>()}},
      {{up_fn<true, false, 8>(), up_fn<true, false, 16>(), up_fn<true, false, 32>()},
       {up_fn<true, true, 8>(), up_fn<true, true, 16>(), up_fn<true, true, 32>()}}};
  return k[wf32][xf32][ti];
}

const void* down_kernel(int wf32, int ti) {
  static const void* const k[2][3] = {{down_fn<false, 8>(), down_fn<false, 16>(), down_fn<false, 32>()},
                                      {down_fn<true, 8>(), down_fn<true, 16>(), down_fn<true, 32>()}};
  return k[wf32][ti];
}

struct Shape {
  int gtw, ti, gtiles, ttiles, u_smem, d_smem, sms;
  const void* up;
  const void* down;
  Split u, d;
};

int gtile_width(int G) {
  int w = 16;
  while (w < G && w < kGTile) w *= 2;
  return w;
}

// the launch shape on the current device, cached by shape
cudaError_t make_shape(int B, int Cu, int E, int G, int w_bf16, int x_bf16, int gated,
                       Shape* sh) {
  struct Entry { int dev, B, Cu, E, G, key; Shape sh; };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static bool filled[kEntries];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key = (w_bf16 ? 1 : 0) | (x_bf16 ? 2 : 0) | (gated ? 4 : 0);
  const unsigned h = ((unsigned)dev * 31u + (unsigned)B * 7919u + (unsigned)Cu * 104729u +
                      (unsigned)E * 1299709u + (unsigned)G * 15485863u + (unsigned)key) % kEntries;
  Entry& e = cache[h];
  if (filled[h] && e.dev == dev && e.B == B && e.Cu == Cu && e.E == E && e.G == G &&
      e.key == key) {
    *sh = e.sh;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&sh->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ws = w_bf16 ? 2 : 4, xs = x_bf16 ? 2 : 4, P = gated ? 2 : 1;
  sh->gtw = gtile_width(G);
  sh->ti = token_tile_index(B);
  const int nt = kTokenTiles[sh->ti];
  sh->gtiles = (G + sh->gtw - 1) / sh->gtw;
  sh->ttiles = (B + nt - 1) / nt;
  sh->u_smem = ULayout(P, sh->gtw, ws, xs, nt).smem(P, nt);
  sh->d_smem = DLayout(ws, nt).smem(nt);
  sh->up = up_kernel(!w_bf16, !x_bf16, sh->ti);
  sh->down = down_kernel(!w_bf16, sh->ti);
  err = plan_split(sh->up, kThreads, sh->u_smem, kMaxSplits, kMinBlocks,
                   (long long)Cu * sh->gtiles * sh->ttiles, (E + kURows - 1) / kURows, sh->sms,
                   &sh->u);
  if (err != cudaSuccess) return err;
  const long long K = (long long)Cu * G;
  err = plan_split(sh->down, kThreads, sh->d_smem, kMaxSplits, kMinBlocks,
                   (long long)((E + kETile - 1) / kETile) * sh->ttiles,
                   (int)((K + kDRows - 1) / kDRows), sh->sms, &sh->d);
  if (err != cudaSuccess) return err;
  e = Entry{dev, B, Cu, E, G, key, *sh};
  filled[h] = true;
  return cudaSuccess;
}

bool valid(int B, int Cu, int E, int G, int R) {
  return G % 8 == 0 && E % 8 == 0 && B > 0 && Cu > 0 && E > 0 && G > 0 && R > 0 &&
         (long long)Cu * G < (1LL << 30) && Cu <= 65535 / ((G + kGTile - 1) / kGTile);
}

}  // namespace

extern "C" {

// f32 words of the scratch the caller allocates for one call: the bf16
// hidden (B, Cu, G)
long long sparse_ffn_v7u_scratch_floats(int B, int Cu, int E, int G) {
  (void)E;
  return ((long long)B * Cu * G + 1) / 2;
}

const char* sparse_ffn_v7u_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch shape on the current device: out10 = {SMs, G tile, token tile,
// U splits (cluster size), U blocks, U wave ratio x 1e6, D splits, D blocks,
// D wave ratio x 1e6, U shared bytes a block}. Returns the CUDA error.
int sparse_ffn_v7u_plan(int B, int Cu, int E, int G, int w_bf16, int x_bf16, int gated,
                        long long* out10) {
  if (!valid(B, Cu, E, G, 1)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  const cudaError_t err = make_shape(B, Cu, E, G, w_bf16, x_bf16, gated, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long v[10] = {sh.sms, sh.gtw, kTokenTiles[sh.ti], sh.u.ks, sh.u.blocks,
                           (long long)(sh.u.ratio * 1e6), sh.d.ks, sh.d.blocks,
                           (long long)(sh.d.ratio * 1e6), sh.u_smem};
  for (int i = 0; i < 10; ++i) out10[i] = v[i];
  return 0;
}

// x (B, E) bf16 (x_bf16 = 1) or f32; union_rows int32 (Cu,); gp f32
// (B, Cu, G); bu f32 with (Cu, G) contiguous and bu_bs elements between
// tokens (0: one row for all), or null; wu, wg (R, E, G) and wd (R, G, E)
// in __nv_bfloat16 (w_bf16 = 1) or float, wg null for an ungated
// activation; out f32 (B, E); scratch: sparse_ffn_v7u_scratch_floats words.
// Two launches on the stream (the second may start before the first ends
// and waits for it); returns their CUDA error (0 on success); it does not
// synchronise.
int sparse_ffn_v7u(const void* x, const void* union_rows, const void* gp, const void* bu,
                   const void* wu, const void* wg, const void* wd, void* out, void* scratch,
                   int B, int Cu, int E, int G, int R, int w_bf16, int x_bf16, int act,
                   int bu_bs, float fat_thr, float prob_thr, int mask_scale, void* stream) {
  if (!valid(B, Cu, E, G, R)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  cudaError_t err = make_shape(B, Cu, E, G, w_bf16, x_bf16, wg != nullptr, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto st = static_cast<cudaStream_t>(stream);
  const int* urows = static_cast<const int*>(union_rows);
  const float* gpf = static_cast<const float*>(gp);
  const float* buf = static_cast<const float*>(bu);
  auto* hidden = static_cast<__nv_bfloat16*>(scratch);
  const __nv_bfloat16* hidden_in = hidden;
  auto* o = static_cast<float*>(out);
  int gtw = sh.gtw, uper = sh.u.per, urem = sh.u.rem, dper = sh.d.per, drem = sh.d.rem;
  void* up_args[] = {&x, &urows, &wu, &wg, &gpf, &buf, &bu_bs, &hidden, &B, &Cu, &E, &G, &R,
                     &gtw, &uper, &urem, &act, &fat_thr, &prob_thr, &mask_scale};
  void* down_args[] = {&hidden_in, &urows, &wd, &o, &B, &Cu, &E, &G, &R, &dper, &drem};
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg = cluster_config(dim3(sh.u.ks, Cu * sh.gtiles, sh.ttiles), kThreads,
                                          sh.u_smem, sh.u.ks, st, attr);
  err = cudaLaunchKernelExC(&cfg, sh.up, up_args);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg = cluster_config(dim3(sh.d.ks, (E + kETile - 1) / kETile, sh.ttiles), kThreads,
                       sh.d_smem, sh.d.ks, st, attr, 1);
  err = cudaLaunchKernelExC(&cfg, sh.down, down_args);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // extern "C"
