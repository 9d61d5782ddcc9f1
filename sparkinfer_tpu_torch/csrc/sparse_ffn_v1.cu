// Predictor-gated sparse FFN over neuron-row weight stores, for Hopper
// (sm_90a): one strided kernel for five TPU kernels, one launch a call.
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
// the TPU's DMA engine is scheduled to fetch it, so one kernel serves all
// five: projection p of row r, neuron g starts at element
// off_p + r * row_stride + g * E of its store:
//   v1, v3, v5  three pointers, row_stride G*E, every offset 0;
//   v4          one pointer,    row_stride P*G*E, offsets 0, G*E, (P-1)*G*E;
//   v2          one pointer,    row_stride G*E, offsets 0, R*G*E, (P-1)*R*G*E.
// For each token n and selection c, with r = clamp(idx[n, c], 0, R - 1):
//     up   = x[n] . Wu[r, g, :] + bu[n, c, g]     f32 sums of exact products
//     gate = x[n] . Wg[r, g, :] + bg[n, c, g]     gated activations only
//     h    = combine(act, gate, up) * mask        mask = gp >= thr, or gp
//     h    = h rounded to the store dtype         (every one of them: :105,
//                                                  :289, :430, :874, :1026)
//     out[n] = sum_c sum_g h[g] * Wd[r, g, :]     f32
// The gate bias bg is v1's alone (the others pass null). x is bf16 or f32.
//
// What bounds it: the weight bytes, n_proj * N * C * G * E * sizeof(w) when
// every token reads its own rows: 3 * 12 * 128 * 4096 * 2 = 37.7 MB for the
// ProSparse-Llama-2-7B decode shape at N = 1, about 11.3 us at 3.35 TB/s.
// Two flops per weight: far below the FMA pipe's rate, so plain f32 FMAs on
// the CUDA cores suffice; what matters is keeping HBM busy on every SM from
// the first byte to the last, with one fill a call.
//
// Design: one launch of a grid sized to the card: the clusters of KS blocks
// (1-16; above 8 a non-portable cluster) resident at once, m of them to
// each token. Token n's C * G neuron rows, selection by selection, are one
// flat list, split evenly over its m * KS blocks, so that every block
// streams the same bytes whatever N and C are (a block's rows may end one
// selection and start the next). In every layout a run of neuron rows of
// one projection of one selection is one contiguous block, so each load is
// one bulk copy (two where a stage crosses into the next selection):
//   1. One ring of kSlots slots in shared memory that the Tensor Memory
//      Accelerator fills (cp.async.bulk, completing on the slot's mbarrier).
//      The stages, in turn for chunks of 16 / P rows: the chunk's up (and
//      gate) rows, rows_u rows of each projection a stage, then its down
//      rows, P * rows_u a stage. A ninth warp only loads: it refills each
//      slot as soon as the eight compute warps have arrived on the slot's
//      "empty" barrier, so no block-wide barrier is met a stage and the
//      loads never wait for the hidden (W_down's addresses depend only on
//      idx).
//   2. Each thread owns fixed 8-column chunks of E and keeps them of x[n] in
//      registers. Up/gate: each thread adds its columns' partial dots of the
//      chunk's rows in registers; after the chunk's last up/gate stage they
//      are summed over the block in a fixed order (one recursive-halving
//      reduction of all 16 over the warp, then the warps in order), and the
//      hidden of each row (bias, activation, mask, rounding to the store
//      dtype) goes to shared memory. Down: each thread adds
//      h[g] * Wd[r, g, its columns] in registers, rows in order.
//   3. The cluster's partial outputs are pushed, not pulled: block k stores
//      slice j of its partial out (E split in 8-column units) into block j's
//      receive buffer through distributed shared memory (st.async, each
//      store completing its bytes on block j's receive barrier, so no block
//      waits for its own stores), and block j adds the KS slices in rank
//      order once all have landed.
//   4. A token's m clusters are added in order by the last block, as
//      sparse_ffn_v6.cu adds its selections: block j writes its slice to an
//      f32 workspace (N, m, E) and adds 1 to the counter of (n, j) with a
//      release/acquire atomic; the block that arrives m-th adds the m
//      partials in order, writes out[n, slice j] and sets the counter back
//      to 0. For m = 1 the slice goes to out directly. No f32 value is added
//      atomically and no sum depends on arrival order or on where a block
//      runs, so every run and every graph replay gives the same bits.
// The grid: KS and m per shape from the occupancy query and a model of the
// call's time (make_shape), cached by shape. Out-of-range row ids are
// clamped into [0, R), as XLA clamps a gather (for v2 that keeps a row
// inside its own projection).
// Requires E a multiple of 8 and at most 8192, N at most 4096, 16-byte
// aligned x and stores, and offsets and row_stride multiples of 8. The
// "// stamp:" comments mark the phases that tools/v1_stamps.py times in an
// instrumented copy of this source.

#include "sparse_ffn_cluster.cuh"
#include "sparse_ffn_common.cuh"
#include "sparse_ffn_tma.cuh"

namespace {

constexpr int kConsumers = 256;             // 8 warps that compute
constexpr int kWarps = kConsumers / 32;
constexpr int kThreads = kConsumers + 32;   // and one that loads
constexpr int kSlots = 2;                   // ring slots
constexpr int kSlot = 40 * 1024;            // most bytes of a stage, unless one row needs more
constexpr int kMaxQ = 4;                    // most 8-column chunks of E a thread owns
constexpr int kMaxE = 8 * kConsumers * kMaxQ;  // 8192
constexpr int kMaxRowsU = 4;                // most rows of each projection in an up/gate stage
constexpr int kDots = 16;                   // partial dots a thread holds: P x the rows of a chunk
constexpr int kMaxRows = 1024;              // most neuron rows a block owns
constexpr int kMaxSplits = 16;              // blocks of a cluster
constexpr int kCounters = 1 << 16;          // workspace: one int32 counter per (n, k)

template <typename T> __device__ __forceinline__ float to_store(float v);
template <> __device__ __forceinline__ float to_store<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_store<__nv_bfloat16>(float v) {
  return round_bf16(v);
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Byte offsets of the shared-memory regions: the ring [kSlots][slot], the
// receive buffer [KS][slen][8] f32 (a slice of E in 8-column units from each
// block), gp/bu/bg [3][rows4] f32 of the block's rows, the clamped row ids
// of the selections the block's rows fall in [sels], the chunk's hidden
// [kDots] and dot sums of each warp [kWarps][kDots], the ring's barriers
// (full, then empty), the barrier of the receive buffer and the last flag.
struct Layout {
  int recv, rows, sels, hid, red, bars, last, total;
};

__host__ __device__ __forceinline__ Layout layout_of(int slot, int KS, int slen, int rmax,
                                                     int sels) {
  Layout l;
  l.recv = kSlots * slot;
  l.rows = l.recv + KS * slen * 32;
  l.sels = l.rows + 12 * ((rmax + 3) & ~3);
  l.hid = l.sels + 4 * ((sels + 3) & ~3);
  l.red = l.hid + kDots * 4;
  l.bars = l.red + kWarps * kDots * 4;
  l.last = l.bars + 16 * kSlots + 8;
  l.total = l.last + 16;
  return l;
}

// Selections a run of rmax flat rows can touch: one more than it fills.
__host__ __device__ __forceinline__ int sels_of(int rmax, int G, int C) {
  const int s = cdiv(rmax - 1, G) + 1;
  return s < C ? s : C;
}

// Stage s of a block of nr rows, read in chunks of kc = kDots / P rows: the
// chunk's up/gate stages (rows_u rows of each projection, fewer in the
// last), then its down stages (P * rows_u rows, fewer in the last). c: the
// chunk's first row; last: the chunk's last up/gate stage.
struct Stage {
  int down, a, rows, c, last;
};

__device__ __forceinline__ Stage stage_of(int s, int nr, int P, int rows_u) {
  const int kc = kDots / P, per = cdiv(kc, rows_u) + cdiv(kc, P * rows_u);
  const int i = s / per, w = s - i * per, c = i * kc, cr = min(kc, nr - c);
  const int nu = cdiv(cr, rows_u);
  if (w < nu)
    return Stage{0, c + w * rows_u, min(rows_u, cr - w * rows_u), c, w == nu - 1};
  const int d = (w - nu) * P * rows_u;
  return Stage{1, c + d, min(P * rows_u, cr - d), c, 0};
}

__host__ __device__ __forceinline__ int stages_of(int nr, int P, int rows_u) {
  const int kc = kDots / P, per = cdiv(kc, rows_u) + cdiv(kc, P * rows_u);
  const int nch = cdiv(nr, kc), cr = nr - (nch - 1) * kc;
  return (nch - 1) * per + cdiv(cr, rows_u) + cdiv(cr, P * rows_u);
}

// barrier of the compute warps alone (named barrier 1)
__device__ __forceinline__ void compute_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

// Block (k, s, n): rank k of cluster s of token n's gridDim.y clusters; it
// owns flat rows r0 .. r0 + nr of the token's C * G. Warps 0-7 compute, each
// thread owning NQ 8-column chunks of E (2 up to E = 4096, else 4); warp 8
// loads.
template <typename W, typename X, int NQ>
__global__ void __launch_bounds__(kThreads, NQ == 2 ? 2 : 1)
v1_ffn(const X* __restrict__ x, const int* __restrict__ idx, const float* __restrict__ gp,
       const float* __restrict__ bu, const float* __restrict__ bg, const W* __restrict__ wu,
       const W* __restrict__ wg, const W* __restrict__ wd, float* __restrict__ part,
       int* __restrict__ counters, float* __restrict__ out, int C, int E, int G, int R,
       long long row_stride, int rows_u, int slot, int act, float fat_thr, float prob_thr,
       int mask_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  // stamp: start
  constexpr int ws = sizeof(W);
  const int P = wg ? 2 : 1;
  const int KS = gridDim.x, k = blockIdx.x, m = gridDim.y, cl = blockIdx.y, n = blockIdx.z;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // this block's flat rows, and the cluster's slices of E in 8-column units
  const int K = C * G, S = m * KS, b = cl * KS + k;
  const int rper = K / S, rrem = K % S;
  const int r0 = b * rper + min(b, rrem), nr = rper + (b < rrem), rmax = rper + (rrem > 0);
  const int units = E / 8, sper = units / KS, srem = units % KS, slen = sper + (srem > 0);
  const int my = sper + (k < srem), e0 = 8 * (k * sper + min(k, srem));  // this block's slice
  const int c0 = r0 / G, nsel = (r0 + nr - 1) / G - c0 + 1;
  const Layout L = layout_of(slot, KS, slen, rmax, sels_of(rmax, G, C));
  float* recv = reinterpret_cast<float*>(smem + L.recv);
  const int rows4 = (rmax + 3) & ~3;
  float* sgp = reinterpret_cast<float*>(smem + L.rows);
  float* sbu = sgp + rows4;
  float* sbg = sbu + rows4;
  int* srow = reinterpret_cast<int*>(smem + L.sels);
  float* hid = reinterpret_cast<float*>(smem + L.hid);
  float* red = reinterpret_cast<float*>(smem + L.red);  // [kWarps][kDots]
  int* last = reinterpret_cast<int*>(smem + L.last);
  // barriers: full[kSlots] (the landed bytes), empty[kSlots] (the compute
  // warps done with the slot), the receive buffer's (the cluster's slices)
  const uint32_t sbase = smem_u32(smem), full = smem_u32(smem + L.bars);
  const uint32_t empty = full + 8 * kSlots, rbar = empty + 8 * kSlots;
  if (t == 0) {
    ring_init(full, kSlots);
    ring_init(empty, kSlots, kWarps);
    ring_init(rbar, 1);
    expect_bytes(rbar, KS * my * 32);  // every block's 8 floats a unit of this slice
  }
  __syncthreads();
  cluster_arrive_relaxed();  // this block runs: the others may store into its recv

  const int total = stages_of(nr, P, rows_u);
  const int pbytes = rows_u * E * ws;  // bytes of one projection in an up/gate stage
  float acc[NQ][8];
  if (warp == kWarps) {
    // The loading warp: the row ids of the selections this block's rows
    // fall in, then stage s into slot s % kSlots once the compute warps are
    // done with the stage before it there. Rows r0 + a .. r0 + a + rows of
    // one projection are one bulk copy a selection they fall in.
    if (lane == 0) {
      for (int i = 0; i < nsel; ++i) srow[i] = clamp_row(idx[(size_t)n * C + c0 + i], R);
      auto copy_rows = [&](uint32_t dst, const W* w, int a, int rows, uint32_t bar) {
        for (int f = r0 + a, end = r0 + a + rows; f < end;) {
          const int c = f / G, g = f - c * G, len = min(end - f, G - g);
          bulk_copy(dst, w + (size_t)srow[c - c0] * row_stride + (size_t)g * E, len * E * ws,
                    bar);
          dst += len * E * ws;
          f += len;
        }
      };
      for (int s = 0; s < total; ++s) {
        if (s >= kSlots) wait_phase(empty + (s % kSlots) * 8, (s / kSlots - 1) & 1);
        const Stage st = stage_of(s, nr, P, rows_u);
        const uint32_t dst = sbase + (s % kSlots) * slot, bar = full + (s % kSlots) * 8;
        expect_bytes(bar, (st.down ? 1 : P) * st.rows * E * ws);
        if (st.down) {
          copy_rows(dst, wd, st.a, st.rows, bar);
        } else {
          copy_rows(dst, wu, st.a, st.rows, bar);
          if (P == 2) copy_rows(dst + pbytes, wg, st.a, st.rows, bar);
        }
      }
    }
  } else {
    // gp and the biases of this block's rows (read first at the first
    // chunk's sums, after a barrier of the compute warps), and x[n] at this
    // thread's chunks q = t, t + kConsumers, ..
    for (int i = t; i < nr; i += kConsumers) {
      const size_t kk = (size_t)n * K + r0 + i;
      sgp[i] = gp[kk];
      sbu[i] = bu ? bu[kk] : 0.f;
      sbg[i] = bg && P == 2 ? bg[kk] : 0.f;
    }
    float xr[NQ][8];
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int q = t + i * kConsumers;
      if (q < units) {
        load8(x + (size_t)n * E + 8 * q, xr[i]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) xr[i][j] = 0.f;
      }
    }
    // dots[p * kc + j]: this thread's partial dot of projection p, row j of
    // the current chunk; acc: its columns of the partial out
    const int kc = kDots / P;
    float dots[kDots];
#pragma unroll
    for (int v = 0; v < kDots; ++v) dots[v] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    // The ring: wait for stage it, use it, and tell the loading warp.
#pragma unroll 1
    for (int it = 0; it < total; ++it) {
      const Stage st = stage_of(it, nr, P, rows_u);
      wait_phase(full + (it % kSlots) * 8, (it / kSlots) & 1);
      // stamp: first_stage if it == 0
      const uint8_t* sl = smem + (it % kSlots) * slot;
      if (!st.down) {
        // up/gate: this thread's partial dots of the staged rows
        const int j0 = st.a - st.c;
#pragma unroll
        for (int v = 0; v < kDots; ++v) {
          const int p = v >= kc, j = v - p * kc;
          if (p < P && j >= j0 && j < j0 + st.rows) {
            const W* w = reinterpret_cast<const W*>(sl + p * pbytes) + (size_t)(j - j0) * E;
            float s = dots[v];
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
              const int q = t + qq * kConsumers;
              if (q < units) {
                float wv[8];
                load8(w + 8 * q, wv);
#pragma unroll
                for (int e = 0; e < 8; ++e) s = fmaf(xr[qq][e], wv[e], s);
              }
            }
            dots[v] = s;
          }
        }
        __syncwarp();
        if (lane == 0) arrive(empty + (it % kSlots) * 8);
        if (st.last) {
          // The chunk's dots summed over the compute warps: over the warp
          // by recursive halving (16 shuffles; lane l ends with the sum of
          // dot l >> 1 over its warp), then the warps in order; then the
          // hidden of each row: bias, activation, mask, rounding.
          float h8[8], h4[4], h2[2];
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const bool hi = lane & 16;
            h8[i] = (hi ? dots[8 + i] : dots[i]) +
                    __shfl_xor_sync(0xffffffffu, hi ? dots[i] : dots[8 + i], 16);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const bool hi = lane & 8;
            h4[i] = (hi ? h8[4 + i] : h8[i]) +
                    __shfl_xor_sync(0xffffffffu, hi ? h8[i] : h8[4 + i], 8);
          }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const bool hi = lane & 4;
            h2[i] = (hi ? h4[2 + i] : h4[i]) +
                    __shfl_xor_sync(0xffffffffu, hi ? h4[i] : h4[2 + i], 4);
          }
          const bool hi = lane & 2;
          float h1 = (hi ? h2[1] : h2[0]) + __shfl_xor_sync(0xffffffffu, hi ? h2[0] : h2[1], 2);
          h1 += __shfl_xor_sync(0xffffffffu, h1, 1);
          if (!(lane & 1)) red[warp * kDots + (lane >> 1)] = h1;
          compute_sync();
          if (t < min(kc, nr - st.c)) {
            float up = 0.f, gate = 0.f;
            for (int w = 0; w < kWarps; ++w) {
              up += red[w * kDots + t];
              if (P == 2) gate += red[w * kDots + kc + t];
            }
            const int i = st.c + t;
            const float p = sgp[i];
            const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
            hid[t] = to_store<W>(
                combine(act, fat_thr, P == 2 ? gate + sbg[i] : 0.f, up + sbu[i]) * mask);
          }
#pragma unroll
          for (int v = 0; v < kDots; ++v) dots[v] = 0.f;
          compute_sync();  // the hidden is in
        }
      } else {
        // down: this thread's columns of h[g] * Wd[r, g, :], rows in order
        const W* w0 = reinterpret_cast<const W*>(sl);
        const float* h = hid + (st.a - st.c);
#pragma unroll 2
        for (int i = 0; i < st.rows; ++i) {
          const W* w = w0 + (size_t)i * E;
#pragma unroll
          for (int qq = 0; qq < NQ; ++qq) {
            const int q = t + qq * kConsumers;
            if (q < units) {
              float wv[8];
              load8(w + 8 * q, wv);
#pragma unroll
              for (int e = 0; e < 8; ++e) acc[qq][e] = fmaf(h[i], wv[e], acc[qq][e]);
            }
          }
        }
        __syncwarp();
        if (lane == 0) arrive(empty + (it % kSlots) * 8);
      }
    }
    // stamp: streamed
  }

  // slice j of this block's partial out into block j's recv[k], each store
  // completing its bytes on block j's receive barrier
  __syncwarp();
  cluster_wait();  // every block of the cluster runs
  if (warp < kWarps) {
#pragma unroll
    for (int qq = 0; qq < NQ; ++qq) {
      const int q = t + qq * kConsumers;
      if (q < units) {
        const int big = srem * (sper + 1);  // units of the first srem slices
        const int j = q < big ? q / (sper + 1) : srem + (q - big) / sper;
        const int u = q - (j * sper + min(j, srem));
        const uint32_t a = smem_u32(recv + ((size_t)k * slen + u) * 8);
        st_async4(a, rbar, j, make_float4(acc[qq][0], acc[qq][1], acc[qq][2], acc[qq][3]));
        st_async4(a + 16, rbar, j, make_float4(acc[qq][4], acc[qq][5], acc[qq][6], acc[qq][7]));
      }
    }
  }

  // this block's slice: the KS partials added in rank order, once all landed
  if (my == 0) return;  // E has fewer 8-column units than the cluster blocks
  wait_phase(rbar, 0);
  // stamp: received
  float* dst = (m == 1 ? out + (size_t)n * E : part + ((size_t)n * m + cl) * E) + e0;
  for (int i = t; i < 2 * my; i += kThreads) {
    float4 s = reinterpret_cast<const float4*>(recv)[i];
    for (int q = 1; q < KS; ++q) {
      const float4 v = reinterpret_cast<const float4*>(recv + (size_t)q * slen * 8)[i];
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    reinterpret_cast<float4*>(dst)[i] = s;
  }
  // stamp: slice

  if (m > 1) {
    // The last block of (n, k) adds the token's m partials in cluster
    // order. The barrier orders the block's partial stores before thread
    // 0's atomic, whose release (cumulative) publishes them and whose
    // acquire lets the last block read everyone's.
    __syncthreads();
    int* counter = counters + (size_t)n * KS + k;
    if (t == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                   : "=r"(prev) : "l"(counter) : "memory");
      *last = prev == m - 1;
    }
    __syncthreads();
    if (*last) {
      for (int i = t; i < 2 * my; i += kThreads) {
        const float* pc = part + (size_t)n * m * E + e0 + 4 * i;
        float4 s = make_float4(0, 0, 0, 0);
        for (int q0 = 0; q0 < m; q0 += 16) {  // 16 loads in flight, added in order
          float4 v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            v[u] = q0 + u < m ? __ldcg(reinterpret_cast<const float4*>(pc + (size_t)(q0 + u) * E))
                              : make_float4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (q0 + u < m) { s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w; }
        }
        reinterpret_cast<float4*>(out + (size_t)n * E + e0)[i] = s;
      }
      if (t == 0) *counter = 0;  // ready for the next launch
      // stamp: summed
    }
  }
}

// ---------------------------------------------------------------------------
// host: the launch shape and the launch

struct Shape {
  int sms, smem, rows_u, slot, ks, m;
  float ratio;
  const void* fn;
};

const void* kernel_of(int w_bf16, int x_bf16, int nq) {
  using B = __nv_bfloat16;
  static const void* const k[2][2][2] = {
      {{reinterpret_cast<const void*>(&v1_ffn<float, float, 2>),
        reinterpret_cast<const void*>(&v1_ffn<float, B, 2>)},
       {reinterpret_cast<const void*>(&v1_ffn<B, float, 2>),
        reinterpret_cast<const void*>(&v1_ffn<B, B, 2>)}},
      {{reinterpret_cast<const void*>(&v1_ffn<float, float, 4>),
        reinterpret_cast<const void*>(&v1_ffn<float, B, 4>)},
       {reinterpret_cast<const void*>(&v1_ffn<B, float, 4>),
        reinterpret_cast<const void*>(&v1_ffn<B, B, 4>)}}};
  return k[nq > 2 ? 1 : 0][w_bf16 ? 1 : 0][x_bf16 ? 1 : 0];
}

// The launch shape on the current device, cached by shape. The grid: for
// each cluster size ks (16 down to 1), the clusters resident at once (the
// occupancy query) shared among the tokens, m to each (at least one, at
// most one row a block, at most kMaxRows rows a block), and the time that
// grid is estimated to take: its weight bytes at the card's streaming rate
// or the busiest block's bytes at one block's rate, whichever is longer
// (over its rounds), plus the last block's read of its token's m partial
// slices. The least wins, a tie the larger ks. ratio: the busiest block's
// rows over an even share of the N * C * G rows among the blocks.
// The rates are fitted to this kernel's times on an H100 at the 7B decode
// rows (N = 1, 4 and 8, every cluster size): the card streams about 2.8
// TB/s, one block about 18 GB/s (two 32 KB stages in flight), and a last
// block reads the partials at about 50 GB/s.
constexpr double kCardRate = 2.8e12, kBlockRate = 18e9, kSumRate = 50e9;

cudaError_t make_shape(int N, int C, int E, int G, int gated, int w_bf16, int x_bf16, Shape* sh) {
  struct Entry { int dev, N, C, E, G, key; Shape sh; };
  constexpr int kEntries = 256;
  static Entry cache[kEntries];
  static bool filled[kEntries];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const int key = (gated ? 1 : 0) | (w_bf16 ? 2 : 0) | (x_bf16 ? 4 : 0);
  const unsigned h = ((unsigned)dev * 31u + (unsigned)N * 7919u + (unsigned)C * 104729u +
                      (unsigned)E * 1299709u + (unsigned)G * 15485863u + (unsigned)key) % kEntries;
  Entry& e = cache[h];
  if (filled[h] && e.dev == dev && e.N == N && e.C == C && e.E == E && e.G == G &&
      e.key == key) {
    *sh = e.sh;
    return cudaSuccess;
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ws = w_bf16 ? 2 : 4, P = gated ? 2 : 1, K = C * G;
  const void* fn = kernel_of(w_bf16, x_bf16, cdiv(E / 8, kConsumers));
  // an up/gate stage: rows_u whole rows of each projection, as many as fit
  // in kSlot bytes (at least one); a down stage holds P * rows_u rows
  int rows_u = kSlot / (P * E * ws);
  rows_u = rows_u < 1 ? 1 : (rows_u > kMaxRowsU ? kMaxRowsU : rows_u);
  // shared bytes: planned for blocks of kMaxRows rows, launched for the rows
  // a block of the grid owns
  auto smem_of = [&](int ks, int rmax) {
    const int ru = rows_u < rmax ? rows_u : rmax;
    return layout_of(P * ru * E * ws, ks, cdiv(E / 8, ks), rmax, sels_of(rmax, G, C)).total;
  };
  const double row_bytes = (double)(P + 1) * E * ws;
  Shape best{};
  double best_t = 0;
  for (int ks = (K < kMaxSplits ? K : kMaxSplits); ks >= 1; --ks) {
    int most = 0;
    err = max_clusters(fn, kThreads, smem_of(ks, kMaxRows), ks, &most);
    if (err != cudaSuccess) return err;
    if (most <= 0) continue;
    long long m = most / N;
    const long long need = cdiv(K, ks * kMaxRows);
    m = m > need ? m : need;
    m = m < K / ks ? m : K / ks;
    m = m < 65535 ? m : 65535;
    const long long rounds = (N * m + most - 1) / most;
    const int rmax = cdiv(K, (int)m * ks);
    const double stream = fmax((double)N * K * row_bytes / kCardRate,
                               (double)rounds * rmax * row_bytes / kBlockRate);
    const double time = stream + (m > 1 ? (double)m * 4 * cdiv(E / 8, ks) * 8 / kSumRate : 0.0);
    if (best.ks == 0 || time < best_t * 0.999) {
      best_t = time;
      best = Shape{sms, smem_of(ks, rmax), rows_u < rmax ? rows_u : rmax, 0, ks, (int)m,
                   (float)((double)rmax * m * ks / K), fn};
      best.slot = P * best.rows_u * E * ws;
    }
  }
  if (best.ks == 0) return cudaErrorInvalidConfiguration;
  *sh = best;
  e = Entry{dev, N, C, E, G, key, *sh};
  filled[h] = true;
  return cudaSuccess;
}

bool valid(int N, int C, int E, int G, int R) {
  return E % 8 == 0 && E > 0 && E <= kMaxE && G > 0 && N > 0 && C > 0 && R > 0 && N <= 65535 &&
         (long long)N * kMaxSplits <= kCounters && (long long)C * G < (1LL << 31) / kMaxSplits;
}

template <typename T>
const T* at(const void* base, long long off) {
  return base ? static_cast<const T*>(base) + off : nullptr;
}

}  // namespace

extern "C" {

// f32 words of the scratch the caller allocates for one call: each token's
// partial outputs of its m clusters (N, m, E), none for m = 1; 0 where the
// shape is refused (the launch reports why)
long long sparse_ffn_v1_scratch_floats(int N, int C, int E, int G, int gated, int w_bf16,
                                       int x_bf16) {
  Shape sh;
  if (!valid(N, C, E, G, 1) || make_shape(N, C, E, G, gated, w_bf16, x_bf16, &sh) != cudaSuccess)
    return 0;
  return sh.m > 1 ? (long long)N * sh.m * E : 0;
}

// int32 words of the per-device workspace, allocated zeroed once: the
// counters of (token, split), left at 0 by every call
long long sparse_ffn_v1_workspace_words(void) { return kCounters; }

const char* sparse_ffn_v1_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch shape on the current device: out9 = {SMs, splits (cluster
// size), clusters a token, blocks, wave ratio x 1e6, shared bytes a block,
// rows of each projection in an up/gate stage, rows of a down stage,
// stages of the widest block}. Returns the CUDA error.
int sparse_ffn_v1_plan(int N, int C, int E, int G, int gated, int w_bf16, int x_bf16,
                       long long* out9) {
  if (!valid(N, C, E, G, 1)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  const cudaError_t err = make_shape(N, C, E, G, gated, w_bf16, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = gated ? 2 : 1, rmax = cdiv(C * G, sh.m * sh.ks);
  const long long v[9] = {sh.sms, sh.ks, sh.m, (long long)N * sh.m * sh.ks,
                          (long long)(sh.ratio * 1e6), sh.smem, sh.rows_u, P * sh.rows_u,
                          stages_of(rmax, P, sh.rows_u)};
  for (int i = 0; i < 9; ++i) out9[i] = v[i];
  return 0;
}

// x (N, E) bf16 (x_bf16 = 1) or f32; idx int32 (N, C); gp, bu, bg f32
// (N, C, G), bu and bg may be null; wu, wg, wd the up, gate and down stores
// in __nv_bfloat16 (w_bf16 = 1) or float, wg null where the gate is not
// read; they may be one pointer. Neuron g of row r of projection p starts at
// element off_p + r * row_stride + g * E of its store. out f32 (N, E);
// scratch: sparse_ffn_v1_scratch_floats words (may be null where that is
// 0); counters: the device's workspace (sparse_ffn_v1_workspace_words,
// zeroed before the first call; two streams must not run this kernel at
// once on one device). Requires E a multiple of 8 and at most 8192, 16-byte
// aligned x and stores, offsets and row_stride multiples of 8. One launch
// on the stream; returns its CUDA error (0 on success); it does not
// synchronise.
int sparse_ffn_v1(const void* x, const void* idx, const void* gp, const void* bu,
                  const void* bg, const void* wu, const void* wg, const void* wd, void* out,
                  void* scratch, void* counters, int N, int C, int E, int G, int R, int w_bf16,
                  int x_bf16, int act, long long row_stride, long long off_u, long long off_g,
                  long long off_d, float fat_thr, float prob_thr, int mask_scale, void* stream) {
  if (!valid(N, C, E, G, R) || row_stride % 8 != 0 || off_u % 8 != 0 || off_g % 8 != 0 ||
      off_d % 8 != 0 || row_stride < (long long)G * E || off_u < 0 || off_g < 0 || off_d < 0 ||
      !counters)
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  cudaError_t err = make_shape(N, C, E, G, wg != nullptr, w_bf16, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (sh.m > 1 && !scratch) return static_cast<int>(cudaErrorInvalidValue);
  const void *pu, *pg, *pd;
  if (w_bf16) {
    pu = at<__nv_bfloat16>(wu, off_u), pg = at<__nv_bfloat16>(wg, off_g);
    pd = at<__nv_bfloat16>(wd, off_d);
  } else {
    pu = at<float>(wu, off_u), pg = at<float>(wg, off_g), pd = at<float>(wd, off_d);
  }
  int rows_u = sh.rows_u, slot = sh.slot;
  void* args[] = {&x, &idx, &gp, &bu, &bg, &pu, &pg, &pd, &scratch, &counters, &out, &C, &E,
                  &G, &R, &row_stride, &rows_u, &slot, &act, &fat_thr, &prob_thr, &mask_scale};
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(sh.ks, sh.m, N), kThreads, sh.smem, sh.ks,
                                                static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelExC(&cfg, sh.fn, args);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // extern "C"
