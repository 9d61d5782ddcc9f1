// Predictor-gated sparse FFN over flat (layer, group) weight stores, for
// Hopper (sm_90a): one launch a call.
//
// Replaces the Pallas TPU kernel sparse_ffn_block_v6
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:564, kernel body :522). It
// computes the same function, in f32: for each token n and selection c, with
// r = clamp(idx[n, c], 0, R - 1),
//     up   = x[n] . WuT[r] + bu[n, c]          WuT[r] is (E, G)
//     gate = x[n] . WgT[r]                     (gated activations only)
//     h    = combine(act, gate, up) * mask     mask = gp >= thr, or gp itself
//     out[n] = sum_c h . Wd[r]                 Wd[r] is (G, E)
// Stores are bf16 or f32, x bf16 or f32; up, gate, the hidden and out are
// f32 (the hidden is not rounded before the down product).
//
// What bounds it: the weight bytes. At decode (N = 1) every selected row is
// read once, n_proj * N * C * G * E * sizeof(w) bytes: 3 * 12 * 128 * 4096 * 2
// = 37.7 MB for the ProSparse-Llama-2-7B decode shape, about 11.3 us at the
// H100's 3.35 TB/s. The arithmetic (2 flops per weight) is far below the FMA
// pipe's rate, so plain f32 FMAs suffice; what matters is keeping HBM busy
// on every SM from the first byte to the last, with one fill a call.
//
// Design: one launch, grid (KS, C, N) in clusters of KS blocks (1-16; above
// 8 a non-portable cluster), one cluster per selection (n, c). Block k owns
// columns e0 .. e0 + span of E (a multiple of 8), the same range for both
// products:
//   1. up and gate: rows e0 .. of WuT[r] and WgT[r] (one contiguous span x G
//      block of each) times x[n, e0 ..]: partial up and gate of all G
//      columns, summed over the block's threads in a fixed order.
//   2. Every block stores its partials into every block's gbuf through
//      distributed shared memory (stores, so no remote read is waited for)
//      and arrives at a cluster barrier; after it, every block adds the KS
//      partials in rank order from its own shared memory and forms the same
//      f32 hidden of the G rows itself: bias, activation, mask.
//   3. down: the hidden times columns e0 .. of Wd[r], read through a tensor
//      map over the down store as (R * G, E): the partial out[n, e0 ..] of
//      selection c.
//   4. Selections are added in order by the last block. Each block writes
//      its partial to an f32 workspace (N, C, E) and adds 1 to the counter
//      of (n, k) with a release/acquire atomic; the block that arrives C-th
//      adds the C partials in order c = 0 .. C-1, writes out[n, e0 ..] and
//      sets the counter back to 0 (the pattern of quant_matmul.cu's
//      qmm_decode, with its per-device zeroed counters). No f32 value is
//      added atomically and no sum depends on arrival order, so every run
//      and every graph replay gives the same bits; no block waits for a
//      block outside its cluster.
// Loads: one ring of kSlots slots in shared memory that the Tensor Memory
// Accelerator fills, each completing on its mbarrier. An up/gate stage is
// one bulk copy of rows_u contiguous rows of each projection and one of
// their x values; a down stage is br rows of the span in boxes of up to 512
// bytes a row. W_down's rows depend only on idx, so warp 0 issues the down
// stages right behind the up/gate stages, into the same ring, while the
// cluster's partials are exchanged: HBM stays busy across the boundary and
// only the down products wait for the hidden. Measured on an H100 (scratch
// variants in one process): 2 slots of 40 KB beat 3-4 smaller ones (fewer
// stages, fewer barriers); boxes with rows of 128 or 512 bytes stream
// alike for W_down, but up/gate read as boxes of 128-byte rows (half of G)
// streamed far slower than whole rows, so G is not split.
// Arithmetic: bf16 -> f32 is a shift (load8); products and sums are f32 FMAs.
// Splits: KS per shape from the occupancy query (plan_split). A grid that
// fits in one round is planned as if the busiest SM held as many blocks as
// fit, since the hardware packs clusters onto few SMs (12 clusters of 11
// left 30 SMs idle and 30 with 2 blocks: tools/v6_stamps.py --splits 11),
// so at 7B decode KS = 16 (192 blocks) is taken over 11. A span is at most
// 8 * kThreads columns (one 8-column chunk a thread in the down product).
// Out-of-range row ids are clamped into [0, R), as XLA clamps a gather.
// Requires G and E multiples of 8, G at most 2048, E at most 32768, and
// 16-byte aligned stores and x. The "// stamp:" comments mark the phases
// that tools/v6_stamps.py times in an instrumented copy of this source.

#include "sparse_ffn_cluster.cuh"
#include "sparse_ffn_common.cuh"
#include "sparse_ffn_tma.cuh"

namespace {

constexpr int kThreads = 256;           // 8 warps a block
constexpr int kSlots = 2;               // ring slots: 1 stage in flight while one is summed
constexpr int kSlot = 40 * 1024;        // bytes a slot
constexpr int kGather = 16 * 1024;      // bytes of gbuf, unless the least split needs more
constexpr int kMaxSplits = 16;          // blocks of a cluster
constexpr int kMaxSpan = 8 * kThreads;  // most columns of E a block owns
constexpr int kBoxBytes = 512;          // most bytes of a down box's row
constexpr int kCounters = 1 << 16;      // workspace: one int32 counter per (n, k)

// bytes of gbuf: the KS blocks' partial up (and gate) of G columns
__host__ __device__ __forceinline__ int gather_bytes(int KS, int P, int G) {
  return (KS * P * G * 4 + 127) & ~127;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// The whole call for selection (blockIdx.z, blockIdx.y), split blockIdx.x.
// Block k owns the 8-column units k * per + min(k, rem) .. of E (per + 1 of
// them for k < rem). The stages: up/gate (rows_u whole rows of each
// projection), then down (br rows of Wd[r] as boxes of dbc columns).
// Shared memory: the ring (kSlots x kSlot), gbuf [KS][P][G] (the cluster's
// partial up and gate, which every block stores into every block's gbuf),
// bsum [2][G] (the block's own partials, then the cluster's sums), hid [G]
// (gp, then the hidden), sbu [G] (the up bias), the ring's barriers and
// the flag of the last block.
template <typename W, typename X>
__global__ void __launch_bounds__(kThreads, 2)
v6_ffn(const __grid_constant__ CUtensorMap dmap, const X* __restrict__ x,
       const int* __restrict__ idx, const float* __restrict__ gp, const float* __restrict__ bu,
       const W* __restrict__ wu, const W* __restrict__ wg, float* __restrict__ part,
       int* __restrict__ counters, float* __restrict__ out, int C, int E, int G, int R, int per,
       int rem, int rows_u, int br, int dbc, int act, float fat_thr, float prob_thr,
       int mask_scale) {
  extern __shared__ __align__(128) uint8_t smem[];
  // stamp: start
  constexpr int ws = sizeof(W), xs = sizeof(X);
  const int P = wg ? 2 : 1;
  const int KS = gridDim.x, k = blockIdx.x, c = blockIdx.y, n = blockIdx.z;
  const int nc = n * C + c;
  const int e0 = 8 * (k * per + min(k, rem)), span = 8 * (per + (k < rem));
  const int t = threadIdx.x, lane = t & 31;
  const size_t r = clamp_row(idx[nc], R);
  const int nu = (span + rows_u - 1) / rows_u;          // up/gate stages
  const int nb = (span + dbc - 1) / dbc;                // down boxes a stage
  const int dbox = (br * dbc * ws + 127) & ~127;        // bytes of a down box in a slot
  const int total = nu + (G + br - 1) / br;
  const int ustride = (rows_u * G * ws + 127) & ~127;  // bytes of a projection in a stage
  float4* gbuf = reinterpret_cast<float4*>(smem + kSlots * kSlot);
  float* bsum = reinterpret_cast<float*>(smem + kSlots * kSlot + gather_bytes(KS, P, G));
  float* hid = bsum + 2 * G;
  float* sbu = hid + G;
  int* last = reinterpret_cast<int*>(sbu + G + 2 * kSlots);
  const uint32_t sbase = smem_u32(smem), bars = smem_u32(sbu + G);
  if (t == 0) ring_init(bars, kSlots);
  __syncthreads();

  auto issue = [&](int s) {  // warp 0: stage s into slot s % kSlots
    if (s >= total) return;
    const uint32_t slot = sbase + (s % kSlots) * kSlot, bar = bars + (s % kSlots) * 8;
    if (s < nu) {
      // rows ea .. ea + rows of each projection, and x over the 8-aligned
      // columns xa .. xb around them (16-byte aligned both sides)
      const int ea = e0 + s * rows_u, rows = min(rows_u, e0 + span - ea);
      const int xa = ea & ~7, xb = (ea + rows + 7) & ~7;
      if (lane == 0) {
        expect_bytes(bar, P * rows * G * ws + (xb - xa) * xs);
        bulk_copy(slot, wu + (r * E + ea) * G, rows * G * ws, bar);
        if (wg) bulk_copy(slot + ustride, wg + (r * E + ea) * G, rows * G * ws, bar);
        bulk_copy(slot + P * ustride, x + (size_t)n * E + xa, (xb - xa) * xs, bar);
      }
    } else {
      // rows g0 .. g0 + br of Wd[r], box b over columns e0 + b * dbc ..
      // (the last box may reach past the span and the last stage past row
      // G of Wd[r]: what lies there is not used; past the store's edge the
      // box is zero-filled)
      if (lane == 0) expect_bytes(bar, nb * br * dbc * ws);
      __syncwarp();
      const int row = (int)r * G + (s - nu) * br;
      for (int b = lane; b < nb; b += 32)
        box_copy(slot + b * dbox, &dmap, e0 + b * dbc, row, bar);
    }
  };
  if (t < 32)
    for (int s = 0; s < kSlots; ++s) issue(s);
  cluster_arrive_relaxed();  // this block runs: the others may store into its gbuf

  // gp and the bias of this selection, read while the first stages land
  for (int i = t; i < G; i += kThreads) {
    hid[i] = gp[(size_t)nc * G + i];
    sbu[i] = bu ? bu[(size_t)nc * G + i] : 0.f;
  }

  // up/gate: thread (cu, ru) sums columns 8 cu .. over rows ru, ru + RU, ..;
  // down: thread (cd, rd) sums columns e0 + 8 cd .. over rows rd, rd + RD, ..
  const int cpt = G / 8, RU = kThreads / cpt, ru = t / cpt, cu = t - ru * cpt;
  const int cpd = span / 8, RD = kThreads / cpd, rd = t / cpd, cd = t - rd * cpd;
  const int cpb = dbc / 8;  // 8-column chunks of a down box's row
  float au[8], ag[8], ad[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) au[j] = ag[j] = ad[j] = 0.f;

  // The ring: wait for stage it, sum it, meet at a barrier, and warp 0
  // refills the slot with stage it + kSlots. After the last up/gate stage
  // its slot first takes the block's row sums (before the refill), and the
  // hidden is formed while the first down stages land.
#pragma unroll 1
  for (int it = 0; it < total; ++it) {
    wait_phase(bars + (it % kSlots) * 8, (it / kSlots) & 1);
    // stamp: first_stage if it == 0
    const uint8_t* slot = smem + (it % kSlots) * kSlot;
    if (it < nu) {
      if (ru < RU) {
        const int ea = e0 + it * rows_u, rows = min(rows_u, e0 + span - ea);
        const X* xv = reinterpret_cast<const X*>(slot + P * ustride) + (ea & 7);
        const W* w0 = reinterpret_cast<const W*>(slot) + cu * 8;
#pragma unroll 4
        for (int i = ru; i < rows; i += RU) {
          const float xe = to_f32(xv[i]);
          float w[8];
          load8(w0 + (size_t)i * G, w);
#pragma unroll
          for (int j = 0; j < 8; ++j) au[j] = fmaf(xe, w[j], au[j]);
          if (P == 2) {
            load8(w0 + ustride / ws + (size_t)i * G, w);
#pragma unroll
            for (int j = 0; j < 8; ++j) ag[j] = fmaf(xe, w[j], ag[j]);
          }
        }
      }
    } else if (rd < RD) {
      const int g0 = (it - nu) * br, b = cd / cpb, rows = min(br, G - g0);
      const W* w0 = reinterpret_cast<const W*>(slot + b * dbox) + (cd - b * cpb) * 8;
#pragma unroll 4
      for (int i = rd; i < rows; i += RD) {
        const float h = hid[g0 + i];
        float w[8];
        load8(w0 + i * dbc, w);
#pragma unroll
        for (int j = 0; j < 8; ++j) ad[j] = fmaf(h, w[j], ad[j]);
      }
    }
    __syncthreads();
    if (it == nu - 1) {  // the block's up/gate sums over its row threads, in order
      float* red = reinterpret_cast<float*>(smem + (it % kSlots) * kSlot);  // [RU][P][G]
      if (ru < RU) {
        float* rp = red + (size_t)ru * P * G + cu * 8;
#pragma unroll
        for (int j = 0; j < 8; j += 4) {
          *reinterpret_cast<float4*>(rp + j) = make_float4(au[j], au[j + 1], au[j + 2], au[j + 3]);
          if (P == 2)
            *reinterpret_cast<float4*>(rp + G + j) =
                make_float4(ag[j], ag[j + 1], ag[j + 2], ag[j + 3]);
        }
      }
      __syncthreads();
      for (int m = 4 * t; m < P * G; m += 4 * kThreads) {
        float4 s = *reinterpret_cast<const float4*>(red + m);
        for (int q = 1; q < RU; ++q) {
          const float4 v = *reinterpret_cast<const float4*>(red + (size_t)q * P * G + m);
          s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
        }
        *reinterpret_cast<float4*>(bsum + m) = s;
      }
      __syncthreads();
      // stamp: up_done
      // bsum into slot k of every block's gbuf [KS][P][G] (this one's too)
      cluster_wait();  // every block of the cluster runs
      const int pg4 = P * G / 4;
      for (int i = t; i < KS * pg4; i += kThreads)
        st_cluster4(smem_u32(gbuf + k * pg4 + i % pg4), i / pg4,
                    reinterpret_cast<const float4*>(bsum)[i % pg4]);
      cluster_arrive();  // release: the stores to the cluster
    }
    if (t < 32) issue(it + kSlots);
    if (it == nu - 1) {
      // the hidden: up and gate added over the cluster in rank order, one
      // element a thread, then bias, activation and mask
      cluster_wait();
      // stamp: barrier
      const float* gs = reinterpret_cast<const float*>(gbuf);
      for (int m = t; m < P * G; m += kThreads) {
        float tot = gs[m];
        for (int q = 1; q < KS; ++q) tot += gs[q * P * G + m];
        bsum[m] = tot;
      }
      __syncthreads();
      for (int g = t; g < G; g += kThreads) {
        const float p = hid[g];
        const float mask = mask_scale ? p : (p >= prob_thr ? 1.0f : 0.0f);
        hid[g] = combine(act, fat_thr, P == 2 ? bsum[G + g] : 0.f, bsum[g] + sbu[g]) * mask;
      }
      __syncthreads();
      // stamp: hidden
    }
  }
  // stamp: down_done

  // the block's partial out[n, e0 ..] of selection c, its row threads added
  // in order (the drained ring holds them)
  float* red = reinterpret_cast<float*>(smem);  // [RD][span]
  if (rd < RD) {
    float* rp = red + (size_t)rd * span + cd * 8;
#pragma unroll
    for (int j = 0; j < 8; j += 4)
      *reinterpret_cast<float4*>(rp + j) = make_float4(ad[j], ad[j + 1], ad[j + 2], ad[j + 3]);
  }
  __syncthreads();
  float* dst = (C == 1 ? out + (size_t)n * E : part + (size_t)nc * E) + e0;
  for (int m = 4 * t; m < span; m += 4 * kThreads) {
    float4 s = *reinterpret_cast<const float4*>(red + m);
    for (int q = 1; q < RD; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(red + (size_t)q * span + m);
      s.x += v.x; s.y += v.y; s.z += v.z; s.w += v.w;
    }
    *reinterpret_cast<float4*>(dst + m) = s;
  }

  if (C > 1) {
    // The last block of (n, k) adds the C partials in selection order. The
    // barrier orders the block's partial stores before thread 0's atomic,
    // whose release (cumulative) publishes them and whose acquire lets the
    // last block read everyone's.
    __syncthreads();
    int* counter = counters + (size_t)n * KS + k;
    if (t == 0) {
      int prev;
      asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
                   : "=r"(prev) : "l"(counter) : "memory");
      *last = prev == C - 1;
    }
    __syncthreads();
    if (*last) {
      for (int m = 4 * t; m < span; m += 4 * kThreads) {
        const float* pc = part + (size_t)n * C * E + e0 + m;
        float4 s = make_float4(0, 0, 0, 0);
        for (int c0 = 0; c0 < C; c0 += 16) {  // 16 loads in flight, added in order
          float4 v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u)
            v[u] = c0 + u < C ? __ldcg(reinterpret_cast<const float4*>(pc + (size_t)(c0 + u) * E))
                              : make_float4(0, 0, 0, 0);
#pragma unroll
          for (int u = 0; u < 16; ++u)
            if (c0 + u < C) { s.x += v[u].x; s.y += v[u].y; s.z += v[u].z; s.w += v[u].w; }
        }
        *reinterpret_cast<float4*>(out + (size_t)n * E + e0 + m) = s;
      }
      if (t == 0) *counter = 0;  // ready for the next launch
    }
  }
  // stamp: end
}

// ---------------------------------------------------------------------------
// host: the launch shape and the launch

struct Shape {
  int sms, smem, rows_u, br, dbc;
  const void* fn;
  Split split;
};

const void* kernel_of(int w_bf16, int x_bf16) {
  using B = __nv_bfloat16;
  static const void* const k[2][2] = {
      {reinterpret_cast<const void*>(&v6_ffn<float, float>),
       reinterpret_cast<const void*>(&v6_ffn<float, B>)},
      {reinterpret_cast<const void*>(&v6_ffn<B, float>),
       reinterpret_cast<const void*>(&v6_ffn<B, B>)}};
  return k[w_bf16 ? 1 : 0][x_bf16 ? 1 : 0];
}

// the launch shape on the current device, cached by shape
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
  err = cudaDeviceGetAttribute(&sh->sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int ws = w_bf16 ? 2 : 4, xs = x_bf16 ? 2 : 4, P = gated ? 2 : 1;
  sh->fn = kernel_of(w_bf16, x_bf16);
  // splits: at least enough for spans of kMaxSpan columns, at most what
  // keeps gbuf within kGather bytes (unless the least needs more)
  const int units = E / 8;  // 8-column units of E, split over the cluster
  const int min_ks = (units + kMaxSpan / 8 - 1) / (kMaxSpan / 8);
  const int fit = kGather / (P * G * 4), most = fit > min_ks ? fit : min_ks;
  const int max_ks = most < kMaxSplits ? most : kMaxSplits;
  auto smem_of = [&](int ks) {
    return kSlots * kSlot + gather_bytes(ks, P, G) + 4 * G * 4 + kSlots * 8 + 16;
  };
  err = plan_split(sh->fn, kThreads, smem_of(max_ks), max_ks, 1, (long long)N * C, units, sh->sms,
                   &sh->split, false, min_ks, true);
  if (err != cudaSuccess) return err;
  sh->smem = smem_of(sh->split.ks);
  // an up/gate stage: rows of P projections (each 128-byte aligned) and
  // their x (with 16 values of 8-alignment slack) in one slot
  sh->rows_u = (kSlot - 16 * xs - 16 - P * 128) / (P * G * ws + xs);
  // a down stage: br rows of the widest span in nb boxes of dbc columns
  // (at most kBoxBytes a row) in one slot, the fewest stages that hold G
  // rows, with rows spread evenly over them
  const int span = 8 * ((units + sh->split.ks - 1) / sh->split.ks);
  const int nb = (span * ws + kBoxBytes - 1) / kBoxBytes;
  sh->dbc = 8 * ((span / 8 + nb - 1) / nb);
  int most_rows = (kSlot / nb - 127) / (sh->dbc * ws);
  most_rows = most_rows < 256 ? most_rows : 256;
  const int nd = (G + most_rows - 1) / most_rows;
  sh->br = (G + nd - 1) / nd;
  e = Entry{dev, N, C, E, G, key, *sh};
  filled[h] = true;
  return cudaSuccess;
}

bool valid(int N, int C, int E, int G, int R) {
  return G % 8 == 0 && E % 8 == 0 && G > 0 && E > 0 && G <= 2048 &&
         E <= kMaxSpan * kMaxSplits && N > 0 && C > 0 && R > 0 && N <= 65535 && C <= 65535 &&
         (long long)R * G < (1LL << 31);
}

}  // namespace

extern "C" {

// f32 words of the scratch the caller allocates for one call: the
// selections' partial outputs (N, C, E), none for C = 1
long long sparse_ffn_v6_scratch_floats(int N, int C, int E, int G) {
  (void)G;
  return C > 1 ? (long long)N * C * E : 0;
}

// int32 words of the per-device workspace, allocated zeroed once: the
// counters of (token, split), left at 0 by every call
long long sparse_ffn_v6_workspace_words(void) { return kCounters; }

const char* sparse_ffn_v6_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The launch shape on the current device: out9 = {SMs, splits (cluster
// size), blocks, wave ratio x 1e6, shared bytes a block, rows of an up/gate
// stage, rows of a down stage, stages of the widest block, columns of a
// down box}. Returns the CUDA error.
int sparse_ffn_v6_plan(int N, int C, int E, int G, int gated, int w_bf16, int x_bf16,
                       long long* out9) {
  if (!valid(N, C, E, G, 1)) return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  const cudaError_t err = make_shape(N, C, E, G, gated, w_bf16, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int span = 8 * ((E / 8 + sh.split.ks - 1) / sh.split.ks);
  const long long v[9] = {sh.sms, sh.split.ks, sh.split.blocks, (long long)(sh.split.ratio * 1e6),
                          sh.smem, sh.rows_u, sh.br,
                          (span + sh.rows_u - 1) / sh.rows_u + (G + sh.br - 1) / sh.br, sh.dbc};
  for (int i = 0; i < 9; ++i) out9[i] = v[i];
  return 0;
}

// x (N, E) bf16 (x_bf16 = 1) or f32; idx int32 (N, C); gp, bu f32 (N, C, G)
// (bu may be null); wu, wg (R, E, G) and wd (R, G, E), bf16 (w_bf16 = 1) or
// f32 (wg null for an ungated activation); out f32 (N, E); scratch:
// sparse_ffn_v6_scratch_floats words (may be null for C = 1); counters: the
// device's workspace (sparse_ffn_v6_workspace_words, zeroed before the first
// call; two streams must not run this kernel at once on one device). One
// launch on the stream; returns its CUDA error (0 on success); it does not
// synchronise.
int sparse_ffn_v6(const void* x, const void* idx, const void* gp, const void* bu,
                  const void* wu, const void* wg, const void* wd, void* out, void* scratch,
                  void* counters, int N, int C, int E, int G, int R, int w_bf16, int x_bf16,
                  int act, float fat_thr, float prob_thr, int mask_scale, void* stream) {
  if (!valid(N, C, E, G, R) || (C > 1 && (!scratch || !counters)))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape sh;
  cudaError_t err = make_shape(N, C, E, G, wg != nullptr, w_bf16, x_bf16, &sh);
  if (err != cudaSuccess) return static_cast<int>(err);
  if ((long long)N * sh.split.ks > kCounters) return static_cast<int>(cudaErrorInvalidValue);
  const int ws = w_bf16 ? 2 : 4;
  const CUtensorMapDataType type =
      w_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap dmap;
  err = tensor_map_2d(wd, type, ws, (long long)R * G, E, sh.dbc, sh.br, &dmap);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per = E / 8 / sh.split.ks, rem = E / 8 % sh.split.ks, rows_u = sh.rows_u, br = sh.br,
      dbc = sh.dbc;
  void* args[] = {&dmap, &x, &idx, &gp, &bu, &wu, &wg, &scratch, &counters, &out, &C, &E, &G,
                  &R, &per, &rem, &rows_u, &br, &dbc, &act, &fat_thr, &prob_thr, &mask_scale};
  cudaLaunchAttribute attr[2];
  const cudaLaunchConfig_t cfg = cluster_config(dim3(sh.split.ks, C, N), kThreads, sh.smem,
                                                sh.split.ks, static_cast<cudaStream_t>(stream), attr);
  err = cudaLaunchKernelExC(&cfg, sh.fn, args);
  return static_cast<int>(err == cudaSuccess ? cudaGetLastError() : err);
}

}  // extern "C"
