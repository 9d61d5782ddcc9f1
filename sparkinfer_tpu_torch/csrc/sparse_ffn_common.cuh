// Device helpers shared by the sparse FFN kernels (sparse_ffn_v1.cu,
// sparse_ffn_v6.cu, sparse_ffn_v6q.cu, sparse_ffn_v7u.cu): 16-byte loads of
// 8 weights, the row clamp, the activations of the TPU kernels' `_combine`
// (sparkinfer_tpu/ops/sparse_ffn_pallas.py:41-58) and the rounding to bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Act { kFatrelu = 0, kDrelu = 1, kRelu = 2, kSilu = 3, kGelu = 4, kSwigluOai = 5 };

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// round-to-nearest-even to bf16 and back, as torch's .to(torch.bfloat16)
// and XLA's astype(bfloat16) round
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ int clamp_row(int r, int R) {
  return r < 0 ? 0 : (r >= R ? R - 1 : r);
}

__device__ __forceinline__ float combine(int act, float thr, float gate,
                                         float up) {
  switch (act) {
    case kFatrelu: return (gate > thr ? gate : 0.0f) * up;
    case kDrelu: return fmaxf(gate, 0.0f) * fmaxf(up, 0.0f);
    case kRelu: return fmaxf(up, 0.0f);
    case kSilu: return gate / (1.0f + expf(-gate)) * up;
    case kSwigluOai: {  // gpt-oss clamped swiglu (ggml_swiglu_oai)
      const float g = fminf(gate, 7.0f);
      const float u = fminf(fmaxf(up, -7.0f), 7.0f);
      return g / (1.0f + expf(-1.702f * g)) * (u + 1.0f);
    }
    default: {  // kGelu, tanh approximation as jax.nn.gelu(approximate=True)
      const float k = 0.7978845608028654f;  // sqrt(2 / pi)
      const float t = tanhf(k * (gate + 0.044715f * gate * gate * gate));
      return 0.5f * gate * (1.0f + t) * up;
    }
  }
}

}  // namespace
