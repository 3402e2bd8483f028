// How the kernels of the fused pipeline read an error state (and dgc
// mode's momentum): fp32 as it is, or bf16 widened to fp32 in registers
// (exact), as the reference's ef_dtype="bfloat16" stores it; and the gated
// variants' input masking under elastic participation. Shared by sweep1.cu
// (B1) and sketch_parts.cu (B3).
#pragma once

#include <cuda_bf16.h>

#include "compress_common.cuh"

namespace compress {

// fp32 x rounded to bf16 and widened back
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ void round_bf16(float4& g) {
  g.x = round_bf16(g.x);
  g.y = round_bf16(g.y);
  g.z = round_bf16(g.z);
  g.w = round_bf16(g.w);
}

// How the error state (and dgc mode's momentum) is read: fp32 as it is, or
// bf16 widened to fp32 (exact).
template <typename S>
struct StateRead;

template <>
struct StateRead<float> {
  static constexpr bool BF16 = false;
  // the 4 elements at 4 * i of p
  static __device__ __forceinline__ float4 load4(const float* p,
                                                  long long i) {
    return __ldcs(reinterpret_cast<const float4*>(p) + i);
  }
  static __device__ __forceinline__ float load1(const float* p,
                                                long long e) {
    return p[e];
  }
};

template <>
struct StateRead<__nv_bfloat16> {
  static constexpr bool BF16 = true;
  static __device__ __forceinline__ float4 load4(const __nv_bfloat16* p,
                                                  long long i) {
    // four bf16 in 8 bytes; the lower half-word is the lower element
    const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p) + i);
    return make_float4(__uint_as_float(u.x << 16),
                       __uint_as_float(u.x & 0xffff0000u),
                       __uint_as_float(u.y << 16),
                       __uint_as_float(u.y & 0xffff0000u));
  }
  static __device__ __forceinline__ float load1(const __nv_bfloat16* p,
                                                long long e) {
    return __bfloat162float(p[e]);
  }
};

// the gated variants' input masking: g_eff = p ? g : 0 and err_eff = p ?
// err : decay * err (one rounding), in place; with a bf16 state the
// decayed error is rounded back to bf16
template <bool BF16>
__device__ __forceinline__ void mask_inputs(bool p, float decay, float& g,
                                            float& e) {
  g = p ? g : 0.0f;
  if (!p) {
    e = __fmul_rn(decay, e);
    if constexpr (BF16) e = round_bf16(e);
  }
}

template <bool BF16>
__device__ __forceinline__ void mask_inputs(bool p, float decay, float4& g,
                                            float4& e) {
  mask_inputs<BF16>(p, decay, g.x, e.x);
  mask_inputs<BF16>(p, decay, g.y, e.y);
  mask_inputs<BF16>(p, decay, g.z, e.z);
  mask_inputs<BF16>(p, decay, g.w, e.w);
}

}  // namespace compress
