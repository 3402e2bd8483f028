// The dense reference-layout REGTOP-k passes, hand-written for Hopper
// (sm_90a). Replaces the TPU kernels of src/repro/kernels/fused_ef/kernel.py:
//
//   scores (_scores_kernel, launcher scores_pallas), for every element
//     a     = err + g
//     delta = s_prev * (g_agg - omega * a_prev) / safe(omega * a)
//             + Q * (1 - s_prev)
//     score = a * tanh(|1 + delta| / mu)
//   apply (_apply_kernel, launcher apply_pallas)
//     ghat = mask * a,   err' = a - ghat
//
// scores also has a bf16 read (scores_bf16_launch) for the reference's
// ef_dtype="bfloat16": err, a_prev, g_agg and s_prev are bf16, g fp32. The
// reference computes this chain in bf16 jnp operations, and its compiled
// CPU program rounds the fp32 result of every one of them to bf16 (read
// from the compiled HLO: a convert pair after each op, none elided), with
// its Python constants rounded to bf16 first (omega, Q and the 1e-12 of
// the safe divisor) and the division by mu a multiply by the fp32
// reciprocal of bf16(mu). The kernel rounds at each of those points; a is
// written as bf16 and the score as fp32 (each a bf16 value).
//
// Bound: device-memory bytes. scores reads five fp32 J-vectors and writes
// two (28 B per element, 24.98 GB at J = 892,032,000, 7.46 ms at the H100
// SXM's 3.35 TB/s), its bf16 read g (4 B), four bf16 vectors (8 B) and
// writes a bf16 a and the fp32 score (6 B: 18 B, 16.06 GB, 4.79 ms);
// apply reads two and writes two (16 B, 4.26 ms). About
// 40 fp32 operations per element (the tanh's two polynomials, one
// division, the posterior) stay far below the 67 TFLOP/s of the card.
//
// Design. The TPU grid walks 4096-element rows in order; here a
// persistent grid-stride loop walks float4 groups (16-byte loads and
// stores, streamed past L1 with __ldcs/__stcs) and a scalar loop takes the
// ragged tail, so any J is served without padding. The result must equal
// the reference's compiled program bit for bit, so nothing is contracted
// that the compiled program keeps apart: every add, multiply and the
// division are the _rn intrinsics (nvcc would otherwise fuse a*b + c into
// an FMA), the division is IEEE (__fdiv_rn), and 1/mu arrives as the fp32
// reciprocal the compiled reference multiplies by. Where the compiled
// program does fuse, so does the kernel, with __fmaf_rn: g_agg - omega *
// a_prev (the factor fp32(-omega)), and the multiply-adds of XLA's fp32
// tanh (the clamped 13/6 rational polynomial); the plain PyTorch version
// forms them in fp64 products (see repro_torch.core.numerics).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace fused_ef {
namespace {

constexpr int THREADS = 256;

// fp32 constants, written as the exact values numerics.py rounds to
constexpr float TINY = 0x1.197998p-40f;           // f32(1e-12)
constexpr float TINY_BF16 = 0x1.1ap-40f;          // bf16(1e-12)
constexpr float TANH_CLAMP = 0x1.ffec88p+2f;      // 7.99881172180175781
constexpr float TANH_SMALL = 0x1.a36e2ep-12f;     // f32(0.0004)
constexpr float N0 = -0x1.3e4b8p-52f, N1 = 0x1.c266fcp-43f,
                N2 = -0x1.7a6ffep-34f, N3 = 0x1.b80082p-25f,
                N4 = 0x1.f28694p-17f, N5 = 0x1.4e1bdap-11f,
                N6 = 0x1.40b3b8p-8f;
constexpr float D0 = 0x1.41a7bp-20f, D1 = 0x1.f12bacp-14f,
                D2 = 0x1.29540ap-9f, D3 = 0x1.40b3bap-8f;

// XLA's fp32 tanh; the clamp passes NaN through like jnp.clip
__device__ __forceinline__ float tanh_xla(float x) {
  const float xc = x < -TANH_CLAMP ? -TANH_CLAMP
                                   : (x > TANH_CLAMP ? TANH_CLAMP : x);
  const float x2 = __fmul_rn(xc, xc);
  float num = N0;
  num = __fmaf_rn(x2, num, N1);
  num = __fmaf_rn(x2, num, N2);
  num = __fmaf_rn(x2, num, N3);
  num = __fmaf_rn(x2, num, N4);
  num = __fmaf_rn(x2, num, N5);
  num = __fmaf_rn(x2, num, N6);
  num = __fmul_rn(xc, num);
  float den = D0;
  den = __fmaf_rn(x2, den, D1);
  den = __fmaf_rn(x2, den, D2);
  den = __fmaf_rn(x2, den, D3);
  return fabsf(x) < TANH_SMALL ? x : __fdiv_rn(num, den);
}

// where(|d| > tiny, d, sign(d) * tiny + tiny), sign(+-0) = +-0
__device__ __forceinline__ float safe_denom(float d) {
  if (fabsf(d) > TINY) return d;
  const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);
  return __fadd_rn(__fmul_rn(s, TINY), TINY);
}

struct Scalars {
  float omega, rmu, q;   // omega, fp32 1/mu, Q
};

__device__ __forceinline__ float score_one(float g, float e, float ap,
                                           float ga, float sp,
                                           const Scalars& c, float* a_out) {
  const float a = __fadd_rn(e, g);
  const float safe = safe_denom(__fmul_rn(c.omega, a));
  // ga - omega * ap is one fused multiply-add in the compiled reference
  const float sent = __fdiv_rn(__fmaf_rn(-c.omega, ap, ga), safe);
  const float delta = __fadd_rn(__fmul_rn(sp, sent),
                                __fmul_rn(c.q, __fsub_rn(1.0f, sp)));
  const float reg = tanh_xla(__fmul_rn(fabsf(__fadd_rn(1.0f, delta)), c.rmu));
  *a_out = a;
  return __fmul_rn(a, reg);
}

// fp32 x rounded to bf16 and widened back: one bf16 operation
__device__ __forceinline__ float rb(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// the score chain on bf16 operands, each operation rounded to bf16 (c:
// omega and Q as bf16 values, rmu the fp32 reciprocal of bf16(mu)); g is
// rounded to bf16 first, as the reference casts it
__device__ __forceinline__ float score_one_bf16(float g, float e, float ap,
                                                float ga, float sp,
                                                const Scalars& c,
                                                float* a_out) {
  const float a = rb(__fadd_rn(e, rb(g)));
  const float d = rb(__fmul_rn(c.omega, a));
  float safe = d;
  if (!(fabsf(d) > TINY_BF16)) {
    const float s = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : d);
    safe = rb(__fadd_rn(rb(__fmul_rn(s, TINY_BF16)), TINY_BF16));
  }
  const float num = rb(__fsub_rn(ga, rb(__fmul_rn(c.omega, ap))));
  const float sent = rb(__fdiv_rn(num, safe));
  const float delta = rb(__fadd_rn(
      rb(__fmul_rn(sp, sent)), rb(__fmul_rn(rb(__fsub_rn(1.0f, sp)), c.q))));
  const float w = rb(__fmul_rn(fabsf(rb(__fadd_rn(delta, 1.0f))), c.rmu));
  *a_out = a;
  return rb(__fmul_rn(a, rb(tanh_xla(w))));
}

// four bf16 at 4 * i of p, widened (the lower half-word is the lower
// element)
__device__ __forceinline__ float4 load_bf16x4(const __nv_bfloat16* p,
                                              long long i) {
  const uint2 u = __ldcs(reinterpret_cast<const uint2*>(p) + i);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  return (__float_as_uint(hi) & 0xffff0000u) | (__float_as_uint(lo) >> 16);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
scores_bf16_kernel(const float* __restrict__ g,
                   const __nv_bfloat16* __restrict__ err,
                   const __nv_bfloat16* __restrict__ a_prev,
                   const __nv_bfloat16* __restrict__ g_agg,
                   const __nv_bfloat16* __restrict__ s_prev,
                   __nv_bfloat16* __restrict__ a_out,
                   float* __restrict__ score_out, long long j, Scalars c) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = j / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 gv = __ldcs(reinterpret_cast<const float4*>(g) + i);
      const float4 ev = load_bf16x4(err, i);
      const float4 pv = load_bf16x4(a_prev, i);
      const float4 hv = load_bf16x4(g_agg, i);
      const float4 sv = load_bf16x4(s_prev, i);
      float4 av, ov;
      ov.x = score_one_bf16(gv.x, ev.x, pv.x, hv.x, sv.x, c, &av.x);
      ov.y = score_one_bf16(gv.y, ev.y, pv.y, hv.y, sv.y, c, &av.y);
      ov.z = score_one_bf16(gv.z, ev.z, pv.z, hv.z, sv.z, c, &av.z);
      ov.w = score_one_bf16(gv.w, ev.w, pv.w, hv.w, sv.w, c, &av.w);
      // av holds bf16 values: their top half-words are exact
      __stcs(reinterpret_cast<uint2*>(a_out) + i,
             make_uint2(pack_bf16x2(av.x, av.y), pack_bf16x2(av.z, av.w)));
      __stcs(reinterpret_cast<float4*>(score_out) + i, ov);
    }
    done = n4 * 4;
  }
  for (long long e = done + first; e < j; e += stride) {
    float a;
    score_out[e] = score_one_bf16(
        g[e], __bfloat162float(err[e]), __bfloat162float(a_prev[e]),
        __bfloat162float(g_agg[e]), __bfloat162float(s_prev[e]), c, &a);
    a_out[e] = __float2bfloat16_rn(a);
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
scores_kernel(const float* __restrict__ g, const float* __restrict__ err,
              const float* __restrict__ a_prev,
              const float* __restrict__ g_agg,
              const float* __restrict__ s_prev, float* __restrict__ a_out,
              float* __restrict__ score_out, long long j, Scalars c) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = j / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 gv = __ldcs(reinterpret_cast<const float4*>(g) + i);
      const float4 ev = __ldcs(reinterpret_cast<const float4*>(err) + i);
      const float4 pv = __ldcs(reinterpret_cast<const float4*>(a_prev) + i);
      const float4 hv = __ldcs(reinterpret_cast<const float4*>(g_agg) + i);
      const float4 sv = __ldcs(reinterpret_cast<const float4*>(s_prev) + i);
      float4 av, ov;
      ov.x = score_one(gv.x, ev.x, pv.x, hv.x, sv.x, c, &av.x);
      ov.y = score_one(gv.y, ev.y, pv.y, hv.y, sv.y, c, &av.y);
      ov.z = score_one(gv.z, ev.z, pv.z, hv.z, sv.z, c, &av.z);
      ov.w = score_one(gv.w, ev.w, pv.w, hv.w, sv.w, c, &av.w);
      __stcs(reinterpret_cast<float4*>(a_out) + i, av);
      __stcs(reinterpret_cast<float4*>(score_out) + i, ov);
    }
    done = n4 * 4;
  }
  for (long long e = done + first; e < j; e += stride) {
    score_out[e] = score_one(g[e], err[e], a_prev[e], g_agg[e], s_prev[e], c,
                             &a_out[e]);
  }
}

__device__ __forceinline__ void apply_one(float a, float m, float* ghat,
                                          float* err) {
  const float gh = __fmul_rn(m, a);
  *ghat = gh;
  *err = __fsub_rn(a, gh);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
apply_kernel(const float* __restrict__ a, const float* __restrict__ mask,
             float* __restrict__ ghat, float* __restrict__ err, long long j) {
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = j / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 av = __ldcs(reinterpret_cast<const float4*>(a) + i);
      const float4 mv = __ldcs(reinterpret_cast<const float4*>(mask) + i);
      float4 hv, ev;
      apply_one(av.x, mv.x, &hv.x, &ev.x);
      apply_one(av.y, mv.y, &hv.y, &ev.y);
      apply_one(av.z, mv.z, &hv.z, &ev.z);
      apply_one(av.w, mv.w, &hv.w, &ev.w);
      __stcs(reinterpret_cast<float4*>(ghat) + i, hv);
      __stcs(reinterpret_cast<float4*>(err) + i, ev);
    }
    done = n4 * 4;
  }
  for (long long e = done + first; e < j; e += stride) {
    apply_one(a[e], mask[e], &ghat[e], &err[e]);
  }
}

}  // namespace
}  // namespace fused_ef

// g, err, a_prev, g_agg, s_prev, a, score: (J,) fp32 on the device, the
// outputs distinct from the inputs; omega, rmu (= fp32 1/mu) and q by
// value. vec != 0 requires all seven 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int scores_launch(const float* g, const float* err,
                             const float* a_prev, const float* g_agg,
                             const float* s_prev, float* a, float* score,
                             long long j, float omega, float rmu, float q,
                             int grid, int vec, cudaStream_t stream) {
  using namespace fused_ef;
  const Scalars c{omega, rmu, q};
  if (vec) {
    scores_kernel<true><<<grid, THREADS, 0, stream>>>(
        g, err, a_prev, g_agg, s_prev, a, score, j, c);
  } else {
    scores_kernel<false><<<grid, THREADS, 0, stream>>>(
        g, err, a_prev, g_agg, s_prev, a, score, j, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// The bf16 read: g (J,) fp32, err, a_prev, g_agg, s_prev (J,) bf16, a
// (J,) bf16 and score (J,) fp32 written; omega, q the bf16-rounded
// constants and rmu = fp32 1/bf16(mu), by value. vec != 0 requires g and
// score 16-byte aligned and the bf16 vectors 8-byte aligned.
extern "C" int scores_bf16_launch(const float* g, const __nv_bfloat16* err,
                                  const __nv_bfloat16* a_prev,
                                  const __nv_bfloat16* g_agg,
                                  const __nv_bfloat16* s_prev,
                                  __nv_bfloat16* a, float* score,
                                  long long j, float omega, float rmu,
                                  float q, int grid, int vec,
                                  cudaStream_t stream) {
  using namespace fused_ef;
  const Scalars c{omega, rmu, q};
  if (vec) {
    scores_bf16_kernel<true><<<grid, THREADS, 0, stream>>>(
        g, err, a_prev, g_agg, s_prev, a, score, j, c);
  } else {
    scores_bf16_kernel<false><<<grid, THREADS, 0, stream>>>(
        g, err, a_prev, g_agg, s_prev, a, score, j, c);
  }
  return static_cast<int>(cudaGetLastError());
}

// a, mask, ghat, err: (J,) fp32 on the device, outputs distinct from the
// inputs; vec != 0 requires all four 16-byte aligned.
extern "C" int apply_launch(const float* a, const float* mask, float* ghat,
                            float* err, long long j, int grid, int vec,
                            cudaStream_t stream) {
  using namespace fused_ef;
  if (vec) {
    apply_kernel<true><<<grid, THREADS, 0, stream>>>(a, mask, ghat, err, j);
  } else {
    apply_kernel<false><<<grid, THREADS, 0, stream>>>(a, mask, ghat, err, j);
  }
  return static_cast<int>(cudaGetLastError());
}
