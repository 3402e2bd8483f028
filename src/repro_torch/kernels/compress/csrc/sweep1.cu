// Sweep 1 of the fused compression pipeline, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/compress/kernel.py::_sweep1_kernel
// (launcher sweep1_pallas) in its modes. Plain mode, for every element:
//   a = err + g,   score = a * c;
// dgc mode (Deep Gradient Compression's momentum correction) threads a third
// stream, the momentum buffer:
//   mom' = momentum * mom + g,   a = err + mom',   score = a * c;
// both emit the per-4096-element-tile amax of |score| and a 2048-bin
// histogram of the fp32 bit pattern of |score| (bits >> 20).
// The gated variant (elastic participation; the Pallas kernel's gate=
// operand) reads the worker's participation bit p and the error-feedback
// decay, and masks the inputs in registers first:
//   g_eff = p ? g : 0,   err_eff = p ? err : decay * err,
// then plain mode a = err_eff + g_eff, or dgc mode
//   mom' = momentum * mom + g_eff,   a = err_eff + (p ? mom' : 0),
// so a sitting-out worker's a is its decayed error while its momentum
// still advances. Masking in registers adds no pass over J and no
// temporary; the add runs when p is 0 too (-0.0 + 0.0 is +0.0, as in the
// reference).
//
// The bf16 read (every mode; the reference's ef_dtype="bfloat16") takes err
// and, in dgc mode, mom as bf16 and widens them to fp32 in registers, which
// is exact; it also rounds g to bf16 first, because the reference casts the
// gradient to the state's dtype before the sweep, and a sitting-out worker's
// decayed error is rounded to bf16 before the add (the reference casts
// err_decay * err back to the state's dtype). Its outputs stay fp32, so every
// output equals the fp32 kernel's on the upcast inputs (g rounded to bf16).
//
// Bound: device-memory bytes. Plain mode reads g and err and writes a and
// score, 16 B per element (14.27 GB at J = 892,032,000, about 4.3 ms at the
// H100 SXM's 3.35 TB/s); dgc mode also reads mom and writes mom', 24 B per
// element (21.41 GB, about 6.4 ms); the gated variant moves the same bytes
// as its mode. The bf16 read saves 2 B per bf16 stream: 14 B per element in
// plain mode (3.73 ms), 20 B in dgc mode (5.33 ms). The histogram and the
// amax add only J/4096 * 4 B.
//
// Design. The TPU grid runs in order and carries the histogram from one grid
// step to the next; Hopper runs blocks in parallel, so this is a persistent
// grid-stride kernel (a few CTAs per SM), each walking whole 4096-element
// tiles. Loads and stores are 16-byte streaming vectors on full tiles (all
// of a tile's loads issued before any use), the ragged last tile is masked.
// Each CTA keeps its histogram in shared memory, filled with
// warp-aggregated shared atomics (lanes with the same bin add once), and
// flushes its nonzero bins to the global histogram with integer atomicAdd
// once at the end. Integer counts do not depend on order, and every value
// is rounded where the compiled reference rounds it: a and score are
// single-rounding __fadd_rn / __fmul_rn (nothing contracted), and mom' is
// one __fmaf_rn, since XLA contracts momentum * mom + g into a fused
// multiply-add. In the gated variant decay * err is its own __fmul_rn: the
// reference rounds it before the add, because a select stands between the
// two. That keeps a, score, mom', amax and hist bitwise equal to the plain
// version and to the Pallas kernel. One body serves every mode through
// compile-time switches, so the ungated kernels are what they were. c and
// the gate arrive as pointers to 1-element device tensors, so neither the
// step's factor nor the fault schedule forces a host read; momentum and
// decay are by-value fp32 (the reference's weak-typed constants round to
// fp32 too).
#include <cuda_bf16.h>

#include "compress_common.cuh"
#include "state_read.cuh"

namespace compress {
namespace {

__device__ __forceinline__ void count_bin(int* sh_hist, float key) {
  const unsigned bin = __float_as_uint(key) >> BIN_SHIFT;
  const unsigned peers = __match_any_sync(__activemask(), bin);
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1)) {
    atomicAdd(&sh_hist[bin], __popc(peers));
  }
}

__device__ __forceinline__ float one(float e, float g, float c, float* a_out,
                                     float* s_out) {
  const float a = __fadd_rn(e, g);
  const float s = __fmul_rn(a, c);
  *a_out = a;
  *s_out = s;
  return fabsf(s);
}

// the momentum update of dgc mode: mom' = momentum * mom + g, one rounding
__device__ __forceinline__ float advance(float momentum, float m, float g) {
  return __fmaf_rn(momentum, m, g);
}

template <bool VEC, bool DGC, bool GATED, typename S>
__global__ void __launch_bounds__(THREADS)
sweep1_kernel(const float* __restrict__ g, const S* __restrict__ err,
              const S* __restrict__ mom, const float* __restrict__ c_ptr,
              const float* __restrict__ gate_ptr, float momentum, float decay,
              float* __restrict__ a_out, float* __restrict__ score_out,
              float* __restrict__ mom_out, float* __restrict__ amax_out,
              int* __restrict__ hist_out, long long j, long long rows) {
  __shared__ int sh_hist[BINS];
  __shared__ float sh_max[WARPS];
  for (int b = threadIdx.x; b < BINS; b += THREADS) sh_hist[b] = 0;
  __syncthreads();
  const float c = *c_ptr;
  bool p = true;   // the participation bit (the gated variant reads it)
  if constexpr (GATED) p = *gate_ptr > 0.5f;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  using Read = StateRead<S>;

  for (long long t = blockIdx.x; t < rows; t += gridDim.x) {
    const long long base = t * BLOCK;
    float m = 0.0f;   // keys are >= 0: equals the max over a zero-padded tile
    if (VEC && base + BLOCK <= j) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      float4* a4 = reinterpret_cast<float4*>(a_out + base);
      float4* s4 = reinterpret_cast<float4*>(score_out + base);
      float4 gv[PER_THREAD / 4], ev[PER_THREAD / 4];
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        gv[r] = __ldcs(&g4[r * THREADS + threadIdx.x]);
        ev[r] = Read::load4(err + base, r * THREADS + threadIdx.x);
      }
      if constexpr (Read::BF16) {
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) round_bf16(gv[r]);
      }
      if constexpr (GATED) {
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) {
          mask_inputs<Read::BF16>(p, decay, gv[r], ev[r]);
        }
      }
      if constexpr (DGC) {
        // gv becomes mom' in place, and is written out as the new momentum
        float4* mo4 = reinterpret_cast<float4*>(mom_out + base);
        float4 mv[PER_THREAD / 4];
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) {
          mv[r] = Read::load4(mom + base, r * THREADS + threadIdx.x);
        }
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) {
          gv[r].x = advance(momentum, mv[r].x, gv[r].x);
          gv[r].y = advance(momentum, mv[r].y, gv[r].y);
          gv[r].z = advance(momentum, mv[r].z, gv[r].z);
          gv[r].w = advance(momentum, mv[r].w, gv[r].w);
          __stcs(&mo4[r * THREADS + threadIdx.x], gv[r]);
          if constexpr (GATED) {
            // a sitting-out worker's a leaves the momentum out
            gv[r].x = p ? gv[r].x : 0.0f;
            gv[r].y = p ? gv[r].y : 0.0f;
            gv[r].z = p ? gv[r].z : 0.0f;
            gv[r].w = p ? gv[r].w : 0.0f;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        float4 av, sv;
        float k;
        k = one(ev[r].x, gv[r].x, c, &av.x, &sv.x); m = nan_max(m, k); count_bin(sh_hist, k);
        k = one(ev[r].y, gv[r].y, c, &av.y, &sv.y); m = nan_max(m, k); count_bin(sh_hist, k);
        k = one(ev[r].z, gv[r].z, c, &av.z, &sv.z); m = nan_max(m, k); count_bin(sh_hist, k);
        k = one(ev[r].w, gv[r].w, c, &av.w, &sv.w); m = nan_max(m, k); count_bin(sh_hist, k);
        __stcs(&a4[r * THREADS + threadIdx.x], av);
        __stcs(&s4[r * THREADS + threadIdx.x], sv);
      }
    } else {
      for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
        const long long e = base + i;
        if (e < j) {
          float x = g[e];
          float ee = Read::load1(err, e);
          if constexpr (Read::BF16) x = round_bf16(x);
          if constexpr (GATED) mask_inputs<Read::BF16>(p, decay, x, ee);
          if constexpr (DGC) {
            x = advance(momentum, Read::load1(mom, e), x);
            mom_out[e] = x;
            if constexpr (GATED) x = p ? x : 0.0f;
          }
          const float k = one(ee, x, c, &a_out[e], &score_out[e]);
          m = nan_max(m, k);
          count_bin(sh_hist, k);
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = nan_max(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if (lane == 0) sh_max[warp] = m;
    __syncthreads();
    if (warp == 0) {
      float v = lane < WARPS ? sh_max[lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v = nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
      }
      if (lane == 0) amax_out[t] = v;
    }
    __syncthreads();   // sh_max is rewritten by the next tile
  }

  for (int b = threadIdx.x; b < BINS; b += THREADS) {
    const int v = sh_hist[b];
    if (v) atomicAdd(&hist_out[b], v);
  }
}

template <bool DGC, bool GATED, typename S>
int launch(const float* g, const S* err, const S* mom, const float* c,
           const float* gate, float momentum, float decay, float* a,
           float* score, float* mom_out, float* amax, int* hist, long long j,
           int grid, int vec, cudaStream_t stream) {
  const long long rows = (j + BLOCK - 1) / BLOCK;
  if (vec) {
    sweep1_kernel<true, DGC, GATED, S><<<grid, THREADS, 0, stream>>>(
        g, err, mom, c, gate, momentum, decay, a, score, mom_out, amax, hist,
        j, rows);
  } else {
    sweep1_kernel<false, DGC, GATED, S><<<grid, THREADS, 0, stream>>>(
        g, err, mom, c, gate, momentum, decay, a, score, mom_out, amax, hist,
        j, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace compress

// g, err: (J,) fp32; c: (1,) fp32 on the device; a, score: (J,) fp32;
// amax: (ceil(J/4096),) fp32; hist: (2048,) int32, zeroed by the caller.
// vec != 0 requires 16-byte-aligned g, err, a and score. Returns the
// cudaError_t of the launch.
extern "C" int sweep1_launch(const float* g, const float* err, const float* c,
                             float* a, float* score, float* amax, int* hist,
                             long long j, int grid, int vec,
                             cudaStream_t stream) {
  return compress::launch<false, false, float>(
      g, err, nullptr, c, nullptr, 0.0f, 1.0f, a, score, nullptr, amax, hist,
      j, grid, vec, stream);
}

// dgc mode: as sweep1_launch, plus mom (J,) fp32 in and mom_out (J,) fp32
// out, and momentum by value; vec != 0 also requires 16-byte-aligned mom
// and mom_out.
extern "C" int sweep1_dgc_launch(const float* g, const float* err,
                                 const float* mom, const float* c,
                                 float momentum, float* a, float* score,
                                 float* mom_out, float* amax, int* hist,
                                 long long j, int grid, int vec,
                                 cudaStream_t stream) {
  return compress::launch<true, false, float>(
      g, err, mom, c, nullptr, momentum, 1.0f, a, score, mom_out, amax, hist,
      j, grid, vec, stream);
}

// the gated variant, both modes: as sweep1_launch (mom == nullptr, mom_out
// unused) or sweep1_dgc_launch, plus gate, a (1,) fp32 on the device (the
// participation bit, > 0.5 is in), and decay by value.
extern "C" int sweep1_gated_launch(const float* g, const float* err,
                                   const float* mom, const float* c,
                                   const float* gate, float momentum,
                                   float decay, float* a, float* score,
                                   float* mom_out, float* amax, int* hist,
                                   long long j, int grid, int vec,
                                   cudaStream_t stream) {
  if (mom != nullptr) {
    return compress::launch<true, true, float>(
        g, err, mom, c, gate, momentum, decay, a, score, mom_out, amax, hist,
        j, grid, vec, stream);
  }
  return compress::launch<false, true, float>(
      g, err, nullptr, c, gate, 0.0f, decay, a, score, nullptr, amax, hist, j,
      grid, vec, stream);
}

// The bf16 read of each mode: as sweep1_launch, sweep1_dgc_launch and
// sweep1_gated_launch with err (and mom) bf16; g is rounded to bf16 in
// registers. vec != 0 requires 16-byte-aligned fp32 vectors and 8-byte-
// aligned bf16 ones.
extern "C" int sweep1_bf16_launch(const float* g, const __nv_bfloat16* err,
                                  const float* c, float* a, float* score,
                                  float* amax, int* hist, long long j,
                                  int grid, int vec, cudaStream_t stream) {
  return compress::launch<false, false, __nv_bfloat16>(
      g, err, nullptr, c, nullptr, 0.0f, 1.0f, a, score, nullptr, amax, hist,
      j, grid, vec, stream);
}

extern "C" int sweep1_dgc_bf16_launch(const float* g,
                                      const __nv_bfloat16* err,
                                      const __nv_bfloat16* mom,
                                      const float* c, float momentum,
                                      float* a, float* score, float* mom_out,
                                      float* amax, int* hist, long long j,
                                      int grid, int vec,
                                      cudaStream_t stream) {
  return compress::launch<true, false, __nv_bfloat16>(
      g, err, mom, c, nullptr, momentum, 1.0f, a, score, mom_out, amax, hist,
      j, grid, vec, stream);
}

extern "C" int sweep1_gated_bf16_launch(const float* g,
                                        const __nv_bfloat16* err,
                                        const __nv_bfloat16* mom,
                                        const float* c, const float* gate,
                                        float momentum, float decay, float* a,
                                        float* score, float* mom_out,
                                        float* amax, int* hist, long long j,
                                        int grid, int vec,
                                        cudaStream_t stream) {
  if (mom != nullptr) {
    return compress::launch<true, true, __nv_bfloat16>(
        g, err, mom, c, gate, momentum, decay, a, score, mom_out, amax, hist,
        j, grid, vec, stream);
  }
  return compress::launch<false, true, __nv_bfloat16>(
      g, err, nullptr, c, gate, 0.0f, decay, a, score, nullptr, amax, hist, j,
      grid, vec, stream);
}
