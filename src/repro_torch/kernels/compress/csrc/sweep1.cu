// Sweep 1 of the fused compression pipeline, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/compress/kernel.py::_sweep1_kernel
// (plain mode, launcher sweep1_pallas): for every element
//   a = err + g,   score = a * c,
// plus the per-4096-element-tile amax of |score| and a 2048-bin histogram of
// the fp32 bit pattern of |score| (bits >> 20).
//
// Bound: device-memory bytes. Each element reads g and err and writes a and
// score, 16 B per element (14.27 GB at J = 892,032,000, about 4.3 ms at the
// H100 SXM's 3.35 TB/s). The histogram and the amax add only J/4096 * 4 B.
//
// Design. The TPU grid runs in order and carries the histogram from one grid
// step to the next; Hopper runs blocks in parallel, so this is a persistent
// grid-stride kernel (a few CTAs per SM), each walking whole 4096-element
// tiles. Loads and stores are 16-byte vectors on full tiles (all eight loads
// of a tile issued before any use), the ragged last tile is masked. Each CTA
// keeps its histogram in shared memory, filled with warp-aggregated shared
// atomics (lanes with the same bin add once), and flushes its nonzero bins
// to the global histogram with integer atomicAdd once at the end. Integer
// counts do not depend on order, and a and score are single-rounding fp32
// operations (__fadd_rn / __fmul_rn, so nothing is contracted into an FMA),
// which keeps a, score, amax and hist bitwise equal to the plain version and
// to the Pallas kernel. c arrives as a pointer to a 1-element device tensor,
// so the step's factor never forces a host read.
#include "compress_common.cuh"

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

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sweep1_kernel(const float* __restrict__ g, const float* __restrict__ err,
              const float* __restrict__ c_ptr, float* __restrict__ a_out,
              float* __restrict__ score_out, float* __restrict__ amax_out,
              int* __restrict__ hist_out, long long j, long long rows) {
  __shared__ int sh_hist[BINS];
  __shared__ float sh_max[WARPS];
  for (int b = threadIdx.x; b < BINS; b += THREADS) sh_hist[b] = 0;
  __syncthreads();
  const float c = *c_ptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  for (long long t = blockIdx.x; t < rows; t += gridDim.x) {
    const long long base = t * BLOCK;
    float m = 0.0f;   // keys are >= 0: equals the max over a zero-padded tile
    if (VEC && base + BLOCK <= j) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      const float4* e4 = reinterpret_cast<const float4*>(err + base);
      float4* a4 = reinterpret_cast<float4*>(a_out + base);
      float4* s4 = reinterpret_cast<float4*>(score_out + base);
      float4 gv[PER_THREAD / 4], ev[PER_THREAD / 4];
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        gv[r] = __ldcs(&g4[r * THREADS + threadIdx.x]);
        ev[r] = __ldcs(&e4[r * THREADS + threadIdx.x]);
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
          const float k = one(err[e], g[e], c, &a_out[e], &score_out[e]);
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
  using namespace compress;
  const long long rows = (j + BLOCK - 1) / BLOCK;
  if (vec) {
    sweep1_kernel<true><<<grid, THREADS, 0, stream>>>(g, err, c, a, score,
                                                      amax, hist, j, rows);
  } else {
    sweep1_kernel<false><<<grid, THREADS, 0, stream>>>(g, err, c, a, score,
                                                       amax, hist, j, rows);
  }
  return static_cast<int>(cudaGetLastError());
}
