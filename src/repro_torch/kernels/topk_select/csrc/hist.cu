// The linear magnitude histogram of threshold top-k selection, hand-written
// for Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/topk_select/kernel.py::_hist_kernel (launcher
// histogram_pallas): for every element
//   bin = clip(trunc(|x| / max(amax, 1e-30) * 2048), 0, 2047)
// and hist[bin] += 1, over 2048 int32 bins; a NaN |x| (or a NaN amax)
// counts in bin 0, as XLA converts NaN to 0.
//
// Bound: device-memory bytes. Each element is read once (4 B, 3.57 GB at
// J = 892,032,000, 1.07 ms at the H100 SXM's 3.35 TB/s); the histogram is
// 8 KB.
//
// Design. The TPU grid runs in order and accumulates into one output
// block across grid steps; Hopper runs blocks in parallel, so this is a
// persistent kernel over 4096-element tiles (a masked scalar loop takes
// the ragged tail, so J needs no padding and bin 0 no correction). What
// costs time here is the binning, not the bytes, so:
// - every warp counts into its own 2048-bin sub-histogram in shared memory
//   (8 x 8 KB) with a plain shared atomic, and the CTA sums the eight and
//   adds the nonzero bins to the global histogram with one integer atomic
//   each at the end. Integer counts do not depend on order, so the result
//   equals the plain version bit for bit;
// - each thread loads its four float4 of a tile before it bins any of
//   them, as sweep 1 does, so 64 B per thread are in flight;
// - the bin is the IEEE division's, as the reference's compiled program
//   computes it: an exact multiply by 2048 follows, no contraction. (A bin
//   through a per-CTA table of the exact bin edges, with no division per
//   element, was measured slower than the division once the
//   sub-histograms were in: PERF.md.)
// amax arrives as a pointer to a device scalar, so it costs no host read.
#include <cstdint>
#include <cuda_runtime.h>

namespace topk_select {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BINS = 2048;
constexpr int BLOCK = 4096;                     // elements per tile
constexpr int PER_THREAD = BLOCK / THREADS;     // 16 elements, 4 float4
constexpr size_t SMEM = WARPS * BINS * sizeof(int);
constexpr float AMAX_FLOOR = 0x1.4484cp-100f;   // f32(1e-30)

__device__ __forceinline__ int bin_of(float x, float amax) {
  const float q = __fmul_rn(__fdiv_rn(fabsf(x), amax), 2048.0f);
  if (q != q) return 0;                 // NaN: bin 0, as XLA converts it
  const int b = __float2int_rz(q);
  return b < 0 ? 0 : (b > BINS - 1 ? BINS - 1 : b);
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const float* __restrict__ x, const float* __restrict__ amax_ptr,
            int* __restrict__ hist_out, long long j) {
  extern __shared__ int sub[];          // WARPS histograms of BINS
  // jnp.maximum(amax, 1e-30): a NaN amax stays NaN
  const float raw = *amax_ptr;
  const float amax = raw != raw ? raw : fmaxf(raw, AMAX_FLOOR);
  for (int b = threadIdx.x; b < WARPS * BINS; b += THREADS) sub[b] = 0;
  __syncthreads();
  int* h = sub + (threadIdx.x >> 5) * BINS;
  const auto count = [&](float v) { atomicAdd(&h[bin_of(v, amax)], 1); };

  const long long tiles = (j + BLOCK - 1) / BLOCK;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * BLOCK;
    if (VEC && base + BLOCK <= j) {
      const float4* x4 = reinterpret_cast<const float4*>(x + base);
      float4 v[PER_THREAD / 4];
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        v[r] = __ldcs(&x4[r * THREADS + threadIdx.x]);
      }
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        count(v[r].x);
        count(v[r].y);
        count(v[r].z);
        count(v[r].w);
      }
    } else {
      for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
        if (base + i < j) count(x[base + i]);
      }
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += THREADS) {
    int v = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) v += sub[w * BINS + b];
    if (v) atomicAdd(&hist_out[b], v);
  }
}

}  // namespace
}  // namespace topk_select

// x: (J,) fp32; amax: one fp32 on the device; hist: (2048,) int32, zeroed
// by the caller. vec != 0 requires x 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int hist_launch(const float* x, const float* amax, int* hist,
                           long long j, int grid, int vec,
                           cudaStream_t stream) {
  using namespace topk_select;
  auto kernel = vec ? hist_kernel<true> : hist_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, THREADS, SMEM, stream>>>(x, amax, hist, j);
  return static_cast<int>(cudaGetLastError());
}
