// The linear magnitude histogram of threshold top-k selection, hand-written
// for Hopper (sm_90a). Replaces the TPU kernel
// src/repro/kernels/topk_select/kernel.py::_hist_kernel (launcher
// histogram_pallas): for every element
//   bin = clip(trunc(|x| / max(amax, 1e-30) * 2048), 0, 2047)
// and hist[bin] += 1, over 2048 int32 bins.
//
// Bound: device-memory bytes. Each element is read once (4 B, 3.57 GB at
// J = 892,032,000, 1.07 ms at the H100 SXM's 3.35 TB/s); the histogram is
// 8 KB.
//
// Design. The TPU grid runs in order and accumulates into one output
// block across grid steps; Hopper runs blocks in parallel, so this is a
// persistent grid-stride kernel over float4 groups (a scalar loop takes
// the ragged tail, so J needs no padding and bin 0 no correction). Each
// CTA keeps a 2048-bin histogram in shared memory (8 KB), filled with
// warp-aggregated shared atomics (lanes of a warp that hit the same bin
// add once), and adds its nonzero bins to the global histogram with
// integer atomics once at the end. Integer counts do not depend on order,
// so the histogram equals the plain version's bit for bit. amax arrives
// as a pointer to a device scalar, so it costs no host read; the bin is
// computed with an IEEE division and an exact multiply by 2048 (no
// contraction), as the reference's compiled program computes it.
#include <cstdint>
#include <cuda_runtime.h>

namespace topk_select {
namespace {

constexpr int THREADS = 256;
constexpr int BINS = 2048;
constexpr float AMAX_FLOOR = 0x1.4484cp-100f;   // f32(1e-30)

__device__ __forceinline__ int bin_of(float x, float amax) {
  const float q = __fmul_rn(__fdiv_rn(fabsf(x), amax), 2048.0f);
  if (q != q) return 0;                 // NaN: bin 0, as XLA converts it
  const int b = __float2int_rz(q);
  return b < 0 ? 0 : (b > BINS - 1 ? BINS - 1 : b);
}

__device__ __forceinline__ void count_bin(int* sh_hist, int bin) {
  const unsigned peers = __match_any_sync(__activemask(), bin);
  if ((threadIdx.x & 31) == static_cast<unsigned>(__ffs(peers) - 1)) {
    atomicAdd(&sh_hist[bin], __popc(peers));
  }
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
hist_kernel(const float* __restrict__ x, const float* __restrict__ amax_ptr,
            int* __restrict__ hist_out, long long j) {
  __shared__ int sh_hist[BINS];
  for (int b = threadIdx.x; b < BINS; b += THREADS) sh_hist[b] = 0;
  __syncthreads();
  // jnp.maximum(amax, 1e-30): a NaN amax stays NaN
  const float raw = *amax_ptr;
  const float amax = raw != raw ? raw : fmaxf(raw, AMAX_FLOOR);
  const long long stride = static_cast<long long>(gridDim.x) * THREADS;
  const long long first = static_cast<long long>(blockIdx.x) * THREADS +
                          threadIdx.x;
  long long done = 0;
  if (VEC) {
    const long long n4 = j / 4;
    for (long long i = first; i < n4; i += stride) {
      const float4 v = __ldcs(reinterpret_cast<const float4*>(x) + i);
      count_bin(sh_hist, bin_of(v.x, amax));
      count_bin(sh_hist, bin_of(v.y, amax));
      count_bin(sh_hist, bin_of(v.z, amax));
      count_bin(sh_hist, bin_of(v.w, amax));
    }
    done = n4 * 4;
  }
  for (long long e = done + first; e < j; e += stride) {
    count_bin(sh_hist, bin_of(x[e], amax));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < BINS; b += THREADS) {
    const int v = sh_hist[b];
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
  if (vec) {
    hist_kernel<true><<<grid, THREADS, 0, stream>>>(x, amax, hist, j);
  } else {
    hist_kernel<false><<<grid, THREADS, 0, stream>>>(x, amax, hist, j);
  }
  return static_cast<int>(cudaGetLastError());
}
