// The CountSketch encode of sketch-coordinated top-k on the reference
// pipeline, hand-written for Hopper (sm_90a). sketch_encode replaces the
// TPU kernel src/repro/kernels/compress/kernel.py::_sketch_encode_kernel
// (launcher sketch_encode_pallas): the CountSketch of a given a, through
// sketch_accum (sketch_common.cuh). The fused encode of the fused
// pipeline (_sweep1_sketch_kernel) is sketch_parts.cu.
//
// Bound: device-memory bytes. sketch_encode reads a, 4 B per element
// (3.57 GB at J = 892,032,000, about 1.07 ms at the H100 SXM's
// 3.35 TB/s). Each element also makes `rows` float reductions into the
// sketch (2,676,096,000 at rows = 3), which the data sheet gives no rate
// for.
//
// Design. The TPU kernel walks the grid in order and keeps the whole sketch
// in VMEM as one output block. On Hopper the sketch (3 x 3,568,128 fp32 =
// 42.8 MB at the main shape) does not fit in shared memory, so every
// contribution is a global float atomic, served by the 50 MB L2. The kernel
// is persistent and grid-stride over 4096-element tiles (a few CTAs per SM),
// with 16-byte vector loads of a on full tiles; the ragged last tile is
// masked (the reference pads it with a = 0, which adds +-0 to some bucket,
// so masking is the same). The caller zeroes the sketch. The partitioned
// two-pass design of sketch_parts.cu is this kernel's next step.
#include "sketch_common.cuh"

namespace compress {
namespace {

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sketch_kernel(const float* __restrict__ x, float* __restrict__ sk,
              const SketchHash hp, long long j, long long tiles) {
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
        const unsigned i = static_cast<unsigned>(
            base + 4LL * (r * THREADS + threadIdx.x));
        sketch_accum(sk, hp, i, v[r].x);
        sketch_accum(sk, hp, i + 1, v[r].y);
        sketch_accum(sk, hp, i + 2, v[r].z);
        sketch_accum(sk, hp, i + 3, v[r].w);
      }
    } else {
      for (int i = threadIdx.x; i < BLOCK; i += THREADS) {
        const long long e = base + i;
        if (e < j) sketch_accum(sk, hp, static_cast<unsigned>(e), x[e]);
      }
    }
  }
}

int launch(const float* x, float* sk, const unsigned* mults,
           const unsigned* adds, int rows, unsigned width, long long j,
           int grid, int vec, cudaStream_t stream) {
  if (rows < 1 || rows > SKETCH_MAX_ROWS || width == 0 || grid < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SketchHash hp{};
  for (int r = 0; r < rows; ++r) {
    hp.mult[r] = mults[r];
    hp.add[r] = adds[r];
  }
  hp.width = width;
  hp.rows = rows;
  const long long tiles = (j + BLOCK - 1) / BLOCK;
  if (vec) {
    sketch_kernel<true><<<grid, THREADS, 0, stream>>>(x, sk, hp, j, tiles);
  } else {
    sketch_kernel<false><<<grid, THREADS, 0, stream>>>(x, sk, hp, j, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace compress

// a: (J,) fp32 with J <= 2^32; sk: (rows, width) fp32, zeroed by the
// caller; mults, adds: host arrays of the rows' hash constants (copied into
// the kernel's by-value argument). vec != 0 requires a 16-byte-aligned a.
// Returns the cudaError_t of the launch.
extern "C" int sketch_encode_launch(const float* a, float* sk,
                                    const unsigned* mults,
                                    const unsigned* adds, int rows,
                                    unsigned width, long long j, int grid,
                                    int vec, cudaStream_t stream) {
  return compress::launch(a, sk, mults, adds, rows, width, j, grid, vec,
                          stream);
}
