// The CountSketch encodes of sketch-coordinated top-k, hand-written for
// Hopper (sm_90a).
//
// sweep1_sketch replaces the TPU kernel
// src/repro/kernels/compress/kernel.py::_sweep1_sketch_kernel (launcher
// sweep1_sketch_pallas): a = err + g for every element, and the (rows, width)
// CountSketch of a. sketch_encode replaces
// kernel.py::_sketch_encode_kernel (launcher sketch_encode_pallas): the
// CountSketch of a given a. Both accumulate through sketch_accum
// (sketch_common.cuh).
//
// Bound: device-memory bytes. sweep1_sketch reads g and err and writes a,
// 12 B per element (10.70 GB at J = 892,032,000, about 3.20 ms at the H100
// SXM's 3.35 TB/s); sketch_encode reads a, 4 B per element (3.57 GB, about
// 1.07 ms). Each element also makes `rows` float reductions into the sketch
// (2,676,096,000 at rows = 3), which the data sheet gives no rate for.
//
// Design. The TPU kernel walks the grid in order and keeps the whole sketch
// in VMEM as one output block. On Hopper the sketch (3 x 3,568,128 fp32 =
// 42.8 MB at the main shape) does not fit in shared memory, so every
// contribution is a global float atomic, served by the 50 MB L2. The kernel
// is persistent and grid-stride over 4096-element tiles (a few CTAs per SM),
// with 16-byte vector loads of the inputs and stores of a on full tiles; the
// ragged last tile is masked (the reference pads it with a = 0, which adds
// +-0 to some bucket, so masking is the same). a is a single-rounding add
// (__fadd_rn), bitwise equal to the plain version and the reference. The
// caller zeroes the sketch. Making the reductions cheaper (privatised bucket
// ranges in shared memory, a multiplicative inverse for % width,
// warp-aggregated reductions) is later work.
#include "sketch_common.cuh"

namespace compress {
namespace {

// FUSED: x is g, a = err + g is written to a_out. Else x is a itself.
template <bool VEC, bool FUSED>
__global__ void __launch_bounds__(THREADS)
sketch_kernel(const float* __restrict__ x, const float* __restrict__ err,
              float* __restrict__ a_out, float* __restrict__ sk,
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
      if (FUSED) {
        const float4* e4 = reinterpret_cast<const float4*>(err + base);
        float4* a4 = reinterpret_cast<float4*>(a_out + base);
        float4 ev[PER_THREAD / 4];
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) {
          ev[r] = __ldcs(&e4[r * THREADS + threadIdx.x]);
        }
#pragma unroll
        for (int r = 0; r < PER_THREAD / 4; ++r) {
          v[r].x = __fadd_rn(ev[r].x, v[r].x);
          v[r].y = __fadd_rn(ev[r].y, v[r].y);
          v[r].z = __fadd_rn(ev[r].z, v[r].z);
          v[r].w = __fadd_rn(ev[r].w, v[r].w);
          __stcs(&a4[r * THREADS + threadIdx.x], v[r]);
        }
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
        if (e < j) {
          float a = x[e];
          if (FUSED) {
            a = __fadd_rn(err[e], a);
            a_out[e] = a;
          }
          sketch_accum(sk, hp, static_cast<unsigned>(e), a);
        }
      }
    }
  }
}

template <bool FUSED>
int launch(const float* x, const float* err, float* a, float* sk,
           const unsigned* mults, const unsigned* adds, int rows,
           unsigned width, long long j, int grid, int vec,
           cudaStream_t stream) {
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
    sketch_kernel<true, FUSED><<<grid, THREADS, 0, stream>>>(
        x, err, a, sk, hp, j, tiles);
  } else {
    sketch_kernel<false, FUSED><<<grid, THREADS, 0, stream>>>(
        x, err, a, sk, hp, j, tiles);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace compress

// g, err, a: (J,) fp32 with J <= 2^32; sk: (rows, width) fp32, zeroed by the
// caller; mults, adds: host arrays of the rows' hash constants (copied into
// the kernel's by-value argument). vec != 0 requires 16-byte-aligned g, err
// and a. Returns the cudaError_t of the launch.
extern "C" int sweep1_sketch_launch(const float* g, const float* err, float* a,
                                    float* sk, const unsigned* mults,
                                    const unsigned* adds, int rows,
                                    unsigned width, long long j, int grid,
                                    int vec, cudaStream_t stream) {
  return compress::launch<true>(g, err, a, sk, mults, adds, rows, width, j,
                                grid, vec, stream);
}

// a: (J,) fp32 with J <= 2^32; the rest as above. vec != 0 requires a
// 16-byte-aligned a.
extern "C" int sketch_encode_launch(const float* a, float* sk,
                                    const unsigned* mults,
                                    const unsigned* adds, int rows,
                                    unsigned width, long long j, int grid,
                                    int vec, cudaStream_t stream) {
  return compress::launch<false>(a, nullptr, nullptr, sk, mults, adds, rows,
                                 width, j, grid, vec, stream);
}
