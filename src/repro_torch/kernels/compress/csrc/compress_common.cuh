// Constants and helpers shared by the two sweeps of the fused compression
// pipeline. Tile geometry and histogram layout are the reference's
// (src/repro/kernels/compress/kernel.py: BLOCK, BINS, _BIN_SHIFT), so slot
// layouts and histograms agree bit for bit.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace compress {

constexpr int BLOCK = 4096;            // elements per tile (one reference grid step)
constexpr int BINS = 2048;             // bit-pattern histogram bins
constexpr int BIN_SHIFT = 20;          // fp32 bits >> 20 -> [0, 2047] for |x|
constexpr int THREADS = 256;           // threads per CTA
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = BLOCK / THREADS;   // 16 elements, 4 float4

// max that propagates NaN like jnp.max / torch.amax (fmaxf would drop it)
__device__ __forceinline__ float nan_max(float acc, float x) {
  return (x != x || x > acc) ? x : acc;
}

}  // namespace compress
