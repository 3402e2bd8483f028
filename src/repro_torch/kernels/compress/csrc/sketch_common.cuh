// CountSketch hashing: the rows' hash constants (SketchHash, used by both
// encodes, sketch.cu and sketch_parts.cu) and sketch_accum, the global
// atomic accumulation of sketch_encode (sketch.cu). Hash constants, bucket
// and sign follow the reference (src/repro/core/sketch.py: _MULTS, _ADDS,
// _hashes) bit for bit.
#pragma once

#include "compress_common.cuh"

namespace compress {

constexpr int SKETCH_MAX_ROWS = 8;

// The rows' hash constants, passed to the kernel by value.
struct SketchHash {
  unsigned mult[SKETCH_MAX_ROWS];
  unsigned add[SKETCH_MAX_ROWS];
  unsigned width;
  int rows;
};

// Add element idx's value a to its bucket in every row: x = idx * mult + add
// (uint32 wraparound), bucket (x >> 8) % width, sign +1 when bit 31 of x is
// set. The sign is a flip of a (exact, as the reference's s * a is), and the
// add is a float atomic whose result is unused, so it compiles to a RED.
// Float atomics add in no fixed order: on inputs whose partial sums are not
// all exact, the sketch equals the sequential reference only up to fp32
// reassociation (and global fp32 atomics may flush subnormals to zero).
__device__ __forceinline__ void sketch_accum(float* __restrict__ sk,
                                             const SketchHash& hp,
                                             unsigned idx, float a) {
#pragma unroll
  for (int r = 0; r < SKETCH_MAX_ROWS; ++r) {   // constant indices into hp
    if (r < hp.rows) {
      const unsigned x = idx * hp.mult[r] + hp.add[r];
      const unsigned h = (x >> 8) % hp.width;
      const float v = (x >> 31) ? a : -a;
      atomicAdd(&sk[static_cast<size_t>(r) * hp.width + h], v);
    }
  }
}

}  // namespace compress
