// CountSketch hashing: the rows' hash constants (SketchHash), passed by
// value to the kernels of sketch_parts.cu. For row r, x = idx * mult[r] +
// add[r] (uint32 wraparound), bucket (x >> 8) % width, sign +1 when bit 31
// of x is set; constants, bucket and sign follow the reference
// (src/repro/core/sketch.py: _MULTS, _ADDS, _hashes) bit for bit.
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

}  // namespace compress
