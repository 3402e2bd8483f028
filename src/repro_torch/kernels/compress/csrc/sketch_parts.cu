// The partitioned CountSketch encodes of sketch-coordinated top-k,
// hand-written for Hopper (sm_90a). The entry points share every kernel
// of this file:
// - sweep1_sketch_launch, the fused sweep 1 of the fused pipeline: a = err
//   + g for every element and the (rows, width) CountSketch of a. Replaces
//   the TPU kernel src/repro/kernels/compress/kernel.py::
//   _sweep1_sketch_kernel (launcher sweep1_sketch_pallas). Its gated form
//   (sweep1_sketch_gated_launch) folds in the reference's masked_inputs
//   (src/repro/kernels/compress/ops.py), which runs in XLA before the
//   Pallas kernel: g_eff = p ? g : 0, err_eff = p ? err : decay * err. Its
//   bf16 read (sweep1_sketch{,_gated}_bf16_launch) takes a bf16 err and
//   widens it in registers, as the reference casts it to fp32 before its
//   kernel; g and a stay fp32.
// - sketch_encode_launch, the encode of the reference pipeline: the
//   CountSketch of a given a. Replaces _sketch_encode_kernel (launcher
//   sketch_encode_pallas) of the same file.
// Hash constants, bucket and sign follow the reference
// (src/repro/core/sketch.py: _MULTS, _ADDS, _hashes) bit for bit.
//
// Bound: device-memory bytes. The fused sweep reads g and err and writes
// a, 12 B per element (10.70 GB at J = 892,032,000, about 3.20 ms at the
// H100 SXM's 3.35 TB/s); the encode reads a, 4 B per element (3.57 GB,
// about 1.07 ms). The bf16 read moves 10 B per element (8.92 GB, 2.66 ms);
// the gated form the bytes of its read. Both make `rows` additions per
// element into a sketch (42.8 MB at 3 rows x 3,568,128) that does not fit
// in shared memory.
//
// Design: privatised bucket ranges. Each row's buckets are cut into
// partitions of R = 2^14 buckets (R fp32 sums, 64 KB, fit in one CTA's
// shared memory with room for three CTAs an SM; 2^15 was measured slower:
// PERF.md). A bucket is (hash >> 8) % width < 2^24, so buckets at or
// beyond 2^24 of a wider row stay 0 and get no partition: a row has at
// most 1024 partitions. J is cut into chunks, and a chunk into tiles of
// TILE elements; per chunk:
// - pass 1 (pass1_kernel, persistent over the tiles) reads its input with
//   16-byte vectors: g and err, writing a bitwise, in the fused sweep; a
//   alone in the encode. It turns every row's contribution of the tile
//   into a pair (local bucket uint16, signed value fp32; two arrays, 6 B
//   a pair), ranks each pair within its partition with a shared atomic,
//   stages a row's pairs of the tile in shared memory in partition order,
//   and writes them contiguously into the tile's own block of the pair
//   buffer (rows * TILE pairs a tile), so the pair buffer is written as a
//   plain stream. The bucket (x >> 8) % width comes from a multiplicative
//   inverse, exact for the 24-bit x >> 8: no division.
// - pass 2 (pass2_kernel, one CTA per partition) gathers its partition's
//   run from every tile's block, adds the pairs into R sums in shared
//   memory with shared atomics, and writes (first chunk) or adds (later
//   chunks) its slice of the sketch once: no global float atomic, no
//   zeroed sketch.
// Where a partition's run starts inside a tile's block depends only on the
// element indices, rows and width, not on the data: start_kernel computes
// that table (uint16, parts x tiles) once per shape, and the caller keeps
// it; both encodes read the same table. The order of the pairs inside a
// run and of the shared atomics is not fixed, so on inputs whose partial
// sums are not all exact the sketch equals the sequential reference only
// up to fp32 reassociation.
#include <algorithm>

#include "sketch_common.cuh"
#include "state_read.cuh"

namespace compress {
namespace {

constexpr int PART_SHIFT = 14;              // R = 2^14 buckets a partition
constexpr unsigned HASH_BUCKETS = 1u << 24;  // buckets a hash can reach

struct Parts {
  SketchHash hp;
  unsigned long long magic;   // 2^64 / width rounded up (mod 2^64)
  int per_row;                // partitions a row, ceil(min(width, 2^24) / R)
  int parts;                  // rows * per_row
};

// Pass 1 and the start table work in tiles of TILE elements, 16 a thread,
// one row of a tile at a time; pass 2 loads P2_BATCH pairs a lane before
// its atomics.
constexpr int P1_THREADS = 512;
constexpr int P1_WARPS = P1_THREADS / 32;
constexpr int TILE = P1_THREADS * PER_THREAD;    // 8192 elements
constexpr int P2_THREADS = 512;
constexpr int P2_WARPS = P2_THREADS / 32;
constexpr int P2_BATCH = 8;

// n % width for n < 2^32 (Lemire's fastmod: the low 64 bits of magic * n,
// times width, high half)
__device__ __forceinline__ unsigned fastmod(unsigned n,
                                            unsigned long long magic,
                                            unsigned width) {
  return static_cast<unsigned>(__umul64hi(magic * n, width));
}

// row r's bucket of element idx, and whether its sign is +1
__device__ __forceinline__ unsigned bucket(const Parts& L, int r,
                                           unsigned idx, bool* pos) {
  const unsigned x = idx * L.hp.mult[r] + L.hp.add[r];
  *pos = x >> 31;
  return fastmod(x >> 8, L.magic, L.hp.width);
}

// Exclusive scan of cnt[0, n) into start[0, n) by the whole CTA, which
// leaves cnt zeroed for the next count.
__device__ __forceinline__ void block_scan(int* cnt, int* start, int n,
                                           int* warp_sum) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (n + P1_THREADS - 1) / P1_THREADS;
  const int lo = min(static_cast<int>(threadIdx.x) * per, n);
  const int hi = min(lo + per, n);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += cnt[i];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < P1_WARPS ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < P1_WARPS; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < P1_WARPS) warp_sum[lane] = w;
  }
  __syncthreads();
  int base = incl - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    start[i] = base;
    base += cnt[i];
    cnt[i] = 0;
  }
  __syncthreads();
}

// start[p * tiles + t] for every partition p of tile t of the whole J:
// where p's run begins in the tile's block (the pairs of all partitions
// before p). One CTA a tile at a time; no data read.
__global__ void __launch_bounds__(P1_THREADS)
start_kernel(uint16_t* __restrict__ start_out, const Parts L, long long j,
             long long tiles) {
  extern __shared__ int tally[];
  int* cnt = tally;                  // [parts]
  int* start = cnt + L.parts;        // [parts]
  int* warp_sum = start + L.parts;   // [P1_WARPS]
  for (int p = threadIdx.x; p < L.parts; p += P1_THREADS) cnt[p] = 0;
  __syncthreads();
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long end = min((t + 1) * TILE, j);
    for (long long e = t * TILE + threadIdx.x; e < end; e += P1_THREADS) {
#pragma unroll
      for (int r = 0; r < SKETCH_MAX_ROWS; ++r) {
        if (r < L.hp.rows) {
          bool pos;
          const unsigned h = bucket(L, r, static_cast<unsigned>(e), &pos);
          atomicAdd(&cnt[r * L.per_row + (h >> PART_SHIFT)], 1);
        }
      }
    }
    __syncthreads();
    block_scan(cnt, start, L.parts, warp_sum);
    for (int p = threadIdx.x; p < L.parts; p += P1_THREADS) {
      start_out[p * tiles + t] = static_cast<uint16_t>(start[p]);
    }
    __syncthreads();
  }
}

// Pass 1's shared memory: the pair counts of one row's partitions, their
// scan, and the row's pairs of the tile staged in partition order.
struct Stage {
  int* cnt;          // [per_row]
  int* start;        // [per_row]
  int* warp_sum;     // [P1_WARPS]
  float* val;        // [TILE], 16-byte aligned
  uint16_t* loc;     // [TILE]
};

__host__ __device__ inline size_t stage_head(int per_row) {
  return (sizeof(int) * (2 * per_row + P1_WARPS) + 15) / 16 * 16;
}

__host__ __device__ inline size_t stage_bytes(int per_row) {
  return stage_head(per_row) + TILE * (sizeof(float) + sizeof(uint16_t));
}

__device__ Stage stage_of(unsigned char* smem, int per_row) {
  Stage st;
  st.cnt = reinterpret_cast<int*>(smem);
  st.start = st.cnt + per_row;
  st.warp_sum = st.start + per_row;
  st.val = reinterpret_cast<float*>(smem + stage_head(per_row));
  st.loc = reinterpret_cast<uint16_t*>(st.val + TILE);
  return st;
}

// Every row's pairs of one tile into the tile's block (pl, pv point at
// it), a row at a time: the thread's PER_THREAD elements (idx, a; the
// first `valid` of them, the rest masked) are hashed once and ranked
// within their partition with a shared atomic; after the scan of the
// counts they are staged in partition order and the row's run of m
// pairs is copied out contiguously (16-byte streaming stores on a full
// tile: pass 2 reads them only after the whole chunk).
__device__ __forceinline__ void emit_tile(
    const Parts& L, const Stage& st, uint16_t* __restrict__ pl,
    float* __restrict__ pv, const unsigned (&idx)[PER_THREAD],
    const float (&a)[PER_THREAD], int valid, int m) {
  const unsigned mask = (1u << PART_SHIFT) - 1;
  for (int r = 0; r < L.hp.rows; ++r) {
    unsigned h[PER_THREAD];
    int rank[PER_THREAD];
    unsigned positive = 0;
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (k < valid) {
        bool pos;
        h[k] = bucket(L, r, idx[k], &pos);
        positive |= static_cast<unsigned>(pos) << k;
        rank[k] = atomicAdd(&st.cnt[h[k] >> PART_SHIFT], 1);
      }
    }
    __syncthreads();
    block_scan(st.cnt, st.start, L.per_row, st.warp_sum);
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
      if (k < valid) {
        const int slot = st.start[h[k] >> PART_SHIFT] + rank[k];
        st.val[slot] = (positive >> k) & 1 ? a[k] : -a[k];
        st.loc[slot] = static_cast<uint16_t>(h[k] & mask);
      }
    }
    __syncthreads();
    uint16_t* lo = pl + static_cast<long long>(r) * m;
    float* vo = pv + static_cast<long long>(r) * m;
    if (m == TILE) {
      for (int v = threadIdx.x; v < TILE / 8; v += P1_THREADS) {
        __stcs(reinterpret_cast<uint4*>(lo) + v,
               reinterpret_cast<const uint4*>(st.loc)[v]);
      }
      for (int v = threadIdx.x; v < TILE / 4; v += P1_THREADS) {
        __stcs(reinterpret_cast<float4*>(vo) + v,
               reinterpret_cast<const float4*>(st.val)[v]);
      }
    } else {
      for (int s = threadIdx.x; s < m; s += P1_THREADS) {
        lo[s] = st.loc[s];
        vo[s] = st.val[s];
      }
    }
    // the next row's first barrier orders this copy before the staging
    // is written again
  }
}

// FUSED: a = err + g, written to a_out bitwise (the fused sweep); else a
// = g, the given a, and err, a_out are unused (the encode). S is the error
// state's type (fp32, or bf16 widened in registers); GATED masks the
// inputs by the participation bit *gate > 0.5 and the decay first, as the
// reference's masked_inputs feeds its kernel (a sitting-out worker's a is
// its decayed error, rounded to S, plus +0.0). g, err, a_out start at the
// chunk's first element e0; n elements; pl, pv hold the chunk's tile
// blocks
template <bool VEC, bool FUSED, typename S, bool GATED>
__global__ void __launch_bounds__(P1_THREADS)
pass1_kernel(const float* __restrict__ g, const S* __restrict__ err,
             float* __restrict__ a_out, const float* __restrict__ gate,
             float decay, uint16_t* __restrict__ pl,
             float* __restrict__ pv, const Parts L, long long e0,
             long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  using Read = StateRead<S>;
  const Stage st = stage_of(smem, L.per_row);
  for (int q = threadIdx.x; q < L.per_row; q += P1_THREADS) st.cnt[q] = 0;
  bool p = true;   // the participation bit (the gated form reads it)
  if constexpr (GATED) p = *gate > 0.5f;
  __syncthreads();
  const long long tiles = (n + TILE - 1) / TILE;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long base = t * TILE;
    const long long block = base * L.hp.rows;
    unsigned idx[PER_THREAD];
    float a[PER_THREAD];
    if (VEC && base + TILE <= n) {
      const float4* g4 = reinterpret_cast<const float4*>(g + base);
      float4* a4 = FUSED ? reinterpret_cast<float4*>(a_out + base) : nullptr;
      float4 v[PER_THREAD / 4], ev[PER_THREAD / 4];
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        v[r] = __ldcs(&g4[r * P1_THREADS + threadIdx.x]);
        if constexpr (FUSED) {
          ev[r] = Read::load4(err + base, r * P1_THREADS + threadIdx.x);
        }
      }
#pragma unroll
      for (int r = 0; r < PER_THREAD / 4; ++r) {
        if constexpr (FUSED) {
          if constexpr (GATED) mask_inputs<Read::BF16>(p, decay, v[r], ev[r]);
          v[r].x = __fadd_rn(ev[r].x, v[r].x);
          v[r].y = __fadd_rn(ev[r].y, v[r].y);
          v[r].z = __fadd_rn(ev[r].z, v[r].z);
          v[r].w = __fadd_rn(ev[r].w, v[r].w);
          __stcs(&a4[r * P1_THREADS + threadIdx.x], v[r]);
        }
        const unsigned i = static_cast<unsigned>(
            e0 + base + 4LL * (r * P1_THREADS + threadIdx.x));
        idx[4 * r] = i;
        idx[4 * r + 1] = i + 1;
        idx[4 * r + 2] = i + 2;
        idx[4 * r + 3] = i + 3;
        a[4 * r] = v[r].x;
        a[4 * r + 1] = v[r].y;
        a[4 * r + 2] = v[r].z;
        a[4 * r + 3] = v[r].w;
      }
      emit_tile(L, st, pl + block, pv + block, idx, a, PER_THREAD, TILE);
    } else {
      // the ragged tile: element k of the thread is base + tid + k * threads
      const int m = static_cast<int>(min(static_cast<long long>(TILE),
                                         n - base));
      int valid = 0;
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const int i = static_cast<int>(threadIdx.x) + k * P1_THREADS;
        if (i < m) {
          const long long e = base + i;
          if constexpr (FUSED) {
            float x = g[e];
            float ee = Read::load1(err, e);
            if constexpr (GATED) mask_inputs<Read::BF16>(p, decay, x, ee);
            a[k] = __fadd_rn(ee, x);
            a_out[e] = a[k];
          } else {
            a[k] = g[e];
          }
          idx[k] = static_cast<unsigned>(e0 + e);
          valid = k + 1;
        }
      }
      emit_tile(L, st, pl + block, pv + block, idx, a, valid, m);
    }
  }
}

// One CTA per partition p; its run in tile t of the chunk is
// [start[p][t], start[p + 1][t]) of the tile's block (the last partition's
// ends at the block's end). The starts are kept mod 2^16: a run holds at
// most TILE pairs, so its length is the difference mod 2^16. The warps
// take the tiles in turn; a warp reads the runs of 32 tiles at once and
// walks them as one flat run, 32 * P2_BATCH pairs loaded before it adds
// any of them.
__global__ void __launch_bounds__(P2_THREADS)
pass2_kernel(const uint16_t* __restrict__ pl, const float* __restrict__ pv,
             const uint16_t* __restrict__ start, long long start_stride,
             float* __restrict__ sk, const Parts L, long long n,
             int accumulate) {
  extern __shared__ float acc[];
  const int R = 1 << PART_SHIFT;
  const int p = blockIdx.x;
  const int r = p / L.per_row;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long first = static_cast<long long>(p - r * L.per_row)
                          << PART_SHIFT;
  for (int b = threadIdx.x; b < R; b += P2_THREADS) acc[b] = 0.0f;
  __syncthreads();
  const long long tiles = (n + TILE - 1) / TILE;
  const uint16_t* s_row = start + p * start_stride;
  const uint16_t* e_row = p + 1 < L.parts ? s_row + start_stride : nullptr;
  constexpr int SPAN = 32 * P2_BATCH;
  for (long long t0 = 32LL * warp; t0 < tiles; t0 += 32LL * P2_WARPS) {
    // lane l holds the run of tile t0 + l: its first pair and length
    const long long tl = t0 + lane;
    long long s = 0;
    int len = 0;
    if (tl < tiles) {
      const int m = static_cast<int>(min(static_cast<long long>(TILE),
                                         n - tl * TILE));
      const int s16 = s_row[tl];
      const int e16 = e_row ? e_row[tl] : L.hp.rows * m;
      s = tl * TILE * L.hp.rows + s16;
      len = (e16 - s16) & 0xFFFF;
    }
    // the 32 runs as one flat index space: lane l's pairs are f = l, l +
    // 32, ... of it; tile i of the pair f is the count of runs whose
    // inclusive end is <= f (a five-step search over the lanes)
    int incl = len;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const long long sx = s - (incl - len);    // run start minus its offset
    const int total = __shfl_sync(0xffffffffu, incl, 31);
    for (int f0 = 0; f0 < total; f0 += SPAN) {
      uint16_t lv[P2_BATCH];
      float vv[P2_BATCH];
#pragma unroll
      for (int k = 0; k < P2_BATCH; ++k) {
        const int f = f0 + 32 * k + lane;
        int i = 0;
#pragma unroll
        for (int b = 16; b >= 1; b >>= 1) {
          if (__shfl_sync(0xffffffffu, incl, i + b - 1) <= f) i += b;
        }
        const long long at = __shfl_sync(0xffffffffu, sx, i & 31) + f;
        lv[k] = f < total ? pl[at] : 0;
        vv[k] = f < total ? pv[at] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < P2_BATCH; ++k) {
        if (f0 + 32 * k + lane < total) atomicAdd(&acc[lv[k]], vv[k]);
      }
    }
  }
  __syncthreads();
  const long long nb = min(static_cast<long long>(R), L.hp.width - first);
  float* out = sk + static_cast<long long>(r) * L.hp.width + first;
  for (int b = threadIdx.x; b < nb; b += P2_THREADS) {
    out[b] = accumulate ? __fadd_rn(out[b], acc[b]) : acc[b];
  }
}

// the layout shared by the two entry points; 0 or a cudaError_t
int make_parts(Parts* L, const unsigned* mults, const unsigned* adds,
               int rows, unsigned width, unsigned long long magic) {
  if (rows < 1 || rows > SKETCH_MAX_ROWS || width == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *L = Parts{};
  for (int r = 0; r < rows; ++r) {
    L->hp.mult[r] = mults[r];
    L->hp.add[r] = adds[r];
  }
  L->hp.width = width;
  L->hp.rows = rows;
  L->magic = magic;
  L->per_row = static_cast<int>(
      ((std::min(width, HASH_BUCKETS) - 1) >> PART_SHIFT) + 1);
  L->parts = rows * L->per_row;
  return 0;
}

int set_smem(const void* kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

// The chunk loop of both encodes: pass 1 then pass 2 per chunk; pass 2
// writes the sketch at the first chunk and adds the later ones. FUSED
// reads g and err (of type S; gated by *gate and decay with GATED) and
// writes a; else g is the given a.
template <bool FUSED, typename S = float, bool GATED = false>
int encode(const float* g, const S* err, float* a, const float* gate,
           float decay, float* sk, uint16_t* pl, float* pv,
           const uint16_t* start, const unsigned* mults,
           const unsigned* adds, int rows, unsigned width,
           unsigned long long magic, long long j, long long chunk, int grid,
           int vec, cudaStream_t stream) {
  Parts L;
  int bad = make_parts(&L, mults, adds, rows, width, magic);
  if (bad) return bad;
  if (chunk < TILE || chunk % TILE) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem1 = stage_bytes(L.per_row);
  const size_t smem2 = (size_t{1} << PART_SHIFT) * sizeof(float);
  auto pass1 = vec ? pass1_kernel<true, FUSED, S, GATED>
                   : pass1_kernel<false, FUSED, S, GATED>;
  bad = set_smem(reinterpret_cast<const void*>(pass1), smem1);
  if (bad) return bad;
  bad = set_smem(reinterpret_cast<const void*>(pass2_kernel), smem2);
  if (bad) return bad;
  const long long stride = (j + TILE - 1) / TILE;
  const long long nchunks = j > 0 ? (j + chunk - 1) / chunk : 1;
  for (long long c = 0; c < nchunks; ++c) {
    const long long e0 = c * chunk;
    const long long n = std::min(chunk, j - e0);
    pass1<<<grid, P1_THREADS, smem1, stream>>>(
        g + e0, FUSED ? err + e0 : nullptr, FUSED ? a + e0 : nullptr, gate,
        decay, pl, pv, L, e0, n);
    cudaError_t e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return static_cast<int>(e1);
    pass2_kernel<<<L.parts, P2_THREADS, smem2, stream>>>(
        pl, pv, start + e0 / TILE, stride, sk, L, n, c > 0);
    e1 = cudaGetLastError();
    if (e1 != cudaSuccess) return static_cast<int>(e1);
  }
  return 0;
}

}  // namespace
}  // namespace compress

// The run starts of every partition in every tile of J (tiles =
// ceil(J / 8192)): start is (parts, tiles) uint16. mults, adds: host
// arrays of the rows' hash constants; magic: ceil(2^64 / width) mod 2^64.
// Returns the cudaError_t of the launch.
extern "C" int sketch_parts_start_launch(uint16_t* start,
                                         const unsigned* mults,
                                         const unsigned* adds, int rows,
                                         unsigned width,
                                         unsigned long long magic,
                                         long long j, int grid,
                                         cudaStream_t stream) {
  using namespace compress;
  Parts L;
  int bad = make_parts(&L, mults, adds, rows, width, magic);
  if (bad) return bad;
  const size_t smem = sizeof(int) * (2 * L.parts + P1_WARPS);
  bad = set_smem(reinterpret_cast<const void*>(start_kernel), smem);
  if (bad) return bad;
  const long long tiles = (j + TILE - 1) / TILE;
  start_kernel<<<grid, P1_THREADS, smem, stream>>>(start, L, j, tiles);
  return static_cast<int>(cudaGetLastError());
}

// g, err, a: (J,) fp32 with J < 2^32; sk: (rows, width) fp32, its first
// min(width, 2^24) columns written whole (no zeroing needed; the caller
// zeroes any beyond); pl, pv: the pair buffer, rows * chunk entries each;
// start: the (parts, tiles) table above; chunk: elements a chunk, a
// multiple of 8192. vec != 0 requires 16-byte-aligned g, err and a.
// Returns the cudaError_t of the launches.
extern "C" int sweep1_sketch_launch(const float* g, const float* err, float* a,
                                    float* sk, uint16_t* pl, float* pv,
                                    const uint16_t* start,
                                    const unsigned* mults,
                                    const unsigned* adds, int rows,
                                    unsigned width, unsigned long long magic,
                                    long long j, long long chunk, int grid,
                                    int vec, cudaStream_t stream) {
  return compress::encode<true>(g, err, a, nullptr, 1.0f, sk, pl, pv, start,
                                mults, adds, rows, width, magic, j, chunk,
                                grid, vec, stream);
}

// The bf16 read: err (J,) bf16, widened in registers; vec != 0 requires
// 16-byte-aligned g and a and an 8-byte-aligned err.
extern "C" int sweep1_sketch_bf16_launch(
    const float* g, const __nv_bfloat16* err, float* a, float* sk,
    uint16_t* pl, float* pv, const uint16_t* start, const unsigned* mults,
    const unsigned* adds, int rows, unsigned width, unsigned long long magic,
    long long j, long long chunk, int grid, int vec, cudaStream_t stream) {
  return compress::encode<true, __nv_bfloat16>(
      g, err, a, nullptr, 1.0f, sk, pl, pv, start, mults, adds, rows, width,
      magic, j, chunk, grid, vec, stream);
}

// The gated form: gate a 1-element device fp32 (the participation bit, >
// 0.5 is in), decay by value; otherwise as sweep1_sketch_launch.
extern "C" int sweep1_sketch_gated_launch(
    const float* g, const float* err, float* a, const float* gate,
    float decay, float* sk, uint16_t* pl, float* pv, const uint16_t* start,
    const unsigned* mults, const unsigned* adds, int rows, unsigned width,
    unsigned long long magic, long long j, long long chunk, int grid,
    int vec, cudaStream_t stream) {
  return compress::encode<true, float, true>(
      g, err, a, gate, decay, sk, pl, pv, start, mults, adds, rows, width,
      magic, j, chunk, grid, vec, stream);
}

// The gated form of the bf16 read.
extern "C" int sweep1_sketch_gated_bf16_launch(
    const float* g, const __nv_bfloat16* err, float* a, const float* gate,
    float decay, float* sk, uint16_t* pl, float* pv, const uint16_t* start,
    const unsigned* mults, const unsigned* adds, int rows, unsigned width,
    unsigned long long magic, long long j, long long chunk, int grid,
    int vec, cudaStream_t stream) {
  return compress::encode<true, __nv_bfloat16, true>(
      g, err, a, gate, decay, sk, pl, pv, start, mults, adds, rows, width,
      magic, j, chunk, grid, vec, stream);
}

// The same for a given a (J,) fp32: only the sketch is written. vec != 0
// requires a 16-byte-aligned a.
extern "C" int sketch_encode_launch(const float* a, float* sk, uint16_t* pl,
                                    float* pv, const uint16_t* start,
                                    const unsigned* mults,
                                    const unsigned* adds, int rows,
                                    unsigned width, unsigned long long magic,
                                    long long j, long long chunk, int grid,
                                    int vec, cudaStream_t stream) {
  return compress::encode<false>(a, static_cast<const float*>(nullptr),
                                 nullptr, nullptr, 1.0f, sk, pl, pv, start,
                                 mults, adds, rows, width, magic, j, chunk,
                                 grid, vec, stream);
}
