// Sweep 2 of the fused compression pipeline, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/compress/kernel.py::_sweep2_kernel
// (launcher sweep2_pallas, want_mask=False): per 4096-element tile, flags =
// |score| >= tau; the tile's flag count; and an in-tile prefix-sum
// compaction of (|score|, global index) into the tile's own static slots
// [t*MAXPB, (t+1)*MAXPB). Unused slots hold (-inf, 0xFFFFFFFF); cnt holds the
// full count, so overflow shows as cnt > MAXPB.
//
// Bound: device-memory bytes. It reads 4 B per element and writes
// rows*MAXPB*8 B of slots plus 4 B per tile (3.63 GB at J = 892,032,000 and
// MAXPB = 33, about 1.08 ms at 3.35 TB/s).
//
// Design. One CTA per tile, each thread owning 16 consecutive elements (four
// 16-byte loads on full tiles; the ragged last tile is masked and its
// missing lanes never flag). A warp-shuffle scan of the per-thread flag
// counts, then a scan of the eight warp totals, gives every flagged element
// its slot. There is no global atomic cursor: slots are static per tile and
// filled in element order, so candidate order equals global-index order,
// which the trim's tie-break relies on, and slots, indices and counts are
// bitwise equal to the plain version and to the Pallas kernel.
#include "compress_common.cuh"

namespace compress {
namespace {

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
sweep2_kernel(const float* __restrict__ score, const float* __restrict__ tau_ptr,
              float* __restrict__ vals, unsigned* __restrict__ idx,
              int* __restrict__ cnt, long long j, int maxpb) {
  __shared__ int warp_excl[WARPS];
  __shared__ int block_total;
  const long long t = blockIdx.x;
  const long long first = t * BLOCK + threadIdx.x * PER_THREAD;
  const float tau = *tau_ptr;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float key[PER_THREAD];
  unsigned flags = 0;
  if (VEC && (t + 1) * BLOCK <= j) {
    const float4* s4 = reinterpret_cast<const float4*>(score + first);
#pragma unroll
    for (int r = 0; r < PER_THREAD / 4; ++r) {
      const float4 v = __ldcs(&s4[r]);
      key[4 * r + 0] = fabsf(v.x);
      key[4 * r + 1] = fabsf(v.y);
      key[4 * r + 2] = fabsf(v.z);
      key[4 * r + 3] = fabsf(v.w);
    }
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      flags |= static_cast<unsigned>(key[i] >= tau) << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER_THREAD; ++i) {
      const bool live = first + i < j;
      key[i] = live ? fabsf(score[first + i]) : 0.0f;
      flags |= static_cast<unsigned>(live && key[i] >= tau) << i;
    }
  }

  const int local = __popc(flags);
  int incl = local;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int n = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += n;
  }
  if (lane == 31) warp_excl[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int tot = lane < WARPS ? warp_excl[lane] : 0;
    int w = tot;
#pragma unroll
    for (int off = 1; off < WARPS; off <<= 1) {
      const int n = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += n;
    }
    __syncwarp();
    if (lane < WARPS) warp_excl[lane] = w - tot;
    if (lane == WARPS - 1) block_total = w;
  }
  __syncthreads();

  const int total = block_total;
  int pos = warp_excl[warp] + incl - local;
  float* vrow = vals + t * maxpb;
  unsigned* irow = idx + t * maxpb;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    if ((flags >> i) & 1u) {
      if (pos < maxpb) {
        vrow[pos] = key[i];
        irow[pos] = static_cast<unsigned>(first + i);
      }
      ++pos;
    }
  }
  for (int s = min(total, maxpb) + threadIdx.x; s < maxpb; s += THREADS) {
    vrow[s] = __int_as_float(0xff800000);   // -inf
    irow[s] = 0xFFFFFFFFu;
  }
  if (threadIdx.x == 0) cnt[t] = total;
}

}  // namespace
}  // namespace compress

// score: (J,) fp32 with J < 2^32 - 1; tau: (1,) fp32 on the device;
// vals: (rows*maxpb,) fp32; idx: (rows*maxpb,) uint32 bits; cnt: (rows,)
// int32. vec != 0 requires a 16-byte-aligned score. Returns the
// cudaError_t of the launch.
extern "C" int sweep2_launch(const float* score, const float* tau, float* vals,
                             unsigned* idx, int* cnt, long long j, int maxpb,
                             int vec, cudaStream_t stream) {
  using namespace compress;
  const long long rows = (j + BLOCK - 1) / BLOCK;
  if (vec) {
    sweep2_kernel<true><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        score, tau, vals, idx, cnt, j, maxpb);
  } else {
    sweep2_kernel<false><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
        score, tau, vals, idx, cnt, j, maxpb);
  }
  return static_cast<int>(cudaGetLastError());
}
