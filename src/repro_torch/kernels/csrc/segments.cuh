// segments.cuh — block-wide segment numbering and warp segmented
// reductions over a tile of rows sorted by key, for the aggregate_combine
// kernels.
//
// A tile is one block, one row per thread. A row heads a segment when it
// is the tile's first row or its key differs from the previous row's.
// block_segment_id numbers the tile's segments from 0 by a block-wide
// inclusive scan of the head flags (warp ballots, then one warp scans the
// warp totals). warp_segment_reduce folds each lane's value with the
// values of the later lanes of its segment inside the warp, by shuffles:
// afterwards the first lane of every (warp, segment) run holds that run's
// total, and one shared-memory atomic per run finishes the segment.
#pragma once

#include <cstdint>

namespace segments {

constexpr unsigned kFull = 0xffffffffu;

// Local segment id of this thread's row: the number of heads at or before
// it, minus one. Thread 0 must be a head. warp_total is shared scratch of
// kWarps ints. Every thread of the block must call it.
template <int kWarps>
__device__ __forceinline__ int block_segment_id(bool head, int* warp_total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(kFull, head);
  const int incl = __popc(ballot & (kFull >> (31 - lane)));
  if (lane == 31) warp_total[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int x = lane < kWarps ? warp_total[lane] : 0;
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane < kWarps) warp_total[lane] = x;
  }
  __syncthreads();
  return (warp == 0 ? 0 : warp_total[warp - 1]) + incl - 1;
}

// Fold v with the values of the later lanes of the same segment in this
// warp (segments are contiguous runs of lanes). Every lane must call it.
template <typename T, typename Op>
__device__ __forceinline__ T warp_segment_reduce(T v, int seg, Op op) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const T o = __shfl_down_sync(kFull, v, off);
    const int os = __shfl_down_sync(kFull, seg, off);
    if (lane + off < 32 && os == seg) v = op(v, o);
  }
  return v;
}

// True on the first lane of each run of equal segment ids in the warp.
__device__ __forceinline__ bool first_of_run(int seg) {
  const int prev = __shfl_up_sync(kFull, seg, 1);
  return (threadIdx.x & 31) == 0 || prev != seg;
}

// Inclusive running max of one value per thread over the block; total gets
// the block's max. scratch is shared, kWarps long longs. Every thread must
// call it.
template <int kWarps>
__device__ __forceinline__ long long block_max_scan(long long v, long long* scratch,
                                                    long long& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v = v > y ? v : y;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    long long x = lane < kWarps ? scratch[lane] : LLONG_MIN;
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x = x > y ? x : y;
    }
    if (lane < kWarps) scratch[lane] = x;
  }
  __syncthreads();
  if (warp > 0) {
    const long long w = scratch[warp - 1];
    v = v > w ? v : w;
  }
  total = scratch[kWarps - 1];
  __syncthreads();  // the next call rewrites scratch
  return v;
}

// Inclusive running sum of one value per thread over the block; total gets
// the block's sum. scratch is shared, kWarps Ts. Every thread must call it.
template <int kWarps, typename T>
__device__ __forceinline__ T block_sum_scan(T v, T* scratch, T& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int off = 1; off < 32; off <<= 1) {
    const T y = __shfl_up_sync(kFull, v, off);
    if (lane >= off) v += y;
  }
  if (lane == 31) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    T x = lane < kWarps ? scratch[lane] : T(0);
    for (int off = 1; off < 32; off <<= 1) {
      const T y = __shfl_up_sync(kFull, x, off);
      if (lane >= off) x += y;
    }
    if (lane < kWarps) scratch[lane] = x;
  }
  __syncthreads();
  if (warp > 0) v += scratch[warp - 1];
  total = scratch[kWarps - 1];
  __syncthreads();  // the next call rewrites scratch
  return v;
}

// The stitch of one row of `tiles` tiles of `tile` entries: keys is the
// row, last its tiles' last true heads. fold(owner, i) moves the partial
// at tile start i into the true head owner; tile starts that do not
// continue a key are left alone. Every thread of the block must call it.
template <int kThreads, typename Fold>
__device__ __forceinline__ void stitch_row(const int64_t* __restrict__ keys,
                                           const int64_t* __restrict__ last, long long tiles,
                                           int tile, long long* scratch, Fold fold) {
  long long carry = -1;  // the max of last[] over the earlier chunks
  for (long long base = 0; base < tiles; base += kThreads) {
    const long long t = base + threadIdx.x;
    const bool start = t >= 1 && t < tiles;
    long long total;
    long long owner = block_max_scan<kThreads / 32>(start ? last[t - 1] : -1, scratch, total);
    owner = owner > carry ? owner : carry;
    if (start) {
      const long long i = t * (long long)tile;
      if (keys[i] == keys[i - 1]) fold(owner, i);
    }
    carry = total > carry ? total : carry;
  }
}

}  // namespace segments
