// aggregate_combine.cu — the Accumulo combiner: head flags and the sum
// per key of sorted (key, count) rows, batched over rows of a (B, n) grid
// (the tablets of the aggregate family at compaction).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/aggregate_combine/aggregate_combine.py::combine_blocks_pallas
// (`_kernel`), and on the device plane the jnp segment sum it shares its
// semantics with (src/repro/core/dist_ingest.py::_combine_dup_keys, the
// aggregate family's combiner-on-compaction).
//
// What bounds it on the H100: bytes. Each int64 key and count is read once
// (16 B), a head flag and an int64 sum written once (9 B): 25 B an entry
// over 3.35 TB/s — about 0.85 ms at the aggregate family's 2-way major,
// (64, 1,769,472).
//
// Design: one block per tile of kTile entries of one row, one entry per
// thread; int64 keys compared as they are (the TPU kernel split them into
// (hi, lo) int32 lanes). Heads compare against the previous entry of the
// row in device memory; every tile also opens a segment at its first
// entry. A block-wide scan of the heads numbers the tile's segments, each
// warp folds its lanes per segment by shuffles, and one shared-memory
// int64 atomic per (warp, segment) finishes the sum; head entries write
// it, the others 0. Counts may be int32 or int64 and always sum in int64
// (the TPU kernel summed int32 tile partials). A sentinel tail of 1.4M
// entries is one segment per tile, not one serial walk: each tile writes
// the position of its last true head (-1 if none), and a second launch,
// one block per row (segments.cuh::stitch_row), folds every tile-start
// entry that continues a key into that key's head — chains of any number
// of tiles included. The kernels allocate nothing and launch on the
// caller's stream; the wrapper passes the per-tile scratch.
#include <cstdint>
#include <cuda_runtime.h>

#include "segments.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;

template <typename C>
__global__ void __launch_bounds__(kTile)
aggregate_combine_kernel(const int64_t* __restrict__ keys, const C* __restrict__ counts,
                         long long n, long long tiles_per_row, bool* __restrict__ heads,
                         int64_t* __restrict__ sums, int64_t* __restrict__ tile_last_head) {
  __shared__ long long acc[kTile];
  __shared__ int warp_total[kWarps];
  __shared__ int last_head;

  const int t = threadIdx.x;
  const long long row = blockIdx.x / tiles_per_row;
  const long long tile = blockIdx.x % tiles_per_row;
  const long long i0 = tile * kTile;
  const long long i = i0 + t;
  const bool live = i < n;
  const int64_t* rk = keys + row * n;
  acc[t] = 0;
  if (t == 0) last_head = -1;
  __syncthreads();

  bool true_head = false;
  long long v = 0;
  if (live) {
    true_head = i == 0 || rk[i - 1] != rk[i];
    v = (long long)counts[row * n + i];
  }
  const bool head = t == 0 || true_head;
  const int seg = segments::block_segment_id<kWarps>(head, warp_total);
  v = segments::warp_segment_reduce(v, seg, [](long long a, long long b) { return a + b; });
  if (segments::first_of_run(seg)) {
    atomicAdd((unsigned long long*)&acc[seg], (unsigned long long)v);
  }
  if (true_head) atomicMax(&last_head, t);
  __syncthreads();
  if (live) {
    heads[row * n + i] = head;
    sums[row * n + i] = head ? acc[seg] : 0;
  }
  if (t == 0) tile_last_head[blockIdx.x] = last_head < 0 ? -1 : i0 + last_head;
}

constexpr int kStitch = 1024;

__global__ void __launch_bounds__(kStitch)
aggregate_combine_stitch(const int64_t* __restrict__ keys, long long n, long long tiles_per_row,
                         const int64_t* __restrict__ tile_last_head, bool* __restrict__ heads,
                         int64_t* __restrict__ sums) {
  __shared__ long long scratch[kStitch / 32];
  const long long row = blockIdx.x;
  bool* rh = heads + row * n;
  int64_t* rs = sums + row * n;
  segments::stitch_row<kStitch>(keys + row * n, tile_last_head + row * tiles_per_row,
                                tiles_per_row, kTile, scratch, [&](long long owner, long long i) {
    atomicAdd((unsigned long long*)&rs[owner], (unsigned long long)rs[i]);
    rs[i] = 0;
    rh[i] = false;
  });
}

template <typename C>
int launch(const void* keys, const void* counts, long long rows, long long n, void* heads,
           void* sums, void* tile_last_head, void* stream) {
  const long long tiles_per_row = (n + kTile - 1) / kTile;
  aggregate_combine_kernel<C><<<(unsigned)(rows * tiles_per_row), kTile, 0,
                                (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const C*)counts, n, tiles_per_row, (bool*)heads,
      (int64_t*)sums, (int64_t*)tile_last_head);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || tiles_per_row < 2) return (int)err;
  aggregate_combine_stitch<<<(unsigned)rows, kStitch, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, n, tiles_per_row, (const int64_t*)tile_last_head, (bool*)heads,
      (int64_t*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int aggregate_combine_i32(const void* keys, const void* counts, long long rows,
                                     long long n, void* heads, void* sums,
                                     void* tile_last_head, void* stream) {
  return launch<int32_t>(keys, counts, rows, n, heads, sums, tile_last_head, stream);
}

extern "C" int aggregate_combine_i64(const void* keys, const void* counts, long long rows,
                                     long long n, void* heads, void* sums,
                                     void* tile_last_head, void* stream) {
  return launch<int64_t>(keys, counts, rows, n, heads, sums, tile_last_head, stream);
}

extern "C" int aggregate_combine_tile_rows() { return kTile; }
