// aggregate_combine.cu — the Accumulo combiner over sorted (key, count)
// rows, batched over rows of a (B, n) grid (the tablets of a table family
// at compaction). Two entry points:
//
//   aggregate_combine_i32/_i64  head flags and the sum per key at its head
//                               (combine_blocks; the host combiner)
//   combine_compact             the combiner-on-compaction whole: unique
//                               keys compacted to the front, their sums at
//                               the same slots, cut to cap, and the number
//                               of unique keys per row
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/aggregate_combine/aggregate_combine.py::combine_blocks_pallas
// (`_kernel`), and on the device plane the jnp combine-and-compact it
// shares its semantics with (src/repro/core/dist_ingest.py::_combine_dup_keys
// plus the cut to the base's capacity: the aggregate family's sums, and the
// index family's dedup).
//
// aggregate_combine: what bounds it on the H100 is bytes. Each int64 key
// and count is read once (16 B), a head flag and an int64 sum written once
// (9 B): 25 B an entry over 3.35 TB/s — about 0.85 ms at the aggregate
// family's 2-way major, (64, 1,769,472).
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
// of tiles included.
//
// combine_compact: each row's first n_live keys are live and the rest count
// as the sentinel, whatever they hold. What bounds it is bytes: the live
// keys and every count read once (16 B a live entry, 8 B a tail count; tail
// keys are never read), and an int64 key and sum written per output slot (16
// B), cap slots a row; the dedup form (no counts) reads 8 B a live key and
// writes 8 B a slot. A row's head tiles, those that start at or before
// n_live, hold every head; past them every entry continues the sentinel
// segment. Four launches on the caller's stream, the first and third with a
// fixed number of blocks a row (about eight waves of resident blocks in
// all), each looping over its share of the row's tiles, so that a row's
// 2,700 tail tiles cost no block each: (1) the true heads of each head tile,
// kGroup tiles' keys loaded at once; (2) one block per row turns those into
// each head tile's first output slot, the row's segment count and n_unique;
// (3) over the head tiles, the block scan of segments.cuh numbers the tile's
// segments from that slot, sums the counts per segment, and each head writes
// its key and its tile's partial sum straight to its slot, while a tile
// whose first entry continues the previous tile's key keeps that segment's
// partial apart; then the row's blocks fill the slots no segment reaches
// with the sentinel and 0, and sum the counts past the head tiles (one
// atomic a block); (4) the kept partials and the tail sum are added to their
// segments' slots, one int64 atomic per (warp, slot). Sums are exact in
// int64 whatever their order. The kernels allocate nothing; the wrapper
// passes the per-tile scratch.
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

// ------------------------------------------------------------ combine_compact

constexpr int kScan = 1024;
constexpr int kCarry = 256;

__device__ __forceinline__ long long live_length(const int* __restrict__ n_live, long long row,
                                                 long long n) {
  const long long l = n_live[row];
  return l < 0 ? 0 : (l > n ? n : l);
}

// The tiles of a row that can hold a head: those that start at or before
// its live length. Every later entry continues the sentinel segment.
__device__ __forceinline__ long long head_tiles(long long live, long long tiles) {
  const long long t = live / kTile + 1;
  return t < tiles ? t : tiles;
}

// Key i of a row whose keys past `live` count as the sentinel.
__device__ __forceinline__ int64_t key_at(const int64_t* __restrict__ rk, long long i,
                                          long long live, int64_t sentinel) {
  return i < live ? rk[i] : sentinel;
}

// (1) per_row blocks a row, each over every per_row-th group of kGroup
// head tiles (their keys loaded at once): first[row, tile] = the tile's
// true heads.
constexpr int kGroup = 4;

__global__ void __launch_bounds__(kTile)
compact_count(const int64_t* __restrict__ keys, const int* __restrict__ n_live, long long n,
              long long tiles, long long per_row, int64_t sentinel, int* __restrict__ first) {
  const long long row = blockIdx.x / per_row;
  const long long live = live_length(n_live, row, n);
  const long long ht = head_tiles(live, tiles);
  const int64_t* rk = keys + row * n;
  for (long long g = (blockIdx.x % per_row) * kGroup; g < ht; g += per_row * kGroup) {
    bool head[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const long long i = (g + u) * kTile + threadIdx.x;
      head[u] = g + u < ht && i < n &&
                (i == 0 || key_at(rk, i, live, sentinel) != key_at(rk, i - 1, live, sentinel));
    }
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int count = __syncthreads_count(head[u]);
      if (threadIdx.x == 0 && g + u < ht) first[row * (tiles + 1) + g + u] = count;
    }
  }
}

// (2) One block per row, in place: first[row, t] becomes the number of
// segments that start before tile t (for the head tiles), first[row,
// tiles] the row's segment count; n_unique leaves out the sentinel
// segment, which a sorted row has last if at all. Zeroes the row's tail
// sum, carry[row, tiles].
__global__ void __launch_bounds__(kScan)
compact_scan(const int64_t* __restrict__ keys, const int* __restrict__ n_live, long long n,
             long long tiles, int64_t sentinel, int* __restrict__ first,
             int64_t* __restrict__ carry, int* __restrict__ n_unique) {
  __shared__ int scratch[kScan / 32];
  const long long row = blockIdx.x;
  const long long live = live_length(n_live, row, n);
  const long long ht = head_tiles(live, tiles);
  int* rf = first + row * (tiles + 1);
  int total_heads = 0;
  for (long long base = 0; base < ht; base += kScan) {
    const long long t = base + threadIdx.x;
    const int v = t < ht ? rf[t] : 0;
    int total;
    const int incl = segments::block_sum_scan<kScan / 32>(v, scratch, total);
    if (t < ht) rf[t] = total_heads + incl - v;
    total_heads += total;
  }
  if (threadIdx.x == 0) {
    rf[tiles] = total_heads;
    const bool sentinel_segment = live < n || keys[row * n + n - 1] == sentinel;
    n_unique[row] = total_heads - (sentinel_segment ? 1 : 0);
    if (carry != nullptr) carry[row * (tiles + 1) + tiles] = 0;
  }
}

// p[from, to) = value in 16-byte stores (one 8-byte store at either end
// where needed); this thread stores the pairs first, first + stride, ...
__device__ __forceinline__ void fill_range(int64_t* __restrict__ p, long long from, long long to,
                                           int64_t value, long long first, long long stride) {
  if (from >= to) return;
  if (reinterpret_cast<uintptr_t>(p + from) & 15) {
    if (first == 0) p[from] = value;
    ++from;
  }
  const long long pairs = (to - from) / 2;
  longlong2* v = reinterpret_cast<longlong2*>(p + from);
  const longlong2 w = make_longlong2(value, value);
#pragma unroll 4
  for (long long q = first; q < pairs; q += stride) v[q] = w;
  if (((to - from) & 1) && first == 0) p[to - 1] = value;
}

// (3) per_row blocks a row. Over every per_row-th head tile: keys and
// partial sums to their slots, and the partial of a segment the tile
// continues in carry[row, tile] (0 if none). Then, strided over the
// row's blocks: the fill of the slots no segment reaches, and the sum of
// the counts past the head tiles into carry[row, tiles].
template <typename C, bool kSums>
__global__ void __launch_bounds__(kTile)
compact_write(const int64_t* __restrict__ keys, const C* __restrict__ counts,
              const int* __restrict__ n_live, long long n, long long tiles, long long per_row,
              long long cap, int64_t sentinel, const int* __restrict__ first,
              int64_t* __restrict__ ukeys, int64_t* __restrict__ sums,
              int64_t* __restrict__ carry) {
  __shared__ long long acc[kTile];
  __shared__ int warp_total[kWarps];
  __shared__ long long warp_sum[kWarps];
  __shared__ bool lead_continues;

  const int t = threadIdx.x;
  const long long row = blockIdx.x / per_row;
  const long long b = blockIdx.x % per_row;
  const long long live = live_length(n_live, row, n);
  const long long ht = head_tiles(live, tiles);
  const int* rf = first + row * (tiles + 1);
  const long long nseg = rf[tiles];
  const int64_t* rk = keys + row * n;
  int64_t* uk = ukeys + row * cap;

  for (long long tile = b; tile < ht; tile += per_row) {
    const long long i = tile * kTile + t;
    const long long before = rf[tile];  // segments that start before this tile
    int64_t k = sentinel;
    bool true_head = false;
    long long v = 0;
    if (i < n) {
      k = key_at(rk, i, live, sentinel);
      true_head = i == 0 || k != key_at(rk, i - 1, live, sentinel);
      if (kSums) v = (long long)counts[row * n + i];
    }
    if (kSums) acc[t] = 0;
    if (t == 0) lead_continues = !true_head;
    // Synchronizes the block: acc and lead_continues are set after it.
    const int seg = segments::block_segment_id<kWarps>(t == 0 || true_head, warp_total);
    const long long slot = before + seg - (lead_continues ? 1 : 0);
    if (kSums) {
      v = segments::warp_segment_reduce(v, seg, [](long long a, long long c) { return a + c; });
      if (segments::first_of_run(seg)) {
        atomicAdd((unsigned long long*)&acc[seg], (unsigned long long)v);
      }
      __syncthreads();
    }
    if (true_head && slot < cap) {
      uk[slot] = k;
      if (kSums) sums[row * cap + slot] = acc[seg];
    }
    if (kSums && t == 0) {
      carry[row * (tiles + 1) + tile] = lead_continues && slot < cap ? acc[0] : 0;
    }
    __syncthreads();  // the next tile rewrites acc, warp_total and lead_continues
  }

  const long long stride = per_row * kTile;
  fill_range(uk, nseg, cap, sentinel, b * kTile + t, stride);
  if (kSums) fill_range(sums + row * cap, nseg, cap, 0, b * kTile + t, stride);
  // The counts past the head tiles continue the sentinel segment, slot
  // nseg - 1; its head lies in the last head tile.
  if (kSums && nseg - 1 < cap) {
    long long v = 0;
#pragma unroll 4
    for (long long i = ht * kTile + b * kTile + t; i < n; i += stride) {
      v += (long long)counts[row * n + i];
    }
    long long total;
    segments::block_sum_scan<kWarps>(v, warp_sum, total);
    if (t == 0 && total != 0) {
      atomicAdd((unsigned long long*)&carry[row * (tiles + 1) + tiles], (unsigned long long)total);
    }
  }
}

// (4) Add each head tile's carried partial to the slot of the segment it
// continues (first[row, t] - 1), one atomic per (warp, slot): the slots
// of a row's tiles never decrease, so a warp's equal slots are adjacent.
// The first block of a row also adds the row's tail sum to slot nseg - 1.
__global__ void __launch_bounds__(kCarry)
compact_carry(const int* __restrict__ first, const int64_t* __restrict__ carry,
              const int* __restrict__ n_live, long long n, long long tiles, long long chunks,
              long long cap, int64_t* __restrict__ sums) {
  const long long row = blockIdx.x / chunks;
  const long long chunk = blockIdx.x % chunks;
  const long long ht = head_tiles(live_length(n_live, row, n), tiles);
  const int* rf = first + row * (tiles + 1);
  const int64_t* rc = carry + row * (tiles + 1);
  if (chunk == 0 && threadIdx.x == 0) {
    const long long slot = rf[tiles] - 1;
    if (rc[tiles] != 0 && slot < cap) {
      atomicAdd((unsigned long long*)&sums[row * cap + slot], (unsigned long long)rc[tiles]);
    }
  }
  if (chunk * kCarry >= ht) return;  // the whole block
  const long long t = chunk * kCarry + threadIdx.x;
  long long v = 0;
  int slot = -1;
  if (t >= 1 && t < ht) {
    v = rc[t];
    slot = rf[t] - 1;
  }
  v = segments::warp_segment_reduce(v, slot, [](long long a, long long c) { return a + c; });
  if (segments::first_of_run(slot) && v != 0 && slot >= 0 && slot < cap) {
    atomicAdd((unsigned long long*)&sums[row * cap + slot], (unsigned long long)v);
  }
}

template <typename C, bool kSums>
int compact_launch(const void* keys, const void* counts, const void* n_live, long long rows,
                   long long n, long long cap, long long sentinel, void* first, void* carry,
                   void* ukeys, void* sums, void* n_unique, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  const long long tiles = (n + kTile - 1) / kTile;
  // Blocks a row: about eight waves of resident blocks over all rows,
  // each block looping over its share of the row's tiles and slots.
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = 8LL * sms * (2048 / kTile);
  long long per_row = (blocks + rows - 1) / rows;
  per_row = per_row < 1 ? 1 : (per_row > tiles ? tiles : per_row);
  const unsigned grid = (unsigned)(rows * per_row);
  compact_count<<<grid, kTile, 0, s>>>((const int64_t*)keys, (const int*)n_live, n, tiles,
                                       per_row, (int64_t)sentinel, (int*)first);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_scan<<<(unsigned)rows, kScan, 0, s>>>((const int64_t*)keys, (const int*)n_live, n,
                                                tiles, (int64_t)sentinel, (int*)first,
                                                (int64_t*)carry, (int*)n_unique);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  compact_write<C, kSums><<<grid, kTile, 0, s>>>(
      (const int64_t*)keys, (const C*)counts, (const int*)n_live, n, tiles, per_row, cap,
      (int64_t)sentinel, (const int*)first, (int64_t*)ukeys, (int64_t*)sums, (int64_t*)carry);
  err = cudaGetLastError();
  if (err != cudaSuccess || !kSums || tiles < 2) return (int)err;
  const long long chunks = (tiles + kCarry - 1) / kCarry;
  compact_carry<<<(unsigned)(rows * chunks), kCarry, 0, s>>>(
      (const int*)first, (const int64_t*)carry, (const int*)n_live, n, tiles, chunks, cap,
      (int64_t*)sums);
  return (int)cudaGetLastError();
}

}  // namespace

// keys int64 (rows, n) sorted over each row's first n_live (int32 (rows,))
// entries; counts (rows, n) of count_bytes 4 or 8, or none (count_bytes 0:
// the dedup form, no sums and no carry). Scratch: first int32 (rows,
// tiles + 1), carry int64 (rows, tiles + 1), tiles = ceil(n / kTile). Outputs:
// ukeys and sums int64 (rows, cap), n_unique int32 (rows,). n >= 1.
extern "C" int combine_compact(const void* keys, const void* counts, int count_bytes,
                               const void* n_live, long long rows, long long n, long long cap,
                               long long sentinel, void* first, void* carry, void* ukeys,
                               void* sums, void* n_unique, void* stream) {
  switch (count_bytes) {
    case 0:
      return compact_launch<int64_t, false>(keys, counts, n_live, rows, n, cap, sentinel, first,
                                            carry, ukeys, sums, n_unique, stream);
    case 4:
      return compact_launch<int32_t, true>(keys, counts, n_live, rows, n, cap, sentinel, first,
                                           carry, ukeys, sums, n_unique, stream);
    case 8:
      return compact_launch<int64_t, true>(keys, counts, n_live, rows, n, cap, sentinel, first,
                                           carry, ukeys, sums, n_unique, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

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
