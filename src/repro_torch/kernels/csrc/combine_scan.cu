// combine_scan.cu — fused scan-time filter and group combine over rows
// sorted by group key (the iterator stack's terminal CombinerIterator).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/combine_scan/combine_scan.py::combine_scan_pallas
// (`_kernel`): per row the predicate program; segment heads where the
// group key changes; per segment the masked sum, min or max of the values
// (count: of ones) and the number of matching rows, written at the
// segment's head.
//
// What bounds it on the H100: bytes. Each row's key (8 B), value (4 B)
// and F codes (4F B) are read once; a head flag (1 B), an int64 aggregate
// (8 B) and an int32 count (4 B) are written once: (12 + 4F + 13) n bytes
// over 3.35 TB/s — at 1,048,576 rows of 12 fields about 23 us.
//
// Design: one block per tile of kTile rows, one row per thread. The TPU
// kernel split the int64 keys into (hi, lo) int32 lanes and padded the
// fields to 128 lanes; here keys are compared as int64 and the fields stay
// unpadded. The prepared program is staged in shared memory after the
// tile's accumulators while it fits, else its header only, with the codes
// searched in global memory (program_eval.cuh, shared with filter_scan);
// each thread evaluates its row. Head flags compare against the previous row in device memory, so a
// tile's first row is a head only when its key changes — except that every
// tile opens its own segment at its first row. Local segment ids come from
// a block-wide scan of the heads; each warp folds its lanes per segment by
// shuffles, and one shared-memory atomic per (warp, segment) adds into the
// segment's accumulator: int64 for sum and count (the TPU kernel's int32
// tile partials wrapped for large values; this kernel needs no int64
// fallback), int32 values in an int64 slot for min and max (identity
// INT32_MAX and INT32_MIN, as jax.ops.segment_min/max give an empty
// segment), and an int32 match count. Head rows write their segment's
// results; other rows write the identity and 0. Each tile also writes the
// position of its last true head (a key change, not a tile start), or -1,
// and a second launch of one block (segments.cuh::stitch_row) folds every
// tile-start row that continues the previous tile's group into that
// group's true head with one atomic each. The kernels allocate nothing
// and launch on the caller's stream; the wrapper passes the per-tile
// scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "program_eval.cuh"
#include "segments.cuh"

namespace {

constexpr int kTile = 512;
constexpr int kWarps = kTile / 32;
// Dynamic shared memory before the program: kTile int64 accumulators and
// kTile int32 counts.
constexpr int kAccBytes = kTile * (int)(sizeof(long long) + sizeof(int32_t));
enum : int { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };

__device__ __forceinline__ long long identity(int op) {
  return op == kMin ? (long long)INT_MAX : (op == kMax ? (long long)INT_MIN : 0LL);
}

__global__ void __launch_bounds__(kTile)
combine_scan_kernel(const int64_t* __restrict__ keys, const int32_t* __restrict__ vals,
                    const int32_t* __restrict__ cols, long long n, int f,
                    const int32_t* __restrict__ words, int p, int header_words,
                    int staged, int op, bool* __restrict__ heads, int64_t* __restrict__ aggs,
                    int32_t* __restrict__ cnts, int64_t* __restrict__ tile_last_head) {
  extern __shared__ long long smem_acc[];  // kTile int64 accumulators, then
  int32_t* acc_cnt = (int32_t*)(smem_acc + kTile);  // kTile int32 counts, then
  int32_t* prog = acc_cnt + kTile;                  // the staged program words
  __shared__ int warp_total[kWarps];
  __shared__ int last_head;

  const int t = threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kTile;
  const long long row = row0 + t;
  const bool live = row < n;
  const long long ident = identity(op);
  program_eval::stage_words(prog, words, staged);
  smem_acc[t] = ident;
  acc_cnt[t] = 0;
  if (t == 0) last_head = -1;
  __syncthreads();

  bool true_head = false;
  bool hit = false;
  if (live) {
    const int64_t key = keys[row];
    true_head = row == 0 || keys[row - 1] != key;
    hit = program_eval::eval_row(
        cols + row * f, program_eval::program_view(prog, words, p, header_words, staged));
  }
  const bool head = t == 0 || true_head;
  const int seg = segments::block_segment_id<kWarps>(head, warp_total);

  // Rows past n contribute the identity, so they may share a segment.
  long long v = ident;
  if (hit) v = op == kCount ? 1LL : (long long)vals[row];
  int c = hit ? 1 : 0;
  if (op == kMin) {
    v = segments::warp_segment_reduce(v, seg,
                                      [](long long a, long long b) { return a < b ? a : b; });
  } else if (op == kMax) {
    v = segments::warp_segment_reduce(v, seg,
                                      [](long long a, long long b) { return a > b ? a : b; });
  } else {
    v = segments::warp_segment_reduce(v, seg, [](long long a, long long b) { return a + b; });
  }
  c = segments::warp_segment_reduce(c, seg, [](int a, int b) { return a + b; });
  if (segments::first_of_run(seg)) {
    if (op == kMin) {
      atomicMin(&smem_acc[seg], v);
    } else if (op == kMax) {
      atomicMax(&smem_acc[seg], v);
    } else {
      atomicAdd((unsigned long long*)&smem_acc[seg], (unsigned long long)v);
    }
    atomicAdd(&acc_cnt[seg], c);
  }
  if (true_head) atomicMax(&last_head, t);
  __syncthreads();
  if (live) {
    heads[row] = head;
    aggs[row] = head ? smem_acc[seg] : ident;
    cnts[row] = head ? acc_cnt[seg] : 0;
  }
  if (t == 0) tile_last_head[blockIdx.x] = last_head < 0 ? -1 : row0 + last_head;
}

constexpr int kStitch = 1024;

__global__ void __launch_bounds__(kStitch)
combine_scan_stitch(const int64_t* __restrict__ keys, long long tiles, int op,
                    const int64_t* __restrict__ tile_last_head, bool* __restrict__ heads,
                    int64_t* __restrict__ aggs, int32_t* __restrict__ cnts) {
  __shared__ long long scratch[kStitch / 32];
  const long long ident = identity(op);
  segments::stitch_row<kStitch>(keys, tile_last_head, tiles, kTile, scratch,
                                [&](long long owner, long long i) {
    long long* head = (long long*)&aggs[owner];
    if (op == kMin) {
      atomicMin(head, (long long)aggs[i]);
    } else if (op == kMax) {
      atomicMax(head, (long long)aggs[i]);
    } else {
      atomicAdd((unsigned long long*)head, (unsigned long long)aggs[i]);
    }
    atomicAdd(&cnts[owner], cnts[i]);
    aggs[i] = ident;
    cnts[i] = 0;
    heads[i] = false;
  });
}

}  // namespace

// The prepared program's words on the device, of which a block stages the
// first `staged` in shared memory after its accumulators.
extern "C" int combine_scan_tiles(const void* keys, const void* vals, const void* cols,
                                  long long n, int f, const void* words, int p,
                                  int header_words, int staged, int op, void* heads,
                                  void* aggs, void* cnts, void* tile_last_head, void* stream) {
  const long long blocks = (n + kTile - 1) / kTile;
  const size_t smem = (size_t)kAccBytes + (size_t)staged * sizeof(int32_t);
  cudaError_t err = program_eval::allow_shared(combine_scan_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  combine_scan_kernel<<<(unsigned)blocks, kTile, smem, (cudaStream_t)stream>>>(
      (const int64_t*)keys, (const int32_t*)vals, (const int32_t*)cols, n, f,
      (const int32_t*)words, p, header_words, staged, op, (bool*)heads, (int64_t*)aggs,
      (int32_t*)cnts, (int64_t*)tile_last_head);
  err = cudaGetLastError();
  if (err != cudaSuccess || blocks < 2) return (int)err;
  combine_scan_stitch<<<1, kStitch, 0, (cudaStream_t)stream>>>(
      (const int64_t*)keys, blocks, op, (const int64_t*)tile_last_head, (bool*)heads,
      (int64_t*)aggs, (int32_t*)cnts);
  return (int)cudaGetLastError();
}

extern "C" int combine_scan_tile_rows() { return kTile; }

// Shared memory a block takes besides the program: the accumulators and
// the static scratch (warp totals and the last head).
extern "C" int combine_scan_accumulator_bytes() {
  return kAccBytes + kWarps * (int)sizeof(int) + (int)sizeof(int);
}
