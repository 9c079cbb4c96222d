// merge_runs.cu — output ranks of K sorted runs, batched over tablets.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/merge_runs/merge_runs.py::merge_ranks_pallas
// (`_kernel`, `_count_rank`), which computes, for every element of K sorted
// runs, its position in the merged order:
//
//   rank(x in run j) = index of x within run j
//                    + |{y in run i : y <= x}|  for every run i < j
//                    + |{y in run i : y <  x}|  for every run i > j
//
// Earlier runs win ties, so the ranks are a permutation of [0, N) and the
// scatter that follows in ops.py is bit-identical to the reference's.
//
// Layout: each batch row of the (B, N) key tensor holds K runs back to
// back, run o at [bounds[o], bounds[o+1]). Only the first lengths[b, o]
// entries of a run are live; the rest count as the dtype-max sentinel
// whatever they hold. A live entry searches only the live prefix of every
// other run. A dead entry needs no search: it ranks after every live key,
// in (run, index) order, which is its own position plus the live entries
// of the later runs. So runs of different capacities merge without
// padding, and the sentinel tail of a sparsely filled base costs one write
// per entry.
//
// What bounds it on the H100: bytes. The live keys are read once, the
// lengths once, and one int32 rank is written per entry: (live * key bytes
// + B*K*4 + B*N*4) over 3.35 TB/s. The searches add up to sum log2(len)
// dependent loads per live entry, which hit L2 or HBM for large runs; the
// kernel is latency-bound on those loads long before it reaches the byte
// bound.
//
// Design: one thread per entry of the (B, N) tensor, B being the tablet
// batch, so one launch covers every tablet of a table family. Keys are read
// as int32 or int64 directly (the reference's (hi, lo) int32 lane split was
// a TPU layout choice). Each block stages the K+1 run bounds in shared
// memory. No run is held on chip: the runs of the main path are megabytes
// each. The kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRuns = 32;

template <typename Key>
__global__ void merge_ranks_kernel(const Key* __restrict__ keys,
                                   const long long* __restrict__ bounds,
                                   const int32_t* __restrict__ lengths,
                                   int32_t* __restrict__ ranks,
                                   long long batches, int k) {
  __shared__ long long at[kMaxRuns + 1];
  if (threadIdx.x <= k) at[threadIdx.x] = bounds[threadIdx.x];
  __syncthreads();
  const long long n = at[k];
  const long long idx = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (idx >= batches * n) return;
  const long long b = idx / n;
  const long long p = idx - b * n;
  int j = 0;
  while (p >= at[j + 1]) ++j;
  const Key* row = keys + b * n;
  const int32_t* len = lengths + b * k;
  // Live entries of run o, clamped into [0, capacity].
  auto live = [&](int o) {
    const long long cap = at[o + 1] - at[o];
    const long long l = len[o];
    return l < 0 ? 0LL : (l > cap ? cap : l);
  };
  const long long i = p - at[j];
  long long rank;
  if (i >= live(j)) {
    // Dead entry: after every live key, in (run, index) order.
    rank = p;
    for (int o = j + 1; o < k; ++o) rank += live(o);
  } else {
    const Key x = row[p];
    rank = i;
    for (int o = 0; o < k; ++o) {
      if (o == j) continue;
      const Key* run = row + at[o];
      long long lo = 0, hi = live(o);
      if (o < j) {
        // Upper bound: entries <= x of an earlier run order before x.
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (run[mid] <= x) lo = mid + 1; else hi = mid;
        }
      } else {
        // Lower bound: entries < x of a later run order before x.
        while (lo < hi) {
          const long long mid = (lo + hi) >> 1;
          if (run[mid] < x) lo = mid + 1; else hi = mid;
        }
      }
      rank += lo;
    }
  }
  ranks[idx] = (int32_t)rank;
}

template <typename Key>
int launch(const void* keys, const void* bounds, const void* lengths,
           void* ranks, long long batches, int k, long long n, void* stream) {
  if (k < 1 || k > kMaxRuns) return (int)cudaErrorInvalidValue;
  const long long total = batches * n;
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  merge_ranks_kernel<Key><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Key*)keys, (const long long*)bounds, (const int32_t*)lengths,
      (int32_t*)ranks, batches, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int merge_ranks_i32(const void* keys, const void* bounds,
                               const void* lengths, void* ranks,
                               long long batches, int k, long long n,
                               void* stream) {
  return launch<int32_t>(keys, bounds, lengths, ranks, batches, k, n, stream);
}

extern "C" int merge_ranks_i64(const void* keys, const void* bounds,
                               const void* lengths, void* ranks,
                               long long batches, int k, long long n,
                               void* stream) {
  return launch<long long>(keys, bounds, lengths, ranks, batches, k, n, stream);
}
