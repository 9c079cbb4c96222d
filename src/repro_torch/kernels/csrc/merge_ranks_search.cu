// merge_ranks_search.cu — the earlier design of merge_runs.cu, kept as
// chip_smoke.py's yardstick for the merge-path kernel (it times both on
// the same inputs in one run). Nothing in the package calls it.
//
// Design: one thread per entry of the (B, N) tensor. A live entry runs one
// binary search into the live prefix of every other run (upper bound
// against earlier runs, lower bound against later ones), about
// sum log2(len) dependent loads from L2 or HBM with no reuse between
// neighbouring threads; a dead entry takes the closed form p + the live
// entries of the later runs. Same contract as merge_runs.cu, except that
// the run bounds come as a device array.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRuns = 32;

template <typename Key>
__global__ void search_ranks_kernel(const Key* __restrict__ keys,
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
  search_ranks_kernel<Key><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const Key*)keys, (const long long*)bounds, (const int32_t*)lengths,
      (int32_t*)ranks, batches, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int merge_ranks_search_i32(const void* keys, const void* bounds,
                                      const void* lengths, void* ranks,
                                      long long batches, int k, long long n,
                                      void* stream) {
  return launch<int32_t>(keys, bounds, lengths, ranks, batches, k, n, stream);
}

extern "C" int merge_ranks_search_i64(const void* keys, const void* bounds,
                                      const void* lengths, void* ranks,
                                      long long batches, int k, long long n,
                                      void* stream) {
  return launch<long long>(keys, bounds, lengths, ranks, batches, k, n, stream);
}
