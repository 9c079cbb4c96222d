// merge_intersect.cu — membership of each probe key in a sorted key set,
// batched over rows (the device index AND).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/merge_intersect/merge_intersect.py::intersect_mask_pallas
// and, on the device index path, the jnp form it shares its semantics with
// (src/repro/kernels/merge_intersect/ref.py::member_mask_keys, called per
// tablet by the reference's _combine_postings).
//
// out[r, j] = a[r, j] occurs in b[r, 0:m], each row of b sorted ascending.
// Sentinels are ordinary values: the caller masks sentinel probes.
//
// What bounds it on the H100: bytes. Each probe is read once, each row of
// the set once, one bool written per probe: rows * (n + m) * sizeof(key)
// + rows * n bytes over 3.35 TB/s. At the index step's shape (64 tablets,
// 12,288 int32 candidates probing 12,288 postings) that is about 7.1 MB,
// about 2 us — far below a launch, so a call is launch-bound.
//
// Design: one thread per probe, a lower-bound binary search over its row
// of b in device memory (ceil(log2(m + 1)) dependent loads; the upper
// levels of the search stay in L1/L2 across a warp), then an exact
// compare. The TPU kernel split int64 keys into (hi, lo-unsigned) int32
// lanes for the vector unit; here int32 and int64 keys are compared as
// they are, which is the same order for the store's non-negative keys and
// the INT64_MAX pad. The TPU kernel needed m padded to a power of two and
// n to its block size; here any n and m work, m = 0 included. Staging a
// tile of b in shared memory, or a merge-path co-rank, is later work. The
// kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename K>
__global__ void member_mask_kernel(const K* __restrict__ a, const K* __restrict__ b,
                                   long long rows, long long n, long long m,
                                   bool* __restrict__ out) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= rows * n) return;
  const K* set = b + (i / n) * m;
  const K key = a[i];
  long long lo = 0, hi = m;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (set[mid] < key) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[i] = lo < m && set[lo] == key;
}

template <typename K>
int launch(const void* a, const void* b, long long rows, long long n, long long m,
           void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (rows * n + threads - 1) / threads;
  member_mask_kernel<K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const K*)a, (const K*)b, rows, n, m, (bool*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int member_mask_i32(const void* a, const void* b, long long rows, long long n,
                               long long m, void* out, void* stream) {
  return launch<int32_t>(a, b, rows, n, m, out, stream);
}

extern "C" int member_mask_i64(const void* a, const void* b, long long rows, long long n,
                               long long m, void* out, void* stream) {
  return launch<int64_t>(a, b, rows, n, m, out, stream);
}
