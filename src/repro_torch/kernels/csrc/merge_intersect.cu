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
// Sentinels are ordinary values: the caller masks sentinel probes. The
// probes may come in any order.
//
// What bounds it on the H100: bytes. Each probe is read once, each row of
// the set once, one bool written per probe: rows * (n + m) * sizeof(key)
// + rows * n bytes over 3.35 TB/s. At the index step's shape (64 tablets,
// 12,288 int32 candidates probing 12,288 postings) that is about 7.1 MB,
// about 2 us — below a launch, so what a call costs is its launch and its
// chain of dependent loads.
//
// Design: one block per tile of kProbes probes of one row. The block reads
// its probes (kPer a thread, coalesced), reduces their min and max, and two
// warps co-rank them into the set at once: the lower bound of the min and
// the lower bound of the max, each by a 33-way warp search (32 lanes probe
// 32 evenly spaced keys a round; 12,288 keys take four dependent rounds, the
// first at positions every block of the row shares, instead of the fourteen
// loads of a binary search). Only the set's slice between the two bounds can
// hold a probe's key. The block stages that slice in shared memory, a chunk
// of kStage keys at a time, and every thread binary-searches its probes in
// the chunk. The index path's probes are sorted, so a tile's slice is about
// as long as the tile and one chunk holds it; unsorted probes, or a sparse
// set, only widen the slice and add chunks. Keys are compared as they are
// (the TPU kernel split int64 keys into (hi, lo-unsigned) int32 lanes, and
// needed m padded to a power of two); any n and m work, m = 0 included. The
// kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;
constexpr int kProbes = kThreads * kPer;
constexpr int kStageBytes = 16384;

// The first index p of the sorted set[0, m) with set[p] >= key, m if
// none, by a 33-way search: the 32 lanes probe 32 evenly spaced keys of the
// candidate range a round and keep the part between the last key below and
// the first at or above. Every lane of the warp must call it.
template <typename K>
__device__ __forceinline__ long long warp_lower_bound(const K* __restrict__ set, long long m,
                                                      K key) {
  const int lane = threadIdx.x & 31;
  long long lo = 0, hi = m;
  while (hi - lo > 32) {
    const long long len = hi - lo;
    const long long q = lo + len * (lane + 1) / 33;  // increasing, in [lo, hi)
    const int c = __popc(__ballot_sync(kFull, set[q] < key));  // a prefix of the lanes
    const long long q_last = __shfl_sync(kFull, q, c > 0 ? c - 1 : 0);
    const long long q_next = __shfl_sync(kFull, q, c < 32 ? c : 31);
    if (c > 0) lo = q_last + 1;
    if (c < 32) hi = q_next;
  }
  const long long q = lo + lane;
  return lo + __popc(__ballot_sync(kFull, q < hi && set[q] < key));
}

template <typename K>
__global__ void __launch_bounds__(kThreads)
member_mask_kernel(const K* __restrict__ a, const K* __restrict__ b, long long n, long long m,
                   long long tiles, bool* __restrict__ out) {
  constexpr int kStage = kStageBytes / (int)sizeof(K);
  __shared__ K stage[kStage];
  __shared__ K warp_min[kWarps], warp_max[kWarps];
  __shared__ long long slice[2];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = blockIdx.x / tiles;
  const long long j0 = (blockIdx.x % tiles) * kProbes;
  const K* probes = a + row * n;
  const K* set = b + row * m;

  // The tile's least and greatest probe, starting from its first, which
  // every tile has.
  K key[kPer];
  bool hit[kPer];
  K lo_key = probes[j0], hi_key = lo_key;
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long j = j0 + p * kThreads + t;
    hit[p] = false;
    key[p] = lo_key;
    if (j < n) {
      key[p] = probes[j];
      lo_key = key[p] < lo_key ? key[p] : lo_key;
      hi_key = hi_key < key[p] ? key[p] : hi_key;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const K ol = __shfl_xor_sync(kFull, lo_key, off);
    const K oh = __shfl_xor_sync(kFull, hi_key, off);
    lo_key = ol < lo_key ? ol : lo_key;
    hi_key = hi_key < oh ? oh : hi_key;
  }
  if (lane == 0) {
    warp_min[warp] = lo_key;
    warp_max[warp] = hi_key;
  }
  __syncthreads();
  // Warp 0 co-ranks the least probe, warp 1 the greatest, at once. A
  // probe k of the tile is in the set iff set[lower_bound(k)] == k, and
  // that position lies between the two lower bounds: only the slice
  // [lo, hi) can hold a probe's key. It leaves out the set's copies of the
  // greatest key but its first (the INT_MAX pads of a posting slab).
  if (warp < 2) {
    const K* w = warp == 0 ? warp_min : warp_max;
    K x = w[0];
    for (int i = 1; i < kWarps; ++i) x = warp == 0 ? (w[i] < x ? w[i] : x) : (x < w[i] ? w[i] : x);
    const long long p = warp_lower_bound(set, m, x);
    if (lane == 0) slice[warp] = warp == 0 ? p : (p < m ? p + 1 : m);
  }
  __syncthreads();
  const long long lo = slice[0], hi = slice[1];

  for (long long c0 = lo; c0 < hi; c0 += kStage) {
    const int len = (int)(hi - c0 < kStage ? hi - c0 : kStage);
#pragma unroll 4
    for (int x = t; x < len; x += kThreads) stage[x] = set[c0 + x];
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      if (j0 + p * kThreads + t >= n || hit[p]) continue;
      const K k = key[p];
      if (k < stage[0] || stage[len - 1] < k) continue;
      int s = 0, e = len;
      while (s < e) {
        const int mid = (s + e) >> 1;
        if (stage[mid] < k) {
          s = mid + 1;
        } else {
          e = mid;
        }
      }
      hit[p] = stage[s] == k;
    }
    __syncthreads();  // the next chunk rewrites stage
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const long long j = j0 + p * kThreads + t;
    if (j < n) out[row * n + j] = hit[p];
  }
}

template <typename K>
int launch(const void* a, const void* b, long long rows, long long n, long long m,
           void* out, void* stream) {
  const long long tiles = (n + kProbes - 1) / kProbes;
  member_mask_kernel<K><<<(unsigned)(rows * tiles), kThreads, 0, (cudaStream_t)stream>>>(
      (const K*)a, (const K*)b, n, m, tiles, (bool*)out);
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
