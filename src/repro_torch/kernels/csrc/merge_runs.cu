// merge_runs.cu — output ranks of K sorted runs, batched over tablets, by
// merge path.
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
// back, run o at [at[o], at[o+1]). Only the first lengths[b, o] entries of
// a run are live; the rest count as the dtype-max sentinel whatever they
// hold and are never read. A dead entry ranks after every live key, in
// (run, index) order: its own position plus the live entries of the later
// runs.
//
// What bounds it on the H100: bytes. The live keys are read once, the
// lengths once, and one int32 rank is written per entry: (live * key bytes
// + B*K*4 + B*N*4) over 3.35 TB/s.
//
// Design (merge path). The 2-way merge of runs j < o (A and B, A winning
// ties: A[i] goes first iff A[i] <= B[j]) is cut into tiles of kTile
// outputs. A tile's block finds where its first and last output diagonals
// cross the two live prefixes (the co-rank, one warp each: a 32-way search
// that narrows the range 32-fold per round of loads), loads the two
// contiguous slices into shared memory with coalesced loads, and each
// thread merges kItems outputs from a co-rank of its own in shared memory.
// The co-ranks use the same <= / < rule as the merge, so a tile boundary
// inside a run of equal keys splits it as the global merge does. Every
// output's value is staged in shared memory by its input index, so the
// writes of a tile's A side and B side are two contiguous, coalesced
// ranges.
//   K = 2: the merged position of an entry is its rank; pair tiles store it.
//   K >= 3: rank(x in run j at i) = sum over o != j of x's position in the
//   merge of runs j and o, minus (K-2)*i. All K(K-1)/2 pair merges of all
//   tablets run in one launch and add each entry's count from the other
//   run, position - i, into ranks zeroed first with int32 atomics; integer
//   addition is order-free, so the result is bit-exact.
// Entry tiles (no key reads) write the dead entries' closed form, and for
// K = 1 or K >= 3 the live entries' own index. One launch covers every pair,
// tile and tablet: blockIdx.y is the tablet, blockIdx.x a pair tile, then
// an entry tile. The pairs and their first tiles come in the parameter
// block. The kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxRuns = 32;
constexpr int kMaxPairs = kMaxRuns * (kMaxRuns - 1) / 2;
constexpr int kThreads = 256;
constexpr int kItems = 8;
constexpr int kTile = kThreads * kItems;  // outputs of one pair tile
constexpr int kEntryTile = 4096;          // entries of one entry tile
constexpr unsigned kFull = 0xffffffffu;

enum : int { kOneRun = 0, kTwoRuns = 1, kManyRuns = 2 };

struct Plan {
  long long at[kMaxRuns + 1];        // run bounds within a row
  int pair_start[kMaxPairs + 1];     // first tile of each pair; the last entry = pair tiles
  unsigned char pj[kMaxPairs], po[kMaxPairs];  // the pair's runs, pj < po
  int k, n_pairs, mode;
};

// Entries of A among the first d outputs of the merge of A[0:la] and
// B[0:lb] (A wins ties). Called by a whole warp; every lane gets the
// answer. Each round the 32 lanes probe 32 evenly spaced candidates at
// once, so a range of n shrinks to n/32 per round of dependent loads.
template <typename Key>
__device__ long long corank_warp(const Key* __restrict__ a, long long la,
                                 const Key* __restrict__ b, long long lb, long long d) {
  const int lane = threadIdx.x & 31;
  long long lo = d - lb > 0 ? d - lb : 0;
  long long hi = d < la ? d : la;
  while (lo < hi) {
    const long long step = (hi - lo + 31) / 32;
    const long long m = lo + lane * step;
    // A[m] is among the first d outputs iff A[m] <= B[d - m - 1].
    const bool before = m < hi && a[m] <= b[d - m - 1];
    const int c = __popc(__ballot_sync(kFull, before));
    const long long m_c = lo + c * step;
    const long long new_hi = (c < 32 && m_c < hi) ? m_c : hi;
    lo = c == 0 ? lo : lo + (c - 1) * step + 1;
    hi = new_hi;
  }
  return lo;
}

// The same co-rank over two slices in shared memory, one thread.
template <typename Key>
__device__ __forceinline__ int corank_local(const Key* a, int na, const Key* b, int nb, int d) {
  int lo = d - nb > 0 ? d - nb : 0;
  int hi = d < na ? d : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= b[d - mid - 1]) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Tile `tile` of the merge of runs j < o of one row: the live prefixes
// a[0:la] and b[0:lb] at ranks offsets out_a and out_b.
template <typename Key>
__device__ __forceinline__ void pair_tile(const Key* __restrict__ a, long long la,
                                          const Key* __restrict__ b, long long lb,
                                          int32_t* __restrict__ out_a,
                                          int32_t* __restrict__ out_b, long long tile,
                                          int mode) {
  __shared__ Key skeys[kTile];
  __shared__ int32_t svals[kTile];
  __shared__ long long cut[2];
  const long long d0 = tile * kTile;
  if (d0 >= la + lb) return;  // the tile lies past the live prefixes
  const long long d1 = d0 + kTile < la + lb ? d0 + kTile : la + lb;
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const long long c = corank_warp(a, la, b, lb, warp == 0 ? d0 : d1);
    if ((threadIdx.x & 31) == 0) cut[warp] = c;
  }
  __syncthreads();
  const long long i0 = cut[0], j0 = d0 - cut[0];
  const int na = (int)(cut[1] - i0);
  const int nd = (int)(d1 - d0);
  const int nb = nd - na;
  for (int x = threadIdx.x; x < nd; x += kThreads) {
    skeys[x] = x < na ? a[i0 + x] : b[j0 + x - na];
  }
  __syncthreads();
  const int dl0 = threadIdx.x * kItems;
  if (dl0 < nd) {
    const Key* sa = skeys;
    const Key* sb = skeys + na;
    int ia = corank_local(sa, na, sb, nb, dl0);
    int ib = dl0 - ia;
    const int dl1 = dl0 + kItems < nd ? dl0 + kItems : nd;
    for (int dl = dl0; dl < dl1; ++dl) {
      const long long pos = d0 + dl;
      // K = 2: the merged position is the rank; else the count of the
      // other run's entries before this one.
      if (ia < na && (ib >= nb || sa[ia] <= sb[ib])) {
        svals[ia] = (int32_t)(mode == kTwoRuns ? pos : pos - (i0 + ia));
        ++ia;
      } else {
        svals[na + ib] = (int32_t)(mode == kTwoRuns ? pos : pos - (j0 + ib));
        ++ib;
      }
    }
  }
  __syncthreads();
  for (int x = threadIdx.x; x < nd; x += kThreads) {
    int32_t* dst = x < na ? out_a + i0 + x : out_b + j0 + (x - na);
    if (mode == kTwoRuns) *dst = svals[x]; else atomicAdd(dst, svals[x]);
  }
}

// Entry tile `tile` of one row: the dead entries' closed form, and the
// live entries' own index where the mode needs it. at/live/later are the
// row's run bounds, live lengths and live entries of the later runs.
__device__ __forceinline__ void entry_tile(const long long* at, const long long* live,
                                           const long long* later, int32_t* __restrict__ out,
                                           long long n, long long tile, int mode) {
  const long long p0 = tile * kEntryTile;
  const long long p1 = p0 + kEntryTile < n ? p0 + kEntryTile : n;
  int j = 0;
  for (long long p = p0 + threadIdx.x; p < p1; p += kThreads) {
    while (p >= at[j + 1]) ++j;
    const long long i = p - at[j];
    if (i >= live[j]) {
      out[p] = (int32_t)(p + later[j]);  // dead: after every live key
    } else if (mode == kOneRun) {
      out[p] = (int32_t)i;
    } else if (mode == kManyRuns) {
      atomicAdd(&out[p], (int32_t)i);
    }
  }
}

template <typename Key>
__global__ void __launch_bounds__(kThreads)
merge_path_kernel(const Key* __restrict__ keys, const int32_t* __restrict__ lengths,
                  int32_t* __restrict__ ranks, const Plan plan) {
  __shared__ long long at[kMaxRuns + 1], live[kMaxRuns], later[kMaxRuns];
  __shared__ int pair[3];  // j, o and the tile within the pair
  const int k = plan.k;
  const long long b = blockIdx.y;
  const int t = blockIdx.x;
  const int pair_tiles = plan.pair_start[plan.n_pairs];
  if (threadIdx.x <= k) at[threadIdx.x] = plan.at[threadIdx.x];
  __syncthreads();
  if (threadIdx.x == 0) {
    long long acc = 0;
    for (int o = k - 1; o >= 0; --o) {
      const long long cap = at[o + 1] - at[o];
      const long long l = lengths[b * k + o];
      live[o] = l < 0 ? 0 : (l > cap ? cap : l);
      later[o] = acc;
      acc += live[o];
    }
    if (t < pair_tiles) {
      // The pair of this tile: the last whose first tile is <= t.
      int lo = 0, hi = plan.n_pairs - 1;
      while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (plan.pair_start[mid] <= t) lo = mid; else hi = mid - 1;
      }
      pair[0] = plan.pj[lo];
      pair[1] = plan.po[lo];
      pair[2] = t - plan.pair_start[lo];
    }
  }
  __syncthreads();
  const long long n = at[k];
  const Key* row = keys + b * n;
  int32_t* out = ranks + b * n;
  if (t < pair_tiles) {
    const int j = pair[0], o = pair[1];
    pair_tile<Key>(row + at[j], live[j], row + at[o], live[o], out + at[j], out + at[o],
                   pair[2], plan.mode);
  } else {
    entry_tile(at, live, later, out, n, t - pair_tiles, plan.mode);
  }
}

template <typename Key>
int launch(const void* keys, const long long* bounds, const void* lengths, void* ranks,
           long long batches, int k, long long n, void* stream) {
  if (k < 1 || k > kMaxRuns || batches > 65535) return (int)cudaErrorInvalidValue;
  Plan plan;
  plan.k = k;
  plan.mode = k == 1 ? kOneRun : (k == 2 ? kTwoRuns : kManyRuns);
  for (int o = 0; o <= k; ++o) plan.at[o] = bounds[o];
  for (int o = k + 1; o <= kMaxRuns; ++o) plan.at[o] = n;
  int pairs = 0;
  long long tiles = 0;
  for (int j = 0; j < k; ++j) {
    for (int o = j + 1; o < k; ++o) {
      plan.pj[pairs] = (unsigned char)j;
      plan.po[pairs] = (unsigned char)o;
      plan.pair_start[pairs] = (int)tiles;
      tiles += (bounds[j + 1] - bounds[j] + bounds[o + 1] - bounds[o] + kTile - 1) / kTile;
      ++pairs;
    }
  }
  plan.pair_start[pairs] = (int)tiles;
  plan.n_pairs = pairs;
  const long long entry_tiles = (n + kEntryTile - 1) / kEntryTile;
  if (tiles + entry_tiles >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (plan.mode == kManyRuns) {
    const cudaError_t err = cudaMemsetAsync(ranks, 0, (size_t)(batches * n) * sizeof(int32_t),
                                            (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((unsigned)(tiles + entry_tiles), (unsigned)batches);
  merge_path_kernel<Key><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const Key*)keys, (const int32_t*)lengths, (int32_t*)ranks, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// bounds: the K+1 run bounds in host memory; keys (B, N), lengths (B, K)
// int32 and ranks (B, N) int32 on the device.
extern "C" int merge_ranks_i32(const void* keys, const long long* bounds,
                               const void* lengths, void* ranks,
                               long long batches, int k, long long n,
                               void* stream) {
  return launch<int32_t>(keys, bounds, lengths, ranks, batches, k, n, stream);
}

extern "C" int merge_ranks_i64(const void* keys, const long long* bounds,
                               const void* lengths, void* ranks,
                               long long batches, int k, long long n,
                               void* stream) {
  return launch<long long>(keys, bounds, lengths, ranks, batches, k, n, stream);
}
