// combine_scan.cu — fused scan-time filter and group combine over rows
// sorted by group key (the iterator stack's terminal CombinerIterator).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/combine_scan/combine_scan.py::combine_scan_pallas
// (`_kernel`): per row the predicate program; a group wherever the group
// key changes; per group the masked sum, min or max of the values (count:
// of ones) and the number of matching rows.
//
// What bounds it on the H100: bytes. Each row's key (8 B), value (4 B, not
// read for count) and F codes (4F B) are read once. The per-row form
// (combine_scan_rows) writes a head flag (1 B), an int64 aggregate (8 B)
// and an int32 count (4 B) per row, as the TPU kernel does; the group form
// (combine_scan_groups) writes only each group with a matching row: its
// key, aggregate and count (20 B), and the number of such groups.
//
// Design. Persistent blocks, about the SM count times the blocks an SM
// holds (one: a block takes most of its shared memory); block b owns one
// contiguous chunk of rows and splits it into one contiguous strip run
// per warp. A warp walks its run a strip of kStrip = 128 rows at a time
// with a pipeline of its own: its lane 0 copies each strip's keys, values
// and (rows, F) codes into the warp's shared memory with TMA bulk copies
// (cp.async.bulk, completing on the warp's mbarrier), two strips ahead
// (three while it scans a strip it has read into registers), so every
// device-memory read is a contiguous stream; the ragged tail of
// the array's last strip, under 16 B, is read by plain loads. No
// __syncthreads stands in the loop, so one warp's loads and waits overlap
// another's work. The prepared program is staged once per block. Each
// lane evaluates kRows rows spaced 32 apart from the staged codes (no
// strided reads from device memory, program_eval.cuh), the warp ballots
// the verdicts, and then each lane folds kRows consecutive rows in
// registers into a Span: the rows before its first head, the groups that
// close inside it, and the group left open with its head row. A warp
// scan of Spans (shuffles) gives every lane the open group it continues;
// the warp's running Span is carried from strip to strip in registers, so
// a group is closed, and written, where its next head is found. The group
// form buffers a warp's closed groups in shared memory (flushed to a
// scratch in device memory when the buffer fills: only runs of more
// groups than a strip has rows); the per-row form writes its rows' flags,
// aggregates and counts with vector stores, the value of a group closed
// elsewhere at its head row. At the chunk's end the warps' Spans are
// joined in order, and each warp closes the group open at its run's start
// and writes its groups after the ones before it.
//
// Only the chunks' boundaries need a fix-up, one per block, by a decoupled
// look-back inside the launch: block b publishes its chunk's Span, then
// warp 0 reads its predecessors' (32 at a time) back to one that
// published an inclusive Span, and publishes its own. That gives the group
// open at the chunk's start, and, for the group form, where the chunk's
// groups go in the output, which keeps key order. The look-back words are
// cleared by a memset before the launch; the two are the call's only
// operations on the stream. Blocks wait only for blocks of lower index,
// which the card starts first. Sums and counts accumulate in int64 (the
// TPU kernel's int32 tile partials needed an int64 route for large
// values), min and max over int32 values in int64 registers, with
// identities INT32_MAX and INT32_MIN as jax.ops.segment_min/max give an
// empty segment. The kernels allocate nothing and launch on the caller's
// stream; the wrapper passes outputs and scratch.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "program_eval.cuh"

namespace {

constexpr int kRows = 4;               // consecutive rows a lane folds
constexpr int kStrip = 32 * kRows;     // rows a warp takes at a time
constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = 32 * kMaxWarps;
constexpr int kMaxStages = 3;
constexpr int kStaticBytes = 1024;  // the kernel's static shared memory, rounded up
constexpr unsigned kFull = 0xffffffffu;
enum : int { kSum = 0, kMin = 1, kMax = 2, kCount = 3 };
enum : int { kNone = 0, kAggregate = 1, kInclusive = 2 };  // a block's look-back word

template <int Op>
__device__ __forceinline__ long long identity() {
  return Op == kMin ? (long long)INT_MAX : (Op == kMax ? (long long)INT_MIN : 0LL);
}

template <int Op>
__device__ __forceinline__ long long fold(long long a, long long b) {
  if (Op == kMin) return a < b ? a : b;
  if (Op == kMax) return a > b ? a : b;
  return a + b;
}

// A span of rows: the aggregate and matching rows of its rows before its
// first head (all of them when it has none), the number of groups with a
// matching row that close inside it (at a head after its first), and the
// group open at its end, from its last head (open_head, -1 when none).
struct alignas(16) Span {
  long long lead_agg, open_agg;
  int lead_cnt, open_cnt, closed, open_head;
};

template <int Op>
__device__ __forceinline__ Span empty_span() {
  return {identity<Op>(), identity<Op>(), 0, 0, 0, -1};
}

// The span of a followed by b (associative; empty_span is its identity).
template <int Op>
__device__ __forceinline__ Span join(const Span& a, const Span& b) {
  Span r = b;
  if (a.open_head < 0) {
    r.lead_agg = fold<Op>(a.lead_agg, b.lead_agg);
    r.lead_cnt = a.lead_cnt + b.lead_cnt;
  } else {
    r.lead_agg = a.lead_agg;
    r.lead_cnt = a.lead_cnt;
    if (b.open_head < 0) {
      r.open_agg = fold<Op>(a.open_agg, b.lead_agg);
      r.open_cnt = a.open_cnt + b.lead_cnt;
      r.closed = a.closed;
      r.open_head = a.open_head;
    } else {
      r.closed = a.closed + (a.open_cnt + b.lead_cnt > 0) + b.closed;
    }
  }
  return r;
}

__device__ __forceinline__ Span shfl_up(const Span& s, int d) {
  return {__shfl_up_sync(kFull, s.lead_agg, d), __shfl_up_sync(kFull, s.open_agg, d),
          __shfl_up_sync(kFull, s.lead_cnt, d), __shfl_up_sync(kFull, s.open_cnt, d),
          __shfl_up_sync(kFull, s.closed, d), __shfl_up_sync(kFull, s.open_head, d)};
}

__device__ __forceinline__ Span shfl_down(const Span& s, int d) {
  return {__shfl_down_sync(kFull, s.lead_agg, d), __shfl_down_sync(kFull, s.open_agg, d),
          __shfl_down_sync(kFull, s.lead_cnt, d), __shfl_down_sync(kFull, s.open_cnt, d),
          __shfl_down_sync(kFull, s.closed, d), __shfl_down_sync(kFull, s.open_head, d)};
}

__device__ __forceinline__ Span shfl(const Span& s, int lane) {
  return {__shfl_sync(kFull, s.lead_agg, lane), __shfl_sync(kFull, s.open_agg, lane),
          __shfl_sync(kFull, s.lead_cnt, lane), __shfl_sync(kFull, s.open_cnt, lane),
          __shfl_sync(kFull, s.closed, lane), __shfl_sync(kFull, s.open_head, lane)};
}

// ---- the look-back words: per block a state word, its chunk's Span and
// ---- its inclusive Span (every row up to the chunk's end).
struct LookBack {
  int* state;   // [blocks]
  Span* chunk;  // [blocks]
  Span* incl;   // [blocks]
};

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void put_span(Span* p, const Span& s) {
  __stcg(&p->lead_agg, s.lead_agg);
  __stcg(&p->open_agg, s.open_agg);
  __stcg(&p->lead_cnt, s.lead_cnt);
  __stcg(&p->open_cnt, s.open_cnt);
  __stcg(&p->closed, s.closed);
  __stcg(&p->open_head, s.open_head);
}

__device__ __forceinline__ Span get_span(const Span* p) {
  return {__ldcg(&p->lead_agg), __ldcg(&p->open_agg), __ldcg(&p->lead_cnt),
          __ldcg(&p->open_cnt), __ldcg(&p->closed), __ldcg(&p->open_head)};
}

__device__ __forceinline__ void publish(const LookBack& lb, int b, int state, const Span& s) {
  put_span(state == kInclusive ? lb.incl + b : lb.chunk + b, s);
  __threadfence();
  store_release(lb.state + b, state);
}

// The Span of every row before chunk b (b > 0), by warp 0: 32
// predecessors at a time, each waited for until it has published, back to
// the nearest inclusive Span. (Every thread of the block waiting at once
// was slower on the H100: it loads L2 while other blocks still stream.)
template <int Op>
__device__ Span look_back(const LookBack& lb, int b) {
  const int lane = threadIdx.x & 31;
  Span after = empty_span<Op>();  // the spans between the window and b
  for (int hi = b - 1;; hi -= 32) {
    const int j = hi - lane;
    int state = kInclusive;  // before chunk 0: nothing
    if (j >= 0) {
      do {
        state = load_acquire(lb.state + j);
      } while (state == kNone);
    }
    const unsigned inc = __ballot_sync(kFull, state == kInclusive);
    const int stop = inc ? __ffs(inc) - 1 : 31;
    Span s = empty_span<Op>();
    if (j >= 0 && lane <= stop) s = get_span(state == kInclusive ? lb.incl + j : lb.chunk + j);
    // A higher lane holds an earlier chunk.
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Span o = shfl_down(s, d);
      if (lane + d < 32) s = join<Op>(o, s);
    }
    after = join<Op>(shfl(s, 0), after);
    if (inc) return after;
  }
}

// ---- TMA bulk copies into shared memory, completing on an mbarrier.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ uint32_t floor16(long long bytes) { return (uint32_t)(bytes & ~15LL); }

struct Args {
  const int64_t* keys;
  const int32_t* vals;  // null for count
  const int32_t* cols;
  long long n;
  int f;
  const int32_t* words;
  int p, header_words, staged;
  int stages, warp_strips;  // each warp's strips, so a block's chunk is warps * warp_strips
  // the per-row form
  bool* heads;
  int64_t* aggs;
  int32_t* cnts;
  // the group form, each of n entries, and the group count
  int64_t* group_keys;
  int64_t* group_aggs;
  int32_t* group_cnts;
  int64_t* n_groups;
  int64_t* spill_keys;  // a warp's groups past its buffer, at its run's first row
  int64_t* spill_aggs;
  int32_t* spill_cnts;
  LookBack lb;
};

// Bytes of one warp's stage: a strip's keys, values and codes.
__host__ __device__ __forceinline__ long long stage_bytes(int f, bool vals) {
  return (long long)kStrip * (8 + (vals ? 4 : 0) + 4LL * f);
}

// Bytes of one warp's group buffer: a strip's worth of groups.
__host__ __device__ __forceinline__ long long buffer_bytes(bool groups) {
  return groups ? (long long)kStrip * 20 : 0;
}

// Dynamic shared memory of a block of `warps` warps: their stages and
// group buffers, then the program.
__host__ __device__ __forceinline__ long long block_bytes(int warps, int stages, int f, bool vals,
                                                          bool groups, long long program) {
  return warps * (stages * stage_bytes(f, vals) + buffer_bytes(groups)) + program;
}

template <int Op, bool Groups>
__global__ void __launch_bounds__(kMaxThreads) combine_chunks_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ uint64_t bar[kMaxWarps][kMaxStages];
  __shared__ Span warp_span[kMaxWarps];  // each warp's run
  __shared__ Span before_block;          // every row before the chunk

  constexpr bool kVals = Op != kCount;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const int f = a.f;
  const long long stage = stage_bytes(f, kVals);
  const long long run_rows = (long long)a.warp_strips * kStrip;
  const long long row_begin = (long long)blockIdx.x * warps * run_rows;
  const long long row_end = min(a.n, row_begin + warps * run_rows);
  const long long run_begin = min(row_end, row_begin + warp * run_rows);
  const long long run_end = min(row_end, run_begin + run_rows);
  const int strips = (int)((run_end - run_begin + kStrip - 1) / kStrip);
  unsigned char* mine = smem + warp * (a.stages * stage + buffer_bytes(Groups));
  int64_t* buf_keys = (int64_t*)(mine + a.stages * stage);
  int64_t* buf_aggs = buf_keys + kStrip;
  int32_t* buf_cnts = (int32_t*)(buf_aggs + kStrip);
  int32_t* prog = (int32_t*)(smem + warps * (a.stages * stage + buffer_bytes(Groups)));
  uint64_t* wbar = bar[warp];

  // Strip k of this warp's run into its stage k % stages, by lane 0.
  auto issue = [&](int k) {
    const long long r0 = run_begin + (long long)k * kStrip;
    const long long rows = min((long long)kStrip, run_end - r0);
    unsigned char* s = mine + (k % a.stages) * stage;
    const uint32_t kb = floor16(rows * 8), vb = kVals ? floor16(rows * 4) : 0,
                   cb = floor16(rows * f * 4);
    uint64_t* b = &wbar[k % a.stages];
    bar_expect(b, kb + vb + cb);
    if (kb) bulk_copy(s, a.keys + r0, kb, b);
    if (vb) bulk_copy(s + 8 * kStrip, a.vals + r0, vb, b);
    if (cb) bulk_copy(s + (8 + (kVals ? 4 : 0)) * kStrip, a.cols + r0 * f, cb, b);
  };

  if (lane == 0) {
    for (int s = 0; s < a.stages; ++s) bar_init(&wbar[s]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    for (int k = 0; k < a.stages && k < strips; ++k) issue(k);
  }
  program_eval::stage_program(prog, a.words, a.p, a.header_words, a.staged);
  __syncthreads();
  const program_eval::View view =
      program_eval::program_view(prog, a.words, a.p, a.header_words, a.staged);

  long long prev_key = run_begin > 0 && strips > 0 ? a.keys[run_begin - 1] : 0;
  Span carry = empty_span<Op>();  // the run's rows before this strip
  int buffered = 0;               // the run's closed groups before the buffer's first
  for (int k = 0; k < strips; ++k) {
    const long long r0 = run_begin + (long long)k * kStrip;
    const int rows = (int)min((long long)kStrip, run_end - r0);
    unsigned char* s = mine + (k % a.stages) * stage;
    int64_t* s_keys = (int64_t*)s;
    int32_t* s_vals = (int32_t*)(s + 8 * kStrip);
    int32_t* s_cols = (int32_t*)(s + (8 + (kVals ? 4 : 0)) * kStrip);
    bar_wait(&wbar[k % a.stages], (uint32_t)(k / a.stages) & 1u);
    if (rows < kStrip) {  // the array's last strip: the bytes past the copies' 16-byte cut
      for (int i = (int)(floor16(rows * 8LL) / 8) + lane; i < rows; i += 32)
        s_keys[i] = a.keys[r0 + i];
      if (kVals)
        for (int i = (int)(floor16(rows * 4LL) / 4) + lane; i < rows; i += 32)
          s_vals[i] = a.vals[r0 + i];
      for (int i = (int)(floor16(rows * 4LL * f) / 4) + lane; i < rows * f; i += 32)
        s_cols[i] = a.cols[r0 * f + i];
      __syncwarp();
    }

    // The program over rows lane, lane + 32, ...: ballot i holds rows
    // [32 i, 32 i + 32), and this lane's kRows rows are in ballot lane / 8.
    uint32_t mask;
    {
      const int32_t* r[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int local = i * 32 + lane;
        r[i] = s_cols + (long long)(local < rows ? local : 0) * f;
      }
      const uint32_t verdict = program_eval::eval_rows<kRows>(r, view);
      uint32_t ballot[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        ballot[i] = __ballot_sync(kFull, ((verdict >> i) & 1u) && i * 32 + lane < rows);
      uint32_t word = ballot[0];
#pragma unroll
      for (int i = 1; i < kRows; ++i) word = (lane >> 3) == i ? ballot[i] : word;
      mask = (word >> ((lane & 7) * kRows)) & ((1u << kRows) - 1);
    }

    // This lane's kRows consecutive rows, folded into a Span.
    const int l0 = lane * kRows;
    const int row0 = (int)(r0 + l0);
    long long key[kRows], v[kRows];
    int c[kRows];
    bool live[kRows], head[kRows];
    long long prev = lane > 0 ? s_keys[l0 - 1] : prev_key;
    const long long prev0 = prev;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      live[j] = l0 + j < rows;
      key[j] = live[j] ? s_keys[l0 + j] : 0;
      head[j] = live[j] && (row0 + j == 0 || key[j] != prev);
      prev = key[j];
      const bool hit = (mask >> j) & 1u;
      c[j] = hit ? 1 : 0;
      v[j] = hit ? (kVals ? (long long)s_vals[l0 + j] : 1LL) : identity<Op>();
    }
    Span span = empty_span<Op>();
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!live[j]) continue;
      if (head[j]) {
        if (span.open_head >= 0) span.closed += span.open_cnt > 0;
        span.open_agg = v[j];
        span.open_cnt = c[j];
        span.open_head = row0 + j;
      } else if (span.open_head >= 0) {
        span.open_agg = fold<Op>(span.open_agg, v[j]);
        span.open_cnt += c[j];
      } else {
        span.lead_agg = fold<Op>(span.lead_agg, v[j]);
        span.lead_cnt += c[j];
      }
    }
    // The strip is in registers: its stage takes the strip `stages` ahead
    // while the warp scans and writes.
    prev_key = s_keys[rows - 1];
    __syncwarp();
    if (lane == 0 && k + a.stages < strips) {
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      issue(k + a.stages);
    }

    // The warp's scan: run is the run's rows before this lane's.
    Span incl = span;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const Span o = shfl_up(incl, d);
      if (lane >= d) incl = join<Op>(o, incl);
    }
    const Span excl = shfl_up(incl, 1);
    Span run = lane == 0 ? carry : join<Op>(carry, excl);
    const Span total = join<Op>(carry, shfl(incl, 31));

    if (Groups && total.closed - buffered > kStrip) {  // make room for this strip's groups
      const int held = carry.closed - buffered;
      for (int i = lane; i < held; i += 32) {
        a.spill_keys[run_begin + buffered + i] = buf_keys[i];
        a.spill_aggs[run_begin + buffered + i] = buf_aggs[i];
        a.spill_cnts[run_begin + buffered + i] = buf_cnts[i];
      }
      buffered = carry.closed;
      __syncwarp();
    }

    // Close the groups at this lane's heads, in row order. A group open at
    // the run's start closes after the chunk's look-back.
    long long out_agg[kRows];
    int out_cnt[kRows];
    bool pending = false;  // the per-row form: a close at a head before these rows
    int pend_row = 0, pend_cnt = 0;
    long long pend_agg = 0;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      out_agg[j] = identity<Op>();
      out_cnt[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (!live[j]) continue;
      if (head[j]) {
        if (run.open_head >= 0) {
          if (Groups) {
            if (run.open_cnt > 0) {
              const int slot = run.closed - buffered;
              buf_keys[slot] = j > 0 ? key[j - 1] : prev0;
              buf_aggs[slot] = run.open_agg;
              buf_cnts[slot] = run.open_cnt;
              run.closed += 1;
            }
          } else if (run.open_head >= row0) {
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              if (row0 + i == run.open_head) {
                out_agg[i] = run.open_agg;
                out_cnt[i] = run.open_cnt;
              }
          } else {
            pending = true;
            pend_row = run.open_head;
            pend_agg = run.open_agg;
            pend_cnt = run.open_cnt;
          }
        }
        run.open_agg = v[j];
        run.open_cnt = c[j];
        run.open_head = row0 + j;
      } else if (run.open_head >= 0) {
        run.open_agg = fold<Op>(run.open_agg, v[j]);
        run.open_cnt += c[j];
      }
    }
    if (!Groups && live[0]) {
      if (live[kRows - 1]) {
        uchar4 h;
        h.x = head[0], h.y = head[1], h.z = head[2], h.w = head[3];
        *(uchar4*)(a.heads + row0) = h;
        *(int4*)(a.cnts + row0) = make_int4(out_cnt[0], out_cnt[1], out_cnt[2], out_cnt[3]);
        *(longlong2*)(a.aggs + row0) = make_longlong2(out_agg[0], out_agg[1]);
        *(longlong2*)(a.aggs + row0 + 2) = make_longlong2(out_agg[2], out_agg[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kRows; ++j)
          if (live[j]) {
            a.heads[row0 + j] = head[j];
            a.aggs[row0 + j] = out_agg[j];
            a.cnts[row0 + j] = out_cnt[j];
          }
      }
    }
    carry = total;
    __syncwarp();  // the buffer is written; the placeholder stores are before these closes
    if (!Groups && pending) {
      a.aggs[pend_row] = pend_agg;
      a.cnts[pend_row] = pend_cnt;
    }
  }

  // The chunk's end: the warps' runs in order, then the look-back.
  __threadfence();
  if (lane == 0) warp_span[warp] = carry;
  __syncthreads();
  Span chunk = empty_span<Op>(), before_warp = empty_span<Op>();
  for (int w = 0; w < warps; ++w) {
    if (w == warp) before_warp = chunk;
    chunk = join<Op>(chunk, warp_span[w]);
  }
  if (warp == 0) {
    Span before = empty_span<Op>();
    if (blockIdx.x == 0) {
      if (lane == 0) publish(a.lb, 0, kInclusive, chunk);
    } else {
      if (lane == 0) publish(a.lb, blockIdx.x, kAggregate, chunk);
      before = look_back<Op>(a.lb, blockIdx.x);
      if (lane == 0) publish(a.lb, blockIdx.x, kInclusive, join<Op>(before, chunk));
    }
    if (lane == 0) before_block = before;
  }
  __syncthreads();
  const Span before_chunk = before_block;  // every row before the chunk
  const Span before = join<Op>(before_chunk, before_warp);  // every row before the run
  const Span incl = join<Op>(before_chunk, chunk);
  // The group open at the run's start closes at its first head.
  const bool lead_close = carry.open_head >= 0 && before.open_head >= 0;
  const long long lead_agg = fold<Op>(before.open_agg, carry.lead_agg);
  const int lead_cnt = before.open_cnt + carry.lead_cnt;
  const bool last = row_end == a.n && threadIdx.x == 0;
  if (Groups) {
    long long base = before.closed;
    if (lead_close && lead_cnt > 0) {
      if (lane == 0) {
        a.group_keys[base] = a.keys[before.open_head];
        a.group_aggs[base] = lead_agg;
        a.group_cnts[base] = lead_cnt;
      }
      base += 1;
    }
    for (int i = lane; i < buffered; i += 32) {
      a.group_keys[base + i] = a.spill_keys[run_begin + i];
      a.group_aggs[base + i] = a.spill_aggs[run_begin + i];
      a.group_cnts[base + i] = a.spill_cnts[run_begin + i];
    }
    for (int i = lane; i < carry.closed - buffered; i += 32) {
      a.group_keys[base + buffered + i] = buf_keys[i];
      a.group_aggs[base + buffered + i] = buf_aggs[i];
      a.group_cnts[base + buffered + i] = buf_cnts[i];
    }
    if (last) {  // the last group closes at the end of the rows
      long long n_groups = incl.closed;
      if (incl.open_cnt > 0) {
        a.group_keys[n_groups] = a.keys[incl.open_head];
        a.group_aggs[n_groups] = incl.open_agg;
        a.group_cnts[n_groups] = incl.open_cnt;
        n_groups += 1;
      }
      *a.n_groups = n_groups;
    }
  } else {
    if (lead_close && lane == 0) {
      a.aggs[before.open_head] = lead_agg;
      a.cnts[before.open_head] = lead_cnt;
    }
    if (last) {
      a.aggs[incl.open_head] = incl.open_agg;
      a.cnts[incl.open_head] = incl.open_cnt;
    }
  }
}

// A launch plan: the warps of a block and their stages, the most blocks
// the card holds at once, the grid and each warp's strips.
struct Plan {
  int warps, stages, blocks, warp_strips;
  long long resident;
  size_t smem;
};

// Look-back scratch a block takes: its chunk's Span, its inclusive Span
// and its state word.
constexpr long long kScratchPerBlock = 2 * sizeof(Span) + sizeof(int);

// The block shape (the most warps, then the most stages, that fit beside
// the program) and how many such blocks the card holds at once (SMs times
// the occupancy calculator's blocks an SM).
template <int Op, bool Groups>
cudaError_t shape(const Args& a, Plan* plan) {
  constexpr bool kVals = Op != kCount;
  auto kernel = combine_chunks_kernel<Op, Groups>;
  int device = 0, optin = 0, sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const long long program = 4LL * program_eval::shared_words(a.p, a.header_words, a.staged);
  *plan = Plan{0, 0, 0, 0, 0, 0};
  for (int warps = kMaxWarps; warps >= 1 && !plan->warps; warps /= 2) {
    for (int stages = kMaxStages; stages >= 2; --stages) {
      const long long smem = block_bytes(warps, stages, a.f, kVals, Groups, program);
      if (smem + kStaticBytes <= optin) {
        plan->warps = warps;
        plan->stages = stages;
        plan->smem = (size_t)smem;
        break;
      }
    }
  }
  if (!plan->warps) return cudaErrorInvalidValue;
  if ((err = program_eval::allow_shared(kernel, plan->smem)) != cudaSuccess) return err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * plan->warps,
                                                           plan->smem)) != cudaSuccess)
    return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  plan->resident = (long long)sms * per_sm;
  return cudaSuccess;
}

// Launches on a grid of at most the resident blocks, each warp's strip
// run as even as that allows. The scratch was sized by
// combine_scan_scratch_bytes for the same shape; a smaller one is refused.
template <int Op, bool Groups>
cudaError_t launch(Args a, void* scratch, long long scratch_bytes, cudaStream_t stream) {
  Plan plan;
  cudaError_t err = shape<Op, Groups>(a, &plan);
  if (err != cudaSuccess) return err;
  if (plan.resident * kScratchPerBlock > scratch_bytes) return cudaErrorInvalidValue;
  const long long strips = (a.n + kStrip - 1) / kStrip;
  const long long cap = plan.resident;
  const long long per_warp = (strips + cap * plan.warps - 1) / (cap * plan.warps);
  plan.warp_strips = (int)per_warp;
  plan.blocks = (int)((strips + per_warp * plan.warps - 1) / (per_warp * plan.warps));
  a.stages = plan.stages;
  a.warp_strips = plan.warp_strips;
  Span* spans = (Span*)scratch;  // laid out for the resident blocks
  a.lb.chunk = spans;
  a.lb.incl = spans + plan.resident;
  a.lb.state = (int*)(spans + 2 * plan.resident);
  if ((err = cudaMemsetAsync(a.lb.state, 0, sizeof(int) * plan.blocks, stream)) != cudaSuccess)
    return err;
  combine_chunks_kernel<Op, Groups><<<plan.blocks, 32 * plan.warps, plan.smem, stream>>>(a);
  return cudaGetLastError();
}

template <bool Groups>
int dispatch(const Args& a, int op, void* scratch, long long scratch_bytes, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (op) {
    case kSum: return (int)launch<kSum, Groups>(a, scratch, scratch_bytes, s);
    case kMin: return (int)launch<kMin, Groups>(a, scratch, scratch_bytes, s);
    case kMax: return (int)launch<kMax, Groups>(a, scratch, scratch_bytes, s);
    case kCount: return (int)launch<kCount, Groups>(a, scratch, scratch_bytes, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <int Op, bool Groups>
long long scratch_for(const Args& a) {
  Plan plan;
  const cudaError_t err = shape<Op, Groups>(a, &plan);
  return err != cudaSuccess ? -(long long)err : plan.resident * kScratchPerBlock;
}

template <bool Groups>
long long scratch_for(const Args& a, int op) {
  switch (op) {
    case kSum: return scratch_for<kSum, Groups>(a);
    case kMin: return scratch_for<kMin, Groups>(a);
    case kMax: return scratch_for<kMax, Groups>(a);
    case kCount: return scratch_for<kCount, Groups>(a);
    default: return -(long long)cudaErrorInvalidValue;
  }
}

Args inputs(const void* keys, const void* vals, const void* cols, long long n, int f,
            const void* words, int p, int header_words, int staged) {
  Args a{};
  a.keys = (const int64_t*)keys;
  a.vals = (const int32_t*)vals;
  a.cols = (const int32_t*)cols;
  a.n = n;
  a.f = f;
  a.words = (const int32_t*)words;
  a.p = p;
  a.header_words = header_words;
  a.staged = staged;
  return a;
}

}  // namespace

// keys int64 (n,) ascending, vals int32 (n,) (null for op count), cols
// int32 (n, f), all 16-byte aligned; the prepared program's words on the
// device, of which a block stages the first `staged` in shared memory;
// scratch of scratch_bytes, at least combine_scan_scratch_bytes for the
// same f, op, form and program. Writes heads bool, aggs int64 and cnts
// int32, each (n,).
extern "C" int combine_scan_rows(const void* keys, const void* vals, const void* cols,
                                 long long n, int f, const void* words, int p, int header_words,
                                 int staged, int op, void* heads, void* aggs, void* cnts,
                                 void* scratch, long long scratch_bytes, void* stream) {
  Args a = inputs(keys, vals, cols, n, f, words, p, header_words, staged);
  a.heads = (bool*)heads;
  a.aggs = (int64_t*)aggs;
  a.cnts = (int32_t*)cnts;
  return dispatch<false>(a, op, scratch, scratch_bytes, stream);
}

// As combine_scan_rows, but writes the groups with a matching row, in key
// order, to group_keys int64, group_aggs int64 and group_cnts int32 (each
// of n entries), their number to n_groups int64 (1,); spill_* are scratch
// of n entries each.
extern "C" int combine_scan_groups(const void* keys, const void* vals, const void* cols,
                                   long long n, int f, const void* words, int p,
                                   int header_words, int staged, int op, void* group_keys,
                                   void* group_aggs, void* group_cnts, void* n_groups,
                                   void* spill_keys, void* spill_aggs, void* spill_cnts,
                                   void* scratch, long long scratch_bytes, void* stream) {
  Args a = inputs(keys, vals, cols, n, f, words, p, header_words, staged);
  a.group_keys = (int64_t*)group_keys;
  a.group_aggs = (int64_t*)group_aggs;
  a.group_cnts = (int32_t*)group_cnts;
  a.n_groups = (int64_t*)n_groups;
  a.spill_keys = (int64_t*)spill_keys;
  a.spill_aggs = (int64_t*)spill_aggs;
  a.spill_cnts = (int32_t*)spill_cnts;
  return dispatch<true>(a, op, scratch, scratch_bytes, stream);
}

// Bytes of the look-back scratch for f fields, the op, the form (groups
// nonzero) and the program as the two entries above take them: one slot
// per block the card holds at once with that block shape. A negative
// return is a CUDA error, negated.
extern "C" long long combine_scan_scratch_bytes(int f, int op, int groups, int p,
                                                int header_words, int staged) {
  Args a = inputs(nullptr, nullptr, nullptr, 0, f, nullptr, p, header_words, staged);
  return groups ? scratch_for<true>(a, op) : scratch_for<false>(a, op);
}

// Shared memory a block takes besides the program at its smallest (one
// warp, two stages): what the program may not take.
extern "C" int combine_scan_reserved_bytes(int f, int vals, int groups) {
  return (int)block_bytes(1, 2, f, vals != 0, groups != 0, 0) + kStaticBytes;
}
