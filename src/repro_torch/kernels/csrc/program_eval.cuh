// program_eval.cuh — the postfix predicate program over rows of
// dictionary codes, shared by the filter_scan and combine_scan kernels.
//
// The device form of src/repro_torch/kernels/program_eval.py (opcodes
// NOP, PUSH_EQ, PUSH_IN, PUSH_TRUE, AND, OR, NOT over a stack of
// MAX_STACK = 8 bools). The program arrives prepared, as one int32 array
//
//   [opcodes P | arg0 P | arg1 P | set offsets S+1 | codes |
//    bitmap offsets S+1 | bitmaps]
//
// (arg0 = field id, arg1 = code or set index); set s is
// codes[off[s]:off[s+1]], its non-negative codes sorted ascending, and the
// last header word off[S] is the number of codes. Bitmap s is
// words[boff[s]:boff[s+1]] (absolute offsets; an empty range: no bitmap),
// bit c of word c / 32 set when code c is in the set.
//
// PUSH_IN answers from the set's bitmap when it has one: one load a row,
// from a bitmap that stays resident in L2. prepare_program builds one for
// every set when the program's codes are too large to be staged in shared
// memory (past SHARED_PROGRAM_BYTES), as long as the bitmap over
// [0, the set's largest code] takes at most BITMAP_MAX_BYTES; a code that
// is negative or past the bitmap's end is not a member. A set without a
// bitmap is searched: a branch-free lower bound of ceil(log2 M) probes,
// whose probe count depends on M alone, so eval_rows runs the searches of
// its rows in lockstep and their loads overlap.
//
// A block stages a prefix of the array in shared memory with
// stage_program: all of the program and its codes, or the header alone
// (the codes are then searched in place in global memory), each with the
// bitmap offsets after it; or nothing. program_view points the evaluator
// at shared memory for what was staged and at global memory for the rest,
// so one code path serves every size. A stack is one 8-bit register;
// stack indices clamp into [0, 8) exactly as the reference's dynamic
// indexing does.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace program_eval {

constexpr int kMaxStack = 8;
enum : int32_t { kNop = 0, kPushEq, kPushIn, kPushTrue, kAnd, kOr, kNot };

__device__ __forceinline__ int clamp_sp(int i) {
  return i < 0 ? 0 : (i > kMaxStack - 1 ? kMaxStack - 1 : i);
}

__device__ __forceinline__ bool get_bit(uint32_t s, int i) { return (s >> i) & 1u; }

__device__ __forceinline__ uint32_t put_bit(uint32_t s, int i, bool v) {
  return (s & ~(1u << i)) | ((uint32_t)v << i);
}

// Words of shared memory a block takes for a program of p ops whose first
// `staged` words it stages: those, and the S+1 bitmap offsets after them
// when the header is staged.
__host__ __device__ __forceinline__ int shared_words(int p, int header_words, int staged) {
  return staged >= header_words ? staged + header_words - 3 * p : 0;
}

// Copy the first `staged` words of the prepared program, then (when the
// header is among them) its bitmap offsets, into smem; every thread of the
// block takes part, and the caller syncs.
__device__ __forceinline__ void stage_program(int32_t* smem, const int32_t* __restrict__ words,
                                              int p, int header_words, int staged) {
  for (int w = threadIdx.x; w < staged; w += blockDim.x) smem[w] = words[w];
  if (staged < header_words) return;
  const int32_t* table = words + header_words + words[header_words - 1];
  for (int w = threadIdx.x; w < header_words - 3 * p; w += blockDim.x) smem[staged + w] = table[w];
}

// Where the evaluator reads the program: the header (opcodes, args and
// set offsets), the codes and the bitmap offsets, each from shared memory
// if it was staged; the bitmaps from global memory.
struct View {
  const int32_t* header;
  const int32_t* codes;
  const int32_t* bitmap_off;
  const int32_t* words;
  int p;
};

__device__ __forceinline__ View program_view(const int32_t* smem,
                                             const int32_t* __restrict__ words, int p,
                                             int header_words, int staged) {
  View v;
  v.header = staged >= header_words ? smem : words;
  v.codes = staged > header_words ? smem + header_words : words + header_words;
  v.bitmap_off = staged >= header_words ? smem + staged
                                        : words + header_words + words[header_words - 1];
  v.words = words;
  v.p = p;
  return v;
}

// Is code[i] in set s, for N codes at once?
template <int N>
__device__ __forceinline__ void in_set(const View& v, int s, const int32_t (&code)[N],
                                       bool (&hit)[N]) {
  const int b0 = v.bitmap_off[s];
  const int words = v.bitmap_off[s + 1] - b0;
  if (words > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const uint32_t c = (uint32_t)code[i];  // a negative code lands past the end
      hit[i] = c < 32u * (uint32_t)words && ((__ldg(v.words + b0 + (c >> 5)) >> (c & 31)) & 1u);
    }
    return;
  }
  const int32_t* off = v.header + 3 * v.p;
  const int32_t* set = v.codes + off[s];
  const int m = off[s + 1] - off[s];
  if (m == 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) hit[i] = false;
    return;
  }
  int base[N];
#pragma unroll
  for (int i = 0; i < N; ++i) base[i] = 0;
  // The lower bound stays in [base, base + len]; at len = 1 it is base or
  // base + 1.
  for (int len = m; len > 1;) {
    const int half = len >> 1;
#pragma unroll
    for (int i = 0; i < N; ++i) base[i] = set[base[i] + half] < code[i] ? base[i] + half : base[i];
    len -= half;
  }
#pragma unroll
  for (int i = 0; i < N; ++i)
    hit[i] = set[base[i]] == code[i] || (base[i] + 1 < m && set[base[i] + 1] == code[i]);
}

// The program's verdicts on N rows r[i] (F codes each): bit i of the
// result for row i.
template <int N>
__device__ __forceinline__ uint32_t eval_rows(const int32_t* const (&r)[N], const View& v) {
  const int32_t* opc = v.header;
  const int32_t* arg0 = v.header + v.p;
  const int32_t* arg1 = v.header + 2 * v.p;
  uint32_t stack[N];
#pragma unroll
  for (int i = 0; i < N; ++i) stack[i] = 0;
  int sp = 0;
  for (int k = 0; k < v.p; ++k) {
    const int32_t op = opc[k];
    if (op == kPushEq || op == kPushIn || op == kPushTrue) {
      bool b[N];
      if (op == kPushEq) {
#pragma unroll
        for (int i = 0; i < N; ++i) b[i] = r[i][arg0[k]] == arg1[k];
      } else if (op == kPushIn) {
        int32_t code[N];
#pragma unroll
        for (int i = 0; i < N; ++i) code[i] = r[i][arg0[k]];
        in_set<N>(v, arg1[k], code, b);
      } else {
#pragma unroll
        for (int i = 0; i < N; ++i) b[i] = true;
      }
#pragma unroll
      for (int i = 0; i < N; ++i) stack[i] = put_bit(stack[i], clamp_sp(sp), b[i]);
      sp += 1;
    } else if (op == kAnd || op == kOr) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        const bool a = get_bit(stack[i], clamp_sp(sp - 2));
        const bool b = get_bit(stack[i], clamp_sp(sp - 1));
        stack[i] = put_bit(stack[i], clamp_sp(sp - 2), op == kAnd ? (a & b) : (a | b));
      }
      sp -= 1;
    } else if (op == kNot) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        stack[i] = put_bit(stack[i], clamp_sp(sp - 1), !get_bit(stack[i], clamp_sp(sp - 1)));
    }
  }
  uint32_t out = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) out |= (stack[i] & 1u) << i;
  return out;
}

// The program's verdict on one row r (F codes).
__device__ __forceinline__ bool eval_row(const int32_t* __restrict__ r, const View& v) {
  const int32_t* rows[1] = {r};
  return eval_rows<1>(rows, v) & 1u;
}

// Opt the kernel in to `bytes` of dynamic shared memory when that is past
// the 48 KiB a launch gets without asking; returns the CUDA error.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace program_eval
