// program_eval.cuh — the postfix predicate program over one row of
// dictionary codes, shared by the filter_scan and combine_scan kernels.
//
// The device form of src/repro_torch/kernels/program_eval.py (opcodes
// NOP, PUSH_EQ, PUSH_IN, PUSH_TRUE, AND, OR, NOT over a stack of
// MAX_STACK = 8 bools). The program arrives prepared, as one int32 array
//
//   [opcodes P | arg0 P | arg1 P | set offsets S+1 | codes]
//
// (arg0 = field id, arg1 = code or set index); set s is
// codes[off[s]:off[s+1]], its non-negative codes sorted ascending, so
// PUSH_IN is a lower-bound search of ceil(log2 M) probes. A block stages
// a prefix of the array in shared memory with stage_words: all of it, the
// header alone (the codes are then searched in place in global memory,
// where they stay L2-resident and the search's first levels hit L1), or
// nothing. program_view points the evaluator at shared memory for what
// was staged and at global memory for the rest, so one code path serves
// every size. The stack is one 8-bit register; stack indices clamp into
// [0, 8) exactly as the reference's dynamic indexing does.
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

// Copy the first `staged` words of the prepared program into smem; every
// thread of the block takes part, and the caller syncs.
__device__ __forceinline__ void stage_words(int32_t* smem, const int32_t* __restrict__ words,
                                            int staged) {
  for (int w = threadIdx.x; w < staged; w += blockDim.x) smem[w] = words[w];
}

// Where the evaluator reads the program: the header (opcodes, args and
// offsets) and the codes, each from shared memory if it was staged.
struct View {
  const int32_t* header;
  const int32_t* codes;
  int p;
};

__device__ __forceinline__ View program_view(const int32_t* smem,
                                             const int32_t* __restrict__ words, int p,
                                             int header_words, int staged) {
  View v;
  v.header = staged >= header_words ? smem : words;
  v.codes = staged > header_words ? smem + header_words : words + header_words;
  v.p = p;
  return v;
}

// Is code in set s? A lower-bound search over the set's sorted codes.
__device__ __forceinline__ bool in_set(const View& v, int s, int32_t code) {
  const int32_t* off = v.header + 3 * v.p;
  int lo = off[s];
  const int end = off[s + 1];
  int n = end - lo;
  while (n > 0) {
    const int half = n >> 1;
    if (v.codes[lo + half] < code) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo < end && v.codes[lo] == code;
}

// The program's verdict on one row r (F codes).
__device__ __forceinline__ bool eval_row(const int32_t* __restrict__ r, const View& v) {
  const int32_t* opc = v.header;
  const int32_t* arg0 = v.header + v.p;
  const int32_t* arg1 = v.header + 2 * v.p;
  uint32_t stack = 0;
  int sp = 0;
  for (int i = 0; i < v.p; ++i) {
    const int32_t op = opc[i];
    if (op == kPushEq || op == kPushIn || op == kPushTrue) {
      bool b = true;
      if (op == kPushEq) {
        b = r[arg0[i]] == arg1[i];
      } else if (op == kPushIn) {
        b = in_set(v, arg1[i], r[arg0[i]]);
      }
      stack = put_bit(stack, clamp_sp(sp), b);
      sp += 1;
    } else if (op == kAnd || op == kOr) {
      const bool a = get_bit(stack, clamp_sp(sp - 2));
      const bool b = get_bit(stack, clamp_sp(sp - 1));
      stack = put_bit(stack, clamp_sp(sp - 2), op == kAnd ? (a & b) : (a | b));
      sp -= 1;
    } else if (op == kNot) {
      stack = put_bit(stack, clamp_sp(sp - 1), !get_bit(stack, clamp_sp(sp - 1)));
    }
  }
  return stack & 1u;
}

// Opt the kernel in to `bytes` of dynamic shared memory when that is past
// the 48 KiB a launch gets without asking; returns the CUDA error.
template <typename Kernel>
inline cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace program_eval
