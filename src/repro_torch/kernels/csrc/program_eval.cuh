// program_eval.cuh — the postfix predicate program over one row of
// dictionary codes, shared by the filter_scan and combine_scan kernels.
//
// The device form of src/repro_torch/kernels/program_eval.py (opcodes
// NOP, PUSH_EQ, PUSH_IN, PUSH_TRUE, AND, OR, NOT over a stack of
// MAX_STACK = 8 bools). The program is three int32 arrays of P entries
// (opcodes, arg0 = field id, arg1 = code or codeset row) followed by the
// codeset table (S x M, padded with -1); a block stages all of it in
// shared memory once with stage_program, then every thread evaluates its
// own row. The stack is one 8-bit register; stack indices clamp into
// [0, 8) exactly as the reference's dynamic indexing does.
#pragma once

#include <cstdint>

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

// Words of shared memory the program and codesets take.
__host__ __device__ __forceinline__ int program_words(int p, int s, int m) {
  return 3 * p + s * m;
}

// Copy the program (3 * p words) and the codesets (s * m words) into
// smem; every thread of the block takes part, and the caller syncs.
__device__ __forceinline__ void stage_program(int32_t* smem, const int32_t* __restrict__ program,
                                              int p, const int32_t* __restrict__ codesets,
                                              int s, int m) {
  const int n_words = program_words(p, s, m);
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    smem[w] = w < 3 * p ? program[w] : codesets[w - 3 * p];
  }
}

// The program's verdict on one row r (F codes) — staged program in smem.
__device__ __forceinline__ bool eval_row(const int32_t* __restrict__ r, const int32_t* smem,
                                         int p, int m) {
  const int32_t* opc = smem;
  const int32_t* arg0 = smem + p;
  const int32_t* arg1 = smem + 2 * p;
  const int32_t* cset = smem + 3 * p;
  uint32_t stack = 0;
  int sp = 0;
  for (int i = 0; i < p; ++i) {
    const int32_t op = opc[i];
    if (op == kPushEq || op == kPushIn || op == kPushTrue) {
      bool v = true;
      if (op == kPushEq) {
        v = r[arg0[i]] == arg1[i];
      } else if (op == kPushIn) {
        const int32_t code = r[arg0[i]];
        const int32_t* set = cset + arg1[i] * m;
        v = false;
        for (int e = 0; e < m; ++e) v |= (set[e] >= 0) & (set[e] == code);
      }
      stack = put_bit(stack, clamp_sp(sp), v);
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

}  // namespace program_eval
