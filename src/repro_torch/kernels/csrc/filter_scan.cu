// filter_scan.cu — the postfix predicate program over dictionary codes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/filter_scan/filter_scan.py::filter_scan_pallas
// (`_kernel`), and on the device scan path the jnp evaluator it shares its
// semantics with (src/repro/kernels/program_eval.py::program_eval_rows).
// Opcodes: NOP, PUSH_EQ, PUSH_IN (codeset table padded with -1), PUSH_TRUE,
// AND, OR, NOT, over a stack of MAX_STACK = 8 bools per row.
//
// What bounds it on the H100: bytes. The rows are read once and the mask
// written once: n*F*4 + n bytes over 3.35 TB/s. The work per row is a few
// integer compares per program step.
//
// Design: one thread per row of an (n, F) int32 block, F unpadded (the
// reference padded fields to 128 TPU lanes). The program (three int32
// arrays of P entries) and the codeset table (S x M) are copied once per
// block into shared memory, so every step reads them at shared-memory
// speed. The stack of 8 bools is one 8-bit register; stack indices clamp
// into [0, 8) exactly as the reference's dynamic indexing does. The kernel
// allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxStack = 8;
enum : int32_t { kNop = 0, kPushEq, kPushIn, kPushTrue, kAnd, kOr, kNot };

__device__ __forceinline__ int clamp_sp(int i) {
  return i < 0 ? 0 : (i > kMaxStack - 1 ? kMaxStack - 1 : i);
}

__device__ __forceinline__ bool get_bit(uint32_t s, int i) { return (s >> i) & 1u; }

__device__ __forceinline__ uint32_t put_bit(uint32_t s, int i, bool v) {
  return (s & ~(1u << i)) | ((uint32_t)v << i);
}

__global__ void filter_scan_kernel(const int32_t* __restrict__ cols, long long n,
                                   int f, const int32_t* __restrict__ program,
                                   int p, const int32_t* __restrict__ codesets,
                                   int s, int m, bool* __restrict__ out) {
  extern __shared__ int32_t smem[];
  const int n_words = 3 * p + s * m;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) {
    smem[w] = w < 3 * p ? program[w] : codesets[w - 3 * p];
  }
  __syncthreads();
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n) return;
  const int32_t* opc = smem;
  const int32_t* arg0 = smem + p;
  const int32_t* arg1 = smem + 2 * p;
  const int32_t* cset = smem + 3 * p;
  const int32_t* r = cols + row * f;
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
  out[row] = stack & 1u;
}

}  // namespace

extern "C" int filter_scan_rows(const void* cols, long long n, int f,
                                const void* program, int p, const void* codesets,
                                int s, int m, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)(3 * p + s * m) * sizeof(int32_t);
  filter_scan_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cols, n, f, (const int32_t*)program, p,
      (const int32_t*)codesets, s, m, (bool*)out);
  return (int)cudaGetLastError();
}
