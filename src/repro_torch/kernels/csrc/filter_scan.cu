// filter_scan.cu — the postfix predicate program over dictionary codes.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/filter_scan/filter_scan.py::filter_scan_pallas
// (`_kernel`), and on the device scan path the jnp evaluator it shares its
// semantics with (src/repro/kernels/program_eval.py::program_eval_rows).
// The evaluator itself lives in program_eval.cuh, shared with combine_scan.
//
// What bounds it on the H100: bytes. The rows are read once and the mask
// written once: n*F*4 + n bytes over 3.35 TB/s. The work per row is a few
// integer compares per program step.
//
// Design: one thread per row of an (n, F) int32 block, F unpadded (the
// reference padded fields to 128 TPU lanes). The program (three int32
// arrays of P entries) and the codeset table (S x M) are copied once per
// block into shared memory, so every step reads them at shared-memory
// speed. The kernel allocates nothing and launches on the caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

#include "program_eval.cuh"

namespace {

__global__ void filter_scan_kernel(const int32_t* __restrict__ cols, long long n,
                                   int f, const int32_t* __restrict__ program,
                                   int p, const int32_t* __restrict__ codesets,
                                   int s, int m, bool* __restrict__ out) {
  extern __shared__ int32_t smem[];
  program_eval::stage_program(smem, program, p, codesets, s, m);
  __syncthreads();
  const long long row = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (row >= n) return;
  out[row] = program_eval::eval_row(cols + row * f, smem, p, m);
}

}  // namespace

extern "C" int filter_scan_rows(const void* cols, long long n, int f,
                                const void* program, int p, const void* codesets,
                                int s, int m, void* out, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  const size_t smem = (size_t)program_eval::program_words(p, s, m) * sizeof(int32_t);
  filter_scan_kernel<<<(unsigned)blocks, threads, smem, (cudaStream_t)stream>>>(
      (const int32_t*)cols, n, f, (const int32_t*)program, p,
      (const int32_t*)codesets, s, m, (bool*)out);
  return (int)cudaGetLastError();
}
