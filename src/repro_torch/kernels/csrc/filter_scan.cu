// filter_scan.cu — the postfix predicate program over dictionary codes,
// every LSM level of a step in one launch.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/filter_scan/filter_scan.py::filter_scan_pallas
// (`_kernel`), and on the device scan path the jnp evaluator it shares its
// semantics with (src/repro/kernels/program_eval.py::program_eval_rows).
// The evaluator itself lives in program_eval.cuh, shared with combine_scan.
//
// What bounds it on the H100: bytes. The rows are read once and the mask
// written once: n*F*4 + n bytes over 3.35 TB/s. The work per row is a few
// integer compares per program step, and per PUSH_IN one bitmap load or
// about log2 M probes over a set of M codes (program_eval.cuh).
//
// Design: one launch takes up to kMaxLevels segments, each an (n_l, F)
// int32 block of rows with its own bool output (a scan step's base, runs
// and memtable, or the index step's candidate rows of each level). The
// grid is the SM count times the blocks that fit on an SM, and each
// thread walks the segments' rows with a grid stride, one row at a time,
// so a block stages the prepared program once for its whole life (not
// once per 256 rows) and one launch serves the whole step. F stays
// unpadded (the reference padded fields to 128 TPU lanes). Programs too
// large for shared memory keep their codes, and their sets' bitmaps, in
// global memory (program_eval.cuh). The kernel allocates nothing and launches on the
// caller's stream.
#include <cstdint>
#include <cuda_runtime.h>

#include "program_eval.cuh"

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 1024;

struct Levels {
  const int32_t* cols[kMaxLevels];
  bool* out[kMaxLevels];
  long long start[kMaxLevels + 1];  // first row of each segment in the joint row space
  int n;
};

__global__ void __launch_bounds__(kThreads)
filter_levels_kernel(Levels lv, int f, const int32_t* __restrict__ words, int p,
                     int header_words, int staged) {
  extern __shared__ int32_t smem[];
  program_eval::stage_program(smem, words, p, header_words, staged);
  __syncthreads();
  const program_eval::View view = program_eval::program_view(smem, words, p, header_words,
                                                             staged);
  const long long total = lv.start[lv.n];
  const long long stride = (long long)gridDim.x * blockDim.x;
  int l = 0;
  for (long long g = blockIdx.x * (long long)blockDim.x + threadIdx.x; g < total; g += stride) {
    while (g >= lv.start[l + 1]) ++l;  // rows only grow along the stride
    const long long r = g - lv.start[l];
    lv.out[l][r] = program_eval::eval_row(lv.cols[l] + r * f, view);
  }
}

}  // namespace

// cols[l] (rows[l], f) int32 and out[l] (rows[l],) bool, device pointers in
// host arrays of n_levels entries; the prepared program's words on the
// device, of which a block stages the first `staged` (and the bitmap
// offsets) in shared memory.
extern "C" int filter_scan_levels(const void* const* cols, void* const* out,
                                  const long long* rows, int n_levels, int f,
                                  const void* words, int p, int header_words, int staged,
                                  void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = n_levels;
  lv.start[0] = 0;
  for (int l = 0; l < n_levels; ++l) {
    lv.cols[l] = (const int32_t*)cols[l];
    lv.out[l] = (bool*)out[l];
    lv.start[l + 1] = lv.start[l] + rows[l];
  }
  for (int l = n_levels; l < kMaxLevels; ++l) {
    lv.cols[l] = nullptr;
    lv.out[l] = nullptr;
    lv.start[l + 1] = lv.start[n_levels];
  }
  const long long total = lv.start[n_levels];
  if (total == 0) return (int)cudaSuccess;
  const size_t smem =
      (size_t)program_eval::shared_words(p, header_words, staged) * sizeof(int32_t);
  cudaError_t err = program_eval::allow_shared(filter_levels_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, filter_levels_kernel,
                                                           kThreads, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  long long blocks = (long long)sms * per_sm;
  const long long needed = (total + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  filter_levels_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(
      lv, f, (const int32_t*)words, p, header_words, staged);
  return (int)cudaGetLastError();
}

// Bytes of shared memory a block of the current device may opt in to.
extern "C" int shared_optin_bytes() {
  int device = 0, bytes = 0;
  if (cudaGetDevice(&device) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) !=
      cudaSuccess)
    return -1;
  return bytes;
}
