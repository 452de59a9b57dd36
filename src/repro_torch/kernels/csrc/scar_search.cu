// scar_search: occupancy-mask AND + popcount of beam rows x candidates.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scar_search/kernel.py
// (scar_search / _search_kernel).  The beam search's disjointness screen:
// for every (beam row b, candidate n) pair,
//
//   out[b, n] = sum_k popcount(beam[b, k] & cand[n, k])      (int32)
//
// over W packed uint32 occupancy words (two per 64-chiplet word: W = 2 on
// 3x3 and 6x6 packages, 8 on the 16x16 pod).  0 means disjoint.  The words
// arrive as int32 tensors holding the uint32 bits and are read as unsigned.
//
// Design: one thread per (beam row, candidate).  The candidate index runs
// along threadIdx.x, so the stores of a [Bm, N] row-major output coalesce;
// a block covers 128 candidates and up to 8 beam rows (blockIdx.y), whose
// words it stages in shared memory.  Each thread loads its candidate's W
// words once, with 16-byte vector loads when W is a multiple of 4 (two for
// W = 8) and 8-byte loads when it is even, and keeps them in registers
// across its beam rows.  A ragged N is masked by a bound check: unlike the
// Pallas wrapper there is no padding to a block multiple.
//
// Bound on an H100: at the 16x16 pod's largest beam stage (Bm = 48,
// N = 8192 padded candidates, W = 8) the function reads 4 * (Bm + N) * W
// bytes and writes 4 * Bm * N: about 1.8 MB, 0.5 us at 3.35 TB/s; the
// Bm * N * W = 3.1 M popcounts take under 1 us at 16 per clock per SM on
// 132 SMs.  Both are below the cost of a launch, so the caller sees launch
// overhead; fusing the `== 0` test or the keep-rank prefix sum into the
// kernel is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowsPerBlock = 8;

template <int W>
__device__ __forceinline__ void load_words(const unsigned* __restrict__ p,
                                           unsigned (&c)[W]) {
  if constexpr (W % 4 == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 v = __ldg(q + k);
      c[4 * k] = v.x;
      c[4 * k + 1] = v.y;
      c[4 * k + 2] = v.z;
      c[4 * k + 3] = v.w;
    }
  } else if constexpr (W % 2 == 0) {
    const uint2* q = reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const uint2 v = __ldg(q + k);
      c[2 * k] = v.x;
      c[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < W; ++k) c[k] = __ldg(p + k);
  }
}

// W known at compile time: the candidate's words live in registers.
template <int W>
__global__ void __launch_bounds__(kThreads)
scar_search_fixed(const unsigned* __restrict__ beam,
                  const unsigned* __restrict__ cand, int Bm, int N,
                  int* __restrict__ out) {
  __shared__ unsigned sbeam[kRowsPerBlock * W];
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, Bm - row0);
  for (int i = threadIdx.x; i < rows * W; i += kThreads)
    sbeam[i] = beam[(size_t)row0 * W + i];
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  unsigned c[W];
  load_words<W>(cand + (size_t)n * W, c);
  for (int r = 0; r < rows; ++r) {
    int acc = 0;
#pragma unroll
    for (int k = 0; k < W; ++k) acc += __popc(sbeam[r * W + k] & c[k]);
    out[(size_t)(row0 + r) * N + n] = acc;
  }
}

// Any W: the candidate's words are read from global memory (L1-cached) for
// each beam row.
__global__ void __launch_bounds__(kThreads)
scar_search_any(const unsigned* __restrict__ beam,
                const unsigned* __restrict__ cand, int Bm, int N, int W,
                int* __restrict__ out) {
  extern __shared__ unsigned sbeam_dyn[];
  const int row0 = blockIdx.y * kRowsPerBlock;
  const int rows = min(kRowsPerBlock, Bm - row0);
  for (int i = threadIdx.x; i < rows * W; i += kThreads)
    sbeam_dyn[i] = beam[(size_t)row0 * W + i];
  __syncthreads();
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= N) return;
  const unsigned* c = cand + (size_t)n * W;
  for (int r = 0; r < rows; ++r) {
    int acc = 0;
    for (int k = 0; k < W; ++k)
      acc += __popc(sbeam_dyn[r * W + k] & __ldg(c + k));
    out[(size_t)(row0 + r) * N + n] = acc;
  }
}

}  // namespace

// Shared memory the launch needs for W words, in bytes (the wrapper checks
// it against the static limit).
extern "C" long long scar_search_smem_bytes(int W) {
  return (long long)sizeof(unsigned) * kRowsPerBlock * W;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// beam: [Bm, W], cand: [N, W] uint32 bits; out: [Bm, N] int32.
extern "C" int scar_search_launch(const void* beam, const void* cand, int Bm,
                                  int N, int W, void* out, void* stream) {
  if (Bm == 0 || N == 0) return (int)cudaGetLastError();
  const dim3 grid((N + kThreads - 1) / kThreads,
                  (Bm + kRowsPerBlock - 1) / kRowsPerBlock);
  const unsigned* b = static_cast<const unsigned*>(beam);
  const unsigned* c = static_cast<const unsigned*>(cand);
  int* o = static_cast<int*>(out);
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t align = reinterpret_cast<uintptr_t>(cand);
  if (W == 8 && align % 16 == 0) {
    scar_search_fixed<8><<<grid, kThreads, 0, s>>>(b, c, Bm, N, o);
  } else if (W == 4 && align % 16 == 0) {
    scar_search_fixed<4><<<grid, kThreads, 0, s>>>(b, c, Bm, N, o);
  } else if (W == 2 && align % 8 == 0) {
    scar_search_fixed<2><<<grid, kThreads, 0, s>>>(b, c, Bm, N, o);
  } else {
    const size_t smem = (size_t)scar_search_smem_bytes(W);
    scar_search_any<<<grid, kThreads, smem, s>>>(b, c, Bm, N, W, o);
  }
  return (int)cudaGetLastError();
}
