// scar_search: the beam search's whole per-stage screen in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scar_search/kernel.py
// (scar_search / _search_kernel), the AND + popcount disjointness test of
// beam rows x candidates, together with the jitted code around it in
// src/repro/core/device_search.py::beam_scan (keep_budget, score_pick up
// to the top-k).  For beam row b and candidate n of a stage:
//
//   dis[b, n]    beam[b] & cand[n] == 0 in all W uint32 words (the
//                reference's popcount of the AND is zero), the candidate
//                valid and the row live (b < live rows)
//   rank[b, n]   inclusive count of dis along row b
//   before[b, n] accepted-so-far in row-major order: the rows above give
//                min(keep, their dis count) each, row b gives rank - 1
//   accepted     dis, rank <= keep, and expansions + before < max_exp,
//                or before == 0 (a stage's first acceptance always goes
//                through)
//   score[b, n]  metric(max(b_lat[b], c_lat[n]), b_e[b] + c_e[n]) where
//                accepted, else +inf
//
// and the stage total, the expansion counter after it, the next beam's
// live rows (min(total, Bm)) and a no-placement flag, all on the device.
// Each score is one IEEE max, add and multiply, in float32 on the fused
// path and float64 on the protocol path, so the kernel gives the plain
// version's bits.
//
// Bound on an H100: at the 16x16 pod's largest stage (Bm 48, N 8 192, W 8)
// the function reads 4 (Bm + N) W bytes of words, N validity bytes and
// the lat / energy rows, and writes the 1.5 MB float32 score plane: about
// 0.57 us at 3.35 TB/s, so it is bound by bytes; the test needs only an
// AND folded into an OR per word (one LOP3, 64 a clock per SM), 3.1 M of
// them, about 0.2 us.  What cost
// time before were the ~20 torch ops that reread the [Bm, N] count plane
// for one step each (compare, masks, two cumsums, the keep filter, the
// budget, sum, max, add, metric, where).
//
// Design: one CTA of 256 threads a (beam row, 1 024-candidate tile).  The
// row's words sit in shared memory; each thread tests 4 candidates with
// vector loads of their words.  The in-row rank is a warp ballot and a
// scan of the 32 (round, warp) counts.  A tile needs two sums from other
// CTAs: the dis counts of the earlier tiles of its row, and the row
// totals of the earlier rows (the budget).  CTAs take tickets from an
// atomic counter in row-major order (ticket t is row t / tiles, tile
// t % tiles), publish their tile's count at once and, for a row's last
// tile, the row total after reading the row's earlier tiles; a CTA then
// looks back over its row's earlier tiles and the rows above, whose
// tickets are smaller, so whatever it waits on has started and waits only
// on smaller tickets: no deadlock, one launch.  A row total waits only on
// its own row, so no chain runs down the rows.  One launch rather than a
// count pass and a mark pass: each candidate's disjoint bit stays in a
// register between the two halves, and a stage costs one launch.  What
// remains is latency: every tile waits for the counts of the whole grid.
// The counters live in an int32 buffer the launcher zeroes on the stream
// first.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                       // candidates a thread
constexpr int kTile = kThreads * kPer;
static_assert(kPer * kWarps == 32, "one warp scans the (round, warp) counts");

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// The value another CTA published (stored as value + 1; 0 = not yet).
// Seconds of polling mean a broken look-back: fail rather than hang.
__device__ __forceinline__ int wait_value(const int* p) {
  int v;
  for (int spins = 0; (v = ld_acquire(p)) == 0;)
    if (++spins > (1 << 22)) __trap();
  return v - 1;
}

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float max_of(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double max_of(double a, double b) {
  return fmax(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}

// The sum over the CTA's threads of v (every thread gets it); red holds
// one slot a warp.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) sum += red[w];
  return sum;
}

// True when the candidate's words share no bit with the beam row's: the
// ANDs folded into one OR (one LOP3 a word), tested for zero once.
template <int W>
__device__ __forceinline__ bool disjoint(const unsigned* __restrict__ c,
                                         const unsigned* sbeam, int w_rt) {
  unsigned acc = 0;
  if constexpr (W % 4 == 0 && W > 0) {
    const uint4* q = reinterpret_cast<const uint4*>(c);
#pragma unroll
    for (int k = 0; k < W / 4; ++k) {
      const uint4 v = __ldg(q + k);
      acc |= (v.x & sbeam[4 * k]) | (v.y & sbeam[4 * k + 1]) |
             (v.z & sbeam[4 * k + 2]) | (v.w & sbeam[4 * k + 3]);
    }
  } else if constexpr (W % 2 == 0 && W > 0) {
    const uint2* q = reinterpret_cast<const uint2*>(c);
#pragma unroll
    for (int k = 0; k < W / 2; ++k) {
      const uint2 v = __ldg(q + k);
      acc |= (v.x & sbeam[2 * k]) | (v.y & sbeam[2 * k + 1]);
    }
  } else {
    for (int k = 0; k < w_rt; ++k) acc |= __ldg(c + k) & sbeam[k];
  }
  return acc == 0;
}

// W > 0: W words known at compile time; W == 0: w_rt words.
template <typename T, int W>
__global__ void __launch_bounds__(kThreads)
scar_search_kernel(const unsigned* __restrict__ beam,
                   const unsigned* __restrict__ cand,
                   const bool* __restrict__ valid,
                   const long long* __restrict__ state_in, long long keep,
                   long long max_exp, const T* __restrict__ b_lat,
                   const T* __restrict__ b_e, const T* __restrict__ c_lat,
                   const T* __restrict__ c_e, int metric, int Bm, int N,
                   int w_rt, int n_tiles, int* __restrict__ sync,
                   T* __restrict__ score, long long* __restrict__ state_out) {
  extern __shared__ unsigned sbeam[];
  __shared__ int s_ticket, s_count;
  __shared__ int s_off[32];
  __shared__ long long s_red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) s_ticket = atomicAdd(sync, 1);
  __syncthreads();
  const int t = s_ticket;
  const int b = t / n_tiles, j = t % n_tiles;
  const int nw = W > 0 ? W : w_rt;
  for (int i = tid; i < nw; i += kThreads) sbeam[i] = beam[(size_t)b * nw + i];
  const long long exp0 = state_in[1];
  const bool live = b < state_in[2];
  __syncthreads();

  // 1. disjointness, and each candidate's rank among the tile's
  const int n0 = j * kTile;
  unsigned dis_bits = 0;
  int lane_rank[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = n0 + k * kThreads + tid;
    bool dis = false;
    if (live && n < N && valid[n])
      dis = disjoint<W>(cand + (size_t)n * nw, sbeam, nw);
    const unsigned ballot = __ballot_sync(0xffffffffu, dis);
    lane_rank[k] = __popc(ballot & ((1u << lane) - 1u));
    if (dis) dis_bits |= 1u << k;
    if (lane == 0) s_off[k * kWarps + warp] = __popc(ballot);
  }
  __syncthreads();
  if (warp == 0) {                  // exclusive scan in (round, warp) order
    const int v = s_off[lane];
    int inc = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, inc, o);
      if (lane >= o) inc += u;
    }
    s_off[lane] = inc - v;
    if (lane == 31) s_count = inc;
  }
  __syncthreads();
  const int d = s_count;
  int* tile_count = sync + 1;                  // [Bm, n_tiles]
  int* row_total = sync + 1 + Bm * n_tiles;    // [Bm]
  if (tid == 0) st_release(tile_count + t, d + 1);

  // 2. look back: the row's earlier tiles, then (the row total published
  //    first, so no row waits on the rows above it to publish) the rows
  //    above
  long long part = 0;
  for (int jj = tid; jj < j; jj += kThreads)
    part += wait_value(tile_count + b * n_tiles + jj);
  const long long E = block_sum(part, s_red[0]);
  if (tid == 0 && j == n_tiles - 1) st_release(row_total + b, (int)(E + d) + 1);
  part = 0;
  for (int bb = tid; bb < b; bb += kThreads)
    part += min(keep, (long long)wait_value(row_total + bb));
  const long long P = block_sum(part, s_red[1]);

  // 3. keep, budget and score
  const T inf = (T)INFINITY;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int n = n0 + k * kThreads + tid;
    if (n >= N) continue;
    T s = inf;
    if ((dis_bits >> k) & 1u) {
      const long long rank = E + s_off[k * kWarps + warp] + lane_rank[k] + 1;
      const long long before = P + rank - 1;
      if (rank <= keep && (exp0 + before < max_exp || before == 0)) {
        const T lat = max_of(b_lat[b], c_lat[n]);
        const T e = add_rn(b_e[b], c_e[n]);
        s = metric == 1 ? lat : metric == 2 ? e : mul_rn(lat, e);
      }
    }
    score[(size_t)b * N + n] = s;
  }

  // 4. the last ticket knows every row: the stage's counters
  if (tid == 0 && t == Bm * n_tiles - 1) {
    const long long sel = P + min(keep, E + d);
    const long long total =
        sel == 0 ? 0 : max(1LL, min(sel, max_exp - exp0));
    state_out[0] = total;
    state_out[1] = exp0 + total;
    state_out[2] = min(total, (long long)Bm);
    state_out[3] = total == 0;
  }
}

template <typename T>
int launch_typed(const unsigned* beam, const unsigned* cand,
                 const bool* valid, const long long* state_in,
                 long long keep, long long max_exp, const T* b_lat,
                 const T* b_e, const T* c_lat, const T* c_e, int metric,
                 int Bm, int N, int W, int* sync, T* score,
                 long long* state_out, cudaStream_t s) {
  const int n_tiles = (N + kTile - 1) / kTile;
  const size_t smem = sizeof(unsigned) * (size_t)W;
  const uintptr_t align = reinterpret_cast<uintptr_t>(cand);
#define SCAR_SEARCH_LAUNCH(WT)                                               \
  scar_search_kernel<T, WT><<<Bm * n_tiles, kThreads, smem, s>>>(            \
      beam, cand, valid, state_in, keep, max_exp, b_lat, b_e, c_lat, c_e,    \
      metric, Bm, N, W, n_tiles, sync, score, state_out)
  if (W == 8 && align % 16 == 0) {
    SCAR_SEARCH_LAUNCH(8);
  } else if (W == 4 && align % 16 == 0) {
    SCAR_SEARCH_LAUNCH(4);
  } else if (W == 2 && align % 8 == 0) {
    SCAR_SEARCH_LAUNCH(2);
  } else {
    SCAR_SEARCH_LAUNCH(0);
  }
#undef SCAR_SEARCH_LAUNCH
  return (int)cudaGetLastError();
}

}  // namespace

// Ints of the zeroed sync buffer a launch needs: a ticket counter, a count
// per (row, tile) and a total per row.
extern "C" long long scar_search_sync_ints(int Bm, int N) {
  const long long n_tiles = (N + kTile - 1) / kTile;
  return 1 + (long long)Bm * n_tiles + Bm;
}

// Zeroes `sync` and launches on `stream`; returns the first CUDA error (0
// on success).  beam: [Bm, W], cand: [N, W] uint32 bits; valid: [N] bool;
// state_in / state_out: int64 (total, expansions, live rows, no
// placement); b_lat, b_e: [Bm], c_lat, c_e: [N], score: [Bm, N], all
// float32 (dtype 0) or float64 (dtype 1); metric 0 edp, 1 latency,
// 2 energy.
extern "C" int scar_search_launch(const void* beam, const void* cand,
                                  const void* valid, const void* state_in,
                                  long long keep, long long max_exp,
                                  const void* b_lat, const void* b_e,
                                  const void* c_lat, const void* c_e,
                                  int metric, int dtype, int Bm, int N, int W,
                                  void* sync, void* score, void* state_out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t err = cudaMemsetAsync(
      sync, 0, sizeof(int) * (size_t)scar_search_sync_ints(Bm, N), s);
  if (err != cudaSuccess) return (int)err;
  const unsigned* bw = static_cast<const unsigned*>(beam);
  const unsigned* cw = static_cast<const unsigned*>(cand);
  const bool* v = static_cast<const bool*>(valid);
  const long long* si = static_cast<const long long*>(state_in);
  long long* so = static_cast<long long*>(state_out);
  int* sy = static_cast<int*>(sync);
  if (dtype == 0)
    return launch_typed<float>(
        bw, cw, v, si, keep, max_exp, static_cast<const float*>(b_lat),
        static_cast<const float*>(b_e), static_cast<const float*>(c_lat),
        static_cast<const float*>(c_e), metric, Bm, N, W, sy,
        static_cast<float*>(score), so, s);
  return launch_typed<double>(
      bw, cw, v, si, keep, max_exp, static_cast<const double*>(b_lat),
      static_cast<const double*>(b_e), static_cast<const double*>(c_lat),
      static_cast<const double*>(c_e), metric, Bm, N, W, sy,
      static_cast<double*>(score), so, s);
}
