// scar_eval: per-candidate window (latency, energy) of SCHED candidate plans.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scar_eval/kernel.py
// (scar_eval / _scar_kernel).  The TPU kernel reads dense [B, L, C] class
// and [B, L, S] segment one-hots and turns the per-segment reduction into
// MXU matvecs.  This kernel reads the compact form instead: per segment its
// chiplet class, the window-relative index of its last layer and the live
// segment count, plus the per-segment comm terms computed in torch before
// the launch.
//
// Design: one thread per candidate, 128 threads a block.  Each block stages
// prefix sums of the [Lw, C] latency and energy tables in shared memory
// (2 * (Lw + 1) * C floats plus a little scratch); a segment's compute cost
// is then the difference of two prefix entries of its class column, so a
// thread does O(S) work whatever Lw is.  The prefix sums follow the
// association of the reference's float32 evaluator (jnp.cumsum on the CPU:
// sequential within blocks of 16 layers, plus the blocked prefix of the
// block totals), so this kernel, its plain torch version and the reference
// produce the same float32 bits.
//
// Bound on an H100: bytes.  Per candidate it reads S * (4 + 4 + 4 + 4) bytes
// of ids and comm terms plus 4 for n_segs and writes 8: about 100 B at
// S = 6, so 0.8 MB at B = 7 872, which the card's 3.35 TB/s moves in well
// under a microsecond.  The arithmetic (a few adds per segment) is
// negligible, so at the main path's batch sizes launch overhead dominates;
// the kernel makes no attempt to hide it (a later change can fuse the comm
// terms or batch several models per launch).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockThreads = 128;
constexpr int kPrefixBlock = 16;

// y[0] = 0 and y[i + 1] = x[0] + ... + x[i] for i < n, with x read at
// stride sx and y written at stride sy, summed sequentially within blocks
// of 16 elements and then offset by the prefix of the block totals (itself
// blocked the same way).  scratch holds 2 * (n1 + n2) floats, where
// n1 = ceil(n / 16) and n2 = ceil(n1 / 16); n <= 4096 keeps n2 <= 16.
__device__ void blocked_prefix(const float* x, int sx, int n, float* y,
                               int sy, float* scratch) {
  const int n1 = (n + kPrefixBlock - 1) / kPrefixBlock;
  const int n2 = (n1 + kPrefixBlock - 1) / kPrefixBlock;
  float* t1 = scratch;
  float* s1 = t1 + n1;
  float* t2 = s1 + n1;
  float* s2 = t2 + n2;
  y[0] = 0.f;
  for (int b = 0; b < n1; ++b) {
    float acc = 0.f;
    const int hi = min(n, (b + 1) * kPrefixBlock);
    for (int i = b * kPrefixBlock; i < hi; ++i) {
      acc += x[i * sx];
      y[(i + 1) * sy] = acc;
    }
    t1[b] = acc;
  }
  if (n1 == 1) return;
  for (int b = 0; b < n2; ++b) {
    float acc = 0.f;
    const int hi = min(n1, (b + 1) * kPrefixBlock);
    for (int j = b * kPrefixBlock; j < hi; ++j) {
      acc += t1[j];
      s1[j] = acc;
    }
    t2[b] = acc;
  }
  if (n2 > 1) {
    float acc = 0.f;
    for (int k = 0; k < n2; ++k) {
      acc += t2[k];
      s2[k] = acc;
    }
    for (int j = kPrefixBlock; j < n1; ++j) s1[j] += s2[j / kPrefixBlock - 1];
  }
  for (int i = kPrefixBlock; i < n; ++i)
    y[(i + 1) * sy] += s1[i / kPrefixBlock - 1];
}

__global__ void __launch_bounds__(kBlockThreads)
scar_eval_kernel(const float* __restrict__ lat_tab,
                 const float* __restrict__ e_tab, int Lw, int C,
                 const int* __restrict__ seg_cls,
                 const int* __restrict__ last,
                 const int* __restrict__ n_segs,
                 const float* __restrict__ comm_lat,
                 const float* __restrict__ comm_e, int B, int S,
                 int pipelined, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* cum_lat = smem;                       // [(Lw + 1), C] row-major
  float* cum_e = cum_lat + (Lw + 1) * C;
  float* scratch = cum_e + (Lw + 1) * C;
  const int n1 = (Lw + kPrefixBlock - 1) / kPrefixBlock;
  const int per_col = 2 * (n1 + (n1 + kPrefixBlock - 1) / kPrefixBlock);

  // threads 0 .. 2C-1 each build one prefix column (C <= 64)
  const int t = threadIdx.x;
  if (t < 2 * C) {
    const bool is_lat = t < C;
    const int c = is_lat ? t : t - C;
    blocked_prefix((is_lat ? lat_tab : e_tab) + c, C, Lw,
                   (is_lat ? cum_lat : cum_e) + c, C, scratch + t * per_col);
  }
  __syncthreads();

  const int b = blockIdx.x * kBlockThreads + t;
  if (b >= B) return;
  const int ns = min(n_segs[b], S);
  const int* cls_row = seg_cls + (size_t)b * S;
  const int* last_row = last + (size_t)b * S;
  const float* cl_row = comm_lat + (size_t)b * S;
  const float* ce_row = comm_e + (size_t)b * S;
  float lat_sum = 0.f, lat_max = -INFINITY, e_sum = 0.f;
  int lo = 0;                                  // prefix row of segment start
  for (int s = 0; s < ns; ++s) {
    const int c = min(max(cls_row[s], 0), C - 1);
    const int hi = min(max(last_row[s], 0), Lw - 1) + 1;
    const float comp_lat = cum_lat[hi * C + c] - cum_lat[lo * C + c];
    const float comp_e = cum_e[hi * C + c] - cum_e[lo * C + c];
    const float seg_lat = comp_lat + cl_row[s];
    lat_sum += seg_lat;
    lat_max = fmaxf(lat_max, seg_lat);
    e_sum += comp_e + ce_row[s];
    lo = min(max(last_row[s], -1) + 1, Lw);
  }
  out[2 * (size_t)b] = (pipelined && ns > 1) ? lat_max : lat_sum;
  out[2 * (size_t)b + 1] = e_sum;
}

}  // namespace

// Shared memory the launch needs, in bytes (the wrapper checks it first).
extern "C" long long scar_eval_smem_bytes(int Lw, int C) {
  const long long n1 = (Lw + kPrefixBlock - 1) / kPrefixBlock;
  const long long n2 = (n1 + kPrefixBlock - 1) / kPrefixBlock;
  return (long long)sizeof(float) *
         (2LL * (Lw + 1) * C + 2LL * C * 2LL * (n1 + n2));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int scar_eval_launch(const float* lat_tab, const float* e_tab,
                                int Lw, int C, const int* seg_cls,
                                const int* last, const int* n_segs,
                                const float* comm_lat, const float* comm_e,
                                int B, int S, int pipelined, float* out,
                                void* stream) {
  if (B == 0) return (int)cudaGetLastError();
  const int grid = (B + kBlockThreads - 1) / kBlockThreads;
  const size_t smem = (size_t)scar_eval_smem_bytes(Lw, C);
  scar_eval_kernel<<<grid, kBlockThreads, smem, (cudaStream_t)stream>>>(
      lat_tab, e_tab, Lw, C, seg_cls, last, n_segs, comm_lat, comm_e, B, S,
      pipelined, out);
  return (int)cudaGetLastError();
}
