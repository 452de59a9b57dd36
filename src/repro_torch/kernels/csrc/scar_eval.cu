// scar_eval: window (latency, energy) of SCHED candidate plans, comm terms
// included, for every model of a scheduling window in one launch.
//
// Replaces the Pallas TPU kernel src/repro/kernels/scar_eval/kernel.py
// (scar_eval / _scar_kernel) together with the jitted code around it in
// src/repro/kernels/scar_eval/ops.py::evaluate_traceable.  The TPU kernel
// reads dense [B, L, C] class and [B, L, S] segment one-hots and turns the
// segment reduction into MXU matvecs; the comm terms come from XLA before
// it.  Here one launch takes the raw integers the host holds for each
// candidate (chiplet of each segment, window-relative last layer, live
// segment count) and the window's float32 rows of the CostDB, and does all
// of it: the class lookup, the blocked prefix sums of the two cost tables
// and of the weight bytes, the segment weight sums and last-layer output
// bytes, hop counts, the DRAM and NoP formulas of cost.comm_from_parts
// with the first segment's cold-DRAM or anchored input, the segment sums
// and the pipelined max.
//
// Launch: a segmented batch.  A descriptor row per model gives its
// candidate offset and count, table offset and layer count, anchor
// chiplet (-1: cold DRAM input), pipelined flag and first CTA.  A CTA
// scores blockDim.x consecutive candidates of one model.
//
// Bound on an H100: neither bytes nor operations.  The largest 16x16
// window reads about 1 MB of candidate integers and writes 8 B a
// candidate, a fraction of a microsecond at 3.35 TB/s, and does a few
// dozen float operations a segment.  What costs is latency: the torch ops
// that used to build the comm terms (about 150 a model) and the serial
// prefix chain of each CTA.  So the launch covers the whole window, CTAs
// are small (32 candidates: a 16x16 batch of 4 672 gives 146 of them, a
// window several hundred) and each builds its prefix tables in parallel,
// one thread per (column, 16-row block), then the block totals' carry, so
// the serial chain is about 16 + Lw / 16 adds, not Lw.  Tables take
// dynamic shared memory past 48 KB after an opt-in, up to 227 KB.
//
// Bits: every float operation is the one the plain torch version does, in
// its order.  Torch's elementwise kernels never fuse a multiply into an
// add, so the formulas use __fmul_rn / __fadd_rn, which nvcc does not
// contract into FMAs.  The prefix sums follow the reference's float32
// association (jnp.cumsum on the CPU: sequential in blocks of 16, then
// the blocked prefix of the block totals).
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlock = 16;
constexpr int kDesc = 8;   // descriptor ints a model
// Carry levels of the blocked prefix: level l + 1 holds the totals of
// level l's 16-blocks, up to the first level of at most 16 entries; 9
// levels cover any int row count.
constexpr int kLevels = 9;

// Entries of each level for Lw >= 1 rows (len[0] = Lw, len[1] the block
// totals, ..., len[top] <= 16, len[top + 1] = 1: the top is one block);
// returns the top level.
__host__ __device__ __forceinline__ int level_sizes(int Lw, int* len) {
  int top = 0;
  len[0] = Lw;
  do {
    len[top + 1] = (len[top] + kBlock - 1) / kBlock;
    ++top;
  } while (len[top] > kBlock);
  len[top + 1] = 1;
  return top;
}

// Package constants, rounded to float32 by the wrapper as torch rounds a
// Python scalar against a float32 tensor.
struct Consts {
  float inv_dram, inv_nop, hop_lat, dram_lat, delta_dram, delta_nop,
      dram_e_pj, nop_e_pj, bits, pj;
  int cols, C, S, n_models;
};

__device__ __forceinline__ float dram_lat(const Consts& k, float sz,
                                          float hops) {
  if (!(sz > 0.f)) return 0.f;
  return __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(sz, k.inv_dram),
                                       __fmul_rn(hops, k.hop_lat)),
                             k.dram_lat),
                   __fmul_rn(k.delta_dram, sz));
}

__device__ __forceinline__ float nop_lat(const Consts& k, float sz,
                                         float hops) {
  if (!(sz > 0.f && hops > 0.f)) return 0.f;
  return __fadd_rn(__fadd_rn(__fmul_rn(sz, k.inv_nop),
                             __fmul_rn(hops, k.hop_lat)),
                   __fmul_rn(k.delta_nop, sz));
}

__device__ __forceinline__ float dram_e(const Consts& k, float sz,
                                        float hops) {
  return __fmul_rn(__fmul_rn(__fmul_rn(sz, k.bits),
                             __fadd_rn(k.dram_e_pj,
                                       __fmul_rn(k.nop_e_pj, hops))),
                   k.pj);
}

__device__ __forceinline__ float nop_e(const Consts& k, float sz,
                                       float hops) {
  return __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(sz, k.bits), k.nop_e_pj),
                             hops),
                   k.pj);
}

__device__ __forceinline__ float hops_between(int a, int b, int cols) {
  return (float)(abs(a / cols - b / cols) + abs(a % cols - b % cols));
}

__global__ void scar_eval_kernel(
    const float* __restrict__ lat_tab, const float* __restrict__ e_tab,
    const float* __restrict__ w_bytes, const float* __restrict__ out_bytes,
    const float* __restrict__ act_in, const int* __restrict__ chips,
    const int* __restrict__ last, const int* __restrict__ n_segs,
    const int* __restrict__ class_map, const int* __restrict__ desc,
    Consts k, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  int m = 0;
  for (int i = 1; i < k.n_models; ++i)
    if (desc[i * kDesc + 6] <= (int)blockIdx.x) m = i;
  const int* d = desc + m * kDesc;
  const int cand_off = d[0], B = d[1], tab_off = d[2], Lw = d[3];
  const int prev_end = d[4], pipelined = d[5], cta0 = d[6];
  const int C = k.C, K = 2 * C + 1;            // lat, energy, weight bytes
  int len[kLevels + 1];
  const int top = level_sizes(Lw, len);
  float* cum = smem;                           // [Lw + 1, K]
  float* lev[kLevels + 1];                     // level l: [K, len[l]]
  lev[1] = cum + (Lw + 1) * K;
  for (int l = 1; l < top; ++l) lev[l + 1] = lev[l] + K * len[l];
  const int nb = len[1];

  // 1. sequential sums within blocks of 16 rows, one thread a (column,
  //    block); row 0 of every column is the zero row
  for (int it = tid; it < K * nb; it += nt) {
    const int col = it / nb, b = it % nb;
    const float* tab;
    int stride;
    if (col < C) {
      tab = lat_tab + (size_t)tab_off * C + col;
      stride = C;
    } else if (col < 2 * C) {
      tab = e_tab + (size_t)tab_off * C + (col - C);
      stride = C;
    } else {
      tab = w_bytes + tab_off;
      stride = 1;
    }
    const int lo = b * kBlock, hi = min(Lw, lo + kBlock);
    float acc = 0.f;
    for (int i = lo; i < hi; ++i) {
      acc = __fadd_rn(acc, tab[(size_t)i * stride]);
      cum[(i + 1) * K + col] = acc;
    }
    lev[1][col * nb + b] = acc;
  }
  for (int col = tid; col < K; col += nt) cum[col] = 0.f;
  __syncthreads();

  // 2. up the levels: each level's 16-blocks summed in place, their totals
  //    the next level, until one block (the top) is the whole prefix
  for (int l = 1; l <= top; ++l) {
    const int n = len[l], nbl = len[l + 1];
    float* v = lev[l];
    for (int it = tid; it < K * nbl; it += nt) {
      const int col = it / nbl, b = it % nbl;
      const int lo = b * kBlock, hi = min(n, lo + kBlock);
      float acc = 0.f;
      for (int i = lo; i < hi; ++i) {
        acc = __fadd_rn(acc, v[col * n + i]);
        v[col * n + i] = acc;
      }
      if (l < top) lev[l + 1][col * nbl + b] = acc;
    }
    __syncthreads();
  }
  // 3. down the levels: every entry past a level's first block takes the
  //    prefix of the earlier blocks' totals from the level above, and
  //    every table row past the first block takes level 1's
  for (int l = top - 1; l >= 0; --l) {
    const int n = len[l], rest = n - kBlock;
    const float* carry = lev[l + 1];
    const int nc = len[l + 1];
    for (int it = tid; it < K * rest; it += nt) {
      const int col = it / rest, i = kBlock + it % rest;
      float* y = l == 0 ? cum + (i + 1) * K + col : lev[l] + col * n + i;
      *y = __fadd_rn(*y, carry[col * nc + i / kBlock - 1]);
    }
    __syncthreads();
  }

  // 4. one thread a candidate
  const int local = (blockIdx.x - cta0) * nt + tid;
  if (local >= B) return;
  const size_t row = (size_t)cand_off + local;
  const int S = k.S, cols = k.cols;
  const int n_raw = n_segs[row];
  const int ns = min(max(n_raw, 0), S);
  const int* crow = chips + row * S;
  const int* lrow = last + row * S;
  const float* outb = out_bytes + tab_off;
  float lat_sum = 0.f, lat_max = -INFINITY, e_sum = 0.f;
  int lo = 0;
  for (int s = 0; s < ns; ++s) {
    const int chip = max(crow[s], 0);
    const int cc = chip % cols;
    const float hd = (float)min(cc, cols - 1 - cc);
    const int lv = lrow[s];
    const int hi = min(max(lv, 0), Lw - 1) + 1;
    const int cls = min(max(class_map[chip], 0), C - 1);
    const float seg_w =
        __fsub_rn(cum[hi * K + 2 * C], cum[lo * K + 2 * C]);
    float ip_lat = dram_lat(k, seg_w, hd), ip_e = dram_e(k, seg_w, hd);
    if (s == 0) {
      const float act = act_in[m];
      if (prev_end < 0) {
        ip_lat = __fadd_rn(ip_lat, dram_lat(k, act, hd));
        ip_e = __fadd_rn(ip_e, dram_e(k, act, hd));
      } else {
        const float h0 = hops_between(chip, prev_end, cols);
        ip_lat = __fadd_rn(ip_lat, nop_lat(k, act, h0));
        ip_e = __fadd_rn(ip_e, nop_e(k, act, h0));
      }
    }
    const float slo = outb[hi - 1];
    float op_lat, op_e;
    if (s == n_raw - 1) {                      // DRAM writeback
      op_lat = dram_lat(k, slo, hd);
      op_e = dram_e(k, slo, hd);
    } else {                                   // NoP to the next segment
      const float hn = hops_between(chip, max(crow[(s + 1) % S], 0), cols);
      op_lat = nop_lat(k, slo, hn);
      op_e = nop_e(k, slo, hn);
    }
    const float comp_lat =
        __fsub_rn(cum[hi * K + cls], cum[lo * K + cls]);
    const float comp_e =
        __fsub_rn(cum[hi * K + C + cls], cum[lo * K + C + cls]);
    const float seg_lat = __fadd_rn(comp_lat, __fadd_rn(ip_lat, op_lat));
    const float seg_e = __fadd_rn(comp_e, __fadd_rn(ip_e, op_e));
    lat_sum = __fadd_rn(lat_sum, seg_lat);
    lat_max = fmaxf(lat_max, seg_lat);
    e_sum = __fadd_rn(e_sum, seg_e);
    lo = min(max(lv, -1) + 1, Lw);
  }
  out[2 * row] = (pipelined && n_raw > 1) ? lat_max : lat_sum;
  out[2 * row + 1] = e_sum;
}

}  // namespace

// Dynamic shared memory of a CTA for Lw layers and C classes, in bytes.
extern "C" long long scar_eval_smem_bytes(int Lw, int C) {
  const long long K = 2LL * C + 1;
  int len[kLevels + 1];
  const int top = level_sizes(Lw, len);
  long long entries = Lw + 1LL;
  for (int l = 1; l <= top; ++l) entries += len[l];
  return (long long)sizeof(float) * K * entries;
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// consts: the 10 float32 package constants in Consts' order; desc: [M, 8]
// ints on the device; n_ctas: the total of every model's CTAs; Lw_max: the
// widest model of the window (it sizes the shared memory).
extern "C" int scar_eval_launch(const float* lat_tab, const float* e_tab,
                                const float* w_bytes, const float* out_bytes,
                                const float* act_in, const int* chips,
                                const int* last, const int* n_segs,
                                const int* class_map, const int* desc,
                                int n_models, int n_ctas, int threads,
                                int Lw_max, const float* consts, int cols,
                                int C, int S, float* out, void* stream) {
  if (n_ctas == 0) return (int)cudaGetLastError();
  Consts k;
  k.inv_dram = consts[0];
  k.inv_nop = consts[1];
  k.hop_lat = consts[2];
  k.dram_lat = consts[3];
  k.delta_dram = consts[4];
  k.delta_nop = consts[5];
  k.dram_e_pj = consts[6];
  k.nop_e_pj = consts[7];
  k.bits = consts[8];
  k.pj = consts[9];
  k.cols = cols;
  k.C = C;
  k.S = S;
  k.n_models = n_models;
  const size_t smem = (size_t)scar_eval_smem_bytes(Lw_max, C);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        scar_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  scar_eval_kernel<<<n_ctas, threads, smem, (cudaStream_t)stream>>>(
      lat_tab, e_tab, w_bytes, out_bytes, act_in, chips, last, n_segs,
      class_map, desc, k, out);
  return (int)cudaGetLastError();
}
