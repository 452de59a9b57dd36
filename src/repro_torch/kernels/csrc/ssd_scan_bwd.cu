// ssd_scan_bwd: the gradient of ssd_scan (the Mamba-2 SSD scan).
//
// New in the port: the TPU package has no backward Pallas kernel; it
// differentiates the model layer's `gla_chunked`
// (src/repro/models/layers.py:314) with jax.grad.  Per (batch, head), for
//
//   o_t = q_t . S_t,     S_t = exp(a_t) S_{t-1} + k_t^T v_t      (S: [N, P])
//
// computed chunk by chunk as ssd_scan.cu computes it (cum the in-chunk
// prefix sums of a in `blocked_cumsum`'s association, total the chunk's
// last one, S_in the state entering the chunk, dS_out the gradient of the
// state leaving it), the gradient given dO is
//
//   dq_t = sum_{s <= t} (dO_t . v_s) exp(cum_t - cum_s) k_s
//          + exp(cum_t) dO_t S_in^T
//   dk_s = sum_{t >= s} (dO_t . v_s) exp(cum_t - cum_s) q_t
//          + exp(total - cum_s) dS_out v_s
//   dv_s = sum_{t >= s} (q_t . k_s) exp(cum_t - cum_s) dO_t
//          + exp(total - cum_s) k_s dS_out
//   dS_in = exp(total) dS_out + sum_t (q_t exp(cum_t))^T dO_t
//   da_t = sum_{u >= t} (q_u . dq_u - k_u . dk_u)      (over the whole
//                                                      sequence)
//
// (the last: d o_u / d a_t gathers every pair s < t <= u, which is the
// reverse sum of the pairs a row closes, q_u . dq_u, less those it opens,
// k_u . dk_u).  The sums run in float32 and every output element is
// written once by one thread: no atomics, the same bits on every run.
//
// Layout: q, k [B, L, H, N], v, dO [B, L, H, P], a [B, L, H] float32, each
// with its own batch, sequence and head strides and a contiguous last
// dimension (Mamba-2's q and k have head stride 0: broadcast over heads).
// dq and dk come back per head, new contiguous [B, L, H, N]: the caller's
// broadcast (autograd's `expand` backward) sums them over the heads.  dv is
// [B, L, H, P] and da [B, L, H] float32.  bf16 or float32 in, the inputs'
// type out, float32 inside.
//
// Four kernels in order on the stream, with a float32 workspace:
//  * states: each chunk's S_in (and its prefix sums) and dS_out.  float32
//    (ssd_bwd_states): one block per (batch, head, direction) walks the
//    chunks in order (backward: in reverse), the [N, P] state in
//    registers, 16 values a thread, CUDA cores.  bf16 on the tensor cores
//    (ssd_bwd_chunk_states_tc): one block per (batch, head, chunk,
//    direction) forms the chunk's own state or state gradient, then
//    ssd_bwd_combine chains them in order, in place (one more launch).
//  * dq: one block per (batch, head, chunk, 64 rows): the inter term from
//    S_in, then per 64-row kv tile up to the diagonal the gated dO v^T
//    times k.  Also q_t . dq_t.
//  * dk / dv: one block per (batch, head, chunk, 64 rows): the state terms
//    from dS_out, then per 64-row query tile from the diagonal on the
//    gated q k^T and dO v^T, transposed into dv and dk.  Also k_s . dk_s.
//  * ssd_bwd_da: one block per (batch, head): the reverse sums.
// bf16 (the training path; N and P multiples of 16 and rows that allow
// 16 B loads, else the call is refused) runs dq and dk / dv on the tensor
// cores (ssd_bwd_dq_tc, ssd_bwd_dkv_tc): four warps a block, 16 rows
// each, mma.sync m16n8k16 (bf16 in, float32 sums); products of bf16
// inputs (q k^T, dO v^T, and those against k, q, dO) are exact, and the
// float32-held operands (the gated scores, S_in, dS_out) are split into
// two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), about 16 bits.
// float32 takes the CUDA cores (ssd_bwd_dq, ssd_bwd_dkv): float32 FMAs out
// of shared memory, each thread a 4 x 4 micro-tile of a 64 x 64 score
// tile or N / 4 (P / 4) output columns of one row.
//
// Bound on an H100 at the training shape (zamba2-2.7b's Mamba-2: B = 4,
// L = 1024, 80 heads, N = P = 64, chunk 256, bf16, q and k broadcast):
// about 4e10 FLOP of in-chunk and state products (41 us at 989 TFLOP/s
// bf16), and q, k (broadcast), v, dO and a read and their gradients
// written once, about 131 MB (39 us at 3.35 TB/s): bound by operations.
// These kernels repeat the split operands' products, write dq and dk per
// head, load their tiles synchronously and launch five times; wgmma tiles
// fed by a load pipeline, as in the forward, are the later step (PERF.md
// has the times).  It takes N, P <= 64 and chunks <= 256 rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;               // rows of a tile
constexpr int kLd = kT + 1;          // row pitch of a score tile
constexpr int kMaxNP = 64;
constexpr int kMaxChunk = 256;
constexpr int kScanBlock = 16;       // association of the prefix sums
constexpr int kScanSlots = kMaxChunk / kScanBlock;
constexpr int kStateRegs = kMaxNP * kMaxNP / kThreads;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* a;
  void* dq;                          // [B, L, H, N], per head
  void* dk;                          // [B, L, H, N], per head
  void* dv;                          // [B, L, H, P]
  float* da;                         // [B, L, H]
  float* S;                          // [B, H, nc, N, P]: S_in of each chunk
  float* dS;                         // [B, H, nc, N, P]: dS_out of each
  float* cum;                        // [B, H, L]: in-chunk prefix sums
  float* rq;                         // [B, H, L]: q_t . dq_t
  float* rk;                         // [B, H, L]: k_t . dk_t
  float* tot;                        // [B, H, nc]: each chunk's total
  int B, L, H, N, P, chunk, nc;
  long long qs[3], ks[3], vs[3], dos[3], as[3];   // batch, sequence, head
};

// Inclusive prefix sums of x[0], x[stride], ... (n <= kMaxChunk values)
// into out, in the association of ssd_scan.cu and of the plain version's
// `blocked_cumsum`: sequential within blocks of 16, each block offset by
// the prefix of the earlier blocks' totals.  Ends with a barrier.
__device__ void blocked_cumsum(const float* x, long long stride, int n,
                               float* out, float* tot, float* carry) {
  const int tid = threadIdx.x;
  const int nb = (n + kScanBlock - 1) / kScanBlock;
  for (int i = tid; i < n; i += blockDim.x) out[i] = x[i * stride];
  __syncthreads();
  for (int blk = tid; blk < nb; blk += blockDim.x) {
    float s = 0.f;
    for (int i = blk * kScanBlock; i < min(n, (blk + 1) * kScanBlock); ++i) {
      s += out[i];
      out[i] = s;
    }
    tot[blk] = s;
  }
  __syncthreads();
  if (tid == 0 && nb > 1) {          // nb <= kScanSlots = kScanBlock
    float s = 0.f;
    for (int b = 0; b < nb; ++b) carry[b] = s += tot[b];
  }
  __syncthreads();
  for (int i = kScanBlock + tid; i < n; i += blockDim.x)
    out[i] += carry[i / kScanBlock - 1];
  __syncthreads();
}

// s[jr][ic] = x[rg + 16 jr] . y[cg + 16 ic] over w columns (pitch w + 1)
__device__ __forceinline__ void tile_dot(const float* x, const float* y,
                                         int w, float s[4][4]) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int ldw = w + 1;
#pragma unroll
  for (int jr = 0; jr < 4; ++jr)
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) s[jr][ic] = 0.f;
  for (int d = 0; d < w; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) xv[jr] = x[(rg + 16 * jr) * ldw + d];
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) yv[ic] = y[(cg + 16 * ic) * ldw + d];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) s[jr][ic] += xv[jr] * yv[ic];
  }
}

// n rows (sequence stride rs) of w values into a 64-row tile (pitch w + 1),
// each row scaled by scale[r] when given; zeros past n
__device__ void load_rows(float* dst, const float* src, long long rs, int n,
                          int w, const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kT * w; e += kThreads) {
    const int r = e / w, c = e % w;
    float x = 0.f;
    if (r < n) {
      x = src[r * rs + c];
      if (scale) x *= scale[r];
    }
    dst[r * (w + 1) + c] = x;
  }
}

__device__ __forceinline__ long long slot(const Args& g, int b, int h, int c) {
  return (((long long)b * g.H + h) * g.nc + c) * g.N * g.P;
}

// grid (B * H, 2): y = 0 stores S_in and the prefix sums of every chunk,
// y = 1 every chunk's dS_out
__global__ void __launch_bounds__(kThreads) ssd_bwd_states(Args g) {
  extern __shared__ float smem[];
  const int N = g.N, P = g.P, c = g.chunk;
  float* sCum = smem;                         // kMaxChunk
  float* sTot = sCum + kMaxChunk;             // kScanSlots
  float* sCarry = sTot + kScanSlots;          // kScanSlots
  float* sW = sCarry + kScanSlots;            // kT: row weights
  float* sX = sW + kT;                        // kT x (N + 1)
  float* sY = sX + kT * (N + 1);              // kT x (P + 1)

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const bool fwd = blockIdx.y == 0;
  const float* X = static_cast<const float*>(fwd ? g.k : g.q) +
                   b * (fwd ? g.ks[0] : g.qs[0]) +
                   h * (fwd ? g.ks[2] : g.qs[2]);
  const long long xs = fwd ? g.ks[1] : g.qs[1];
  const float* Y = static_cast<const float*>(fwd ? g.v : g.dO) +
                   b * (fwd ? g.vs[0] : g.dos[0]) +
                   h * (fwd ? g.vs[2] : g.dos[2]);
  const long long ys = fwd ? g.vs[1] : g.dos[1];
  const float* A = g.a + b * g.as[0] + h * g.as[2];
  float* out = fwd ? g.S : g.dS;

  float st_[kStateRegs];
#pragma unroll
  for (int i = 0; i < kStateRegs; ++i) st_[i] = 0.f;
  const int NP = N * P;

  for (int step = 0; step < g.nc; ++step) {
    const int ci = fwd ? step : g.nc - 1 - step;
    const int c0 = ci * c;
    __syncthreads();
    blocked_cumsum(A + c0 * g.as[1], g.as[1], c, sCum, sTot, sCarry);
    const float total = sCum[c - 1];
    if (fwd)
      for (int i = tid; i < c; i += kThreads)
        g.cum[((long long)b * g.H + h) * g.L + c0 + i] = sCum[i];
    float* dst = out + slot(g, b, h, ci);
    const float et = expf(total);
#pragma unroll
    for (int i = 0; i < kStateRegs; ++i) {
      const int e = tid + kThreads * i;
      if (e < NP) dst[e] = st_[i];
      st_[i] *= et;
    }
    for (int r0 = 0; r0 < c; r0 += kT) {
      const int nr = min(kT, c - r0);
      __syncthreads();
      // forward: k_r exp(total - cum_r); backward: q_r exp(cum_r)
      if (tid < kT)
        sW[tid] = tid < nr ? expf(fwd ? total - sCum[r0 + tid]
                                      : sCum[r0 + tid])
                           : 0.f;
      __syncthreads();
      load_rows(sX, X + (c0 + r0) * xs, xs, nr, N, sW);
      load_rows(sY, Y + (c0 + r0) * ys, ys, nr, P);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kStateRegs; ++i) {
        const int e = tid + kThreads * i;
        if (e < NP) {
          const int n = e / P, p = e % P;
          float s = 0.f;
          for (int r = 0; r < nr; ++r)
            s += sX[r * (N + 1) + n] * sY[r * (P + 1) + p];
          st_[i] += s;
        }
      }
    }
  }
}

// grid (B * H * nc, chunk / 64 rounded up): dq of 64 rows of a chunk
__global__ void __launch_bounds__(kThreads) ssd_bwd_dq(Args g) {
  extern __shared__ float smem[];
  const int N = g.N, P = g.P, c = g.chunk;
  const int ldn = N + 1, ldp = P + 1;
  float* sCum = smem;                         // kMaxChunk
  float* sQ = sCum + kMaxChunk;               // kT x ldn
  float* sDO = sQ + kT * ldn;                 // kT x ldp
  float* sK = sDO + kT * ldp;                 // kT x ldn
  float* sV = sK + kT * ldn;                  // kT x ldp
  float* sG = sV + kT * ldp;                  // kT x kLd
  float* sS = sG + kT * kLd;                  // N x ldp: S_in

  const int tid = threadIdx.x;
  const int ci = blockIdx.x % g.nc, bh = blockIdx.x / g.nc;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c, i0 = blockIdx.y * kT;
  const int ni = min(kT, c - i0);
  const float* Q = static_cast<const float*>(g.q) + b * g.qs[0] + h * g.qs[2];
  const float* K = static_cast<const float*>(g.k) + b * g.ks[0] + h * g.ks[2];
  const float* V = static_cast<const float*>(g.v) + b * g.vs[0] + h * g.vs[2];
  const float* DO =
      static_cast<const float*>(g.dO) + b * g.dos[0] + h * g.dos[2];
  const long long lrow = ((long long)b * g.H + h) * g.L + c0;

  for (int i = tid; i < c; i += kThreads) sCum[i] = g.cum[lrow + i];
  const float* S = g.S + slot(g, b, h, ci);
  for (int e = tid; e < N * P; e += kThreads)
    sS[(e / P) * ldp + e % P] = S[e];
  load_rows(sQ, Q + (c0 + i0) * g.qs[1], g.qs[1], ni, N);
  load_rows(sDO, DO + (c0 + i0) * g.dos[1], g.dos[1], ni, P);
  __syncthreads();

  const int rg = tid / 16, cg = tid % 16;
  const int ro = tid / 4, co = tid % 4;       // row ro, columns co + 4 i
  float acc[kMaxNP / 4];
#pragma unroll
  for (int i = 0; i < kMaxNP / 4; ++i) acc[i] = 0.f;
  if (ro < ni) {                              // inter: exp(cum) dO S_in^T
    const float ec = expf(sCum[i0 + ro]);
    for (int p = 0; p < P; ++p) {
      const float x = sDO[ro * ldp + p] * ec;
#pragma unroll
      for (int i = 0; i < kMaxNP / 4; ++i) {
        const int n = co + 4 * i;
        if (n < N) acc[i] += x * sS[n * ldp + p];
      }
    }
  }
  float s[4][4];
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    const int nj = min(kT, c - j0);
    __syncthreads();
    load_rows(sK, K + (c0 + j0) * g.ks[1], g.ks[1], nj, N);
    load_rows(sV, V + (c0 + j0) * g.vs[1], g.vs[1], nj, P);
    __syncthreads();
    tile_dot(sDO, sV, P, s);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int r = rg + 16 * jr;
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int cc = cg + 16 * ic;
        float gated = 0.f;
        if (r < ni && cc < nj && j0 + cc <= i0 + r)
          gated = s[jr][ic] * expf(sCum[i0 + r] - sCum[j0 + cc]);
        sG[r * kLd + cc] = gated;
      }
    }
    __syncthreads();
    if (ro < ni) {
      const float* grow = sG + ro * kLd;
      for (int cc = 0; cc < nj; ++cc) {
        const float x = grow[cc];
        const float* krow = sK + cc * ldn;
#pragma unroll
        for (int i = 0; i < kMaxNP / 4; ++i) {
          const int n = co + 4 * i;
          if (n < N) acc[i] += x * krow[n];
        }
      }
    }
  }
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNP / 4; ++i) {
    const int n = co + 4 * i;
    if (n < N && ro < ni) r += sQ[ro * ldn + n] * acc[i];
  }
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  if (ro < ni) {
    const int t = c0 + i0 + ro;
    if (co == 0) g.rq[lrow - c0 + t] = r;
    float* out = static_cast<float*>(g.dq) +
                     (((long long)b * g.L + t) * g.H + h) * N;
#pragma unroll
    for (int i = 0; i < kMaxNP / 4; ++i) {
      const int n = co + 4 * i;
      if (n < N) out[n] = acc[i];
    }
  }
}

// grid (B * H * nc, chunk / 64 rounded up): dk and dv of 64 rows of a chunk
__global__ void __launch_bounds__(kThreads) ssd_bwd_dkv(Args g) {
  extern __shared__ float smem[];
  const int N = g.N, P = g.P, c = g.chunk;
  const int ldn = N + 1, ldp = P + 1;
  float* sCum = smem;                         // kMaxChunk
  float* sK = sCum + kMaxChunk;               // kT x ldn
  float* sV = sK + kT * ldn;                  // kT x ldp
  float* sQ = sV + kT * ldp;                  // kT x ldn
  float* sDO = sQ + kT * ldn;                 // kT x ldp
  float* sA = sDO + kT * ldp;                 // kT x kLd: gated q k^T
  float* sdA = sA + kT * kLd;                 // kT x kLd: gated dO v^T
  float* sDS = sdA + kT * kLd;                // N x ldp: dS_out

  const int tid = threadIdx.x;
  const int ci = blockIdx.x % g.nc, bh = blockIdx.x / g.nc;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c, j0 = blockIdx.y * kT;
  const int nj = min(kT, c - j0);
  const float* Q = static_cast<const float*>(g.q) + b * g.qs[0] + h * g.qs[2];
  const float* K = static_cast<const float*>(g.k) + b * g.ks[0] + h * g.ks[2];
  const float* V = static_cast<const float*>(g.v) + b * g.vs[0] + h * g.vs[2];
  const float* DO =
      static_cast<const float*>(g.dO) + b * g.dos[0] + h * g.dos[2];
  const long long lrow = ((long long)b * g.H + h) * g.L + c0;

  for (int i = tid; i < c; i += kThreads) sCum[i] = g.cum[lrow + i];
  const float* dS = g.dS + slot(g, b, h, ci);
  for (int e = tid; e < N * P; e += kThreads)
    sDS[(e / P) * ldp + e % P] = dS[e];
  load_rows(sK, K + (c0 + j0) * g.ks[1], g.ks[1], nj, N);
  load_rows(sV, V + (c0 + j0) * g.vs[1], g.vs[1], nj, P);
  __syncthreads();

  const int rg = tid / 16, cg = tid % 16;
  const int ro = tid / 4, co = tid % 4;       // row ro, columns co + 4 i
  float acc_k[kMaxNP / 4], acc_v[kMaxNP / 4];
#pragma unroll
  for (int i = 0; i < kMaxNP / 4; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (ro < nj) {          // state terms: exp(total - cum_s) (dS v_s, k_s dS)
    const float w = expf(sCum[c - 1] - sCum[j0 + ro]);
    for (int p = 0; p < P; ++p) {
      const float x = sV[ro * ldp + p] * w;
#pragma unroll
      for (int i = 0; i < kMaxNP / 4; ++i) {
        const int n = co + 4 * i;
        if (n < N) acc_k[i] += x * sDS[n * ldp + p];
      }
    }
    for (int n = 0; n < N; ++n) {
      const float x = sK[ro * ldn + n] * w;
      const float* drow = sDS + n * ldp;
#pragma unroll
      for (int i = 0; i < kMaxNP / 4; ++i) {
        const int p = co + 4 * i;
        if (p < P) acc_v[i] += x * drow[p];
      }
    }
  }
  float qk[4][4], dov[4][4];
  for (int i0 = j0; i0 < c; i0 += kT) {
    const int ni = min(kT, c - i0);
    __syncthreads();
    load_rows(sQ, Q + (c0 + i0) * g.qs[1], g.qs[1], ni, N);
    load_rows(sDO, DO + (c0 + i0) * g.dos[1], g.dos[1], ni, P);
    __syncthreads();
    tile_dot(sQ, sK, N, qk);
    tile_dot(sDO, sV, P, dov);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int r = rg + 16 * jr;             // query row t
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int cc = cg + 16 * ic;          // kv row s
        float gate = 0.f;
        if (r < ni && cc < nj && j0 + cc <= i0 + r)
          gate = expf(sCum[i0 + r] - sCum[j0 + cc]);
        sA[r * kLd + cc] = qk[jr][ic] * gate;
        sdA[r * kLd + cc] = dov[jr][ic] * gate;
      }
    }
    __syncthreads();
    if (ro < nj) {
      for (int t = 0; t < ni; ++t) {
        const float xa = sA[t * kLd + ro], xd = sdA[t * kLd + ro];
        const float* dorow = sDO + t * ldp;
        const float* qrow = sQ + t * ldn;
#pragma unroll
        for (int i = 0; i < kMaxNP / 4; ++i) {
          const int x = co + 4 * i;
          if (x < P) acc_v[i] += xa * dorow[x];
          if (x < N) acc_k[i] += xd * qrow[x];
        }
      }
    }
  }
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxNP / 4; ++i) {
    const int n = co + 4 * i;
    if (n < N && ro < nj) r += sK[ro * ldn + n] * acc_k[i];
  }
  r += __shfl_xor_sync(0xffffffffu, r, 1);
  r += __shfl_xor_sync(0xffffffffu, r, 2);
  if (ro < nj) {
    const int t = c0 + j0 + ro;
    if (co == 0) g.rk[lrow - c0 + t] = r;
    const long long row = ((long long)b * g.L + t) * g.H + h;
    float* dk = static_cast<float*>(g.dk) + row * N;
    float* dv = static_cast<float*>(g.dv) + row * P;
#pragma unroll
    for (int i = 0; i < kMaxNP / 4; ++i) {
      const int x = co + 4 * i;
      if (x < N) dk[x] = acc_k[i];
      if (x < P) dv[x] = acc_v[i];
    }
  }
}

// grid (B * H): da_t = sum_{u >= t} (rq_u - rk_u), each thread a segment
__global__ void __launch_bounds__(kThreads) ssd_bwd_da(Args g) {
  __shared__ float sSum[kThreads];
  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const long long base = ((long long)b * g.H + h) * g.L;
  const int seg = (g.L + kThreads - 1) / kThreads;
  const int t0 = min(g.L, tid * seg), t1 = min(g.L, t0 + seg);
  float s = 0.f;
  for (int t = t0; t < t1; ++t) s += g.rq[base + t] - g.rk[base + t];
  sSum[tid] = s;
  __syncthreads();
  if (tid == 0) {                   // exclusive suffix sums of the segments
    float acc = 0.f;
    for (int i = kThreads - 1; i >= 0; --i) {
      const float x = sSum[i];
      sSum[i] = acc;
      acc += x;
    }
  }
  __syncthreads();
  float acc = sSum[tid];
  for (int t = t1 - 1; t >= t0; --t) {
    acc += g.rq[base + t] - g.rk[base + t];
    g.da[((long long)b * g.L + t) * g.H + h] = acc;
  }
}

// ------------------------- bf16: tensor cores ------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;      // four warps, 16 tile rows each
constexpr int kTcLd = kMaxNP + 8;    // bf16 row pitch of a tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8.  Without .trans a lane receives (row l / 4, columns 2 (l % 4) and
// 2 (l % 4) + 1) of each; with .trans (rows 2 (l % 4), 2 (l % 4) + 1,
// column l / 4).
__device__ __forceinline__ void ldsm4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 sums.  Fragments of
// lane l (g = l / 4, t = l % 4): a = (g, 2t..), (g + 8, 2t..), (g, 2t + 8..),
// (g + 8, 2t + 8..); b = (2t.., g), (2t + 8.., g); c = (g, 2t), (g, 2t + 1),
// (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of the 16 x 16 block at (r0, c0) of a row-major tile.
__device__ __forceinline__ void ld_a(uint32_t* a, const bf16* s, int r0,
                                     int c0) {
  const int l = threadIdx.x % 32;
  ldsm4(a, s + (r0 + l % 16) * kTcLd + c0 + (l / 16) * 8);
}

// B fragments of n-tiles n0, n0 + 8 over k0 .. k0 + 15 from a tile held
// as rows of n (b[0], b[1] for n0; b[2], b[3] for n0 + 8) ...
__device__ __forceinline__ void ld_b_nk(uint32_t* b, const bf16* s, int n0,
                                        int k0) {
  const int l = threadIdx.x % 32;
  ldsm4(b, s + (n0 + l % 8 + (l / 16) * 8) * kTcLd + k0 + ((l / 8) % 2) * 8);
}

// ... or as rows of k.
__device__ __forceinline__ void ld_b_kn(uint32_t* b, const bf16* s, int k0,
                                        int n0) {
  const int l = threadIdx.x % 32;
  ldsm4_t(b, s + (k0 + l % 8 + ((l / 8) % 2) * 8) * kTcLd + n0 +
                 (l / 16) * 8);
}

__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments (hi, lo) of k-step kk of a 16 x 64 float32 operand held
// as C fragments c[8][4]: hi = bf16(x), lo = bf16(x - hi), about 16 bits.
__device__ __forceinline__ void split_a(const float (*c)[4], int kk,
                                        uint32_t* hi, uint32_t* lo) {
  const float* x[4] = {c[2 * kk], c[2 * kk] + 2, c[2 * kk + 1],
                       c[2 * kk + 1] + 2};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x[i][0], x[i][1]);
    hi[i] = *reinterpret_cast<const uint32_t*>(&h);
    lo[i] = pack(x[i][0] - __low2float(h), x[i][1] - __high2float(h));
  }
}

// n rows (sequence stride rs) of w bf16 values (w a multiple of 8) into a
// 64-row tile, 16 B at a time; zeros past n rows and w columns.
__device__ void load_tile_tc(bf16* dst, const bf16* src, long long rs, int n,
                             int w) {
  constexpr int per_row = kMaxNP / 8;
  for (int e = threadIdx.x; e < kT * per_row; e += kTcThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n && c < w) v = *reinterpret_cast<const uint4*>(src + r * rs + c);
    *reinterpret_cast<uint4*>(dst + r * kTcLd + c) = v;
  }
}

// A float32 [N, P] state into two bf16 tiles (hi, lo: rows n, pitch kTcLd,
// zeros past N and P).
__device__ void load_state_tc(bf16* hi, bf16* lo, const float* S, int N,
                              int P) {
  for (int e = threadIdx.x; e < kMaxNP * kMaxNP; e += kTcThreads) {
    const int n = e / kMaxNP, p = e % kMaxNP;
    const float x = n < N && p < P ? S[n * P + p] : 0.f;
    const bf16 h = __float2bfloat16(x);
    hi[n * kTcLd + p] = h;
    lo[n * kTcLd + p] = __float2bfloat16(x - __bfloat162float(h));
  }
}

// c[8][4] = x[16 rows from r0] y^T over w columns (a multiple of 16): a
// 16 x 64 tile of products of two row-major tiles.
__device__ __forceinline__ void tile_mma(float (*c)[4], const bf16* x,
                                         const bf16* y, int r0, int w) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
  for (int ks = 0; ks < w / 16; ++ks) {
    uint32_t xa[4];
    ld_a(xa, x, r0, 16 * ks);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t yb[4];
      ld_b_nk(yb, y, 16 * np, 16 * ks);
      mma(c[2 * np], xa, yb[0], yb[1]);
      mma(c[2 * np + 1], xa, yb[2], yb[3]);
    }
  }
}

// acc[8][4] (w columns used) += op[16 x 64] m[64 x w], op held as C
// fragments and split in two bf16 terms, m a row-major tile (rows k).
__device__ __forceinline__ void acc_mma(float (*acc)[4], const float (*op)[4],
                                        const bf16* m, int w) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split_a(op, kk, hi, lo);
    for (int nd = 0; nd < w / 16; ++nd) {
      uint32_t mb[4];
      ld_b_kn(mb, m, 16 * kk, 16 * nd);
      mma(acc[2 * nd], hi, mb[0], mb[1]);
      mma(acc[2 * nd + 1], hi, mb[2], mb[3]);
      mma(acc[2 * nd], lo, mb[0], mb[1]);
      mma(acc[2 * nd + 1], lo, mb[2], mb[3]);
    }
  }
}

// acc[8][4] (wn columns) += x[16 rows from r0, wk columns] m, m a float32
// matrix held as its (hi, lo) bf16 tiles: rows of n (nk) or rows of k.
__device__ __forceinline__ void state_mma(float (*acc)[4], const bf16* x,
                                          int r0, const bf16* hi,
                                          const bf16* lo, bool rows_n,
                                          int wk, int wn) {
  for (int ks = 0; ks < wk / 16; ++ks) {
    uint32_t xa[4];
    ld_a(xa, x, r0, 16 * ks);
    for (int nd = 0; nd < wn / 16; ++nd) {
#pragma unroll
      for (int term = 0; term < 2; ++term) {
        uint32_t mb[4];
        if (rows_n)
          ld_b_nk(mb, term ? lo : hi, 16 * nd, 16 * ks);
        else
          ld_b_kn(mb, term ? lo : hi, 16 * ks, 16 * nd);
        mma(acc[2 * nd], xa, mb[0], mb[1]);
        mma(acc[2 * nd + 1], xa, mb[2], mb[3]);
      }
    }
  }
}

constexpr size_t kTcTileBytes = (size_t)kT * kTcLd * sizeof(bf16);
constexpr size_t kTcBytes = 6 * kTcTileBytes + kMaxChunk * sizeof(float);
constexpr size_t kTcStatesBytes =
    3 * kTcTileBytes + (kMaxChunk + 2 * kScanSlots + kT) * sizeof(float);

// bf16 dq: one CTA of four warps per (batch, head, chunk, 64 rows t),
// warp w owning rows 16 w ..: the inter term exp(cum_t) dO_t S_in^T (S_in
// in two bf16 terms), then per kv tile up to the diagonal G = (dO v^T)
// exp(cum_t - cum_s) on s <= t and dq += G k (G in two bf16 terms); the
// products of bf16 inputs are exact, the sums float32.  Also q_t . dq_t.
__global__ void __launch_bounds__(kTcThreads) ssd_bwd_dq_tc(Args g) {
  extern __shared__ __align__(16) uint8_t smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sDO = sQ + kT * kTcLd;
  bf16* sK = sDO + kT * kTcLd;
  bf16* sV = sK + kT * kTcLd;
  bf16* sHi = sV + kT * kTcLd;
  bf16* sLo = sHi + kT * kTcLd;
  float* sCum = reinterpret_cast<float*>(sLo + kT * kTcLd);

  const int N = g.N, P = g.P, c = g.chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ci = blockIdx.x % g.nc, bh = blockIdx.x / g.nc;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c, i0 = blockIdx.y * kT;
  const int ni = min(kT, c - i0);
  const bf16* Q = static_cast<const bf16*>(g.q) + b * g.qs[0] + h * g.qs[2];
  const bf16* K = static_cast<const bf16*>(g.k) + b * g.ks[0] + h * g.ks[2];
  const bf16* V = static_cast<const bf16*>(g.v) + b * g.vs[0] + h * g.vs[2];
  const bf16* DO = static_cast<const bf16*>(g.dO) + b * g.dos[0] +
                   h * g.dos[2];
  const long long lrow = ((long long)b * g.H + h) * g.L + c0;

  for (int i = tid; i < c; i += kTcThreads) sCum[i] = g.cum[lrow + i];
  load_state_tc(sHi, sLo, g.S + slot(g, b, h, ci), N, P);
  load_tile_tc(sQ, Q + (c0 + i0) * g.qs[1], g.qs[1], ni, N);
  load_tile_tc(sDO, DO + (c0 + i0) * g.dos[1], g.dos[1], ni, P);
  __syncthreads();

  const int r0 = 16 * warp;
  const int rows[2] = {r0 + gq, r0 + gq + 8};       // in the tile
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  // inter: dO_t S_in^T (S_in's rows are n: B[k = p][n] = S_in[n][p])
  state_mma(acc, sDO, r0, sHi, sLo, true, P, N);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = rows[e / 2];
      acc[j][e] *= r < ni ? expf(sCum[i0 + r]) : 0.f;
    }
  float s[8][4];
  for (int j0 = 0; j0 <= i0; j0 += kT) {
    const int nj = min(kT, c - j0);
    __syncthreads();
    load_tile_tc(sK, K + (c0 + j0) * g.ks[1], g.ks[1], nj, N);
    load_tile_tc(sV, V + (c0 + j0) * g.vs[1], g.vs[1], nj, P);
    __syncthreads();
    tile_mma(s, sDO, sV, r0, P);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rows[e / 2], cc = 8 * j + 2 * tq + (e & 1);
        s[j][e] = r < ni && cc < nj && j0 + cc <= i0 + r
                      ? s[j][e] * expf(sCum[i0 + r] - sCum[j0 + cc])
                      : 0.f;
      }
    acc_mma(acc, s, sK, N);
  }
  float rq[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * tq + (e & 1);
      if (n < N)
        rq[e / 2] += __bfloat162float(sQ[rows[e / 2] * kTcLd + n]) *
                     acc[j][e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rq[hf] += __shfl_xor_sync(0xffffffffu, rq[hf], 1);
    rq[hf] += __shfl_xor_sync(0xffffffffu, rq[hf], 2);
    const int r = rows[hf];
    if (r >= ni) continue;
    const int t = c0 + i0 + r;
    if (tq == 0) g.rq[lrow - c0 + t] = rq[hf];
    bf16* out = static_cast<bf16*>(g.dq) +
                (((long long)b * g.L + t) * g.H + h) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = 8 * j + 2 * tq + e;
        if (n < N) out[n] = __float2bfloat16(acc[j][2 * hf + e]);
      }
  }
}

// bf16 dk, dv: one CTA of four warps per (batch, head, chunk, 64 rows s):
// the state terms exp(total - cum_s) (v_s dS_out^T, k_s dS_out) (dS_out in
// two bf16 terms), then per query tile from the diagonal on A^T = (k q^T)
// gate and dA^T = (v dO^T) gate, gate = exp(cum_t - cum_s) on t >= s, and
// dv += A^T dO, dk += dA^T q (A^T, dA^T in two bf16 terms).  Also
// k_s . dk_s.
__global__ void __launch_bounds__(kTcThreads) ssd_bwd_dkv_tc(Args g) {
  extern __shared__ __align__(16) uint8_t smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + kT * kTcLd;
  bf16* sQ = sV + kT * kTcLd;
  bf16* sDO = sQ + kT * kTcLd;
  bf16* sHi = sDO + kT * kTcLd;
  bf16* sLo = sHi + kT * kTcLd;
  float* sCum = reinterpret_cast<float*>(sLo + kT * kTcLd);

  const int N = g.N, P = g.P, c = g.chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ci = blockIdx.x % g.nc, bh = blockIdx.x / g.nc;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c, j0 = blockIdx.y * kT;
  const int nj = min(kT, c - j0);
  const bf16* Q = static_cast<const bf16*>(g.q) + b * g.qs[0] + h * g.qs[2];
  const bf16* K = static_cast<const bf16*>(g.k) + b * g.ks[0] + h * g.ks[2];
  const bf16* V = static_cast<const bf16*>(g.v) + b * g.vs[0] + h * g.vs[2];
  const bf16* DO = static_cast<const bf16*>(g.dO) + b * g.dos[0] +
                   h * g.dos[2];
  const long long lrow = ((long long)b * g.H + h) * g.L + c0;

  for (int i = tid; i < c; i += kTcThreads) sCum[i] = g.cum[lrow + i];
  load_state_tc(sHi, sLo, g.dS + slot(g, b, h, ci), N, P);
  load_tile_tc(sK, K + (c0 + j0) * g.ks[1], g.ks[1], nj, N);
  load_tile_tc(sV, V + (c0 + j0) * g.vs[1], g.vs[1], nj, P);
  __syncthreads();

  const int r0 = 16 * warp;
  const int rows[2] = {r0 + gq, r0 + gq + 8};       // in the tile
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  // state terms: v_s dS_out^T (rows n: B[k = p][n]) and k_s dS_out (rows
  // k = n: B[k = n][p]), each row then scaled by exp(total - cum_s)
  state_mma(dk, sV, r0, sHi, sLo, true, P, N);
  state_mma(dv, sK, r0, sHi, sLo, false, N, P);
  {
    const float total = sCum[c - 1];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rows[e / 2];
        const float w = r < nj ? expf(total - sCum[j0 + r]) : 0.f;
        dk[j][e] *= w;
        dv[j][e] *= w;
      }
  }
  float qk[8][4], dov[8][4];
  for (int i0 = j0; i0 < c; i0 += kT) {
    const int ni = min(kT, c - i0);
    __syncthreads();
    load_tile_tc(sQ, Q + (c0 + i0) * g.qs[1], g.qs[1], ni, N);
    load_tile_tc(sDO, DO + (c0 + i0) * g.dos[1], g.dos[1], ni, P);
    __syncthreads();
    tile_mma(qk, sK, sQ, r0, N);
    tile_mma(dov, sV, sDO, r0, P);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = rows[e / 2], cc = 8 * j + 2 * tq + (e & 1);
        const float gate = r < nj && cc < ni && j0 + r <= i0 + cc
                               ? expf(sCum[i0 + cc] - sCum[j0 + r])
                               : 0.f;
        qk[j][e] *= gate;
        dov[j][e] *= gate;
      }
    acc_mma(dv, qk, sDO, P);
    acc_mma(dk, dov, sQ, N);
  }
  float rk[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 8 * j + 2 * tq + (e & 1);
      if (n < N)
        rk[e / 2] += __bfloat162float(sK[rows[e / 2] * kTcLd + n]) *
                     dk[j][e];
    }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    rk[hf] += __shfl_xor_sync(0xffffffffu, rk[hf], 1);
    rk[hf] += __shfl_xor_sync(0xffffffffu, rk[hf], 2);
    const int r = rows[hf];
    if (r >= nj) continue;
    const int t = c0 + j0 + r;
    if (tq == 0) g.rk[lrow - c0 + t] = rk[hf];
    const long long row = ((long long)b * g.L + t) * g.H + h;
    bf16* dko = static_cast<bf16*>(g.dk) + row * N;
    bf16* dvo = static_cast<bf16*>(g.dv) + row * P;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int x = 8 * j + 2 * tq + e;
        if (x < N) dko[x] = __float2bfloat16(dk[j][2 * hf + e]);
        if (x < P) dvo[x] = __float2bfloat16(dv[j][2 * hf + e]);
      }
  }
}

// ldmatrix of the A fragment of the 16 x 16 block at (m0, k0) of a matrix
// held transposed in shared memory (rows k, columns m: X[k][m] = A[m][k]).
__device__ __forceinline__ void ld_a_t(uint32_t* a, const bf16* s, int m0,
                                       int k0) {
  const int l = threadIdx.x % 32;
  ldsm4_t(a, s + (k0 + l % 8 + (l / 16) * 8) * kTcLd + m0 + ((l / 8) % 2) * 8);
}

// bf16 chunk states: one CTA of four warps per (batch, head, chunk,
// direction), warp w owning state rows 16 w ..: forward, the chunk's own
// state sum_s (k_s exp(total - cum_s))^T v_s; backward, its own state
// gradient sum_t (q_t exp(cum_t))^T dO_t; each into the chunk's workspace
// slot (ssd_bwd_combine then chains them).  The decayed k or q, float32,
// goes in two bf16 terms.  The forward CTA also stores the chunk's prefix
// sums and total.
__global__ void __launch_bounds__(kTcThreads) ssd_bwd_chunk_states_tc(
    Args g) {
  extern __shared__ __align__(16) uint8_t smem_tc[];
  bf16* sXh = reinterpret_cast<bf16*>(smem_tc);     // kT x kTcLd, rows s
  bf16* sXl = sXh + kT * kTcLd;
  bf16* sY = sXl + kT * kTcLd;
  float* sCum = reinterpret_cast<float*>(sY + kT * kTcLd);
  float* sTot = sCum + kMaxChunk;
  float* sCarry = sTot + kScanSlots;

  const int N = g.N, P = g.P, c = g.chunk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int ci = blockIdx.x % g.nc, bh = blockIdx.x / g.nc;
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c;
  const bool fwd = blockIdx.y == 0;
  const bf16* X = static_cast<const bf16*>(fwd ? g.k : g.q) +
                  b * (fwd ? g.ks[0] : g.qs[0]) +
                  h * (fwd ? g.ks[2] : g.qs[2]);
  const long long xs = fwd ? g.ks[1] : g.qs[1];
  const bf16* Y = static_cast<const bf16*>(fwd ? g.v : g.dO) +
                  b * (fwd ? g.vs[0] : g.dos[0]) +
                  h * (fwd ? g.vs[2] : g.dos[2]);
  const long long ys = fwd ? g.vs[1] : g.dos[1];
  const float* A = g.a + b * g.as[0] + h * g.as[2];

  blocked_cumsum(A + c0 * g.as[1], g.as[1], c, sCum, sTot, sCarry);
  const float total = sCum[c - 1];
  const long long lrow = ((long long)b * g.H + h) * g.L + c0;
  if (fwd) {
    for (int i = tid; i < c; i += kTcThreads) g.cum[lrow + i] = sCum[i];
    if (tid == 0) g.tot[(long long)bh * g.nc + ci] = total;
  }
  const int r0 = 16 * warp;
  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float* sW = sCarry + kScanSlots;                  // kT row weights
  for (int s0 = 0; s0 < c; s0 += kT) {
    const int ns = min(kT, c - s0);
    __syncthreads();
    load_tile_tc(sY, Y + (c0 + s0) * ys, ys, ns, P);
    if (tid < kT)
      sW[tid] = tid < ns ? expf(fwd ? total - sCum[s0 + tid] : sCum[s0 + tid])
                         : 0.f;
    __syncthreads();
    // the decayed rows, 8 entries (16 B) a thread, in two bf16 terms
    for (int e = tid; e < kT * kMaxNP / 8; e += kTcThreads) {
      const int r = e / (kMaxNP / 8), n = (e % (kMaxNP / 8)) * 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (r < ns && n < N)
        raw = *reinterpret_cast<const uint4*>(X + (c0 + s0 + r) * xs + n);
      const __nv_bfloat162* x2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 x = __bfloat1622float2(x2[i]);
        const float x0 = x.x * sW[r], x1 = x.y * sW[r];
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
        hi[i] = *reinterpret_cast<const uint32_t*>(&h2);
        lo[i] = pack(x0 - __low2float(h2), x1 - __high2float(h2));
      }
      *reinterpret_cast<uint4*>(sXh + r * kTcLd + n) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(sXl + r * kTcLd + n) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    __syncthreads();
    if (r0 < N) {
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t ah[4], al[4];
        ld_a_t(ah, sXh, r0, 16 * kk);
        ld_a_t(al, sXl, r0, 16 * kk);
        for (int nd = 0; nd < P / 16; ++nd) {
          uint32_t yb[4];
          ld_b_kn(yb, sY, 16 * kk, 16 * nd);
          mma(acc[2 * nd], ah, yb[0], yb[1]);
          mma(acc[2 * nd + 1], ah, yb[2], yb[3]);
          mma(acc[2 * nd], al, yb[0], yb[1]);
          mma(acc[2 * nd + 1], al, yb[2], yb[3]);
        }
      }
    }
  }
  float* dst = (fwd ? g.S : g.dS) + slot(g, b, h, ci);
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = r0 + gq + 8 * (e / 2), p = 8 * j + 2 * tq + (e & 1);
      if (n < N && p < P) dst[n * P + p] = acc[j][e];
    }
}

// grid (B * H, N * P / 256 rounded up, 2): chains the chunks' own states
// in place, one state entry a thread: forward S_in(c) = exp(total_{c-1})
// S_in(c - 1) + own(c - 1), backward dS_out(c) = exp(total_{c+1})
// dS_out(c + 1) + own(c + 1), in the plain version's order.
__global__ void __launch_bounds__(kThreads) ssd_bwd_combine(Args g) {
  const int b = blockIdx.x / g.H, h = blockIdx.x % g.H;
  const bool fwd = blockIdx.z == 0;
  const long long np = (long long)g.N * g.P;
  const long long e = (long long)blockIdx.y * kThreads + threadIdx.x;
  if (e >= np) return;
  float* base = (fwd ? g.S : g.dS) + slot(g, b, h, 0) + e;
  const float* tot = g.tot + (long long)blockIdx.x * g.nc;
  float run = 0.f;
  // eight chunks' loads in flight before their stores (the compiler may
  // not move a load past a store to the same array)
  constexpr int kBatch = 8;
  for (int s0 = 0; s0 < g.nc; s0 += kBatch) {
    float own[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int step = s0 + i, ci = fwd ? step : g.nc - 1 - step;
      own[i] = step < g.nc ? base[ci * np] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      const int step = s0 + i, ci = fwd ? step : g.nc - 1 - step;
      if (step < g.nc) {
        base[ci * np] = run;
        run = run * expf(tot[ci]) + own[i];
      }
    }
  }
}

size_t states_bytes(int N, int P) {
  return sizeof(float) *
         (kMaxChunk + 2 * kScanSlots + kT + (size_t)kT * (N + 1) +
          (size_t)kT * (P + 1));
}

size_t dq_bytes(int N, int P) {
  return sizeof(float) * (kMaxChunk + 2 * (size_t)kT * (N + 1) +
                          2 * (size_t)kT * (P + 1) + (size_t)kT * kLd +
                          (size_t)N * (P + 1));
}

size_t dkv_bytes(int N, int P) {
  return sizeof(float) * (kMaxChunk + 2 * (size_t)kT * (N + 1) +
                          2 * (size_t)kT * (P + 1) + 2 * (size_t)kT * kLd +
                          (size_t)N * (P + 1));
}

template <typename K>
int launch_one(K kernel, dim3 grid, size_t smem, const Args& g,
               cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}

template <typename K>
int launch_tc(K kernel, dim3 grid, const Args& g, cudaStream_t s,
              size_t smem = kTcBytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTcThreads, smem, s>>>(g);
  return (int)cudaGetLastError();
}

// bf16: the tensor-core kernels (N and P multiples of 16, 16 B aligned
// rows); float32: the CUDA-core kernels.
int launch(const Args& g, cudaStream_t s, bool bf16) {
  const dim3 blocks(g.B * g.H * g.nc, (g.chunk + kT - 1) / kT);
  int err;
  if (bf16) {
    err = launch_tc(ssd_bwd_chunk_states_tc, dim3(g.B * g.H * g.nc, 2), g, s,
                    kTcStatesBytes);
    if (err) return err;
    ssd_bwd_combine<<<dim3(g.B * g.H, (g.N * g.P + kThreads - 1) / kThreads,
                           2),
                      kThreads, 0, s>>>(g);
    err = (int)cudaGetLastError();
    if (err) return err;
    err = launch_tc(ssd_bwd_dq_tc, blocks, g, s);
    if (err) return err;
    err = launch_tc(ssd_bwd_dkv_tc, blocks, g, s);
  } else {
    err = launch_one(ssd_bwd_states, dim3(g.B * g.H, 2),
                     states_bytes(g.N, g.P), g, s);
    if (err) return err;
    err = launch_one(ssd_bwd_dq, blocks, dq_bytes(g.N, g.P), g, s);
    if (err) return err;
    err = launch_one(ssd_bwd_dkv, blocks, dkv_bytes(g.N, g.P), g, s);
  }
  if (err) return err;
  ssd_bwd_da<<<g.B * g.H, kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// bf16 inputs the tensor-core kernels take: N and P multiples of 16, the
// strides multiples of 8 elements and 16 B aligned pointers.
bool tc_ok(const void* const* ptrs, const long long* const* strides, int N,
           int P) {
  if (N % 16 || P % 16) return false;
  for (int i = 0; i < 4; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[i][j] % 8) return false;
  }
  return true;
}

}  // namespace

// The largest N and P, and chunk, the kernel takes.
extern "C" int ssd_scan_bwd_max_np() { return kMaxNP; }
extern "C" int ssd_scan_bwd_max_chunk() { return kMaxChunk; }

// The float32 workspace, in values: two [B, H, nc, N, P] state stacks,
// three [B, H, L] rows and the [B, H, nc] chunk totals.
extern "C" long long ssd_scan_bwd_ws_floats(int B, int L, int H, int N,
                                            int P, int chunk) {
  const long long bh = (long long)B * H;
  return 2 * bh * (L / chunk) * N * P + 3 * bh * L + bh * (L / chunk);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dO, dq, dk, dv; a and da are
// float32).  Strides in elements, three per input (batch, sequence, head),
// in the order q, k, v, dO, a; dq, dk, dv and da are new contiguous
// tensors; ws holds ssd_scan_bwd_ws_floats values.  bf16 needs N and P
// multiples of 16, strides multiples of 8 and 16 B aligned pointers.
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for inputs the kernel does not take).
extern "C" int ssd_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* a, void* dq, void* dk, void* dv, float* da, float* ws,
    int dtype, int B, int L, int H, int N, int P, int chunk,
    const long long* qs, const long long* ks, const long long* vs,
    const long long* dos, const long long* as, void* stream) {
  if (N < 1 || P < 1 || N > kMaxNP || P > kMaxNP || chunk < 1 ||
      chunk > kMaxChunk || L % chunk || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  Args g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.dO = dO;
  g.a = a;
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  g.da = da;
  g.B = B;
  g.L = L;
  g.H = H;
  g.N = N;
  g.P = P;
  g.chunk = chunk;
  g.nc = L / chunk;
  const long long bh = (long long)B * H;
  g.S = ws;
  g.dS = ws + bh * g.nc * N * P;
  g.cum = g.dS + bh * g.nc * N * P;
  g.rq = g.cum + bh * L;
  g.rk = g.rq + bh * L;
  g.tot = g.rk + bh * L;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = qs[i];
    g.ks[i] = ks[i];
    g.vs[i] = vs[i];
    g.dos[i] = dos[i];
    g.as[i] = as[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(g, s, false);
  const void* ptrs[4] = {q, k, v, dO};
  const long long* strides[4] = {qs, ks, vs, dos};
  if (!tc_ok(ptrs, strides, N, P)) return (int)cudaErrorInvalidValue;
  return launch(g, s, true);
}
