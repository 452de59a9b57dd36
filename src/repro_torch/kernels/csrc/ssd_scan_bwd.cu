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
// float32 (the parity path): four kernels in order on the stream, with a
// float32 workspace, on the CUDA cores:
//  * ssd_bwd_states: each chunk's S_in (and its prefix sums) and dS_out,
//    one block per (batch, head, direction) walking the chunks in order
//    (backward: in reverse), the [N, P] state in registers.
//  * ssd_bwd_dq: one block per (batch, head, chunk, 64 rows): the inter
//    term from S_in, then per 64-row kv tile up to the diagonal the gated
//    dO v^T times k.  Also q_t . dq_t.
//  * ssd_bwd_dkv: one block per (batch, head, chunk, 64 rows): the state
//    terms from dS_out, then per 64-row query tile from the diagonal on
//    the gated q k^T and dO v^T, transposed into dv and dk.  Also
//    k_s . dk_s.  (Both: float32 FMAs out of shared memory, each thread a
//    4 x 4 micro-tile of a 64 x 64 score tile or N / 4 (P / 4) columns.)
//  * ssd_bwd_da: one block per (batch, head): the reverse sums.
//
// bf16 (the training path; N and P multiples of 16 and rows that allow
// TMA, else the call is refused): three launches, Hopper's tensor cores
// through wgmma (bf16 in, float32 sums) on 64-row tiles that TMA brings
// through shared-memory rings (full / empty mbarriers, a producer warp or
// warpgroup, consumer warpgroups):
//  * ssd_bwd_states_wgmma: one CTA per (direction, batch, head, chunk)
//    forms the chunk's own state (forward, k^T v with k decayed) or state
//    gradient (backward, q^T dO with q decayed) from X^T in registers
//    (ldmatrix of the transposed tile, weighted, split), then takes its
//    place in the chain with ssd_scan.cu's release-flag hand-off (tickets
//    in launch order, step slowest; backward in reverse): it waits for the
//    state the step before published, publishes exp(total) prev + own in
//    the plain version's order, then stores it again as the fused
//    kernel's operand: bf16 hi / lo tiles in the 128B-swizzled layout.
//    The forward CTAs also store their chunk's prefix sums.
//  * ssd_bwd_fused_wgmma: dq, dk and dv of a chunk in one CTA (a
//    persistent grid walking the (batch, head, chunk) items; below).  Also
//    the row dots q_t . dq_t and k_s . dk_s.
//  * ssd_bwd_da: the reverse sums, as for float32.
// Products of bf16 inputs (q k^T, dO v^T, and those against k, q, dO) are
// exact; the float32-held operands (the gated scores, S_in, dS_out, the
// decayed k and q of the states) keep two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), about 16 bits: rounding them once loses the plain
// version's 2e-2 on slow decays (ssd_scan.cu's note), and with wgmma a
// register-A split is one more wgmma and no more loads.  The gate is
// ex2((cum_t - cum_s) log2 e), the difference taken first as the plain
// version takes it.  The fused kernel forms q k^T once (as G_qk^T, kv
// rows) and dO v^T twice, once per orientation: G_do^T with kv rows for
// dk, and G_do with query rows for dq, since handing the transposed tile
// from one warpgroup to the other would take a shared-memory round trip
// and a cross-warpgroup hand-off a tile; that is one product in nine.
// dq and dk stay per head.  No atomics: every output element is written
// once by one thread, and the chain runs in a fixed order: the same bits
// on every run.
//
// Bound on an H100 at the training shape (zamba2-2.7b's Mamba-2: B = 4,
// L = 1024, 80 heads, N = P = 64, chunk 256, bf16, q and k broadcast):
// about 4e10 FLOP of in-chunk and state products (41 us at 989 TFLOP/s
// bf16), and q, k (broadcast), v, dO and a read and their gradients
// written once, about 131 MB (39 us at 3.35 TB/s): bound by operations.
// What holds the fused kernel from it now is its per-element work (the
// gates and the hi / lo splits of two 64 x 64 tiles a step, on two
// consumer warpgroups an SM; hence one ex2 a gate, shared by the two
// tiles it scales) and the wait that ends each wgmma group;
// scripts/bwd_kernel_ablation.py times the kernel with parts taken out
// (PERF.md has the numbers).  It takes N, P <= 64 and chunks <= 256 rows.
#include "hopper.cuh"

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

// float32: the CUDA-core kernels.
int launch(const Args& g, cudaStream_t s) {
  const dim3 blocks(g.B * g.H * g.nc, (g.chunk + kT - 1) / kT);
  int err = launch_one(ssd_bwd_states, dim3(g.B * g.H, 2),
                       states_bytes(g.N, g.P), g, s);
  if (err) return err;
  err = launch_one(ssd_bwd_dq, blocks, dq_bytes(g.N, g.P), g, s);
  if (err) return err;
  err = launch_one(ssd_bwd_dkv, blocks, dkv_bytes(g.N, g.P), g, s);
  if (err) return err;
  ssd_bwd_da<<<g.B * g.H, kThreads, 0, s>>>(g);
  return (int)cudaGetLastError();
}

// ------------------------- bf16: Hopper tensor cores -----------------------

typedef __nv_bfloat16 bf16;
constexpr int kRows = 64;                   // rows of a tile
constexpr int kTileBytes = kRows * 128;     // 64 x 64 bf16, one 128B box
constexpr int kStStages = 2;                // states: ring depth
constexpr int kStThreads = 160;             // states: warpgroup + producer
constexpr int kFStages = 6;                 // fused: ring depth
constexpr int kFThreads = 384;              // fused: producer + two groups
constexpr int kFTiles = 4;                  // fused: q, k, v, dO a stage

struct TcArgs {
  const float* a;
  long long as[3];                   // batch, sequence, head
  bf16* dq;                          // [B, L, H, N], per head
  bf16* dk;                          // [B, L, H, N], per head
  bf16* dv;                          // [B, L, H, P]
  float* S;                          // [B, H, nc, N, P]: S_in of each chunk
  float* dS;                         // [B, H, nc, N, P]: dS_out of each
  float* rq;                         // [B, H, L]: q_t . dq_t
  float* rk;                         // [B, H, L]: k_t . dk_t
  float* cum;                        // [B, H, L]: in-chunk prefix sums
  uint8_t* tiles;                    // [2, B, H, nc, 2] 8 KB tile images:
                                     // S_in, dS_out as bf16 hi, lo
  int* sync;                         // ticket, then [2, B, H, nc] flags
  int B, L, H, N, P, chunk, nc;
  int hm[4], bm[4];                  // q, k, v, dO: 0 where the map is
                                     // broadcast (head, batch coordinate 0)
};

// acc[32] (+)= X Y^T, 64 x 64 over 64 columns: X and Y 64-row tiles, both
// read K-major; `add` = false overwrites acc.
__device__ __forceinline__ void mm_nt(float* acc, uint32_t x, uint32_t y,
                                      bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<64>::ss<0>(acc, desc128(x + 32 * kk, 16, 1024),
                     desc128(y + 32 * kk, 16, 1024), add || kk > 0);
}

// acc[32] (+)= X Y: X read K-major, Y (rows the reduced index) MN-major.
__device__ __forceinline__ void mm_nn(float* acc, uint32_t x, uint32_t y,
                                      bool add) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<64>::ss<1>(acc, desc128(x + 32 * kk, 16, 1024),
                     desc128(y + 2048 * kk, kTileBytes, 1024), add || kk > 0);
}

// acc[32] += F Y: F the register A fragments of a 64 x 64 tile, Y MN-major.
__device__ __forceinline__ void mm_rn(float* acc, const uint32_t* f,
                                      uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<64>::rs(acc, f + 4 * kk, desc128(y + 2048 * kk, kTileBytes, 1024));
}

// The states entering and leaving the chunks, one launch: one CTA of a
// consumer warpgroup and a producer warp per (direction, batch, head,
// chunk).  Forward: the chunk's own state X^T Y with X = k exp(total -
// cum), Y = v; backward: its own state gradient with X = q exp(cum),
// Y = dO.  X and Y come in 64-row tiles by TMA through a two-stage ring;
// the warpgroup forms X^T in registers from the transposed tile (ldmatrix),
// weights each row, splits it in two bf16 terms (hi, lo) and runs
// own += X^T Y on wgmma (A from registers, Y MN-major).  Then the hand-off
// of ssd_scan.cu: CTAs take tickets in launch order, step slowest (step t
// of a direction is chunk t forward, nc - 1 - t backward), so the CTA of
// the step before has started; it waits for that CTA's release flag,
// reads the state it published and publishes exp(total) prev + own for
// the next step, in the plain version's order.
__global__ void __launch_bounds__(kStThreads)
ssd_bwd_states_wgmma(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     const __grid_constant__ CUtensorMap tdo, TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sX = base;                                  // kStStages tiles
  uint8_t* sY = sX + kStStages * kTileBytes;           // kStStages tiles
  float* sCum = reinterpret_cast<float*>(sY + kStStages * kTileBytes);
  float* sW = sCum + kMaxChunk;                        // row weights
  float* sTot = sW + kMaxChunk;
  float* sCarry = sTot + kScanSlots;
  uint64_t* bars = reinterpret_cast<uint64_t*>(sCarry + kScanSlots);
  int* sTicket = reinterpret_cast<int*>(bars + 2 * kStStages);
  const uint32_t bar_full = smem_u32(bars);                   // + 8 s
  const uint32_t bar_empty = smem_u32(bars + kStStages);      // + 8 s

  const int tid = threadIdx.x;
  if (tid == 0) {
    *sTicket = atomicAdd(g.sync, 1);
    for (int s = 0; s < kStStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    mbar_init_fence();
  }
  __syncthreads();
  const int ticket = *sTicket;
  const int BH = g.B * g.H;
  const int step = ticket / (2 * BH), rest = ticket % (2 * BH);
  const bool fwd = rest < BH;
  const int bh = rest % BH, b = bh / g.H, h = bh % g.H;
  const int ci = fwd ? step : g.nc - 1 - step;
  const int c = g.chunk, c0 = ci * c;
  const int nt = (c + kRows - 1) / kRows;

  if (tid >= 128) {                      // producer warp
    if (tid == 128) {
      const CUtensorMap* mx = fwd ? &tk : &tq;
      const CUtensorMap* my = fwd ? &tv : &tdo;
      const int ix = fwd ? 1 : 0, iy = fwd ? 2 : 3;
      for (int r = 0; r < nt; ++r) {
        const int s = r % kStStages;
        if (r >= kStStages)
          mbar_wait(bar_empty + 8 * s, (r / kStStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kTileBytes);
        tma_load(smem_u32(sX + s * kTileBytes), mx, bar_full + 8 * s, 0,
                 c0 + r * kRows, h * g.hm[ix], b * g.bm[ix]);
        tma_load(smem_u32(sY + s * kTileBytes), my, bar_full + 8 * s, 0,
                 c0 + r * kRows, h * g.hm[iy], b * g.bm[iy]);
      }
    }
    return;
  }
  // the consumer warpgroup
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
  chunk_cumsum(g.a + b * g.as[0] + h * g.as[2] + c0 * g.as[1], g.as[1], c,
               sCum, sTot, sCarry, tid, 128, 1);
  const float total = sCum[c - 1];
  for (int i = tid; i < nt * kRows; i += 128)
    sW[i] = i < c ? expf(fwd ? total - sCum[i] : sCum[i]) : 0.f;
  if (fwd)
    for (int i = tid; i < c; i += 128)
      g.cum[(long long)bh * g.L + c0 + i] = sCum[i];
  named_sync(1, 128);

  float own[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) own[i] = 0.f;
  for (int r = 0; r < nt; ++r) {
    const int s = r % kStStages;
    mbar_wait(bar_full + 8 * s, (r / kStStages) & 1);
    const uint32_t x_addr = smem_u32(sX + s * kTileBytes);
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A[m = n][k = row]: rows 16 kk .. of the tile, state rows 16 warp ..
      const int row = 16 * kk + lane % 8 + (lane / 16) * 8;
      const int col = 16 * warp + ((lane / 8) % 2) * 8;
      uint32_t x[4];
      ldsm4_t(x, x_addr + swz(row, col, kTileBytes));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // x[i]: rows (k) 16 kk + 2 t4 (+ 8 for i >= 2), + 1
        const int k = r * kRows + 16 * kk + 2 * t4 + (i / 2) * 8;
        const float2 xf =
            __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x[i]));
        split2(xf.x * sW[k], xf.y * sW[k + 1], hi[4 * kk + i], lo[4 * kk + i]);
      }
    }
    const uint32_t y_addr = smem_u32(sY + s * kTileBytes);
    fence_regs<32>(own);
    wg_fence();
    mm_rn(own, hi, y_addr);
    mm_rn(own, lo, y_addr);
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(own);
    fence_u32<16>(hi);
    fence_u32<16>(lo);
    mbar_arrive(bar_empty + 8 * s);
  }

  // the hand-off: prev from the step before, exp(total) prev + own on
  const int N = g.N, P = g.P;
  const long long np = (long long)N * P;
  float* states = fwd ? g.S : g.dS;
  int* flags = g.sync + 1 + (fwd ? 0 : (long long)BH * g.nc) +
               (long long)bh * g.nc;
  const long long slot0 = (long long)bh * g.nc;
  const bool has_next = fwd ? ci + 1 < g.nc : ci > 0;
  const int next = fwd ? ci + 1 : ci - 1;
  if (step > 0) {
    if (tid == 0) {
      // seconds of polling mean a broken chain: fail rather than hang
      for (int spins = 0; ld_acquire(flags + ci) == 0;)
        if (++spins > (1 << 22)) __trap();
    }
    named_sync(1, 128);
    const float decay = expf(total);
    const float* prev = states + (slot0 + ci) * np;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * warp + gq + 8 * hf, p = 8 * j + 2 * t4;
        if (n < N && p < P) {
          const float2 x =
              __ldcg(reinterpret_cast<const float2*>(prev + n * P + p));
          own[4 * j + 2 * hf] = fmaf(x.x, decay, own[4 * j + 2 * hf]);
          own[4 * j + 2 * hf + 1] = fmaf(x.y, decay, own[4 * j + 2 * hf + 1]);
        }
      }
  }
  if (has_next) {
    float* dst = states + (slot0 + next) * np;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * warp + gq + 8 * hf, p = 8 * j + 2 * t4;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(dst + n * P + p) =
              make_float2(own[4 * j + 2 * hf], own[4 * j + 2 * hf + 1]);
      }
    __threadfence();
    named_sync(1, 128);
    if (tid == 0) st_release(flags + next, 1);
    // the same state as the fused kernel's B operand: bf16 hi and lo in
    // the 128B-swizzled tile layout (zeros past N and P), loaded as is
    uint8_t* hi = g.tiles + ((((fwd ? 0 : 1) * (long long)BH + bh) * g.nc +
                              next) * 2) * kTileBytes;
    uint8_t* lo = hi + kTileBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * warp + gq + 8 * hf, p = 8 * j + 2 * t4;
        const bool in = n < N && p < P;
        uint32_t h, l;
        split2(in ? own[4 * j + 2 * hf] : 0.f,
               in ? own[4 * j + 2 * hf + 1] : 0.f, h, l);
        const uint32_t off = swz(n, p, kTileBytes);
        *reinterpret_cast<uint32_t*>(hi + off) = h;
        *reinterpret_cast<uint32_t*>(lo + off) = l;
      }
  }
}

// x[32] (and y[32] with NY = 2), 64 x 64 accumulator tiles, times the
// gate exp(cum_t - cum_s) on s <= t < c: rows at r_base + ra (+ 8) with
// prefix sums rc, columns at c_base; T_COL: the columns are the query
// positions t.  EDGE: the tile crosses the diagonal or the chunk's end and
// is masked element by element (0 off the triangle); else all of it is
// kept.  The gate is ex2 of the difference times log2(e): one MUFU.EX2.
template <bool T_COL, bool EDGE, int NY>
__device__ __forceinline__ void gate_tile(float* x, float* y,
                                          const float* cum, int c,
                                          int r_base, int c_base,
                                          const float* rc, int ra, int t4) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cp0 = c_base + 8 * j + 2 * t4;
    const float cc[2] = {__ldg(cum + min(cp0, c - 1)),
                         __ldg(cum + min(cp0 + 1, c - 1))};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float d = T_COL ? cc[e & 1] - rc[e / 2] : rc[e / 2] - cc[e & 1];
      const float gv = ex2(d * kLog2e);
      bool ok = true;
      if (EDGE) {
        const int rp = r_base + ra + 8 * (e / 2), cp = cp0 + (e & 1);
        const int t = T_COL ? cp : rp, s = T_COL ? rp : cp;
        ok = s <= t && t < c;
      }
      // masked: 0 by a select (above the diagonal gv may be inf)
      x[4 * j + e] = ok ? x[4 * j + e] * gv : 0.f;
      if (NY == 2) y[4 * j + e] = ok ? y[4 * j + e] * gv : 0.f;
    }
  }
}

// The dot of each of this thread's two accumulator rows (ra, ra + 8) with
// the same rows of a bf16 tile in shared memory, over the quad.
__device__ __forceinline__ void row_dot(const uint8_t* t, const float* acc,
                                        int ra, int t4, float* out) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float d = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 v = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              t + swz(ra + 8 * hf, 8 * j + 2 * t4, kTileBytes)));
      d = fmaf(v.x, acc[4 * j + 2 * hf], d);
      d = fmaf(v.y, acc[4 * j + 2 * hf + 1], d);
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    out[hf] = d + __shfl_xor_sync(0xffffffffu, d, 2);
  }
}

// The gradient rows ra, ra + 8 of a tile (positions r0 + ra .. of the
// chunk at c0, rows past c not written) as bf16 pairs, w columns.
__device__ __forceinline__ void store_tile_rows(bf16* out, const float* acc,
                                                const TcArgs& g, int b, int h,
                                                int c0, int r0, int c, int w,
                                                int ra, int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = r0 + ra + 8 * hf;
    if (t >= c) continue;
    const long long row = ((long long)b * g.L + c0 + t) * g.H + h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int x = 8 * j + 2 * t4;
      if (x < w)
        *reinterpret_cast<__nv_bfloat162*>(out + row * w + x) =
            __floats2bfloat162_rn(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
}

// dq, dk, dv in one launch: a persistent grid, one CTA of 384 threads an
// SM, walking the (batch, head, chunk) items.  Warpgroup 0 is the
// producer: one thread loads each chunk's q, k, v and dO in 64-row tiles
// by TMA through a six-stage ring (a stage holds the four tensors' tiles
// of 64 rows, so the next chunk's first tiles load while this one
// computes), and S_in's and dS_out's bf16 hi / lo tiles as the states
// launch left them (bulk copies into a buffer of their own, released
// after each chunk).  Warpgroups 1 and 2 take the chunk's 64-row tiles
// {0, 3} and {1, 2} (equal causal work) and run each on its own, waiting
// for a tile only when it first needs it:
//  * tile i as query rows t: per kv tile j <= i, G_do = (dO_i v_j^T) gate
//    (gate = exp(cum_t - cum_s) on s <= t) as the A operand of
//    dq += G_do k_j, then exp(cum_t) dO_i S_in^T; then q_t . dq_t.
//  * tile j as kv rows s: per query tile i >= j, G_qk^T = (k_j q_i^T) gate
//    and G_do^T = (v_j dO_i^T) gate as the A operands of dv += G_qk^T dO_i
//    and dk += G_do^T q_i, then exp(total - cum_s) (v_j dS_out^T,
//    k_j dS_out); then k_s . dk_s.
// Each step issues the next score tiles together with the current
// gradient products (one wgmma group, then one wait), so the gates and
// splits of one step overlap the tensor cores' work of the other
// warpgroup.  The gated scores are split in registers into two bf16 terms
// (hi, lo), each a register A operand: two wgmmas, no more loads.
__global__ void __launch_bounds__(kFThreads, 1)
ssd_bwd_fused_wgmma(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo, TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = base;                        // kFStages x (q, k, v, dO)
  uint8_t* sSt = ring + kFStages * kFTiles * kTileBytes;   // S hi, lo,
                                                           // dS hi, lo
  uint64_t* bars = reinterpret_cast<uint64_t*>(sSt + 4 * kTileBytes);
  const uint32_t bar_full = smem_u32(bars);                   // + 8 s
  const uint32_t bar_empty = smem_u32(bars + kFStages);       // + 8 s
  const uint32_t bar_st_full = smem_u32(bars + 2 * kFStages);
  const uint32_t bar_st_empty = bar_st_full + 8;

  const int tid = threadIdx.x;
  const int c = g.chunk, nt = (c + kRows - 1) / kRows;
  const int n_items = g.B * g.H * g.nc;
  if (tid == 0) {
    for (int s = 0; s < kFStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_st_full, 1);
    mbar_init(bar_st_empty, 2 * 128);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      const CUtensorMap* maps[kFTiles] = {&tq, &tk, &tv, &tdo};
      int cnt = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int ci = item % g.nc, bh = item / g.nc;
        const int b = bh / g.H, h = bh % g.H;
        for (int r = 0; r < nt; ++r, ++cnt) {
          const int s = cnt % kFStages;
          if (cnt >= kFStages)
            mbar_wait(bar_empty + 8 * s, (cnt / kFStages - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, kFTiles * kTileBytes);
          for (int x = 0; x < kFTiles; ++x)
            tma_load(smem_u32(ring + (s * kFTiles + x) * kTileBytes), maps[x],
                     bar_full + 8 * s, 0, ci * c + r * kRows, h * g.hm[x],
                     b * g.bm[x]);
        }
        if (it > 0) mbar_wait(bar_st_empty, (it - 1) & 1);
        const bool has_in = ci > 0, has_out = ci + 1 < g.nc;
        mbar_expect_tx(bar_st_full, (has_in + has_out) * 2 * kTileBytes);
        for (int d = 0; d < 2; ++d) {
          if (!(d ? has_out : has_in)) continue;
          const uint8_t* src = g.tiles + (((d * (long long)g.B * g.H + bh) *
                                           g.nc + ci) * 2) * kTileBytes;
          bulk_load(smem_u32(sSt + 2 * d * kTileBytes), src, 2 * kTileBytes,
                    bar_st_full);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int ctid = tid - 128, cw = ctid / 128;
  const int warp = (ctid % 128) / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int ra = 16 * warp + gq;         // rows ra, ra + 8 of a tile
  const int N = g.N, P = g.P;
  const uint32_t s_hi = smem_u32(sSt), s_lo = s_hi + kTileBytes;
  const uint32_t d_hi = s_hi + 2 * kTileBytes, d_lo = s_hi + 3 * kTileBytes;
  int cnt = 0, it = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
    const int ci = item % g.nc, bh = item / g.nc;
    const int b = bh / g.H, h = bh % g.H;
    const int c0 = ci * c;
    const bool has_in = ci > 0, has_out = ci + 1 < g.nc;
    const float* cum = g.cum + (long long)bh * g.L + c0;
    const float total = __ldg(cum + c - 1);
    auto need = [&](int r) {                 // tile r has arrived
      const int u = cnt + r;
      mbar_wait(bar_full + 8 * (u % kFStages), (u / kFStages) & 1);
    };
    auto tile_ptr = [&](int r, int x) {      // x: 0 q, 1 k, 2 v, 3 dO
      return ring + (((cnt + r) % kFStages) * kFTiles + x) * kTileBytes;
    };
    auto tile = [&](int r, int x) { return smem_u32(tile_ptr(r, x)); };
    for (int r = 0; r < nt; ++r) {
      if ((r == 0 || r == 3 ? 0 : 1) != cw) continue;
      const int r0 = r * kRows;
      const float rc[2] = {__ldg(cum + min(r0 + ra, c - 1)),
                           __ldg(cum + min(r0 + ra + 8, c - 1))};
      // ---- tile r as query rows t: dq ----
      {
        float dq[32], sd[32];
        uint32_t gh[16], gl[16];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        need(r);
        need(0);
        wg_fence();
        mm_nt(sd, tile(r, 3), tile(0, 2), false);       // dO_i v_0^T
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(sd);
        if (r == 0 || r0 + kRows > c)
          gate_tile<false, true, 1>(sd, sd, cum, c, r0, 0, rc, ra, t4);
        else
          gate_tile<false, false, 1>(sd, sd, cum, c, r0, 0, rc, ra, t4);
        split_a<32>(sd, gh, gl);
        for (int j2 = 1; j2 <= r; ++j2) {
          // the scores of kv tile j2 with dq += G k of tile j2 - 1
          need(j2);
          fence_regs<32>(dq);
          wg_fence();
          mm_nt(sd, tile(r, 3), tile(j2, 2), false);
          mm_rn(dq, gh, tile(j2 - 1, 1));
          mm_rn(dq, gl, tile(j2 - 1, 1));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dq);
          fence_regs<32>(sd);
          fence_u32<16>(gh);
          fence_u32<16>(gl);
          if (j2 == r || r0 + kRows > c)
            gate_tile<false, true, 1>(sd, sd, cum, c, r0, j2 * kRows, rc, ra,
                                      t4);
          else
            gate_tile<false, false, 1>(sd, sd, cum, c, r0, j2 * kRows, rc,
                                       ra, t4);
          split_a<32>(sd, gh, gl);
        }
        if (has_in) {      // the last G k with exp(cum_t) dO_t S_in^T
          mbar_wait(bar_st_full, it & 1);
          fence_regs<32>(dq);
          wg_fence();
          mm_nt(sd, tile(r, 3), s_hi, false);
          mm_nt(sd, tile(r, 3), s_lo, true);
          mm_rn(dq, gh, tile(r, 1));
          mm_rn(dq, gl, tile(r, 1));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dq);
          fence_regs<32>(sd);
          fence_u32<16>(gh);
          fence_u32<16>(gl);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float w = r0 + ra + 8 * hf < c ? expf(rc[hf]) : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * hf + e;
                dq[x] = fmaf(w, sd[x], dq[x]);
              }
          }
        } else {
          fence_regs<32>(dq);
          wg_fence();
          mm_rn(dq, gh, tile(r, 1));
          mm_rn(dq, gl, tile(r, 1));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dq);
          fence_u32<16>(gh);
          fence_u32<16>(gl);
        }
        float rq[2];
        row_dot(tile_ptr(r, 0), dq, ra, t4, rq);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (t4 == 0 && r0 + ra + 8 * hf < c)
            g.rq[(long long)bh * g.L + c0 + r0 + ra + 8 * hf] = rq[hf];
        store_tile_rows(g.dq, dq, g, b, h, c0, r0, c, N, ra, t4);
      }
      // ---- tile r as kv rows s: dk, dv ----
      {
        float dk[32], dv[32], sq[32], sd[32];
        uint32_t qh[16], ql[16], dh[16], dl[16];
#pragma unroll
        for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;
        wg_fence();
        mm_nt(sq, tile(r, 1), tile(r, 0), false);       // k_j q_j^T
        mm_nt(sd, tile(r, 2), tile(r, 3), false);       // v_j dO_j^T
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(sq);
        fence_regs<32>(sd);
        gate_tile<true, true, 2>(sq, sd, cum, c, r0, r0, rc, ra, t4);
        split_a<32>(sq, qh, ql);
        split_a<32>(sd, dh, dl);
        for (int i = r + 1; i < nt; ++i) {
          // the scores of query tile i with the products of tile i - 1
          need(i);
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          wg_fence();
          mm_nt(sq, tile(r, 1), tile(i, 0), false);
          mm_nt(sd, tile(r, 2), tile(i, 3), false);
          mm_rn(dv, qh, tile(i - 1, 3));                // G_qk^T dO_i
          mm_rn(dv, ql, tile(i - 1, 3));
          mm_rn(dk, dh, tile(i - 1, 0));                // G_do^T q_i
          mm_rn(dk, dl, tile(i - 1, 0));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          fence_regs<32>(sq);
          fence_regs<32>(sd);
          fence_u32<16>(qh);
          fence_u32<16>(ql);
          fence_u32<16>(dh);
          fence_u32<16>(dl);
          if ((i + 1) * kRows > c)
            gate_tile<true, true, 2>(sq, sd, cum, c, r0, i * kRows, rc, ra,
                                     t4);
          else
            gate_tile<true, false, 2>(sq, sd, cum, c, r0, i * kRows, rc, ra,
                                      t4);
          split_a<32>(sq, qh, ql);
          split_a<32>(sd, dh, dl);
        }
        const int last = nt - 1;
        if (has_out) {     // the last products with the state terms
          mbar_wait(bar_st_full, it & 1);
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          wg_fence();
          mm_nt(sq, tile(r, 2), d_hi, false);           // v_s dS_out^T
          mm_nt(sq, tile(r, 2), d_lo, true);
          mm_nn(sd, tile(r, 1), d_hi, false);           // k_s dS_out
          mm_nn(sd, tile(r, 1), d_lo, true);
          mm_rn(dv, qh, tile(last, 3));
          mm_rn(dv, ql, tile(last, 3));
          mm_rn(dk, dh, tile(last, 0));
          mm_rn(dk, dl, tile(last, 0));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          fence_regs<32>(sq);
          fence_regs<32>(sd);
          fence_u32<16>(qh);
          fence_u32<16>(ql);
          fence_u32<16>(dh);
          fence_u32<16>(dl);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float w =
                r0 + ra + 8 * hf < c ? expf(total - rc[hf]) : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int x = 4 * j + 2 * hf + e;
                dk[x] = fmaf(w, sq[x], dk[x]);
                dv[x] = fmaf(w, sd[x], dv[x]);
              }
          }
        } else {
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          wg_fence();
          mm_rn(dv, qh, tile(last, 3));
          mm_rn(dv, ql, tile(last, 3));
          mm_rn(dk, dh, tile(last, 0));
          mm_rn(dk, dl, tile(last, 0));
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(dk);
          fence_regs<32>(dv);
          fence_u32<16>(qh);
          fence_u32<16>(ql);
          fence_u32<16>(dh);
          fence_u32<16>(dl);
        }
        float rk[2];
        row_dot(tile_ptr(r, 1), dk, ra, t4, rk);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          if (t4 == 0 && r0 + ra + 8 * hf < c)
            g.rk[(long long)bh * g.L + c0 + r0 + ra + 8 * hf] = rk[hf];
        store_tile_rows(g.dk, dk, g, b, h, c0, r0, c, N, ra, t4);
        store_tile_rows(g.dv, dv, g, b, h, c0, r0, c, P, ra, t4);
      }
    }
    // release the chunk's stages and states: every thread waits for each
    // phase it arrives on, so no arrival runs ahead of the producer
    for (int r = 0; r < nt; ++r) {
      need(r);
      mbar_arrive(bar_empty + 8 * ((cnt + r) % kFStages));
    }
    mbar_wait(bar_st_full, it & 1);
    mbar_arrive(bar_st_empty);
    cnt += nt;
  }
}

constexpr int kStSmem = 1024 + 2 * kStStages * kTileBytes +
                        (2 * kMaxChunk + 2 * kScanSlots) * 4 +
                        8 * 2 * kStStages + 16;
constexpr int kFSmem = 1024 + (kFStages * kFTiles + 4) * kTileBytes +
                       8 * (2 * kFStages + 2);

// bf16: states, then dq / dk / dv, then da: three launches.
int launch_bf16(const Args& a, uint8_t* tiles, int* sync, cudaStream_t s) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoTensorMap;
  TcArgs g;
  const void* ptrs[4] = {a.q, a.k, a.v, a.dO};
  const long long* st[4] = {a.qs, a.ks, a.vs, a.dos};
  const int cols[4] = {a.N, a.N, a.P, a.P};
  CUtensorMap maps[4];
  for (int x = 0; x < 4; ++x) {
    // the maps take (batch, head, row) strides; the arguments are (batch,
    // sequence, head)
    const long long bhr[3] = {st[x][0], st[x][2], st[x][1]};
    if (!tensor_map(enc, &maps[x], ptrs[x], cols[x], a.L, a.H, a.B, bhr,
                    kRows, true))
      return kErrNoTensorMap;
    g.hm[x] = bhr[1] ? 1 : 0;
    g.bm[x] = bhr[0] ? 1 : 0;
  }
  g.a = a.a;
  for (int i = 0; i < 3; ++i) g.as[i] = a.as[i];
  g.dq = static_cast<bf16*>(a.dq);
  g.dk = static_cast<bf16*>(a.dk);
  g.dv = static_cast<bf16*>(a.dv);
  g.S = a.S;
  g.dS = a.dS;
  g.rq = a.rq;
  g.rk = a.rk;
  g.cum = a.cum;
  g.tiles = tiles;
  g.sync = sync;
  g.B = a.B;
  g.L = a.L;
  g.H = a.H;
  g.N = a.N;
  g.P = a.P;
  g.chunk = a.chunk;
  g.nc = a.nc;
  // once per device: the kernels' shared memory and the SM count
  constexpr int kDevices = 64;
  static int sms_of[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0) {
    int n = 0;
    if ((err = cudaFuncSetAttribute(
             ssd_bwd_states_wgmma,
             cudaFuncAttributeMaxDynamicSharedMemorySize, kStSmem)) ||
        (err = cudaFuncSetAttribute(
             ssd_bwd_fused_wgmma,
             cudaFuncAttributeMaxDynamicSharedMemorySize, kFSmem)) ||
        (err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount,
                                      dev)))
      return (int)err;
    sms = n;
  }
  ssd_bwd_states_wgmma<<<2 * a.B * a.H * a.nc, kStThreads, kStSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int items = a.B * a.H * a.nc;
  ssd_bwd_fused_wgmma<<<min(items, sms), kFThreads, kFSmem, s>>>(
      maps[0], maps[1], maps[2], maps[3], g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_da<<<a.B * a.H, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

// bf16 inputs the tensor-core kernels take: N and P multiples of 16, the
// strides multiples of 8 elements and 16 B aligned pointers (TMA).
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

// The float32 workspace, in values: bf16 (dtype 1) first the states' bf16
// hi / lo tile images ([2, B, H, nc, 2] tiles of 8 KB); then two [B, H,
// nc, N, P] state stacks, three [B, H, L] rows and the [B, H, nc] chunk
// totals.
extern "C" long long ssd_scan_bwd_ws_floats(int B, int L, int H, int N,
                                            int P, int chunk, int dtype) {
  const long long bh = (long long)B * H, nc = L / chunk;
  const long long tiles = dtype == 1 ? 2 * bh * nc * 2 * kTileBytes / 4 : 0;
  return tiles + 2 * bh * nc * N * P + 3 * bh * L + bh * nc;
}

// The zeroed int32 values bf16 takes (a ticket counter and the states'
// ready flags; float32 takes none).
extern "C" long long ssd_scan_bwd_sync_ints(int B, int L, int H, int chunk) {
  return 1 + 2 * (long long)B * H * (L / chunk);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dO, dq, dk, dv; a and da are
// float32).  Strides in elements, three per input (batch, sequence, head),
// in the order q, k, v, dO, a; dq, dk, dv and da are new contiguous
// tensors; ws holds ssd_scan_bwd_ws_floats values (16 B aligned); sync
// (bf16 only) holds ssd_scan_bwd_sync_ints zeros.  bf16 needs N and P
// multiples of 16, strides multiples of 8 and 16 B aligned pointers.
// Launches on `stream` and returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for
// inputs the kernel does not take; 10000 when the TMA maps cannot be made).
extern "C" int ssd_scan_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* a, void* dq, void* dk, void* dv, float* da, float* ws,
    int* sync, int dtype, int B, int L, int H, int N, int P, int chunk,
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
  uint8_t* tiles = reinterpret_cast<uint8_t*>(ws);
  if (dtype == 1) ws += 2 * bh * g.nc * 2 * kTileBytes / 4;
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
  if (dtype == 0) return launch(g, s);
  const void* ptrs[4] = {q, k, v, dO};
  const long long* strides[4] = {qs, ks, vs, dos};
  if (!tc_ok(ptrs, strides, N, P) || sync == nullptr ||
      reinterpret_cast<uintptr_t>(tiles) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(g, tiles, sync, s);
}
