// ssd_wide_bwd: the gradient of ssd_scan for wide heads (N, P up to 256,
// xLSTM's mLSTM) and for the normaliser the mLSTM divides by.
//
// New in the port: the TPU package has no backward Pallas kernel; it
// differentiates the model layer's `gla_chunked`
// (src/repro/models/layers.py:314, called twice by the mLSTM, once for the
// numerator and once for the normaliser) with jax.grad.  ssd_scan_bwd.cu
// takes N, P <= 64 without the normaliser; this file takes the rest of the
// forward's range.  Per (batch, head), for
//
//   o_t = q_t . S_t,     S_t = exp(a_t) S_{t-1} + k_t^T v_t      (S: [N, P])
//
// and, with the normaliser, den_t = q_t . n_t, n_t the same scan of v = 1,
// the gradient given dO (and dden) is, with cum the in-chunk prefix sums
// of a, total the chunk's last, S_in / n_in the state entering the chunk
// and dS_out / dn_out the gradient of the state leaving it:
//
//   dq_t = sum_{s <= t} (dO_t . v_s + dden_t) exp(cum_t - cum_s) k_s
//          + exp(cum_t) (dO_t S_in^T + dden_t n_in)
//   dk_s = sum_{t >= s} (dO_t . v_s + dden_t) exp(cum_t - cum_s) q_t
//          + exp(total - cum_s) (v_s dS_out^T + dn_out)
//   dv_s = sum_{t >= s} (q_t . k_s) exp(cum_t - cum_s) dO_t
//          + exp(total - cum_s) k_s dS_out
//   da_t = sum_{u >= t} (q_u . dq_u - k_u . dk_u)
//
// (the normaliser is the scan of one more column of v, all ones, whose
// output gradient is dden; its dv is dropped).  dq and dk come back per
// head, new contiguous [B, L, H, N]; dv [B, L, H, P]; da [B, L, H] float32.
//
// float32 (the parity path of the reduced xLSTM): three launches on the
// CUDA cores, the normaliser as column P of v (1) and of dO (dden), so the
// kernels work on P_e = P + 1 columns:
//  * ssd_wide_states: S_in of every chunk and dS_out, one CTA per (64 x 64
//    state tile, batch, head, direction) walking the chunks in order.
//  * ssd_wide_grads: one CTA per (64 rows of a chunk, chunk, batch, head,
//    gradient), its 64 output rows, all N (or P) columns, in shared memory;
//    float32 FMAs, each thread a 4 x 4 micro-tile of a 64 x 64 tile.
//  * ssd_wide_da: one CTA per (batch, head), the reverse sums in segments
//    of 256 with a fixed-order tree (Hillis-Steele) inside each.
//
// bf16 (the training path; N and P multiples of 16, else the call is
// refused, and rows TMA can read, which the wrapper's aligned16 copy
// ensures): three launches, every product on Hopper's tensor
// cores (wgmma, bf16 in, float32 sums) over 64 x 64 bf16 boxes that TMA
// brings into shared memory through rings with full and empty mbarriers,
// a producer warp feeding consumer warpgroups (hopper.cuh's pieces):
//  * wide_states_wgmma: one CTA (a warpgroup and a producer warp) per
//    (direction, batch, head, chunk, 64 x 64 tile of the [N, P] state).  A
//    state entry depends on its own columns of k and v (or q and dO) only,
//    so the tiles need no exchange.  It forms its tile of the chunk's own
//    state (forward k^T v, k decayed by exp(total - cum); backward q^T dO,
//    q decayed by exp(cum)) from X^T in registers (ldmatrix of the
//    transposed box, weighted, split in two bf16 terms), then takes its
//    place in the chain with ssd_scan.cu's release flags (tickets in
//    launch order, step slowest): it waits for the tile the step before
//    published, publishes exp(total) prev + own, and stores it again as
//    the grads kernel's operand (bf16 hi / lo boxes, 128B swizzled).  The
//    normaliser is no column here: the tiles of the first 64 columns also
//    carry the N-vector n (the sum of the decayed k) or dn (of the decayed
//    q times dden) through the same chain, in float32 on the CUDA cores.
//  * wide_grads_wgmma: one CTA of 384 threads an SM per item, the items
//    heaviest first so the block scheduler fills the SMs as they free: per
//    chunk, a kv item for each 64-row tile j (warpgroup 1 dk_j, warpgroup 2
//    dv_j, sharing the query tiles (q_i, dO_i), i >= j, streamed through a
//    two-stage ring beside k_j and v_j held resident) and a query item for
//    each pair of 64-row tiles (nt - 1 - p, p) (a warpgroup each for dq,
//    sharing the streamed kv tiles (k_j, v_j) beside the two dO tiles).
//    The register budget sets this split: a 64 x 256 float32 gradient is
//    128 registers a thread of a warpgroup, so each warpgroup holds one
//    gradient of its rows (four 64-column blocks), one 64 x 64 score tile
//    (16 k16 steps deep over N or P) and its hi / lo A fragments, about
//    200 of the 240 registers setmaxnreg gives it.  The state terms come
//    first, the states' hi / lo image streamed through the same ring 64
//    state rows at a time, then scaled by exp(cum_t) (dq) or exp(total -
//    cum_s) (dk, dv) with the normaliser's rank-1 term added in float32
//    (dden_t n_in, dn_out); then each pair step gates its score tile, the
//    normaliser's dden_t added to it before the gate (dq and dk), splits
//    it and multiplies it into the gradient's blocks.  Also q_t . dq_t and
//    k_s . dk_s from the float32 sums.
//  * ssd_wide_da: as for float32.
// Products of bf16 inputs are exact; the float32-held operands (the gated
// scores, S_in, dS_out, the decayed k and q of the states) keep two bf16
// terms, hi = bf16(x) and lo = bf16(x - hi): rounding them once loses the
// 2e-2 on slow decays (ssd_scan_bwd.cu's note).  n_in and dn_out never
// meet a tensor core: they stay float32.  The gate is ex2((cum_t - cum_s)
// log2 e), the difference taken first as the plain version takes it.  No
// atomics in any sum: every output element is written once by one thread
// and the chain runs in a fixed order, so two calls give the same bits.
//
// Bound on an H100 at xlstm-350m's training shape (q, k, v, dO [4, 1024,
// 4, 256] bf16, chunk 256, the normaliser): q, k, v and dO read and dq,
// dk, dv written once, about 59 MB, take 17.5 us; the in-chunk and state
// products, about 1.6e10 FLOP, 16.4 us at the bf16 tensor-core rate:
// bound by bytes, barely.  The design runs about 3.4e10 FLOP on the
// tensor cores (the hi / lo terms, the dq / dk score recomputed, 64-column
// blocks past N or P), and what holds it back is bytes, not the tensor
// cores: with every product emptied both kernels keep most of their time
// (scripts/bwd_kernel_ablation.py; PERF.md has the numbers).  The grads
// kernel streams about 170 MB through L2, half of it the states' image,
// which each of a chunk's items (2 query, 4 kv) reads whole, on the
// two-stage ring that 227 KB of shared memory leaves at N = P = 256; a
// cluster multicasting the image to a chunk's items would cut that.  The
// states kernel reads each k (q) and v (dO) box once a tile and writes
// the float32 chain and the bf16 image; one CTA per 64 state rows across
// every column reads a quarter as much but measured slower, its chain
// moving four times the bytes a step through one CTA.  It takes N, P <= 256
// and chunks <= 256 rows.
#include "hopper.cuh"

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;               // rows of a tile, columns of a tile
constexpr int kLd = kT + 1;          // row pitch of a tile
constexpr int kMaxNP = 256;
constexpr int kMaxChunk = 256;
constexpr int kScanBlock = 16;       // association of the prefix sums
constexpr int kScanSlots = kMaxChunk / kScanBlock;

enum { kQ = 0, kK = 1, kV = 2, kDO = 3 };

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dO;
  const float* a;
  const void* dden;                  // [B, L, H] in v's type, or null
  void* dq;                          // [B, L, H, N], per head
  void* dk;                          // [B, L, H, N], per head
  void* dv;                          // [B, L, H, P]
  float* da;                         // [B, L, H]
  float* S;                          // [B, H, nc, N, Pe]: S_in of each chunk
  float* dS;                         // [B, H, nc, N, Pe]: dS_out of each
  float* rq;                         // [B, H, L]: q_t . dq_t
  float* rk;                         // [B, H, L]: k_t . dk_t
  int B, L, H, N, P, Pe, chunk, nc;
  long long qs[3], ks[3], vs[3], dos[3], as[3], ds[3];  // batch, seq, head
};

__device__ __forceinline__ float at(const void* p, const long long* s, int b,
                                    int t, int h, int col) {
  return static_cast<const float*>(p)[b * s[0] + t * s[1] + h * s[2] + col];
}

// Element (b, t, h, col) of q, k, v or dO; v's column P is the normaliser's
// 1 and dO's its dden (when Pe > P); 0 past the operand's width.
__device__ __forceinline__ float operand(const Args& g, int op, int b, int t,
                                         int h, int col) {
  switch (op) {
    case kQ: return col < g.N ? at(g.q, g.qs, b, t, h, col) : 0.f;
    case kK: return col < g.N ? at(g.k, g.ks, b, t, h, col) : 0.f;
    case kV:
      if (col < g.P) return at(g.v, g.vs, b, t, h, col);
      return col < g.Pe ? 1.f : 0.f;
    default:
      if (col < g.P) return at(g.dO, g.dos, b, t, h, col);
      return col < g.Pe ? at(g.dden, g.ds, b, t, h, 0) : 0.f;
  }
}

// Inclusive prefix sums of a chunk's c values of a (sequence stride
// `stride`) into out, in the association of ssd_scan.cu and of the plain
// version's `blocked_cumsum`: sequential within blocks of 16, each block
// offset by the prefix of the earlier blocks' totals.  Ends with a barrier.
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
  if (tid == 0 && nb > 1) {          // nb <= kScanSlots
    float s = 0.f;
    for (int b = 0; b < nb; ++b) carry[b] = s += tot[b];
  }
  __syncthreads();
  for (int i = kScanBlock + tid; i < n; i += blockDim.x)
    out[i] += carry[i / kScanBlock - 1];
  __syncthreads();
}

// A 64 x 64 tile of operand `op`: rows t0 .. t0 + nr - 1 (zeros past nr),
// columns col0 .. col0 + 63 below `width` (zeros past it), each row scaled
// by scale[r] when given.
__device__ void load_tile(float* dst, const Args& g, int op, int b, int h,
                          int t0, int nr, int col0, int width,
                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    float x = 0.f;
    if (r < nr && col0 + c < width) {
      x = operand(g, op, b, t0 + r, h, col0 + c);
      if (scale) x *= scale[r];
    }
    dst[r * kLd + c] = x;
  }
}

// s[jr][ic] += x[rg + 16 jr] . y[cg + 16 ic] over 64 columns (both tiles
// row-major, pitch kLd)
__device__ __forceinline__ void tile_dot(const float* x, const float* y,
                                         float s[4][4]) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int d = 0; d < kT; ++d) {
    float xv[4], yv[4];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) xv[jr] = x[(rg + 16 * jr) * kLd + d];
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) yv[ic] = y[(cg + 16 * ic) * kLd + d];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) s[jr][ic] += xv[jr] * yv[ic];
  }
}

// s[jr][ic] += sum_r x[r][rg + 16 jr] y[r][cg + 16 ic] over 64 rows
__device__ __forceinline__ void tile_tn(const float* x, const float* y,
                                        float s[4][4]) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  for (int r = 0; r < kT; ++r) {
    float xv[4], yv[4];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) xv[jr] = x[r * kLd + rg + 16 * jr];
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) yv[ic] = y[r * kLd + cg + 16 * ic];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) s[jr][ic] += xv[jr] * yv[ic];
  }
}

__device__ __forceinline__ void zero(float s[4][4]) {
#pragma unroll
  for (int jr = 0; jr < 4; ++jr)
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) s[jr][ic] = 0.f;
}

__device__ __forceinline__ long long slot(const Args& g, int bh, int ci) {
  return ((long long)bh * g.nc + ci) * g.N * g.Pe;
}

// grid (tiles of the [N, Pe] state x B x H, 2): y = 0 stores every chunk's
// S_in, y = 1 every chunk's dS_out
__global__ void __launch_bounds__(kThreads) ssd_wide_states(Args g) {
  extern __shared__ float smem[];
  float* sX = smem;                           // kT x kLd
  float* sY = sX + kT * kLd;                  // kT x kLd
  float* sCum = sY + kT * kLd;                // kMaxChunk
  float* sTot = sCum + kMaxChunk;             // kScanSlots
  float* sCarry = sTot + kScanSlots;          // kScanSlots
  float* sW = sCarry + kScanSlots;            // kT: row weights

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int tp = (g.Pe + kT - 1) / kT, tn = (g.N + kT - 1) / kT;
  const int tile = blockIdx.x % (tn * tp), bh = blockIdx.x / (tn * tp);
  const int b = bh / g.H, h = bh % g.H;
  const int n0 = (tile / tp) * kT, p0 = (tile % tp) * kT;
  const bool fwd = blockIdx.y == 0;
  const int c = g.chunk;
  const float* A = g.a + b * g.as[0] + h * g.as[2];
  float* out = fwd ? g.S : g.dS;

  float st[4][4], own[4][4];
  zero(st);
  for (int step = 0; step < g.nc; ++step) {
    const int ci = fwd ? step : g.nc - 1 - step;
    const int c0 = ci * c;
    float* dst = out + slot(g, bh, ci);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int n = n0 + rg + 16 * jr, p = p0 + cg + 16 * ic;
        if (n < g.N && p < g.Pe) dst[(long long)n * g.Pe + p] = st[jr][ic];
      }
    __syncthreads();
    blocked_cumsum(A + c0 * g.as[1], g.as[1], c, sCum, sTot, sCarry);
    const float total = sCum[c - 1];
    zero(own);
    for (int r0 = 0; r0 < c; r0 += kT) {
      const int nr = min(kT, c - r0);
      // forward: k_r exp(total - cum_r) against v; backward: q_r exp(cum_r)
      // against dO
      if (tid < kT)
        sW[tid] = tid < nr ? expf(fwd ? total - sCum[r0 + tid]
                                      : sCum[r0 + tid])
                           : 0.f;
      __syncthreads();
      load_tile(sX, g, fwd ? kK : kQ, b, h, c0 + r0, nr, n0, g.N, sW);
      load_tile(sY, g, fwd ? kV : kDO, b, h, c0 + r0, nr, p0, g.Pe);
      __syncthreads();
      tile_tn(sX, sY, own);
      __syncthreads();
    }
    const float et = expf(total);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) st[jr][ic] = st[jr][ic] * et + own[jr][ic];
  }
}

// grid (64-row tiles of a chunk x nc x B x H, 3): y = 0 dq, 1 dk, 2 dv of
// 64 rows of a chunk, every column of the gradient
__global__ void __launch_bounds__(kThreads) ssd_wide_grads(Args g) {
  extern __shared__ float smem[];
  const int mode = blockIdx.y;
  const int W = mode == 2 ? g.P : g.N;        // columns of the gradient
  const int D = mode == 2 ? g.N : g.Pe;       // depth of the scores
  const int ldw = W + 1;
  float* sAcc = smem;                         // kT x ldw
  float* sG = sAcc + kT * ldw;                // kT x kLd: gated scores
  float* sX = sG + kT * kLd;                  // kT x kLd
  float* sY = sX + kT * kLd;                  // kT x kLd
  float* sCum = sY + kT * kLd;                // kMaxChunk
  float* sTot = sCum + kMaxChunk;             // kScanSlots
  float* sCarry = sTot + kScanSlots;          // kScanSlots
  float* sW = sCarry + kScanSlots;            // kT: the state term's scale

  const int tid = threadIdx.x, rg = tid / 16, cg = tid % 16;
  const int c = g.chunk;
  const int nt = (c + kT - 1) / kT;
  const int rt = blockIdx.x % nt;
  const int ci = (blockIdx.x / nt) % g.nc;
  const int bh = blockIdx.x / (nt * g.nc);
  const int b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c, i0 = rt * kT, ni = min(kT, c - i0);
  // dq: dO against v, then k; dk: v against dO, then q; dv: k against q,
  // then dO.  The state term: dq dO S_in^T, dk v dS_out^T, dv k dS_out.
  const int opX = mode == 0 ? kDO : mode == 1 ? kV : kK;
  const int opY = mode == 0 ? kV : mode == 1 ? kDO : kQ;
  const int opZ = mode == 0 ? kK : mode == 1 ? kQ : kDO;
  const float* M = (mode == 0 ? g.S : g.dS) + slot(g, bh, ci);

  for (int e = tid; e < kT * ldw; e += kThreads) sAcc[e] = 0.f;
  blocked_cumsum(g.a + b * g.as[0] + h * g.as[2] + c0 * g.as[1], g.as[1], c,
                 sCum, sTot, sCarry);
  const float total = sCum[c - 1];
  if (tid < kT)
    sW[tid] = tid < ni ? expf(mode == 0 ? sCum[i0 + tid]
                                        : total - sCum[i0 + tid])
                       : 0.f;

  float s[4][4];
  // in-chunk: gated scores of the 64 rows against each causal tile, then
  // their product with that tile's rows of Z
  const int j_lo = mode == 0 ? 0 : rt, j_hi = mode == 0 ? rt : nt - 1;
  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int j0 = jt * kT, nj = min(kT, c - j0);
    zero(s);
    for (int d0 = 0; d0 < D; d0 += kT) {
      __syncthreads();
      load_tile(sX, g, opX, b, h, c0 + i0, ni, d0, D);
      load_tile(sY, g, opY, b, h, c0 + j0, nj, d0, D);
      __syncthreads();
      tile_dot(sX, sY, s);
    }
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int i = i0 + rg + 16 * jr, j = j0 + cg + 16 * ic;
        const bool on = rg + 16 * jr < ni && cg + 16 * ic < nj &&
                        (mode == 0 ? j <= i : j >= i);
        // exp(cum_t - cum_s), t the later row, as the plain version's rel
        sG[(rg + 16 * jr) * kLd + cg + 16 * ic] =
            on ? s[jr][ic] * expf(mode == 0 ? sCum[i] - sCum[j]
                                            : sCum[j] - sCum[i])
               : 0.f;
      }
    for (int w0 = 0; w0 < W; w0 += kT) {
      __syncthreads();
      load_tile(sX, g, opZ, b, h, c0 + j0, nj, w0, W);
      __syncthreads();
      zero(s);
      // s[jr][ic] = sum_j G[i][j] Z[j][w]
      for (int j = 0; j < kT; ++j) {
        float xv[4], yv[4];
#pragma unroll
        for (int jr = 0; jr < 4; ++jr) xv[jr] = sG[(rg + 16 * jr) * kLd + j];
#pragma unroll
        for (int ic = 0; ic < 4; ++ic) yv[ic] = sX[j * kLd + cg + 16 * ic];
#pragma unroll
        for (int jr = 0; jr < 4; ++jr)
#pragma unroll
          for (int ic = 0; ic < 4; ++ic) s[jr][ic] += xv[jr] * yv[ic];
      }
#pragma unroll
      for (int jr = 0; jr < 4; ++jr)
#pragma unroll
        for (int ic = 0; ic < 4; ++ic)
          if (w0 + cg + 16 * ic < W)
            sAcc[(rg + 16 * jr) * ldw + w0 + cg + 16 * ic] += s[jr][ic];
    }
  }
  // the state term: scale_i sum_d X'[i][d] M(w, d), X' = dO, v or k
  const int opS = mode == 0 ? kDO : mode == 1 ? kV : kK;
  for (int w0 = 0; w0 < W; w0 += kT) {
    zero(s);
    for (int d0 = 0; d0 < D; d0 += kT) {
      __syncthreads();
      load_tile(sX, g, opS, b, h, c0 + i0, ni, d0, D);
      for (int e = tid; e < kT * kT; e += kThreads) {
        const int w = w0 + e / kT, d = d0 + e % kT;
        float x = 0.f;
        if (w < W && d < D)     // dq, dk: M[n = w][p = d]; dv: M[n = d][p = w]
          x = mode == 2 ? M[(long long)d * g.Pe + w]
                        : M[(long long)w * g.Pe + d];
        sY[(e / kT) * kLd + e % kT] = x;
      }
      __syncthreads();
      tile_dot(sX, sY, s);
    }
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic)
        if (w0 + cg + 16 * ic < W)
          sAcc[(rg + 16 * jr) * ldw + w0 + cg + 16 * ic] +=
              sW[rg + 16 * jr] * s[jr][ic];
  }
  __syncthreads();
  const long long row0 = ((long long)b * g.L + c0 + i0) * g.H + h;
  float* out = static_cast<float*>(mode == 0 ? g.dq : mode == 1 ? g.dk
                                                              : g.dv);
  for (int e = tid; e < ni * W; e += kThreads) {
    const int i = e / W, w = e % W;
    out[(row0 + (long long)i * g.H) * W + w] = sAcc[i * ldw + w];
  }
  if (mode < 2 && tid < ni) {                 // q_t . dq_t, k_t . dk_t
    float r = 0.f;
    for (int n = 0; n < g.N; ++n)
      r += operand(g, mode == 0 ? kQ : kK, b, c0 + i0 + tid, h, n) *
           sAcc[tid * ldw + n];
    (mode == 0 ? g.rq : g.rk)[(long long)bh * g.L + c0 + i0 + tid] = r;
  }
}

// grid (B * H): da_t = sum_{u >= t} (rq_u - rk_u), from the end in
// segments of kThreads, a Hillis-Steele sum inside each
__global__ void __launch_bounds__(kThreads) ssd_wide_da(Args g) {
  __shared__ float sx[kThreads];
  const int tid = threadIdx.x, bh = blockIdx.x;
  const int b = bh / g.H, h = bh % g.H;
  const float* rq = g.rq + (long long)bh * g.L;
  const float* rk = g.rk + (long long)bh * g.L;
  float carry = 0.f;
  for (int end = g.L; end > 0; end -= kThreads) {
    const int t = end - 1 - tid;              // thread 0 the latest row
    const float x = t >= 0 ? rq[t] - rk[t] : 0.f;
    sx[tid] = x;
    __syncthreads();
    for (int off = 1; off < kThreads; off *= 2) {
      const float y = tid >= off ? sx[tid - off] : 0.f;
      __syncthreads();
      sx[tid] += y;
      __syncthreads();
    }
    if (t >= 0) g.da[((long long)b * g.L + t) * g.H + h] = carry + sx[tid];
    carry += sx[kThreads - 1];
    __syncthreads();
  }
}

size_t states_smem() {
  return sizeof(float) * (2 * kT * kLd + kMaxChunk + 2 * kScanSlots + kT);
}

size_t grads_smem(int N, int P) {
  return sizeof(float) * (kT * (std::max(N, P) + 1) + 3 * kT * kLd +
                          kMaxChunk + 2 * kScanSlots + kT);
}

// float32: states, dq / dk / dv, da.
int launch_f32(const Args& g, cudaStream_t stream) {
  const size_t gs = grads_smem(g.N, g.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wide_grads, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gs);
  if (err != cudaSuccess) return (int)err;
  const int bh = g.B * g.H;
  const int tiles = ((g.N + kT - 1) / kT) * ((g.Pe + kT - 1) / kT);
  ssd_wide_states<<<dim3(tiles * bh, 2), kThreads, states_smem(),
                       stream>>>(g);
  const int nt = (g.chunk + kT - 1) / kT;
  ssd_wide_grads<<<dim3(nt * g.nc * bh, 3), kThreads, gs, stream>>>(g);
  ssd_wide_da<<<bh, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// ------------------------- bf16: Hopper tensor cores -----------------------

typedef __nv_bfloat16 bf16;
constexpr int kRows = 64;                   // rows of a tile
constexpr int kBoxBytes = kRows * 128;      // 64 x 64 bf16, one 128B box
constexpr int kMaxBoxes = kMaxNP / kBox;    // boxes across N or P
constexpr int kStStages = 2;                // states: ring depth
constexpr int kStThreads = 160;             // states: warpgroup + producer
constexpr int kGStages = 2;                 // grads: ring depth
constexpr int kGThreads = 384;              // grads: producer + two groups

struct TcArgs {
  const float* a;
  const bf16* q;                     // read for the row dots q_t . dq_t
  const bf16* dden;                  // [B, L, H], or null
  long long as[3], qs[3], ds[3];     // batch, sequence, head
  bf16* dq;                          // [B, L, H, N], per head
  bf16* dk;                          // [B, L, H, N], per head
  bf16* dv;                          // [B, L, H, P]
  float* S;                          // [B, H, nc, N, P]: S_in of each chunk
  float* dS;                         // [B, H, nc, N, P]: dS_out of each
  float* vec;                        // [2, B, H, nc, N]: n_in, dn_out
  float* cum;                        // [B, H, L]: in-chunk prefix sums
  float* rq;                         // [B, H, L]: q_t . dq_t
  float* rk;                         // [B, H, L]: k_t . dk_t
  uint8_t* img;                      // [2, B, H, nc, nbN, 2, nbP] boxes:
                                     // S_in, dS_out as bf16 hi, lo
  int* sync;                         // ticket, then [2, B, H, nc, nbN nbP]
                                     // flags
  int B, L, H, N, P, chunk, nc, nbN, nbP, norm;
  int hm[4], bm[4];                  // q, k, v, dO: 0 where the map is
                                     // broadcast (head, batch coordinate 0)
};

// The states' image of (direction, batch x head, chunk): nbN pieces of 64
// state rows, each nbP hi boxes then nbP lo boxes.
__device__ __forceinline__ uint8_t* image(const TcArgs& g, int dir, int bh,
                                          int ci) {
  return g.img + (((long long)dir * g.B * g.H + bh) * g.nc + ci) * g.nbN *
                     2 * g.nbP * kBoxBytes;
}

// wgmma descriptors of k-step kk: a K-major operand of several boxes (the
// reduced dimension along the columns), and box b of an MN-major one (the
// reduced dimension along the rows, 16 rows a step).
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int kk) {
  return desc128(tile + (kk / 4) * kBoxBytes + 32 * (kk % 4), 16, 1024);
}
__device__ __forceinline__ uint64_t ndesc(uint32_t tile, int b, int kk) {
  return desc128(tile + b * kBoxBytes + 2048 * kk, kBoxBytes, 1024);
}

// acc[32] (+)= X Y^T over `steps` k-steps: X and Y 64-row tiles, K-major;
// `add` = false overwrites acc.
__device__ __forceinline__ void mm_nt(float* acc, uint32_t x, uint32_t y,
                                      int steps, bool add) {
  for (int kk = 0; kk < steps; ++kk)
    Wgmma<64>::ss<0>(acc, kdesc(x, kk), kdesc(y, kk), add || kk > 0);
}

// acc[32] += X Y: box bx of X (K-major, 64 deep), box by of Y (MN-major).
__device__ __forceinline__ void mm_nn(float* acc, uint32_t x, int bx,
                                      uint32_t y, int by) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<64>::ss<1>(acc, kdesc(x, 4 * bx + kk), ndesc(y, by, kk), 1);
}

// acc[32] += F Y: F the register A fragments of a 64 x 64 tile, box b of Y
// MN-major.
__device__ __forceinline__ void mm_rn(float* acc, const uint32_t* f,
                                      uint32_t y, int b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<64>::rs(acc, f + 4 * kk, ndesc(y, b, kk));
}

// The states of a chain, one launch: see the note.  Forward: X = k (box of
// state rows nq) decayed by exp(total - cum), Y = v (box of state columns
// pb); backward: X = q decayed by exp(cum), Y = dO.  The normaliser's
// vector (pb = 0 tiles): forward sum_s k_s exp(total - cum_s), backward
// sum_t q_t exp(cum_t) dden_t, in float32.
__global__ void __launch_bounds__(kStThreads)
wide_states_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv,
                  const __grid_constant__ CUtensorMap tdo, TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sX = base;                                  // kStStages boxes
  uint8_t* sY = sX + kStStages * kBoxBytes;            // kStStages boxes
  float* sCum = reinterpret_cast<float*>(sY + kStStages * kBoxBytes);
  float* sW = sCum + kMaxChunk;                        // row weights
  float* sV = sW + kMaxChunk;                          // the vector's
  float* sTot = sV + kMaxChunk;
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
  const int BH = g.B * g.H, T = g.nbN * g.nbP, per_dir = BH * T;
  const int step = ticket / (2 * per_dir), rest = ticket % (2 * per_dir);
  const bool fwd = rest < per_dir;
  const int bh = (rest % per_dir) / T, tile = rest % T;
  const int nq = tile / g.nbP, pb = tile % g.nbP;
  const int b = bh / g.H, h = bh % g.H;
  const int ci = fwd ? step : g.nc - 1 - step;
  const int c = g.chunk, c0 = ci * c;
  const int nt = (c + kRows - 1) / kRows;
  const bool vec = g.norm && pb == 0;

  if (tid >= 128) {                      // producer warp
    if (tid == 128) {
      const CUtensorMap* mx = fwd ? &tk : &tq;
      const CUtensorMap* my = fwd ? &tv : &tdo;
      const int ix = fwd ? 1 : 0, iy = fwd ? 2 : 3;
      for (int r = 0; r < nt; ++r) {
        const int s = r % kStStages;
        if (r >= kStStages)
          mbar_wait(bar_empty + 8 * s, (r / kStStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * kBoxBytes);
        tma_load(smem_u32(sX + s * kBoxBytes), mx, bar_full + 8 * s,
                 nq * kBox, c0 + r * kRows, h * g.hm[ix], b * g.bm[ix]);
        tma_load(smem_u32(sY + s * kBoxBytes), my, bar_full + 8 * s,
                 pb * kBox, c0 + r * kRows, h * g.hm[iy], b * g.bm[iy]);
      }
    }
    return;
  }
  // the consumer warpgroup
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, t4 = lane % 4;
  chunk_cumsum(g.a + b * g.as[0] + h * g.as[2] + c0 * g.as[1], g.as[1], c,
               sCum, sTot, sCarry, tid, 128, 1);
  const float total = sCum[c - 1];
  for (int i = tid; i < nt * kRows; i += 128) {
    const float w = i < c ? expf(fwd ? total - sCum[i] : sCum[i]) : 0.f;
    sW[i] = w;
    if (vec)
      sV[i] = fwd || i >= c
                  ? w
                  : w * __bfloat162float(g.dden[b * g.ds[0] +
                                                (c0 + i) * g.ds[1] +
                                                h * g.ds[2]]);
  }
  if (fwd && tile == 0)
    for (int i = tid; i < c; i += 128)
      g.cum[(long long)bh * g.L + c0 + i] = sCum[i];
  named_sync(1, 128);

  float own[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) own[i] = 0.f;
  float vs[2] = {0.f, 0.f};              // state rows 16 warp + gq (+ 8)
  for (int r = 0; r < nt; ++r) {
    const int s = r % kStStages;
    mbar_wait(bar_full + 8 * s, (r / kStStages) & 1);
    const uint32_t x_addr = smem_u32(sX + s * kBoxBytes);
    uint32_t hi[16], lo[16];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      // A[m = n][k = row]: rows 16 kk .. of the box, state rows 16 warp ..
      const int row = 16 * kk + lane % 8 + (lane / 16) * 8;
      const int col = 16 * warp + ((lane / 8) % 2) * 8;
      uint32_t x[4];
      ldsm4_t(x, x_addr + swz(row, col, kBoxBytes));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // x[i]: state row 16 warp + gq (+ 8 for odd i), rows (k) of the
        // box 16 kk + 2 t4 (+ 8 for i >= 2), + 1
        const int k = r * kRows + 16 * kk + 2 * t4 + (i / 2) * 8;
        const float2 xf = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&x[i]));
        split2(xf.x * sW[k], xf.y * sW[k + 1], hi[4 * kk + i],
               lo[4 * kk + i]);
        if (vec) vs[i % 2] += xf.x * sV[k] + xf.y * sV[k + 1];
      }
    }
    const uint32_t y_addr = smem_u32(sY + s * kBoxBytes);
    fence_regs<32>(own);
    wg_fence();
    mm_rn(own, hi, y_addr, 0);
    mm_rn(own, lo, y_addr, 0);
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(own);
    fence_u32<16>(hi);
    fence_u32<16>(lo);
    mbar_arrive(bar_empty + 8 * s);
  }
  if (vec)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      vs[hf] += __shfl_xor_sync(0xffffffffu, vs[hf], 1);
      vs[hf] += __shfl_xor_sync(0xffffffffu, vs[hf], 2);
    }

  // the hand-off: prev from the step before, exp(total) prev + own on
  const int N = g.N, P = g.P, n0 = nq * kBox, p0 = pb * kBox;
  const long long np = (long long)N * P;
  float* states = fwd ? g.S : g.dS;
  float* vecs = g.vec + (fwd ? 0 : (long long)BH * g.nc * N);
  int* flags = g.sync + 1 + ((fwd ? 0 : (long long)BH * g.nc) +
                             (long long)bh * g.nc) * T + tile;
  const long long slot0 = (long long)bh * g.nc;
  const bool has_next = fwd ? ci + 1 < g.nc : ci > 0;
  const int next = fwd ? ci + 1 : ci - 1;
  if (step > 0) {
    if (tid == 0) {
      // seconds of polling mean a broken chain: fail rather than hang
      for (int spins = 0; ld_acquire(flags + (long long)ci * T) == 0;)
        if (++spins > (1 << 22)) __trap();
    }
    named_sync(1, 128);
    const float decay = expf(total);
    const float* prev = states + (slot0 + ci) * np;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 16 * warp + gq + 8 * hf, p = p0 + 8 * j + 2 * t4;
        if (n < N && p < P) {
          const float2 x =
              __ldcg(reinterpret_cast<const float2*>(prev + n * P + p));
          own[4 * j + 2 * hf] = fmaf(x.x, decay, own[4 * j + 2 * hf]);
          own[4 * j + 2 * hf + 1] = fmaf(x.y, decay, own[4 * j + 2 * hf + 1]);
        }
      }
    if (vec)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 16 * warp + gq + 8 * hf;
        if (n < N)
          vs[hf] = fmaf(__ldcg(vecs + (slot0 + ci) * N + n), decay, vs[hf]);
      }
  }
  if (has_next) {
    float* dst = states + (slot0 + next) * np;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 16 * warp + gq + 8 * hf, p = p0 + 8 * j + 2 * t4;
        if (n < N && p < P)
          *reinterpret_cast<float2*>(dst + n * P + p) =
              make_float2(own[4 * j + 2 * hf], own[4 * j + 2 * hf + 1]);
      }
    if (vec && t4 == 0)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = n0 + 16 * warp + gq + 8 * hf;
        if (n < N) vecs[(slot0 + next) * N + n] = vs[hf];
      }
    __threadfence();
    named_sync(1, 128);
    if (tid == 0) st_release(flags + (long long)next * T, 1);
    // the same tile as the grads kernel's operand: bf16 hi and lo boxes in
    // the 128B-swizzled layout (zeros past N and P), loaded as they are
    uint8_t* hi = image(g, fwd ? 0 : 1, bh, next) +
                  ((long long)nq * 2 * g.nbP + pb) * kBoxBytes;
    uint8_t* lo = hi + g.nbP * kBoxBytes;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int n = 16 * warp + gq + 8 * hf, p = 8 * j + 2 * t4;
        const bool in = n0 + n < N && p0 + p < P;
        uint32_t h2, l2;
        split2(in ? own[4 * j + 2 * hf] : 0.f,
               in ? own[4 * j + 2 * hf + 1] : 0.f, h2, l2);
        const uint32_t off = swz(n, p, kBoxBytes);
        *reinterpret_cast<uint32_t*>(hi + off) = h2;
        *reinterpret_cast<uint32_t*>(lo + off) = l2;
      }
  }
}

// x[32], a 64 x 64 score tile in accumulator layout (rows r_base + ra (+ 8),
// columns c_base + 8 j + 2 t4 (+ 1), chunk positions), plus add[] (the
// normaliser's dden of the query position: of the rows, or with T_COL of
// the columns; ADD = false: nothing), times the gate exp(cum_t - cum_s)
// on s <= t < c.  T_COL: the columns are the query positions t.  EDGE: the
// tile crosses the diagonal or the chunk's end and is masked element by
// element (0 off the triangle); else all of it is kept.  The gate is ex2
// of the difference times log2(e): one MUFU.EX2.
template <bool T_COL, bool EDGE, bool ADD>
__device__ __forceinline__ void gate(float* x, const float* cum,
                                     const float* add, int c, int r_base,
                                     int c_base, int ra, int t4) {
  float rc[2], radd[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = min(r_base + ra + 8 * hf, c - 1);
    rc[hf] = cum[r];
    radd[hf] = ADD && !T_COL ? add[r] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int cp0 = c_base + 8 * j + 2 * t4;
    const float cc[2] = {cum[min(cp0, c - 1)], cum[min(cp0 + 1, c - 1)]};
    const float cadd[2] = {ADD && T_COL ? add[min(cp0, c - 1)] : 0.f,
                           ADD && T_COL ? add[min(cp0 + 1, c - 1)] : 0.f};
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
      float v = x[4 * j + e];
      if (ADD) v += T_COL ? cadd[e & 1] : radd[e / 2];
      // masked: 0 by a select (above the diagonal gv may be inf)
      x[4 * j + e] = ok ? v * gv : 0.f;
    }
  }
}

// The gradient rows ra, ra + 8 of a tile (positions r0 + ra .. of the
// chunk at c0, rows past c not written) as bf16 pairs, w columns, from
// the four 64-column blocks acc[q].
__device__ __forceinline__ void store_rows(bf16* out, float (*acc)[32],
                                           const TcArgs& g, int b, int h,
                                           int c0, int r0, int c, int w,
                                           int ra, int t4) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int t = r0 + ra + 8 * hf;
    if (t >= c) continue;
    bf16* row = out + (((long long)b * g.L + c0 + t) * g.H + h) * w;
#pragma unroll
    for (int q = 0; q < kMaxBoxes; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int x = q * kBox + 8 * j + 2 * t4;
        if (x < w)
          *reinterpret_cast<__nv_bfloat162*>(row + x) = __floats2bfloat162_rn(
              acc[q][4 * j + 2 * hf], acc[q][4 * j + 2 * hf + 1]);
      }
  }
}

// Each row's state term, exp-scaled: acc = w_row (acc + add_row vec[col])
// (vec null: acc = w_row acc), the rows' weights w[2] and adds ad[2].
__device__ __forceinline__ void scale_rows(float (*acc)[32], const float* w,
                                           const float* ad, const float* vec,
                                           int width, int t4) {
#pragma unroll
  for (int q = 0; q < kMaxBoxes; ++q)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = q * kBox + 8 * j + 2 * t4 + e;
        const float vc = vec != nullptr && col < width ? vec[col] : 0.f;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float& x = acc[q][4 * j + 2 * hf + e];
          x = w[hf] * (vec != nullptr ? fmaf(ad[hf], vc, x) : x);
        }
      }
}

// The item of grid rank `rank` among a chunk's nt + ceil(nt / 2), heaviest
// first: kv items j = 0, 1, ... (nt - j query tiles each) interleaved with
// query items p = 0, 1, ... (tiles nt - 1 - p and p).
__device__ __forceinline__ void item_of(int rank, int nt, bool& kv,
                                        int& idx) {
  const int nq = (nt + 1) / 2;
  for (int l = 0; l < nt; ++l) {
    if (rank == 0) {
      kv = true;
      idx = l;
      return;
    }
    --rank;
    if (l < nq) {
      if (rank == 0) {
        kv = false;
        idx = l;
        return;
      }
      --rank;
    }
  }
  kv = true;
  idx = nt - 1;
}

// dq, dk and dv (see the note): one CTA per item, a producer warpgroup
// (one thread issuing every TMA and bulk copy) and two consumer warpgroups.
// The producer loads the item's resident tiles (kv item: k_j, v_j; query
// item: the two dO tiles), then through the two-stage ring the state
// image's nbN pieces (when the chunk has that state), then one stage per
// pair step (kv item: q_i and dO_i; query item: k_j and v_j).  Every
// consumer thread waits for every stage and arrives on its empty barrier
// after its own products of that stage are done.
__global__ void __launch_bounds__(kGThreads, 1)
wide_grads_wgmma(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo, TcArgs g) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nbN = g.nbN, nbP = g.nbP;
  const int R = max(nbN + nbP, 2 * nbP);       // boxes: resident, a stage
  uint8_t* res = base;
  uint8_t* ring = base + R * kBoxBytes;        // kGStages x R boxes
  float* sCum = reinterpret_cast<float*>(ring + kGStages * R * kBoxBytes);
  float* sDd = sCum + kMaxChunk;               // dden of the chunk, or 0
  uint64_t* bars = reinterpret_cast<uint64_t*>(sDd + kMaxChunk);
  const uint32_t bar_full = smem_u32(bars);                   // + 8 s
  const uint32_t bar_empty = smem_u32(bars + kGStages);       // + 8 s
  const uint32_t bar_res = smem_u32(bars + 2 * kGStages);

  const int tid = threadIdx.x;
  const int c = g.chunk, nt = (c + kRows - 1) / kRows;
  const int per = g.B * g.H * g.nc;
  const int rank = blockIdx.x / per, bh = (blockIdx.x % per) / g.nc;
  const int ci = blockIdx.x % g.nc, b = bh / g.H, h = bh % g.H;
  const int c0 = ci * c;
  bool kv;
  int idx;
  item_of(rank, nt, kv, idx);
  // kv item: tile j = idx, steps over query tiles i = j .. nt - 1; query
  // item: tiles ia = nt - 1 - idx and ib = idx, steps over kv tiles 0 .. ia
  const int ia = nt - 1 - idx, ib = idx;
  const int p_lo = kv ? idx : 0, p_hi = kv ? nt - 1 : ia;
  const bool has_state = kv ? ci + 1 < g.nc : ci > 0;
  if (tid == 0) {
    for (int s = 0; s < kGStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_res, 1);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      const int hq = h * g.hm[0], hk = h * g.hm[1], hv = h * g.hm[2];
      const int hd = h * g.hm[3];
      const int bq = b * g.bm[0], bk = b * g.bm[1], bv = b * g.bm[2];
      const int bd = b * g.bm[3];
      auto boxes = [&](uint8_t* dst, const CUtensorMap* map, int n, int row,
                       int hh, int bb, uint32_t bar) {
        for (int x = 0; x < n; ++x)
          tma_load(smem_u32(dst + x * kBoxBytes), map, bar, x * kBox, row,
                   hh, bb);
      };
      if (kv) {
        mbar_expect_tx(bar_res, (nbN + nbP) * kBoxBytes);
        boxes(res, &tk, nbN, c0 + idx * kRows, hk, bk, bar_res);
        boxes(res + nbN * kBoxBytes, &tv, nbP, c0 + idx * kRows, hv, bv,
              bar_res);
      } else {
        const int two = ib < ia ? 2 : 1;
        mbar_expect_tx(bar_res, two * nbP * kBoxBytes);
        boxes(res, &tdo, nbP, c0 + ia * kRows, hd, bd, bar_res);
        if (two == 2)
          boxes(res + nbP * kBoxBytes, &tdo, nbP, c0 + ib * kRows, hd, bd,
                bar_res);
      }
      int cnt = 0;
      auto acquire = [&]() {
        const int s = cnt % kGStages;
        if (cnt >= kGStages)
          mbar_wait(bar_empty + 8 * s, (cnt / kGStages - 1) & 1);
        return s;
      };
      if (has_state) {
        const uint8_t* src = image(g, kv ? 1 : 0, bh, ci);
        const uint32_t bytes = 2 * nbP * kBoxBytes;
        for (int q = 0; q < nbN; ++q, ++cnt) {
          const int s = acquire();
          mbar_expect_tx(bar_full + 8 * s, bytes);
          bulk_load(smem_u32(ring + s * R * kBoxBytes), src + q * bytes,
                    bytes, bar_full + 8 * s);
        }
      }
      for (int p = p_lo; p <= p_hi; ++p, ++cnt) {
        const int s = acquire();
        uint8_t* st = ring + s * R * kBoxBytes;
        const uint32_t bar = bar_full + 8 * s;
        mbar_expect_tx(bar, (nbN + nbP) * kBoxBytes);
        if (kv) {
          boxes(st, &tq, nbN, c0 + p * kRows, hq, bq, bar);
          boxes(st + nbN * kBoxBytes, &tdo, nbP, c0 + p * kRows, hd, bd, bar);
        } else {
          boxes(st, &tk, nbN, c0 + p * kRows, hk, bk, bar);
          boxes(st + nbN * kBoxBytes, &tv, nbP, c0 + p * kRows, hv, bv, bar);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  // the warpgroup, read from lane 0 so the compiler knows it is uniform:
  // wgmmas under a branch it takes for divergent are serialized
  const int ctid = tid - 128;
  const int cw = __shfl_sync(0xffffffffu, ctid / 128, 0);
  const int warp = (ctid % 128) / 32, lane = tid % 32;
  const int gq = lane / 4, t4 = lane % 4;
  const int ra = 16 * warp + gq;         // rows ra, ra + 8 of a tile
  const int N = g.N, P = g.P, BH = g.B * g.H;
  const int kN = N / 16, kP = P / 16;    // k16 steps over N, P
  for (int i = ctid; i < c; i += 256) {
    sCum[i] = g.cum[(long long)bh * g.L + c0 + i];
    sDd[i] = g.norm ? __bfloat162float(g.dden[b * g.ds[0] +
                                              (c0 + i) * g.ds[1] +
                                              h * g.ds[2]])
                    : 0.f;
  }
  named_sync(1, 256);
  mbar_wait(bar_res, 0);
  const float total = sCum[c - 1];
  const uint32_t res_a = smem_u32(res), ring_a = smem_u32(ring);
  int cnt = 0;
  auto stage = [&]() {                   // the stage `cnt` has arrived
    const int s = cnt % kGStages;
    mbar_wait(bar_full + 8 * s, (cnt / kGStages) & 1);
    return ring_a + s * R * kBoxBytes;
  };
  auto release = [&]() {
    mbar_arrive(bar_empty + 8 * (cnt % kGStages));
    ++cnt;
  };
  float acc[kMaxBoxes][32];
#pragma unroll
  for (int q = 0; q < kMaxBoxes; ++q)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[q][i] = 0.f;
  float sd[32];
  uint32_t gh[16], gl[16];

  if (!kv) {
    // ---- a query item: this warpgroup's dq of tile i ----
    const int i = cw == 0 ? ia : ib;
    const bool active = cw == 0 || ib < ia;
    const int r0 = i * kRows;
    const uint32_t my_do = res_a + cw * nbP * kBoxBytes;
    if (has_state) {     // dO_i S_in^T, 64 state rows (dq columns) a stage
#pragma unroll
      for (int q = 0; q < kMaxBoxes; ++q) {
        if (q >= nbN) break;
        const uint32_t st = stage();
        if (active) {
          fence_regs<32>(acc[q]);
          wg_fence();
          mm_nt(acc[q], my_do, st, kP, true);
          mm_nt(acc[q], my_do, st + nbP * kBoxBytes, kP, true);
          wg_commit();
          wg_wait<0>();
          fence_regs<32>(acc[q]);
        }
        release();
      }
      if (active) {      // exp(cum_t) (dO_t S_in^T + dden_t n_in)
        float w[2], ad[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int r = min(r0 + ra + 8 * hf, c - 1);
          w[hf] = expf(sCum[r]);
          ad[hf] = sDd[r];
        }
        scale_rows(acc, w, ad,
                   g.norm ? g.vec + ((long long)bh * g.nc + ci) * N
                          : nullptr,
                   N, t4);
      }
    }
    for (int p = p_lo; p <= p_hi; ++p) {  // kv tile j = p: k_j, v_j
      const uint32_t st = stage();
      if (active && p <= i) {
        wg_fence();
        mm_nt(sd, my_do, st + nbN * kBoxBytes, kP, false);   // dO_i v_j^T
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(sd);
        if (p == i || r0 + kRows > c)
          gate<false, true, true>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
        else
          gate<false, false, true>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
        split_a<32>(sd, gh, gl);
#pragma unroll
        for (int q = 0; q < kMaxBoxes; ++q) fence_regs<32>(acc[q]);
        wg_fence();
#pragma unroll
        for (int q = 0; q < kMaxBoxes; ++q) {
          if (q >= nbN) break;
          mm_rn(acc[q], gh, st, q);                         // G k_j
          mm_rn(acc[q], gl, st, q);
        }
        wg_commit();
        wg_wait<0>();
#pragma unroll
        for (int q = 0; q < kMaxBoxes; ++q) fence_regs<32>(acc[q]);
        fence_u32<16>(gh);
        fence_u32<16>(gl);
      }
      release();
    }
    if (!active) return;
    // q_t . dq_t from the float32 sums, then dq
    float rq[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int t = r0 + ra + 8 * hf;
      float d = 0.f;
      if (t < c) {
        const bf16* qrow = g.q + b * g.qs[0] + (long long)(c0 + t) * g.qs[1] +
                           h * g.qs[2];
#pragma unroll
        for (int q = 0; q < kMaxBoxes; ++q)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int x = q * kBox + 8 * j + 2 * t4;
            if (x < N) {
              const float2 v = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(qrow + x));
              d = fmaf(v.x, acc[q][4 * j + 2 * hf], d);
              d = fmaf(v.y, acc[q][4 * j + 2 * hf + 1], d);
            }
          }
      }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      rq[hf] = d + __shfl_xor_sync(0xffffffffu, d, 2);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (t4 == 0 && r0 + ra + 8 * hf < c)
        g.rq[(long long)bh * g.L + c0 + r0 + ra + 8 * hf] = rq[hf];
    store_rows(g.dq, acc, g, b, h, c0, r0, c, N, ra, t4);
    return;
  }

  // ---- a kv item: warpgroup 1 dk_j, warpgroup 2 dv_j ----
  const int j = idx, r0 = j * kRows;
  const bool dk = cw == 0;
  const uint32_t k_j = res_a, v_j = res_a + nbN * kBoxBytes;
  if (has_state) {       // 64 rows of dS_out a stage
#pragma unroll
    for (int q = 0; q < kMaxBoxes; ++q) {
      if (q >= nbN) break;
      const uint32_t st = stage();
#pragma unroll
      for (int x = 0; x < kMaxBoxes; ++x) fence_regs<32>(acc[x]);
      wg_fence();
      if (dk) {          // v_s dS_out^T: dk columns of these rows
        mm_nt(acc[q], v_j, st, kP, true);
        mm_nt(acc[q], v_j, st + nbP * kBoxBytes, kP, true);
      } else {           // k_s dS_out: these rows' part of every dv column
#pragma unroll
        for (int x = 0; x < kMaxBoxes; ++x) {
          if (x >= nbP) break;
          mm_nn(acc[x], k_j, q, st, x);
          mm_nn(acc[x], k_j, q, st + nbP * kBoxBytes, x);
        }
      }
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int x = 0; x < kMaxBoxes; ++x) fence_regs<32>(acc[x]);
      release();
    }
    // exp(total - cum_s) (v_s dS_out^T + dn_out), exp(total - cum_s) k_s
    // dS_out
    float w[2], ad[2] = {1.f, 1.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      w[hf] = expf(total - sCum[min(r0 + ra + 8 * hf, c - 1)]);
    scale_rows(acc, w, ad,
               dk && g.norm
                   ? g.vec + ((long long)(BH + bh) * g.nc + ci) * N
                   : nullptr,
               N, t4);
  }
  for (int p = p_lo; p <= p_hi; ++p) {    // query tile i = p: q_i, dO_i
    const uint32_t st = stage();
    const uint32_t q_i = st, do_i = st + nbN * kBoxBytes;
    wg_fence();
    if (dk)
      mm_nt(sd, v_j, do_i, kP, false);                      // v_j dO_i^T
    else
      mm_nt(sd, k_j, q_i, kN, false);                       // k_j q_i^T
    wg_commit();
    wg_wait<0>();
    fence_regs<32>(sd);
    const bool edge = p == j || (p + 1) * kRows > c;
    if (dk) {
      if (edge)
        gate<true, true, true>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
      else
        gate<true, false, true>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
    } else {
      if (edge)
        gate<true, true, false>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
      else
        gate<true, false, false>(sd, sCum, sDd, c, r0, p * kRows, ra, t4);
    }
    split_a<32>(sd, gh, gl);
#pragma unroll
    for (int q = 0; q < kMaxBoxes; ++q) fence_regs<32>(acc[q]);
    wg_fence();
    const uint32_t y = dk ? q_i : do_i;   // G_do^T q_i, G_qk^T dO_i
    const int nb = dk ? nbN : nbP;
#pragma unroll
    for (int q = 0; q < kMaxBoxes; ++q) {
      if (q >= nb) break;
      mm_rn(acc[q], gh, y, q);
      mm_rn(acc[q], gl, y, q);
    }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int q = 0; q < kMaxBoxes; ++q) fence_regs<32>(acc[q]);
    fence_u32<16>(gh);
    fence_u32<16>(gl);
    release();
  }
  if (dk) {              // k_s . dk_s from the float32 sums, then dk
    float rk[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxBoxes; ++q)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int x = q * kBox + 8 * jj + 2 * t4;
          if (x < N) {
            const float2 v = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(
                    res + swz(ra + 8 * hf, x, kBoxBytes)));
            d = fmaf(v.x, acc[q][4 * jj + 2 * hf], d);
            d = fmaf(v.y, acc[q][4 * jj + 2 * hf + 1], d);
          }
        }
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      rk[hf] = d + __shfl_xor_sync(0xffffffffu, d, 2);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      if (t4 == 0 && r0 + ra + 8 * hf < c)
        g.rk[(long long)bh * g.L + c0 + r0 + ra + 8 * hf] = rk[hf];
    store_rows(g.dk, acc, g, b, h, c0, r0, c, N, ra, t4);
  } else {
    store_rows(g.dv, acc, g, b, h, c0, r0, c, P, ra, t4);
  }
}

constexpr int kStSmem = 1024 + 2 * kStStages * kBoxBytes +
                        (3 * kMaxChunk + 2 * kScanSlots) * 4 +
                        8 * 2 * kStStages + 16;

// The grads kernel's shared memory for N, P: resident boxes and kGStages
// stages of R = max(nbN + nbP, 2 nbP) boxes, the chunk's prefix sums and
// dden, the barriers.
int grads_wgmma_smem(int N, int P) {
  const int nbN = (N + kBox - 1) / kBox, nbP = (P + kBox - 1) / kBox;
  const int R = std::max(nbN + nbP, 2 * nbP);
  return 1024 + (1 + kGStages) * R * kBoxBytes + 2 * kMaxChunk * 4 +
         8 * (2 * kGStages + 1);
}

// bf16: the states, then dq / dk / dv, then da: three launches.
int launch_bf16(const Args& a, uint8_t* img, float* ws, int* sync,
                cudaStream_t s) {
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
  const long long bh = (long long)a.B * a.H;
  g.a = a.a;
  g.q = static_cast<const bf16*>(a.q);
  g.dden = static_cast<const bf16*>(a.dden);
  for (int i = 0; i < 3; ++i) {
    g.as[i] = a.as[i];
    g.qs[i] = a.qs[i];
    g.ds[i] = a.ds[i];
  }
  g.dq = static_cast<bf16*>(a.dq);
  g.dk = static_cast<bf16*>(a.dk);
  g.dv = static_cast<bf16*>(a.dv);
  g.S = ws;
  g.dS = g.S + bh * a.nc * a.N * a.P;
  g.vec = g.dS + bh * a.nc * a.N * a.P;
  g.cum = g.vec + 2 * bh * a.nc * a.N;
  g.rq = g.cum + bh * a.L;
  g.rk = g.rq + bh * a.L;
  g.img = img;
  g.sync = sync;
  g.B = a.B;
  g.L = a.L;
  g.H = a.H;
  g.N = a.N;
  g.P = a.P;
  g.chunk = a.chunk;
  g.nc = a.nc;
  g.nbN = (a.N + kBox - 1) / kBox;
  g.nbP = (a.P + kBox - 1) / kBox;
  g.norm = a.dden != nullptr;
  // once per device: the kernels' shared memory
  constexpr int kDevices = 64;
  static bool set_up[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  if (!set_up[dev]) {
    if ((err = cudaFuncSetAttribute(
             wide_states_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
             kStSmem)) ||
        (err = cudaFuncSetAttribute(
             wide_grads_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize,
             grads_wgmma_smem(kMaxNP, kMaxNP))))
      return (int)err;
    set_up[dev] = true;
  }
  wide_states_wgmma<<<2 * bh * a.nc * g.nbN * g.nbP, kStThreads, kStSmem,
                      s>>>(maps[0], maps[1], maps[2], maps[3], g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (a.chunk + kRows - 1) / kRows;
  wide_grads_wgmma<<<(nt + (nt + 1) / 2) * bh * a.nc, kGThreads,
                     grads_wgmma_smem(a.N, a.P), s>>>(maps[0], maps[1],
                                                      maps[2], maps[3], g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  Args d = a;                            // da from this layout's rows
  d.rq = g.rq;
  d.rk = g.rk;
  ssd_wide_da<<<a.B * a.H, kThreads, 0, s>>>(d);
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

extern "C" int ssd_wide_bwd_max_np() { return kMaxNP; }
extern "C" int ssd_wide_bwd_max_chunk() { return kMaxChunk; }

// The workspace, in float32 values.  float32 (dtype 0): the two [B, H, nc,
// N, P (+1 with the normaliser)] state stacks and two [B, H, L] rows.
// bf16 (dtype 1): the states' bf16 image ([2, B, H, nc, nbN, 2, nbP] boxes
// of 8 KB, nbN and nbP the 64-column boxes across N and P), then the two
// [B, H, nc, N, P] state stacks, the normaliser's [2, B, H, nc, N] vectors
// and three [B, H, L] rows.
extern "C" long long ssd_wide_bwd_ws_floats(int B, int L, int H, int N,
                                            int P, int chunk, int norm,
                                            int dtype) {
  const long long bh = (long long)B * H, nc = L / chunk;
  if (dtype != 1) return 2 * bh * nc * N * (P + (norm ? 1 : 0)) + 2 * bh * L;
  const long long nbN = (N + kBox - 1) / kBox, nbP = (P + kBox - 1) / kBox;
  return 2 * bh * nc * nbN * 2 * nbP * kBoxBytes / 4 + 2 * bh * nc * N * P +
         2 * bh * nc * N + 3 * bh * L;
}

// The zeroed int32 values bf16 takes: the states launch's ticket counter
// and a ready flag per (direction, batch, head, chunk, 64 x 64 state tile);
// float32 takes none.
extern "C" long long ssd_wide_bwd_sync_ints(int B, int L, int H, int N,
                                            int P, int chunk) {
  const long long tiles = (long long)((N + kBox - 1) / kBox) *
                          ((P + kBox - 1) / kBox);
  return 1 + 2 * (long long)B * H * (L / chunk) * tiles;
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dO, dden, dq, dk, dv; a and da
// are float32).  Strides in elements, three per input (batch, sequence,
// head), in the order q, k, v, dO, a, dden (dden null without the
// normaliser); dq, dk, dv and da are new contiguous tensors; ws holds
// ssd_wide_bwd_ws_floats values (16 B aligned); sync (bf16 only) holds
// ssd_wide_bwd_sync_ints zeros.  bf16 needs N and P multiples of 16,
// strides multiples of 8 and 16 B aligned pointers.  Launches on `stream`
// and returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for
// inputs the kernels do not take; 10000 when the TMA maps cannot be made).
extern "C" int ssd_wide_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* a, const void* dden, void* dq, void* dk, void* dv,
    float* da, float* ws, int* sync, int dtype, int B, int L, int H, int N,
    int P, int chunk, const long long* qs, const long long* ks,
    const long long* vs, const long long* dos, const long long* as,
    const long long* ds, void* stream) {
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
  g.dden = dden;
  g.dq = dq;
  g.dk = dk;
  g.dv = dv;
  g.da = da;
  g.B = B;
  g.L = L;
  g.H = H;
  g.N = N;
  g.P = P;
  g.Pe = P + (dden ? 1 : 0);
  g.chunk = chunk;
  g.nc = L / chunk;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = qs[i];
    g.ks[i] = ks[i];
    g.vs[i] = vs[i];
    g.dos[i] = dos[i];
    g.as[i] = as[i];
    g.ds[i] = dden ? ds[i] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const long long bh = (long long)B * H;
    g.S = ws;
    g.dS = ws + bh * g.nc * N * g.Pe;
    g.rq = g.dS + bh * g.nc * N * g.Pe;
    g.rk = g.rq + bh * L;
    return launch_f32(g, s);
  }
  const void* ptrs[4] = {q, k, v, dO};
  const long long* strides[4] = {qs, ks, vs, dos};
  if (!tc_ok(ptrs, strides, N, P) || sync == nullptr ||
      reinterpret_cast<uintptr_t>(ws) % 16)
    return (int)cudaErrorInvalidValue;
  const long long bh = (long long)B * H;
  const long long img_floats = 2 * bh * g.nc * ((N + kBox - 1) / kBox) * 2 *
                               ((P + kBox - 1) / kBox) * kBoxBytes / 4;
  return launch_bf16(g, reinterpret_cast<uint8_t*>(ws), ws + img_floats,
                     sync, s);
}
