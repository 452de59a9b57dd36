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
// the normaliser is one more column of v, all ones, whose output gradient
// is dden: the kernel works on P_e = P + 1 columns, reading column P of v
// as 1 and of dO as dden, and drops dv of that column.  dq, dk and da sum
// it in with the other columns.  The gradient (ssd_scan_bwd.cu's note):
//
//   dq_t = sum_{s <= t} (dO_t . v_s) exp(cum_t - cum_s) k_s
//          + exp(cum_t) dO_t S_in^T
//   dk_s = sum_{t >= s} (dO_t . v_s) exp(cum_t - cum_s) q_t
//          + exp(total - cum_s) v_s dS_out^T
//   dv_s = sum_{t >= s} (q_t . k_s) exp(cum_t - cum_s) dO_t
//          + exp(total - cum_s) k_s dS_out
//   da_t = sum_{u >= t} (q_u . dq_u - k_u . dk_u)
//
// Three launches in order on the stream, float32 inside, on the CUDA cores
// (bf16 or float32 in and out; FMAs out of shared memory, each thread a
// 4 x 4 micro-tile of a 64 x 64 tile):
//  * ssd_wide_states: S_in of every chunk (forward) and dS_out (backward),
//    one CTA per (64 x 64 state tile, batch, head, direction) walking the
//    chunks in order.  A state column depends on its own column of v (or
//    dO) only, so the [N, P_e] state splits into tiles with no exchange.
//  * ssd_wide_grads: one CTA per (64 rows of a chunk, chunk, batch, head,
//    gradient), the gradient one of dq, dk, dv.  Its 64 output rows, all
//    N (or P) columns, sit in shared memory, so the sums over P that dq and
//    dk need (the score dO v^T, and dO S_in^T) are whole inside the CTA and
//    no partial sum crosses CTAs.  The score tiles are gated in float32
//    and never rounded.  dq and dk also store q_t . dq_t and k_t . dk_t
//    for da.
//  * ssd_wide_da: one CTA per (batch, head), the reverse sums in segments
//    of 256 with a fixed-order tree (Hillis-Steele) inside each.
// Every output element is written once by one thread and every sum runs in
// a fixed order: no atomics, the same bits on every run.
//
// Bound on an H100 at xlstm-350m's training shape (q, k, v, dO [4, 1024,
// 4, 256] bf16, chunk 256, the normaliser): q, k, v and dO read and dq,
// dk, dv written once, about 59 MB, take 17.5 us; the in-chunk and state
// products, about 1.6e10 FLOP, 16.4 us at the bf16 tensor-core rate:
// bound by bytes, barely.  This kernel runs the products on the CUDA
// cores (67 TFLOP/s float32 at best), so it sits far above that bound;
// moving them onto wgmma, as ssd_scan_bwd.cu does for N, P <= 64, is
// later work.  It takes N, P <= 256 and chunks <= 256 rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__device__ __forceinline__ float at(const void* p, const long long* s, int b,
                                    int t, int h, int col) {
  return to_f(static_cast<const T*>(p)[b * s[0] + t * s[1] + h * s[2] + col]);
}

// Element (b, t, h, col) of q, k, v or dO; v's column P is the normaliser's
// 1 and dO's its dden (when Pe > P); 0 past the operand's width.
template <typename T>
__device__ __forceinline__ float operand(const Args& g, int op, int b, int t,
                                         int h, int col) {
  switch (op) {
    case kQ: return col < g.N ? at<T>(g.q, g.qs, b, t, h, col) : 0.f;
    case kK: return col < g.N ? at<T>(g.k, g.ks, b, t, h, col) : 0.f;
    case kV:
      if (col < g.P) return at<T>(g.v, g.vs, b, t, h, col);
      return col < g.Pe ? 1.f : 0.f;
    default:
      if (col < g.P) return at<T>(g.dO, g.dos, b, t, h, col);
      return col < g.Pe ? at<T>(g.dden, g.ds, b, t, h, 0) : 0.f;
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
template <typename T>
__device__ void load_tile(float* dst, const Args& g, int op, int b, int h,
                          int t0, int nr, int col0, int width,
                          const float* scale = nullptr) {
  for (int e = threadIdx.x; e < kT * kT; e += kThreads) {
    const int r = e / kT, c = e % kT;
    float x = 0.f;
    if (r < nr && col0 + c < width) {
      x = operand<T>(g, op, b, t0 + r, h, col0 + c);
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
template <typename T>
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
      load_tile<T>(sX, g, fwd ? kK : kQ, b, h, c0 + r0, nr, n0, g.N, sW);
      load_tile<T>(sY, g, fwd ? kV : kDO, b, h, c0 + r0, nr, p0, g.Pe);
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
template <typename T>
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
      load_tile<T>(sX, g, opX, b, h, c0 + i0, ni, d0, D);
      load_tile<T>(sY, g, opY, b, h, c0 + j0, nj, d0, D);
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
      load_tile<T>(sX, g, opZ, b, h, c0 + j0, nj, w0, W);
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
      load_tile<T>(sX, g, opS, b, h, c0 + i0, ni, d0, D);
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
  T* out = static_cast<T*>(mode == 0 ? g.dq : mode == 1 ? g.dk : g.dv);
  for (int e = tid; e < ni * W; e += kThreads) {
    const int i = e / W, w = e % W;
    out[(row0 + (long long)i * g.H) * W + w] = from_f<T>(sAcc[i * ldw + w]);
  }
  if (mode < 2 && tid < ni) {                 // q_t . dq_t, k_t . dk_t
    float r = 0.f;
    for (int n = 0; n < g.N; ++n)
      r += operand<T>(g, mode == 0 ? kQ : kK, b, c0 + i0 + tid, h, n) *
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

template <typename T>
int launch(const Args& g, cudaStream_t stream) {
  const size_t gs = grads_smem(g.N, g.P);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_wide_grads<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)gs);
  if (err != cudaSuccess) return (int)err;
  const int bh = g.B * g.H;
  const int tiles = ((g.N + kT - 1) / kT) * ((g.Pe + kT - 1) / kT);
  ssd_wide_states<T><<<dim3(tiles * bh, 2), kThreads, states_smem(),
                       stream>>>(g);
  const int nt = (g.chunk + kT - 1) / kT;
  ssd_wide_grads<T><<<dim3(nt * g.nc * bh, 3), kThreads, gs, stream>>>(g);
  ssd_wide_da<<<bh, kThreads, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_wide_bwd_max_np() { return kMaxNP; }
extern "C" int ssd_wide_bwd_max_chunk() { return kMaxChunk; }

// The float32 workspace, in values: the two [B, H, nc, N, P (+1 with the
// normaliser)] state stacks and two [B, H, L] rows.
extern "C" long long ssd_wide_bwd_ws_floats(int B, int L, int H, int N,
                                            int P, int chunk, int norm) {
  const long long bh = (long long)B * H, nc = L / chunk;
  return 2 * bh * nc * N * (P + (norm ? 1 : 0)) + 2 * bh * L;
}

// dtype: 0 float32, 1 bfloat16 (q, k, v, dO, dden, dq, dk, dv; a and da
// are float32).  Strides in elements, three per input (batch, sequence,
// head), in the order q, k, v, dO, a, dden (dden null without the
// normaliser); dq, dk, dv and da are new contiguous tensors; ws holds
// ssd_wide_bwd_ws_floats values.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for inputs the
// kernel does not take).
extern "C" int ssd_wide_bwd_launch(
    const void* q, const void* k, const void* v, const void* dO,
    const float* a, const void* dden, void* dq, void* dk, void* dv,
    float* da, float* ws, int dtype, int B, int L, int H, int N, int P,
    int chunk, const long long* qs, const long long* ks, const long long* vs,
    const long long* dos, const long long* as, const long long* ds,
    void* stream) {
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
  const long long bh = (long long)B * H;
  g.S = ws;
  g.dS = ws + bh * g.nc * N * g.Pe;
  g.rq = g.dS + bh * g.nc * N * g.Pe;
  g.rk = g.rq + bh * L;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = qs[i];
    g.ks[i] = ks[i];
    g.vs[i] = vs[i];
    g.dos[i] = dos[i];
    g.as[i] = as[i];
    g.ds[i] = dden ? ds[i] : 0;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(g, s) : launch<float>(g, s);
}
