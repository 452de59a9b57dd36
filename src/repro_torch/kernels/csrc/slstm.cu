// slstm: the xLSTM scalar-memory recurrence over a sequence, forward
// (slstm_fwd) and backward (slstm_bwd).
//
// New in the port: the TPU package has no Pallas kernel for it; its sLSTM
// is a lax.scan of `_slstm_cell` (src/repro/models/blocks.py:333; the scan
// in slstm_apply at :369), differentiated by jax.grad.  Per (batch, head),
// with carry (c, n, h, m) of dh units each, position t:
//
//   g = (gx_t + h r).float()        (h r and the sum rounded to h's type)
//   z, i, f, o = split(g, 4);  lf = log sigmoid(f) = -softplus(-f)
//   m' = max(lf + m, i);  i' = exp(i - m');  f' = exp(lf + m - m')
//   c' = f' c + i' tanh(z);  n' = f' n + i'
//   h' = (sigmoid(o) c' / max(n', 1)) rounded to h's type
//
// r is [H, dh, 4 dh]: at xlstm-350m's width (dh = 256) a head's r is
// 512 KB of bf16, more than one SM's shared memory, and every position
// needs all of it.  So a head runs on a cluster of 8 CTAs, each holding
// the r columns of its dh / 8 units' four gates in shared memory (64 KB in
// bf16) for the whole sequence.  Each step a CTA multiplies the previous h
// (all dh units, every batch row of its tile, in its own shared memory) by
// its columns, finishes its units' cells, and writes its units' new h into
// every CTA's shared memory of the cluster (distributed shared memory);
// one cluster barrier a step orders the hand-off, h double buffered.  A
// cluster takes a tile of 4 batch rows (8 for batches over 4); more rows
// take more clusters.  In the product each thread sums a quarter of the
// rows of r for two columns and every row of the tile (16 sums in flight
// at 8 rows), the four quarters then added in order.
//
// Backward, from the last position down: each CTA's units take dh (the
// output's gradient plus the recurrent one, summed in h's type as autograd
// sums them), rebuild the step from the saved gate inputs g and the
// previous position's saved c, n, m, and form dg, which is dgx (rounded to
// gx's type, as autograd's cast does) and d(h r).  The recurrent gradient
// dh_{t-1} = dg r^T sums over all 4 dh columns, which the 8 CTAs split:
// each CTA writes its partial for every unit into its own shared memory,
// the cluster synchronises, and each unit's owner adds the 8 partials in
// rank order.  dr = sum_t h_{t-1}^T dg_t is one batched matrix product
// after the kernel (the wrapper's).  The maximum's gradient splits a tie
// in half (torch.maximum's and jnp.maximum's rule); max(n', 1) passes the
// whole gradient at n' == 1 (torch.clamp_min's rule, which the plain
// version takes; jnp.maximum would pass half, and the two cancel to
// rounding: ROADMAP.md, traps).  float32 inside; no atomics, every sum in
// a fixed order: the same bits on every run.
//
// Bound on an H100 at xlstm-350m's training shape (gx [4, 1024, 4, 1024]
// bf16, r [4, 256, 1024], dh 256): the forward's 4.3e9 multiply-adds are
// 8.7 us at the bf16 tensor-core rate, and its bytes (gx read, ys written,
// r read once, 44 MB) 13 us: bound by bytes.  What holds the kernel is the
// chain of 1 024 dependent steps, each a 256-deep product per gate, a
// cluster barrier and a distributed-shared-memory exchange; the backward
// adds one more product and exchange a step.  It takes dh <= 256.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;           // CTAs of a head
constexpr int kThreads = 256;
constexpr int kMaxDh = 256;
constexpr int kMaxBt = 8;             // batch rows of a cluster

struct Args {
  const void* gx;                     // [B, L, H, 4 dh], strides gxs
  const void* r;                      // [H, dh, 4 dh]
  const float* c0;                    // carry in, [B, H, dh] each
  const float* n0;
  const void* h0;
  const float* m0;
  void* ys;                           // [B, L, H, dh]
  float* c1;                          // carry out
  float* n1;
  void* h1;
  float* m1;
  void* g;                            // saved [B, L, H, 4 dh] (or null)
  float* cs;                          // saved [B, L, H, dh] (or null)
  float* ns;
  float* ms;
  const void* dys;                    // backward: [B, L, H, dh] (or null)
  const float* dc1;                   // the carry out's gradients (or null)
  const float* dn1;
  const void* dh1;
  const float* dm1;
  void* dgx;                          // [B, L, H, 4 dh]
  float* dc0;                         // the carry in's gradients
  float* dn0;
  void* dh0;
  float* dm0;
  int B, L, H, dh, U, Bt;
  long long gxs[3];
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
// a float rounded to T and back
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// two adjacent entries of a row of r, as float (bf16: one 4-byte load)
__device__ __forceinline__ void pair(const float* p, float& a, float& b) {
  a = p[0];
  b = p[1];
}
__device__ __forceinline__ void pair(const __nv_bfloat16* p, float& a,
                                     float& b) {
  const float2 f =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  a = f.x;
  b = f.y;
}

__device__ __forceinline__ float softplus(float x) {  // jax.nn.softplus's form
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// One cell: the gate inputs z, i, f, o (float32, already rounded as the
// reference rounds them) and the carry c, n, m; what the backward reuses.
struct Cell {
  float lfm, m2, ip, fp, tz, c2, n2, so, hv;
};

__device__ __forceinline__ Cell cell(const float pre[4], float c, float n,
                                     float m) {
  Cell s;
  const float lf = -softplus(-pre[2]);
  s.lfm = lf + m;
  s.m2 = fmaxf(s.lfm, pre[1]);
  s.ip = expf(pre[1] - s.m2);
  s.fp = expf(s.lfm - s.m2);
  s.tz = tanhf(pre[0]);
  s.c2 = s.fp * c + s.ip * s.tz;
  s.n2 = s.fp * n + s.ip;
  s.so = sigmoid(pre[3]);
  s.hv = s.so * s.c2 / fmaxf(s.n2, 1.f);
  return s;
}

struct Tile {                          // this CTA's place in the grid
  int h, b0, nb, u0, nu, rank;
};

__device__ __forceinline__ Tile tile_of(const Args& g, unsigned rank) {
  Tile t;
  const int cid = blockIdx.x / kCluster;
  t.rank = (int)rank;
  t.h = cid % g.H;
  t.b0 = (cid / g.H) * g.Bt;
  t.nb = min(g.Bt, g.B - t.b0);
  t.u0 = t.rank * g.U;
  t.nu = max(0, min(g.U, g.dh - t.u0));
  return t;
}

// This CTA's columns of r (its units' four gates, local column q U + u),
// row pitch `pitch`, zero for units past dh
template <typename T>
__device__ void load_r(T* rs, const Args& g, const Tile& tl, int pitch) {
  const int C = 4 * g.U, dh = g.dh;
  const T* R = static_cast<const T*>(g.r) + (long long)tl.h * dh * 4 * dh;
  for (int e = threadIdx.x; e < dh * C; e += kThreads) {
    const int d = e / C, lc = e % C, q = lc / g.U, u = lc % g.U;
    rs[d * pitch + lc] =
        u < tl.nu ? R[(long long)d * 4 * dh + q * dh + tl.u0 + u]
                  : from_f<T>(0.f);
  }
}

// grid (8 x H x batch tiles of NB rows), clusters of 8: the recurrence
// forward
template <typename T, int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    slstm_fwd(Args g) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile tl = tile_of(g, cluster.block_rank());
  const int tid = threadIdx.x, U = g.U, C = 4 * U, dh = g.dh;
  float* hb = reinterpret_cast<float*>(smem4);  // 2 x [dh][NB]: h before
  float* red = hb + 2 * dh * NB;                // [parts][NB][C]
  float* grs = red + 2 * kThreads * NB;         // [NB][C]: h r
  T* rs = reinterpret_cast<T*>(grs + NB * C);   // [dh][C]
  load_r(rs, g, tl, C);
  for (int e = tid; e < 2 * dh * NB; e += kThreads) {
    const int d = e / NB, bl = e % NB;         // rows past nb stay zero
    hb[e] = d < dh && bl < tl.nb
                ? to_f(static_cast<const T*>(g.h0)[
                      ((long long)(tl.b0 + bl) * g.H + tl.h) * dh + d])
                : 0.f;
  }
  // the thread that owns unit (batch row obl, unit ou) keeps its carry
  const int obl = tid / U, ou = tid % U, uu = tl.u0 + ou;
  const bool owner = tid < tl.nb * U && ou < tl.nu;
  const long long oi = ((long long)(tl.b0 + obl) * g.H + tl.h) * dh + uu;
  float c = 0.f, n = 0.f, m = 0.f;
  T hl = from_f<T>(0.f);
  if (owner) {
    c = g.c0[oi];
    n = g.n0[oi];
    m = g.m0[oi];
    hl = static_cast<const T*>(g.h0)[oi];
  }
  // h r: thread (pp, cp) sums rows [d_lo, d_hi) of columns 2 cp, 2 cp + 1
  // for all NB batch rows (16 independent sums in flight at NB = 8)
  const int CP = C / 2, parts = kThreads / CP, cp = tid % CP, pp = tid / CP;
  const int dlen = (dh + parts - 1) / parts;
  const int d_lo = min(dh, pp * dlen), d_hi = min(dh, d_lo + dlen);
  cluster.sync();                     // every CTA of the cluster running
  for (int t = 0; t < g.L; ++t) {
    const float* hc = hb + (t & 1) * dh * NB;
    const long long row = ((long long)(tl.b0 + obl) * g.L + t) * g.H + tl.h;
    float gxv[4];                     // this position's gx, loaded early
    if (owner) {
      const T* gxp = static_cast<const T*>(g.gx) + (tl.b0 + obl) * g.gxs[0] +
                     t * g.gxs[1] + tl.h * g.gxs[2];
#pragma unroll
      for (int q = 0; q < 4; ++q) gxv[q] = to_f(gxp[q * dh + uu]);
    }
    if (pp < parts) {
      float acc[NB][2];
#pragma unroll
      for (int bl = 0; bl < NB; ++bl) acc[bl][0] = acc[bl][1] = 0.f;
#pragma unroll 4
      for (int d = d_lo; d < d_hi; ++d) {
        float r0, r1;
        pair(rs + d * C + 2 * cp, r0, r1);
        const float4* hv = reinterpret_cast<const float4*>(hc + d * NB);
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
          const float4 h4 = hv[q];
          const float h[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * q + j][0] += h[j] * r0;
            acc[4 * q + j][1] += h[j] * r1;
          }
        }
      }
#pragma unroll
      for (int bl = 0; bl < NB; ++bl)
        *reinterpret_cast<float2*>(red + (pp * NB + bl) * C + 2 * cp) =
            make_float2(acc[bl][0], acc[bl][1]);
    }
    __syncthreads();
    for (int e = tid; e < tl.nb * C; e += kThreads) {
      const int bl = e / C, l = e % C;
      float s = 0.f;
      for (int q = 0; q < parts; ++q) s += red[(q * NB + bl) * C + l];
      grs[bl * C + l] = s;
    }
    __syncthreads();
    if (owner) {
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)      // gx + (h r rounded), rounded
        pre[q] = round_to<T>(gxv[q] + round_to<T>(grs[obl * C + q * U + ou]));
      const Cell s = cell(pre, c, n, m);
      c = s.c2;
      n = s.n2;
      m = s.m2;
      hl = from_f<T>(s.hv);
      static_cast<T*>(g.ys)[row * dh + uu] = hl;
      if (g.g) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          static_cast<T*>(g.g)[row * 4 * dh + q * dh + uu] = from_f<T>(pre[q]);
        g.cs[row * dh + uu] = c;
        g.ns[row * dh + uu] = n;
        g.ms[row * dh + uu] = m;
      }
      const float hf = to_f(hl);
      float* nxt = hb + ((t + 1) & 1) * dh * NB + uu * NB + obl;
      for (int k = 0; k < kCluster; ++k) *cluster.map_shared_rank(nxt, k) = hf;
    }
    cluster.sync();
  }
  if (owner) {
    g.c1[oi] = c;
    g.n1[oi] = n;
    g.m1[oi] = m;
    static_cast<T*>(g.h1)[oi] = hl;
  }
}

// grid as the forward's: the recurrence backward
template <typename T, int NB>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
    slstm_bwd(Args g) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile tl = tile_of(g, cluster.block_rank());
  const int tid = threadIdx.x, U = g.U, C = 4 * U, dh = g.dh;
  // row pitch of r: an odd number of 32-bit words, so the threads of a
  // warp (one row each) read distinct banks
  const int pitch = C + (sizeof(T) == 2 ? 2 : 1);
  float* pbuf = reinterpret_cast<float*>(smem4);  // 2 x [NB][dh] partials
  float* dgs = pbuf + 2 * NB * dh;                // [C][NB]: this step's dg
  T* rs = reinterpret_cast<T*>(dgs + C * NB);     // [dh][pitch]
  load_r(rs, g, tl, pitch);
  for (int e = tid; e < C * NB; e += kThreads) dgs[e] = 0.f;
  const int obl = tid / U, ou = tid % U, uu = tl.u0 + ou;
  const bool owner = tid < tl.nb * U && ou < tl.nu;
  const long long oi = ((long long)(tl.b0 + obl) * g.H + tl.h) * dh + uu;
  float dc = 0.f, dn = 0.f, dm = 0.f, dhr = 0.f;  // dhr: h's type's values
  if (owner) {
    if (g.dc1) dc = g.dc1[oi];
    if (g.dn1) dn = g.dn1[oi];
    if (g.dm1) dm = g.dm1[oi];
    if (g.dh1) dhr = to_f(static_cast<const T*>(g.dh1)[oi]);
  }
  cluster.sync();
  for (int t = g.L - 1; t >= 0; --t) {
    if (owner) {
      const long long row = ((long long)(tl.b0 + obl) * g.L + t) * g.H + tl.h;
      const float dy =
          g.dys ? to_f(static_cast<const T*>(g.dys)[row * dh + uu]) : 0.f;
      const float dhf = round_to<T>(dy + dhr);
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = to_f(static_cast<const T*>(g.g)[row * 4 * dh + q * dh + uu]);
      float cp, np, mp;                // the carry entering position t
      if (t > 0) {
        const long long prev = (row - g.H) * dh + uu;
        cp = g.cs[prev];
        np = g.ns[prev];
        mp = g.ms[prev];
      } else {
        cp = g.c0[oi];
        np = g.n0[oi];
        mp = g.m0[oi];
      }
      const Cell s = cell(pre, cp, np, mp);
      // h' = (so c') / den, den = max(n', 1)
      const float den = fmaxf(s.n2, 1.f);
      const float dA = dhf / den;
      const float dden = -dhf * ((s.so * s.c2 / den) / den);
      const float dn2 = dn + (s.n2 >= 1.f ? dden : 0.f);
      const float dc2 = dc + dA * s.so;
      const float dso = dA * s.c2;
      const float d_o = dso * (1.f - s.so) * s.so;
      // c' = f' c + i' tz, n' = f' n + i'
      const float dfp = dc2 * cp + dn2 * np;
      const float dip = dc2 * s.tz + dn2;
      const float dz = dc2 * s.ip * (1.f - s.tz * s.tz);
      const float dxi = dip * s.ip;    // of i - m'
      const float dxf = dfp * s.fp;    // of lf + m - m'
      const float dm2 = dm - dxi - dxf;
      // m' = max(lf + m, i): a tie splits the gradient in half
      float dlfm = dxf, di = dxi;
      if (s.lfm > pre[1]) {
        dlfm += dm2;
      } else if (s.lfm < pre[1]) {
        di += dm2;
      } else {
        dlfm += 0.5f * dm2;
        di += 0.5f * dm2;
      }
      // lf = -softplus(-f), softplus(x) = max(x, 0) + log1p(exp(-|x|))
      const float x = -pre[2], dsp = -dlfm;
      const float e = expf(-fabsf(x));
      const float dabs = -((dsp / (1.f + e)) * e);
      const float sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
      const float df = -(dsp * (x >= 0.f ? 1.f : 0.f) + dabs * sgn);
      const float dg[4] = {dz, di, df, d_o};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T gt = from_f<T>(dg[q]);
        static_cast<T*>(g.dgx)[row * 4 * dh + q * dh + uu] = gt;
        dgs[(q * U + ou) * NB + obl] = to_f(gt);
      }
      dc = dc2 * s.fp;
      dn = dn2 * s.fp;
      dm = dlfm;
    }
    __syncthreads();
    // this CTA's part of dg r^T for every unit d of every batch row, two
    // columns a step
    float* mine = pbuf + (t & 1) * NB * dh;
    for (int d = tid; d < dh; d += kThreads) {
      float acc[NB];
#pragma unroll
      for (int bl = 0; bl < NB; ++bl) acc[bl] = 0.f;
      const T* rr = rs + d * pitch;
#pragma unroll 4
      for (int l = 0; l < C; l += 2) {
        float r0, r1;
        pair(rr + l, r0, r1);
        const float4* g0 = reinterpret_cast<const float4*>(dgs + l * NB);
        const float4* g1 = reinterpret_cast<const float4*>(dgs + (l + 1) * NB);
#pragma unroll
        for (int q = 0; q < NB / 4; ++q) {
          const float4 a = g0[q], b = g1[q];
          const float x0[4] = {a.x, a.y, a.z, a.w};
          const float x1[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[4 * q + j] += x0[j] * r0;
            acc[4 * q + j] += x1[j] * r1;
          }
        }
      }
#pragma unroll
      for (int bl = 0; bl < NB; ++bl)
        if (bl < tl.nb) mine[bl * dh + d] = acc[bl];
    }
    cluster.sync();
    if (owner) {                       // the 8 parts in rank order
      float s = 0.f;
      for (int k = 0; k < kCluster; ++k)
        s += *cluster.map_shared_rank(mine + obl * dh + uu, k);
      dhr = round_to<T>(s);
    }
  }
  cluster.sync();                      // no CTA leaves while read remotely
  if (owner) {
    g.dc0[oi] = dc;
    g.dn0[oi] = dn;
    g.dm0[oi] = dm;
    static_cast<T*>(g.dh0)[oi] = from_f<T>(dhr);
  }
}

template <int NB>
size_t fwd_smem(const Args& g, size_t es) {
  const int C = 4 * g.U;
  return sizeof(float) * (2 * g.dh * NB + 2 * kThreads * NB + NB * C) +
         es * g.dh * C;
}

template <int NB>
size_t bwd_smem(const Args& g, size_t es) {
  const int C = 4 * g.U;
  return sizeof(float) * (2 * NB * g.dh + C * NB) +
         es * g.dh * (C + (es == 2 ? 2 : 1));
}

template <typename T, int NB>
int launch(const Args& g, bool backward, cudaStream_t stream) {
  const size_t smem = backward ? bwd_smem<NB>(g, sizeof(T))
                               : fwd_smem<NB>(g, sizeof(T));
  const int tiles = (g.B + NB - 1) / NB;
  const dim3 grid(kCluster * g.H * tiles);
  cudaError_t err;
  if (backward) {
    err = cudaFuncSetAttribute(slstm_bwd<T, NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    slstm_bwd<T, NB><<<grid, kThreads, smem, stream>>>(g);
  } else {
    err = cudaFuncSetAttribute(slstm_fwd<T, NB>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    slstm_fwd<T, NB><<<grid, kThreads, smem, stream>>>(g);
  }
  return (int)cudaGetLastError();
}

// batch tiles of 4 rows for up to 4 rows, else of 8
template <typename T>
int launch(const Args& g, bool backward, cudaStream_t stream) {
  return g.Bt == 4 ? launch<T, 4>(g, backward, stream)
                   : launch<T, 8>(g, backward, stream);
}

int checked(Args& g, int dtype, int B, int L, int H, int dh) {
  if (dh < 1 || dh > kMaxDh || B < 1 || H < 1 || L < 0 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  g.B = B;
  g.L = L;
  g.H = H;
  g.dh = dh;
  g.U = (dh + kCluster - 1) / kCluster;   // <= 32: 8 rows x U <= kThreads
  g.Bt = B <= 4 ? 4 : kMaxBt;
  return 0;
}

}  // namespace

extern "C" int slstm_max_dh() { return kMaxDh; }

// dtype: 0 float32, 1 bfloat16 (gx, r, h0, ys, h1, g; c, n, m float32).
// gx has its own batch, sequence and head strides (elements, last
// dimension contiguous); everything else is contiguous.  g, cs, ns, ms:
// the backward's saved values ([B, L, H, 4 dh] gate inputs in gx's type,
// [B, L, H, dh] float32 carries after each position), or all null.
// Launches on `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for inputs the kernel does not take).
extern "C" int slstm_fwd_launch(
    const void* gx, const void* r, const float* c0, const float* n0,
    const void* h0, const float* m0, void* ys, float* c1, float* n1,
    void* h1, float* m1, void* gsave, float* cs, float* ns, float* ms,
    int dtype, int B, int L, int H, int dh, const long long* gxs,
    void* stream) {
  Args g = {};
  const int err = checked(g, dtype, B, L, H, dh);
  if (err) return err;
  g.gx = gx;
  g.r = r;
  g.c0 = c0;
  g.n0 = n0;
  g.h0 = h0;
  g.m0 = m0;
  g.ys = ys;
  g.c1 = c1;
  g.n1 = n1;
  g.h1 = h1;
  g.m1 = m1;
  g.g = gsave;
  g.cs = cs;
  g.ns = ns;
  g.ms = ms;
  for (int i = 0; i < 3; ++i) g.gxs[i] = gxs[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(g, false, s)
                    : launch<float>(g, false, s);
}

// The backward: g, cs, ns, ms as the forward saved them, the carry in (c0,
// n0, m0), the gradients of ys and of the carry out (each may be null:
// zero); writes dgx (gx's type, contiguous [B, L, H, 4 dh]) and the carry
// in's gradients.  dtype and the return as slstm_fwd_launch's.
extern "C" int slstm_bwd_launch(
    const void* gsave, const void* r, const float* c0, const float* n0,
    const float* m0, const float* cs, const float* ns, const float* ms,
    const void* dys, const float* dc1, const float* dn1, const void* dh1,
    const float* dm1, void* dgx, float* dc0, float* dn0, void* dh0,
    float* dm0, int dtype, int B, int L, int H, int dh, void* stream) {
  Args g = {};
  const int err = checked(g, dtype, B, L, H, dh);
  if (err) return err;
  g.g = const_cast<void*>(gsave);
  g.r = r;
  g.c0 = c0;
  g.n0 = n0;
  g.m0 = m0;
  g.cs = const_cast<float*>(cs);
  g.ns = const_cast<float*>(ns);
  g.ms = const_cast<float*>(ms);
  g.dys = dys;
  g.dc1 = dc1;
  g.dn1 = dn1;
  g.dh1 = dh1;
  g.dm1 = dm1;
  g.dgx = dgx;
  g.dc0 = dc0;
  g.dn0 = dn0;
  g.dh0 = dh0;
  g.dm0 = dm0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(g, true, s)
                    : launch<float>(g, true, s);
}
