// flash_attention_bwd: the gradient of flash_attention (the training mask).
//
// New in the port: the TPU package has no backward Pallas kernel; it
// differentiates the model layer's `_sdpa` (src/repro/models/layers.py:94)
// with jax.grad.  This kernel computes that gradient for the forward of
// flash_attention.cu with q_offset = 0 and kv_len = Skv (causal: query row
// i sees kv rows j <= i; or no mask).  Per query head, in float32:
//
//   P     = exp(q k^T * scale - lse)        lse: the row's log-sum-exp
//                                           (bf16: the forward kernel's;
//                                           float32: a first pass here)
//   delta = rowsum(dO * O)
//   dS    = P * (dO V^T - delta)
//   dQ    = dS K * scale,  dK = dS^T Q * scale,  dV = P^T dO
//
// Query head h reads kv head h / (Hq / Hkv); dK and dV of a kv head sum
// the group's query heads in a fixed order.  No atomics: every output
// element is written once by one thread, so the result is the same on
// every run.
//
// Layout: q, o, dO, dQ [B, Sq, Hq, D], k, v, dK, dV [B, Skv, Hkv, D], each
// with its own batch, head and sequence strides and a contiguous last
// dimension.  bf16 or float32 in, the same type out; float32 inside.
//
// Two kernels, one after the other on the stream, in two forms.
//
// bf16 (the training path; strides and pointers that allow TMA, else the
// call is refused): Hopper's tensor cores through wgmma (bf16 in, float32
// sums) on tiles that TMA brings through a ring of shared-memory stages
// (full / empty mbarriers; a producer warpgroup whose one thread issues
// the loads, two consumer warpgroups of 64 rows each), with the shared
// pieces of the forward (hopper.cuh: tensor maps, descriptors, the wgmma
// wrappers; a head dim over 64 as two 128B-swizzled boxes, zero filled).
// Both kernels are persistent (a CTA an SM walking its items), so an
// item's stores overlap the next item's loads.  Seven products of the
// (query, key) tiles where the first design made eleven:
//  * attn_bwd_dq_wgmma, per (batch, query head, 128 query rows): Q and dO
//    once, K and V in 64-row tiles through the ring; S = Q K^T and
//    dP = dO V^T from shared memory, P = 2^(S c - lse log2 e) with the
//    row log-sum-exp the forward kernel wrote beside its output (no
//    statistics pass), dS = P (dP - delta) in registers, and dQ += dS K
//    with dS as the register A operand.  delta = rowsum(dO O) is the
//    item's prologue, stored for the second kernel.
//  * attn_bwd_dkv_wgmma, per (batch, kv head, 128 kv rows): K and V once;
//    for each query head of the group and each 64-row query tile that can
//    see the block (causal: from the block's first row on), Q, dO and the
//    tile's lse and delta through the ring; S^T = K Q^T and dP^T = V dO^T,
//    P^T and dS^T in registers with kv rows, and dV += P^T dO,
//    dK += dS^T Q with P^T and dS^T as register A operands (dO and Q read
//    MN-major): no shared-memory round trip.
//  Each kernel issues the next tile's score products with this tile's
//  gradient products (one wgmma group, one wait).  P and dS are rounded
//  to bf16 once, as SDPA's backward and the reference's bf16 `_sdpa`
//  gradient do: the hi / lo split of the first design is gone, and every
//  bf16 case of chip_smoke.py's sweep and of the `cuda` tests (zamba2's
//  shape, GQA at D = 128, Sq != Skv at the VLM's cross shape) stays
//  within 2e-2 of the plain version.  No atomics: every output element is
//  written once by one thread, the same bits on every run.
//
// float32 (the parity path): the CUDA cores, one block of 256 threads per
// 64 rows, tiles of 64 x D float32 (rows padded by one float), each thread
// a 4 x 4 micro-tile of a 64 x 64 score tile or D / 4 output columns of one
// row (attn_bwd_dq, which takes the rows' lse in a first pass, and
// attn_bwd_dkv).
//
// Bound on an H100 at the training shape (zamba2-2.7b's shared attention:
// B = 4, S = 1024, 32 heads, D = 80, causal, bf16): five S x S x D
// products over the causal half, 4 * 5 * B * H * D * S^2 / 2 = 5.4e10
// FLOP (55 us at 989 TFLOP/s bf16), and q, k, v, o, dO read and dQ, dK,
// dV written once, 168 MB (50 us at 3.35 TB/s): bound by operations.
// What holds the kernels from it now is not the products but what
// surrounds them: with the products taken out
// (scripts/bwd_kernel_ablation.py; PERF.md has the numbers), a kernel
// keeps most of its time in its loads, barriers and per-element work, at
// two consumer warpgroups an SM (shared memory, 195 KB a CTA at D = 80
// with its zero-filled second box, allows one CTA an SM).
#include "hopper.cuh"

namespace {

constexpr int kMaxD = 128;
constexpr int kThreads = 256;
constexpr int kB = 64;               // rows of a query tile and a kv tile
constexpr int kLd = kB + 1;          // row pitch of a score tile
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  void* dq;
  void* dk;
  void* dv;
  float* lse;                        // [B, Hq, Sq]
  float* delta;                      // [B, Hq, Sq]
  int B, Hq, Hkv, Sq, Skv, D;
  // batch, head, sequence strides (elements)
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int causal;
  float scale;
};

// n rows (sequence stride rs) of D values into a 64-row tile (pitch D + 1),
// zeros past n.
__device__ void load_tile(float* dst, const float* src, long long rs, int n,
                          int D) {
  for (int e = threadIdx.x; e < kB * D; e += kThreads) {
    const int r = e / D, d = e % D;
    dst[r * (D + 1) + d] = r < n ? src[r * rs + d] : 0.f;
  }
}

// s[jr][ic] = a[rg + 16 jr] . b[cg + 16 ic] over D (rg = tid / 16,
// cg = tid % 16): a 4 x 4 micro-tile of the 64 x 64 product a b^T.
__device__ __forceinline__ void tile_dot(const float* a, const float* b,
                                         int D, float s[4][4]) {
  const int rg = threadIdx.x / 16, cg = threadIdx.x % 16;
  const int ldd = D + 1;
#pragma unroll
  for (int jr = 0; jr < 4; ++jr)
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) s[jr][ic] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) av[jr] = a[(rg + 16 * jr) * ldd + d];
#pragma unroll
    for (int ic = 0; ic < 4; ++ic) bv[ic] = b[(cg + 16 * ic) * ldd + d];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) s[jr][ic] += av[jr] * bv[ic];
  }
}

// over the 16 threads that share a micro-tile row (one half of a warp)
__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(const Args& a, int qpos, int kpos) {
  return kpos < a.Skv && (!a.causal || kpos <= qpos);
}

size_t smem_bytes(int D, int score_tiles) {
  return sizeof(float) *
         ((size_t)4 * kB * (D + 1) + (size_t)score_tiles * kB * kLd + 2 * kB);
}

__global__ void __launch_bounds__(kThreads) attn_bwd_dq(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ldd = D + 1;
  float* sQ = smem;                  // 64 x ldd
  float* sDO = sQ + kB * ldd;
  float* sK = sDO + kB * ldd;
  float* sV = sK + kB * ldd;
  float* sG = sV + kB * ldd;         // 64 x kLd: dS
  float* sLse = sG + kB * kLd;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * kB;
  const int nq = min(kB, a.Sq - q0);
  const float* Q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1] +
                   q0 * a.qs[2];
  const float* O = static_cast<const float*>(a.o) + b * a.os[0] + h * a.os[1] +
                   q0 * a.os[2];
  const float* DO = static_cast<const float*>(a.dO) + b * a.dos[0] +
                    h * a.dos[1] + q0 * a.dos[2];
  const float* K = static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* V = static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  const long long stat0 = ((long long)b * a.Hq + h) * a.Sq + q0;

  load_tile(sQ, Q, a.qs[2], nq, D);
  load_tile(sDO, DO, a.dos[2], nq, D);
  __syncthreads();

  // delta: row ro, columns co + 4 i, summed over the row's four threads
  const int ro = tid / 4, co = tid % 4;
  {
    float part = 0.f;
    if (ro < nq)
      for (int d = co; d < D; d += 4)
        part += sDO[ro * ldd + d] * O[ro * a.os[2] + d];
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    if (co == 0) sDelta[ro] = part;
  }

  const int kv_end = a.causal ? min(a.Skv, q0 + nq) : a.Skv;
  const int rg = tid / 16, cg = tid % 16;
  float s[4][4], dp[4][4];

  // pass 1: each row's max and sum of exp over the visible kv positions
  float m[4], l[4];
#pragma unroll
  for (int jr = 0; jr < 4; ++jr) {
    m[jr] = kNegInf;
    l[jr] = 0.f;
  }
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();
    load_tile(sK, K + k0 * a.ks[2], a.ks[2], min(kB, a.Skv - k0), D);
    __syncthreads();
    tile_dot(sQ, sK, D, s);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int qpos = q0 + rg + 16 * jr;
      float tmax = kNegInf;
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const bool ok = visible(a, qpos, k0 + cg + 16 * ic);
        s[jr][ic] = ok ? s[jr][ic] * a.scale : kNegInf;
        tmax = fmaxf(tmax, s[jr][ic]);
      }
      const float mnew = fmaxf(m[jr], row_max16(tmax));
      float sum = 0.f;
#pragma unroll
      for (int ic = 0; ic < 4; ++ic)
        if (s[jr][ic] > 0.5f * kNegInf) sum += expf(s[jr][ic] - mnew);
      l[jr] = l[jr] * expf(m[jr] - mnew) + row_sum16(sum);
      m[jr] = mnew;
    }
  }
#pragma unroll
  for (int jr = 0; jr < 4; ++jr) {
    const int r = rg + 16 * jr;
    if (cg == 0) {
      const float lse = r < nq ? m[jr] + logf(l[jr]) : 0.f;
      sLse[r] = lse;
      if (r < nq) {
        a.lse[stat0 + r] = lse;
        a.delta[stat0 + r] = sDelta[r];
      }
    }
  }

  // pass 2: dS = P (dP - delta), dQ += dS K
  float acc[kMaxD / 4];
#pragma unroll
  for (int i = 0; i < kMaxD / 4; ++i) acc[i] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    const int nk = min(kB, a.Skv - k0);
    __syncthreads();
    load_tile(sK, K + k0 * a.ks[2], a.ks[2], nk, D);
    load_tile(sV, V + k0 * a.vs[2], a.vs[2], nk, D);
    __syncthreads();
    tile_dot(sQ, sK, D, s);
    tile_dot(sDO, sV, D, dp);
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int r = rg + 16 * jr;
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int c = cg + 16 * ic;
        float ds = 0.f;
        if (r < nq && visible(a, q0 + r, k0 + c)) {
          const float p = expf(s[jr][ic] * a.scale - sLse[r]);
          ds = p * (dp[jr][ic] - sDelta[r]);
        }
        sG[r * kLd + c] = ds;
      }
    }
    __syncthreads();
    const float* grow = sG + ro * kLd;
    for (int c = 0; c < nk; ++c) {
      const float g = grow[c];
      const float* krow = sK + c * ldd;
#pragma unroll
      for (int i = 0; i < kMaxD / 4; ++i) {
        const int d = co + 4 * i;
        if (d < D) acc[i] += g * krow[d];
      }
    }
  }
  if (ro < nq) {
    float* out = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                 (q0 + ro) * a.dqs[2];
#pragma unroll
    for (int i = 0; i < kMaxD / 4; ++i) {
      const int d = co + 4 * i;
      if (d < D) out[d] = acc[i] * a.scale;
    }
  }
}

__global__ void __launch_bounds__(kThreads) attn_bwd_dkv(Args a) {
  extern __shared__ float smem[];
  const int D = a.D, ldd = D + 1;
  float* sK = smem;                  // 64 x ldd
  float* sV = sK + kB * ldd;
  float* sQ = sV + kB * ldd;
  float* sDO = sQ + kB * ldd;
  float* sP = sDO + kB * ldd;        // 64 x kLd: P  (query rows x kv)
  float* sDS = sP + kB * kLd;        // 64 x kLd: dS
  float* sLse = sDS + kB * kLd;
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int k0 = blockIdx.x * kB;
  const int nk = min(kB, a.Skv - k0);
  load_tile(sK,
            static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1] +
                k0 * a.ks[2],
            a.ks[2], nk, D);
  load_tile(sV,
            static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1] +
                k0 * a.vs[2],
            a.vs[2], nk, D);

  const int rg = tid / 16, cg = tid % 16;
  const int ro = tid / 4, co = tid % 4;   // kv row ro, columns co + 4 i
  float acc_k[kMaxD / 4], acc_v[kMaxD / 4];
#pragma unroll
  for (int i = 0; i < kMaxD / 4; ++i) acc_k[i] = acc_v[i] = 0.f;
  float s[4][4], dp[4][4];

  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const float* Q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
    const float* DO = static_cast<const float*>(a.dO) + b * a.dos[0] +
                      h * a.dos[1];
    const long long stat0 = ((long long)b * a.Hq + h) * a.Sq;
    for (int q0 = a.causal ? k0 : 0; q0 < a.Sq; q0 += kB) {
      const int nq = min(kB, a.Sq - q0);
      __syncthreads();
      load_tile(sQ, Q + q0 * a.qs[2], a.qs[2], nq, D);
      load_tile(sDO, DO + q0 * a.dos[2], a.dos[2], nq, D);
      if (tid < kB) {
        sLse[tid] = tid < nq ? a.lse[stat0 + q0 + tid] : 0.f;
        sDelta[tid] = tid < nq ? a.delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      tile_dot(sQ, sK, D, s);
      tile_dot(sDO, sV, D, dp);
#pragma unroll
      for (int jr = 0; jr < 4; ++jr) {
        const int r = rg + 16 * jr;
#pragma unroll
        for (int ic = 0; ic < 4; ++ic) {
          const int c = cg + 16 * ic;
          float p = 0.f;
          if (r < nq && c < nk && visible(a, q0 + r, k0 + c))
            p = expf(s[jr][ic] * a.scale - sLse[r]);
          sP[r * kLd + c] = p;
          sDS[r * kLd + c] = p * (dp[jr][ic] - sDelta[r]);
        }
      }
      __syncthreads();
      for (int t = 0; t < nq; ++t) {
        const float pp = sP[t * kLd + ro], dd = sDS[t * kLd + ro];
        const float* dorow = sDO + t * ldd;
        const float* qrow = sQ + t * ldd;
#pragma unroll
        for (int i = 0; i < kMaxD / 4; ++i) {
          const int d = co + 4 * i;
          if (d < D) {
            acc_v[i] += pp * dorow[d];
            acc_k[i] += dd * qrow[d];
          }
        }
      }
    }
  }
  if (ro < nk) {
    float* dk = static_cast<float*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
                (k0 + ro) * a.dks[2];
    float* dv = static_cast<float*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
                (k0 + ro) * a.dvs[2];
#pragma unroll
    for (int i = 0; i < kMaxD / 4; ++i) {
      const int d = co + 4 * i;
      if (d < D) {
        dk[d] = acc_k[i] * a.scale;
        dv[d] = acc_v[i];
      }
    }
  }
}

int launch(const Args& a, cudaStream_t stream) {
  const size_t smem_dq = smem_bytes(a.D, 1), smem_dkv = smem_bytes(a.D, 2);
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_dkv);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq<<<dim3((a.Sq + kB - 1) / kB, a.B * a.Hq), kThreads,
                   smem_dq, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv<<<dim3((a.Skv + kB - 1) / kB, a.B * a.Hkv), kThreads,
                    smem_dkv, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------- bf16: Hopper tensor cores -----------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 384;        // producer + two consumer warpgroups
constexpr int kStages = 4;             // ring depth of both kernels
constexpr int kWide = 128;             // rows a CTA owns (kv rows, q rows)
constexpr int kNarrow = 64;            // rows of a tile through the ring
constexpr int kWideBox = kWide * 128;  // bytes of one 64-column box
constexpr int kNarrowBox = kNarrow * 128;

// Shapes of one instantiation: DP is the head dim rounded up to an
// instruction width (16, 32, 64, 80 or 128), the n of the gradient
// products.
template <int DP>
struct Bw {
  static constexpr int kBoxes = (DP + kBox - 1) / kBox;
  static constexpr int kSteps = DP / 16;      // k-steps of the score tiles
  static constexpr int kWideTile = kBoxes * kWideBox;
  static constexpr int kNarrowTile = kBoxes * kNarrowBox;
  // two wide tiles, two narrow tiles a stage, a stage's 64 lse and 64
  // delta values (dK / dV), the mbarriers (the ring's, the wide tiles')
  static constexpr int kSmem = 1024 + 2 * kWideTile +
                               2 * kStages * kNarrowTile + kStages * 512 +
                               8 * (2 + 2 * kStages);
  // the next tile's S and dP in flight with this one's products where the
  // registers allow (dK / dV: 176 a thread at DP = 80, 224 at 128)
  static constexpr bool kOverlap = DP <= 80;
};

struct TcArgs {
  const bf16* o;
  const bf16* dO;
  bf16* dq;
  bf16* dk;
  bf16* dv;
  const float* lse;                  // [B, Hq, ld], the forward's
  float* delta;                      // [B, Hq, ld], written by the dQ kernel
  int ld;                            // Sq rounded up to 64
  long long os[3], dos[3], dqs[3], dks[3], dvs[3];
  int B, Hq, Hkv, Sq, Skv, D, causal;
  float scale, scale_log2;           // scale, scale * log2(e)
};

// acc[32] = X Y^T, 64 x 64 over DP: X a 64-row slice of a tile whose boxes
// are x_box bytes apart, Y a 64-row tile (boxes y_box apart), both K-major.
template <int DP>
__device__ __forceinline__ void issue_scores(float* acc, uint32_t x, int x_box,
                                             uint32_t y, int y_box) {
#pragma unroll
  for (int kk = 0; kk < Bw<DP>::kSteps; ++kk) {
    const uint32_t in_box = (kk % 4) * 32;
    Wgmma<64>::ss<0>(acc, desc128(x + (kk / 4) * x_box + in_box, 16, 1024),
                     desc128(y + (kk / 4) * y_box + in_box, 16, 1024),
                     kk > 0);
  }
}

// acc[DP / 2] += F Y over the 64 rows of Y (four k-steps): F the register
// A fragments of a 64 x 64 tile, Y read MN-major (boxes y_box apart).
template <int DP>
__device__ __forceinline__ void issue_grad(float* acc, const uint32_t* f,
                                           uint32_t y, int y_box) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<DP>::rs(acc, f + 4 * kk, desc128(y + kk * 2048, y_box, 1024));
}

// The gradient rows of a warpgroup's thread (rows ra, ra + 8 of the
// accumulator), times `mul`, as bf16 pairs; rows >= n and columns >= D are
// not written.
template <int DP>
__device__ __forceinline__ void store_rows(bf16* out, long long rs,
                                           const float* acc, int ra, int n,
                                           int D, float mul) {
  const int t4 = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + 2 * t4;              // D is a multiple of 8
    if (col >= D) continue;
    if (ra < n)
      *reinterpret_cast<__nv_bfloat162*>(out + ra * rs + col) =
          __floats2bfloat162_rn(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (ra + 8 < n)
      *reinterpret_cast<__nv_bfloat162*>(out + (ra + 8) * rs + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// bf16 dQ: a persistent grid, one CTA of 384 threads an SM, walking the
// (batch, query head, 128 query rows) items, the last rows (the most
// causal work) first.  Warpgroup 0 is the producer: one thread loads each
// item's Q and dO once (released when the item's products are done, so
// the next item's load overlaps this one's stores) and its K and V tiles
// of 64 kv rows through a kStages ring that runs on from item to item.
// Warpgroups 1 and 2 own 64 query rows each.  Per kv tile: S = Q K^T and
// dP = dO V^T (wgmma, both operands from shared memory), P = 2^(S c -
// lse log2 e) with the forward's lse, dS = P (dP - delta) in registers,
// rounded to bf16 once as the register A operand of dQ += dS K (K read
// MN-major); the next tile's S and dP are issued with this one's dQ
// product.  Each item starts with delta = rowsum(dO O) of its rows, stored
// for the dK / dV kernel.
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tq,
                  const __grid_constant__ CUtensorMap tdo,
                  const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using S = Bw<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sDO = sQ + S::kWideTile;
  uint8_t* sK = sDO + S::kWideTile;                   // kStages tiles
  uint8_t* sV = sK + kStages * S::kNarrowTile;        // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      sV + kStages * S::kNarrowTile + kStages * 512);
  const uint32_t bar_full = smem_u32(bars);                  // + 8 s
  const uint32_t bar_empty = smem_u32(bars + kStages);       // + 8 s
  const uint32_t bar_q_full = smem_u32(bars + 2 * kStages);
  const uint32_t bar_q_empty = bar_q_full + 8;

  const int tid = threadIdx.x;
  const int BH = a.B * a.Hq;
  const int n_qb = (a.Sq + kWide - 1) / kWide;
  const int n_items = BH * n_qb;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_q_full, 1);
    mbar_init(bar_q_empty, 2 * 128);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int cnt = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int b = (item % BH) / a.Hq, h = item % a.Hq;
        const int hk = h / (a.Hq / a.Hkv);
        const int q0 = (n_qb - 1 - item / BH) * kWide;
        const int kv_hi = a.causal ? min(a.Skv, q0 + kWide) : a.Skv;
        const int n_tiles = (kv_hi + kNarrow - 1) / kNarrow;
        if (it > 0) mbar_wait(bar_q_empty, (it - 1) & 1);
        mbar_expect_tx(bar_q_full, 2 * S::kWideTile);
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load(smem_u32(sQ + c * kWideBox), &tq, bar_q_full, c * kBox,
                   q0, h, b);
          tma_load(smem_u32(sDO + c * kWideBox), &tdo, bar_q_full, c * kBox,
                   q0, h, b);
        }
        for (int t = 0; t < n_tiles; ++t, ++cnt) {
          const int s = cnt % kStages;
          if (cnt >= kStages)
            mbar_wait(bar_empty + 8 * s, (cnt / kStages - 1) & 1);
          mbar_expect_tx(bar_full + 8 * s, 2 * S::kNarrowTile);
          for (int c = 0; c < S::kBoxes; ++c) {
            const int off = s * S::kNarrowTile + c * kNarrowBox;
            tma_load(smem_u32(sK + off), &tk, bar_full + 8 * s, c * kBox,
                     t * kNarrow, hk, b);
            tma_load(smem_u32(sV + off), &tv, bar_full + 8 * s, c * kBox,
                     t * kNarrow, hk, b);
          }
        }
      }
    }
  } else {                               // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t a_q = smem_u32(sQ) + 64 * cw * 128;
    const uint32_t a_do = smem_u32(sDO) + 64 * cw * 128;
    const float c2 = a.scale_log2;
    float dq[DP / 2], sc[32], dp[32];
    uint32_t df[16];
    int cnt = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int b = (item % BH) / a.Hq, h = item % a.Hq;
      const int q0 = (n_qb - 1 - item / BH) * kWide;
      const int kv_hi = a.causal ? min(a.Skv, q0 + kWide) : a.Skv;
      const int n_tiles = (kv_hi + kNarrow - 1) / kNarrow;
      const int r0 = q0 + 64 * cw;       // this warpgroup's first row
      const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
      const long long stat = ((long long)b * a.Hq + h) * a.ld;

      // delta = rowsum(dO O) of rows a and b, 16 B a thread per step
      float delta[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = i ? row_b : row_a;
        if (r >= a.Sq) continue;
        const bf16* dor = a.dO + b * a.dos[0] + h * a.dos[1] + r * a.dos[2];
        const bf16* orow = a.o + b * a.os[0] + h * a.os[1] + r * a.os[2];
        for (int c = 8 * t4; c < a.D; c += 32) {
          const uint4 x = *reinterpret_cast<const uint4*>(dor + c);
          const uint4 y = *reinterpret_cast<const uint4*>(orow + c);
          const __nv_bfloat162* x2 =
              reinterpret_cast<const __nv_bfloat162*>(&x);
          const __nv_bfloat162* y2 =
              reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 xf = __bfloat1622float2(x2[e]);
            const float2 yf = __bfloat1622float2(y2[e]);
            delta[i] = fmaf(xf.x, yf.x, delta[i]);
            delta[i] = fmaf(xf.y, yf.y, delta[i]);
          }
        }
      }
      float lse2[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 1);
        delta[i] += __shfl_xor_sync(0xffffffffu, delta[i], 2);
        const int r = i ? row_b : row_a;
        lse2[i] = r < a.Sq ? a.lse[stat + r] * kLog2e : 0.f;
        if (t4 == 0 && r < a.Sq) a.delta[stat + r] = delta[i];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

      // dS of tile t from S (sc) and dP (dp) into df
      auto probs = [&](int t) {
        const int k0 = t * kNarrow;
        const bool edge = k0 + kNarrow > a.Skv ||
                          (a.causal && k0 + kNarrow - 1 > r0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e / 2, col = k0 + 8 * j + 2 * t4 + (e & 1);
            const int row = i ? row_b : row_a;
            const bool vis =
                !edge || (col < a.Skv && (!a.causal || col <= row));
            const float p = ex2(fmaf(sc[4 * j + e], c2, -lse2[i]));
            dp[4 * j + e] = vis ? p * (dp[4 * j + e] - delta[i]) : 0.f;
          }
        pack_a<32>(dp, df);
      };
      auto kv = [&](uint8_t* t, int u) {
        return smem_u32(t + (u % kStages) * S::kNarrowTile);
      };

      mbar_wait(bar_q_full, it & 1);
      mbar_wait(bar_full + 8 * (cnt % kStages), (cnt / kStages) & 1);
      wg_fence();
      issue_scores<DP>(sc, a_q, kWideBox, kv(sK, cnt), kNarrowBox);
      issue_scores<DP>(dp, a_do, kWideBox, kv(sV, cnt), kNarrowBox);
      wg_commit();
      wg_wait<0>();
      fence_regs<32>(sc);
      fence_regs<32>(dp);
      probs(0);
      for (int t = 1; t < n_tiles; ++t) {
        // S, dP of tile t and dQ += dS K of tile t - 1 in flight together
        const int u = cnt + t;
        mbar_wait(bar_full + 8 * (u % kStages), (u / kStages) & 1);
        fence_regs<DP / 2>(dq);
        wg_fence();
        issue_scores<DP>(sc, a_q, kWideBox, kv(sK, u), kNarrowBox);
        issue_scores<DP>(dp, a_do, kWideBox, kv(sV, u), kNarrowBox);
        issue_grad<DP>(dq, df, kv(sK, u - 1), kNarrowBox);
        wg_commit();
        wg_wait<0>();
        fence_regs<32>(sc);
        fence_regs<32>(dp);
        fence_regs<DP / 2>(dq);
        fence_u32<16>(df);
        mbar_arrive(bar_empty + 8 * ((u - 1) % kStages));
        probs(t);
      }
      const int u_last = cnt + n_tiles - 1;
      fence_regs<DP / 2>(dq);
      wg_fence();
      issue_grad<DP>(dq, df, kv(sK, u_last), kNarrowBox);
      wg_commit();
      wg_wait<0>();
      fence_regs<DP / 2>(dq);
      fence_u32<16>(df);
      mbar_arrive(bar_empty + 8 * (u_last % kStages));
      mbar_arrive(bar_q_empty);          // Q and dO are free for the next
      store_rows<DP>(a.dq + b * a.dqs[0] + h * a.dqs[1], a.dqs[2], dq, row_a,
                     a.Sq, a.D, a.scale);
      cnt += n_tiles;
    }
  }
}

// bf16 dK, dV: a persistent grid, one CTA of 384 threads an SM, walking
// the (batch, kv head, 128 kv rows) items, the first rows (the most causal
// work) first.  K and V stay in shared memory for an item (released when
// its products are done, so the next item's load overlaps this one's
// stores); the producer brings, for each query head of the group and each
// 64-row query tile that can see the block, Q, dO and the tile's 64 lse
// and delta values through a kStages ring that runs on from item to item.
// Warpgroups 1 and 2 own 64 kv rows each: S^T = K Q^T and dP^T = V dO^T
// (both operands from shared memory), P^T = 2^(S^T c - lse log2 e) and
// dS^T = P^T (dP^T - delta) in registers with kv rows, each rounded to
// bf16 once as the register A operand of dV += P^T dO and dK += dS^T Q (dO
// and Q read MN-major).
template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
attn_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using S = Bw<DP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sK = base;
  uint8_t* sV = sK + S::kWideTile;
  uint8_t* sQ = sV + S::kWideTile;                    // kStages tiles
  uint8_t* sDO = sQ + kStages * S::kNarrowTile;       // kStages tiles
  float* sStat = reinterpret_cast<float*>(sDO + kStages * S::kNarrowTile);
  uint64_t* bars = reinterpret_cast<uint64_t*>(sStat + kStages * 128);
  const uint32_t bar_full = smem_u32(bars);                  // + 8 s
  const uint32_t bar_empty = smem_u32(bars + kStages);       // + 8 s
  const uint32_t bar_kv_full = smem_u32(bars + 2 * kStages);
  const uint32_t bar_kv_empty = bar_kv_full + 8;

  const int tid = threadIdx.x;
  const int BH = a.B * a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int n_items = BH * ((a.Skv + kWide - 1) / kWide);
  const int n_qt = (a.Sq + kNarrow - 1) / kNarrow;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    mbar_init(bar_kv_full, 1);
    mbar_init(bar_kv_empty, 2 * 128);
    mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      int cnt = 0, it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
        const int b = (item % BH) / a.Hkv, hk = item % a.Hkv;
        const int k0 = item / BH * kWide;
        // causal: the query tiles from the block's first row on see it
        const int first = a.causal ? min(k0 / kNarrow, n_qt) : 0;
        const int per_head = n_qt - first;
        if (it > 0) mbar_wait(bar_kv_empty, (it - 1) & 1);
        mbar_expect_tx(bar_kv_full, 2 * S::kWideTile);
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load(smem_u32(sK + c * kWideBox), &tk, bar_kv_full, c * kBox,
                   k0, hk, b);
          tma_load(smem_u32(sV + c * kWideBox), &tv, bar_kv_full, c * kBox,
                   k0, hk, b);
        }
        for (int t = 0; t < group * per_head; ++t, ++cnt) {
          const int s = cnt % kStages;
          if (cnt >= kStages)
            mbar_wait(bar_empty + 8 * s, (cnt / kStages - 1) & 1);
          const int h = hk * group + t / per_head;
          const int qt = first + t % per_head;
          mbar_expect_tx(bar_full + 8 * s, 2 * S::kNarrowTile + 512);
          for (int c = 0; c < S::kBoxes; ++c) {
            const int off = s * S::kNarrowTile + c * kNarrowBox;
            tma_load(smem_u32(sQ + off), &tq, bar_full + 8 * s, c * kBox,
                     qt * kNarrow, h, b);
            tma_load(smem_u32(sDO + off), &tdo, bar_full + 8 * s, c * kBox,
                     qt * kNarrow, h, b);
          }
          const long long st =
              ((long long)b * a.Hq + h) * a.ld + qt * kNarrow;
          bulk_load(smem_u32(sStat + s * 128), a.lse + st, 256,
                    bar_full + 8 * s);
          bulk_load(smem_u32(sStat + s * 128 + 64), a.delta + st, 256,
                    bar_full + 8 * s);
        }
      }
    }
  } else {                               // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const uint32_t a_k = smem_u32(sK) + 64 * cw * 128;
    const uint32_t a_v = smem_u32(sV) + 64 * cw * 128;
    const float c2 = a.scale_log2;
    float dk[DP / 2], dv[DP / 2], st[32], dpt[32];
    uint32_t pf[16], df[16];
    int cnt = 0, it = 0;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x, ++it) {
      const int b = (item % BH) / a.Hkv, hk = item % a.Hkv;
      const int k0 = item / BH * kWide;
      const int first = a.causal ? min(k0 / kNarrow, n_qt) : 0;
      const int per_head = n_qt - first;
      const int n_tiles = group * per_head;
      const int r0 = k0 + 64 * cw;       // this warpgroup's first kv row
      const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

      // P^T and dS^T of tile t from S^T (st) and dP^T (dpt) into pf, df
      auto probs = [&](int t) {
        const float* ls = sStat + ((cnt + t) % kStages) * 128;
        const int qb = (first + t % per_head) * kNarrow;
        const bool edge = qb + kNarrow > a.Sq ||
                          (a.causal && qb < r0 + 63);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int cl = 8 * j + 2 * t4;
          const float2 l2 = *reinterpret_cast<const float2*>(ls + cl);
          const float2 d2 = *reinterpret_cast<const float2*>(ls + 64 + cl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = qb + cl + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            const bool vis =
                !edge || (col < a.Sq && (!a.causal || row <= col));
            const float p = ex2(fmaf(st[4 * j + e], c2,
                                     -(e & 1 ? l2.y : l2.x) * kLog2e));
            st[4 * j + e] = vis ? p : 0.f;
            dpt[4 * j + e] =
                vis ? p * (dpt[4 * j + e] - (e & 1 ? d2.y : d2.x)) : 0.f;
          }
        }
        pack_a<32>(st, pf);
        pack_a<32>(dpt, df);
      };
      auto q_do = [&](uint8_t* t, int u) {
        return smem_u32(t + (u % kStages) * S::kNarrowTile);
      };
      auto scores = [&](int u) {
        issue_scores<DP>(st, a_k, kWideBox, q_do(sQ, u), kNarrowBox);
        issue_scores<DP>(dpt, a_v, kWideBox, q_do(sDO, u), kNarrowBox);
      };
      auto grads = [&](int u) {
        issue_grad<DP>(dv, pf, q_do(sDO, u), kNarrowBox);
        issue_grad<DP>(dk, df, q_do(sQ, u), kNarrowBox);
      };
      auto fence_all = [&]() {
        fence_regs<32>(st);
        fence_regs<32>(dpt);
        fence_regs<DP / 2>(dk);
        fence_regs<DP / 2>(dv);
        fence_u32<16>(pf);
        fence_u32<16>(df);
      };
      auto full = [&](int u) {
        mbar_wait(bar_full + 8 * (u % kStages), (u / kStages) & 1);
      };

      mbar_wait(bar_kv_full, it & 1);
      if (S::kOverlap && n_tiles > 0) {
        full(cnt);
        wg_fence();
        scores(cnt);
        wg_commit();
        wg_wait<0>();
        fence_all();
        probs(0);
        for (int t = 1; t < n_tiles; ++t) {
          // S^T, dP^T of tile t and the products of tile t - 1 together
          const int u = cnt + t;
          full(u);
          fence_all();
          wg_fence();
          scores(u);
          grads(u - 1);
          wg_commit();
          wg_wait<0>();
          fence_all();
          mbar_arrive(bar_empty + 8 * ((u - 1) % kStages));
          probs(t);
        }
        const int u_last = cnt + n_tiles - 1;
        fence_all();
        wg_fence();
        grads(u_last);
        wg_commit();
        wg_wait<0>();
        fence_all();
        mbar_arrive(bar_empty + 8 * (u_last % kStages));
      } else {
        for (int t = 0; t < n_tiles; ++t) {
          const int u = cnt + t;
          full(u);
          fence_all();
          wg_fence();
          scores(u);
          wg_commit();
          wg_wait<0>();
          fence_all();
          probs(t);
          wg_fence();
          grads(u);
          wg_commit();
          wg_wait<0>();
          fence_all();
          mbar_arrive(bar_empty + 8 * (u % kStages));
        }
      }
      mbar_arrive(bar_kv_empty);         // K and V are free for the next
      store_rows<DP>(a.dk + b * a.dks[0] + hk * a.dks[1], a.dks[2], dk,
                     row_a, a.Skv, a.D, a.scale);
      store_rows<DP>(a.dv + b * a.dvs[0] + hk * a.dvs[1], a.dvs[2], dv,
                     row_a, a.Skv, a.D, 1.f);
      cnt += n_tiles;
    }
  }
}

constexpr int kDevices = 64;           // devices a process may launch on

template <typename K>
int set_smem(K kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int DP>
int launch_tc(const Args& a, const TcArgs& t, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoTensorMap;
  // Q and dO wide for dQ, narrow for dK / dV; K and V the other way
  CUtensorMap q_w, do_w, k_n, v_n, q_n, do_n, k_w, v_w;
  if (!tensor_map(enc, &q_w, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, kWide) ||
      !tensor_map(enc, &do_w, a.dO, a.D, a.Sq, a.Hq, a.B, a.dos, kWide) ||
      !tensor_map(enc, &k_n, a.k, a.D, a.Skv, a.Hkv, a.B, a.ks, kNarrow) ||
      !tensor_map(enc, &v_n, a.v, a.D, a.Skv, a.Hkv, a.B, a.vs, kNarrow) ||
      !tensor_map(enc, &q_n, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, kNarrow) ||
      !tensor_map(enc, &do_n, a.dO, a.D, a.Sq, a.Hq, a.B, a.dos, kNarrow) ||
      !tensor_map(enc, &k_w, a.k, a.D, a.Skv, a.Hkv, a.B, a.ks, kWide) ||
      !tensor_map(enc, &v_w, a.v, a.D, a.Skv, a.Hkv, a.B, a.vs, kWide))
    return kErrNoTensorMap;
  // once per instantiation and device: the shared memory and SM count
  static int sms_of[kDevices] = {};
  int dev = 0, err = (int)cudaGetDevice(&dev);
  if (err) return err;
  if (dev >= kDevices) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  if (sms == 0) {
    int n = 0;
    if ((err = set_smem(attn_bwd_dq_wgmma<DP>, Bw<DP>::kSmem)) ||
        (err = set_smem(attn_bwd_dkv_wgmma<DP>, Bw<DP>::kSmem)) ||
        (err = (int)cudaDeviceGetAttribute(
             &n, cudaDevAttrMultiProcessorCount, dev)))
      return err;
    sms = n;
  }
  const int dq_items = a.B * a.Hq * ((a.Sq + kWide - 1) / kWide);
  const int dkv_items = a.B * a.Hkv * ((a.Skv + kWide - 1) / kWide);
  attn_bwd_dq_wgmma<DP><<<min(dq_items, sms), kTcThreads, Bw<DP>::kSmem,
                          stream>>>(q_w, do_w, k_n, v_n, t);
  err = (int)cudaGetLastError();
  if (err) return err;
  attn_bwd_dkv_wgmma<DP><<<min(dkv_items, sms), kTcThreads, Bw<DP>::kSmem,
                           stream>>>(q_n, do_n, k_w, v_w, t);
  return (int)cudaGetLastError();
}

// bf16 inputs the tensor-core kernels take: head_dim and the batch, head
// and sequence strides multiples of 8 elements and 16 B aligned pointers
// (TMA and 16 B loads); the head dim is padded to 16, 32, 64, 80 or 128.
bool tc_ok(const void* const* ptrs, const long long* const* strides, int D) {
  if (D % 8) return false;
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[i][j] % 8) return false;
  }
  return true;
}

int launch_bf16(const Args& a, const float* lse, int ld, cudaStream_t s) {
  TcArgs t;
  t.o = static_cast<const bf16*>(a.o);
  t.dO = static_cast<const bf16*>(a.dO);
  t.dq = static_cast<bf16*>(a.dq);
  t.dk = static_cast<bf16*>(a.dk);
  t.dv = static_cast<bf16*>(a.dv);
  t.lse = lse;
  t.delta = a.delta;
  t.ld = ld;
  for (int i = 0; i < 3; ++i) {
    t.os[i] = a.os[i];
    t.dos[i] = a.dos[i];
    t.dqs[i] = a.dqs[i];
    t.dks[i] = a.dks[i];
    t.dvs[i] = a.dvs[i];
  }
  t.B = a.B;
  t.Hq = a.Hq;
  t.Hkv = a.Hkv;
  t.Sq = a.Sq;
  t.Skv = a.Skv;
  t.D = a.D;
  t.causal = a.causal;
  t.scale = a.scale;
  t.scale_log2 = a.scale * kLog2e;
  if (a.D <= 16) return launch_tc<16>(a, t, s);
  if (a.D <= 32) return launch_tc<32>(a, t, s);
  if (a.D <= 64) return launch_tc<64>(a, t, s);
  if (a.D <= 80) return launch_tc<80>(a, t, s);
  return launch_tc<128>(a, t, s);
}

}  // namespace

extern "C" int flash_attention_bwd_max_d() { return kMaxD; }

// dtype: 0 float32, 1 bfloat16 (every tensor but the statistics).
// float32: stats is a scratch of 2 * B * Hq * Sq values (the rows' lse,
// then delta) and lse is not read.  bf16: lse holds the forward's row
// log-sum-exp, [B, Hq, ld] (ld = Sq rounded up to 64, rows past Sq
// unread), and stats is a scratch of B * Hq * ld values (delta).  Strides
// are in elements, three per tensor (batch, head, sequence), in the order
// q, k, v, o, dO, dQ, dK, dV.  bf16 needs strides multiples of 8 and 16 B
// aligned pointers.  Launches on `stream` and returns cudaGetLastError() (0
// on success; cudaErrorInvalidValue for inputs the kernel does not take;
// 10000 when the TMA maps cannot be made).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, float* stats,
    const float* lse, int ld, int dtype, int B, int Hq, int Hkv, int Sq,
    int Skv, int D, const long long* qs, const long long* ks,
    const long long* vs, const long long* os, const long long* dos,
    const long long* dqs, const long long* dks, const long long* dvs,
    int causal, float scale, void* stream) {
  if (D < 1 || D > kMaxD || Hkv < 1 || Hq % Hkv || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0 || Skv == 0) return (int)cudaGetLastError();
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dO = dO;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.lse = stats;
  a.delta = dtype == 1 ? stats : stats + (long long)B * Hq * Sq;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = qs[i];
    a.ks[i] = ks[i];
    a.vs[i] = vs[i];
    a.os[i] = os[i];
    a.dos[i] = dos[i];
    a.dqs[i] = dqs[i];
    a.dks[i] = dks[i];
    a.dvs[i] = dvs[i];
  }
  a.causal = causal;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch(a, s);
  const void* ptrs[8] = {q, k, v, o, dO, dq, dk, dv};
  const long long* strides[8] = {qs, ks, vs, os, dos, dqs, dks, dvs};
  if (!tc_ok(ptrs, strides, D) || lse == nullptr || ld % 64 || ld < Sq ||
      reinterpret_cast<uintptr_t>(lse) % 16)
    return (int)cudaErrorInvalidValue;
  return launch_bf16(a, lse, ld, s);
}
