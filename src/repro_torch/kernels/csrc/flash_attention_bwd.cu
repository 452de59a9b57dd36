// flash_attention_bwd: the gradient of flash_attention (the training mask).
//
// New in the port: the TPU package has no backward Pallas kernel; it
// differentiates the model layer's `_sdpa` (src/repro/models/layers.py:94)
// with jax.grad.  This kernel computes that gradient for the forward of
// flash_attention.cu with q_offset = 0 and kv_len = Skv (causal: query row
// i sees kv rows j <= i; or no mask).  Per query head, in float32:
//
//   P     = exp(q k^T * scale - lse)        lse: the row's log-sum-exp,
//                                           recomputed here (pass 1)
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
// bf16 (the training path; strides and pointers that allow 16 B loads,
// else the call is refused): Hopper's tensor cores through mma.sync
// (m16n8k16, bf16 in, float32 sums), one CTA of four warps per 64 rows,
// each warp owning 16 of them; tiles of 64 rows x D bf16 in shared memory
// (D padded to 16, 32, 64, 80 or 128; rows padded by 16 B so ldmatrix is
// conflict-free), loaded 16 B at a time.
//  * attn_bwd_dq_tc, per (batch, query head, 64 query rows): delta from dO
//    and O; pass 1 over the visible kv tiles forms S = Q K^T in registers
//    and takes each row's max and sum (a quad of threads shares a row),
//    writing lse and delta for the second kernel; pass 2 forms S and
//    dP = dO V^T again, dS = P (dP - delta) in registers, and dQ += dS K.
//  * attn_bwd_dkv_tc, per (batch, kv head, 64 kv rows): K and V stay in
//    shared memory; for each query head of the group and each query tile
//    that can see the block (causal: from the block's first row on),
//    S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in registers, then
//    dV += P^T dO and dK += dS^T Q.
//  Q K^T, dO V^T and their transposes multiply bf16 inputs: exact
//  products.  P and dS are float32: each is split into two bf16 terms,
//  hi = bf16(x) and lo = bf16(x - hi) (about 16 bits), and multiplied
//  twice, where rounding them once would leave the plain version's
//  float32 P by 2^-9 relative.
//
// float32 (the parity path): the CUDA cores, one block of 256 threads per
// 64 rows as above, tiles of 64 x D float32 (rows padded by one float),
// each thread a 4 x 4 micro-tile of a 64 x 64 score tile or D / 4 output
// columns of one row (attn_bwd_dq, attn_bwd_dkv).
//
// Bound on an H100 at the training shape (zamba2-2.7b's shared attention:
// B = 4, S = 1024, 32 heads, D = 80, causal, bf16): five S x S x D
// products over the causal half, 4 * 5 * B * H * D * S^2 / 2 = 5.4e10
// FLOP (55 us at 989 TFLOP/s bf16), and q, k, v, o, dO read and dQ, dK,
// dV written once, 168 MB (50 us at 3.35 TB/s): bound by operations.
// These kernels do eleven such products (S twice more, P and dS twice
// each) with mma.sync and synchronous tile loads, one CTA waiting on its
// loads: wgmma and TMA with a load pipeline, as in the forward, are the
// later step (PERF.md has the times).  Shared memory a CTA: 35 KB (bf16,
// D = 80), 100 / 116 KB (float32, D = 80).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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

// ------------------------- bf16: tensor cores ------------------------------

typedef __nv_bfloat16 bf16;
constexpr int kTcThreads = 128;      // four warps, 16 tile rows each

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

// The A fragment of the 16 x 16 block at (r0, c0) of a row-major bf16
// matrix in shared memory (row pitch ld elements).
__device__ __forceinline__ void ld_a(uint32_t* a, const bf16* s, int ld,
                                     int r0, int c0) {
  const int l = threadIdx.x % 32;
  ldsm4(a, s + (r0 + l % 16) * ld + c0 + (l / 16) * 8);
}

// B fragments of n-tiles n0 and n0 + 8 over k = k0 .. k0 + 15, from a
// matrix held as rows of n (X[n][k]): b[0], b[1] for n0, b[2], b[3] for
// n0 + 8.
__device__ __forceinline__ void ld_b_nk(uint32_t* b, const bf16* s, int ld,
                                        int n0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4(b, s + (n0 + l % 8 + (l / 16) * 8) * ld + k0 + ((l / 8) % 2) * 8);
}

// The same from a matrix held as rows of k (X[k][n]).
__device__ __forceinline__ void ld_b_kn(uint32_t* b, const bf16* s, int ld,
                                        int k0, int n0) {
  const int l = threadIdx.x % 32;
  ldsm4_t(b, s + (k0 + l % 8 + ((l / 8) % 2) * 8) * ld + n0 + (l / 16) * 8);
}

__device__ __forceinline__ uint32_t pack(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The A fragments (hi, lo) of the k-step kk of a 16 x 64 float32 operand
// held as C fragments c[8][4] (columns 8 j + ..): two bf16 terms, hi =
// bf16(x) and lo = bf16(x - hi), which keep about 16 bits of x.
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

// n rows (sequence stride rs, elements) of D bf16 values into a 64-row
// tile of pitch ld, 16 B at a time; zeros past n rows and past D columns
// up to DP.
template <int DP>
__device__ void load_tile_tc(bf16* dst, const bf16* src, long long rs, int n,
                             int D) {
  constexpr int ld = DP + 8, per_row = DP / 8;
  for (int e = threadIdx.x; e < kB * per_row; e += kTcThreads) {
    const int r = e / per_row, c = (e % per_row) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < n && c < D) v = *reinterpret_cast<const uint4*>(src + r * rs + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
  }
}

template <int DP>
size_t tc_smem_bytes() {
  return (size_t)4 * kB * (DP + 8) * sizeof(bf16) + 2 * kB * sizeof(float);
}

// c[8][4] = x[16 rows from r0] y^T over DP columns: a 16 x 64 tile of
// products, x and y row-major tiles of pitch DP + 8 (y's rows are the
// tile's 64 columns).
template <int DP>
__device__ __forceinline__ void tile_mma(float (*c)[4], const bf16* x,
                                         const bf16* y, int r0) {
  constexpr int ld = DP + 8;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    uint32_t xa[4];
    ld_a(xa, x, ld, r0, 16 * ks);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t yb[4];
      ld_b_nk(yb, y, ld, 16 * np, 16 * ks);
      mma(c[2 * np], xa, yb[0], yb[1]);
      mma(c[2 * np + 1], xa, yb[2], yb[3]);
    }
  }
}

// acc[DP / 8][4] += op[16 x 64] m[64 x DP], op held as C fragments (split
// in two bf16 terms), m a row-major tile of pitch DP + 8.
template <int DP>
__device__ __forceinline__ void acc_mma(float (*acc)[4], const float (*op)[4],
                                        const bf16* m) {
  constexpr int ld = DP + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t hi[4], lo[4];
    split_a(op, kk, hi, lo);
#pragma unroll
    for (int nd = 0; nd < DP / 16; ++nd) {
      uint32_t mb[4];
      ld_b_kn(mb, m, ld, 16 * kk, 16 * nd);
      mma(acc[2 * nd], hi, mb[0], mb[1]);
      mma(acc[2 * nd + 1], hi, mb[2], mb[3]);
      mma(acc[2 * nd], lo, mb[0], mb[1]);
      mma(acc[2 * nd + 1], lo, mb[2], mb[3]);
    }
  }
}

// bf16 dQ: one CTA of four warps per (batch, query head, 64 query rows),
// warp w owning rows 16 w .. 16 w + 15.  Q and dO tiles stay in shared
// memory; per kv tile S = Q K^T and dP = dO V^T on the tensor cores (bf16
// products are exact, float32 sums), the row statistics (pass 1) and
// dS = P (dP - delta) (pass 2) in registers, dQ += dS K with dS in two
// bf16 terms.
template <int DP>
__global__ void __launch_bounds__(kTcThreads) attn_bwd_dq_tc(Args a) {
  constexpr int ld = DP + 8, NT = DP / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_tc);
  bf16* sDO = sQ + kB * ld;
  bf16* sK = sDO + kB * ld;
  bf16* sV = sK + kB * ld;
  float* sDelta = reinterpret_cast<float*>(sV + kB * ld);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int D = a.D;
  const int b = blockIdx.y / a.Hq, h = blockIdx.y % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * kB;
  const int nq = min(kB, a.Sq - q0);
  const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qs[0] +
                  h * a.qs[1] + q0 * a.qs[2];
  const bf16* O = static_cast<const bf16*>(a.o) + b * a.os[0] +
                  h * a.os[1] + q0 * a.os[2];
  const bf16* DO = static_cast<const bf16*>(a.dO) + b * a.dos[0] +
                   h * a.dos[1] + q0 * a.dos[2];
  const bf16* K = static_cast<const bf16*>(a.k) + b * a.ks[0] +
                  hk * a.ks[1];
  const bf16* V = static_cast<const bf16*>(a.v) + b * a.vs[0] +
                  hk * a.vs[1];
  const long long stat0 = ((long long)b * a.Hq + h) * a.Sq + q0;

  load_tile_tc<DP>(sQ, Q, a.qs[2], nq, D);
  load_tile_tc<DP>(sDO, DO, a.dos[2], nq, D);
  __syncthreads();
  {                                   // delta: two threads a row
    const int r = tid / 2;
    float part = 0.f;
    if (r < nq)
      for (int d = tid % 2; d < D; d += 2)
        part += __bfloat162float(sDO[r * ld + d]) *
                __bfloat162float(O[r * a.os[2] + d]);
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (tid % 2 == 0) sDelta[r] = part;
  }
  __syncthreads();

  const int r0 = 16 * warp;
  const int qpos[2] = {q0 + r0 + g, q0 + r0 + g + 8};
  const float delta[2] = {sDelta[r0 + g], sDelta[r0 + g + 8]};
  const int kv_end = a.causal ? min(a.Skv, q0 + nq) : a.Skv;
  float s[8][4], dp[8][4];

  // pass 1: each row's max and sum of exp over the visible kv positions
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    __syncthreads();
    load_tile_tc<DP>(sK, K + k0 * a.ks[2], a.ks[2], min(kB, a.Skv - k0), D);
    __syncthreads();
    tile_mma<DP>(s, sQ, sK, r0);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * hf + e];
          x = visible(a, qpos[hf], k0 + 8 * j + 2 * t + e) ? x * a.scale
                                                            : kNegInf;
          tmax = fmaxf(tmax, x);
        }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float mnew = fmaxf(m[hf], tmax);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x = s[j][2 * hf + e];
          if (x > 0.5f * kNegInf) sum += expf(x - mnew);
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hf] = l[hf] * expf(m[hf] - mnew) + sum;
      m[hf] = mnew;
    }
  }
  float lse[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    lse[hf] = r < nq ? m[hf] + logf(l[hf]) : 0.f;
    if (t == 0 && r < nq) {
      a.lse[stat0 + r] = lse[hf];
      a.delta[stat0 + r] = delta[hf];
    }
  }

  // pass 2: dS = P (dP - delta), dQ += dS K
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  for (int k0 = 0; k0 < kv_end; k0 += kB) {
    const int nk = min(kB, a.Skv - k0);
    __syncthreads();
    load_tile_tc<DP>(sK, K + k0 * a.ks[2], a.ks[2], nk, D);
    load_tile_tc<DP>(sV, V + k0 * a.vs[2], a.vs[2], nk, D);
    __syncthreads();
    tile_mma<DP>(s, sQ, sK, r0);
    tile_mma<DP>(dp, sDO, sV, r0);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e / 2;
        float ds = 0.f;
        if (qpos[hf] < q0 + nq &&
            visible(a, qpos[hf], k0 + 8 * j + 2 * t + (e & 1))) {
          const float p = expf(s[j][e] * a.scale - lse[hf]);
          ds = p * (dp[j][e] - delta[hf]);
        }
        s[j][e] = ds;
      }
    acc_mma<DP>(acc, s, sK);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= nq) continue;
    bf16* out = static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                (q0 + r) * a.dqs[2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) out[d] = __float2bfloat16(acc[j][2 * hf + e] * a.scale);
      }
  }
}

// bf16 dK, dV: one CTA of four warps per (batch, kv head, 64 kv rows),
// warp w owning kv rows 16 w .. 16 w + 15.  For each query head of the
// group and each query tile that can see the block: S^T = K Q^T and
// dP^T = V dO^T on the tensor cores, P^T and dS^T in registers (lse and
// delta from attn_bwd_dq_tc), dV += P^T dO and dK += dS^T Q with P^T and
// dS^T in two bf16 terms each.
template <int DP>
__global__ void __launch_bounds__(kTcThreads) attn_bwd_dkv_tc(Args a) {
  constexpr int ld = DP + 8, NT = DP / 8;
  extern __shared__ __align__(16) uint8_t smem_tc[];
  bf16* sK = reinterpret_cast<bf16*>(smem_tc);
  bf16* sV = sK + kB * ld;
  bf16* sQ = sV + kB * ld;
  bf16* sDO = sQ + kB * ld;
  float* sLse = reinterpret_cast<float*>(sDO + kB * ld);
  float* sDelta = sLse + kB;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int D = a.D;
  const int b = blockIdx.y / a.Hkv, hk = blockIdx.y % a.Hkv;
  const int group = a.Hq / a.Hkv;
  const int k0 = blockIdx.x * kB;
  const int nk = min(kB, a.Skv - k0);
  load_tile_tc<DP>(sK,
                   static_cast<const bf16*>(a.k) + b * a.ks[0] +
                       hk * a.ks[1] + k0 * a.ks[2],
                   a.ks[2], nk, D);
  load_tile_tc<DP>(sV,
                   static_cast<const bf16*>(a.v) + b * a.vs[0] +
                       hk * a.vs[1] + k0 * a.vs[2],
                   a.vs[2], nk, D);

  const int r0 = 16 * warp;
  const int kpos[2] = {k0 + r0 + g, k0 + r0 + g + 8};
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  float st[8][4], dpt[8][4];

  for (int gi = 0; gi < group; ++gi) {
    const int h = hk * group + gi;
    const bf16* Q = static_cast<const bf16*>(a.q) + b * a.qs[0] +
                    h * a.qs[1];
    const bf16* DO = static_cast<const bf16*>(a.dO) + b * a.dos[0] +
                     h * a.dos[1];
    const long long stat0 = ((long long)b * a.Hq + h) * a.Sq;
    for (int q0 = a.causal ? k0 : 0; q0 < a.Sq; q0 += kB) {
      const int nq = min(kB, a.Sq - q0);
      __syncthreads();
      load_tile_tc<DP>(sQ, Q + q0 * a.qs[2], a.qs[2], nq, D);
      load_tile_tc<DP>(sDO, DO + q0 * a.dos[2], a.dos[2], nq, D);
      if (tid < kB) {
        sLse[tid] = tid < nq ? a.lse[stat0 + q0 + tid] : 0.f;
        sDelta[tid] = tid < nq ? a.delta[stat0 + q0 + tid] : 0.f;
      }
      __syncthreads();
      tile_mma<DP>(st, sK, sQ, r0);
      tile_mma<DP>(dpt, sV, sDO, r0);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * j + 2 * t + (e & 1);     // query row in tile
          float p = 0.f, ds = 0.f;
          if (c < nq && kpos[e / 2] < k0 + nk &&
              visible(a, q0 + c, kpos[e / 2])) {
            p = expf(st[j][e] * a.scale - sLse[c]);
            ds = p * (dpt[j][e] - sDelta[c]);
          }
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      acc_mma<DP>(dv, st, sDO);
      acc_mma<DP>(dk, dpt, sQ);
    }
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g + 8 * hf;
    if (r >= nk) continue;
    bf16* dko = static_cast<bf16*>(a.dk) + b * a.dks[0] + hk * a.dks[1] +
                (k0 + r) * a.dks[2];
    bf16* dvo = static_cast<bf16*>(a.dv) + b * a.dvs[0] + hk * a.dvs[1] +
                (k0 + r) * a.dvs[2];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int d = 8 * j + 2 * t + e;
        if (d < D) {
          dko[d] = __float2bfloat16(dk[j][2 * hf + e] * a.scale);
          dvo[d] = __float2bfloat16(dv[j][2 * hf + e]);
        }
      }
  }
}

template <int DP>
int launch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      attn_bwd_dq_tc<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attn_bwd_dkv_tc<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dq_tc<DP><<<dim3((a.Sq + kB - 1) / kB, a.B * a.Hq), kTcThreads,
                       smem, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attn_bwd_dkv_tc<DP><<<dim3((a.Skv + kB - 1) / kB, a.B * a.Hkv),
                        kTcThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// bf16 inputs the tensor-core kernels take: head_dim and the batch, head
// and sequence strides multiples of 8 elements and 16 B aligned pointers
// (16 B vector loads); the head dim is padded to 16, 32, 64, 80 or 128.
bool tc_ok(const void* const* ptrs, const long long* const* strides, int D) {
  if (D % 8) return false;
  for (int i = 0; i < 8; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[i][j] % 8) return false;
  }
  return true;
}

int launch_bf16(const Args& a, cudaStream_t s) {
  if (a.D <= 16) return launch_tc<16>(a, s);
  if (a.D <= 32) return launch_tc<32>(a, s);
  if (a.D <= 64) return launch_tc<64>(a, s);
  if (a.D <= 80) return launch_tc<80>(a, s);
  return launch_tc<128>(a, s);
}

}  // namespace

extern "C" int flash_attention_bwd_max_d() { return kMaxD; }

// dtype: 0 float32, 1 bfloat16 (every tensor but stats).  stats is a
// float32 scratch of 2 * B * Hq * Sq values (the rows' lse, then delta).
// Strides are in elements, three per tensor (batch, head, sequence), in
// the order q, k, v, o, dO, dQ, dK, dV.  bf16 needs strides multiples of
// 8 and 16 B aligned pointers.  Launches on `stream` and returns
// cudaGetLastError() (0 on success; cudaErrorInvalidValue for inputs the
// kernel does not take).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, float* stats, int dtype,
    int B, int Hq, int Hkv, int Sq, int Skv, int D, const long long* qs,
    const long long* ks, const long long* vs, const long long* os,
    const long long* dos, const long long* dqs, const long long* dks,
    const long long* dvs, int causal, float scale, void* stream) {
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
  a.delta = stats + (long long)B * Hq * Sq;
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
  if (!tc_ok(ptrs, strides, D)) return (int)cudaErrorInvalidValue;
  return launch_bf16(a, s);
}
