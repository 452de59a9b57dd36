// flash_attention: blockwise online-softmax attention (GQA, causal, cache).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention / _flash_kernel).  For every query head and query row i,
//
//   s[j]   = (q_i . k_j) * scale            masked to -1e30 unless
//            j < kv_len  and, when causal,  j <= i + q_offset
//   out_i  = sum_j softmax(s)[j] v_j        (float32 running max, sum and
//                                           accumulator; out / max(l, 1e-30))
//
// which is the model layer's `_sdpa` (src/repro/models/layers.py:94): the
// TPU kernel is the case q_offset = 0, kv_len = Skv.  Query head h reads kv
// head h / (Hq / Hkv) (GQA).  The mask value is the finite -1e30, never -inf
// (exp(-inf - -inf) is NaN); the first kv tile always holds position 0,
// which no mask removes, so a masked entry contributes exp(-1e30 - m) = 0.
//
// Layout: q [B, Sq, Hq, D], k and v [B, Skv, Hkv, D], each with its own
// batch, head and sequence strides and a contiguous last dimension, so the
// model's [B, S, H, D] activations and its KV cache are read in place;
// the TPU layout [BH, S, D] is B = 1, Hq = BH.  bf16 or float32 in, the
// same type out, float32 arithmetic throughout.
//
// Design: one block of 128 threads per (query head, tile of 32 query rows).
// It loops over kv tiles of 64 rows, staged with the query tile in shared
// memory as float32 (rows padded by one float against bank conflicts).  Per
// kv tile: a 32 x 64 score tile (a 4 x 4 micro-tile per thread), masking,
// the online softmax (one warp per 8 rows, shuffles for max and sum), then
// the accumulator update acc += p v (each thread keeps D/4 columns of one
// row in registers).  Tiles past the causal diagonal or past kv_len are
// skipped: they would only add zeros.  Ragged Sq and Skv are masked by
// bound checks; D may be any value up to 128.
//
// Bound on an H100: at the serve path's shape (zamba2-2.7b prefill, B = 4,
// Sq = kv_len = 1024, 32 heads, D = 80, causal, bf16) the function reads
// q and the kv_len rows of k and v once and writes o once, 4 x 21 MB = 84 MB
// (25 us at 3.35 TB/s), and does 2 * 2 * B * H * D * Sq^2 / 2 = 21.5 GFLOP
// (21.7 us at 989 TFLOP/s bf16): bound by bytes, with the operations close
// behind.  This kernel does its products on the CUDA cores in float32 out
// of shared memory, far from both; the tensor-core form (wgmma on bf16
// tiles, TMA loads) is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;          // query rows per block
constexpr int kBK = 64;          // kv rows per tile
constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv, D;
  long long qs[3], ks[3], vs[3], os[3];   // batch, head, sequence strides
  int causal, q_offset, kv_end;           // kv_end = min(Skv, kv_len)
  float scale;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_kernel(Args a) {
  extern __shared__ float smem[];
  const int D = a.D;
  const int ld = D + 1;
  float* sq = smem;                      // kBQ x ld
  float* sk = sq + kBQ * ld;             // kBK x ld
  float* sv = sk + kBK * ld;             // kBK x ld
  float* sp = sv + kBK * ld;             // kBQ x (kBK + 1)
  float* sm = sp + kBQ * (kBK + 1);      // running max
  float* sl = sm + kBQ;                  // running sum
  float* sa = sl + kBQ;                  // this tile's rescale factor

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / a.Hq;
  const int h = bh % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = blockIdx.x * kBQ;
  const T* Q = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const T* K = static_cast<const T*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const T* V = static_cast<const T*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  T* O = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sq[r * ld + d] = q0 + r < a.Sq ? to_float(Q[(q0 + r) * a.qs[2] + d]) : 0.f;
  }
  if (tid < kBQ) {
    sm[tid] = kNegInf;
    sl[tid] = 0.f;
  }

  int kv_end = a.kv_end;
  if (a.causal) kv_end = min(kv_end, q0 + kBQ + a.q_offset);

  // score micro-tile: rows rg + 8 * jr, columns cg + 16 * ic
  const int rg = tid / 16, cg = tid % 16;
  // accumulator: row ro, columns co + 4 * i
  const int ro = tid / 4, co = tid % 4;
  const int warp = tid / 32, lane = tid % 32;
  float acc[kMaxD / 4];
#pragma unroll
  for (int i = 0; i < kMaxD / 4; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kBK) {
    const int nk = min(kBK, kv_end - k0);
    __syncthreads();
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool in = r < nk;
      sk[r * ld + d] = in ? to_float(K[(k0 + r) * a.ks[2] + d]) : 0.f;
      sv[r * ld + d] = in ? to_float(V[(k0 + r) * a.vs[2] + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int jr = 0; jr < 4; ++jr)
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) s[jr][ic] = 0.f;
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int jr = 0; jr < 4; ++jr) qv[jr] = sq[(rg + 8 * jr) * ld + d];
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) kv[ic] = sk[(cg + 16 * ic) * ld + d];
#pragma unroll
      for (int jr = 0; jr < 4; ++jr)
#pragma unroll
        for (int ic = 0; ic < 4; ++ic) s[jr][ic] += qv[jr] * kv[ic];
    }
#pragma unroll
    for (int jr = 0; jr < 4; ++jr) {
      const int r = rg + 8 * jr;
      const int qpos = q0 + r + a.q_offset;
#pragma unroll
      for (int ic = 0; ic < 4; ++ic) {
        const int c = cg + 16 * ic;
        const int kpos = k0 + c;
        const bool ok = c < nk && (!a.causal || kpos <= qpos);
        sp[r * (kBK + 1) + c] = ok ? s[jr][ic] * a.scale : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w+7, a lane two columns
    for (int rr = 0; rr < kBQ / 4; ++rr) {
      const int r = warp * (kBQ / 4) + rr;
      float* row = sp + r * (kBK + 1);
      const float x0 = row[lane], x1 = row[lane + 32];
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = sm[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      row[lane] = p0;
      row[lane + 32] = p1;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sl[r] = sl[r] * alpha + sum;
        sm[r] = m_new;
        sa[r] = alpha;
      }
    }
    __syncthreads();

    const float alpha = sa[ro];
#pragma unroll
    for (int i = 0; i < kMaxD / 4; ++i) acc[i] *= alpha;
    const float* prow = sp + ro * (kBK + 1);
    for (int c = 0; c < nk; ++c) {
      const float p = prow[c];
      const float* vrow = sv + c * ld;
#pragma unroll
      for (int i = 0; i < kMaxD / 4; ++i) {
        const int d = co + 4 * i;
        if (d < D) acc[i] += p * vrow[d];
      }
    }
  }
  __syncthreads();

  const int r = q0 + ro;
  if (r < a.Sq) {
    const float denom = fmaxf(sl[ro], 1e-30f);
    T* orow = O + r * a.os[2];
#pragma unroll
    for (int i = 0; i < kMaxD / 4; ++i) {
      const int d = co + 4 * i;
      if (d < D) store(orow + d, acc[i] / denom);
    }
  }
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1) + 3 * kBQ);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention_max_d() { return kMaxD; }

extern "C" long long flash_attention_smem_bytes(int D) {
  return (long long)smem_bytes(D);
}

// dtype: 0 float32, 1 bfloat16.  Strides are in elements, three per tensor
// (batch, head, sequence).  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int causal, int q_offset, int kv_end,
    float scale, void* stream) {
  if (B == 0 || Hq == 0 || Sq == 0) return (int)cudaGetLastError();
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.Hq = Hq;
  a.Hkv = Hkv;
  a.Sq = Sq;
  a.Skv = Skv;
  a.D = D;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = q_strides[i];
    a.ks[i] = k_strides[i];
    a.vs[i] = v_strides[i];
    a.os[i] = o_strides[i];
  }
  a.causal = causal;
  a.q_offset = q_offset;
  a.kv_end = kv_end;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}
