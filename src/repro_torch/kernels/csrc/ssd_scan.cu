// ssd_scan: chunked gated linear attention (the Mamba-2 SSD scan).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (ssd_scan / _ssd_kernel), which computes the model layer's `gla_chunked`
// (src/repro/models/layers.py:314).  Per (batch, head), with a <= 0:
//
//   o_t = q_t . S_t,     S_t = exp(a_t) S_{t-1} + k_t^T v_t      (S: [N, P])
//
// chunk by chunk: with cum the in-chunk prefix sum of a and total its last
// entry,
//
//   o_i  = sum_{j <= i} (q_i . k_j) exp(cum_i - cum_j) v_j        (intra)
//        + (q_i exp(cum_i)) . S_prev                              (inter)
//   S    = exp(total) S_prev + sum_j (k_j exp(total - cum_j))^T v_j
//
// The decay exp(cum_i - cum_j) is taken only where j <= i: above the
// diagonal cum_i - cum_j > 0 can overflow, and inf * 0 would be NaN.
//
// Layout: q, k [B, L, H, N], v [B, L, H, P], a [B, L, H] float32, each with
// its own batch, sequence and head strides (q and k may have head stride 0:
// Mamba-2 broadcasts them over heads) and a contiguous last dimension; o is
// a new contiguous [B, L, H, P].  The TPU layout [BH, L, N] is H = 1.  bf16
// or float32 in, v's type out, float32 arithmetic and state.
//
// Design: one block of 256 threads per (batch, head); blocks carry nothing
// between them.  The TPU grid's sequential chunk dimension becomes a loop
// inside the block, with the [N, P] float32 state resident in shared
// memory.  A chunk of 256 rows would need a 256 x 256 float32 score tile
// (256 KB, over the 227 KB a block may use), so each chunk is cut into
// 64-row tiles: for output tile I, the inter term, then for every kv tile
// J <= I the gated 64 x 64 score tile and its product with v_J; after the
// chunk's outputs, the state update streams the k and v tiles once more.
// Each thread holds a 4 x 4 score micro-tile, or P/4 output columns of one
// row, in registers; shared-memory rows are padded by one float.
//
// Bound on an H100: at the serve path's shape (zamba2-2.7b prefill, B = 4,
// L = 1024, 80 heads, N = P = 64, chunk 256, bf16, q and k shared over
// heads) the function reads q and k once (0.5 MB each), v (42 MB) and a
// (1.3 MB) and writes o (42 MB): 86 MB, 26 us at 3.35 TB/s.  Its products,
// 2 * B * H * (L * c / 2 * (N + P) + 2 * L * N * P) = 16 GFLOP, take 16 us
// at 989 TFLOP/s bf16: bound by bytes.  This kernel runs them on the CUDA
// cores in float32 out of shared memory, with only B * H = 320 blocks for
// 132 SMs, so it is far from that bound; tensor-core tiles and splitting
// the chunk loop across blocks (a second pass for the carried state) are
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kT = 64;            // rows per tile of a chunk
constexpr int kMaxNP = 128;
constexpr int kScanBlock = 16;    // association of the in-chunk prefix sums
constexpr int kMaxChunk = kThreads * kScanBlock;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* a;
  void* o;
  int B, L, H, N, P, chunk;
  long long qs[3], ks[3], vs[3], as[3];   // batch, sequence, head strides
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Inclusive prefix sums of x[0], x[stride], ... (n <= kMaxChunk values)
// into out, in the association of `jnp.cumsum` on the CPU and of the plain
// version's `blocked_cumsum`: sequential within blocks of 16, and each block
// offset by the prefix of the earlier blocks' totals, taken the same way.
// The gates exp(cum_i - cum_j) take differences of sums that reach -100 and
// more, so another association would move them by 1e-4 relative.  Ends
// with a barrier.
__device__ void blocked_cumsum(const float* x, long long stride, int n,
                               float* out, float* tot, float* carry) {
  const int tid = threadIdx.x;
  const int nb = (n + kScanBlock - 1) / kScanBlock;
  if (tid < nb) {                         // within each block, in order
    float s = 0.f;
    for (int i = tid * kScanBlock; i < min(n, (tid + 1) * kScanBlock); ++i) {
      s += x[i * stride];
      out[i] = s;
    }
    tot[tid] = s;
  }
  __syncthreads();
  if (tid == 0 && nb > 1) {               // prefix of the block totals
    if (nb <= kScanBlock) {
      float s = 0.f;
      for (int b = 0; b < nb; ++b) carry[b] = s += tot[b];
    } else {                              // the same two-level form again
      float outer = 0.f, s = 0.f;
      for (int b = 0; b < nb; ++b) {
        if (b % kScanBlock == 0) s = 0.f;
        s += tot[b];
        carry[b] = b >= kScanBlock ? s + outer : s;
        if (b % kScanBlock == kScanBlock - 1 || b == nb - 1) outer += s;
      }
    }
  }
  __syncthreads();
  for (int i = kScanBlock + tid; i < n; i += blockDim.x)
    out[i] += carry[i / kScanBlock - 1];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(Args g) {
  extern __shared__ float smem[];
  const int N = g.N, P = g.P, c = g.chunk;
  const int ldn = N + 1, ldp = P + 1;
  float* sS = smem;                   // N x ldp   carried state
  float* sQ = sS + N * ldp;           // kT x ldn
  float* sK = sQ + kT * ldn;          // kT x ldn
  float* sV = sK + kT * ldn;          // kT x ldp
  float* sG = sV + kT * ldp;          // kT x (kT + 1) gated scores
  float* sCum = sG + kT * (kT + 1);   // chunk
  float* sTot = sCum + c;             // kMaxChunk / kScanBlock
  float* sCarry = sTot + kMaxChunk / kScanBlock;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x % g.H;
  const T* Q = static_cast<const T*>(g.q) + b * g.qs[0] + h * g.qs[2];
  const T* K = static_cast<const T*>(g.k) + b * g.ks[0] + h * g.ks[2];
  const T* V = static_cast<const T*>(g.v) + b * g.vs[0] + h * g.vs[2];
  const float* A = g.a + b * g.as[0] + h * g.as[2];
  T* O = static_cast<T*>(g.o) + ((long long)b * g.L * g.H + h) * P;
  const long long o_row = (long long)g.H * P;

  for (int e = tid; e < N * ldp; e += kThreads) sS[e] = 0.f;

  // score micro-tile: rows rg + 16 * jr, columns cg + 16 * ic
  const int rg = tid / 16, cg = tid % 16;
  // output: row ro, columns po + 4 * i
  const int ro = tid / 4, po = tid % 4;

  for (int c0 = 0; c0 < g.L; c0 += c) {
    __syncthreads();
    blocked_cumsum(A + c0 * g.as[1], g.as[1], c, sCum, sTot, sCarry);
    const float total = sCum[c - 1];

    for (int i0 = 0; i0 < c; i0 += kT) {
      const int ni = min(kT, c - i0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        sQ[r * ldn + n] =
            r < ni ? to_float(Q[(c0 + i0 + r) * g.qs[1] + n]) : 0.f;
      }
      __syncthreads();

      float acc[kMaxNP / 4];
#pragma unroll
      for (int i = 0; i < kMaxNP / 4; ++i) acc[i] = 0.f;
      if (ro < ni) {                 // inter: (q exp(cum)) . S_prev
        const float ec = expf(sCum[i0 + ro]);
        for (int n = 0; n < N; ++n) {
          const float qd = sQ[ro * ldn + n] * ec;
          const float* srow = sS + n * ldp;
#pragma unroll
          for (int i = 0; i < kMaxNP / 4; ++i) {
            const int p = po + 4 * i;
            if (p < P) acc[i] += qd * srow[p];
          }
        }
      }

      for (int j0 = 0; j0 <= i0; j0 += kT) {
        const int nj = min(kT, c - j0);
        __syncthreads();
        for (int e = tid; e < kT * N; e += kThreads) {
          const int r = e / N, n = e % N;
          sK[r * ldn + n] =
              r < nj ? to_float(K[(c0 + j0 + r) * g.ks[1] + n]) : 0.f;
        }
        for (int e = tid; e < kT * P; e += kThreads) {
          const int r = e / P, p = e % P;
          sV[r * ldp + p] =
              r < nj ? to_float(V[(c0 + j0 + r) * g.vs[1] + p]) : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int jr = 0; jr < 4; ++jr)
#pragma unroll
          for (int ic = 0; ic < 4; ++ic) s[jr][ic] = 0.f;
        for (int n = 0; n < N; ++n) {
          float qv[4], kv[4];
#pragma unroll
          for (int jr = 0; jr < 4; ++jr) qv[jr] = sQ[(rg + 16 * jr) * ldn + n];
#pragma unroll
          for (int ic = 0; ic < 4; ++ic) kv[ic] = sK[(cg + 16 * ic) * ldn + n];
#pragma unroll
          for (int jr = 0; jr < 4; ++jr)
#pragma unroll
            for (int ic = 0; ic < 4; ++ic) s[jr][ic] += qv[jr] * kv[ic];
        }
#pragma unroll
        for (int jr = 0; jr < 4; ++jr) {
          const int r = rg + 16 * jr;
#pragma unroll
          for (int ic = 0; ic < 4; ++ic) {
            const int cc = cg + 16 * ic;
            float gated = 0.f;
            if (r < ni && cc < nj && j0 + cc <= i0 + r)
              gated = s[jr][ic] * expf(sCum[i0 + r] - sCum[j0 + cc]);
            sG[r * (kT + 1) + cc] = gated;
          }
        }
        __syncthreads();

        if (ro < ni) {               // intra: gated scores . v
          const float* grow = sG + ro * (kT + 1);
          for (int cc = 0; cc < nj; ++cc) {
            const float gv = grow[cc];
            const float* vrow = sV + cc * ldp;
#pragma unroll
            for (int i = 0; i < kMaxNP / 4; ++i) {
              const int p = po + 4 * i;
              if (p < P) acc[i] += gv * vrow[p];
            }
          }
        }
      }

      if (ro < ni) {
        T* orow = O + (c0 + i0 + ro) * o_row;
#pragma unroll
        for (int i = 0; i < kMaxNP / 4; ++i) {
          const int p = po + 4 * i;
          if (p < P) store(orow + p, acc[i]);
        }
      }
    }

    // state update: S <- exp(total) S + (k exp(total - cum))^T v
    __syncthreads();
    const float et = expf(total);
    for (int e = tid; e < N * P; e += kThreads) {
      const int n = e / P, p = e % P;
      sS[n * ldp + p] *= et;
    }
    for (int j0 = 0; j0 < c; j0 += kT) {
      const int nj = min(kT, c - j0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kThreads) {
        const int r = e / N, n = e % N;
        sK[r * ldn + n] =
            r < nj ? to_float(K[(c0 + j0 + r) * g.ks[1] + n]) *
                         expf(total - sCum[j0 + r])
                   : 0.f;
      }
      for (int e = tid; e < kT * P; e += kThreads) {
        const int r = e / P, p = e % P;
        sV[r * ldp + p] =
            r < nj ? to_float(V[(c0 + j0 + r) * g.vs[1] + p]) : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < N * P; e += kThreads) {
        const int n = e / P, p = e % P;
        float s = 0.f;
        for (int r = 0; r < nj; ++r) s += sK[r * ldn + n] * sV[r * ldp + p];
        sS[n * ldp + p] += s;
      }
    }
  }
}

size_t smem_bytes(int N, int P, int chunk) {
  const int ldn = N + 1, ldp = P + 1;
  return sizeof(float) * ((size_t)N * ldp + 2 * kT * ldn + kT * ldp +
                          kT * (kT + 1) + chunk +
                          2 * (kMaxChunk / kScanBlock));
}

template <typename T>
int launch(const Args& g, cudaStream_t stream) {
  const size_t smem = smem_bytes(g.N, g.P, g.chunk);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_kernel<T><<<g.B * g.H, kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_max_np() { return kMaxNP; }

extern "C" int ssd_scan_max_chunk() { return kMaxChunk; }

extern "C" long long ssd_scan_smem_bytes(int N, int P, int chunk) {
  return (long long)smem_bytes(N, P, chunk);
}

// dtype: 0 float32, 1 bfloat16 (q, k, v and o; a is float32).  Strides are
// in elements, three per tensor (batch, sequence, head).  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v,
                               const float* a, void* o, int dtype, int B,
                               int L, int H, int N, int P, int chunk,
                               const long long* q_strides,
                               const long long* k_strides,
                               const long long* v_strides,
                               const long long* a_strides, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  Args g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.a = a;
  g.o = o;
  g.B = B;
  g.L = L;
  g.H = H;
  g.N = N;
  g.P = P;
  g.chunk = chunk;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = q_strides[i];
    g.ks[i] = k_strides[i];
    g.vs[i] = v_strides[i];
    g.as[i] = a_strides[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(g, s) : launch<float>(g, s);
}
