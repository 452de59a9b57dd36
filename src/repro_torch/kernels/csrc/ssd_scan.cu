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
//        + exp(cum_i) (q_i . S_prev)                              (inter)
//   S    = exp(total) S_prev + sum_j (k_j exp(total - cum_j))^T v_j
//
// The decay exp(cum_i - cum_j) is taken only where j <= i: above the
// diagonal cum_i - cum_j > 0 can overflow, and inf * 0 would be NaN.  The
// prefix sums follow `blocked_cumsum`'s association (see below).
//
// Layout: q, k [B, L, H, N], v [B, L, H, P], a [B, L, H] float32, each with
// its own batch, sequence and head strides (q and k may have head stride 0:
// Mamba-2 broadcasts them over heads, and they are read as such views) and
// a contiguous last dimension; o is a new contiguous [B, L, H, P].  The TPU
// layout [BH, L, N] is H = 1.  bf16 or float32 in, v's type out; the state
// is float32.
//
// Bound on an H100: at the serve path's shape (zamba2-2.7b prefill, B = 4,
// L = 1024, 80 heads, N = P = 64, chunk 256, bf16, q and k shared over
// heads) the function reads q and k once (0.5 MB each), v (42 MB) and a
// (1.3 MB) and writes o (42 MB): 86 MB, 26 us at 3.35 TB/s.  Its products,
// 2 * B * H * (L * c / 2 * (N + P) + 2 * L * N * P) = 16 GFLOP, take 16 us
// at 989 TFLOP/s bf16: bound by bytes.
//
// Design: the reference layer's own form.  The TPU kernel carries the
// state through its sequential chunk grid; here the chunks run in parallel
// and only the state handed from chunk to chunk is in order:
//
//   state_c = sum_j (k_j exp(total_c - cum_j))^T v_j       (chunk c alone)
//   prev_0 = 0,  prev_{c+1} = exp(total_c) prev_c + state_c (in order)
//   o_i = intra_i + exp(cum_i) (q_i . prev_c)
//
// The order of that recurrence, not an associative scan's, keeps the
// float32 sums those of the plain version, which carries the state in
// order.
//
// bf16 (the serve path): one fused kernel, ssd_chunk_tc, one CTA of 8
// warps per (batch, head, chunk): B * H * L / chunk = 1280 CTAs at the
// serve shape, two an SM (102 KB of shared memory, 128 registers).
//  * k and v of the chunk come into shared memory once, by cp.async
//    (16 B a thread, one group per 64 rows, rows padded by 16 B so
//    ldmatrix is conflict-free; the head-broadcast q and k are read as
//    the views they are), while the prefix sums run.
//  * Products on the tensor cores: mma.sync m16n8k16, bf16 in, float32
//    sums.  q k^T takes the bf16 inputs as they are: exact products.
//    Operands held in float32 (the gated scores G, the decayed k, the
//    state) are never rounded to bf16 once: each is split into three bf16
//    terms, t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1), and
//    multiplied three times, which keeps x to float32's 24 bits.  Rounding
//    them once loses to the plain version's 2e-2 on slow decays
//    (tests/test_torch_ssd_scan.py shows it on the CPU); two terms (16
//    bits) meet 2e-2 but leave many more bf16 outputs an ulp away from the
//    plain version's than float32's own order does, and such flips grow
//    through the 54 layers of the bf16 prefill.  The gate is expf of the
//    difference cum_i - cum_j, as the plain version takes it.  The inter
//    term multiplies q, which is exact, by the split state and scales each
//    row by exp(cum_i) afterwards.
//  * The state goes from chunk to chunk through a float32 workspace
//    [B, nc - 1, H, N, P] (16 MB at the serve shape) with a release flag
//    per slot: chunk c computes state_c, waits for prev_c in slot c - 1,
//    publishes prev_{c+1} = exp(total_c) prev_c + state_c in slot c, and
//    only then computes its outputs (the intra term: warp w owns the
//    16-row slices w and 15 - w, equal work on the causal triangle; per 16
//    kv columns up to the diagonal S, the gate masked on the diagonal
//    block only, G v; then the inter term).  Each chunk reads one state
//    and writes one, so the state traffic grows with L, and the wait is
//    one hand-over, not a chunk's work.  CTAs take tickets from an atomic
//    counter in launch order, chunk slowest: ticket t is chunk t / (B H),
//    so chunk c - 1 of the same head took its ticket B H earlier and has
//    started (the wait cannot deadlock), and when B H fills the card's
//    slots it has long finished.
//  * It takes N, P <= 64 and chunks <= 256 rows (zamba2's widths).
//
// bf16, wide heads (xLSTM's mLSTM: N = P = 256, chunk 256, and its
// normaliser): ssd_wide_tc.  A chunk's float32 state at 256 x 256 is 256 KB,
// more than a CTA's shared memory, so one CTA of 8 warps takes (batch, head,
// chunk, 64 state columns): B * H * L / chunk * P / 64 = 256 CTAs at the
// serve shape, one an SM (175 KB of shared memory).  Each CTA holds the
// chunk's k (all N columns) and its 64 columns of v in shared memory, forms
// its [N, 64] tile of the chunk state (warp w: state rows 16 w and
// 16 (w + 8)), hands that tile on as ssd_chunk_tc hands the whole state
// (one ready flag per tile), computes S = q k^T over all N (16-column
// k-steps, q's fragments in registers) for its output columns, and after
// the intra term reuses k's shared memory for prev_c's tile in three bf16
// terms.  The q k^T products are repeated by the P / 64 column tiles of a
// chunk.  With a normaliser pointer (den, [B, L, H] in v's type) the
// column-0 tile also computes what the reference's second call,
// gla_chunked(q, k, ones), computes: den_i = sum_{j <= i} G_ij +
// exp(cum_i) (q_i . nprev_c), the row sums of the float32 gated scores it
// already forms and q against the normaliser state nprev (the column sums
// of the decayed k, handed on in float32 beside the state tile), so the
// normaliser takes no second launch.  It takes N <= 256 (a multiple of 8),
// any P that is a multiple of 8, and chunks <= 256 rows.
//
// float32 (the parity path): the CUDA-core kernel ssd_f32_kernel, one
// block of 256 threads per (batch, head) that walks the chunks in order
// with the [N, P] state in shared memory and 64-row tiles (float32 FMAs
// out of shared memory), since bf16 products cannot meet float32's 2e-5.
// It takes N, P <= 128 and chunks <= 4096 rows.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kT = 64;            // rows per tile of a chunk
constexpr int kMaxNP = 128;
constexpr int kScanBlock = 16;    // association of the in-chunk prefix sums
constexpr int kMaxChunk = 4096;
constexpr int kScanSlots = kMaxChunk / kScanBlock;
constexpr int kF32Threads = 256;  // float32: one block per (batch, head)
constexpr int kTcThreads = 256;   // bf16: 8 warps per chunk
constexpr int kTcMaxNP = 64;      // bf16: N and P
constexpr int kTcMaxChunk = 256;  // bf16: rows of a chunk
constexpr int kWMaxN = 256;       // bf16 wide: N
constexpr int kWPT = 64;          // bf16 wide: state columns a CTA

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* a;
  void* o;
  float* ws;                      // bf16: [B, nc - 1, H, N, P], the
                                  // states entering chunks 1 .. nc - 1
  int* sync;                      // bf16: ticket counter, then one flag
                                  // per ws slot (wide: per slot and
                                  // column tile), all zero
  void* den;                      // wide only: the normaliser [B, L, H],
                                  // or null
  int B, L, H, N, P, chunk, nc;
  long long qs[3], ks[3], vs[3], as[3];   // batch, sequence, head strides
};

__device__ __forceinline__ long long ws_slot(const Args& g, int b, int c,
                                             int h) {
  return ((long long)b * (g.nc - 1) + c) * g.H + h;
}

// Inclusive prefix sums of x[0], x[stride], ... (n <= kMaxChunk values)
// into out, in the association of `jnp.cumsum` on the CPU and of the plain
// version's `blocked_cumsum`: sequential within blocks of 16, and each block
// offset by the prefix of the earlier blocks' totals, taken the same way.
// The gates exp(cum_i - cum_j) take differences of sums that reach -100 and
// more, so another association would move them by 1e-4 relative.  The
// first n values of a longer run's sums are these.  The values are staged
// in shared memory first, all loads in flight at once.  Ends with a
// barrier.
__device__ void blocked_cumsum(const float* x, long long stride, int n,
                               float* out, float* tot, float* carry) {
  const int tid = threadIdx.x;
  const int nb = (n + kScanBlock - 1) / kScanBlock;
  for (int i = tid; i < n; i += blockDim.x) out[i] = x[i * stride];
  __syncthreads();
  for (int blk = tid; blk < nb; blk += blockDim.x) {   // within each block
    float s = 0.f;
    for (int i = blk * kScanBlock; i < min(n, (blk + 1) * kScanBlock); ++i) {
      s += out[i];
      out[i] = s;
    }
    tot[blk] = s;
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

// ------------------------ float32: the CUDA cores -------------------------

// One block per (batch, head), the chunks in order with the state in
// shared memory; each chunk cut into 64-row tiles: for output tile I, the
// inter term, then for every kv tile J <= I the gated 64 x 64 score tile and
// its product with v_J; after the chunk's outputs, the state update streams
// the k and v tiles once more.  Each thread holds a 4 x 4 score micro-tile,
// or P/4 output columns of one row, in registers; shared-memory rows are
// padded by one float.
__global__ void __launch_bounds__(kF32Threads) ssd_f32_kernel(Args g) {
  extern __shared__ float smem_f[];
  const int N = g.N, P = g.P, c = g.chunk;
  const int ldn = N + 1, ldp = P + 1;
  float* sS = smem_f;                 // N x ldp   carried state
  float* sQ = sS + N * ldp;           // kT x ldn
  float* sK = sQ + kT * ldn;          // kT x ldn
  float* sV = sK + kT * ldn;          // kT x ldp
  float* sG = sV + kT * ldp;          // kT x (kT + 1) gated scores
  float* sCum = sG + kT * (kT + 1);   // chunk
  float* sTot = sCum + c;             // kScanSlots
  float* sCarry = sTot + kScanSlots;

  const int tid = threadIdx.x;
  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x % g.H;
  const float* Q = static_cast<const float*>(g.q) + b * g.qs[0] +
                   h * g.qs[2];
  const float* K = static_cast<const float*>(g.k) + b * g.ks[0] +
                   h * g.ks[2];
  const float* V = static_cast<const float*>(g.v) + b * g.vs[0] +
                   h * g.vs[2];
  const float* A = g.a + b * g.as[0] + h * g.as[2];
  float* O = static_cast<float*>(g.o) + ((long long)b * g.L * g.H + h) * P;
  const long long o_row = (long long)g.H * P;

  for (int e = tid; e < N * ldp; e += kF32Threads) sS[e] = 0.f;

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
      for (int e = tid; e < kT * N; e += kF32Threads) {
        const int r = e / N, n = e % N;
        sQ[r * ldn + n] = r < ni ? Q[(c0 + i0 + r) * g.qs[1] + n] : 0.f;
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
        for (int e = tid; e < kT * N; e += kF32Threads) {
          const int r = e / N, n = e % N;
          sK[r * ldn + n] = r < nj ? K[(c0 + j0 + r) * g.ks[1] + n] : 0.f;
        }
        for (int e = tid; e < kT * P; e += kF32Threads) {
          const int r = e / P, p = e % P;
          sV[r * ldp + p] = r < nj ? V[(c0 + j0 + r) * g.vs[1] + p] : 0.f;
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
        float* orow = O + (c0 + i0 + ro) * o_row;
#pragma unroll
        for (int i = 0; i < kMaxNP / 4; ++i) {
          const int p = po + 4 * i;
          if (p < P) orow[p] = acc[i];
        }
      }
    }

    // state update: S <- exp(total) S + (k exp(total - cum))^T v
    __syncthreads();
    const float et = expf(total);
    for (int e = tid; e < N * P; e += kF32Threads) {
      const int n = e / P, p = e % P;
      sS[n * ldp + p] *= et;
    }
    for (int j0 = 0; j0 < c; j0 += kT) {
      const int nj = min(kT, c - j0);
      __syncthreads();
      for (int e = tid; e < kT * N; e += kF32Threads) {
        const int r = e / N, n = e % N;
        sK[r * ldn + n] = r < nj ? K[(c0 + j0 + r) * g.ks[1] + n] *
                                       expf(total - sCum[j0 + r])
                                 : 0.f;
      }
      for (int e = tid; e < kT * P; e += kF32Threads) {
        const int r = e / P, p = e % P;
        sV[r * ldp + p] = r < nj ? V[(c0 + j0 + r) * g.vs[1] + p] : 0.f;
      }
      __syncthreads();
      for (int e = tid; e < N * P; e += kF32Threads) {
        const int n = e / P, p = e % P;
        float s = 0.f;
        for (int r = 0; r < nj; ++r) s += sK[r * ldn + n] * sV[r * ldp + p];
        sS[n * ldp + p] += s;
      }
    }
  }
}

// --------------------------- bf16: tensor cores --------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
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

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16 terms a float32-held operand is split into: three keep about 24
// bits, as float32 holds them
constexpr int kTerms = 3;

// (x0, x1) as kTerms bf16 pairs: t[0] = bf16(x), t[i] = bf16(x - t[0] -
// .. - t[i - 1]) (each difference exact in float32).
__device__ __forceinline__ void split(float x0, float x1, uint32_t* t) {
#pragma unroll
  for (int i = 0; i < kTerms; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
    t[i] = as_u32(h);
    x0 -= __low2float(h);
    x1 -= __high2float(h);
  }
}

__device__ __forceinline__ float2 unpack(uint32_t x) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&x));
}

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Rows [0, rows) of a bf16 matrix with row stride `stride` and `cols`
// columns (a multiple of 8) into shared memory rows of `ld` elements,
// 16 B per cp.async; rows past `valid` and columns up to `padded` are
// zero.
__device__ __forceinline__ void load_rows(bf16* dst, int ld, const bf16* src,
                                          long long stride, int rows,
                                          int valid, int cols, int padded) {
  const int per_row = padded / 8;
  for (int e = threadIdx.x; e < rows * per_row; e += blockDim.x) {
    const int r = e / per_row, col = (e % per_row) * 8;
    bf16* d = dst + r * ld + col;
    if (r < valid && col < cols)
      cp_async16(d, src + r * stride + col);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

// q's A fragments of one 16-row slice, read from global memory (q is
// small and shared by the heads): k-step ks covers columns 16ks .. 16ks+15.
__device__ __forceinline__ void q_frags(uint32_t (*qa)[4], const bf16* Q,
                                        long long stride, int row, int c,
                                        int N) {
  const int g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < kTcMaxNP / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + g4 + 8 * (e % 2);
      const int col = 16 * ks + 2 * t4 + 8 * (e / 2);
      qa[ks][e] = r < c && col < N
                      ? *reinterpret_cast<const uint32_t*>(Q + r * stride +
                                                           col)
                      : 0u;
    }
  }
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

// One CTA of 8 warps per (batch, head, chunk), chunk <= 256 rows, N and
// P <= 64.  CTAs take tickets in launch order from sync[0]; ticket t is
// chunk t / (B H) of batch (t % (B H)) / H, head t % H, so the CTA of the
// chunk before has always started, and waiting on it cannot deadlock.
//  0. k and v of the chunk into shared memory (cp.async, one group per 64
//     rows), cum, w_j = exp(total - cum_j).
//  1. state_c = sum_j (k_j w_j)^T v_j, warp w: state rows 16 (w % 4),
//     columns 32 (w / 4), starting as the first rows arrive; k_j w_j is
//     formed in registers from the transposed k fragments and split in
//     kTerms bf16 terms.
//  2. the hand-over: once chunk c - 1 has published prev_c (ws slot c - 1),
//     read it in the layout of the state fragments, publish prev_{c+1} =
//     exp(total) prev_c + state_c (the plain version's order) in slot c,
//     and split prev_c into shared memory.
//  3. intra for the warp's 16-row slices w and 15 - w (equal work on the
//     causal triangle): per 16 kv columns up to the diagonal, S = q k^T
//     (exact bf16 products), G = S exp(cum_i - cum_j) on j <= i (expf of
//     the difference, as the plain version takes it), split in kTerms
//     terms, and acc += sum_t G_t v.
//  4. inter: acc += exp(cum_i) (q_i . prev_c) (q exact, prev_c split), and
//     the bf16 outputs.
__global__ void __launch_bounds__(kTcThreads, 2) ssd_chunk_tc(Args g) {
  constexpr int ld = kTcMaxNP + 8;      // shared rows, padded by 16 B
  extern __shared__ __align__(16) uint8_t smem_b[];
  bf16* sK = reinterpret_cast<bf16*>(smem_b);   // kTcMaxChunk x ld
  bf16* sV = sK + kTcMaxChunk * ld;             // kTcMaxChunk x ld
  bf16* sP = sV + kTcMaxChunk * ld;             // kTerms x kTcMaxNP x ld
  float* sCum = reinterpret_cast<float*>(sP + kTerms * kTcMaxNP * ld);
  float* sW = sCum + kTcMaxChunk;               // exp(total - cum)
  float* sTot = sW + kTcMaxChunk;               // 16 + 16 scan slots
  float* sCarry = sTot + 16;
  int* sTicket = reinterpret_cast<int*>(sCarry + 16);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g4 = lane / 4, t4 = lane % 4;
  if (tid == 0) *sTicket = atomicAdd(g.sync, 1);
  __syncthreads();
  const int ticket = *sTicket;
  const int ci = ticket / (g.B * g.H);
  const int b = (ticket % (g.B * g.H)) / g.H, h = ticket % g.H;
  const int N = g.N, P = g.P, c = g.chunk;
  const int NP = round16(N), PP = round16(P);
  const int c16 = round16(c);
  const int n_groups = (c16 + kT - 1) / kT;
  const int c0 = ci * c;
  const bf16* Q = static_cast<const bf16*>(g.q) + b * g.qs[0] + h * g.qs[2] +
                  c0 * g.qs[1];
  const bf16* K = static_cast<const bf16*>(g.k) + b * g.ks[0] + h * g.ks[2] +
                  c0 * g.ks[1];
  const bf16* V = static_cast<const bf16*>(g.v) + b * g.vs[0] + h * g.vs[2] +
                  c0 * g.vs[1];
  const float* A = g.a + b * g.as[0] + h * g.as[2] + c0 * g.as[1];
  bf16* O = static_cast<bf16*>(g.o) + ((long long)b * g.L * g.H + h) * P +
            (long long)c0 * g.H * P;
  const long long o_row = (long long)g.H * P;
  const long long np = (long long)N * P;
  const bool has_prev = ci > 0, has_next = ci + 1 < g.nc;

  // 0. loads (a group per 64 rows), prefix sums, decays
  for (int grp = 0; grp < n_groups; ++grp) {
    const int r0 = grp * kT, rows = min(kT, c16 - r0);
    load_rows(sK + r0 * ld, ld, K + r0 * g.ks[1], g.ks[1], rows, c - r0, N,
              NP);
    load_rows(sV + r0 * ld, ld, V + r0 * g.vs[1], g.vs[1], rows, c - r0, P,
              PP);
    cp_async_commit();
  }
  if (has_prev)                         // rows and columns past N and P
    for (int e = tid; e < kTerms * kTcMaxNP * ld / 8; e += kTcThreads)
      reinterpret_cast<uint4*>(sP)[e] = make_uint4(0, 0, 0, 0);
  blocked_cumsum(A, g.as[1], c, sCum, sTot, sCarry);
  const float total = sCum[c - 1];
  for (int j = c + tid; j < c16; j += kTcThreads) sCum[j] = 0.f;
  for (int j = tid; j < c16; j += kTcThreads)
    sW[j] = j < c ? expf(total - sCum[j]) : 0.f;

  // 1. the chunk's own state (not needed for the last chunk), each group
  // of rows as it arrives
  const int mt = warp % 4, n0 = 32 * (warp / 4);   // state rows, columns
  float st[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) st[i][e] = 0.f;
  for (int grp = 0; grp < n_groups; ++grp) {
    // groups grp + 1 .. n_groups - 1 may still be in flight
    switch (n_groups - 1 - grp) {
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    if (!has_next || 16 * mt >= NP || n0 >= PP) continue;
    for (int j16 = grp * kT; j16 < min(c16, (grp + 1) * kT); j16 += 16) {
      // A = (k w)^T: matrix i holds k rows 8 (i / 2), state rows 8 (i % 2);
      // a lane's pairs are rows j16 + 2t (+ 1) (+ 8)
      const int mi = lane / 8;
      uint32_t kr[4], ak[kTerms][4];
      ldsm4_t(kr, sK + (j16 + (mi / 2) * 8 + lane % 8) * ld + 16 * mt +
                      (mi % 2) * 8);
      const float2 w0 = *reinterpret_cast<const float2*>(sW + j16 + 2 * t4);
      const float2 w8 =
          *reinterpret_cast<const float2*>(sW + j16 + 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 x = unpack(kr[e]);
        const float2 w = e < 2 ? w0 : w8;
        uint32_t t[kTerms];
        split(x.x * w.x, x.y * w.y, t);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) ak[i][e] = t[i];
      }
#pragma unroll
      for (int np2 = 0; np2 < 2; ++np2) {
        if (n0 + 16 * np2 >= PP) continue;
        uint32_t vb[4];
        ldsm4_t(vb, sV + (j16 + lane % 16) * ld + n0 + 16 * np2 +
                        (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          mma(st[2 * np2], ak[i], vb[0], vb[1]);
          mma(st[2 * np2 + 1], ak[i], vb[2], vb[3]);
        }
      }
    }
  }
  // 2. the hand-over: prev_c from chunk c - 1, prev_{c+1} to chunk c + 1;
  // a thread's elements are those of its state fragments
  float prev[4][4];
  if (has_prev) {
    if (tid == 0) {
      // seconds of polling mean a broken chain: fail rather than hang
      const int* flag = g.sync + 1 + ws_slot(g, b, ci - 1, h);
      for (int spins = 0; ld_acquire(flag) == 0;)
        if (++spins > (1 << 22)) __trap();
    }
    __syncthreads();
    const float* S = g.ws + ws_slot(g, b, ci - 1, h) * np;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = 16 * mt + g4, col = n0 + 8 * nt + 2 * t4;
      const bool in_col = col < P;            // P is a multiple of 8
      const float2 lo = in_col && r < N
          ? __ldcg(reinterpret_cast<const float2*>(S + r * P + col))
          : make_float2(0.f, 0.f);
      const float2 hi = in_col && r + 8 < N
          ? __ldcg(reinterpret_cast<const float2*>(S + (r + 8) * P + col))
          : make_float2(0.f, 0.f);
      prev[nt][0] = lo.x;
      prev[nt][1] = lo.y;
      prev[nt][2] = hi.x;
      prev[nt][3] = hi.y;
    }
  }
  if (has_next) {
    const float decay = expf(total);
    float* S = g.ws + ws_slot(g, b, ci, h) * np;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = 16 * mt + g4, col = n0 + 8 * nt + 2 * t4;
      if (col >= P) continue;
      float x[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[e] = has_prev ? fmaf(prev[nt][e], decay, st[nt][e]) : st[nt][e];
      if (r < N)
        *reinterpret_cast<float2*>(S + r * P + col) = make_float2(x[0], x[1]);
      if (r + 8 < N)
        *reinterpret_cast<float2*>(S + (r + 8) * P + col) =
            make_float2(x[2], x[3]);
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(g.sync + 1 + ws_slot(g, b, ci, h), 1);
  }
  if (has_prev) {                             // prev_c as kTerms bf16 terms
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + 8 * nt + 2 * t4;
      if (col >= P) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = 16 * mt + g4 + 8 * half;
        if (r >= N) continue;
        uint32_t t[kTerms];
        split(prev[nt][2 * half], prev[nt][2 * half + 1], t);
#pragma unroll
        for (int i = 0; i < kTerms; ++i)
          *reinterpret_cast<uint32_t*>(sP + (i * kTcMaxNP + r) * ld + col) =
              t[i];
      }
    }
  }

  // 3. intra, slices w and 15 - w
  float acc[2][kTcMaxNP / 8][4];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int nt = 0; nt < kTcMaxNP / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][nt][e] = 0.f;
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int i0 = 16 * (sl == 0 ? warp : 15 - warp);
    if (i0 >= c) continue;
    uint32_t qa[kTcMaxNP / 16][4];
    q_frags(qa, Q, g.qs[1], i0, c, N);
    const int ia = i0 + g4, ib = ia + 8;
    const float cum_a = sCum[ia], cum_b = sCum[ib];   // 0 past the chunk
    for (int j16 = 0; j16 <= i0; j16 += 16) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kTcMaxNP / 16; ++ks) {
        if (16 * ks >= NP) continue;
        uint32_t kb[4];
        ldsm4(kb, sK + (j16 + lane % 8 + (lane / 16) * 8) * ld + 16 * ks +
                      ((lane / 8) % 2) * 8);
        mma(sc[0], qa[ks], kb[0], kb[1]);
        mma(sc[1], qa[ks], kb[2], kb[3]);
      }
      // G on j <= i, as A fragments in kTerms bf16 terms (a0/a1 columns
      // 2t, a2/a3 columns 8 + 2t); the causal mask only on the diagonal
      // block and rows past a ragged chunk's end
      const bool edge = j16 == i0 || i0 + 16 > c;
      uint32_t gk[kTerms][4];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = j16 + 8 * jt + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(sCum + j);
        float x[4] = {sc[jt][0] * expf(cum_a - cj.x),
                      sc[jt][1] * expf(cum_a - cj.y),
                      sc[jt][2] * expf(cum_b - cj.x),
                      sc[jt][3] * expf(cum_b - cj.y)};
        if (edge) {
          if (j > ia || ia >= c) x[0] = 0.f;
          if (j + 1 > ia || ia >= c) x[1] = 0.f;
          if (j > ib || ib >= c) x[2] = 0.f;
          if (j + 1 > ib || ib >= c) x[3] = 0.f;
        }
        uint32_t ta[kTerms], tb[kTerms];
        split(x[0], x[1], ta);
        split(x[2], x[3], tb);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          gk[i][2 * jt] = ta[i];
          gk[i][2 * jt + 1] = tb[i];
        }
      }
#pragma unroll
      for (int np2 = 0; np2 < kTcMaxNP / 16; ++np2) {
        if (16 * np2 >= PP) continue;
        uint32_t vb[4];
        ldsm4_t(vb, sV + (j16 + lane % 16) * ld + 16 * np2 +
                        (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          mma(acc[sl][2 * np2], gk[i], vb[0], vb[1]);
          mma(acc[sl][2 * np2 + 1], gk[i], vb[2], vb[3]);
        }
      }
    }
  }

  if (has_prev) __syncthreads();             // sP complete

  // 4. inter and the outputs
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int i0 = 16 * (sl == 0 ? warp : 15 - warp);
    if (i0 >= c) continue;
    const int ia = i0 + g4, ib = ia + 8;
    if (has_prev) {
      uint32_t qa[kTcMaxNP / 16][4];
      q_frags(qa, Q, g.qs[1], i0, c, N);
      const float ea = ia < c ? expf(sCum[ia]) : 0.f;
      const float eb = ib < c ? expf(sCum[ib]) : 0.f;
#pragma unroll
      for (int np2 = 0; np2 < kTcMaxNP / 16; ++np2) {
        if (16 * np2 >= PP) continue;
        float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kTcMaxNP / 16; ++ks) {
          if (16 * ks >= NP) continue;
          const int off = (16 * ks + lane % 16) * ld + 16 * np2 +
                          (lane / 16) * 8;
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            uint32_t pb[4];
            ldsm4_t(pb, sP + t * kTcMaxNP * ld + off);
            mma(tmp[0], qa[ks], pb[0], pb[1]);
            mma(tmp[1], qa[ks], pb[2], pb[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[sl][2 * np2 + e][0] += ea * tmp[e][0];
          acc[sl][2 * np2 + e][1] += ea * tmp[e][1];
          acc[sl][2 * np2 + e][2] += eb * tmp[e][2];
          acc[sl][2 * np2 + e][3] += eb * tmp[e][3];
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTcMaxNP / 8; ++nt) {
      const int p = 8 * nt + 2 * t4;         // P is a multiple of 8
      if (p >= P) continue;
      if (ia < c)
        *reinterpret_cast<__nv_bfloat162*>(O + ia * o_row + p) =
            __floats2bfloat162_rn(acc[sl][nt][0], acc[sl][nt][1]);
      if (ib < c)
        *reinterpret_cast<__nv_bfloat162*>(O + ib * o_row + p) =
            __floats2bfloat162_rn(acc[sl][nt][2], acc[sl][nt][3]);
    }
  }
}

// ------------------------ bf16, wide heads: tiles of P ----------------------

// q's A fragments of one 16-row slice over up to kWMaxN columns, from
// global memory.
__device__ __forceinline__ void q_frags_wide(uint32_t (*qa)[4], const bf16* Q,
                                             long long stride, int row, int c,
                                             int N) {
  const int g4 = (threadIdx.x % 32) / 4, t4 = threadIdx.x % 4;
#pragma unroll
  for (int ks = 0; ks < kWMaxN / 16; ++ks) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = row + g4 + 8 * (e % 2);
      const int col = 16 * ks + 2 * t4 + 8 * (e / 2);
      qa[ks][e] = r < c && col < N
                      ? *reinterpret_cast<const uint32_t*>(Q + r * stride +
                                                           col)
                      : 0u;
    }
  }
}

// Sum over the four lanes of a quad (the lanes holding one row's columns).
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

// One CTA of 8 warps per (batch, head, chunk, 64 state columns).  Tickets
// as in ssd_chunk_tc, chunk slowest: ticket t is chunk t / (B H T) of batch,
// head and column tile (t % (B H T)) / (H T), (t / T) % H, t % T, so the
// CTA of the same tile in the chunk before has always started.  ws slot
// (b, c, h) holds N x P floats of state and, with a normaliser, N more;
// each column tile has its own ready flag.
//  0. k (N columns) and the tile's v columns into shared memory (cp.async,
//     a group per 64 rows), cum, w_j = exp(total - cum_j).
//  1. the tile of state_c, warp w: state rows 16 w and 16 (w + 8), all 64
//     columns; tile 0 with a normaliser: nstate_c[n] = sum_j k_jn w_j, in
//     float32 by thread n.
//  2. the hand-over of the tile (and of nprev, tile 0) as in ssd_chunk_tc.
//  3. intra for slices w and 15 - w: S over N in 16-column k-steps, G, the
//     row sums of G (tile 0 with a normaliser), acc += sum_t G_t v.
//  4. prev_c's tile into the shared memory k held, in kTerms bf16 terms;
//     inter: acc += exp(cum_i) (q_i . prev_c); den_i += exp(cum_i) (q_i .
//     nprev_c); the bf16 outputs.
__global__ void __launch_bounds__(kTcThreads, 1) ssd_wide_tc(Args g) {
  constexpr int ldk = kWMaxN + 8, ldv = kWPT + 8;   // padded by 16 B
  extern __shared__ __align__(16) uint8_t smem_w[];
  bf16* sK = reinterpret_cast<bf16*>(smem_w);     // kTcMaxChunk x ldk
  bf16* sV = sK + kTcMaxChunk * ldk;              // kTcMaxChunk x ldv
  float* sCum = reinterpret_cast<float*>(sV + kTcMaxChunk * ldv);
  float* sW = sCum + kTcMaxChunk;                 // exp(total - cum)
  float* sTot = sW + kTcMaxChunk;                 // 16 + 16 scan slots
  float* sCarry = sTot + 16;
  float* sNorm = sCarry + 16;                     // nprev_c, kWMaxN
  int* sTicket = reinterpret_cast<int*>(sNorm + kWMaxN);
  bf16* sP = sK;             // step 4: kTerms x kWMaxN x ldv, over k

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, g4 = lane / 4, t4 = lane % 4;
  if (tid == 0) *sTicket = atomicAdd(g.sync, 1);
  __syncthreads();
  const int ticket = *sTicket;
  const int N = g.N, P = g.P, c = g.chunk;
  const int n_pt = (P + kWPT - 1) / kWPT;
  const int per_chunk = g.B * g.H * n_pt;
  const int ci = ticket / per_chunk, rest = ticket % per_chunk;
  const int b = rest / (g.H * n_pt), h = (rest / n_pt) % g.H,
            pt = rest % n_pt;
  const int p0 = pt * kWPT, PT = min(kWPT, P - p0);
  const int NP = round16(N), PPT = round16(PT);
  const int c16 = round16(c);
  const int n_groups = (c16 + kT - 1) / kT;
  const int c0 = ci * c;
  const bf16* Q = static_cast<const bf16*>(g.q) + b * g.qs[0] + h * g.qs[2] +
                  c0 * g.qs[1];
  const bf16* K = static_cast<const bf16*>(g.k) + b * g.ks[0] + h * g.ks[2] +
                  c0 * g.ks[1];
  const bf16* V = static_cast<const bf16*>(g.v) + b * g.vs[0] + h * g.vs[2] +
                  c0 * g.vs[1] + p0;
  const float* A = g.a + b * g.as[0] + h * g.as[2] + c0 * g.as[1];
  bf16* O = static_cast<bf16*>(g.o) + ((long long)b * g.L * g.H + h) * P +
            (long long)c0 * g.H * P + p0;
  const long long o_row = (long long)g.H * P;
  const bool norm = g.den != nullptr, own_norm = norm && pt == 0;
  const long long slot_floats = (long long)N * P + (norm ? N : 0);
  const bool has_prev = ci > 0, has_next = ci + 1 < g.nc;
  const long long slot_prev = has_prev ? ws_slot(g, b, ci - 1, h) : 0;
  const long long slot_next = has_next ? ws_slot(g, b, ci, h) : 0;

  // 0. loads (a group per 64 rows), prefix sums, decays
  for (int grp = 0; grp < n_groups; ++grp) {
    const int r0 = grp * kT, rows = min(kT, c16 - r0);
    load_rows(sK + r0 * ldk, ldk, K + r0 * g.ks[1], g.ks[1], rows, c - r0, N,
              NP);
    load_rows(sV + r0 * ldv, ldv, V + r0 * g.vs[1], g.vs[1], rows, c - r0,
              PT, PPT);
    cp_async_commit();
  }
  blocked_cumsum(A, g.as[1], c, sCum, sTot, sCarry);
  const float total = sCum[c - 1];
  for (int j = c + tid; j < c16; j += kTcThreads) sCum[j] = 0.f;
  for (int j = tid; j < c16; j += kTcThreads)
    sW[j] = j < c ? expf(total - sCum[j]) : 0.f;

  // 1. the tile of the chunk's own state (not needed for the last chunk)
  float st[2][kWPT / 8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int nt = 0; nt < kWPT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[m][nt][e] = 0.f;
  for (int grp = 0; grp < n_groups; ++grp) {
    switch (n_groups - 1 - grp) {
      case 0: cp_async_wait<0>(); break;
      case 1: cp_async_wait<1>(); break;
      case 2: cp_async_wait<2>(); break;
      default: cp_async_wait<3>(); break;
    }
    __syncthreads();
    if (!has_next) continue;
    for (int j16 = grp * kT; j16 < min(c16, (grp + 1) * kT); j16 += 16) {
      uint32_t vb[kWPT / 16][4];
#pragma unroll
      for (int np2 = 0; np2 < kWPT / 16; ++np2)
        if (16 * np2 < PPT)
          ldsm4_t(vb[np2], sV + (j16 + lane % 16) * ldv + 16 * np2 +
                               (lane / 16) * 8);
      const float2 w0 = *reinterpret_cast<const float2*>(sW + j16 + 2 * t4);
      const float2 w8 =
          *reinterpret_cast<const float2*>(sW + j16 + 8 + 2 * t4);
      const int mi = lane / 8;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int mt = warp + 8 * m;
        if (16 * mt >= NP) continue;
        uint32_t kr[4], ak[kTerms][4];
        ldsm4_t(kr, sK + (j16 + (mi / 2) * 8 + lane % 8) * ldk + 16 * mt +
                        (mi % 2) * 8);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = unpack(kr[e]);
          const float2 w = e < 2 ? w0 : w8;
          uint32_t t[kTerms];
          split(x.x * w.x, x.y * w.y, t);
#pragma unroll
          for (int i = 0; i < kTerms; ++i) ak[i][e] = t[i];
        }
#pragma unroll
        for (int np2 = 0; np2 < kWPT / 16; ++np2) {
          if (16 * np2 >= PPT) continue;
#pragma unroll
          for (int i = 0; i < kTerms; ++i) {
            mma(st[m][2 * np2], ak[i], vb[np2][0], vb[np2][1]);
            mma(st[m][2 * np2 + 1], ak[i], vb[np2][2], vb[np2][3]);
          }
        }
      }
    }
  }
  float nst = 0.f;                       // nstate_c[tid], tile 0
  if (own_norm && has_next && tid < N)
    for (int j = 0; j < c; ++j)
      nst = fmaf(__bfloat162float(sK[j * ldk + tid]), sW[j], nst);

  // 2. the hand-over of the tile (and of the normaliser state)
  if (has_prev) {
    if (tid == 0) {
      const int* flag = g.sync + 1 + slot_prev * n_pt + pt;
      for (int spins = 0; ld_acquire(flag) == 0;)
        if (++spins > (1 << 22)) __trap();
    }
    __syncthreads();
  }
  if (own_norm && tid < N)
    sNorm[tid] = has_prev ? __ldcg(g.ws + slot_prev * slot_floats +
                                   (long long)N * P + tid)
                          : 0.f;
  if (has_next) {
    const float decay = expf(total);
    const float* S0 = g.ws + slot_prev * slot_floats;
    float* S1 = g.ws + slot_next * slot_floats;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int r = 16 * (warp + 8 * m) + g4;
#pragma unroll
      for (int nt = 0; nt < kWPT / 8; ++nt) {
        const int col = p0 + 8 * nt + 2 * t4;
        if (8 * nt + 2 * t4 >= PT) continue;     // PT is a multiple of 8
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int rr = r + 8 * half;
          if (rr >= N) continue;
          float2 x = make_float2(st[m][nt][2 * half], st[m][nt][2 * half + 1]);
          if (has_prev) {
            const float2 pv = __ldcg(
                reinterpret_cast<const float2*>(S0 + rr * P + col));
            x.x = fmaf(pv.x, decay, x.x);
            x.y = fmaf(pv.y, decay, x.y);
          }
          *reinterpret_cast<float2*>(S1 + rr * P + col) = x;
        }
      }
    }
    if (own_norm && tid < N)
      S1[(long long)N * P + tid] =
          has_prev ? fmaf(sNorm[tid], decay, nst) : nst;
    __threadfence();
    __syncthreads();
    if (tid == 0) st_release(g.sync + 1 + slot_next * n_pt + pt, 1);
  }

  // 3. intra, slices w and 15 - w
  float acc[2][kWPT / 8][4];
  float rs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};   // row sums of G (rows a, b)
#pragma unroll
  for (int sl = 0; sl < 2; ++sl)
#pragma unroll
    for (int nt = 0; nt < kWPT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[sl][nt][e] = 0.f;
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int i0 = 16 * (sl == 0 ? warp : 15 - warp);
    if (i0 >= c) continue;
    uint32_t qa[kWMaxN / 16][4];
    q_frags_wide(qa, Q, g.qs[1], i0, c, N);
    const int ia = i0 + g4, ib = ia + 8;
    const float cum_a = sCum[ia], cum_b = sCum[ib];   // 0 past the chunk
    for (int j16 = 0; j16 <= i0; j16 += 16) {
      float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int ks = 0; ks < kWMaxN / 16; ++ks) {
        if (16 * ks >= NP) continue;
        uint32_t kb[4];
        ldsm4(kb, sK + (j16 + lane % 8 + (lane / 16) * 8) * ldk + 16 * ks +
                      ((lane / 8) % 2) * 8);
        mma(sc[0], qa[ks], kb[0], kb[1]);
        mma(sc[1], qa[ks], kb[2], kb[3]);
      }
      const bool edge = j16 == i0 || i0 + 16 > c;
      uint32_t gk[kTerms][4];
#pragma unroll
      for (int jt = 0; jt < 2; ++jt) {
        const int j = j16 + 8 * jt + 2 * t4;
        const float2 cj = *reinterpret_cast<const float2*>(sCum + j);
        float x[4] = {sc[jt][0] * expf(cum_a - cj.x),
                      sc[jt][1] * expf(cum_a - cj.y),
                      sc[jt][2] * expf(cum_b - cj.x),
                      sc[jt][3] * expf(cum_b - cj.y)};
        if (edge) {
          if (j > ia || ia >= c) x[0] = 0.f;
          if (j + 1 > ia || ia >= c) x[1] = 0.f;
          if (j > ib || ib >= c) x[2] = 0.f;
          if (j + 1 > ib || ib >= c) x[3] = 0.f;
        }
        rs[sl][0] += x[0] + x[1];
        rs[sl][1] += x[2] + x[3];
        uint32_t ta[kTerms], tb[kTerms];
        split(x[0], x[1], ta);
        split(x[2], x[3], tb);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          gk[i][2 * jt] = ta[i];
          gk[i][2 * jt + 1] = tb[i];
        }
      }
#pragma unroll
      for (int np2 = 0; np2 < kWPT / 16; ++np2) {
        if (16 * np2 >= PPT) continue;
        uint32_t vb[4];
        ldsm4_t(vb, sV + (j16 + lane % 16) * ldv + 16 * np2 +
                        (lane / 16) * 8);
#pragma unroll
        for (int i = 0; i < kTerms; ++i) {
          mma(acc[sl][2 * np2], gk[i], vb[0], vb[1]);
          mma(acc[sl][2 * np2 + 1], gk[i], vb[2], vb[3]);
        }
      }
    }
  }

  // 4. prev_c's tile as kTerms bf16 terms over k's shared memory
  if (has_prev) {
    __syncthreads();                           // every warp is done with k
    const float* S0 = g.ws + slot_prev * slot_floats;
    for (int e = tid; e < NP * (PPT / 2); e += kTcThreads) {
      const int r = e / (PPT / 2), col = 2 * (e % (PPT / 2));
      float2 x = make_float2(0.f, 0.f);
      if (r < N && col < PT)
        x = __ldcg(reinterpret_cast<const float2*>(S0 + r * P + p0 + col));
      uint32_t t[kTerms];
      split(x.x, x.y, t);
#pragma unroll
      for (int i = 0; i < kTerms; ++i)
        *reinterpret_cast<uint32_t*>(sP + (i * kWMaxN + r) * ldv + col) = t[i];
    }
    __syncthreads();
  }
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int i0 = 16 * (sl == 0 ? warp : 15 - warp);
    if (i0 >= c) continue;
    const int ia = i0 + g4, ib = ia + 8;
    float dq[2] = {0.f, 0.f};                  // q_i . nprev_c, partial
    if (has_prev) {
      uint32_t qa[kWMaxN / 16][4];
      q_frags_wide(qa, Q, g.qs[1], i0, c, N);
      const float ea = ia < c ? expf(sCum[ia]) : 0.f;
      const float eb = ib < c ? expf(sCum[ib]) : 0.f;
#pragma unroll
      for (int np2 = 0; np2 < kWPT / 16; ++np2) {
        if (16 * np2 >= PPT) continue;
        float tmp[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
        for (int ks = 0; ks < kWMaxN / 16; ++ks) {
          if (16 * ks >= NP) continue;
          const int off = (16 * ks + lane % 16) * ldv + 16 * np2 +
                          (lane / 16) * 8;
#pragma unroll
          for (int t = 0; t < kTerms; ++t) {
            uint32_t pb[4];
            ldsm4_t(pb, sP + t * kWMaxN * ldv + off);
            mma(tmp[0], qa[ks], pb[0], pb[1]);
            mma(tmp[1], qa[ks], pb[2], pb[3]);
          }
        }
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[sl][2 * np2 + e][0] += ea * tmp[e][0];
          acc[sl][2 * np2 + e][1] += ea * tmp[e][1];
          acc[sl][2 * np2 + e][2] += eb * tmp[e][2];
          acc[sl][2 * np2 + e][3] += eb * tmp[e][3];
        }
      }
      if (own_norm) {
        // a lane's q pairs: row a in fragments 0 and 2, row b in 1 and 3
#pragma unroll
        for (int ks = 0; ks < kWMaxN / 16; ++ks) {
          if (16 * ks >= NP) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 16 * ks + 2 * t4 + 8 * (e / 2);
            const float2 x = unpack(qa[ks][e]);
            const float2 nv = col < N ? make_float2(sNorm[col],
                                                    sNorm[col + 1])
                                      : make_float2(0.f, 0.f);
            dq[e % 2] = fmaf(x.x, nv.x, fmaf(x.y, nv.y, dq[e % 2]));
          }
        }
        dq[0] *= ea;
        dq[1] *= eb;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kWPT / 8; ++nt) {
      const int p = 8 * nt + 2 * t4;         // PT is a multiple of 8
      if (p >= PT) continue;
      if (ia < c)
        *reinterpret_cast<__nv_bfloat162*>(O + ia * o_row + p) =
            __floats2bfloat162_rn(acc[sl][nt][0], acc[sl][nt][1]);
      if (ib < c)
        *reinterpret_cast<__nv_bfloat162*>(O + ib * o_row + p) =
            __floats2bfloat162_rn(acc[sl][nt][2], acc[sl][nt][3]);
    }
    if (own_norm) {
      const float da = quad_sum(rs[sl][0] + dq[0]);
      const float db = quad_sum(rs[sl][1] + dq[1]);
      bf16* D = static_cast<bf16*>(g.den) +
                ((long long)b * g.L + c0) * g.H + h;
      if (t4 == 0 && ia < c) D[(long long)ia * g.H] = __float2bfloat16_rn(da);
      if (t4 == 0 && ib < c) D[(long long)ib * g.H] = __float2bfloat16_rn(db);
    }
  }
}

// ------------------------------- launches --------------------------------

size_t f32_bytes(int N, int P, int chunk) {
  const int ldn = N + 1, ldp = P + 1;
  return sizeof(float) * ((size_t)N * ldp + 2 * kT * ldn + kT * ldp +
                          kT * (kT + 1) + chunk + 2 * kScanSlots);
}
constexpr size_t kChunkTcBytes =
    sizeof(bf16) * (2 * kTcMaxChunk + kTerms * kTcMaxNP) * (kTcMaxNP + 8) +
    sizeof(float) * (3 * kTcMaxChunk + 32) + 16;
constexpr size_t kWideBytes =
    sizeof(bf16) * kTcMaxChunk * ((kWMaxN + 8) + (kWPT + 8)) +
    sizeof(float) * (2 * kTcMaxChunk + 32 + kWMaxN) + 16;
static_assert(kTerms * kWMaxN * (kWPT + 8) <= kTcMaxChunk * (kWMaxN + 8),
              "prev's terms must fit in k's shared memory");

// The kernel that takes these inputs: 0 the float32 kernel, 1 the bf16
// kernel (N, P <= 64), 2 the bf16 wide kernel (N <= 256, also the
// normaliser), -1 none.
int route(int N, int P, int chunk, int dtype, int norm) {
  if (dtype == 0)
    return !norm && N <= kMaxNP && P <= kMaxNP && chunk <= kMaxChunk ? 0 : -1;
  if (chunk > kTcMaxChunk || N > kWMaxN) return -1;
  return !norm && N <= kTcMaxNP && P <= kTcMaxNP ? 1 : 2;
}

// Launches with the shared-memory carveout at its largest, so that as many
// blocks share an SM as its shared memory allows.
template <typename Kernel>
int launch_one(Kernel kernel, dim3 grid, int threads, size_t smem,
               const Args& g, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

// The kernel these inputs take (see route; -1: none), the dynamic shared
// memory a block of it takes, and, for the wide kernel, its column tiles.
extern "C" int ssd_scan_route(int N, int P, int chunk, int dtype, int norm) {
  return route(N, P, chunk, dtype, norm);
}

extern "C" long long ssd_scan_smem_bytes(int N, int P, int chunk, int dtype,
                                         int norm) {
  switch (route(N, P, chunk, dtype, norm)) {
    case 0: return (long long)f32_bytes(N, P, chunk);
    case 1: return (long long)kChunkTcBytes;
    case 2: return (long long)kWideBytes;
    default: return -1;
  }
}

extern "C" int ssd_scan_col_tiles(int P) { return (P + kWPT - 1) / kWPT; }

// dtype: 0 float32, 1 bfloat16 (q, k, v, o and den; a is float32).
// Strides are in elements, three per tensor (batch, sequence, head); for
// bfloat16 the pointers must be 16 B aligned and N, P and the strides
// multiples of 8 (cp.async).  bfloat16 only: ws is a float32 workspace of
// B * (L / chunk - 1) * H slots, each of N * P values (and N more with a
// normaliser), and sync holds 1 + B * (L / chunk - 1) * H * T zeroed int32,
// T the column tiles of the wide kernel (1 for the other); den (a new
// contiguous [B, L, H]) asks the wide kernel for the normaliser.  float32
// takes neither ws nor sync (null) and no normaliser.  Launches on `stream`
// and returns cudaGetLastError() (0 on success; cudaErrorInvalidValue for
// inputs no kernel takes).
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v,
                               const float* a, void* o, void* den, float* ws,
                               int* sync, int dtype, int B, int L, int H,
                               int N, int P, int chunk,
                               const long long* q_strides,
                               const long long* k_strides,
                               const long long* v_strides,
                               const long long* a_strides, void* stream) {
  if (B == 0 || H == 0 || L == 0) return (int)cudaGetLastError();
  const int path = route(N, P, chunk, dtype, den != nullptr);
  if (path < 0) return (int)cudaErrorInvalidValue;
  Args g;
  g.q = q;
  g.k = k;
  g.v = v;
  g.a = a;
  g.o = o;
  g.ws = ws;
  g.sync = sync;
  g.den = den;
  g.B = B;
  g.L = L;
  g.H = H;
  g.N = N;
  g.P = P;
  g.chunk = chunk;
  g.nc = L / chunk;
  for (int i = 0; i < 3; ++i) {
    g.qs[i] = q_strides[i];
    g.ks[i] = k_strides[i];
    g.vs[i] = v_strides[i];
    g.as[i] = a_strides[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 2)
    return launch_one(ssd_wide_tc, dim3(B * H * g.nc * ssd_scan_col_tiles(P)),
                      kTcThreads, kWideBytes, g, s);
  if (path == 1)
    return launch_one(ssd_chunk_tc, dim3(B * H * g.nc), kTcThreads,
                      kChunkTcBytes, g, s);
  return launch_one(ssd_f32_kernel, dim3(B * H), kF32Threads,
                    f32_bytes(N, P, chunk), g, s);
}
