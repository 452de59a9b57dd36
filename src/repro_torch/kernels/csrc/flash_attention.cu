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
// same type out.
//
// Bound on an H100: at the serve path's shape (zamba2-2.7b prefill, B = 4,
// Sq = kv_len = 1024, 32 heads, D = 80, causal, bf16) the function reads
// q and the kv_len rows of k and v once and writes o once, 4 x 21 MB = 84 MB
// (25 us at 3.35 TB/s), and does 2 * 2 * B * H * D * Sq^2 / 2 = 21.5 GFLOP
// (21.7 us at 989 TFLOP/s bf16): bound by bytes, with the operations close
// behind, so the products must run on the tensor cores and the loads must
// overlap them.
//
// bf16: Hopper tensor cores (flash_wgmma_kernel), the FlashAttention-3
// shape without its ping-pong scheduling.
// * One CTA of 384 threads per (batch, query head, 128-row query tile):
//   B * Hq * ceil(Sq / 128) = 1024 CTAs at the serve shape, about 7.8 per
//   SM, launched last query tile first (the causal tiles with the most kv
//   work start first).  Warpgroup 0 is the producer: one thread issues TMA
//   loads and gives its registers away (setmaxnreg 24).  Warpgroups 1 and
//   2 consume (setmaxnreg 240), 64 query rows each.
// * Loads: the Q tile once; then K and V tiles of 128 kv rows through a
//   three-stage shared-memory ring, one `full` mbarrier per stage (TMA
//   completes its bytes) and one `empty` mbarrier per stage (the 256
//   consumer threads arrive when their products have read it).  The loads
//   of the next tiles overlap the products and softmax of this one.
// * S = Q K^T: wgmma m64n128k16, A (Q) and B (K) from shared memory, K-major;
//   ceil(D / 16) k-steps (5 for D = 80).  The online softmax runs on the
//   accumulator fragments in registers: float32 max and sum of the raw
//   scores, p = 2^(s c - m c) with c = scale * log2(e) (one FMA and one
//   MUFU.EX2 an entry); a quad of threads shares a row (two shuffles).  P
//   is split in registers into two bf16 terms, hi = bf16(p) and lo =
//   bf16(p - hi), and both are fed as the register A operand of O += P V
//   (wgmma m64nDk16 with V's tile read MN-major, transposed, from shared
//   memory; 8 k-steps per kv tile, twice).  Rounding P once, as the
//   reference layer does (layers.py:119), stays within 2e-2 of the plain
//   version, which keeps P in float32, but moves many more bf16 outputs
//   an ulp away from the plain version's; hi + lo keeps about 16 bits of
//   p.  The products of tile t (S) and tile t - 1 (P V) are issued
//   together; the two consumer warpgroups share the tensor cores, one's
//   softmax running while the other's products do.  O stays in float32
//   registers, rescaled per tile; the epilogue divides by max(l, 1e-30)
//   and stores bf16.
// * Masking: a tile is masked element by element only where it crosses
//   kv_len or the causal diagonal; a consumer warpgroup skips the products
//   of a tile that lies wholly past its diagonal (it still releases the
//   stage); tiles past kv_len or past the whole CTA's diagonal are not
//   loaded at all.
// * Head dim layout.  A row of D = 80 bf16 is 160 B, which is not a 128 B
//   swizzle span.  Each tile is loaded as ceil(D / 64) TMA boxes of 64
//   columns (128 B rows, 128B swizzle), with TMA's zero fill past column D;
//   for D = 80 the second box holds columns 64..79 and zeros.  This keeps
//   the one swizzle mode wgmma and TMA both know best (bank-conflict free,
//   1024 B atoms), costs 48 zero columns of shared memory per row (225 KB
//   a CTA at D = 80), and serves D = 16 .. 128 with one code path: QK^T
//   steps through the boxes 32 B at a time, and P V spans them with the
//   descriptor's leading byte offset (the distance between two boxes).
// * TMA route: the tensor maps (4-d: D, sequence, head, batch, with the
//   tensors' own strides) are encoded on the host per call with
//   cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so the
//   library links no libcuda, and passed as __grid_constant__ parameters.
//   TMA needs 16 B aligned base addresses and strides; the wrapper checks
//   both and raises otherwise.
//
// float32: the CUDA cores (flash_f32_kernel), since neither bf16 nor TF32
// products meet float32's 2e-5: one block of 128 threads per (query head,
// tile of 32 query rows), 64-row kv tiles staged in shared memory as
// float32, a 4 x 4 score micro-tile per thread, the online softmax by
// warps, the accumulator in registers.  The parity path (reduced zamba2 in
// float32) uses it; the bf16 serve path does not.
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

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

// ------------------------- float32: CUDA cores -----------------------------

constexpr int kThreads = 128;
constexpr int kBQ = 32;          // query rows per block
constexpr int kBK = 64;          // kv rows per tile

__global__ void __launch_bounds__(kThreads) flash_f32_kernel(Args a) {
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
  const float* Q = static_cast<const float*>(a.q) + b * a.qs[0] + h * a.qs[1];
  const float* K =
      static_cast<const float*>(a.k) + b * a.ks[0] + hk * a.ks[1];
  const float* V =
      static_cast<const float*>(a.v) + b * a.vs[0] + hk * a.vs[1];
  float* O = static_cast<float*>(a.o) + b * a.os[0] + h * a.os[1];

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    sq[r * ld + d] = q0 + r < a.Sq ? Q[(q0 + r) * a.qs[2] + d] : 0.f;
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
      sk[r * ld + d] = in ? K[(k0 + r) * a.ks[2] + d] : 0.f;
      sv[r * ld + d] = in ? V[(k0 + r) * a.vs[2] + d] : 0.f;
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
    float* orow = O + r * a.os[2];
#pragma unroll
    for (int i = 0; i < kMaxD / 4; ++i) {
      const int d = co + 4 * i;
      if (d < D) orow[d] = acc[i] / denom;
    }
  }
}

size_t f32_smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) *
         ((size_t)(kBQ + 2 * kBK) * ld + kBQ * (kBK + 1) + 3 * kBQ);
}

int launch_f32(const Args& a, cudaStream_t stream) {
  const size_t smem = f32_smem_bytes(a.D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.B * a.Hq);
  flash_f32_kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ------------------------- bf16: Hopper tensor cores -----------------------

constexpr int kBM = 128;                 // query rows per CTA
constexpr int kBN = 128;                 // kv rows per tile
constexpr int kStages = 3;               // K/V ring depth
constexpr int kTcThreads = 384;          // producer + two consumer groups
constexpr int kBox = 64;                 // columns per TMA box (128 B)
constexpr int kBoxBytes = kBM * 128;     // one box of 128 rows (kBM == kBN)
constexpr int kErrNoTensorMap = 10000;   // returned when TMA maps fail

// Shapes of one instantiation: DP is the head dim rounded up to an
// instruction width (16, 32, 64, 80 or 128), the n of O += P V.
template <int DP>
struct Tc {
  static constexpr int kBoxes = (DP + kBox - 1) / kBox;
  static constexpr int kSteps = DP / 16;             // k-steps of Q K^T
  static constexpr int kTile = kBoxes * kBoxBytes;   // one q, k or v tile
  static constexpr int kBars = 1 + 2 * kStages;
  static constexpr int kSmem = 1024 + (1 + 2 * kStages) * kTile + 8 * kBars;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Waits until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n}\n"
      :: "r"(bar), "r"(parity) : "memory");
}

// One TMA box (4-d coordinates: column, row, head, batch) into shared
// memory; completes its bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading
// and stride byte offsets.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// Keeps the compiler from moving accesses of accumulator registers across
// an asynchronous wgmma's issue or wait.
template <int R>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_u32(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// (x0, x1) as bf16 pairs hi and lo = bf16(x - hi): hi + lo keeps about 16
// bits of each.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - __low2float(h),
                                           x1 - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// wgmma instructions: ss = both operands from shared memory (S = Q K^T),
// rs = A from registers and B transposed (O += P V).  Accumulator fragment
// of a thread (lane l of warp w in the warpgroup, g = l / 4, t = l % 4):
// d[4j + e] is row 16w + g + 8 (e / 2), column 8j + 2t + e % 2.
template <int N>
struct Wgmma;

template <>
struct Wgmma<16> {
  // D[64 x 16] += A[64 x 16] B[16 x 16]: A in registers (four
  // bf16 pairs a thread), B in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float* d,
                                            const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<32> {
  // D[64 x 32] += A[64 x 16] B[16 x 32]: A in registers (four
  // bf16 pairs a thread), B in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float* d,
                                            const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers (four
  // bf16 pairs a thread), B in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float* d,
                                            const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<80> {
  // D[64 x 80] += A[64 x 16] B[16 x 80]: A in registers (four
  // bf16 pairs a thread), B in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float* d,
                                            const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        ", %32, %33, %34, %35, %36, %37, %38, %39"
        "}, {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B in shared
  // memory, both K-major; scale_d = 0 overwrites D.
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        ", %32, %33, %34, %35, %36, %37, %38, %39"
        ", %40, %41, %42, %43, %44, %45, %46, %47"
        ", %48, %49, %50, %51, %52, %53, %54, %55"
        ", %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  // D[64 x 128] += A[64 x 16] B[16 x 128]: A in registers (four
  // bf16 pairs a thread), B in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float* d,
                                            const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        ", %32, %33, %34, %35, %36, %37, %38, %39"
        ", %40, %41, %42, %43, %44, %45, %46, %47"
        ", %48, %49, %50, %51, %52, %53, %54, %55"
        ", %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(1));
  }
};

struct TcArgs {
  void* o;
  long long os[3];                       // batch, head, sequence strides
  int Hq, Hkv, Sq, D;
  int causal, q_offset, kv_end;
  float scale_log2;                      // scale * log2(e)
};

// S = Q K^T for one kv tile, issued and committed (not waited for):
// ceil(D / 16) k-steps, 32 B apart within a box, the boxes kBoxBytes apart.
template <int DP>
__device__ __forceinline__ void issue_scores(float* sc, uint32_t q_addr,
                                             uint32_t k_addr) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < Tc<DP>::kSteps; ++kk) {
    const uint32_t off = (kk / 4) * kBoxBytes + (kk % 4) * 32;
    Wgmma<kBN>::ss(sc, desc128(q_addr + off, 16, 1024),
                   desc128(k_addr + off, 16, 1024), kk > 0);
  }
  wg_commit();
}

// O += (P_hi + P_lo) V for one kv tile, issued and committed: k-step kk
// takes kv rows 16kk .. 16kk + 15 (2 KB into each box); V's column boxes
// are kBoxBytes apart (the descriptor's leading byte offset).  The A
// fragments are the P registers themselves: ptxas serializes the wgmmas
// of a stage if other instructions write their input registers in between.
template <int DP>
__device__ __forceinline__ void issue_pv(float* o, const uint32_t* ph,
                                         const uint32_t* pl,
                                         uint32_t v_addr) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk) {
    const uint64_t dv = desc128(v_addr + kk * 16 * 128, kBoxBytes, 1024);
    Wgmma<DP>::rs(o, ph + 4 * kk, dv);
    Wgmma<DP>::rs(o, pl + 4 * kk, dv);
  }
  wg_commit();
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over a thread's two rows (a: g, b: g + 8), each shared by
// a quad of threads.  Maxima are of the raw scores; the scale and log2(e)
// fold into one FMA before the exponent, p = 2^(s c - m c).
struct Softmax {
  float m_a = kNegInf, m_b = kNegInf;    // running max of raw scores
  float l_a = 0.f, l_b = 0.f;            // this thread's share of the sum
  float al_a = 1.f, al_b = 1.f;          // the last tile's rescale factors

  // The tile at k0, masked where it crosses kv_len or the diagonal: new
  // maxima, and P as wgmma A fragments in two bf16 terms, ph = bf16(p) and
  // pl = bf16(p - ph): [2j] row a, [2j + 1] row b, columns 8j + 2t and
  // 8j + 2t + 1.
  __device__ __forceinline__ void tile(float* sc, uint32_t* ph, uint32_t* pl,
                                       int k0,
                                       int row_a, int row_b, int r0,
                                       const TcArgs& a) {
    const int t4 = threadIdx.x % 4;
    const bool edge = k0 + kBN > a.kv_end ||
                      (a.causal && k0 + kBN - 1 > r0 + a.q_offset);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t4 + e;
          const bool in = col < a.kv_end;
          if (!in || (a.causal && col > row_a + a.q_offset))
            sc[4 * j + e] = kNegInf;
          if (!in || (a.causal && col > row_b + a.q_offset))
            sc[4 * j + 2 + e] = kNegInf;
        }
      }
    }
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float c = a.scale_log2;
    al_a = ex2((m_a - mx_a) * c);
    al_b = ex2((m_b - mx_b) * c);
    m_a = mx_a;
    m_b = mx_b;
    const float ma = m_a * c, mb = m_b * c;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const float pa0 = ex2(fmaf(sc[4 * j], c, -ma));
      const float pa1 = ex2(fmaf(sc[4 * j + 1], c, -ma));
      const float pb0 = ex2(fmaf(sc[4 * j + 2], c, -mb));
      const float pb1 = ex2(fmaf(sc[4 * j + 3], c, -mb));
      sum_a += pa0 + pa1;
      sum_b += pb0 + pb1;
      split2(pa0, pa1, ph[2 * j], pl[2 * j]);
      split2(pb0, pb1, ph[2 * j + 1], pl[2 * j + 1]);
    }
    l_a = l_a * al_a + sum_a;
    l_b = l_b * al_b + sum_b;
  }

  // O's rows to the last tile's maxima.
  template <int DP>
  __device__ __forceinline__ void rescale(float* o) const {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      o[4 * j] *= al_a;
      o[4 * j + 1] *= al_a;
      o[4 * j + 2] *= al_b;
      o[4 * j + 3] *= al_b;
    }
  }

  // A row's sum over its quad.
  __device__ __forceinline__ static float row_sum(float l) {
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    return l + __shfl_xor_sync(0xffffffffu, l, 2);
  }
};

template <int DP>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, TcArgs a) {
  using S = Tc<DP>;
  extern __shared__ uint8_t smem_raw[];
  // 128B-swizzled tiles need 1024 B alignment
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* sQ = base;
  uint8_t* sK = sQ + S::kTile;                        // kStages tiles
  uint8_t* sV = sK + kStages * S::kTile;              // kStages tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(sV + kStages * S::kTile);
  const uint32_t bar_q = smem_u32(bars);
  const uint32_t bar_full = smem_u32(bars + 1);              // + 8 s
  const uint32_t bar_empty = smem_u32(bars + 1 + kStages);   // + 8 s

  const int tid = threadIdx.x;
  const int b = blockIdx.x / a.Hq;
  const int h = blockIdx.x % a.Hq;
  const int hk = h / (a.Hq / a.Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;   // last tile first
  int kv_hi = a.kv_end;
  if (a.causal) kv_hi = min(kv_hi, q0 + kBM + a.q_offset);
  const int n_tiles = (kv_hi + kBN - 1) / kBN;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid < 128) {                       // producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      mbar_expect_tx(bar_q, S::kTile);
      for (int c = 0; c < S::kBoxes; ++c)
        tma_load(smem_u32(sQ + c * kBoxBytes), &tq, bar_q, c * kBox, q0, h,
                 b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages;
        if (t >= kStages)
          mbar_wait(bar_empty + 8 * s, (t / kStages - 1) & 1);
        mbar_expect_tx(bar_full + 8 * s, 2 * S::kTile);
        for (int c = 0; c < S::kBoxes; ++c) {
          const int off = s * S::kTile + c * kBoxBytes;
          tma_load(smem_u32(sK + off), &tk, bar_full + 8 * s, c * kBox,
                   t * kBN, hk, b);
          tma_load(smem_u32(sV + off), &tv, bar_full + 8 * s, c * kBox,
                   t * kBN, hk, b);
        }
      }
    }
  } else {                               // two consumer warpgroups
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int cw = tid / 128 - 1;
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int r0 = q0 + 64 * cw;         // this warpgroup's first row
    const int row_a = r0 + 16 * warp + g, row_b = row_a + 8;
    const uint32_t q_addr = smem_u32(sQ) + 64 * cw * 128;
    // kv tiles this warpgroup multiplies; the CTA's later ones lie wholly
    // past its diagonal
    const int n_live =
        a.causal ? min(n_tiles, (r0 + 64 + a.q_offset + kBN - 1) / kBN)
                 : n_tiles;

    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.f;
    uint32_t ph[kBN / 4], pl[kBN / 4];
    Softmax sm;

    mbar_wait(bar_q, 0);
    mbar_wait(bar_full, 0);
    issue_scores<DP>(sc, q_addr, smem_u32(sK));
    wg_wait<0>();
    fence_regs<kBN / 2>(sc);
    sm.tile(sc, ph, pl, 0, row_a, row_b, r0, a);
    for (int t = 1; t < n_live; ++t) {
      // S of tile t and O += P V of tile t - 1 in flight together, then
      // the softmax of tile t writes P over the registers P V has read
      // (overlapping it with P V needs a second P set, and copying that
      // back makes ptxas serialize the wgmmas)
      const int s = t % kStages, s_prev = (t - 1) % kStages;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      fence_regs<DP / 2>(o);
      issue_scores<DP>(sc, q_addr, smem_u32(sK + s * S::kTile));
      issue_pv<DP>(o, ph, pl, smem_u32(sV + s_prev * S::kTile));
      wg_wait<0>();
      fence_regs<kBN / 2>(sc);
      fence_regs<DP / 2>(o);
      fence_u32<kBN / 4>(ph);
      fence_u32<kBN / 4>(pl);
      mbar_arrive(bar_empty + 8 * s_prev);
      sm.tile(sc, ph, pl, t * kBN, row_a, row_b, r0, a);
      sm.rescale<DP>(o);
    }
    const int s_last = (n_live - 1) % kStages;
    fence_regs<DP / 2>(o);
    issue_pv<DP>(o, ph, pl, smem_u32(sV + s_last * S::kTile));
    wg_wait<0>();
    fence_regs<DP / 2>(o);
    fence_u32<kBN / 4>(ph);
    fence_u32<kBN / 4>(pl);
    mbar_arrive(bar_empty + 8 * s_last);
    for (int t = n_live; t < n_tiles; ++t) {    // release the rest
      const int s = t % kStages;
      mbar_wait(bar_full + 8 * s, (t / kStages) & 1);
      mbar_arrive(bar_empty + 8 * s);
    }

    const float inv_a = 1.f / fmaxf(sm.row_sum(sm.l_a), 1e-30f);
    const float inv_b = 1.f / fmaxf(sm.row_sum(sm.l_b), 1e-30f);
    __nv_bfloat16* O = static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] +
                       h * a.os[1];
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t4;      // D is a multiple of 8
      if (col < a.D) {
        if (row_a < a.Sq)
          *reinterpret_cast<__nv_bfloat162*>(O + row_a * a.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (row_b < a.Sq)
          *reinterpret_cast<__nv_bfloat162*>(O + row_b * a.os[2] + col) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv_b,
                                    o[4 * j + 3] * inv_b);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-d map (column, row, head, batch) of a bf16 [B, S, H, D] view with
// element strides st (batch, head, sequence): boxes of 64 columns x 128
// rows, 128B swizzle, zero fill out of bounds.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D,
                int rows, int heads, int batch, const long long* st) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)st[2] * 2, (cuuint64_t)st[1] * 2,
                                 (cuuint64_t)st[0] * 2};
  const cuuint32_t box[4] = {kBox, kBM, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch_tc_dp(const Args& a, const TcArgs& t, const CUtensorMap& tq,
                 const CUtensorMap& tk, const CUtensorMap& tv,
                 cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_wgmma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      Tc<DP>::kSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.B * a.Hq, (a.Sq + kBM - 1) / kBM);
  flash_wgmma_kernel<DP><<<grid, kTcThreads, Tc<DP>::kSmem, stream>>>(
      tq, tk, tv, t);
  return (int)cudaGetLastError();
}

int tc_dp(int D) {
  return D <= 16 ? 16 : D <= 32 ? 32 : D <= 64 ? 64 : D <= 80 ? 80 : 128;
}

int launch_tc(const Args& a, cudaStream_t stream) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrNoTensorMap;
  CUtensorMap tq, tk, tv;
  if (!tensor_map(enc, &tq, a.q, a.D, a.Sq, a.Hq, a.B, a.qs) ||
      !tensor_map(enc, &tk, a.k, a.D, a.kv_end, a.Hkv, a.B, a.ks) ||
      !tensor_map(enc, &tv, a.v, a.D, a.kv_end, a.Hkv, a.B, a.vs))
    return kErrNoTensorMap;
  TcArgs t;
  t.o = a.o;
  for (int i = 0; i < 3; ++i) t.os[i] = a.os[i];
  t.Hq = a.Hq;
  t.Hkv = a.Hkv;
  t.Sq = a.Sq;
  t.D = a.D;
  t.causal = a.causal;
  t.q_offset = a.q_offset;
  t.kv_end = a.kv_end;
  t.scale_log2 = a.scale * 1.4426950408889634f;
  switch (tc_dp(a.D)) {
    case 16: return launch_tc_dp<16>(a, t, tq, tk, tv, stream);
    case 32: return launch_tc_dp<32>(a, t, tq, tk, tv, stream);
    case 64: return launch_tc_dp<64>(a, t, tq, tk, tv, stream);
    case 80: return launch_tc_dp<80>(a, t, tq, tk, tv, stream);
    default: return launch_tc_dp<128>(a, t, tq, tk, tv, stream);
  }
}

size_t tc_smem_bytes(int D) {
  switch (tc_dp(D)) {
    case 16: return Tc<16>::kSmem;
    case 32: return Tc<32>::kSmem;
    case 64: return Tc<64>::kSmem;
    case 80: return Tc<80>::kSmem;
    default: return Tc<128>::kSmem;
  }
}

}  // namespace

extern "C" int flash_attention_max_d() { return kMaxD; }

// Dynamic shared memory one block of the dtype's kernel takes.
extern "C" long long flash_attention_smem_bytes(int D, int dtype) {
  return (long long)(dtype == 1 ? tc_smem_bytes(D) : f32_smem_bytes(D));
}

// dtype: 0 float32, 1 bfloat16.  Strides are in elements, three per tensor
// (batch, head, sequence); for bfloat16 they and the pointers must be
// 16 B aligned and D a multiple of 8 (TMA).  Launches on `stream` and
// returns cudaGetLastError() (0 on success), or 10000 when the TMA maps
// cannot be made.
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
  return dtype == 1 ? launch_tc(a, s) : launch_f32(a, s);
}
