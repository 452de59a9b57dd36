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
//   both and raises otherwise.  These pieces (maps, mbarriers, wgmma
//   descriptors and wrappers) live in hopper.cuh, which the backward
//   kernels share.
// * The row log-sum-exp: given an lse pointer (the training forward's;
//   serving passes null), the epilogue also stores each row's
//   m scale + log l, which the bf16 backward kernel reads instead of
//   recomputing it; both kernels do, the float32 one from its running
//   max and sum.  Without the pointer the kernel computes what it did
//   before, bit for bit.
//
// float32: the CUDA cores (flash_f32_kernel), since neither bf16 nor TF32
// products meet float32's 2e-5: one block of 128 threads per (query head,
// tile of 32 query rows), 64-row kv tiles staged in shared memory as
// float32, a 4 x 4 score micro-tile per thread, the online softmax by
// warps, the accumulator in registers.  The parity path (reduced zamba2 in
// float32) uses it; the bf16 serve path does not.
#include "hopper.cuh"

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
  float* lse;                             // [B, Hq, >= Sq] or null
  long long ls[2];                        // its batch and head strides
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
  if (r < a.Sq && a.lse && co == 0)
    a.lse[b * a.ls[0] + h * a.ls[1] + r] = sm[ro] + logf(sl[ro]);
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
constexpr int kBoxBytes = kBM * 128;     // one box of 128 rows (kBM == kBN)

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

struct TcArgs {
  void* o;
  long long os[3];                       // batch, head, sequence strides
  int Hq, Hkv, Sq, D;
  int causal, q_offset, kv_end;
  float scale_log2;                      // scale * log2(e)
  float* lse;                            // [B, Hq, >= Sq] or null
  long long ls[2];                       // its batch and head strides
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
    Wgmma<kBN>::ss<0>(sc, desc128(q_addr + off, 16, 1024),
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

    const float l_a = sm.row_sum(sm.l_a), l_b = sm.row_sum(sm.l_b);
    const float inv_a = 1.f / fmaxf(l_a, 1e-30f);
    const float inv_b = 1.f / fmaxf(l_b, 1e-30f);
    if (a.lse && t4 == 0) {      // lse = m scale + log l, in natural units
      float* L = a.lse + b * a.ls[0] + h * a.ls[1];
      constexpr float kLn2 = 0.6931471805599453f;
      if (row_a < a.Sq)
        L[row_a] = (sm.m_a * a.scale_log2 + __log2f(l_a)) * kLn2;
      if (row_b < a.Sq)
        L[row_b] = (sm.m_b * a.scale_log2 + __log2f(l_b)) * kLn2;
    }
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
  if (!tensor_map(enc, &tq, a.q, a.D, a.Sq, a.Hq, a.B, a.qs, kBM) ||
      !tensor_map(enc, &tk, a.k, a.D, a.kv_end, a.Hkv, a.B, a.ks, kBN) ||
      !tensor_map(enc, &tv, a.v, a.D, a.kv_end, a.Hkv, a.B, a.vs, kBN))
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
  t.scale_log2 = a.scale * kLog2e;
  t.lse = a.lse;
  t.ls[0] = a.ls[0];
  t.ls[1] = a.ls[1];
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
// 16 B aligned and D a multiple of 8 (TMA).  lse, when not null, receives
// each query row's log-sum-exp of the scaled, masked scores (float32, rows
// contiguous, batch and head strides lse_b and lse_h).  Launches on
// `stream` and returns cudaGetLastError() (0 on success), or 10000 when the
// TMA maps cannot be made.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int dtype, int B,
    int Hq, int Hkv, int Sq, int Skv, int D, const long long* q_strides,
    const long long* k_strides, const long long* v_strides,
    const long long* o_strides, int causal, int q_offset, int kv_end,
    float scale, float* lse, long long lse_b, long long lse_h,
    void* stream) {
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
  a.lse = lse;
  a.ls[0] = lse_b;
  a.ls[1] = lse_h;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_tc(a, s) : launch_f32(a, s);
}
