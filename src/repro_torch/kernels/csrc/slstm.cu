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
// What bounds it on an H100.  At xlstm-350m's training shape (gx [4, 1024,
// 4, 1024] bf16, r [4, 256, 1024], dh 256) the forward's bytes (gx read, ys
// written, r once: 44 MB) take 13 us and its 4.3e9 multiply-adds 8.7 us at
// the bf16 tensor-core rate: bound by bytes on paper.  What holds the
// kernel is the chain of 1 024 dependent positions: each needs every unit's
// h from the one before, and a head's r (512 KB of bf16) is larger than one
// SM's shared memory, so a position's product is spread over several SMs
// and every position ends in a hand-off between them.  The design keeps
// that chain to one product, the cell and one point-to-point hand-off a
// position, with nothing on it waiting on device memory.
//
// Design.  A head and a tile of up to 8 batch rows run on a cluster of
// nc = ceil(dh / 32) CTAs (8 at dh 256); CTA k owns units [32 k, 32 k + 32)
// and their four gates' 128 columns of r.  A CTA has four warps on the
// recurrence and one producer warp.  Warp w owns units 8 w .. 8 w + 7; lane
// (g = lane / 4, t = lane % 4) owns unit 8 w + g for the tile's columns
// 2 t and 2 t + 1: batch rows 2 t + j, or with 4 rows or fewer rows t (at
// column 2 t) and none, so that each lane runs one cell, not two.
//  * bf16: the product runs on the tensor cores with r held in registers
//    for the whole launch: the CTA's 64 KB slice is copied into shared
//    memory once with 16-byte loads and turned into A fragments by
//    ldmatrix, 128 registers a thread.  Each warp issues mma.sync m16n8k16
//    (N = the tile's 8 columns) on two m16 tiles over the 16 k-steps of
//    dh, each tile's k-steps in order into one sum (the plain product's
//    order).
//    The columns are permuted at the load: a warp's first tile holds its
//    units' z (rows 0-7) and i (rows 8-15) columns, its second f and o, so
//    a thread's accumulator rows g and g + 8 of both tiles are one unit's
//    four gates for its two columns, and the cell runs from registers with
//    no reduction through shared memory.  B is h in shared memory, [unit]
//    [8 columns], read by ldmatrix.  Why not wgmma: the product is 128 x 8
//    x 256 a position, and wgmma m64n8k16 from the same registers (the
//    four warps as one warpgroup) was slower at N = 8 in every measurement
//    (scripts/slstm_ablation.py builds it as its `wgmma` variant; PERF.md
//    §6).  The bf16 cell takes the hardware's exp, log and division
//    (below).
//    float32 (the reduced parity runs) runs the same mapping on the CUDA
//    cores with r in shared memory and the library's functions.
//  * The hand-off is point to point, with no cluster barrier on the chain.
//    h is double buffered by position parity, [unit][8 batch rows], each
//    buffer with its own mbarrier.  Each lane sends its unit's two h values
//    (one 32-bit word in bf16) to every CTA of the cluster, itself included,
//    with st.async ... mbarrier::complete_tx::bytes; each CTA waits on its
//    own mbarrier for the bytes of all nc blocks, and one thread re-arms it
//    for the buffer's next use.  One cluster barrier at the start (every
//    CTA's barriers initialised and armed before any byte is sent) and one
//    at the end (no CTA leaves while a peer may still write to it).
//    Why the double buffer is safe: CTA A writes buffer t & 1 again with
//    h_{t+2} only at position t + 1, after its wait there has passed; that
//    wait needs every peer's h_{t+1}, and each peer sends h_{t+1} only after
//    its position-t product has read buffer t & 1 (the value sent is
//    computed from what was read).  Every warp of every CTA sends to every
//    CTA, so the same wait also orders all of the receiver's own warps.  The
//    bytes of h_{t+2} land on the buffer's mbarrier only after its phase for
//    h_t completed (that wait came first), and if they land before the
//    re-arm the transaction count runs negative and the phase cannot
//    complete until the re-arm's arrival.
//  * Device memory is off the chain.  The producer warp streams gx for the
//    next KP positions (KP up to 16, what shared memory holds) into a
//    two-stage ring with TMA (one 5-d box a stage: units x gates x
//    positions x batch rows), behind full barriers; the outputs (ys and,
//    with `save`, g, c, n and m) go to a two-stage staging buffer that the
//    producer stores with TMA every KP positions, the recurrence's threads
//    arriving on a done barrier (which also frees the gx stage) and waiting
//    on a free barrier only when a staging stage comes round again.
//
// Backward, from the last position down: each lane takes its unit's dh
// (the output's gradient plus the recurrent one, summed in h's type as
// autograd sums them), rebuilds the step from the saved gate inputs g and
// the previous position's saved c, n, m (streamed in reverse by the
// producer, as is dys; dgx goes out through staging), and forms dg, which
// is dgx (rounded to gx's type, as autograd's cast does) and d(h r).  The
// recurrent gradient dh_{t-1} = dg r^T sums over all 4 dh columns, which
// the CTAs split: each CTA forms, on the tensor cores, its 128 columns'
// partial for every unit (mma.sync, M = dh in m16 tiles, warp w's tiles
// w, w + 4, ..., K = 128, N = 8, each tile's even and odd k-steps two sums;
// r's rows in registers, dg written to a shared buffer double buffered by
// position parity, one barrier of the four warps: a warp of the receiving
// CTA may still read one buffer while another warp, whose partials have
// all arrived, writes the other), and sends unit block k's partial to CTA k
// with st.async (float32); CTA k waits for the nc partials on its own
// mbarrier (double buffered as the forward's h, by the same argument) and
// adds them in rank order.  The part of each cell that needs only saved
// values (the forward cell rebuilt, its exponentials and the divisions by
// them) is done before that wait, off the chain; what needs dh after it.
// dr = sum_t h_{t-1}^T dg_t is one batched matrix
// product after the kernel (the wrapper's).  The maximum's gradient splits
// a tie in half (torch.maximum's and jnp.maximum's rule); max(n', 1) passes
// the whole gradient at n' == 1 (torch.clamp_min's rule, which the plain
// version takes; jnp.maximum would pass half, and the two cancel to
// rounding: ROADMAP.md, traps).
//
// Every sum is in a fixed order (the tensor cores' sums and their order,
// the rank order of the partials; float32 products one k at a time) and
// nothing is atomic: the same bits on every run.  Takes dh <= 256, a
// multiple of 16 in bf16 (the k-steps) and of 4 in float32 (TMA's 16-byte
// strides).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;                    // warps on the recurrence
constexpr int kUnits = 8 * kWarps;           // units a CTA, 8 a warp
constexpr int kThreads = 32 * kWarps + 32;   // and the producer warp
constexpr int kRows = 8;                     // batch rows a tile: mma's N
constexpr int kMaxDh = 256;
constexpr int kKSteps = kMaxDh / 16;         // forward k-steps (K = dh)
constexpr int kTilesB = kMaxDh / 16 / kWarps;  // backward m16 tiles a warp
constexpr int kKStepsB = 4 * kUnits / 16;    // backward k-steps (K = 4 U)
constexpr int kMaxNc = kMaxDh / kUnits;      // CTAs a cluster, at most
constexpr int kMaxStage = 16;                // positions a stage, at most
constexpr uint32_t kMaxSmem = 232448;

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

// The cell's transcendentals.  float32 (the parity path): the library's
// functions.  bf16: the hardware's exp, log and division (__expf, __logf,
// __fdividef), softplus's log1p as __logf(1 + e^-|x|) and tanh as
// 1 - 2 / (e^2z + 1).  Those two lose relative precision near 0 (1 + e
// rounds, the difference cancels) where the terms they feed are small
// beside the carry's: at r = 0 (the cell alone) the carries c, n and m
// after every position stay within 3.6e-7 of the largest plain entry
// (the library's log1pf and tanhf: 3.3e-7; c elementwise up to 1.0e-4
// against 6.1e-5 over the entries above 1e-3 of the largest), with no
// drift over 16 384 positions, for 0.13 ms less a forward at xlstm-350m's
// shape
// (scripts/slstm_ablation.py --cell-error; PERF.md §6).  chip_smoke.py's
// phase 2f holds them to float32's 2e-5 of the largest entry.
template <bool kFast>
__device__ __forceinline__ float ex(float x) {
  return kFast ? __expf(x) : expf(x);
}
template <bool kFast>
__device__ __forceinline__ float fdiv(float a, float b) {
  return kFast ? __fdividef(a, b) : a / b;
}
template <bool kFast>
__device__ __forceinline__ float softplus(float x) {  // jax.nn.softplus's form
  return fmaxf(x, 0.f) + (kFast ? __logf(1.f + __expf(-fabsf(x)))
                                : log1pf(expf(-fabsf(x))));
}
template <bool kFast>
__device__ __forceinline__ float sigmoid(float x) {
  return fdiv<kFast>(1.f, 1.f + ex<kFast>(-x));
}
template <bool kFast>
__device__ __forceinline__ float tanh_(float x) {
  return kFast ? 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f) : tanhf(x);
}

// One cell: the gate inputs z, i, f, o (float32, already rounded as the
// reference rounds them) and the carry c, n, m; what the backward reuses.
struct Cell {
  float lfm, m2, ip, fp, tz, c2, n2, so, hv;
};

template <bool kFast>
__device__ __forceinline__ Cell cell(const float pre[4], float c, float n,
                                     float m) {
  Cell s;
  const float lf = -softplus<kFast>(-pre[2]);
  s.lfm = lf + m;
  s.m2 = fmaxf(s.lfm, pre[1]);
  s.ip = ex<kFast>(pre[1] - s.m2);
  s.fp = ex<kFast>(s.lfm - s.m2);
  s.tz = tanh_<kFast>(pre[0]);
  s.c2 = s.fp * c + s.ip * s.tz;
  s.n2 = s.fp * n + s.ip;
  s.so = sigmoid<kFast>(pre[3]);
  s.hv = fdiv<kFast>(s.so * s.c2, fmaxf(s.n2, 1.f));
  return s;
}

// ------------------------- Hopper pieces of this file -----------------------

// The address of `addr` (this CTA's shared memory) in CTA `rank`'s.
__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// Stores into a cluster peer's shared memory, completing their bytes on the
// peer's mbarrier `bar` (both shared::cluster addresses).
__device__ __forceinline__ void st_async(uint32_t addr, uint32_t v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.u32 [%0], %1, "
      "[%2];\n" :: "r"(addr), "r"(v), "r"(bar) : "memory");
}
__device__ __forceinline__ void st_async(uint32_t addr, float2 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];\n" :: "r"(addr), "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// Waits until the barrier's phase of the given parity has completed.  The
// hand-off's bytes come from other CTAs by st.async, whose completion on
// this barrier makes them visible to the waiting threads.  A wait that
// spins past about 2^26 tries traps, so a fault in the hand-off ends the
// launch with an error rather than hanging the card.
__device__ __forceinline__ void spin_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t ok;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
    if (ok) return;
    if (n == (1u << 26)) __trap();
  }
}

// Generic-proxy writes to shared memory made visible to TMA stores.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load5(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int c0, int c1, int c2,
                                          int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(m)), "r"(bar), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void tma_store4(const CUtensorMap* m, uint32_t src,
                                           int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(m)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store5(const CUtensorMap* m, uint32_t src,
                                           int c0, int c1, int c2, int c3,
                                           int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.global.shared::cta.bulk_group [%0, {%2, %3, "
      "%4, %5, %6}], [%1];\n"
      :: "l"(reinterpret_cast<uint64_t>(m)), "r"(src), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" :: "n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four 8x8 b16 matrices from shared memory (lane l: the row address of
// matrix l / 8, row l % 8).
__device__ __forceinline__ void ldsm4(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b: m16n8k16, bf16 in, float32 sums
__device__ __forceinline__ void mma16816(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------ the layout ----------------------------------

// Byte offsets into dynamic shared memory (set by the host, `plan`).  A
// [nbt][KP][U] block is one output or carry stream of a stage; gates are
// [nbt][KP][4][U] (TMA's box order: units, gates, positions, batch rows).
struct Layout {
  uint32_t rs;          // r's slice, staged
  uint32_t hb;          // forward: h, [2][kpad][8]
  uint32_t recv, dgs;   // backward: partials [2][nc][U][8] f32, dg [2][4U][8]
  uint32_t ring, ring_stage, load_bytes;  // the input ring, 2 stages
  uint32_t in_c, in_h;  // within a ring stage (gates at 0): c, n, m; h
  uint32_t out, out_stage;                // the output staging, 2 stages
  uint32_t out_g, out_c;  // within an output stage (h, or dgx, at 0)
  uint32_t cbytes;      // a float32 [nbt][KP][U] block, padded
  uint32_t bars, total;
  int kpad, rpitch;     // h rows; r's staged row pitch (elements)
  int rrows;            // r's staged rows: dh to the product's row tiles
};

struct Params {
  // forward: gin gx, gout g, mc / mn / mm cs / ns / ms, mh ys (stores but
  // gx); backward: gin g, gout dgx, mc / mn / mm cs / ns / ms, mh dys
  // (loads but dgx)
  CUtensorMap gin, gout, mc, mn, mm, mh;
  Layout lay;
  const void* r;                      // [H, dh, 4 dh]
  const float *c0, *n0, *m0;          // carry in, [B, H, dh] each
  const void* h0;
  float *c1, *n1, *m1;                // forward: carry out
  void* h1;
  const float *dc1, *dn1, *dm1;       // backward: the carry out's gradients
  const void* dh1;                    //   (each may be null: zero)
  float *dc0, *dn0, *dm0;             // backward: the carry in's
  void* dh0;
  int B, L, H, dh, nc, nbt, KP;
  int save, has_dys;
};

struct Tile {                          // this CTA's place in the grid
  int head, b0, nb, u0, rank;
};

// The batch row of lane column 2 t + j (the mma's n): with 4 rows or
// fewer, rows t at column 2 t, so that each lane has one row's cell and
// the cells at column 2 t + 1 (rows 4 and up) are skipped as past nb.
__device__ __forceinline__ int row_of(const Tile& tl, int tq, int j) {
  return tl.nb <= 4 ? tq + 4 * j : 2 * tq + j;
}

__device__ __forceinline__ Tile tile_of(const Params& p, int rank) {
  Tile t;
  const int cid = blockIdx.x / p.nc;
  t.rank = rank;
  t.head = cid % p.H;
  t.b0 = (cid / p.H) * kRows;
  t.nb = min(kRows, p.B - t.b0);
  t.u0 = rank * kUnits;
  return t;
}

// This CTA's columns of r (its units' four gates) into shared memory with
// 16-byte loads, zero past dh: [d][q][U] at row pitch `pitch` (elements), or
// with `unit_major` (the float32 forward) [d][U][4].  Rows past dh (to the
// layout's rrows) are zero.
template <typename T>
__device__ void stage_r(T* rs, const Params& p, const Tile& tl, int pitch,
                        bool unit_major) {
  constexpr int E = 16 / sizeof(T);          // elements of a 16-byte chunk
  const int dh = p.dh, per_row = 4 * kUnits / E;
  const int rows = p.lay.rrows;
  const T* R = static_cast<const T*>(p.r) + (long long)tl.head * dh * 4 * dh;
  for (int e = threadIdx.x; e < rows * per_row; e += kThreads) {
    const int d = e / per_row, c = e % per_row, q = c / (kUnits / E),
              u = (c % (kUnits / E)) * E;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (d < dh && tl.u0 + u < dh)
      v = *reinterpret_cast<const uint4*>(R + (long long)d * 4 * dh +
                                          q * dh + tl.u0 + u);
    if (unit_major) {
      const T* x = reinterpret_cast<const T*>(&v);
      for (int i = 0; i < E; ++i) rs[(d * kUnits + u + i) * 4 + q] = x[i];
    } else {
      *reinterpret_cast<uint4*>(rs + d * pitch + q * kUnits + u) = v;
    }
  }
}

// The producer's side of a launch (lane 0 of the last warp).  Stage s
// covers positions [t0, t0 + KP), t0 = s KP, or in the backward (positions
// taken from the last down) t0 = (nst - 1 - s) KP; TMA fills and clips the
// positions past L.  The backward's carry entering each position is read
// from t0 - 1, or from 0 in the stage at t0 = 0 (its position 0 takes the
// carry in).  load_stage: stage s's inputs into ring slot s & 1, on its
// full barrier.
template <bool kBwd>
__device__ __forceinline__ int stage_t0(const Params& p, int s) {
  const int nst = (p.L + p.KP - 1) / p.KP;
  return (kBwd ? nst - 1 - s : s) * p.KP;
}

template <bool kBwd>
__device__ void load_stage(const Params& p, const Tile& tl,
                           unsigned char* smem, const uint64_t* bars, int s) {
  const Layout& y = p.lay;
  const int slot = s & 1, t0 = stage_t0<kBwd>(p, s);
  const uint32_t bar = smem_u32(bars + 2 + slot);
  const uint32_t dst = smem_u32(smem + y.ring + slot * y.ring_stage);
  mbar_expect_tx(bar, y.load_bytes);
  tma_load5(dst, &p.gin, bar, tl.u0, 0, t0, tl.head, tl.b0);
  if (kBwd) {                          // the carry entering each position
    const int tc = max(t0 - 1, 0);
    tma_load(dst + y.in_c, &p.mc, bar, tl.u0, tc, tl.head, tl.b0);
    tma_load(dst + y.in_c + y.cbytes, &p.mn, bar, tl.u0, tc, tl.head, tl.b0);
    tma_load(dst + y.in_c + 2 * y.cbytes, &p.mm, bar, tl.u0, tc, tl.head,
             tl.b0);
    if (p.has_dys)
      tma_load(dst + y.in_h, &p.mh, bar, tl.u0, t0, tl.head, tl.b0);
  }
}

// The rest of the producer's work, once stages 0 and 1 are loading: each
// finished stage's outputs stored from staging slot s & 1, stage s + 2
// loaded into the ring slot it freed, and the staging slot freed once the
// store has read it.
template <bool kBwd>
__device__ void producer(const Params& p, const Tile& tl, unsigned char* smem,
                         const uint64_t* bars) {
  const Layout& y = p.lay;
  const int nst = (p.L + p.KP - 1) / p.KP;
  for (int s = 0; s < nst; ++s) {
    const int slot = s & 1, t0 = stage_t0<kBwd>(p, s);
    spin_wait(smem_u32(bars + 4 + slot), (s >> 1) & 1);
    const uint32_t src = smem_u32(smem + y.out + slot * y.out_stage);
    if (kBwd) {
      tma_store5(&p.gout, src, tl.u0, 0, t0, tl.head, tl.b0);
    } else {
      tma_store4(&p.mh, src, tl.u0, t0, tl.head, tl.b0);
      if (p.save) {
        tma_store5(&p.gout, src + y.out_g, tl.u0, 0, t0, tl.head, tl.b0);
        tma_store4(&p.mc, src + y.out_c, tl.u0, t0, tl.head, tl.b0);
        tma_store4(&p.mn, src + y.out_c + y.cbytes, tl.u0, t0, tl.head,
                   tl.b0);
        tma_store4(&p.mm, src + y.out_c + 2 * y.cbytes, tl.u0, t0, tl.head,
                   tl.b0);
      }
    }
    bulk_commit();
    if (s + 2 < nst) {                 // the stage's slots come round again
      load_stage<kBwd>(p, tl, smem, bars, s + 2);
      bulk_wait_read<0>();
      mbar_arrive(smem_u32(bars + 6 + slot));
    }
  }
  bulk_wait<0>();
}

// The start of both kernels: barriers made (hand-off, full, done, free: two
// each), the hand-off's first two uses armed with `hbytes` each, the first
// two stages loading, r's slice staged by every thread.  Then the producer
// warp runs its loop between the two cluster barriers and returns true.
template <bool kBwd, typename T>
__device__ bool start(const Params& p, const Tile& tl, unsigned char* smem,
                      uint64_t* bars, uint32_t hbytes, int arm0, int arm1,
                      cg::cluster_group& cluster) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_u32(bars + i), 1);
      mbar_init(smem_u32(bars + 2 + i), 1);
      mbar_init(smem_u32(bars + 4 + i), 32 * kWarps);
      mbar_init(smem_u32(bars + 6 + i), 1);
    }
    mbar_init_fence();
    if (arm0 >= 0) mbar_expect_tx(smem_u32(bars + arm0), hbytes);
    if (arm1 >= 0) mbar_expect_tx(smem_u32(bars + arm1), hbytes);
  }
  __syncthreads();
  const int nst = (p.L + p.KP - 1) / p.KP;
  if (warp == kWarps && lane == 0)
    for (int s = 0; s < min(2, nst); ++s)
      load_stage<kBwd>(p, tl, smem, bars, s);
  stage_r(reinterpret_cast<T*>(smem + p.lay.rs), p, tl, p.lay.rpitch,
          !kBwd && sizeof(T) == 4);
  __syncthreads();
  if (warp < kWarps) return false;
  cluster.sync();                      // the start
  if (lane == 0 && nst > 0) producer<kBwd>(p, tl, smem, bars);
  __syncwarp();
  cluster.sync();                      // the end
  return true;
}

// ------------------------------- forward ------------------------------------

// h r for the thread's unit and columns, bf16 on the tensor cores: s[tile]
// [e] of fragment element e (the module note's mapping).  Each warp alone,
// mma.sync: h's fragments all loaded first (ldmatrix), then each tile's
// k-steps in order into one sum.  kFull: all kKSteps k-steps (dh 256), no
// test of ks.
template <bool kFull>
__device__ __forceinline__ void fwd_product(
    float (&s)[2][4], const uint32_t (&a)[2][kKSteps][4], uint32_t hbase,
    int ks, int lane) {
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[x][e] = 0.f;
  uint32_t b[kKSteps / 2][4];          // k-steps 2 i and 2 i + 1 of h
  const uint32_t row = hbase + lane * 16;
#pragma unroll
  for (int i = 0; i < kKSteps / 2; ++i)
    if (kFull || 2 * i < ks) ldsm4_t(b[i], row + i * 512);
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    if (kFull || kk < ks) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
        mma16816(s[x], a[x][kk], b[kk / 2][2 * (kk % 2)],
                 b[kk / 2][2 * (kk % 2) + 1]);
    }
  }
}

// The same in float32 on the CUDA cores, r in shared memory [d][U][4].
__device__ __forceinline__ void fwd_product_f32(float (&s)[2][4],
                                                const float* rs,
                                                const float* hcur, int dh,
                                                int ul, int tq) {
  float acc[4][2] = {};
  const float4* r4 = reinterpret_cast<const float4*>(rs) + ul;
  const float* hp = hcur + 2 * tq;
  for (int d = 0; d < dh; ++d) {
    const float4 rv = r4[d * kUnits];
    const float2 hv = *reinterpret_cast<const float2*>(hp + d * kRows);
    const float r[4] = {rv.x, rv.y, rv.z, rv.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      acc[q][0] += hv.x * r[q];
      acc[q][1] += hv.y * r[q];
    }
  }
  // the tensor-core path's places: tile 0 z, i; tile 1 f, o
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    s[0][j] = acc[0][j];
    s[0][2 + j] = acc[1][j];
    s[1][j] = acc[2][j];
    s[1][2 + j] = acc[3][j];
  }
}

// Sends the thread's unit's h for its two batch rows to every CTA's buffer
// `buf` (the module note's hand-off).
template <typename T>
__device__ __forceinline__ void push_h(const T* hb, uint64_t* hbar, int buf,
                                       int kpad, int uu, int tq, int nc,
                                       const float (&hv)[2]) {
  const uint32_t la = smem_u32(hb + (buf * kpad + uu) * kRows + 2 * tq);
  const uint32_t lb = smem_u32(hbar + buf);
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k) {
    if (k >= nc) break;
    if constexpr (sizeof(T) == 2)
      st_async(mapa(la, k), pack2(hv[0], hv[1]), mapa(lb, k));
    else
      st_async(mapa(la, k), make_float2(hv[0], hv[1]), mapa(lb, k));
  }
}

// grid (nc x H x batch tiles of 8 rows), clusters of nc: the recurrence
// forward
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_fwd(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile tl = tile_of(p, (int)cluster.block_rank());
  const Layout& y = p.lay;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, ul = 8 * warp + lane / 4, uu = tl.u0 + ul;
  const int dh = p.dh, L = p.L, KP = p.KP;
  T* hb = reinterpret_cast<T*>(smem + y.hb);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + y.bars);
  uint64_t* hbar = bars;               // then full, done, free: 2 each
  const uint32_t hbytes = p.nc * kUnits * kRows * sizeof(T);
  // h_0 and h_1 are the buffers' first uses
  if (start<false, T>(p, tl, smem, bars, hbytes, L > 0 ? 0 : -1,
                      L > 1 ? 1 : -1, cluster))
    return;
  // ---- the recurrence's warps
  const int ks = (dh + 15) / 16;
  uint32_t a[2][kKSteps][4];           // r^T: tile x (gates 2x, 2x + 1)
  if constexpr (sizeof(T) == 2) {
    const T* rs = reinterpret_cast<const T*>(smem + y.rs);
    const int mi = lane / 8;
#pragma unroll
    for (int x = 0; x < 2; ++x)
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        const int d = 16 * kk + 8 * (mi >> 1) + lane % 8;
        if (kk < ks)
          ldsm4_t(a[x][kk], smem_u32(rs + d * y.rpitch +
                                     (2 * x + (mi & 1)) * kUnits + 8 * warp));
        else
          a[x][kk][0] = a[x][kk][1] = a[x][kk][2] = a[x][kk][3] = 0;
      }
  }
  float c[2], n[2], m[2], hl[2];       // the carry of batch rows 2 tq + j
  bool real[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = row_of(tl, tq, j);
    real[j] = b < tl.nb && uu < dh;
    const long long oi = ((long long)(tl.b0 + b) * p.H + tl.head) * dh + uu;
    c[j] = real[j] ? p.c0[oi] : 0.f;
    n[j] = real[j] ? p.n0[oi] : 0.f;
    m[j] = real[j] ? p.m0[oi] : 0.f;
    hl[j] = real[j] ? to_f(static_cast<const T*>(p.h0)[oi]) : 0.f;
  }
  cluster.sync();                      // every CTA's barriers armed
  if (L > 0) push_h(hb, hbar, 0, y.kpad, uu, tq, p.nc, hl);
  for (int t = 0; t < L; ++t) {
    const int s = t / KP, pp = t % KP, slot = s & 1;
    if (pp == 0) {                     // a new stage: gx in, staging free
      spin_wait(smem_u32(bars + 2 + slot), (s >> 1) & 1);
      if (s >= 2)
        spin_wait(smem_u32(bars + 6 + slot), ((s >> 1) - 1) & 1);
    }
    spin_wait(smem_u32(hbar + (t & 1)), (t >> 1) & 1);
    float acc[2][4] = {};
    if constexpr (sizeof(T) == 2) {
      const uint32_t hcur = smem_u32(hb + (t & 1) * y.kpad * kRows);
      if (ks == kKSteps)
        fwd_product<true>(acc, a, hcur, ks, lane);
      else
        fwd_product<false>(acc, a, hcur, ks, lane);
    } else
      fwd_product_f32(acc, reinterpret_cast<const float*>(smem + y.rs),
                      reinterpret_cast<const float*>(hb) + (t & 1) * y.kpad *
                      kRows, dh, ul, tq);
    const T* gxs = reinterpret_cast<const T*>(smem + y.ring +
                                              slot * y.ring_stage);
    unsigned char* os = smem + y.out + slot * y.out_stage;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!real[j]) continue;          // h stays 0
      const int b = row_of(tl, tq, j);
      const int e = (b * KP + pp) * kUnits + ul;   // in a [nbt][KP][U] block
      float pre[4];
      const float hr[4] = {acc[0][j], acc[0][2 + j], acc[1][j],
                           acc[1][2 + j]};
#pragma unroll
      for (int q = 0; q < 4; ++q) {    // gx + (h r rounded), rounded
        const float gxv = to_f(gxs[(b * KP + pp) * 4 * kUnits + q * kUnits +
                                   ul]);
        pre[q] = round_to<T>(gxv + round_to<T>(hr[q]));
      }
      const Cell sc = cell<sizeof(T) == 2>(pre, c[j], n[j], m[j]);
      c[j] = sc.c2;
      n[j] = sc.n2;
      m[j] = sc.m2;
      hl[j] = round_to<T>(sc.hv);
      reinterpret_cast<T*>(os)[e] = from_f<T>(hl[j]);
      if (p.save) {
        T* gs = reinterpret_cast<T*>(os + y.out_g);
#pragma unroll
        for (int q = 0; q < 4; ++q)
          gs[(b * KP + pp) * 4 * kUnits + q * kUnits + ul] = from_f<T>(pre[q]);
        float* cs = reinterpret_cast<float*>(os + y.out_c);
        cs[e] = c[j];
        cs[y.cbytes / 4 + e] = n[j];
        cs[2 * (y.cbytes / 4) + e] = m[j];
      }
    }
    if (t + 1 < L) push_h(hb, hbar, (t + 1) & 1, y.kpad, uu, tq, p.nc, hl);
    if (threadIdx.x == 0 && t + 2 < L)   // buffer t & 1 re-armed for h_{t+2}
      mbar_expect_tx(smem_u32(hbar + (t & 1)), hbytes);
    if (pp == KP - 1 || t == L - 1) {  // the stage done: to the producer
      fence_async_smem();
      mbar_arrive(smem_u32(bars + 4 + slot));
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!real[j]) continue;
    const long long oi =
        ((long long)(tl.b0 + row_of(tl, tq, j)) * p.H + tl.head) * dh + uu;
    p.c1[oi] = c[j];
    p.n1[oi] = n[j];
    p.m1[oi] = m[j];
    static_cast<T*>(p.h1)[oi] = from_f<T>(hl[j]);
  }
  cluster.sync();                      // the end
}

// ------------------------------- backward -----------------------------------

// The nc partials of column `col` of unit `ul` in buffer `rb`, added in rank
// order (all loaded first), rounded to T.
template <typename T>
__device__ __forceinline__ float rank_sum(const float* recv, int rb, int nc,
                                          int ul, int col) {
  float v[kMaxNc];
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k)
    v[k] = k < nc ? recv[((rb * nc + k) * kUnits + ul) * kRows + col] : 0.f;
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxNc; ++k)
    if (k < nc) sum += v[k];
  return round_to<T>(sum);
}

// One position's cell backward for one batch row, in two parts.
// cell_saved: what it takes from the saved values alone (the gate inputs
// `pre`, the carry entering the position cp, np, mp), off the chain: the
// forward cell rebuilt and the terms that need no gradient.  cell_grad:
// the rest, from dh of the output (dhf) and the carry's gradients (dc, dn,
// dm, updated to the position's entry); writes dg.  The same operations in
// the same order as one pass would do them.
struct Saved {
  float cp, np, so, oms, c2, tz, ip, fp, den, q, omtz, e, ep1, sgn, pos;
  float n1, tie;        // n' >= 1; the sign of (lf + m) - i
};

template <bool kFast>
__device__ __forceinline__ Saved cell_saved(const float pre[4], float cp,
                                            float np, float mp) {
  const Cell s = cell<kFast>(pre, cp, np, mp);
  Saved k;
  k.cp = cp;
  k.np = np;
  k.so = s.so;
  k.oms = 1.f - s.so;
  k.c2 = s.c2;
  k.tz = s.tz;
  k.ip = s.ip;
  k.fp = s.fp;
  // h' = (so c') / den, den = max(n', 1)
  k.den = fmaxf(s.n2, 1.f);
  k.q = fdiv<kFast>(fdiv<kFast>(s.so * s.c2, k.den), k.den);
  k.n1 = s.n2 >= 1.f ? 1.f : 0.f;
  k.omtz = 1.f - s.tz * s.tz;
  k.tie = s.lfm > pre[1] ? 1.f : (s.lfm < pre[1] ? -1.f : 0.f);
  // lf = -softplus(-f), softplus(x) = max(x, 0) + log1p(exp(-|x|))
  const float x = -pre[2];
  k.e = ex<kFast>(-fabsf(x));
  k.ep1 = 1.f + k.e;
  k.sgn = x > 0.f ? 1.f : (x < 0.f ? -1.f : 0.f);
  k.pos = x >= 0.f ? 1.f : 0.f;
  return k;
}

// Keeps the compiler from moving cell_saved's work past the wait that
// follows it.
__device__ __forceinline__ void pin(Saved& k) {
  float* f = &k.cp;
  fence_regs<sizeof(Saved) / sizeof(float)>(f);
}

template <bool kFast>
__device__ __forceinline__ void cell_grad(const Saved& k, float dhf,
                                          float& dc, float& dn, float& dm,
                                          float dg[4]) {
  const float dA = fdiv<kFast>(dhf, k.den);
  const float dden = -dhf * k.q;
  const float dn2 = dn + (k.n1 != 0.f ? dden : 0.f);
  const float dc2 = dc + dA * k.so;
  const float dso = dA * k.c2;
  const float d_o = dso * k.oms * k.so;
  // c' = f' c + i' tz, n' = f' n + i'
  const float dfp = dc2 * k.cp + dn2 * k.np;
  const float dip = dc2 * k.tz + dn2;
  const float dz = dc2 * k.ip * k.omtz;
  const float dxi = dip * k.ip;        // of i - m'
  const float dxf = dfp * k.fp;        // of lf + m - m'
  const float dm2 = dm - dxi - dxf;
  // m' = max(lf + m, i): a tie splits the gradient in half
  float dlfm = dxf, di = dxi;
  if (k.tie > 0.f) {
    dlfm += dm2;
  } else if (k.tie < 0.f) {
    di += dm2;
  } else {
    dlfm += 0.5f * dm2;
    di += 0.5f * dm2;
  }
  const float dsp = -dlfm;
  const float dabs = -(fdiv<kFast>(dsp, k.ep1) * k.e);
  const float df = -(dsp * k.pos + dabs * k.sgn);
  dg[0] = dz;
  dg[1] = di;
  dg[2] = df;
  dg[3] = d_o;
  dc = dc2 * k.fp;
  dn = dn2 * k.fp;
  dm = dlfm;
}

// This CTA's partial of dg r^T for every unit (rows 16 (i kWarps + warp)
// + g, + 8 of m16 tile i; columns the thread's two batch rows), bf16 on
// the tensor cores from dg's buffer at `base` ([4U][8]).  Each warp alone,
// mma.sync: dg's fragments loaded first, each tile's even and odd k-steps
// two sums added in that order.
__device__ __forceinline__ void bwd_product(
    float (&s)[kTilesB][4], const uint32_t (&a)[kTilesB][kKStepsB][4],
    uint32_t base, int tiles, int lane) {
  float acc[kTilesB][2][4];
#pragma unroll
  for (int i = 0; i < kTilesB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][0][e] = acc[i][1][e] = 0.f;
  uint32_t b[kKStepsB / 2][4];
  const uint32_t row = base + lane * 16;
#pragma unroll
  for (int i = 0; i < kKStepsB / 2; ++i) ldsm4_t(b[i], row + i * 512);
#pragma unroll
  for (int kk = 0; kk < kKStepsB; ++kk) {
#pragma unroll
    for (int i = 0; i < kTilesB; ++i)
      if (i < tiles)
        mma16816(acc[i][kk % 2], a[i][kk], b[kk / 2][2 * (kk % 2)],
                 b[kk / 2][2 * (kk % 2) + 1]);
  }
#pragma unroll
  for (int i = 0; i < kTilesB; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[i][e] = acc[i][0][e] + acc[i][1][e];
}

// The same in float32 on the CUDA cores, r in shared memory [d][4U] at row
// pitch `pitch`, dg [4U][8].
__device__ __forceinline__ void bwd_product_f32(float (&acc)[kTilesB][4],
                                                const float* rs,
                                                const float* dgs, int pitch,
                                                int tiles, int warp,
                                                int lane) {
  const int g8 = lane / 4, tq = lane % 4;
  for (int lc = 0; lc < 4 * kUnits; ++lc) {
    const float2 dv = *reinterpret_cast<const float2*>(dgs + lc * kRows +
                                                       2 * tq);
#pragma unroll
    for (int i = 0; i < kTilesB; ++i) {
      if (i < tiles) {
        const int d = 16 * (i * kWarps + warp) + g8;
        const float r0 = rs[d * pitch + lc], r1 = rs[(d + 8) * pitch + lc];
        acc[i][0] += r0 * dv.x;
        acc[i][1] += r0 * dv.y;
        acc[i][2] += r1 * dv.x;
        acc[i][3] += r1 * dv.y;
      }
    }
  }
}

// grid as the forward's: the recurrence backward
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    slstm_bwd(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const Tile tl = tile_of(p, (int)cluster.block_rank());
  const Layout& y = p.lay;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tq = lane % 4, ul = 8 * warp + lane / 4, uu = tl.u0 + ul;
  const int dh = p.dh, L = p.L, KP = p.KP, nc = p.nc;
  float* recv = reinterpret_cast<float*>(smem + y.recv);
  T* dgs = reinterpret_cast<T*>(smem + y.dgs);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + y.bars);
  uint64_t* rbar = bars;               // then full, done, free: 2 each
  const int mine = max(0, min(kUnits, dh - tl.u0));   // this CTA's units
  const uint32_t rbytes = nc * mine * kRows * 4;
  // the first sends: positions L - 1 and L - 2
  if (start<true, T>(p, tl, smem, bars, rbytes, L > 0 ? (L - 1) & 1 : -1,
                     L > 1 ? (L - 2) & 1 : -1, cluster))
    return;
  // the m64 tiles of unit rows (16 a warp each; rows past dh are zero)
  const int tiles = (dh + 16 * kWarps - 1) / (16 * kWarps);   // m64 tiles
  uint32_t a[kTilesB][kKStepsB][4];    // r: unit rows x this CTA's columns
  if constexpr (sizeof(T) == 2) {
    const T* rs = reinterpret_cast<const T*>(smem + y.rs);
    const int mi = lane / 8;
#pragma unroll
    for (int i = 0; i < kTilesB; ++i)
#pragma unroll
      for (int kk = 0; kk < kKStepsB; ++kk) {
        const int d = 16 * (i * kWarps + warp) + 8 * (mi & 1) + lane % 8;
        if (i < tiles)
          ldsm4(a[i][kk], smem_u32(rs + d * y.rpitch + 16 * kk +
                                   8 * (mi >> 1)));
        else
          a[i][kk][0] = a[i][kk][1] = a[i][kk][2] = a[i][kk][3] = 0;
      }
  }
  float dc[2], dn[2], dm[2], dhr[2], cin[2], nin[2], min_[2];
  bool real[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int b = row_of(tl, tq, j);
    real[j] = b < tl.nb && uu < dh;
    const long long oi = ((long long)(tl.b0 + b) * p.H + tl.head) * dh + uu;
    dc[j] = real[j] && p.dc1 ? p.dc1[oi] : 0.f;
    dn[j] = real[j] && p.dn1 ? p.dn1[oi] : 0.f;
    dm[j] = real[j] && p.dm1 ? p.dm1[oi] : 0.f;
    dhr[j] = real[j] && p.dh1 ? to_f(static_cast<const T*>(p.dh1)[oi]) : 0.f;
    cin[j] = real[j] ? p.c0[oi] : 0.f;
    nin[j] = real[j] ? p.n0[oi] : 0.f;
    min_[j] = real[j] ? p.m0[oi] : 0.f;
  }
  for (int e = threadIdx.x; e < 2 * 4 * kUnits * kRows; e += 32 * kWarps)
    dgs[e] = from_f<T>(0.f);           // the columns of rows past nb
  cluster.sync();                      // every CTA's barriers armed
  const int nst = (L + KP - 1) / KP;
  for (int t = L - 1; t >= 0; --t) {
    const int s = nst - 1 - t / KP, slot = s & 1, pp = t % KP;
    const int pc = t < KP ? pp - 1 : pp;   // the carry's place in the stage
    if (t == L - 1 || pp == KP - 1) {  // a new stage: inputs in, staging free
      spin_wait(smem_u32(bars + 2 + slot), (s >> 1) & 1);
      if (s >= 2)
        spin_wait(smem_u32(bars + 6 + slot), ((s >> 1) - 1) & 1);
    }
    const unsigned char* is = smem + y.ring + slot * y.ring_stage;
    const T* gs = reinterpret_cast<const T*>(is);
    const float* cps = reinterpret_cast<const float*>(is + y.in_c);
    const T* dys = reinterpret_cast<const T*>(is + y.in_h);
    T* dgo = reinterpret_cast<T*>(smem + y.out + slot * y.out_stage);
    T* dgb = dgs + (t & 1) * 4 * kUnits * kRows;
    Saved ks[2];                       // off the chain: the saved values'
    float dyv[2];                      // part, before the wait
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!real[j]) continue;          // (a real row is in the stage)
      const int b = row_of(tl, tq, j);
      const int e = (b * KP + pp) * kUnits + ul, ec = e + (pc - pp) * kUnits;
      dyv[j] = p.has_dys ? to_f(dys[e]) : 0.f;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = to_f(gs[(b * KP + pp) * 4 * kUnits + q * kUnits + ul]);
      float cp = cin[j], np = nin[j], mp = min_[j];
      if (t > 0) {
        cp = cps[ec];
        np = cps[y.cbytes / 4 + ec];
        mp = cps[2 * (y.cbytes / 4) + ec];
      }
      ks[j] = cell_saved<sizeof(T) == 2>(pre, cp, np, mp);
      pin(ks[j]);
    }
    if (t < L - 1) {                   // the partials sent at t + 1
      const int rb = (t + 1) & 1;
      spin_wait(smem_u32(rbar + rb), ((L - 2 - t) >> 1) & 1);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (real[j]) dhr[j] = rank_sum<T>(recv, rb, nc, ul, 2 * tq + j);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!real[j]) continue;          // its dg column stays 0
      const int b = row_of(tl, tq, j), col = 2 * tq + j;
      const float dhf = round_to<T>(dyv[j] + dhr[j]);
      float dg[4];
      cell_grad<sizeof(T) == 2>(ks[j], dhf, dc[j], dn[j], dm[j], dg);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const T gt = from_f<T>(dg[q]);
        dgo[(b * KP + pp) * 4 * kUnits + q * kUnits + ul] = gt;
        dgb[(q * kUnits + ul) * kRows + col] = gt;
      }
    }
    named_sync(1, 32 * kWarps);        // every unit's dg in the buffer
    float acc[kTilesB][4] = {};
    if constexpr (sizeof(T) == 2)
      bwd_product(acc, a, smem_u32(dgb), tiles, lane);
    else
      bwd_product_f32(acc, reinterpret_cast<const float*>(smem + y.rs),
                      reinterpret_cast<const float*>(dgb), y.rpitch, tiles,
                      warp, lane);
    // unit block k's partial to CTA k, slot `rank` of its buffer t & 1
    const uint32_t lr = smem_u32(recv + ((t & 1) * nc + tl.rank) * kUnits *
                                 kRows + 2 * tq);
    const uint32_t lb = smem_u32(rbar + (t & 1));
#pragma unroll
    for (int i = 0; i < kTilesB; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int d = 16 * (i * kWarps + warp) + lane / 4 + 8 * h;
        if (i < tiles && d < dh) {
          const int k = d / kUnits;
          st_async(mapa(lr + (d % kUnits) * kRows * 4, k),
                   make_float2(acc[i][2 * h], acc[i][2 * h + 1]),
                   mapa(lb, k));
        }
      }
    }
    if (threadIdx.x == 0 && t >= 1 && t < L - 1)   // buffer (t + 1) & 1
      mbar_expect_tx(smem_u32(rbar + ((t + 1) & 1)), rbytes);  // for t - 1
    if (pp == 0) {                     // the stage done: to the producer
      fence_async_smem();
      mbar_arrive(smem_u32(bars + 4 + slot));
    }
  }
  if (L > 0) {                         // the partials sent at position 0
    spin_wait(smem_u32(rbar), ((L - 1) >> 1) & 1);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (real[j]) dhr[j] = rank_sum<T>(recv, 0, nc, ul, 2 * tq + j);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    if (!real[j]) continue;
    const long long oi =
        ((long long)(tl.b0 + row_of(tl, tq, j)) * p.H + tl.head) * dh + uu;
    p.dc0[oi] = dc[j];
    p.dn0[oi] = dn[j];
    p.dm0[oi] = dm[j];
    static_cast<T*>(p.dh0)[oi] = from_f<T>(dhr[j]);
  }
  cluster.sync();                      // the end
}

// ------------------------------- host side ----------------------------------

uint32_t up128(uint32_t x) { return (x + 127u) & ~127u; }

// The shared-memory layout at KP positions a stage; false if it does not fit.
bool layout(Layout& y, bool bwd, int es, int dh, int nc, int nbt, int KP,
            bool save, bool dys) {
  const uint32_t U = kUnits;
  y = Layout{};
  // the backward's m64 tiles of unit rows, the forward's k-steps of 16
  const int tile = bwd ? 16 * kWarps : 16;
  const uint32_t rows = (dh + tile - 1) / tile * tile;
  y.rrows = rows;
  y.kpad = (nc * kUnits + 31) / 32 * 32;
  // r's staged row pitch: a 16-byte skew a row (bank-conflict-free ldmatrix
  // and float4 reads); the float32 forward's [d][U][4] has none
  y.rpitch = 4 * kUnits + 16 / es;
  uint32_t rs_bytes = rows * y.rpitch * es;
  if (!bwd && es == 4) {
    y.rpitch = 4 * kUnits;
    rs_bytes = rows * U * 4 * 4;
  }
  uint32_t o = 0;
  y.rs = o;
  o += up128(rs_bytes);
  if (!bwd) {
    y.hb = o;
    o += up128(2 * y.kpad * kRows * es);
  } else {
    y.recv = o;
    o += up128(2 * nc * U * kRows * 4);
    y.dgs = o;
    o += up128(2 * 4 * U * kRows * es);
  }
  const uint32_t blk = nbt * KP * U;   // elements of a [nbt][KP][U] block
  y.cbytes = up128(blk * 4);
  if (!bwd) {
    y.ring_stage = up128(blk * 4 * es);
    y.load_bytes = blk * 4 * es;
  } else {
    y.in_c = up128(blk * 4 * es);
    y.in_h = y.in_c + 3 * y.cbytes;
    y.ring_stage = y.in_h + (dys ? up128(blk * es) : 0);
    y.load_bytes = blk * 4 * es + 3 * blk * 4 + (dys ? blk * es : 0);
  }
  y.ring = o;
  o += 2 * y.ring_stage;
  if (!bwd) {
    y.out_stage = up128(blk * es);
    if (save) {
      y.out_g = y.out_stage;
      y.out_c = y.out_g + up128(blk * 4 * es);
      y.out_stage = y.out_c + 3 * y.cbytes;
    }
  } else {
    y.out_stage = up128(blk * 4 * es);
  }
  y.out = o;
  o += 2 * y.out_stage;
  y.bars = o;
  o += 8 * 8;
  y.total = o;
  return o <= kMaxSmem;
}

// A tensor map of `rank` dimensions, no swizzle, zero fill out of bounds.
bool encode(CUtensorMap* m, CUtensorMapDataType dt, int rank, const void* ptr,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  EncodeTiled enc = encode_tiled();
  const cuuint32_t estr[5] = {1, 1, 1, 1, 1};
  return enc != nullptr &&
         enc(m, dt, rank, const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// [B, L, H, dh] contiguous (es bytes an element): boxes of U units x KP
// positions x nbt batch rows
bool map_units(CUtensorMap* m, CUtensorMapDataType dt, int es, const void* ptr,
               const Params& p) {
  const cuuint64_t dims[4] = {(cuuint64_t)p.dh, (cuuint64_t)p.L,
                              (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t st[3] = {(cuuint64_t)p.H * p.dh * es,
                            (cuuint64_t)p.dh * es,
                            (cuuint64_t)p.L * p.H * p.dh * es};
  const cuuint32_t box[4] = {(cuuint32_t)kUnits, (cuuint32_t)p.KP, 1,
                             (cuuint32_t)p.nbt};
  return encode(m, dt, 4, ptr, dims, st, box);
}

// [B, L, H, 4 dh] with element strides gxs (batch, position, head), the
// gates a dimension of their own: boxes of U units x 4 gates x KP positions
// x nbt batch rows
bool map_gates(CUtensorMap* m, CUtensorMapDataType dt, int es, const void* ptr,
               const Params& p, const long long* gxs) {
  const cuuint64_t dims[5] = {(cuuint64_t)p.dh, 4, (cuuint64_t)p.L,
                              (cuuint64_t)p.H, (cuuint64_t)p.B};
  const cuuint64_t st[4] = {(cuuint64_t)p.dh * es, (cuuint64_t)gxs[1] * es,
                            (cuuint64_t)gxs[2] * es, (cuuint64_t)gxs[0] * es};
  const cuuint32_t box[5] = {(cuuint32_t)kUnits, 4, (cuuint32_t)p.KP, 1,
                             (cuuint32_t)p.nbt};
  return encode(m, dt, 5, ptr, dims, st, box);
}

// Shapes, the cluster and the stage length (the longest that fits, up to
// 16 and to L rounded up to a power of two); 0 or an error code.
int plan(Params& p, bool bwd, int dtype, int B, int L, int H, int dh,
         bool save, bool dys) {
  const int es = dtype == 1 ? 2 : 4;
  if (dh < 1 || dh > kMaxDh || dh % (dtype == 1 ? 16 : 4) || B < 1 ||
      H < 1 || L < 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.B = B;
  p.L = L;
  p.H = H;
  p.dh = dh;
  p.nc = (dh + kUnits - 1) / kUnits;
  p.nbt = min(B, kRows);
  p.save = save;
  p.has_dys = dys;
  int kp = 1;
  while (kp < kMaxStage && kp < L) kp *= 2;
  for (; kp >= 1; kp /= 2)
    if (layout(p.lay, bwd, es, dh, p.nc, p.nbt, kp, save, dys)) break;
  if (kp < 1) return (int)cudaErrorInvalidValue;
  p.KP = kp;
  return 0;
}

// Each kernel's shared-memory limit raised to kMaxSmem once a device (a
// decode step launches the forward 12 times).
template <typename T>
int launch(const Params& p, bool bwd, cudaStream_t stream) {
  void (*kern)(const Params) = bwd ? slstm_bwd<T> : slstm_fwd<T>;
  static bool raised[2][64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !raised[bwd][dev]) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) raised[bwd][dev] = true;
  }
  const int tiles = (p.B + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.nc * p.H * tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.lay.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.nc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

CUtensorMapDataType tma_type(int dtype) {
  return dtype == 1 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

}  // namespace

extern "C" int slstm_max_dh() { return kMaxDh; }

// dtype: 0 float32, 1 bfloat16 (gx, r, h0, ys, h1, g; c, n, m float32).
// gx has its own batch, sequence and head strides (elements, last
// dimension contiguous; each stride and the base 16-byte aligned, as TMA
// reads it); everything else is contiguous.  g, cs, ns, ms: the backward's
// saved values ([B, L, H, 4 dh] gate inputs in gx's type, [B, L, H, dh]
// float32 carries after each position), or all null.  Launches on
// `stream` and returns cudaGetLastError() (0 on success;
// cudaErrorInvalidValue for inputs the kernel does not take, 10000 when a
// tensor map cannot be made).
extern "C" int slstm_fwd_launch(
    const void* gx, const void* r, const float* c0, const float* n0,
    const void* h0, const float* m0, void* ys, float* c1, float* n1,
    void* h1, float* m1, void* gsave, float* cs, float* ns, float* ms,
    int dtype, int B, int L, int H, int dh, const long long* gxs,
    void* stream) {
  Params p = {};
  const bool save = gsave != nullptr;
  int err = plan(p, false, dtype, B, L, H, dh, save, false);
  if (err) return err;
  const int es = dtype == 1 ? 2 : 4;
  const CUtensorMapDataType dt = tma_type(dtype);
  if (L > 0) {
    const long long gst[3] = {(long long)L * H * 4 * dh, (long long)H * 4 * dh,
                              4LL * dh};
    if (!map_gates(&p.gin, dt, es, gx, p, gxs) ||
        !map_units(&p.mh, dt, es, ys, p) ||
        (save && (!map_gates(&p.gout, dt, es, gsave, p, gst) ||
                  !map_units(&p.mc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, cs,
                             p) ||
                  !map_units(&p.mn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ns,
                             p) ||
                  !map_units(&p.mm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, ms,
                             p))))
      return kErrNoTensorMap;
  }
  p.r = r;
  p.c0 = c0;
  p.n0 = n0;
  p.h0 = h0;
  p.m0 = m0;
  p.c1 = c1;
  p.n1 = n1;
  p.h1 = h1;
  p.m1 = m1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, false, s)
                    : launch<float>(p, false, s);
}

// The backward: g, cs, ns, ms as the forward saved them, the carry in (c0,
// n0, m0), the gradients of ys and of the carry out (each may be null:
// zero); writes dgx (gx's type, contiguous [B, L, H, 4 dh]) and the carry
// in's gradients.  Every tensor contiguous, its base 16-byte aligned.
// dtype and the return as slstm_fwd_launch's.
extern "C" int slstm_bwd_launch(
    const void* gsave, const void* r, const float* c0, const float* n0,
    const float* m0, const float* cs, const float* ns, const float* ms,
    const void* dys, const float* dc1, const float* dn1, const void* dh1,
    const float* dm1, void* dgx, float* dc0, float* dn0, void* dh0,
    float* dm0, int dtype, int B, int L, int H, int dh, void* stream) {
  Params p = {};
  int err = plan(p, true, dtype, B, L, H, dh, false, dys != nullptr);
  if (err) return err;
  const int es = dtype == 1 ? 2 : 4;
  const CUtensorMapDataType dt = tma_type(dtype),
                            f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  if (L > 0) {
    const long long gst[3] = {(long long)L * H * 4 * dh, (long long)H * 4 * dh,
                              4LL * dh};
    if (!map_gates(&p.gin, dt, es, gsave, p, gst) ||
        !map_gates(&p.gout, dt, es, dgx, p, gst) ||
        !map_units(&p.mc, f32, 4, cs, p) || !map_units(&p.mn, f32, 4, ns, p) ||
        !map_units(&p.mm, f32, 4, ms, p) ||
        (dys && !map_units(&p.mh, dt, es, dys, p)))
      return kErrNoTensorMap;
  }
  p.r = r;
  p.c0 = c0;
  p.n0 = n0;
  p.m0 = m0;
  p.dc1 = dc1;
  p.dn1 = dn1;
  p.dh1 = dh1;
  p.dm1 = dm1;
  p.dc0 = dc0;
  p.dn0 = dn0;
  p.dh0 = dh0;
  p.dm0 = dm0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch<__nv_bfloat16>(p, true, s)
                    : launch<float>(p, true, s);
}
