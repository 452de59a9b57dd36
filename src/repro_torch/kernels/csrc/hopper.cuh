// hopper.cuh: the Hopper (sm_90a) pieces the port's tensor-core kernels
// share: shared-memory mbarriers, TMA loads (tiled and bulk), wgmma
// descriptors and instructions, bf16 splitting, and the host-side tensor
// maps (cuTensorMapEncodeTiled, fetched through cudaGetDriverEntryPoint so
// no library links libcuda), and the SSD backward kernels' prefix sums,
// release flags and transposed ldmatrix.  Included by flash_attention.cu,
// flash_attention_bwd.cu, ssd_scan_bwd.cu, ssd_wide_bwd.cu and slstm.cu;
// everything is in an anonymous namespace, one copy per library.
//
// Tiles are 128B-swizzled boxes of 64 bf16 columns (128 B rows, 1024 B
// swizzle atoms, so a tile's base is 1024 B aligned); a head dim over 64 is
// several boxes side by side, zero filled by TMA past the tensor's width.
// Operands of wgmma:
//  * K-major (the reduced dimension contiguous, as q k^T reads both): a
//    k-step of 16 is 32 B along a row, the next box after four steps;
//    desc128(addr + off, 16, 1024).
//  * MN-major (the reduced dimension along the rows, as P V reads V): a
//    k-step is 16 rows (16 * 128 B); the boxes are the descriptor's leading
//    byte offset apart, desc128(addr + 2048 kk, box_bytes, 1024).
// Accumulator fragment of a thread (lane l of warp w in the warpgroup,
// g = l / 4, t = l % 4): d[4j + e] is row 16w + g + 8 (e / 2), column
// 8j + 2t + e % 2.  The register A fragment of k-step kk is the four bf16
// pairs f[4kk .. 4kk + 3] with f[2j] = (row g, columns 8j + 2t, + 1) and
// f[2j + 1] the same of row g + 8: an accumulator turns into an A operand
// in place (pack_a).
#pragma once
#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kBox = 64;                 // columns per TMA box (128 B)
constexpr int kErrNoTensorMap = 10000;   // returned when TMA maps fail
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
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

// `bytes` (a multiple of 16) contiguous bytes from global memory (16 B
// aligned) into shared memory; completes its bytes on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// A barrier among `count` threads (whole warps) under the id `id` (1..15;
// 0 is __syncthreads).
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// Inclusive prefix sums of x[0], x[stride], ... (n <= 256 values) into
// out, by `count` threads under the named barrier `bar`: sequential within
// blocks of 16, each block offset by the prefix of the earlier blocks'
// totals (the plain versions' `blocked_cumsum` association; tot and carry
// hold n / 16 values).  Ends with a barrier.
constexpr int kCumBlock = 16;
__device__ void chunk_cumsum(const float* x, long long stride, int n,
                             float* out, float* tot, float* carry, int tid,
                             int count, int bar) {
  const int nb = (n + kCumBlock - 1) / kCumBlock;
  for (int i = tid; i < n; i += count) out[i] = x[i * stride];
  named_sync(bar, count);
  for (int blk = tid; blk < nb; blk += count) {
    float s = 0.f;
    for (int i = blk * kCumBlock; i < min(n, (blk + 1) * kCumBlock); ++i) {
      s += out[i];
      out[i] = s;
    }
    tot[blk] = s;
  }
  named_sync(bar, count);
  if (tid == 0 && nb > 1) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) carry[b] = s += tot[b];
  }
  named_sync(bar, count);
  for (int i = kCumBlock + tid; i < n; i += count)
    out[i] += carry[i / kCumBlock - 1];
  named_sync(bar, count);
}

// A flag in global memory that hands a state from one CTA to another.
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

// Four transposed 8x8 b16 matrices from shared memory (lane l: the row
// address of matrix l / 8, row l % 8).
__device__ __forceinline__ void ldsm4_t(uint32_t* r, uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// wgmma shared-memory descriptor, 128B swizzle: start address, leading
// and stride byte offsets.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo,
                                           uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Byte offset of element (row, col) of a bf16 tile of 64-column boxes,
// 128B swizzled, box_bytes apart (the 16 B chunks of a row XOR row % 8).
__device__ __forceinline__ uint32_t swz(int row, int col, int box_bytes) {
  const int box = col / kBox, c = col % kBox;
  return box * box_bytes + row * 128 + (((c / 8) ^ (row % 8)) * 16) +
         (c % 8) * 2;
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

__device__ __forceinline__ uint32_t pack2(float x0, float x1) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<uint32_t*>(&h);
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

// An accumulator of R registers (R / 4 groups of 8 columns) as the R / 2
// registers of its A fragments, each value rounded to bf16 once.
template <int R>
__device__ __forceinline__ void pack_a(const float* d, uint32_t* f) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    f[2 * j] = pack2(d[4 * j], d[4 * j + 1]);
    f[2 * j + 1] = pack2(d[4 * j + 2], d[4 * j + 3]);
  }
}

// The same in two bf16 terms (hi, lo).
template <int R>
__device__ __forceinline__ void split_a(const float* d, uint32_t* hi,
                                        uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    split2(d[4 * j], d[4 * j + 1], hi[2 * j], lo[2 * j]);
    split2(d[4 * j + 2], d[4 * j + 3], hi[2 * j + 1], lo[2 * j + 1]);
  }
}

__device__ __forceinline__ float ex2(float x) {     // 2^x, MUFU.EX2
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma m64nNk16, bf16 in, float32 sums.  rs: A from registers (four bf16
// pairs a thread), B from shared memory MN-major; ss<TB>: A and B from
// shared memory, A K-major, B K-major (TB = 0) or MN-major (TB = 1);
// scale_d = 0 overwrites D.
template <int N>
struct Wgmma;

#define WG_D8(o)                                                             \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]),            \
      "+f"(d[o + 4]), "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

template <>
struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        : WG_D8(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
                                            uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7"
        ", %8, %9, %10, %11, %12, %13, %14, %15"
        ", %16, %17, %18, %19, %20, %21, %22, %23"
        ", %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
};

template <>
struct Wgmma<80> {
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
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
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

template <>
struct Wgmma<128> {
  template <int TB>
  static __device__ __forceinline__ void ss(float* d, uint64_t da,
                                            uint64_t db, int scale_d) {
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
        "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
          WG_D8(48), WG_D8(56)
        : "l"(da), "l"(db), "r"(scale_d), "n"(TB));
  }
  static __device__ __forceinline__ void rs(float* d, const uint32_t* a,
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
        : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40),
          WG_D8(48), WG_D8(56)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
};

#undef WG_D8

// ----------------------------- host side ----------------------------------

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

// A 4-d map (column, row, head, batch) of a bf16 view with `cols` columns,
// `rows` rows, `heads` heads and `batch` batch rows, element strides st
// (batch, head, row): boxes of 64 columns x box_rows rows, 128B swizzle,
// zero fill out of bounds.  With `collapse`, a head or batch dimension of
// stride 0 (broadcast) is mapped with extent 1, and the kernel reads it at
// coordinate 0.
bool tensor_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int cols,
                int rows, int heads, int batch, const long long* st,
                int box_rows, bool collapse = false) {
  const long long row_bytes = st[2] * 2;
  const bool one_h = collapse && st[1] == 0, one_b = collapse && st[0] == 0;
  const cuuint64_t dims[4] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)(one_h ? 1 : heads),
                              (cuuint64_t)(one_b ? 1 : batch)};
  // an extent-1 dimension's stride is never stepped; any valid one will do
  const cuuint64_t strides[3] = {
      (cuuint64_t)row_bytes,
      (cuuint64_t)(one_h ? row_bytes * rows : st[1] * 2),
      (cuuint64_t)(one_b ? row_bytes * rows : st[0] * 2)};
  const cuuint32_t box[4] = {(cuuint32_t)kBox, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace
