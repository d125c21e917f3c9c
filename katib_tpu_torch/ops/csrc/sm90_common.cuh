// Hopper (sm_90a) building blocks of the wgmma/TMA flash-attention kernels
// (flash_fwd_sm90.cu, flash_bwd_dkv_sm90.cu), as hand-written PTX:
//
// - TMA: a [B, T, H, D] operand is described on the host as a 4-D tensor map
//   (dims {D, H, T, B}, byte strides {sh, st, sb}, box {min(D, 64), 1, rows,
//   1}) and one thread copies a whole tile into shared memory with
//   cp.async.bulk.tensor; rows past T arrive as zeros. A D-128 tile comes as
//   two boxes of 64 columns ("regions"), each rows x 128 bytes.
// - mbarriers: the thread that issues a load arms the stage's barrier with
//   the bytes it expects and TMA completes it; consumers wait on its phase
//   parity. A stage is released through a counter: the last warp to leave
//   it issues its next load.
// - wgmma: a warpgroup (4 warps, 64 rows) multiplies with operands read
//   through shared-memory descriptors in the same swizzle TMA wrote (128-byte
//   rows for D >= 64, 64-byte rows for D 32), or with A from registers.
//   The accumulator of m64nNk16 holds, for thread t (warp w = t / 32 of the
//   warpgroup, lane l), rows 16w + l/4 and 16w + l/4 + 8, columns
//   8j + 2(l % 4) + {0, 1} of every 8-column chunk j: element 4j + e is row
//   (e >= 2 ? +8 : +0), column 8j + 2(l % 4) + (e & 1) -- the mma.sync
//   m16n8k16 C layout, chunk by chunk. Two chunks of it, rounded to bf16,
//   are the register A operand of the next product.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: the encoder comes from the runtime

#include "flash_common.cuh"

namespace katib_flash {
namespace sm90 {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// Tile geometry in shared memory
// ---------------------------------------------------------------------------

// A [rows x D] bf16 tile as TMA writes it: regions of 64 columns (D 32: one
// region of 32), each `rows` rows of kRowBytes, swizzled in units of 16 bytes
// within every 8-row atom.
template <int D>
struct TileGeom {
  static constexpr int kRowBytes = D >= 64 ? 128 : 2 * D;  // bytes of one row of a region
  static constexpr int kRegionCols = kRowBytes / 2;
  static constexpr int kRegions = D / kRegionCols;
  static constexpr int kAtomBytes = 8 * kRowBytes;             // 8 rows: the swizzle period
  static constexpr int kStepsPerRegion = kRowBytes / 32;       // k16 steps along D in one region
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // wgmma: 1 = 128B swizzle, 2 = 64B
  static constexpr CUtensorMapSwizzle kSwizzle =
      kRowBytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  static_assert(D % kRegionCols == 0 && (kRowBytes == 128 || kRowBytes == 64), "head dim");
  template <int Rows>
  __host__ __device__ static constexpr int bytes() { return Rows * D * 2; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (all in 16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// K-major operand (rows x D, D contiguous): the k16 step `kk` along D.
// Within a region a step is 32 bytes further; the swizzle is applied by the
// hardware on the address bits, so the region must be 1024-byte aligned.
template <int D>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t tile, int rows, int kk) {
  using G = TileGeom<D>;
  const uint32_t addr = tile + (kk / G::kStepsPerRegion) * rows * G::kRowBytes +
                        (kk % G::kStepsPerRegion) * 32;
  return make_desc(addr, 16, G::kAtomBytes, G::kLayout);
}

// MN-major operand (K = tile rows, N = D, D contiguous): the k16 step `kk`
// along the rows, i.e. 16 rows further. LBO steps from one 64-column region
// to the next along N; SBO from one 8-row group to the next along K.
template <int D>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int rows, int kk) {
  using G = TileGeom<D>;
  return make_desc(tile + kk * 16 * G::kRowBytes, rows * G::kRowBytes, G::kAtomBytes, G::kLayout);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// Spin until the phase of `bar` with this parity has completed. A phase
// that never completes (a load that was never issued, a miscounted arrival
// or byte count) traps after 2 s on the global timer, so the launch fails
// with an error instead of hanging the card; no real wait comes near it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  uint64_t start = 0;
  for (uint32_t polls = 1; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (!done && (polls & 1023u) == 0) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(now));
      if (start == 0) start = now;
      else if (now - start > 2000000000ull) __trap();
    }
  }
}

// Called by one lane of each of `warps` warps once its products that read a
// stage are complete: true for exactly one caller per round, the last to
// leave, which then refills the stage. The count only grows (round k ends at
// warps * (k + 1)), so it needs no reset.
__device__ __forceinline__ bool last_to_leave(uint32_t* count, uint32_t warps) {
  uint32_t before;
  asm volatile("atom.acq_rel.cta.shared::cta.add.u32 %0, [%1], 1;\n"
               : "=r"(before)
               : "r"(smem_u32(count))
               : "memory");
  if (before % warps != warps - 1) return false;
  // the stage's last reads were the tensor cores'; order them before TMA's writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  return true;
}

// One box of a 4-D tensor map into shared memory; completion is counted in
// bytes on `bar`. Coordinates are {d, h, t, b}.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// 4 bytes from global to shared memory without the registers (zeros where
// !valid); cp_async_arrive counts this thread's copies, once they land, as
// one arrival on `bar` (the barrier's count must include it).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// A [Rows x D] tile of (b, h) from row t0: one box per 64-column region.
template <int D, int Rows>
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map, uint64_t* bar,
                                              int b, int h, int t0) {
  using G = TileGeom<D>;
#pragma unroll
  for (int r = 0; r < G::kRegions; ++r)
    tma_load_4d(dst + r * Rows * G::kRowBytes, map, bar, r * G::kRegionCols, h, t0, b);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous products.
// 2^x on the special-function unit (flushes results below 2^-126 to 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A register A operand is read asynchronously too: fencing it after the
// wait keeps its registers from being reused while the product runs.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

// The register A operand of k16 step `kk` from a [64 x N] accumulator:
// columns 16kk..16kk+15, rounded to bf16.
template <int R>
__device__ __forceinline__ void a_frag(const float (&s)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
  a[1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
  a[2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
  a[3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
}

// Store a warpgroup's [64 x D] accumulator as bf16, row r of this thread
// scaled by inv[r], to rows row0 and row0 + 8 of (b, h) that lie below seqlen.
template <int D>
__device__ __forceinline__ void store_acc(const View& out, int b, int h, int row0, int seqlen,
                                          const float (&acc)[D / 2], const float (&inv)[2], int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    if (t >= seqlen) continue;
    __nv_bfloat16* dst = const_cast<__nv_bfloat16*>(row_ptr<__nv_bfloat16>(out, b, t, h));
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
  }
}

// wgmma m64nNk16, bf16 inputs, f32 accumulator: ss for N 64 and 128 (the
// score products), rs for N 32, 64 and 128 (the products with a head dim).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A in registers (the m16n8k16
  // A fragment of each warp's 16 rows), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B both K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers (the m16n8k16
  // A fragment of each warp's 16 rows), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B both K-major in shared memory.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(accumulate));
  }
  // D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers (the m16n8k16
  // A fragment of each warp's 16 rows), B MN-major in shared memory.
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  }
};

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so that
// the library needs no -lcuda. Null if the driver does not have it.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found{};
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return (err == cudaSuccess && found == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

constexpr int kNoEncoder = -2;  // returned when the driver has no cuTensorMapEncodeTiled

// The map of one bf16 [B, T, H, D] operand (strides in elements, D
// contiguous, every stride a multiple of 8 and the base 16-byte aligned),
// with boxes of `rows` rows of one head. Returns 0 or a CUresult.
template <int D>
int encode_operand(CUtensorMap* map, const void* ptr, int batch, int seqlen, int heads,
                   long long sb, long long st, long long sh, int rows) {
  using G = TileGeom<D>;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEncoder;
  const cuuint64_t dims[4] = {cuuint64_t(D), cuuint64_t(heads), cuuint64_t(seqlen), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(st) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {cuuint32_t(G::kRegionCols), 1, cuuint32_t(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  return int(encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
                    elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, G::kSwizzle,
                    CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

}  // namespace sm90
}  // namespace katib_flash
