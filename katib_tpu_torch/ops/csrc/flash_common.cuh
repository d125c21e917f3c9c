// Shared pieces of the Hopper flash-attention kernels (flash_fwd.cu,
// flash_bwd.cu): tile loads from [B, T, H, D] strides, and the two tile
// products every kernel is built from.
//
// Work split: a CTA of 4 warps owns a 64-row tile (of queries for the
// forward and dQ kernels, of keys/values for dK/dV); warp w owns rows
// 16w..16w+15 of it. Every [16 x 64] score tile a warp computes lives in
// registers in the accumulator layout of mma.sync m16n8k16: thread `lane`
// holds rows g = lane/4 and g+8, columns 8j + 2(lane%4) + {0,1} of n-tile j.
// bf16 tiles run on the tensor cores (f32 accumulation); f32 tiles run in
// plain f32 FMA with the same register layout, never TF32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace katib_flash {

constexpr int kTile = 64;     // rows of a q tile and of a kv tile
constexpr int kWarps = 4;     // 16 rows each
constexpr int kThreads = kWarps * 32;
constexpr float kNegInf = -1e30f;  // the causal mask value of the TPU kernels
constexpr int kScratchLd = kTile + 4;  // f32 P staging row (f32 path only)

// Shared-memory row stride: one 16-byte chunk of padding per row keeps the
// fragment reads of a warp on distinct banks.
template <typename Elem, int D>
struct Smem {
  static constexpr int kEpc = 16 / sizeof(Elem);  // elements per 16-byte chunk
  static constexpr int kLd = D + kEpc;
  static constexpr int kTileElems = kTile * kLd;
  static constexpr int kScratchBytes =
      std::is_same<Elem, float>::value ? kWarps * 16 * kScratchLd * 4 : 0;
};

struct View {  // one [B, T, H, D] operand; strides in elements, D contiguous
  const void* ptr;
  long long sb, st, sh;
};

template <typename Elem>
__device__ __forceinline__ const Elem* row_ptr(const View& v, int b, int t, int h) {
  return static_cast<const Elem*>(v.ptr) + b * v.sb + (long long)t * v.st + h * v.sh;
}

// Copy rows t0..t0+63 of (b, h) into shared memory; rows at or past `seqlen`
// are zero so that padded rows contribute nothing and never carry NaN.
template <typename Elem, int D>
__device__ __forceinline__ void load_tile(Elem* dst, const View& src, int b, int h,
                                          int t0, int seqlen) {
  using S = Smem<Elem, D>;
  constexpr int kChunks = D / S::kEpc;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = i % kChunks, t = t0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < seqlen) val = *reinterpret_cast<const uint4*>(row_ptr<Elem>(src, b, t, h) + c * S::kEpc);
    *reinterpret_cast<uint4*>(dst + r * S::kLd + c * S::kEpc) = val;
  }
}

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float c[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Row and column of accumulator element (j, e) for this lane.
__device__ __forceinline__ int frag_row(int lane, int e) { return (lane >> 2) + (e >= 2 ? 8 : 0); }
__device__ __forceinline__ int frag_col(int lane, int j, int e) { return j * 8 + (lane & 3) * 2 + (e & 1); }

// c[16 x 64] += A[16 x D] . B[64 x D]^T, both row-major in shared memory
// (A: the warp's 16 rows, B: a whole 64-row tile). Contraction over D.
template <typename Elem, int D>
__device__ __forceinline__ void mm_abt(const Elem* A, const Elem* B, float c[8][4], int lane) {
  constexpr int LD = Smem<Elem, D>::kLd;
  if constexpr (std::is_same<Elem, float>::value) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* a = A + frag_row(lane, e) * LD;
        const float* bb = B + frag_col(lane, j, e) * LD;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(a[d], bb[d], s);
        c[j][e] += s;
      }
  } else {
    const int g = lane >> 2, tg = lane & 3;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int col = kk * 16 + tg * 2;
      const uint32_t a0 = ld_pair(A + g * LD + col);
      const uint32_t a1 = ld_pair(A + (g + 8) * LD + col);
      const uint32_t a2 = ld_pair(A + g * LD + col + 8);
      const uint32_t a3 = ld_pair(A + (g + 8) * LD + col + 8);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const Elem* brow = B + (j * 8 + g) * LD + col;
        mma_bf16(c[j], a0, a1, a2, a3, ld_pair(brow), ld_pair(brow + 8));
      }
    }
  }
}

// acc[16 x D] += P[16 x 64] . B[64 x D], P in registers (accumulator
// layout), B row-major in shared memory. bf16: P is rounded to bf16 first,
// as the TPU kernels cast p to the value dtype before the product. f32: P
// goes through the warp's staging rows in shared memory.
template <typename Elem, int D>
__device__ __forceinline__ void mm_pb(const float p[8][4], const Elem* B, float acc[D / 8][4],
                                      int lane, float* scratch) {
  constexpr int LD = Smem<Elem, D>::kLd;
  if constexpr (std::is_same<Elem, float>::value) {
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) scratch[frag_row(lane, e) * kScratchLd + frag_col(lane, j, e)] = p[j][e];
    __syncwarp();
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* prow = scratch + frag_row(lane, e) * kScratchLd;
        const float* bcol = B + frag_col(lane, jd, e);
        float s = 0.f;
#pragma unroll 8
        for (int r = 0; r < kTile; ++r) s = fmaf(prow[r], bcol[r * LD], s);
        acc[jd][e] += s;
      }
  } else {
    const int g = lane >> 2, tg = lane & 3;
    const uint16_t* Bs = reinterpret_cast<const uint16_t*>(B);
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      const uint32_t a0 = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      const uint32_t a1 = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      const uint32_t a2 = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
      const int r = kk * 16 + tg * 2;
#pragma unroll
      for (int jd = 0; jd < D / 8; ++jd) {
        const int n = jd * 8 + g;
        const uint32_t b0 = uint32_t(Bs[r * LD + n]) | (uint32_t(Bs[(r + 1) * LD + n]) << 16);
        const uint32_t b1 = uint32_t(Bs[(r + 8) * LD + n]) | (uint32_t(Bs[(r + 9) * LD + n]) << 16);
        mma_bf16(acc[jd], a0, a1, a2, a3, b0, b1);
      }
    }
  }
}

// Store the warp's [16 x D] accumulator to rows row0 and row0 + 8 of (b, h).
template <typename Elem, int D>
__device__ __forceinline__ void store_rows(const View& out, int b, int h, int row0, int seqlen,
                                           const float acc[D / 8][4], const float inv[2],
                                           int lane) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int t = row0 + half * 8;
    if (t >= seqlen) continue;
    Elem* dst = const_cast<Elem*>(row_ptr<Elem>(out, b, t, h));
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      const int col = frag_col(lane, jd, 0);
      const float x0 = acc[jd][2 * half] * inv[half], x1 = acc[jd][2 * half + 1] * inv[half];
      if constexpr (std::is_same<Elem, float>::value) {
        *reinterpret_cast<float2*>(dst + col) = make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(dst + col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// Opt a kernel into more than 48 KB of dynamic shared memory when it needs it.
template <typename Kernel>
inline cudaError_t set_smem(Kernel kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

constexpr int kBadArgument = -1;  // returned for a dtype/head_dim the kernels do not take

}  // namespace katib_flash
