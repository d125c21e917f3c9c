// K3 on Hopper, bf16: flash-attention dK/dV with wgmma and a TMA pipeline.
//
// Replaces katib_tpu/ops/flash_attention.py::_bwd_dkv_kernel (pallas_call at
// flash_attention.py:306) for bf16 at head dim 32, 64 and 128; f32 stays on
// flash_bwd.cu, and so does K2 (dQ). It computes what flash_bwd.cu's dK/dV
// kernel computes, recomputing P from the lse it is given (the ring backward
// feeds a global lse) with delta = rowsum(O * dO) from the caller:
//   P^T = exp(S^T * scale - lse), dS^T = P^T * (dP^T - delta) * scale,
//   dV += P^T dO, dK += dS^T Q,
// causal: q tiles wholly before the kv tile skipped, -1e30 above the
// diagonal. Every dK/dV tile has one owner CTA: no atomics, sums are
// deterministic.
//
// Bound on this card: four products per (q, kv) pair, 68.7 GFLOP at the
// LM's shape (B 4, T 2048, H 16, D 64, causal) against ~102 MB read and
// written (Q, K, V, dO, dK, dV of 16.8 MB each, lse and delta), ~670
// FLOP/byte: bound by tensor-core operations (0.069 ms at 989 TFLOP/s).
//
// Design:
// - A CTA owns 128 kv rows: two warpgroups of 64 rows each (256 threads,
//   one CTA per SM, 255 registers a thread; a producer warp would cap them
//   at 168, see flash_fwd_sm90.cu). K and V come once by TMA.
// - The loop runs over 64-row q tiles (causal: from the diagonal on). Q and
//   dO come through a 3-stage TMA ring (128-byte swizzle; 64-byte at D 32),
//   with the tile's lse and delta beside them by cp.async (a row of lse
//   starts at b*h*T floats, not on the 16 bytes a TMA box needs); "full"
//   mbarriers count TMA's bytes and the copies, and the last of the 8 warps
//   to leave a stage (a shared counter) loads its next tile.
// - S^T = K Q^T and dP^T = V dO^T: wgmma m64n64k16, operands K-major from
//   shared memory, committed as two groups so that P^T (ex2 of one FFMA,
//   scale * log2 e folded in) is computed while dP^T is still in the tensor
//   cores.
// - dV += P^T dO is issued as soon as P^T is rounded to bf16, and runs while
//   dS^T is computed; then dK += dS^T Q. Both take A from registers (the
//   accumulator layout is the register-A fragment) and B (dO, Q) as
//   MN-major operands from the same TMA tiles that fed the first products.
// - The next tile's S^T and dP^T are issued right behind this tile's dV and
//   dK, so the tensor cores never wait for the loop's bookkeeping; a stage
//   is released once the products that read it are known to be done. The
//   loop is uniform (the last tile is peeled, and a warpgroup whose kv rows
//   all lie after a causal q tile computes it anyway, as zeros): ptxas
//   serialises wgmma issued under a condition.
// - Only the diagonal tiles (causal) and the ragged last tile test the mask.
// - Every accumulator is defined before the first products: ptxas
//   serialises all wgmma of a kernel (warning C7515) if it has to
//   materialise one between two products of a pipeline stage.
// Not yet done (later work): a persistent grid, and one fused dQ/dK/dV pass.
#include "sm90_common.cuh"

namespace katib_flash {
namespace sm90 {

struct DkvCfg {
  static constexpr int kBlockN = 128;  // kv rows of a CTA: two warpgroups of 64
  static constexpr int kBlockM = 64;   // q rows of a tile
  static constexpr int kStages = 3;    // Q/dO/lse/delta ring depth
  static constexpr int kThreads = 256;
  static constexpr int kVecBytes = kBlockM * 4;  // one tile's lse or delta
  static_assert(2 * kVecBytes <= 1024, "lse and delta share a stage's last 1024 bytes");
};

struct DkvParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;  // 4-D maps of the [B, T, H, D] operands
  View dk, dv;
  const float* lse;    // [B*H, T] f32, from K1
  const float* delta;  // [B*H, T] f32
  int heads, seqlen, n_kt;
  float scale, scale_log2;  // softmax scale, and times log2(e)
  int causal;
};

// S^T = K Q^T and dP^T = V dO^T of one q tile for this warpgroup's 64 kv
// rows, committed as two groups.
template <int D>
__device__ __forceinline__ void issue_scores(float (&st)[32], float (&dpt)[32], uint32_t k_wg, uint32_t v_wg,
                                             uint32_t qt, uint32_t dot) {
  using C = DkvCfg;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<64>::ss(st, desc_kmajor<D>(k_wg, C::kBlockN, kk), desc_kmajor<D>(qt, C::kBlockM, kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<64>::ss(dpt, desc_kmajor<D>(v_wg, C::kBlockN, kk), desc_kmajor<D>(dot, C::kBlockM, kk), kk > 0);
  wgmma_commit();
}

// acc += A B over one q tile, issued and committed: A (P^T or dS^T) from
// registers, B (dO or Q) MN-major from the stage.
template <int D>
__device__ __forceinline__ void issue_grad(float (&acc)[D / 2], const uint32_t (&a)[DkvCfg::kBlockM / 16][4],
                                           uint32_t bt) {
  using C = DkvCfg;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kBlockM / 16; ++kk) Wgmma<D>::rs(acc, a[kk], desc_mnmajor<D>(bt, C::kBlockM, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DkvCfg::kThreads, 1) flash_bwd_dkv_sm90_kernel(const __grid_constant__ DkvParams p) {
  using C = DkvCfg;
  using G = TileGeom<D>;
  constexpr int kKvBytes = G::template bytes<C::kBlockN>();
  constexpr int kQBytes = G::template bytes<C::kBlockM>();
  constexpr int kStageBytes = 2 * kQBytes + 1024;  // Q, dO, lse, delta; 1024-byte aligned
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t kv_full, full[C::kStages];
  __shared__ uint32_t left[C::kStages];  // warps done with each stage, ever
  const uint32_t k_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t v_s = k_s + kKvBytes;
  const uint32_t ring = v_s + kKvBytes;  // stage s at ring + s * kStageBytes: Q, dO, lse, delta
  const float* ring_f = reinterpret_cast<const float*>(smem_raw + (ring - smem_u32(smem_raw)));

  // Low kv tiles see the most q tiles (causal): they start first, across
  // every (b, h), since blocks start in order of blockIdx.x + gridDim.x * blockIdx.y.
  const int k0 = blockIdx.y * C::kBlockN;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int q_begin = p.causal ? k0 : 0;
  const int n_q = (p.seqlen - q_begin + C::kBlockM - 1) / C::kBlockM;
  const bool leader = threadIdx.x == 0;  // sets the barriers up and loads K and V

  // q tile it into stage it % kStages, by one whole warp: Q and dO by TMA
  // from lane 0; lse and delta, whose rows need not start on the 16 bytes
  // TMA wants, by 4-byte cp.async from every lane (zeros past T).
  auto load_q = [&](int it, int lane) {
    const int s = it % C::kStages, q0 = q_begin + it * C::kBlockM;
    const uint32_t st = ring + s * kStageBytes;
    if (lane == 0) {
      mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
      tma_load_tile<D, C::kBlockM>(st, &p.tm_q, &full[s], b, h, q0);
      tma_load_tile<D, C::kBlockM>(st + kQBytes, &p.tm_do, &full[s], b, h, q0);
    }
    for (int i = lane; i < C::kBlockM; i += 32) {
      const int t = q0 + i;
      const long long at = (long long)bh * p.seqlen + (t < p.seqlen ? t : 0);
      cp_async_4(st + 2 * kQBytes + 4 * i, p.lse + at, t < p.seqlen);
      cp_async_4(st + 2 * kQBytes + C::kVecBytes + 4 * i, p.delta + at, t < p.seqlen);
    }
    cp_async_arrive(&full[s]);
  };
  if (leader) {
    mbar_init(&kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1 + 32);  // the TMA bytes' arrival, and the loading warp's cp.async
      left[s] = 0;
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&kv_full, 2 * kKvBytes);
    tma_load_tile<D, C::kBlockN>(k_s, &p.tm_k, &kv_full, b, h, k0);
    tma_load_tile<D, C::kBlockN>(v_s, &p.tm_v, &kv_full, b, h, k0);
  }
  __syncthreads();
  if (threadIdx.x < 32)
    for (int it = 0; it < C::kStages && it < n_q; ++it) load_q(it, threadIdx.x);

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row0 = k0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;  // this thread's kv rows: row0, row0 + 8
  const uint32_t k_wg = k_s + wg * 64 * G::kRowBytes, v_wg = v_s + wg * 64 * G::kRowBytes;

  // Tile it's stage is free once all 8 warps are done with it: the last
  // one to leave loads tile it + kStages into it, so no warp ever waits for
  // another.
  auto release = [&](int it) {
    __syncwarp();
    bool last = false;
    if (lane == 0) last = last_to_leave(&left[it % C::kStages], C::kThreads / 32);
    if (__shfl_sync(0xffffffffu, last, 0) && it + C::kStages < n_q) load_q(it + C::kStages, lane);
  };

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  float st[32], dpt[32];  // S^T then P^T, dP^T then dS^T: 64 kv rows x 64 q columns
  uint32_t pa[C::kBlockM / 16][4], da[C::kBlockM / 16][4];  // P^T, dS^T in bf16: A operands
  // Defined before the first products (see the note at the top).
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kBlockM / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) pa[kk][e] = da[kk][e] = 0u;

  // Tile it, its S^T and dP^T already issued: P^T while dP^T runs, then dV
  // and dK; the next tile's scores go in right behind them.
  auto tile = [&](int it, auto more) {  // more: std::true_type unless it is the last tile
    const int s = it % C::kStages, q0 = q_begin + it * C::kBlockM;
    const uint32_t qt = ring + s * kStageBytes, dot = qt + kQBytes;
    const float* lse = ring_f + s * (kStageBytes / 4) + 2 * kQBytes / 4;
    const float* delta = lse + C::kBlockM;
    wgmma_wait<1>();  // tile it - 1's dV and dK and this tile's S^T are in; dP^T may still run
    fence_regs(st);
    fence_regs(pa);
    fence_regs(da);
    if (it > 0) release(it - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qi = (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      st[i] = fast_exp2(fmaf(st[i], p.scale_log2, -lse[qi] * kLog2e));  // P^T
    }
    // Masked scores weigh nothing: the TPU kernel's exp(-1e30 - lse), exactly.
    if ((p.causal && q0 < wg_row0 + 64) || q0 + C::kBlockM > p.seqlen) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int q = q0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1), kv = row0 + ((i >> 1) & 1) * 8;
        if (q >= p.seqlen || (p.causal && kv > q)) st[i] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < C::kBlockM / 16; ++kk) a_frag(st, kk, pa[kk]);
    wgmma_wait<0>();
    fence_regs(dpt);
    fence_regs(dk);
    fence_regs(dv);
    issue_grad<D>(dv, pa, dot);
    // dS^T goes straight into its bf16 A fragment: dP^T's registers are the
    // accumulator of the next tile's product, and ptxas serialises wgmma if
    // other instructions write an accumulator while products are in flight.
#pragma unroll
    for (int kk = 0; kk < C::kBlockM / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e, qi = (i / 4) * 8 + (lane % 4) * 2;
        da[kk][e] = pack_bf16(st[i] * p.scale * (dpt[i] - delta[qi]),
                              st[i + 1] * p.scale * (dpt[i + 1] - delta[qi + 1]));
      }
    issue_grad<D>(dk, da, qt);
    if constexpr (decltype(more)::value) {
      const int s1 = (it + 1) % C::kStages;
      const uint32_t qt1 = ring + s1 * kStageBytes;
      mbar_wait(&full[s1], ((it + 1) / C::kStages) & 1);
      issue_scores<D>(st, dpt, k_wg, v_wg, qt1, qt1 + kQBytes);
    }
  };

  mbar_wait(&kv_full, 0);
  mbar_wait(&full[0], 0);
  issue_scores<D>(st, dpt, k_wg, v_wg, ring, ring + kQBytes);
  // The last tile is peeled so that no product is issued under a condition
  // the compiler cannot see through.
  for (int it = 0; it + 1 < n_q; ++it) tile(it, std::true_type{});
  tile(n_q - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(dk);
  fence_regs(dv);
  fence_regs(pa);
  fence_regs(da);

  const float one[2] = {1.f, 1.f};
  store_acc<D>(p.dk, b, h, row0, p.seqlen, dk, one, lane);
  store_acc<D>(p.dv, b, h, row0, p.seqlen, dv, one, lane);
}

template <int D>
int launch_dkv(int batch, int seqlen, int heads, const View& q, const View& k, const View& v, const View& dout,
               DkvParams& p, cudaStream_t stream) {
  using C = DkvCfg;
  int rc = encode_operand<D>(&p.tm_q, q.ptr, batch, seqlen, heads, q.sb, q.st, q.sh, C::kBlockM);
  if (rc == 0) rc = encode_operand<D>(&p.tm_do, dout.ptr, batch, seqlen, heads, dout.sb, dout.st, dout.sh, C::kBlockM);
  if (rc == 0) rc = encode_operand<D>(&p.tm_k, k.ptr, batch, seqlen, heads, k.sb, k.st, k.sh, C::kBlockN);
  if (rc == 0) rc = encode_operand<D>(&p.tm_v, v.ptr, batch, seqlen, heads, v.sb, v.st, v.sh, C::kBlockN);
  if (rc != 0) return rc;
  const int smem = 2 * TileGeom<D>::template bytes<C::kBlockN>() +
                   C::kStages * (2 * TileGeom<D>::template bytes<C::kBlockM>() + 1024) + 1024;
  auto kernel = flash_bwd_dkv_sm90_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  p.n_kt = (seqlen + C::kBlockN - 1) / C::kBlockN;
  const dim3 grid(batch * heads, p.n_kt);
  kernel<<<grid, C::kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace sm90
}  // namespace katib_flash

using katib_flash::View;

// The bf16 route of K3: the arguments of katib_flash_bwd_dkv (flash_bwd.cu).
// Takes dtype 1 (bfloat16) only. Returns cudaGetLastError() after the
// launch, a CUresult if a tensor map could not be encoded, -2 if the driver
// has no cuTensorMapEncodeTiled, or -1 for arguments the kernel does not take.
extern "C" int katib_flash_bwd_dkv_sm90(int dtype, int head_dim, int batch, int seqlen, int heads,
                                        const void* q, long long q_sb, long long q_st, long long q_sh,
                                        const void* k, long long k_sb, long long k_st, long long k_sh,
                                        const void* v, long long v_sb, long long v_st, long long v_sh,
                                        const void* dout, long long do_sb, long long do_st, long long do_sh,
                                        const float* lse, const float* delta,
                                        void* dk, long long dk_sb, long long dk_st, long long dk_sh,
                                        void* dv, long long dv_sb, long long dv_st, long long dv_sh,
                                        float scale, int causal, void* stream) {
  namespace s9 = katib_flash::sm90;
  if (dtype != 1 || batch <= 0 || seqlen <= 0 || heads <= 0) return katib_flash::kBadArgument;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh}, vv{v, v_sb, v_st, v_sh};
  const View dov{dout, do_sb, do_st, do_sh};
  s9::DkvParams p{};
  p.dk = View{dk, dk_sb, dk_st, dk_sh};
  p.dv = View{dv, dv_sb, dv_st, dv_sh};
  p.lse = lse;
  p.delta = delta;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale = scale;
  p.scale_log2 = scale * s9::kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return s9::launch_dkv<32>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    case 64: return s9::launch_dkv<64>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    case 128: return s9::launch_dkv<128>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    default: return katib_flash::kBadArgument;
  }
}
