// K2 on Hopper, bf16: flash-attention dQ with wgmma and a TMA ring.
//
// Replaces katib_tpu/ops/flash_attention.py::_bwd_dq_kernel (pallas_call at
// flash_attention.py:285) for bf16 at head dim 32, 64 and 128; f32 stays on
// flash_bwd.cu. It computes what flash_bwd.cu's dQ kernel computes,
// recomputing P from the lse it is given (the ring backward feeds a global
// lse) with delta = rowsum(O * dO) from the caller:
//   P = exp(S * scale - lse), dP = dO V^T, dS = P * (dP - delta) * scale,
//   dQ += dS K,
// causal: kv tiles wholly after the CTA's q rows skipped, -1e30 above the
// diagonal, -inf past T (both weigh exactly nothing). dS is rounded to bf16
// before its product, as the TPU kernel casts it. Every dQ tile has one
// owner CTA: no atomics, sums are deterministic.
//
// Bound on this card: three products per (q, kv) pair, 51.6 GFLOP at the
// LM's shape (B 4, T 2048, H 16, D 64, causal) against ~85 MB read and
// written (Q, K, V, dO, dQ of 16.8 MB each, lse and delta), ~600
// FLOP/byte: bound by tensor-core operations (0.052 ms at 989 TFLOP/s).
//
// Design: flash_bwd_dkv_sm90.cu's, with the roles of the two axes swapped.
// - A CTA owns 128 q rows: two warpgroups of 64 rows each (256 threads, no
//   producer warp: one would cap every thread at 168 registers, see
//   flash_fwd_sm90.cu). Q and dO come once by TMA; each thread reads the
//   lse (scaled to base 2) and delta of its two rows into registers once.
// - kv tiles are 64 rows at every head dim. At D <= 64 a thread then fits
//   in 128 registers (dQ <= 32, S 32, dP 32, the bf16 dS fragment 16) and
//   two CTAs share an SM, so one's exponentials and dS arithmetic hide
//   behind the other's products. At D 128, dQ alone takes 64 registers:
//   one CTA per SM.
// - K and V stream through a 3-stage TMA ring (128-byte swizzle; 64-byte at
//   D 32); rows past T arrive as zeros. "Full" mbarriers count TMA's bytes,
//   and the last of the 8 warps to leave a stage (a shared counter) loads
//   its next tile, so no warp waits for another.
// - S = Q K^T and dP = dO V^T: wgmma m64n64k16, both operands K-major from
//   shared memory, committed as two groups so that P (ex2 of one FFMA with
//   scale * log2 e folded in; masked entries zeroed after it, so any scale,
//   zero and negative too, stays right) is computed while dP is still in
//   the tensor cores.
// - dQ += dS K: wgmma m64n{D}k16 with A from registers (the accumulator
//   layout is the register-A fragment: dS goes straight into it) and B = K
//   as an MN-major operand read from the same TMA tile that fed S.
// - The next tile's S and dP are issued as soon as this tile's dQ product
//   is done, not while it runs: with dS's fragment still held by that
//   product, S, dP and dQ in flight together need more than the 128
//   registers of two CTAs per SM, and ptxas then serialised every wgmma of
//   the kernel (C7512), which cost more than the wait does; the other three
//   warpgroups on the SM keep the tensor cores busy meanwhile. A stage is
//   released once the dQ product that read it is done. The loop is uniform
//   (the last tile is peeled, and a warpgroup whose rows all precede a kv
//   tile computes it anyway, as zeros): ptxas serialises wgmma issued under
//   a condition.
// - Only the diagonal tiles (causal) and the ragged last tile test the mask.
// - Every accumulator is defined before the first products: ptxas
//   serialises all wgmma of a kernel (warning C7515) if it has to
//   materialise one between two products of a pipeline stage.
// - Heaviest causal q tiles are scheduled first across all heads (the grid
//   is (B*H, q tiles), q tiles reversed).
// Not yet done (later work): ping-pong scheduling of the two warpgroups, a
// persistent grid, and one fused dQ/dK/dV pass.
#include "sm90_common.cuh"

namespace katib_flash {
namespace sm90 {

struct DqCfg {
  static constexpr int kBlockM = 128;  // q rows of a CTA: two warpgroups of 64
  static constexpr int kBlockN = 64;   // kv rows of a tile
  static constexpr int kStages = 3;    // K/V ring depth
  static constexpr int kThreads = 256;
  static constexpr int kSteps = kBlockN / 16;  // k16 steps of dQ += dS K
};

// CTAs per SM (see the note at the top).
template <int D>
constexpr int kDqCtasPerSm = D <= 64 ? 2 : 1;

struct DqParams {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;  // 4-D maps of the [B, T, H, D] operands
  View dq;
  const float* lse;    // [B*H, T] f32, from K1
  const float* delta;  // [B*H, T] f32
  int heads, seqlen, n_qt;
  float scale, scale_log2;  // softmax scale, and times log2(e)
  int causal;
};

// S = Q K^T and dP = dO V^T of one kv tile for this warpgroup's 64 rows,
// committed as two groups.
template <int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], float (&dp)[32], uint32_t q_wg, uint32_t do_wg,
                                             uint32_t kt, uint32_t vt) {
  using C = DqCfg;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<64>::ss(s, desc_kmajor<D>(q_wg, C::kBlockM, kk), desc_kmajor<D>(kt, C::kBlockN, kk), kk > 0);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<64>::ss(dp, desc_kmajor<D>(do_wg, C::kBlockM, kk), desc_kmajor<D>(vt, C::kBlockN, kk), kk > 0);
  wgmma_commit();
}

// dQ += dS K over one kv tile, issued and committed: dS from registers, K
// MN-major from the stage.
template <int D>
__device__ __forceinline__ void issue_dq(float (&dq)[D / 2], const uint32_t (&da)[DqCfg::kSteps][4], uint32_t kt) {
  using C = DqCfg;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < C::kSteps; ++kk) Wgmma<D>::rs(dq, da[kk], desc_mnmajor<D>(kt, C::kBlockN, kk), 1);
  wgmma_commit();
}

template <int D>
__global__ void __launch_bounds__(DqCfg::kThreads, kDqCtasPerSm<D>)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ DqParams p) {
  using C = DqCfg;
  using G = TileGeom<D>;
  constexpr int kQBytes = G::template bytes<C::kBlockM>();
  constexpr int kKvBytes = G::template bytes<C::kBlockN>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[C::kStages];
  __shared__ uint32_t left[C::kStages];  // warps done with each stage, ever
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t do_s = q_s + kQBytes;
  const uint32_t kv_s = do_s + kQBytes;  // stage s: K at kv_s + 2s * kKvBytes, V right after

  // Heaviest causal q tiles first, across every (b, h): blocks start in
  // order of blockIdx.x + gridDim.x * blockIdx.y.
  const int q0 = (p.n_qt - 1 - int(blockIdx.y)) * C::kBlockM;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int kv_end = p.causal ? min(p.seqlen, q0 + C::kBlockM) : p.seqlen;
  const int n_kv = (kv_end + C::kBlockN - 1) / C::kBlockN;
  const bool leader = threadIdx.x == 0;  // sets the barriers up and issues the first loads

  auto k_tile = [&](int j) { return kv_s + 2 * (j % C::kStages) * kKvBytes; };
  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % C::kStages;
    mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
    tma_load_tile<D, C::kBlockN>(k_tile(j), &p.tm_k, &full[s], b, h, j * C::kBlockN);
    tma_load_tile<D, C::kBlockN>(k_tile(j) + kKvBytes, &p.tm_v, &full[s], b, h, j * C::kBlockN);
  };
  if (leader) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      left[s] = 0;
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&q_full, 2 * kQBytes);
    tma_load_tile<D, C::kBlockM>(q_s, &p.tm_q, &q_full, b, h, q0);
    tma_load_tile<D, C::kBlockM>(do_s, &p.tm_do, &q_full, b, h, q0);
    for (int j = 0; j < C::kStages && j < n_kv; ++j) load_kv(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_s + wg * 64 * G::kRowBytes, do_wg = do_s + wg * 64 * G::kRowBytes;

  float lse2[2], delta[2];  // of this thread's rows: lse * log2(e), and delta (0 past T)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int t = row0 + 8 * r;
    const long long at = (long long)bh * p.seqlen + t;
    lse2[r] = t < p.seqlen ? p.lse[at] * kLog2e : 0.f;
    delta[r] = t < p.seqlen ? p.delta[at] : 0.f;
  }

  // Tile j's stage is free once all 8 warps are done with it: the last one
  // to leave loads tile j + kStages into it, so no warp ever waits for another.
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0 && last_to_leave(&left[j % C::kStages], C::kThreads / 32) && j + C::kStages < n_kv)
      load_kv(j + C::kStages);
  };

  float dq[D / 2];
  float s[32], dp[32];         // S then P, and dP: 64 rows x 64 kv columns
  uint32_t da[C::kSteps][4];   // dS in bf16: the A operand of dQ += dS K
  // Defined before the first products (see the note at the top).
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < C::kSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) da[kk][e] = 0u;

  // Tile j, its S and dP already issued: P while dP runs, then dS and
  // dQ += dS K; the next tile's scores go in once that product is done.
  auto tile = [&](int j, auto more) {  // more: std::true_type unless it is the last tile
    const int k0 = j * C::kBlockN;
    wgmma_wait<1>();  // this tile's S is in; dP may still run
    fence_regs(s);
    if (j > 0) release(j - 1);
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[(i >> 1) & 1]));  // P
    // Masked scores weigh nothing: the TPU kernel's exp(-1e30 - lse), exactly.
    if ((p.causal && k0 + C::kBlockN > wg_row0) || k0 + C::kBlockN > p.seqlen) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1), row = row0 + ((i >> 1) & 1) * 8;
        if (col >= p.seqlen || (p.causal && col > row)) s[i] = 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dp);
    fence_regs(dq);
    // dS goes straight into its bf16 A fragment (a_frag's layout: element
    // 8kk + 2e and the next one, of row half e & 1).
#pragma unroll
    for (int kk = 0; kk < C::kSteps; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * kk + 2 * e;
        da[kk][e] = pack_bf16(s[i] * (dp[i] - delta[e & 1]) * p.scale,
                              s[i + 1] * (dp[i + 1] - delta[e & 1]) * p.scale);
      }
    issue_dq<D>(dq, da, k_tile(j));
    if constexpr (decltype(more)::value) {
      wgmma_wait<0>();  // dS's registers are free again (see the note at the top)
      fence_regs(dq);
      fence_regs(da);
      const int s1 = (j + 1) % C::kStages;
      mbar_wait(&full[s1], ((j + 1) / C::kStages) & 1);
      issue_scores<D>(s, dp, q_wg, do_wg, k_tile(j + 1), k_tile(j + 1) + kKvBytes);
    }
  };

  mbar_wait(&q_full, 0);
  mbar_wait(&full[0], 0);
  issue_scores<D>(s, dp, q_wg, do_wg, kv_s, kv_s + kKvBytes);
  // The last tile is peeled so that no product is issued under a condition
  // the compiler cannot see through.
  for (int j = 0; j + 1 < n_kv; ++j) tile(j, std::true_type{});
  tile(n_kv - 1, std::false_type{});
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(da);

  const float one[2] = {1.f, 1.f};
  store_acc<D>(p.dq, b, h, row0, p.seqlen, dq, one, lane);
}

template <int D>
int launch_dq(int batch, int seqlen, int heads, const View& q, const View& k, const View& v, const View& dout,
              DqParams& p, cudaStream_t stream) {
  using C = DqCfg;
  int rc = encode_operand<D>(&p.tm_q, q.ptr, batch, seqlen, heads, q.sb, q.st, q.sh, C::kBlockM);
  if (rc == 0) rc = encode_operand<D>(&p.tm_do, dout.ptr, batch, seqlen, heads, dout.sb, dout.st, dout.sh, C::kBlockM);
  if (rc == 0) rc = encode_operand<D>(&p.tm_k, k.ptr, batch, seqlen, heads, k.sb, k.st, k.sh, C::kBlockN);
  if (rc == 0) rc = encode_operand<D>(&p.tm_v, v.ptr, batch, seqlen, heads, v.sb, v.st, v.sh, C::kBlockN);
  if (rc != 0) return rc;
  const int smem = 2 * TileGeom<D>::template bytes<C::kBlockM>() +
                   2 * C::kStages * TileGeom<D>::template bytes<C::kBlockN>() + 1024;
  auto kernel = flash_bwd_dq_sm90_kernel<D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  p.n_qt = (seqlen + C::kBlockM - 1) / C::kBlockM;
  const dim3 grid(batch * heads, p.n_qt);
  kernel<<<grid, C::kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

}  // namespace sm90
}  // namespace katib_flash

using katib_flash::View;

// The bf16 route of K2: the arguments of katib_flash_bwd_dq (flash_bwd.cu).
// Takes dtype 1 (bfloat16) only. Returns cudaGetLastError() after the
// launch, a CUresult if a tensor map could not be encoded, -2 if the driver
// has no cuTensorMapEncodeTiled, or -1 for arguments the kernel does not take.
extern "C" int katib_flash_bwd_dq_sm90(int dtype, int head_dim, int batch, int seqlen, int heads,
                                       const void* q, long long q_sb, long long q_st, long long q_sh,
                                       const void* k, long long k_sb, long long k_st, long long k_sh,
                                       const void* v, long long v_sb, long long v_st, long long v_sh,
                                       const void* dout, long long do_sb, long long do_st, long long do_sh,
                                       const float* lse, const float* delta,
                                       void* dq, long long dq_sb, long long dq_st, long long dq_sh,
                                       float scale, int causal, void* stream) {
  namespace s9 = katib_flash::sm90;
  if (dtype != 1 || batch <= 0 || seqlen <= 0 || heads <= 0) return katib_flash::kBadArgument;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh}, vv{v, v_sb, v_st, v_sh};
  const View dov{dout, do_sb, do_st, do_sh};
  s9::DqParams p{};
  p.dq = View{dq, dq_sb, dq_st, dq_sh};
  p.lse = lse;
  p.delta = delta;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale = scale;
  p.scale_log2 = scale * s9::kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return s9::launch_dq<32>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    case 64: return s9::launch_dq<64>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    case 128: return s9::launch_dq<128>(batch, seqlen, heads, qv, kv, vv, dov, p, st);
    default: return katib_flash::kBadArgument;
  }
}
