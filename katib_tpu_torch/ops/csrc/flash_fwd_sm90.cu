// K1 on Hopper, bf16: flash-attention forward with wgmma and a TMA pipeline.
//
// Replaces katib_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// pallas_call at flash_attention.py:142) for bf16 at head dim 32, 64 and 128;
// f32 stays on flash_fwd.cu. It computes what flash_fwd.cu computes:
// O = softmax(Q K^T * scale) V with the online-softmax recurrence, causal
// mask -1e30 with kv tiles above the diagonal skipped, O = acc / l (l == 0
// -> 1) in bf16, LSE = m + log(max(l, 1e-30)) in f32 (natural log).
//
// Bound on this card: at the LM's shape (B 4, T 2048, H 16, D 64, causal)
// the two products are 34.4 GFLOP against 67 MB read and written (Q, K, V,
// O of 16.8 MB each, and the lse), ~510 FLOP/byte, above the H100's ~295
// FLOP/byte ridge: bound by tensor-core operations (0.035 ms at 989 TFLOP/s
// against 0.020 ms for the bytes), so the design is about keeping the
// tensor cores fed.
//
// Design:
// - A CTA owns 128 query rows: two warpgroups of 64 rows each (256 threads).
//   There is no producer warp: ptxas counts a wgmma kernel's block in whole
//   warpgroups, so one would cap every thread at 168 registers.
// - kv tiles are 64 rows at D <= 64: a thread then fits in 128 registers
//   and two CTAs share an SM, so one's softmax and load latencies hide
//   behind the other's products (at D 64, 8192 exponentials per warpgroup
//   and tile of 128 take the special-function units as long as that tile's
//   products take the tensor cores). At D 128 the output alone takes 64
//   registers: tiles of 128 rows, one CTA per SM.
// - Q once and every K and V tile come through a 3-stage ring in shared
//   memory with TMA (cp.async.bulk.tensor, 128-byte swizzle; 64-byte at
//   D 32). Each stage has a "full" mbarrier armed with the bytes TMA
//   delivers; the last of the 8 warps to leave a stage (a shared counter)
//   issues its next load, so loads run two tiles ahead of the products and
//   no warp waits for another to release a stage.
// - S = Q K^T: wgmma m64n{64,128}k16, both operands K-major from shared
//   memory.
// - The online softmax runs in registers in the wgmma accumulator layout
//   (each row held by a quad: two shuffles per reduction), in base 2 with
//   scale * log2(e) in one multiply (any scale, zero and negative too).
//   Only the diagonal tile (causal) and the ragged last tile test the mask.
// - O += P V: P rounded to bf16 (the TPU kernel casts p to v's dtype) is the
//   register A operand of wgmma m64n{D}k16; V is an MN-major B operand read
//   straight from the TMA tile (the transpose bit of wgmma).
// - Inside a warpgroup, S of the next tile is issued ahead of this tile's
//   P V, and the next softmax runs while P V is in the tensor cores; only the
//   bf16 packing of P waits for it. The loop is uniform (the last tile is
//   peeled): ptxas serialises wgmma issued under a condition.
// - Heaviest causal q tiles are scheduled first across all heads (the grid
//   is (B*H, q tiles), q tiles reversed). Rows past T arrive as zeros
//   from TMA, columns past T get -inf, rows past T are not stored.
// Not yet done (later work): ping-pong scheduling of the two warpgroups, a
// persistent grid.
#include "sm90_common.cuh"

namespace katib_flash {
namespace sm90 {

struct FwdCfg {
  static constexpr int kBlockM = 128;  // q rows of a CTA: two warpgroups of 64
  static constexpr int kStages = 3;    // K/V ring depth
  static constexpr int kThreads = 256;
};

// kv rows of a tile, and CTAs per SM (see the note at the top).
template <int D>
struct FwdTile {
  static constexpr int kN = D <= 64 ? 64 : 128;
  static constexpr int kRegs = kN / 2;  // S (then P) accumulator registers a thread
  static constexpr int kSteps = kN / 16;  // k16 steps of P V
  static constexpr int kCtasPerSm = D <= 64 ? 2 : 1;
};

struct FwdParams {
  CUtensorMap tm_q, tm_k, tm_v;  // 4-D maps of the [B, T, H, D] operands
  View o;
  float* lse;  // [B*H, T] f32
  int heads, seqlen, n_qt;
  float scale_log2;  // softmax scale * log2(e)
  int causal;
};

// S = Q K^T of one kv tile for this warpgroup's 64 rows, issued and committed.
template <int D>
__device__ __forceinline__ void issue_scores(float (&sc)[FwdTile<D>::kRegs], uint32_t q_wg, uint32_t kt) {
  using T = FwdTile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Wgmma<T::kN>::ss(sc, desc_kmajor<D>(q_wg, FwdCfg::kBlockM, kk), desc_kmajor<D>(kt, T::kN, kk), kk > 0);
  wgmma_commit();
}

// O += P V of one kv tile, issued and committed: P from registers, V MN-major.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[FwdTile<D>::kSteps][4],
                                         uint32_t vt) {
  using T = FwdTile<D>;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < T::kSteps; ++kk) Wgmma<D>::rs(o, pa[kk], desc_mnmajor<D>(vt, T::kN, kk), 1);
  wgmma_commit();
}

// The online-softmax step of kv tile k0 on S in place: S becomes P (f32),
// m and l move on, alpha is the factor the running output must take.
template <int D>
__device__ __forceinline__ void softmax_step(float (&sc)[FwdTile<D>::kRegs], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const FwdParams& p, int k0, int wg_row0, int row0,
                                             int lane) {
  constexpr int kN = FwdTile<D>::kN, kRegs = FwdTile<D>::kRegs;
#pragma unroll
  for (int i = 0; i < kRegs; ++i) sc[i] *= p.scale_log2;
  if ((p.causal && k0 + kN > wg_row0) || k0 + kN > p.seqlen) {
#pragma unroll
    for (int i = 0; i < kRegs; ++i) {
      const int col = k0 + (i / 4) * 8 + (lane % 4) * 2 + (i & 1);
      const int row = row0 + ((i >> 1) & 1) * 8;
      if (col >= p.seqlen) sc[i] = -INFINITY;           // ragged last tile: no weight
      else if (p.causal && col > row) sc[i] = kNegInf;  // the TPU kernel's mask value
    }
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int i = 0; i < kRegs; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = fast_exp2(m[r] - mx[r]);
    m[r] = mx[r];
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < kRegs; ++i) {
    sc[i] = fast_exp2(sc[i] - m[(i >> 1) & 1]);
    l[(i >> 1) & 1] += sc[i];
  }
}

template <int D>
__device__ __forceinline__ void pack_p(const float (&sc)[FwdTile<D>::kRegs], uint32_t (&pa)[FwdTile<D>::kSteps][4]) {
#pragma unroll
  for (int kk = 0; kk < FwdTile<D>::kSteps; ++kk) a_frag(sc, kk, pa[kk]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

template <int D>
__global__ void __launch_bounds__(FwdCfg::kThreads, FwdTile<D>::kCtasPerSm)
    flash_fwd_sm90_kernel(const __grid_constant__ FwdParams p) {
  using C = FwdCfg;
  using T = FwdTile<D>;
  using G = TileGeom<D>;
  constexpr int kQBytes = G::template bytes<C::kBlockM>();
  constexpr int kKvBytes = G::template bytes<T::kN>();
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t q_full, full[C::kStages];
  __shared__ uint32_t left[C::kStages];  // warps done with each stage, ever
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms want 1024-byte alignment
  const uint32_t kv_s = q_s + kQBytes;  // stage s: K at kv_s + 2s * kKvBytes, V right after

  // Heaviest causal q tiles first, across every (b, h): blocks start in
  // order of blockIdx.x + gridDim.x * blockIdx.y.
  const int q0 = (p.n_qt - 1 - int(blockIdx.y)) * C::kBlockM;
  const int bh = blockIdx.x, b = bh / p.heads, h = bh % p.heads;
  const int kv_end = p.causal ? min(p.seqlen, q0 + C::kBlockM) : p.seqlen;
  const int n_kv = (kv_end + T::kN - 1) / T::kN;
  const bool leader = threadIdx.x == 0;  // issues the first loads

  auto load_kv = [&](int j) {  // tile j into stage j % kStages
    const int s = j % C::kStages;
    mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
    const uint32_t kt = kv_s + 2 * s * kKvBytes;
    tma_load_tile<D, T::kN>(kt, &p.tm_k, &full[s], b, h, j * T::kN);
    tma_load_tile<D, T::kN>(kt + kKvBytes, &p.tm_v, &full[s], b, h, j * T::kN);
  };
  if (leader) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&full[s], 1);
      left[s] = 0;
    }
    fence_barrier_init();
    mbar_arrive_expect_tx(&q_full, kQBytes);
    tma_load_tile<D, C::kBlockM>(q_s, &p.tm_q, &q_full, b, h, q0);
    for (int j = 0; j < C::kStages && j < n_kv; ++j) load_kv(j);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + lane / 4;  // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = q_s + wg * 64 * G::kRowBytes;

  // Tile j's stage is free once all 8 warps are done with it: the last one
  // to leave loads tile j + kStages into it, so no warp ever waits for another.
  auto release = [&](int j) {
    __syncwarp();
    if (lane == 0 && last_to_leave(&left[j % C::kStages], C::kThreads / 32) && j + C::kStages < n_kv)
      load_kv(j + C::kStages);
  };
  auto v_tile = [&](int j) { return kv_s + 2 * (j % C::kStages) * kKvBytes + kKvBytes; };

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running row max, base 2
  float l[2] = {0.f, 0.f};          // this thread's partial row sums
  float sc[T::kRegs], alpha[2];  // S, then P, of the tile in flight: 64 rows x kN kv columns
  uint32_t pa[T::kSteps][4];     // P rounded to bf16: the A operand of O += P V

  mbar_wait(&q_full, 0);
  mbar_wait(&full[0], 0);
  issue_scores<D>(sc, q_wg, kv_s);
  wgmma_wait<0>();
  fence_regs(sc);
  softmax_step<D>(sc, m, l, alpha, p, 0, wg_row0, row0, lane);
  pack_p<D>(sc, pa);

  // Tile j: S of tile j + 1 goes to the tensor cores ahead of O += P_j V_j,
  // and its softmax runs while P_j V_j is in flight. The last tile is peeled
  // so that no product is issued under a condition.
  for (int j = 0; j + 1 < n_kv; ++j) {
    const int s1 = (j + 1) % C::kStages;
    mbar_wait(&full[s1], ((j + 1) / C::kStages) & 1);
    issue_scores<D>(sc, q_wg, kv_s + 2 * s1 * kKvBytes);
    rescale<D>(o, alpha);
    issue_pv<D>(o, pa, v_tile(j));
    wgmma_wait<1>();  // S of tile j + 1 is in; P_j V_j may still run
    fence_regs(sc);
    softmax_step<D>(sc, m, l, alpha, p, (j + 1) * T::kN, wg_row0, row0, lane);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    release(j);
    pack_p<D>(sc, pa);
  }
  rescale<D>(o, alpha);
  issue_pv<D>(o, pa, v_tile(n_kv - 1));
  wgmma_wait<0>();
  fence_regs(o);
  fence_regs(pa);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / (l[r] == 0.f ? 1.f : l[r]);
  }
  store_acc<D>(p.o, b, h, row0, p.seqlen, o, inv, lane);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = row0 + 8 * r;
      if (t < p.seqlen) p.lse[(long long)bh * p.seqlen + t] = m[r] * kLn2 + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <int D>
int launch_fwd(int batch, int seqlen, int heads, const View& q, const View& k, const View& v, FwdParams& p,
               cudaStream_t stream) {
  using C = FwdCfg;
  int rc = encode_operand<D>(&p.tm_q, q.ptr, batch, seqlen, heads, q.sb, q.st, q.sh, C::kBlockM);
  if (rc == 0) rc = encode_operand<D>(&p.tm_k, k.ptr, batch, seqlen, heads, k.sb, k.st, k.sh, FwdTile<D>::kN);
  if (rc == 0) rc = encode_operand<D>(&p.tm_v, v.ptr, batch, seqlen, heads, v.sb, v.st, v.sh, FwdTile<D>::kN);
  if (rc != 0) return rc;
  const int smem = TileGeom<D>::template bytes<C::kBlockM>() +
                   2 * C::kStages * TileGeom<D>::template bytes<FwdTile<D>::kN>() + 1024;
  auto kernel = flash_fwd_sm90_kernel<D>;
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

// The bf16 route of K1: the arguments of katib_flash_fwd (flash_fwd.cu).
// Takes dtype 1 (bfloat16) only. Returns cudaGetLastError() after the
// launch, a CUresult if a tensor map could not be encoded, -2 if the driver
// has no cuTensorMapEncodeTiled, or -1 for arguments the kernel does not take.
extern "C" int katib_flash_fwd_sm90(int dtype, int head_dim, int batch, int seqlen, int heads,
                                    const void* q, long long q_sb, long long q_st, long long q_sh,
                                    const void* k, long long k_sb, long long k_st, long long k_sh,
                                    const void* v, long long v_sb, long long v_st, long long v_sh,
                                    void* o, long long o_sb, long long o_st, long long o_sh,
                                    float* lse, float scale, int causal, void* stream) {
  namespace s9 = katib_flash::sm90;
  if (dtype != 1 || batch <= 0 || seqlen <= 0 || heads <= 0) return katib_flash::kBadArgument;
  const View qv{q, q_sb, q_st, q_sh}, kv{k, k_sb, k_st, k_sh}, vv{v, v_sb, v_st, v_sh};
  s9::FwdParams p{};
  p.o = View{o, o_sb, o_st, o_sh};
  p.lse = lse;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale_log2 = scale * s9::kLog2e;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 32: return s9::launch_fwd<32>(batch, seqlen, heads, qv, kv, vv, p, st);
    case 64: return s9::launch_fwd<64>(batch, seqlen, heads, qv, kv, vv, p, st);
    case 128: return s9::launch_fwd<128>(batch, seqlen, heads, qv, kv, vv, p, st);
    default: return katib_flash::kBadArgument;
  }
}
