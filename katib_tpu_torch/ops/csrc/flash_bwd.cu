// K2 and K3: flash-attention backward on Hopper (sm_90a), recomputing P from
// the forward's log-sum-exp. delta = rowsum(O * dO) in f32 comes from the
// caller, as on the TPU (flash_attention.py:277-279).
//
// K2 replaces katib_tpu/ops/flash_attention.py::_bwd_dq_kernel (pallas_call
// at flash_attention.py:285): for each 64-row q tile, loop over kv tiles:
//   P = exp(Q K^T * scale - lse), dP = dO V^T, dS = P * (dP - delta) * scale,
//   dQ += dS K.
// K3 replaces ::_bwd_dkv_kernel (pallas_call at flash_attention.py:306): for
// each 64-row kv tile, loop over q tiles (causal: from the diagonal on):
//   dV += P^T dO, dK += dS^T Q.
// The two stay separate kernels with no atomics, as on the TPU: each output
// tile has one owner CTA, so sums are deterministic.
//
// Bound on this card: both do 4 tile products per (q tile, kv tile) pair
// against the forward's 2, at ~T/2 multiply-adds per byte read at the LM's
// shape: bound by tensor-core operations. Design: every score-shaped
// [16 x 64] tile (P, dP, dS and their transposes) lives in registers in the
// mma.sync accumulator layout and is fed straight back as the A operand of
// the next product; the CTA's own tile (Q and dO for K2, K and V for K3) is
// loaded once and stays in shared memory. Not yet done (later work): wgmma,
// TMA, pipelined loads, and one fused dQ/dK/dV pass.
#include "flash_common.cuh"

namespace katib_flash {

struct BwdParams {
  View q, k, v, dout;
  View dq, dk, dv;
  const float* lse;    // [B*H, T] f32, from K1
  const float* delta;  // [B*H, T] f32
  int heads, seqlen;
  float scale;
  int causal;
};

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq_kernel(BwdParams p) {
  using S = Smem<Elem, D>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* Qs = reinterpret_cast<Elem*>(smem);
  Elem* dOs = Qs + S::kTileElems;
  Elem* Ks = dOs + S::kTileElems;
  Elem* Vs = Ks + S::kTileElems;
  float* scratch = reinterpret_cast<float*>(Vs + S::kTileElems);

  const int n_qt = (p.seqlen + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);
  float* wscratch = scratch + warp * 16 * kScratchLd;

  load_tile<Elem, D>(Qs, p.q, b, h, q0, p.seqlen);
  load_tile<Elem, D>(dOs, p.dout, b, h, q0, p.seqlen);
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = row0 + 8 * i;
    const long long at = (long long)bh * p.seqlen + t;
    lse[i] = t < p.seqlen ? p.lse[at] : 0.f;
    delta[i] = t < p.seqlen ? p.delta[at] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) dq[jd][0] = dq[jd][1] = dq[jd][2] = dq[jd][3] = 0.f;

  const int kv_end = p.causal ? min(p.seqlen, q0 + kTile) : p.seqlen;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();
    load_tile<Elem, D>(Ks, p.k, b, h, k0, p.seqlen);
    load_tile<Elem, D>(Vs, p.v, b, h, k0, p.seqlen);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    mm_abt<Elem, D>(Qs + warp * 16 * LD, Ks, s, lane);
    mm_abt<Elem, D>(dOs + warp * 16 * LD, Vs, dp, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + frag_col(lane, j, e), row = row0 + (e >= 2 ? 8 : 0);
        float x = s[j][e] * p.scale;
        if (kv >= p.seqlen) x = -INFINITY;
        else if (p.causal && kv > row) x = kNegInf;
        const float prob = expf(x - lse[e >> 1]);
        s[j][e] = prob * (dp[j][e] - delta[e >> 1]) * p.scale;  // dS
      }
    mm_pb<Elem, D>(s, Ks, dq, lane, wscratch);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<Elem, D>(p.dq, b, h, row0, p.seqlen, dq, one, lane);
}

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkv_kernel(BwdParams p) {
  using S = Smem<Elem, D>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* Ks = reinterpret_cast<Elem*>(smem);
  Elem* Vs = Ks + S::kTileElems;
  Elem* Qs = Vs + S::kTileElems;
  Elem* dOs = Qs + S::kTileElems;
  float* lse_s = reinterpret_cast<float*>(dOs + S::kTileElems);
  float* delta_s = lse_s + kTile;
  float* scratch = delta_s + kTile;

  const int k0 = blockIdx.x * kTile;  // causal: low kv tiles see the most q tiles
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvrow0 = k0 + warp * 16 + (lane >> 2);  // this lane's kv rows
  float* wscratch = scratch + warp * 16 * kScratchLd;

  load_tile<Elem, D>(Ks, p.k, b, h, k0, p.seqlen);
  load_tile<Elem, D>(Vs, p.v, b, h, k0, p.seqlen);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[jd][e] = dv[jd][e] = 0.f;

  const int q_begin = p.causal ? k0 : 0;  // q tiles wholly before the kv tile are skipped
  for (int q0 = q_begin; q0 < p.seqlen; q0 += kTile) {
    __syncthreads();
    load_tile<Elem, D>(Qs, p.q, b, h, q0, p.seqlen);
    load_tile<Elem, D>(dOs, p.dout, b, h, q0, p.seqlen);
    for (int i = threadIdx.x; i < kTile; i += kThreads) {
      const int t = q0 + i;
      const long long at = (long long)bh * p.seqlen + t;
      lse_s[i] = t < p.seqlen ? p.lse[at] : 0.f;
      delta_s[i] = t < p.seqlen ? p.delta[at] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // S^T and dP^T: [16 kv rows x 64 q columns]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
    mm_abt<Elem, D>(Ks + warp * 16 * LD, Qs, st, lane);
    mm_abt<Elem, D>(Vs + warp * 16 * LD, dOs, dpt, lane);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = frag_col(lane, j, e), q = q0 + qi;
        const int kv = kvrow0 + (e >= 2 ? 8 : 0);
        float x = st[j][e] * p.scale;
        if (q >= p.seqlen) x = -INFINITY;
        else if (p.causal && kv > q) x = kNegInf;
        const float prob = expf(x - lse_s[qi]);
        st[j][e] = prob;                                            // P^T
        dpt[j][e] = prob * (dpt[j][e] - delta_s[qi]) * p.scale;     // dS^T
      }
    mm_pb<Elem, D>(st, dOs, dv, lane, wscratch);
    mm_pb<Elem, D>(dpt, Qs, dk, lane, wscratch);
  }
  const float one[2] = {1.f, 1.f};
  store_rows<Elem, D>(p.dk, b, h, kvrow0, p.seqlen, dk, one, lane);
  store_rows<Elem, D>(p.dv, b, h, kvrow0, p.seqlen, dv, one, lane);
}

template <typename Elem, int D>
int launch_bwd(int which, const BwdParams& p, int batch, cudaStream_t stream) {
  using S = Smem<Elem, D>;
  const dim3 grid((p.seqlen + kTile - 1) / kTile, batch * p.heads);
  const int tiles = 4 * S::kTileElems * int(sizeof(Elem)) + S::kScratchBytes;
  if (which == 0) {
    auto kernel = flash_bwd_dq_kernel<Elem, D>;
    cudaError_t err = set_smem(kernel, tiles);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, kThreads, tiles, stream>>>(p);
  } else {
    const int smem = tiles + 2 * kTile * int(sizeof(float));
    auto kernel = flash_bwd_dkv_kernel<Elem, D>;
    cudaError_t err = set_smem(kernel, smem);
    if (err != cudaSuccess) return int(err);
    kernel<<<grid, kThreads, smem, stream>>>(p);
  }
  return int(cudaGetLastError());
}

template <typename Elem>
int dispatch_bwd(int which, int head_dim, const BwdParams& p, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_bwd<Elem, 32>(which, p, batch, stream);
    case 64: return launch_bwd<Elem, 64>(which, p, batch, stream);
    case 128: return launch_bwd<Elem, 128>(which, p, batch, stream);
    default: return kBadArgument;
  }
}

int run_bwd(int which, int dtype, int head_dim, int batch, const BwdParams& p, void* stream) {
  if (batch <= 0 || p.seqlen <= 0 || p.heads <= 0) return kBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_bwd<float>(which, head_dim, p, batch, s);
  if (dtype == 1) return dispatch_bwd<__nv_bfloat16>(which, head_dim, p, batch, s);
  return kBadArgument;
}

}  // namespace katib_flash

using katib_flash::View;

// K2. dtype: 0 = float32, 1 = bfloat16; strides in elements; lse and delta
// are [B*H, T] f32. Returns cudaGetLastError() after the launch, or -1 for a
// dtype/head_dim the kernel does not take.
extern "C" int katib_flash_bwd_dq(int dtype, int head_dim, int batch, int seqlen, int heads,
                                  const void* q, long long q_sb, long long q_st, long long q_sh,
                                  const void* k, long long k_sb, long long k_st, long long k_sh,
                                  const void* v, long long v_sb, long long v_st, long long v_sh,
                                  const void* dout, long long do_sb, long long do_st, long long do_sh,
                                  const float* lse, const float* delta,
                                  void* dq, long long dq_sb, long long dq_st, long long dq_sh,
                                  float scale, int causal, void* stream) {
  katib_flash::BwdParams p{};
  p.q = View{q, q_sb, q_st, q_sh};
  p.k = View{k, k_sb, k_st, k_sh};
  p.v = View{v, v_sb, v_st, v_sh};
  p.dout = View{dout, do_sb, do_st, do_sh};
  p.dq = View{dq, dq_sb, dq_st, dq_sh};
  p.lse = lse;
  p.delta = delta;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale = scale;
  p.causal = causal;
  return katib_flash::run_bwd(0, dtype, head_dim, batch, p, stream);
}

// K3. Same conventions as katib_flash_bwd_dq; writes dk and dv.
extern "C" int katib_flash_bwd_dkv(int dtype, int head_dim, int batch, int seqlen, int heads,
                                   const void* q, long long q_sb, long long q_st, long long q_sh,
                                   const void* k, long long k_sb, long long k_st, long long k_sh,
                                   const void* v, long long v_sb, long long v_st, long long v_sh,
                                   const void* dout, long long do_sb, long long do_st, long long do_sh,
                                   const float* lse, const float* delta,
                                   void* dk, long long dk_sb, long long dk_st, long long dk_sh,
                                   void* dv, long long dv_sb, long long dv_st, long long dv_sh,
                                   float scale, int causal, void* stream) {
  katib_flash::BwdParams p{};
  p.q = View{q, q_sb, q_st, q_sh};
  p.k = View{k, k_sb, k_st, k_sh};
  p.v = View{v, v_sb, v_st, v_sh};
  p.dout = View{dout, do_sb, do_st, do_sh};
  p.dk = View{dk, dk_sb, dk_st, dk_sh};
  p.dv = View{dv, dv_sb, dv_st, dv_sh};
  p.lse = lse;
  p.delta = delta;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale = scale;
  p.causal = causal;
  return katib_flash::run_bwd(1, dtype, head_dim, batch, p, stream);
}
