// K1: flash-attention forward on Hopper (sm_90a).
//
// Replaces katib_tpu/ops/flash_attention.py::_fwd_kernel (launched by _fwd,
// pallas_call at flash_attention.py:142): O = softmax(Q K^T * scale) V with
// the online-softmax recurrence, causal mask -1e30 with kv tiles above the
// diagonal skipped, O = acc / l (l == 0 -> 1) in the input dtype, and
// LSE = m + log(max(l, 1e-30)) in f32.
//
// Bound on this card: at the LM's shape (T = 2048, D = 64, bf16) the kernel
// does ~T/2 multiply-adds per byte it must read, far above the H100's ~295
// FLOP/byte ridge, so it is bound by tensor-core operations, not by memory.
// Design: the [64 x 64] score tile never leaves registers (mma.sync
// m16n8k16, f32 accumulation); P is fed back into the P.V product from the
// same registers; Q stays in shared memory for the whole kv loop and each
// K/V tile is read once per CTA; causal CTAs stop at the diagonal and the
// heaviest q tiles are scheduled first. Not yet done (later work): wgmma,
// TMA and a multi-stage K/V pipeline.
#include "flash_common.cuh"

namespace katib_flash {

struct FwdParams {
  View q, k, v, o;
  float* lse;  // [B*H, T] f32
  int heads, seqlen;
  float scale;
  int causal;
};

template <typename Elem, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FwdParams p) {
  using S = Smem<Elem, D>;
  constexpr int LD = S::kLd;
  extern __shared__ __align__(16) unsigned char smem[];
  Elem* Qs = reinterpret_cast<Elem*>(smem);
  Elem* Ks = Qs + S::kTileElems;
  Elem* Vs = Ks + S::kTileElems;
  float* scratch = reinterpret_cast<float*>(Vs + S::kTileElems);

  const int n_qt = (p.seqlen + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;  // heavy causal tiles first
  const int bh = blockIdx.y, b = bh / p.heads, h = bh % p.heads;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = q0 + warp * 16 + (lane >> 2);  // this lane's rows: row0, row0 + 8
  float* wscratch = scratch + warp * 16 * kScratchLd;

  load_tile<Elem, D>(Qs, p.q, b, h, q0, p.seqlen);

  float acc[D / 8][4];
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) acc[jd][0] = acc[jd][1] = acc[jd][2] = acc[jd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this lane's partial row sums

  const int kv_end = p.causal ? min(p.seqlen, q0 + kTile) : p.seqlen;
  for (int k0 = 0; k0 < kv_end; k0 += kTile) {
    __syncthreads();  // the previous K/V tile is consumed
    load_tile<Elem, D>(Ks, p.k, b, h, k0, p.seqlen);
    load_tile<Elem, D>(Vs, p.v, b, h, k0, p.seqlen);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mm_abt<Elem, D>(Qs + warp * 16 * LD, Ks, s, lane);

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kv = k0 + frag_col(lane, j, e), row = row0 + (e >= 2 ? 8 : 0);
        float x = s[j][e] * p.scale;
        if (kv >= p.seqlen) x = -INFINITY;             // ragged last tile: no weight
        else if (p.causal && kv > row) x = kNegInf;    // the TPU kernel's mask value
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      acc[jd][0] *= alpha[0]; acc[jd][1] *= alpha[0];
      acc[jd][2] *= alpha[1]; acc[jd][3] *= alpha[1];
    }
    mm_pb<Elem, D>(s, Vs, acc, lane, wscratch);
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = 1.f / (l[i] == 0.f ? 1.f : l[i]);
  }
  store_rows<Elem, D>(p.o, b, h, row0, p.seqlen, acc, inv, lane);
  if ((lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = row0 + 8 * i;
      if (t < p.seqlen) p.lse[(long long)bh * p.seqlen + t] = m[i] + logf(fmaxf(l[i], 1e-30f));
    }
  }
}

template <typename Elem, int D>
int launch_fwd(const FwdParams& p, int batch, cudaStream_t stream) {
  using S = Smem<Elem, D>;
  const int smem = 3 * S::kTileElems * int(sizeof(Elem)) + S::kScratchBytes;
  auto kernel = flash_fwd_kernel<Elem, D>;
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return int(err);
  const dim3 grid((p.seqlen + kTile - 1) / kTile, batch * p.heads);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <typename Elem>
int dispatch_fwd(int head_dim, const FwdParams& p, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch_fwd<Elem, 32>(p, batch, stream);
    case 64: return launch_fwd<Elem, 64>(p, batch, stream);
    case 128: return launch_fwd<Elem, 128>(p, batch, stream);
    default: return kBadArgument;
  }
}

}  // namespace katib_flash

using katib_flash::View;

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements; the last dim of
// every operand is contiguous. Returns cudaGetLastError() after the launch,
// or -1 for a dtype/head_dim the kernel does not take.
extern "C" int katib_flash_fwd(int dtype, int head_dim, int batch, int seqlen, int heads,
                               const void* q, long long q_sb, long long q_st, long long q_sh,
                               const void* k, long long k_sb, long long k_st, long long k_sh,
                               const void* v, long long v_sb, long long v_st, long long v_sh,
                               void* o, long long o_sb, long long o_st, long long o_sh,
                               float* lse, float scale, int causal, void* stream) {
  katib_flash::FwdParams p;
  p.q = View{q, q_sb, q_st, q_sh};
  p.k = View{k, k_sb, k_st, k_sh};
  p.v = View{v, v_sb, v_st, v_sh};
  p.o = View{o, o_sb, o_st, o_sh};
  p.lse = lse;
  p.heads = heads;
  p.seqlen = seqlen;
  p.scale = scale;
  p.causal = causal;
  if (batch <= 0 || seqlen <= 0 || heads <= 0) return katib_flash::kBadArgument;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return katib_flash::dispatch_fwd<float>(head_dim, p, batch, s);
  if (dtype == 1) return katib_flash::dispatch_fwd<__nv_bfloat16>(head_dim, p, batch, s);
  return katib_flash::kBadArgument;
}
