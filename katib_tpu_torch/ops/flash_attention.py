"""Flash attention on [B, T, H, D] — hand-written CUDA kernels for Hopper.

Counterpart of ``katib_tpu/ops/flash_attention.py:flash_attention``. Three
kernels carry it, one for each Pallas kernel of the JAX package:

- K1 ``fwd``: O and the row log-sum-exp;
- K2 ``dq``: dQ, recomputing P from the lse;
- K3 ``dkv``: dK and dV, recomputing P from the lse.

Each has two designs, and the route picks one from the dtype and head dim
alone (``route``): ``sm90``, the wgmma/TMA kernels
(``csrc/flash_fwd_sm90.cu``, ``csrc/flash_bwd_dq_sm90.cu``,
``csrc/flash_bwd_dkv_sm90.cu``), takes bf16; ``mma``, the mma.sync/FMA
kernels (``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``), takes f32. A launch
that fails raises; nothing retries on the other route. ``forced_route`` puts
all three kernels on one design for a block, to hold the two designs against
each other on the same model.

The kernels are built for head dims 32, 64 and 128 (``HEAD_DIMS``). A
smaller head dim that is not one of them runs on the next one up
(``head_dim_padded``): the wrapper pads q, k, v and dO with zero columns,
which add exactly 0 to every score QKᵀ and to rowsum(O·dO), keeps the
softmax scale of the true D (the wrappers take it explicitly), and slices
O, dQ, dK and dV back; the padded columns of each are 0. A head dim above
128 raises on CUDA, and the LM trial refuses it up front.

Beside each kernel sits its plain PyTorch version (f32 math, explicit mask,
explicit lse): the wrappers take it for tensors on the CPU, and for CUDA
tensors they launch the kernel or raise. ``LAUNCHES`` counts kernel launches
per kernel, ``ROUTES`` per kernel and route. The kernels are built by
``_build`` at first CUDA use.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30  # the JAX package's mask value, above the causal diagonal
LAUNCHES = {"fwd": 0, "dq": 0, "dkv": 0}
ROUTES = {"fwd.sm90": 0, "fwd.mma": 0, "dq.sm90": 0, "dq.mma": 0, "dkv.sm90": 0, "dkv.mma": 0}
HEAD_DIMS = (32, 64, 128)
SM90_KERNELS = ("fwd", "dq", "dkv")  # the kernels with a wgmma/TMA design
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_VIEW = [_P, _L, _L, _L]
_FWD_ARGS = [_I, _I, _I, _I, _I] + _VIEW * 4 + [_P, ctypes.c_float, _I, _P]
_DQ_ARGS = [_I, _I, _I, _I, _I] + _VIEW * 4 + [_P, _P] + _VIEW + [ctypes.c_float, _I, _P]
_DKV_ARGS = [_I, _I, _I, _I, _I] + _VIEW * 4 + [_P, _P] + _VIEW * 2 + [ctypes.c_float, _I, _P]
_ARGTYPES = {
    "katib_flash_fwd": _FWD_ARGS,
    "katib_flash_fwd_sm90": _FWD_ARGS,
    "katib_flash_bwd_dq": _DQ_ARGS,
    "katib_flash_bwd_dq_sm90": _DQ_ARGS,
    "katib_flash_bwd_dkv": _DKV_ARGS,
    "katib_flash_bwd_dkv_sm90": _DKV_ARGS,
}
_SOURCE = {"katib_flash_fwd": "flash_fwd.cu", "katib_flash_fwd_sm90": "flash_fwd_sm90.cu",
           "katib_flash_bwd_dq": "flash_bwd.cu", "katib_flash_bwd_dq_sm90": "flash_bwd_dq_sm90.cu",
           "katib_flash_bwd_dkv": "flash_bwd.cu",
           "katib_flash_bwd_dkv_sm90": "flash_bwd_dkv_sm90.cu"}
_ENTRY = {("fwd", "mma"): "katib_flash_fwd", ("fwd", "sm90"): "katib_flash_fwd_sm90",
          ("dq", "mma"): "katib_flash_bwd_dq", ("dq", "sm90"): "katib_flash_bwd_dq_sm90",
          ("dkv", "mma"): "katib_flash_bwd_dkv", ("dkv", "sm90"): "katib_flash_bwd_dkv_sm90"}
_fns = {}
_forced: Optional[str] = None  # set by forced_route


def route(kernel: str, dtype: torch.dtype, head_dim: int) -> str:
    """The design that runs ``kernel`` ("fwd", "dq" or "dkv") for this dtype
    and head dim: "sm90" (wgmma + TMA) for bf16, "mma" (plain FMA, never
    TF32) for f32; inside ``forced_route``, the forced design (bf16 on "mma"
    is the mma.sync design, kept as the yardstick)."""
    if kernel not in SM90_KERNELS:
        raise ValueError(f"no kernel {kernel!r}; the kernels are {SM90_KERNELS}")
    if _forced is not None:
        return _forced
    return "sm90" if dtype == torch.bfloat16 and head_dim <= HEAD_DIMS[-1] else "mma"


@contextlib.contextmanager
def forced_route(design: str):
    """K1, K2 and K3 run on ``design`` ("sm90" or "mma") inside the block,
    for every dtype and head dim; the sm90 kernels reject f32 at launch."""
    global _forced
    if design not in ("sm90", "mma"):
        raise ValueError(f"no design {design!r}; the designs are 'sm90' and 'mma'")
    previous, _forced = _forced, design
    try:
        yield
    finally:
        _forced = previous


# ---------------------------------------------------------------------------
# Plain versions (f32 math) — the CPU path and the on-card yardstick
# ---------------------------------------------------------------------------

def _scores(q: torch.Tensor, k: torch.Tensor, causal: bool, sm_scale: float) -> torch.Tensor:
    """S = Q K^T * scale in f32, [B, H, Tq, Tk], NEG_INF above the diagonal."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * sm_scale
    if causal:
        tq, tk = s.shape[-2:]
        keep = torch.ones((tq, tk), dtype=torch.bool, device=s.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def fwd_plain(q, k, v, causal: bool, sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's function: (O [B,T,H,D] in q's dtype, lse [B,H,T] f32)."""
    s = _scores(q, k, causal, sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bhqk,bkhd->bqhd", p / l, v.float())
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale):
    p = torch.exp(_scores(q, k, causal, sm_scale) - lse.unsqueeze(-1))
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    return p, p * (dp - delta.unsqueeze(-1)) * sm_scale


def bwd_dq_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float) -> torch.Tensor:
    """K2's function: dQ from the saved lse and delta = rowsum(O * dO)."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def bwd_dkv_plain(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K3's function: (dK, dV) from the saved lse and delta."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal, sm_scale)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def padded_head_dim(d: int) -> int:
    """The head dim the kernels run ``d`` at: the least of ``HEAD_DIMS``
    not below it, or ``d`` itself above 128 (which ``_check`` refuses)."""
    return next((h for h in HEAD_DIMS if h >= d), d)


def head_dim_padded(fn, n_operands: int, *args):
    """``fn(*args)`` with its first ``n_operands`` [B, T, H, D] arguments
    zero-padded along D to ``padded_head_dim(D)``, and every [B, T, H, D]
    output sliced back to D. The softmax scale is an argument of ``fn``, so
    it stays that of the true D."""
    d = args[0].shape[-1]
    dp = padded_head_dim(d)
    if dp == d:
        return fn(*args)
    out = fn(*(F.pad(x, (0, dp - d)) for x in args[:n_operands]), *args[n_operands:])
    if isinstance(out, tuple):
        return tuple(o[..., :d] if o.dim() == 4 else o for o in out)
    return out[..., :d]


# ---------------------------------------------------------------------------
# Kernel launches
# ---------------------------------------------------------------------------

def _fn(name: str):
    fn = _fns.get(name)
    if fn is None:
        from . import _build

        fn = getattr(_build.load(_SOURCE[name]), name)
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _operand(x: torch.Tensor) -> torch.Tensor:
    """The kernels read [B,T,H,D] from strides with D contiguous and every
    row on a 16-byte boundary; anything else is copied once."""
    epc = 16 // x.element_size()
    ok = x.stride(-1) == 1 and all(s % epc == 0 for s in x.stride()[:3]) and x.data_ptr() % 16 == 0
    return x if ok else x.contiguous()


def _view(x: torch.Tensor):
    sb, st, sh, _ = x.stride()
    return [x.data_ptr(), sb, st, sh]


def _check(*xs: torch.Tensor) -> Tuple[int, int, int, int, int]:
    q = xs[0]
    if q.dim() != 4:
        raise ValueError(f"flash attention takes [B, T, H, D], got shape {tuple(q.shape)}")
    for x in xs:
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(
                f"flash attention operands differ: {tuple(x.shape)} {x.dtype} {x.device} "
                f"vs {tuple(q.shape)} {q.dtype} {q.device}"
            )
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got {q.dtype}")
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"the CUDA kernels take head_dim in {HEAD_DIMS}, got {d}")
    return _DTYPE_CODES[q.dtype], d, b, t, h


def _launch(name: str, *args) -> None:
    rc = _fn(name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with code {rc}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def _require_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise RuntimeError(f"flash attention runs on CUDA or CPU tensors, got {x.device}")


def _fwd_cuda(design: str, q, k, v, causal: bool, sm_scale: float):
    q, k, v = (_operand(x) for x in (q, k, v))
    code, d, b, t, h = _check(q, k, v)
    o = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_ENTRY["fwd", design], code, d, b, t, h, *_view(q), *_view(k), *_view(v), *_view(o),
                lse.data_ptr(), float(sm_scale), int(causal), _stream(q))
    return o, lse


def flash_fwd(q, k, v, causal: bool, sm_scale: float):
    """K1: (O, lse). CPU tensors take the plain version."""
    if q.device.type == "cpu":
        return fwd_plain(q, k, v, causal, sm_scale)
    _require_cuda(q)
    design = route("fwd", q.dtype, q.shape[-1])
    out = head_dim_padded(functools.partial(_fwd_cuda, design), 3, q, k, v, causal, sm_scale)
    LAUNCHES["fwd"] += 1
    ROUTES["fwd." + design] += 1
    return out


def _dq_cuda(design: str, q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    q, k, v, do = (_operand(x) for x in (q, k, v, do))
    code, d, b, t, h = _check(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dq = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_ENTRY["dq", design], code, d, b, t, h, *_view(q), *_view(k), *_view(v), *_view(do),
                lse.data_ptr(), delta.data_ptr(), *_view(dq), float(sm_scale), int(causal), _stream(q))
    return dq


def flash_bwd_dq(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K2: dQ. ``lse`` and ``delta`` are [B, H, T] f32."""
    if q.device.type == "cpu":
        return bwd_dq_plain(q, k, v, do, lse, delta, causal, sm_scale)
    _require_cuda(q)
    design = route("dq", q.dtype, q.shape[-1])
    out = head_dim_padded(functools.partial(_dq_cuda, design), 4, q, k, v, do, lse, delta, causal, sm_scale)
    LAUNCHES["dq"] += 1
    ROUTES["dq." + design] += 1
    return out


def _dkv_cuda(design: str, q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    q, k, v, do = (_operand(x) for x in (q, k, v, do))
    code, d, b, t, h = _check(q, k, v, do)
    lse, delta = lse.float().contiguous(), delta.float().contiguous()
    dk = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, t, h, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        _launch(_ENTRY["dkv", design], code, d, b, t, h, *_view(q), *_view(k), *_view(v), *_view(do),
                lse.data_ptr(), delta.data_ptr(), *_view(dk), *_view(dv), float(sm_scale),
                int(causal), _stream(q))
    return dk, dv


def flash_bwd_dkv(q, k, v, do, lse, delta, causal: bool, sm_scale: float):
    """K3: (dK, dV). ``lse`` and ``delta`` are [B, H, T] f32."""
    if q.device.type == "cpu":
        return bwd_dkv_plain(q, k, v, do, lse, delta, causal, sm_scale)
    _require_cuda(q)
    design = route("dkv", q.dtype, q.shape[-1])
    out = head_dim_padded(functools.partial(_dkv_cuda, design), 4, q, k, v, do, lse, delta, causal, sm_scale)
    LAUNCHES["dkv"] += 1
    ROUTES["dkv." + design] += 1
    return out


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(O * dO) in f32, [B, H, T] (flash_attention.py:277-279)."""
    return (o.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


class FlashAttention(torch.autograd.Function):
    """Forward through K1; backward recomputes through K2 and K3."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: float):
        o, lse = flash_fwd(q, k, v, causal, sm_scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = attention_delta(o, do)
        dq = flash_bwd_dq(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, ctx.causal, ctx.sm_scale)
        return dq, dk, dv, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = False,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Fused attention on [B, T, H, D], differentiable. ``sm_scale``
    defaults to 1/sqrt(D). Any T >= 1: the kernels mask the ragged last
    tile themselves, and any D up to 128 (padded up to ``HEAD_DIMS``), so
    there is no dense fallback on CUDA."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, bool(causal), float(sm_scale))
