"""Decoder-only transformer LM — the single-device subset of
``katib_tpu/models/transformer.py``.

Dtypes follow the JAX model step by step, so the two agree in bf16 as well as
in f32: parameters are f32 and every projection casts its input and weight to
``config.dtype`` (flax ``Dense(dtype=...)``); ``RMSNorm`` rounds the normalised
activations to the input dtype and then multiplies by its f32 scale, so its
output is f32; rotary sin/cos are cast to the activations' dtype; the tied
output head multiplies in ``config.dtype`` and returns f32 logits. Attention
goes through the flash-attention kernels (``ops/flash_attention.py``).
Mixture-of-experts blocks and the sharded paths are later slices.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 32000
    embed_dim: int = 512
    num_layers: int = 4
    num_heads: int = 8
    mlp_ratio: int = 4
    max_seq_len: int = 2048
    dtype: torch.dtype = torch.bfloat16
    causal: bool = True
    num_experts: int = 0

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads


def bench_lm_config(size: str, on_gpu: bool):
    """The benchmark LM shapes of the JAX package, ``(config_kwargs, batch,
    seq, effective_size)``; off the card every size becomes the CPU smoke
    shape (and says so in ``effective_size``)."""
    if not on_gpu:
        return (
            dict(vocab_size=512, embed_dim=128, num_layers=2, num_heads=4,
                 max_seq_len=256, dtype=torch.float32),
            4, 256, "cpu_smoke",
        )
    if size == "large":
        return (
            dict(vocab_size=32768, embed_dim=1024, num_layers=8, num_heads=16,
                 max_seq_len=2048, dtype=torch.bfloat16),
            4, 2048, "large",
        )
    return (
        dict(vocab_size=8192, embed_dim=512, num_layers=4, num_heads=8,
             max_seq_len=1024, dtype=torch.bfloat16),
        8, 1024, "small",
    )


def rotary_embed(x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """RoPE on [B, T, H, D] with explicit positions [B, T]."""
    half = x.shape[-1] // 2
    freqs = torch.exp(
        -torch.arange(0, half, dtype=torch.float32, device=x.device) * (math.log(10000.0) / half)
    )
    angles = positions.to(torch.float32)[..., None] * freqs  # [B, T, half]
    sin = torch.sin(angles)[:, :, None, :].to(x.dtype)
    cos = torch.cos(angles)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: Optional[torch.Generator]) -> None:
    """flax's default kernel init: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std, generator=generator)


class Dense(nn.Module):
    """Bias-free projection with f32 weight [out, in], computed in ``dtype``."""

    def __init__(self, in_features: int, out_features: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        _lecun_normal_(self.weight, self.weight.shape[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype))


class RMSNorm(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        var = x.to(torch.float32).square().mean(dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + self.eps)).to(x.dtype) * self.scale


class Attention(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        self.config = config
        inner = config.num_heads * config.head_dim
        self.qkv = Dense(config.embed_dim, 3 * inner, config.dtype)
        self.out = Dense(inner, config.embed_dim, config.dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b, t, _ = x.shape
        qkv = self.qkv(x).view(b, t, 3, cfg.num_heads, cfg.head_dim)
        q = rotary_embed(qkv[:, :, 0], positions)
        k = rotary_embed(qkv[:, :, 1], positions)
        o = flash_attention(q, k, qkv[:, :, 2], causal=cfg.causal)
        return self.out(o.reshape(b, t, cfg.num_heads * cfg.head_dim))


class MLP(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        hidden = config.embed_dim * config.mlp_ratio
        self.up = Dense(config.embed_dim, hidden, config.dtype)
        self.gate = Dense(config.embed_dim, hidden, config.dtype)
        self.down = Dense(hidden, config.embed_dim, config.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.silu(self.gate(x)) * self.up(x))


class Block(nn.Module):
    def __init__(self, config: TransformerConfig):
        super().__init__()
        if config.num_experts > 0:
            raise NotImplementedError(
                "mixture-of-experts blocks (num_experts > 0) come with the sharded-LM "
                "slice of the port (MoE and the sharded LM)"
            )
        self.ln1 = RMSNorm(config.embed_dim)
        self.attn = Attention(config)
        self.ln2 = RMSNorm(config.embed_dim)
        self.mlp = MLP(config)

    def forward(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), positions)
        return x + self.mlp(self.ln2(x))


class _F32Logits(torch.autograd.Function):
    """x [N, E] . emb [V, E]^T with operands in bf16 and the sum kept in f32
    (the JAX head's ``preferred_element_type=f32``); gradients in bf16."""

    @staticmethod
    def forward(ctx, x, emb):
        ctx.save_for_backward(x, emb)
        return torch.mm(x, emb.t(), out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, grad):
        x, emb = ctx.saved_tensors
        g = grad.to(x.dtype)
        return g @ emb, g.t() @ x


def tied_logits(x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """f32 logits [B, T, V] from activations and the embedding, both already
    in the compute dtype."""
    if x.dtype == torch.float32:
        return x @ emb.t()
    if x.is_cuda:
        b, t, e = x.shape
        return _F32Logits.apply(x.reshape(b * t, e), emb).view(b, t, -1)
    # the CPU has no mixed-precision product: f32 products of the rounded
    # operands are exact, so the f32 sum matches the card's
    return x.float() @ emb.float().t()


class TransformerLM(nn.Module):
    """Token ids [B, T] -> f32 logits [B, T, V], with the output head tied
    to the embedding. Parameters are drawn from ``generator`` on the CPU,
    so a seed gives the same weights on every device."""

    def __init__(self, config: TransformerConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        self.embed = nn.Parameter(torch.empty(config.vocab_size, config.embed_dim))
        self.blocks = nn.ModuleList(Block(config) for _ in range(config.num_layers))
        self.ln_f = RMSNorm(config.embed_dim)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        nn.init.normal_(self.embed, std=0.02, generator=generator)
        for module in self.modules():
            if isinstance(module, Dense):
                module.reset_parameters(generator)
            elif isinstance(module, RMSNorm):
                module.scale.fill_(1.0)

    def forward(self, tokens: torch.Tensor, positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.config
        if positions is None:
            b, t = tokens.shape
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        x = F.embedding(tokens, self.embed).to(cfg.dtype)
        for block in self.blocks:
            x = block(x, positions)
        x = self.ln_f(x)
        return tied_logits(x.to(cfg.dtype), self.embed.to(cfg.dtype))
