"""Dense reference attention on [B, T, H, D].

Counterpart of ``katib_tpu/ops/ring_attention.py:dense_attention``. Only the
plain unsharded reference is here; the ring schedule over several devices
is a later slice of the port.
"""

from __future__ import annotations

import math

import torch

from .flash_attention import NEG_INF, fwd_plain

__all__ = ["NEG_INF", "dense_attention"]


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """softmax(Q K^T / sqrt(d)) V, masked with ``NEG_INF`` above the diagonal
    when ``causal``: K1's plain version without its lse (f32 math, the result
    in q's dtype)."""
    return fwd_plain(q, k, v, causal, 1.0 / math.sqrt(q.shape[-1]))[0]
