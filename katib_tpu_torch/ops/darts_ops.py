"""DARTS operation set — the port's own copy of ``katib_tpu/ops/darts_ops.py``
as ``nn.Module``s in NCHW (the reference's operations.py OPS: none, avg/max
pooling 3x3, skip connection, separable convolutions 3x3/5x5, dilated
convolutions 3x3/5x5).

- Normalisation has no state: every ``batch_norm`` normalises over the
  batch with the biased variance (train-mode BatchNorm, no affine
  parameters, no running statistics), in evaluation too.
- Padding is XLA's SAME: ``total // 2`` before and the rest after, so a
  stride-2 window over an even size pads one more pixel after than before
  (32 -> 16: (0, 1) for a 3x3 window, (1, 2) for a 5x5 one or a 3x3 one at
  dilation 2). Convolutions and average pools pad with zeros (the average
  divides by the full window, padding included, as flax's ``avg_pool``
  does), max pools with -inf.
- The JAX package's ``MatmulConv`` (an im2col product, a TPU compile-time
  workaround) is a plain convolution without bias here; a 1x1 one at stride
  2 is a slice ``[:, :, ::2, ::2]`` and a 1x1 convolution, as there.
- Weights are drawn as flax's ``lecun_normal`` draws them (truncated
  normal, std sqrt(1/fan_in)). Ops without parameters hold none, and the
  class names are the flax modules' own, so that a supernet's or derived
  network's modules are named as the flax tree names them
  (``models.convert.darts_params_from_flax``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch import nn

_LECUN_TRUNC = 0.87962566103423978  # stddev of a standard normal truncated to [-2, 2]
BN_EPS = 1e-5


def batch_norm(x: torch.Tensor) -> torch.Tensor:
    """Per-batch normalisation over N, H, W (biased variance, eps 1e-5).
    A dual tensor (forward-mode AD) takes the written-out formula: the
    reverse pass over torch's forward-mode formula for batch norm treats the
    batch statistics as constants."""
    if fwAD.unpack_dual(x).tangent is None:
        return F.batch_norm(x, None, None, training=True, eps=BN_EPS)
    mean = x.mean((0, 2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(x.var((0, 2, 3), unbiased=False, keepdim=True) + BN_EPS)


def same_padding(size: int, window: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dimension: (before, after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + window - size, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, window: int, stride: int):
    """(F.pad argument, or None when symmetric; the symmetric padding)."""
    (top, bottom), (left, right) = (same_padding(s, window, stride) for s in x.shape[-2:])
    if top == bottom and left == right:
        return None, (top, left)
    return (left, right, top, bottom), (0, 0)


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int = 1, dilation: int = 1,
                groups: int = 1, bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    window = (weight.shape[-1] - 1) * dilation + 1
    explicit, padding = _pads(x, window, stride)
    if explicit is not None:
        x = F.pad(x, explicit)
    return F.conv2d(x, weight, bias, stride, padding, dilation, groups)


def lecun_normal_(weight: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    std = (1.0 / weight[0].numel()) ** 0.5 / _LECUN_TRUNC
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


class Conv(nn.Module):
    """A convolution without bias, SAME padding; ``groups=channels`` makes
    it depthwise. Its weight is [F, C/groups, k, k]."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int = 1, stride: int = 1,
                 dilation: int = 1, groups: int = 1, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.dilation, self.groups = stride, dilation, groups
        self.weight = nn.Parameter(torch.empty(channels_out, channels_in // groups, kernel_size, kernel_size))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.weight.shape[-1] == 1 and self.dilation == 1:  # 1x1: stride by slicing
            if self.stride != 1:
                x = x[:, :, ::self.stride, ::self.stride]
            return F.conv2d(x, self.weight, groups=self.groups)
        return conv2d_same(x, self.weight, self.stride, self.dilation, self.groups)


class Zero(nn.Module):
    def __init__(self, stride: int = 1):
        super().__init__()
        self.stride = stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride == 1:
            return x * 0.0
        return x[:, :, ::self.stride, ::self.stride] * 0.0


class PoolBN(nn.Module):
    """avg or max pool 3x3, then batch_norm."""

    def __init__(self, pool_type: str, stride: int = 1):
        super().__init__()
        if pool_type not in ("avg", "max"):
            raise ValueError(f"pool_type must be 'avg' or 'max', got {pool_type!r}")
        self.pool_type, self.stride = pool_type, stride

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        explicit, padding = _pads(x, 3, self.stride)
        if self.pool_type == "avg":
            if explicit is not None:
                x = F.pad(x, explicit)
            out = F.avg_pool2d(x, 3, self.stride, padding, count_include_pad=True)
        else:
            if explicit is not None:
                x = F.pad(x, explicit, value=float("-inf"))
            out = F.max_pool2d(x, 3, self.stride, padding)
        return batch_norm(out)


class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class FactorizedReduce(nn.Module):
    """ReLU, two 1x1 convolutions at stride 2 offset by one pixel,
    concatenated, then batch_norm."""

    def __init__(self, channels_in: int, channels: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        h = channels // 2
        self.conv1 = Conv(channels_in, h, 1, stride=2, generator=generator)
        self.conv2 = Conv(channels_in, channels - h, 1, stride=2, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(x)
        return batch_norm(torch.cat([self.conv1(x), self.conv2(x[:, :, 1:, 1:])], dim=1))


class StdConv(nn.Module):
    """ReLU - convolution - batch_norm."""

    def __init__(self, channels_in: int, channels: int, kernel_size: int = 1, stride: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv = Conv(channels_in, channels, kernel_size, stride, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self.conv(F.relu(x)))


class SepConv(nn.Module):
    """Two stacked (ReLU - depthwise - pointwise - batch_norm) blocks, the
    stride in the first."""

    def __init__(self, channels_in: int, channels: int, kernel_size: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw0 = Conv(channels_in, channels_in, kernel_size, stride, groups=channels_in, generator=generator)
        self.pw0 = Conv(channels_in, channels, generator=generator)
        self.dw1 = Conv(channels, channels, kernel_size, 1, groups=channels, generator=generator)
        self.pw1 = Conv(channels, channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = batch_norm(self.pw0(self.dw0(F.relu(x))))
        return batch_norm(self.pw1(self.dw1(F.relu(x))))


class DilConv(nn.Module):
    """ReLU - dilated depthwise - pointwise - batch_norm."""

    def __init__(self, channels_in: int, channels: int, kernel_size: int, stride: int, dilation: int = 2,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dw = Conv(channels_in, channels_in, kernel_size, stride, dilation, groups=channels_in,
                       generator=generator)
        self.pw = Conv(channels_in, channels, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return batch_norm(self.pw(self.dw(F.relu(x))))


def make_op(name: str, channels: int, stride: int, generator: Optional[torch.Generator] = None) -> nn.Module:
    """The reference's OPS factory; the input has ``channels`` channels."""
    if name == "none":
        return Zero(stride)
    if name == "avg_pooling_3x3":
        return PoolBN("avg", stride)
    if name == "max_pooling_3x3":
        return PoolBN("max", stride)
    if name == "skip_connection":
        return Identity() if stride == 1 else FactorizedReduce(channels, channels, generator)
    if name in ("separable_convolution_3x3", "separable_convolution_5x5"):
        return SepConv(channels, channels, int(name[-1]), stride, generator)
    if name in ("dilated_convolution_3x3", "dilated_convolution_5x5"):
        return DilConv(channels, channels, int(name[-1]), stride, 2, generator)
    raise ValueError(f"unknown DARTS operation {name!r}")


def flax_names(ops: Sequence[nn.Module]) -> List[str]:
    """The names flax gives unnamed submodules created in this order: the
    class name and a counter per class (``SepConv_0``, ``SepConv_1``, ...)."""
    seen: Dict[str, int] = {}
    names = []
    for op in ops:
        cls = type(op).__name__
        names.append(f"{cls}_{seen.get(cls, 0)}")
        seen[cls] = seen.get(cls, 0) + 1
    return names


class MixedOp(nn.ModuleDict):
    """The continuous relaxation of one edge: every candidate op, weighted by
    the edge's softmaxed alphas and summed. The ops are keyed by their flax
    names, in the order of ``primitives``."""

    def __init__(self, primitives: Sequence[str], channels: int, stride: int,
                 generator: Optional[torch.Generator] = None):
        ops = [make_op(p, channels, stride, generator) for p in primitives]
        super().__init__(zip(flax_names(ops), ops))

    def forward(self, x: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
        stacked = torch.stack([op(x) for op in self.values()])  # [n_ops, N, C, H, W]
        return torch.tensordot(weights, stacked, dims=1)
