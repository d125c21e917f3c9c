"""ENAS child network and its trial — the port's own copy of
``katib_tpu/models/enas_child.py`` (``_pad_to``, ``_concat_inputs``,
``EnasChildNet``, ``run_enas_trial``), in NCHW.

The controller's ``architecture`` (per layer [op, skip bits...]) and
``nn_config`` (the concrete operations it names) become a CNN:

- layer l reads layer l-1 and every earlier layer whose skip bit is set;
  skip bit i reads ``layers[i]``, and ``layers[0]`` is the image. Inputs
  are concatenated along channels, smaller maps zero-padded, centred, to
  the largest height and width;
- ops: ``convolution`` (ReLU, SAME convolution, batch_norm),
  ``separable_convolution`` (ReLU, depthwise convolution of
  ``depth_multiplier`` outputs a channel, 1x1 pointwise, batch_norm),
  ``depthwise_convolution`` (the same without the pointwise), and
  ``reduction`` (a VALID max or average pool, stride the pool size; the
  identity when the map's height or width is already 1);
- head: the global mean, dropout, then a dense layer.

Batch norm is the stateless per-batch one of the DARTS ops. Convolutions
have biases and kernels drawn as flax draws them (``lecun_normal``, biases
zero); modules carry flax's names (``layer1_conv``, ``layer2_dw``,
``layer2_pw``, ``classifier``), so ``models.convert.enas_child_params_from_flax``
is a rename and a transpose. Shapes are worked out when the network is
built. A pool window larger than its map gives an empty map, as flax does;
every op on an empty map gives an empty map (torch's convolutions and pools
refuse one, so no op runs on it), padding turns it into zeros beside a
non-empty input, and the head's mean of an empty map is NaN, as in JAX.
Dropout masks come from a CPU generator seeded per trial, so the card and
the CPU drop the same units; they are not ``jax.random``'s masks.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.darts_ops import batch_norm, conv2d_same, lecun_normal_
from ..utils.backend import trial_device
from ..utils.datasets import batch_indices, cifar10_train_nchw
from ..utils.precision import f32_convolutions

Shape = Tuple[int, int, int]  # (C, H, W)


def pad_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero-pad the spatial dims up to (h, w), the extra row and column
    after, as the reference's concat does."""
    dh, dw = h - x.shape[2], w - x.shape[3]
    if dh == 0 and dw == 0:
        return x
    top, left = dh // 2, dw // 2
    return F.pad(x, (left, dw - left, top, dh - top))


def concat_inputs(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    if len(inputs) == 1:
        return inputs[0]
    h = max(x.shape[2] for x in inputs)
    w = max(x.shape[3] for x in inputs)
    return torch.cat([pad_to(x, h, w) for x in inputs], dim=1)


class SameConv(nn.Module):
    """flax's ``nn.Conv`` with SAME padding: a weight [F, C/groups, k, k]
    drawn by ``lecun_normal``, a zero bias."""

    def __init__(self, channels_in: int, channels_out: int, kernel_size: int, stride: int = 1, groups: int = 1,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.groups = stride, groups
        self.weight = nn.Parameter(torch.empty(channels_out, channels_in // groups, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(channels_out))
        lecun_normal_(self.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv2d_same(x, self.weight, self.stride, groups=self.groups, bias=self.bias)


class Layer:
    """One layer's plan: the layers it reads, its op and its shapes."""

    def __init__(self, index: int, reads: List[int], opt_type: str, params: Dict[str, Any], shape_in: Shape):
        self.index, self.reads, self.opt_type, self.shape_in = index, reads, opt_type, shape_in
        c, h, w = shape_in
        self.num_filter = int(params.get("num_filter", 64))
        self.filter_size = int(params.get("filter_size", 3))
        self.stride = int(params.get("stride", 1) or 1)
        self.depth_mult = int(params.get("depth_multiplier", 1))
        if opt_type in ("convolution", "separable_convolution", "depthwise_convolution"):
            h, w = -(-h // self.stride), -(-w // self.stride)
            c = c * self.depth_mult if opt_type == "depthwise_convolution" else self.num_filter
        elif opt_type == "reduction":
            self.pool = int(params.get("pool_size", 2))
            self.pool_stride = int(params.get("stride") or self.pool)
            self.identity = h == 1 or w == 1
            if not self.identity:
                h, w = (max((s - self.pool) // self.pool_stride + 1, 0) for s in (h, w))
            self.avg = params.get("reduction_type", "max_pooling") == "avg_pooling"
        else:
            raise ValueError(f"unknown ENAS op type {opt_type!r}")
        self.shape_out = (c, h, w)


class EnasChildNet(nn.Module):
    """The network of one architecture. ``arch`` is the per-layer [op,
    skip...] lists, ``embedding`` maps str(op) to its operation, and
    ``input_shape`` is the images' (C, H, W). Weights are drawn from
    ``generator`` (seeded 0 by default)."""

    def __init__(self, arch: Sequence[Sequence[int]], embedding: Dict[str, Dict[str, Any]],
                 input_shape: Shape = (3, 32, 32), num_classes: int = 10, dropout_rate: float = 0.4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.dropout_rate = dropout_rate
        shapes: List[Shape] = [tuple(int(s) for s in input_shape)]
        self.plan: List[Layer] = []
        for l in range(1, len(arch) + 1):
            skip = list(arch[l - 1][1:l + 1])
            reads = [l - 1] + [i for i in range(l - 1) if i < len(skip) and skip[i] == 1]
            shape_in = (sum(shapes[i][0] for i in reads), max(shapes[i][1] for i in reads),
                        max(shapes[i][2] for i in reads))
            cfg = embedding[str(arch[l - 1][0])]
            layer = Layer(l, reads, cfg["opt_type"], cfg.get("opt_params", {}), shape_in)
            c = shape_in[0]
            if layer.opt_type == "convolution":
                self.add_module(f"layer{l}_conv", SameConv(c, layer.num_filter, layer.filter_size, layer.stride,
                                                           generator=g))
            elif layer.opt_type in ("separable_convolution", "depthwise_convolution"):
                self.add_module(f"layer{l}_dw", SameConv(c, c * layer.depth_mult, layer.filter_size, layer.stride,
                                                         groups=c, generator=g))
                if layer.opt_type == "separable_convolution":
                    self.add_module(f"layer{l}_pw", SameConv(c * layer.depth_mult, layer.num_filter, 1,
                                                             generator=g))
            self.plan.append(layer)
            shapes.append(layer.shape_out)
        self.out_channels = shapes[-1][0]
        self.classifier = nn.Linear(self.out_channels, num_classes)
        lecun_normal_(self.classifier.weight, g)
        nn.init.zeros_(self.classifier.bias)

    def _run_layer(self, layer: Layer, x: torch.Tensor) -> torch.Tensor:
        c, h, w = layer.shape_out
        if h * w == 0:  # an empty map: nothing to compute, as in XLA
            return x.new_zeros((x.shape[0], c, h, w))
        l, kind = layer.index, layer.opt_type
        if kind == "convolution":
            return batch_norm(getattr(self, f"layer{l}_conv")(F.relu(x)))
        if kind in ("separable_convolution", "depthwise_convolution"):
            x = getattr(self, f"layer{l}_dw")(F.relu(x))
            if kind == "separable_convolution":
                x = getattr(self, f"layer{l}_pw")(x)
            return batch_norm(x)
        if layer.identity:
            return x
        pool = F.avg_pool2d if layer.avg else F.max_pool2d
        return pool(x, layer.pool, layer.pool_stride)

    def dropout_mask(self, batch: int, generator: torch.Generator) -> Optional[torch.Tensor]:
        """A [batch, C] keep-mask drawn on the CPU, or None at rate 0."""
        if self.dropout_rate == 0.0:
            return None
        return torch.rand(batch, self.out_channels, generator=generator) < 1.0 - self.dropout_rate

    def forward(self, x: torch.Tensor, dropout_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """NCHW images -> logits; ``dropout_mask`` (training) keeps and
        rescales the pooled features it marks."""
        layers = [x]
        for layer in self.plan:
            layers.append(self._run_layer(layer, concat_inputs([layers[i] for i in layer.reads])))
        out = layers[-1].mean((2, 3))
        if dropout_mask is not None:
            keep = 1.0 - self.dropout_rate
            out = torch.where(dropout_mask.to(out.device), out / keep, torch.zeros_like(out))
        return self.classifier(out)


def make_child_train_step(model: EnasChildNet, lr: float, generator: torch.Generator):
    """``step(bx, by)``: one Adam step (optax's defaults) on the mean
    softmax cross-entropy, dropout masks from ``generator``, convolutions in
    full f32; returns the loss as a 0-d tensor on the device."""
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        mask = model.dropout_mask(len(bx), generator)
        if mask is not None and bx.is_cuda:  # from pinned memory: the host does not wait for the card
            mask = mask.pin_memory().to(bx.device, non_blocking=True)
        with f32_convolutions.hold():
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(bx, mask), by)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


def load_child_data(dataset: str, n: Optional[int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trial's images (NCHW) and labels on ``device``."""
    if dataset == "digits":
        raise ValueError("dataset 'digits' is scikit-learn's bundled UCI digits; the port imports torch, numpy "
                         "and the standard library only and does not carry it (use 'cifar')")
    if dataset not in ("cifar", "cifar10"):
        raise ValueError(f"unknown dataset {dataset!r}; expected 'digits' or 'cifar'")
    return cifar10_train_nchw(n, device)


def train_and_report(step, evaluate, train: Tuple[torch.Tensor, torch.Tensor],
                     valid: Tuple[torch.Tensor, torch.Tensor], batch_size: int, num_epochs: int,
                     rng: np.random.Generator, ctx=None) -> None:
    """The epoch loop: train (one step on the whole split when it is
    smaller than a batch, drawing nothing), then validate on batches of a
    permutation drawn from the same ``rng`` (the whole split when not one
    batch fits), then report ``Validation-accuracy`` and ``Train-loss`` (the
    epoch's last step)."""
    (x_t, y_t), (x_v, y_v) = train, valid
    device = x_t.device
    loss = torch.tensor(float("nan"))
    for epoch in range(num_epochs):
        if len(x_t) < batch_size:
            loss = step(x_t, y_t)
        else:
            for sel in torch.from_numpy(batch_indices(len(x_t), batch_size, rng)).to(device):
                loss = step(x_t[sel], y_t[sel])
        accs = [evaluate(x_v[sel], y_v[sel])
                for sel in torch.from_numpy(batch_indices(len(x_v), batch_size, rng)).to(device)]
        if not accs and len(x_v):  # the validation split is smaller than one batch
            accs = [evaluate(x_v, y_v)]
        acc = float(torch.stack(accs).mean()) if accs else 0.0
        if ctx is not None:
            ctx.report(**{"Validation-accuracy": acc, "Train-loss": float(loss)})
        else:
            print(f"Epoch {epoch + 1}:")
            print(f"Validation-accuracy={acc}")
            print(f"Train-loss={float(loss)}")


def parse_assignments(assignments: Dict[str, str]) -> Tuple[List[List[int]], Dict[str, Any]]:
    """The ``architecture`` and ``nn_config`` strings (JSON with single
    quotes) as lists and a dict."""
    arch = json.loads(assignments["architecture"].replace("'", '"'))
    return arch, json.loads(assignments["nn_config"].replace("'", '"'))


def run_enas_trial(assignments: Dict[str, str], ctx=None) -> None:
    """Trial entry point of the enas suggester's assignments: builds the
    architecture and trains it with Adam on 90 % of CIFAR-10's training
    split, validating on the rest; ``num_epochs`` (3), ``batch_size``
    (128), ``learning_rate`` (0.002), ``num_train_examples`` and
    ``dataset`` as in the JAX trial. One ``default_rng(0)`` draws every
    epoch's training and then validation permutation."""
    arch, nn_config = parse_assignments(assignments)
    num_epochs = int(assignments.get("num_epochs", "3"))
    batch_size = int(assignments.get("batch_size", "128"))
    lr = float(assignments.get("learning_rate", "0.002"))
    n_train = int(assignments.get("num_train_examples", "0")) or None

    device = trial_device(ctx)
    x, y = load_child_data(assignments.get("dataset", "cifar"), n_train, device)
    split = int(len(x) * 0.9)
    model = EnasChildNet(arch, nn_config["embedding"], input_shape=tuple(x.shape[1:]),
                         num_classes=int(nn_config["output_sizes"][-1])).to(device)
    step = make_child_train_step(model, lr, torch.Generator().manual_seed(0))

    @torch.no_grad()
    def evaluate(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        return (model(bx).argmax(-1) == by).float().mean()

    with f32_convolutions.hold():
        train_and_report(step, evaluate, (x[:split], y[:split]), (x[split:], y[split:]), batch_size, num_epochs,
                         np.random.default_rng(0), ctx)
