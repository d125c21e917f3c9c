"""The derived (discrete) DARTS network and its retraining trial — the port's
own copy of ``katib_tpu/models/darts_derived.py``.

``DerivedNetwork`` builds only the genotype's chosen ops (no mixture, no
alphas) on the supernet's stem and reduction schedule, in NCHW;
``run_darts_retrain_trial`` trains it from a ``genotype`` assignment, the
``Best-Genotype`` a search printed, so that an experiment can tune the
retraining's optimiser. A cell's ops carry the names flax gives them
(``SepConv_0``, ``FactorizedReduce_0``, ...), in gene order.
"""

from __future__ import annotations

import ast
import itertools
import json
import math
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.darts_ops import Conv, FactorizedReduce, StdConv, batch_norm, flax_names, make_op
from ..utils.backend import trial_device
from ..utils.datasets import batch_indices
from ..utils.precision import f32_convolutions
from .darts_supernet import Classifier, reduction_layers
from .darts_trainer import WeightOptimizer, cifar_halves

# one tuple of (op, input state) edges per node
Gene = Tuple[Tuple[Tuple[str, int], ...], ...]


def gene_from_json(gene_list) -> Gene:
    """A gene as nested tuples, from the lists a JSON round trip makes."""
    return tuple(tuple((str(op), int(edge)) for op, edge in node) for node in gene_list)


class DerivedCell(nn.Module):
    """A supernet cell with each mixture collapsed to its chosen op."""

    def __init__(self, gene: Gene, c_pp: int, c_p: int, channels: int, reduction_prev: bool,
                 reduction_cur: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        if reduction_prev:
            self.pre0_reduce = FactorizedReduce(c_pp, channels, generator)
        else:
            self.pre0 = StdConv(c_pp, channels, 1, generator=generator)
        self.pre1 = StdConv(c_p, channels, 1, generator=generator)
        self.reduction_prev = reduction_prev
        ops, self.nodes = [], []
        for i, node_edges in enumerate(gene):
            edges = []
            for op_name, j in node_edges:
                if not 0 <= j < 2 + i:
                    raise ValueError(f"gene node {i} reads state {j}; it may read states 0..{i + 1}")
                ops.append(make_op(op_name, channels, 2 if reduction_cur and j < 2 else 1, generator))
                edges.append(j)
            self.nodes.append(edges)
        self.op_names = flax_names(ops)
        for name, op in zip(self.op_names, ops):
            self.add_module(name, op)

    def forward(self, s0: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
        s0 = self.pre0_reduce(s0) if self.reduction_prev else self.pre0(s0)
        states = [s0, self.pre1(s1)]
        names = iter(self.op_names)
        for edges in self.nodes:
            acc = None
            for j in edges:
                out = getattr(self, next(names))(states[j])
                acc = out if acc is None else acc + out
            states.append(acc)
        return torch.cat(states[2:], dim=1)


class DerivedNetwork(nn.Module):
    """The supernet's stem and reduction schedule with cells built from
    the genes (``reduce`` defaults to ``normal``); NCHW images in, logits
    out. Weights are drawn from ``generator`` (seeded 0 by default)."""

    def __init__(self, normal: Gene, reduce: Optional[Gene] = None, init_channels: int = 16,
                 input_channels: int = 3, num_classes: int = 10, num_layers: int = 8, stem_multiplier: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        c_cur = stem_multiplier * init_channels
        self.stem = Conv(input_channels, c_cur, 3, generator=g)
        reductions = reduction_layers(num_layers)
        c_pp, c_p, c = c_cur, c_cur, init_channels
        reduction_prev = False
        for layer in range(num_layers):
            reduction_cur = layer in reductions
            if reduction_cur:
                c *= 2
            gene = (reduce or normal) if reduction_cur else normal
            self.add_module(f"cell{layer}", DerivedCell(gene, c_pp, c_p, c, reduction_prev, reduction_cur, g))
            c_pp, c_p = c_p, len(gene) * c
            reduction_prev = reduction_cur
        self.num_layers = num_layers
        self.classifier = Classifier(c_p, num_classes, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s0 = s1 = batch_norm(self.stem(x))
        for layer in range(self.num_layers):
            s0, s1 = s1, getattr(self, f"cell{layer}")(s0, s1)
        return self.classifier(s1.mean((2, 3)))


def parse_genotype_assignment(value: Any) -> Dict[str, Any]:
    """The genotype as the search prints it (a Python literal: tuples,
    single quotes) or as JSON."""
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return json.loads(value)


def cosine_decay(lr: float, steps: int, count: int) -> float:
    """optax's ``cosine_decay_schedule(lr, steps)`` at update ``count``."""
    return lr * 0.5 * (1.0 + math.cos(math.pi * min(count, steps) / steps))


def make_retrain_step(model: nn.Module, lr: float, momentum: float, weight_decay: float, grad_clip: float,
                      total_steps: int):
    """``step(bx, by)``: one step of weight decay, global-norm clip and SGD
    with momentum at the cosine-decayed learning rate (down to 0 after
    ``total_steps``), convolutions in f32; returns the loss before the
    step as a 0-d tensor on the device."""
    params = list(model.parameters())
    opt = WeightOptimizer(params, weight_decay, momentum, grad_clip)
    count = itertools.count()

    def step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        with f32_convolutions.hold():
            loss = F.cross_entropy(model(bx), by)
            opt.step(torch.autograd.grad(loss, params), cosine_decay(lr, total_steps, next(count)))
        return loss.detach()

    return step


def _batches(n: int, batch_size: int, rng: np.random.Generator, device: torch.device) -> torch.Tensor:
    """One drawn epoch of batches of min(batch_size, n) as device indices."""
    return torch.from_numpy(batch_indices(n, min(batch_size, n), rng)).to(device)


def run_darts_retrain_trial(assignments: Dict[str, str], ctx=None, **overrides) -> None:
    """Trial entry point: train the architecture a DARTS search printed.
    ``genotype`` is the search's ``Best-Genotype``; ``lr``, ``momentum``,
    ``weight_decay``, ``grad_clip``, ``num_epochs``, ``batch_size``,
    ``init_channels``, ``num_layers``, ``stem_multiplier`` and
    ``num_train_examples`` take the JAX trial's defaults. Reports
    ``Validation-accuracy`` (up to 50 batches) and ``Train-loss`` (the
    epoch's last step) each epoch."""
    settings: Dict[str, Any] = dict(assignments)
    settings.update(overrides)
    gene = parse_genotype_assignment(settings.pop("genotype"))
    lr = float(settings.get("lr", 0.025))
    momentum = float(settings.get("momentum", 0.9))
    weight_decay = float(settings.get("weight_decay", 3e-4))
    grad_clip = float(settings.get("grad_clip", 5.0))
    num_epochs = int(float(settings.get("num_epochs", 10)))
    batch_size = int(float(settings.get("batch_size", 96)))
    init_channels = int(float(settings.get("init_channels", 16)))
    num_layers = int(float(settings.get("num_layers", 8)))
    stem_multiplier = int(float(settings.get("stem_multiplier", 3)))
    n_train = int(float(settings.get("num_train_examples", 0) or 0)) or None

    device = trial_device(ctx)
    model = DerivedNetwork(
        normal=gene_from_json(gene["normal"]),
        reduce=gene_from_json(gene["reduce"]) if gene.get("reduce") else None,
        init_channels=init_channels, num_layers=num_layers, stem_multiplier=stem_multiplier,
    ).to(device)
    (x_t, y_t), (x_v, y_v) = cifar_halves(n_train, device)
    steps_per_epoch = max(len(x_t) // batch_size, 1)
    step = make_retrain_step(model, lr, momentum, weight_decay, grad_clip, max(steps_per_epoch * num_epochs, 1))

    rng = np.random.default_rng(0)
    best_acc = 0.0
    for _ in range(num_epochs):
        loss = torch.zeros(())
        for sel in _batches(len(x_t), batch_size, rng, device):
            loss = step(x_t[sel], y_t[sel])
        with torch.no_grad(), f32_convolutions.hold():
            accs = [(model(x_v[sel]).argmax(-1) == y_v[sel]).float().mean()
                    for sel in _batches(len(x_v), batch_size, rng, device)[:50]]
        acc = float(torch.stack(accs).mean()) if accs else 0.0
        best_acc = max(best_acc, acc)
        if ctx is not None:
            ctx.report(**{"Validation-accuracy": acc, "Train-loss": float(loss)})
        else:
            print(f"Validation-accuracy={acc}")
            print(f"Train-loss={float(loss)}")
    print(f"Best-accuracy={best_acc}")
