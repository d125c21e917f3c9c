"""DARTS supernet (search network) — the port's own copy of
``katib_tpu/models/darts_supernet.py`` (the reference's model.py Cell and
NetworkCNN, and search_space.py's genotype parse), in NCHW.

- stem: 3x3 convolution to stem_multiplier * init_channels, batch_norm;
- num_layers cells, reduction cells (stride 2, twice the channels) at
  layers [L/3, 2L/3] (L == 2: the second; L == 1: none);
- a cell preprocesses its two inputs (FactorizedReduce after a reduction
  cell, else a 1x1 StdConv), then num_nodes nodes, node i summing 2 + i
  mixed-op edges; its output concatenates the nodes;
- two alpha sets (normal, reduce), one [i + 2, n_ops] matrix per node,
  drawn as 1e-3 * randn and softmaxed per edge in the forward pass; they
  are ``nn.Parameter``s apart from the weights (``weights()`` and
  ``alphas()`` are the two groups), as the JAX package keeps them in their
  own collection;
- genotype: per node the top-2 edges by their best non-'none' op.

Submodules carry the flax tree's names (``stem``, ``cell0``,
``node0_edge1``, ``SepConv_0``, ``classifier``), and ``alpha_normal.0`` is
flax's ``alpha_normal_0``: see ``models.convert.darts_params_from_flax``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.darts_ops import Conv, FactorizedReduce, MixedOp, StdConv, batch_norm, lecun_normal_


def reduction_layers(num_layers: int) -> List[int]:
    if num_layers == 1:
        return []
    if num_layers == 2:
        return [1]
    return [num_layers // 3, 2 * num_layers // 3]


class Classifier(nn.Linear):
    """The dense head: a lecun_normal kernel and a zero bias, as flax's
    ``nn.Dense`` starts."""

    def __init__(self, features_in: int, classes: int, generator: Optional[torch.Generator] = None):
        super().__init__(features_in, classes)
        lecun_normal_(self.weight, generator)
        with torch.no_grad():
            self.bias.zero_()


class Cell(nn.Module):
    def __init__(self, primitives: Sequence[str], num_nodes: int, c_pp: int, c_p: int, channels: int,
                 reduction_prev: bool, reduction_cur: bool, generator: Optional[torch.Generator] = None):
        super().__init__()
        if reduction_prev:
            self.pre0_reduce = FactorizedReduce(c_pp, channels, generator)
        else:
            self.pre0 = StdConv(c_pp, channels, 1, generator=generator)
        self.pre1 = StdConv(c_p, channels, 1, generator=generator)
        self.reduction_prev, self.num_nodes = reduction_prev, num_nodes
        for i in range(num_nodes):
            for j in range(2 + i):
                stride = 2 if reduction_cur and j < 2 else 1
                self.add_module(f"node{i}_edge{j}", MixedOp(primitives, channels, stride, generator))

    def forward(self, s0: torch.Tensor, s1: torch.Tensor, w_dag: Sequence[torch.Tensor]) -> torch.Tensor:
        s0 = self.pre0_reduce(s0) if self.reduction_prev else self.pre0(s0)
        states = [s0, self.pre1(s1)]
        for i in range(self.num_nodes):
            acc = None
            for j in range(2 + i):
                out = getattr(self, f"node{i}_edge{j}")(states[j], w_dag[i][j])
                acc = out if acc is None else acc + out
            states.append(acc)
        return torch.cat(states[2:], dim=1)


class DartsSupernet(nn.Module):
    """The search network over ``primitives`` ('none' last); NCHW images
    in, logits out. Weights and alphas are drawn from ``generator`` (seeded
    0 by default)."""

    def __init__(self, primitives: Sequence[str], init_channels: int = 16, input_channels: int = 3,
                 num_classes: int = 10, num_layers: int = 8, num_nodes: int = 4, stem_multiplier: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.primitives, self.num_nodes = tuple(primitives), num_nodes
        n_ops = len(self.primitives)
        self.alpha_normal = nn.ParameterList(
            [nn.Parameter(1e-3 * torch.randn(i + 2, n_ops, generator=g)) for i in range(num_nodes)])
        self.alpha_reduce = nn.ParameterList(
            [nn.Parameter(1e-3 * torch.randn(i + 2, n_ops, generator=g)) for i in range(num_nodes)]
            if num_layers > 1 else [])
        c_cur = stem_multiplier * init_channels
        self.stem = Conv(input_channels, c_cur, 3, generator=g)
        self.reductions = reduction_layers(num_layers)
        c_pp, c_p, c = c_cur, c_cur, init_channels
        reduction_prev = False
        for layer in range(num_layers):
            reduction_cur = layer in self.reductions
            if reduction_cur:
                c *= 2
            self.add_module(f"cell{layer}", Cell(self.primitives, num_nodes, c_pp, c_p, c, reduction_prev,
                                                 reduction_cur, g))
            c_pp, c_p = c_p, num_nodes * c
            reduction_prev = reduction_cur
        self.num_layers = num_layers
        self.classifier = Classifier(c_p, num_classes, g)

    def alphas(self) -> List[nn.Parameter]:
        """The architecture parameters: normal, then reduce, by node."""
        return list(self.alpha_normal) + list(self.alpha_reduce)

    def named_weights(self) -> List[Tuple[str, nn.Parameter]]:
        """Every parameter that is not an alpha, with its name, in
        ``named_parameters`` order."""
        return [(name, p) for name, p in self.named_parameters() if not name.startswith("alpha_")]

    def weights(self) -> List[nn.Parameter]:
        return [p for _, p in self.named_weights()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w_normal = [F.softmax(a, dim=-1) for a in self.alpha_normal]
        w_reduce = [F.softmax(a, dim=-1) for a in self.alpha_reduce]
        s0 = s1 = batch_norm(self.stem(x))
        for layer in range(self.num_layers):
            w_dag = w_reduce if layer in self.reductions else w_normal
            s0, s1 = s1, getattr(self, f"cell{layer}")(s0, s1, w_dag)
        return self.classifier(s1.mean((2, 3)))


Gene = List[List[Tuple[str, int]]]


def parse_genotype(alphas: Sequence[torch.Tensor], primitives: Sequence[str], k: int = 2) -> Gene:
    """One alpha set as a gene: for each node, each edge's best non-'none'
    op, and the k edges whose best op weighs most (a stable sort: of equal
    weights the lower edge first), in edge order."""
    if primitives[-1] != "none":
        raise ValueError(f"'none' must be the last primitive, got {list(primitives)}")
    gene: Gene = []
    for edges in alphas:
        w = F.softmax(edges.detach().float().cpu(), dim=-1)[:, :-1]
        best_w, best_op = w.max(dim=-1)
        top_edges = torch.argsort(-best_w, stable=True)[:k]
        gene.append([(primitives[int(best_op[e])], int(e)) for e in sorted(map(int, top_edges))])
    return gene


def genotype(model: DartsSupernet) -> Dict[str, Any]:
    """The normal and reduce genes with their concat ranges."""
    concat = list(range(2, 2 + model.num_nodes))
    gene: Dict[str, Any] = {"normal": parse_genotype(list(model.alpha_normal), model.primitives),
                            "normal_concat": concat}
    if len(model.alpha_reduce):
        gene["reduce"] = parse_genotype(list(model.alpha_reduce), model.primitives)
        gene["reduce_concat"] = list(concat)
    return gene
