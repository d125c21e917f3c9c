"""DARTS bilevel search — the port's own copy of
``katib_tpu/models/darts_trainer.py`` (the reference's darts-cnn-cifar10
run_trial.py train loop and architect.py's second-order alpha gradient).

One search step, as the JAX step does it:

1. the alpha gradient of the unrolled objective
   (``architect_alpha_grad``): a virtual SGD step w' = w - xi (momentum
   trace * mu + dw L_train + wd w), the validation gradients at (w',
   alpha), and the mixed Hessian-vector product d2/dalpha dw L_train . dw';
2. Adam on the alphas (weight decay added first, b1 0.5, b2 0.999);
3. the weights' step on the training batch at the new alphas: weight decay
   added, the global norm clipped, then SGD with momentum at the cosine
   learning rate xi of the step.

The JAX package computes the Hessian-vector product forward over reverse
(``jax.jvp`` of the alpha gradient along dw'); here it is reverse over
forward, the alpha gradient of the training loss's derivative along dw'
(``mixed_hessian_vector``), the same product by the symmetry of second
derivatives. ``"fd"`` is the reference's central difference. The virtual weights live in a second
supernet, so no step swaps parameters. Both optimisers are written out:
``torch.optim.SGD`` does not clip between weight decay and momentum.
Convolutions run in full f32 (``utils.precision``). The JAX trainer's cache
of compiled steps and its mesh have no counterpart: the port trains on one
device, and validation refuses ``numDevices`` > 1.
"""

from __future__ import annotations

import copy
import json
import logging
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD
import torch.nn.functional as F
from torch.func import functional_call

from ..utils.backend import trial_device
from ..utils.datasets import batch_indices, cifar10_train_nchw
from ..utils.precision import f32_convolutions
from .darts_supernet import DartsSupernet, genotype

log = logging.getLogger("katib_tpu_torch.darts")

Batch = Tuple[torch.Tensor, torch.Tensor]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(list(tensors))))


class WeightOptimizer:
    """optax's ``add_decayed_weights(wd) -> clip_by_global_norm(clip) ->
    sgd(lr, momentum)``: g += wd p; g *= clip / |g| when |g| >= clip;
    trace = g + momentum trace; p -= lr trace. ``trace`` is the momentum
    buffer that the virtual step reads."""

    def __init__(self, params: Sequence[torch.Tensor], weight_decay: float, momentum: float, grad_clip: float):
        self.params = list(params)
        self.weight_decay, self.momentum, self.grad_clip = weight_decay, momentum, grad_clip
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], lr: float) -> None:
        g = torch._foreach_add(list(grads), self.params, alpha=self.weight_decay)
        norm = global_norm(g)
        torch._foreach_mul_(g, torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm))
        torch._foreach_mul_(self.trace, self.momentum)
        torch._foreach_add_(self.trace, g)
        torch._foreach_add_(self.params, self.trace, alpha=-lr)


class AlphaOptimizer:
    """optax's ``add_decayed_weights(wd) -> adam(lr, b1=0.5, b2=0.999,
    eps=1e-8)``."""

    def __init__(self, params: Sequence[torch.Tensor], weight_decay: float, lr: float,
                 b1: float = 0.5, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.weight_decay, self.lr, self.b1, self.b2, self.eps = weight_decay, lr, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        g = torch._foreach_add(list(grads), self.params, alpha=self.weight_decay)
        self.count += 1
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, g, g, value=1 - self.b2)
        mu_hat = torch._foreach_div(self.mu, 1 - self.b1 ** self.count)
        denom = torch._foreach_sqrt(torch._foreach_div(self.nu, 1 - self.b2 ** self.count))
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, mu_hat, denom, value=-self.lr)


def _cross_entropy_along(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``F.cross_entropy`` written out, for dual logits: the forward-mode
    formulas of torch's softmax family update a saved tensor in place, which
    the reverse pass over them then refuses."""
    shift = logits.detach().amax(-1, keepdim=True)
    log_norm = (logits - shift).exp().sum(-1).log() + shift[:, 0]
    return (log_norm - logits.gather(1, labels[:, None])[:, 0]).mean()


def mixed_hessian_vector(model: DartsSupernet, direction: Sequence[torch.Tensor],
                         batch: Batch) -> Tuple[torch.Tensor, ...]:
    """d/dalpha <dw L(w, alpha), direction> at ``model``'s weights and
    alphas: the training loss's derivative along ``direction`` in weight
    space, by forward-mode AD (weights as dual tensors), then its gradient
    in the alphas by reverse mode. No double backward: torch's double
    backward of a depthwise convolution loops over its channels, one
    convolution each."""
    with fwAD.dual_level():
        duals = {name: fwAD.make_dual(w.detach(), d) for (name, w), d in zip(model.named_weights(), direction)}
        loss = _cross_entropy_along(functional_call(model, duals, (batch[0],)), batch[1])
        along = fwAD.unpack_dual(loss).tangent
    return torch.autograd.grad(along, model.alphas())


def architect_alpha_grad(model: DartsSupernet, virtual: DartsSupernet, momentum_buf: Sequence[torch.Tensor],
                         train_batch: Batch, valid_batch: Batch, xi: float, w_momentum: float,
                         w_weight_decay: float, hessian_mode: str = "jvp") -> List[torch.Tensor]:
    """dalpha L_val(w', alpha) - xi d2/dalpha dw L_train(w, alpha) . dw'
    L_val(w', alpha) at ``model``'s weights and alphas, one tensor per
    alpha. ``virtual`` is a supernet of the same shape, overwritten with w'
    (and, for "fd", with w +- eps dw')."""
    if hessian_mode not in ("jvp", "fd"):
        raise ValueError(f"unknown hessian_mode {hessian_mode!r} (jvp|fd)")
    weights, alphas = model.weights(), model.alphas()
    v_weights, v_alphas = virtual.weights(), virtual.alphas()
    g_w = torch.autograd.grad(F.cross_entropy(model(train_batch[0]), train_batch[1]), weights)
    with torch.no_grad():
        step = torch._foreach_mul(list(momentum_buf), w_momentum)
        torch._foreach_add_(step, g_w)
        torch._foreach_add_(step, weights, alpha=w_weight_decay)
        torch._foreach_mul_(step, xi)
        torch._foreach_copy_(v_weights, weights)
        torch._foreach_sub_(v_weights, step)
        torch._foreach_copy_(v_alphas, alphas)
    grads = torch.autograd.grad(F.cross_entropy(virtual(valid_batch[0]), valid_batch[1]), v_weights + v_alphas)
    dw, dalpha = grads[:len(v_weights)], grads[len(v_weights):]
    if hessian_mode == "jvp":
        hessian = mixed_hessian_vector(model, dw, train_batch)
    else:
        eps = 0.01 / (global_norm(dw) + 1e-12)
        scaled = torch._foreach_mul(list(dw), eps)

        def alpha_grad_at(sign: float):
            with torch.no_grad():
                torch._foreach_copy_(v_weights, weights)
                torch._foreach_add_(v_weights, scaled, alpha=sign)
            return torch.autograd.grad(F.cross_entropy(virtual(train_batch[0]), train_batch[1]), v_alphas)

        a_pos, a_neg = alpha_grad_at(1.0), alpha_grad_at(-1.0)
        hessian = [(p - n) / (2.0 * eps) for p, n in zip(a_pos, a_neg)]
    return [da - xi * h for da, h in zip(dalpha, hessian)]


class DartsSearch:
    """The alternating bilevel optimisation (the reference's run_trial.py
    train loop) on one device; settings as the JAX ``DartsSearch`` reads
    them."""

    def __init__(self, primitives: Sequence[str], num_layers: int = 8, settings: Optional[Dict[str, Any]] = None,
                 input_channels: int = 3, num_classes: int = 10, seed: int = 0,
                 device: Optional[torch.device] = None):
        s = dict(settings or {})
        self.num_epochs = int(s.get("num_epochs", 50) or 50)
        self.w_lr = float(s.get("w_lr", 0.025))
        self.w_lr_min = float(s.get("w_lr_min", 0.001))
        self.w_momentum = float(s.get("w_momentum", 0.9))
        self.w_weight_decay = float(s.get("w_weight_decay", 3e-4))
        self.w_grad_clip = float(s.get("w_grad_clip", 5.0))
        self.alpha_lr = float(s.get("alpha_lr", 3e-4))
        self.alpha_weight_decay = float(s.get("alpha_weight_decay", 1e-3))
        self.batch_size = int(s.get("batch_size", 128) or 128)
        self.init_channels = int(s.get("init_channels", 16))
        self.num_nodes = int(s.get("num_nodes", 4))
        self.stem_multiplier = int(s.get("stem_multiplier", 3))
        # pins the cosine schedule's horizon apart from the run's length
        self.schedule_horizon = int(s.get("schedule_horizon", 0) or 0)
        # checked here: HPO assignments bypass the suggester's validation
        self.hessian_mode = str(s.get("hessian_mode", "jvp") or "jvp").strip().lower()
        if self.hessian_mode not in ("jvp", "fd"):
            raise ValueError(f"hessian_mode must be 'jvp' or 'fd', got {s.get('hessian_mode')!r}")
        if str(s.get("remat_cells", "")).strip().lower() in ("1", "true", "yes", "on"):  # the JAX trainer's opt-in
            raise ValueError("remat_cells is not part of the port: the search step keeps every cell's "
                             "activations (leave remat_cells unset or false)")
        prims = list(primitives)
        if "none" not in prims:
            prims.append("none")  # as the reference's search_space.py appends it
        self.primitives = prims
        self.num_layers, self.input_channels, self.num_classes = num_layers, input_channels, num_classes
        self.seed = seed
        self.device = device if device is not None else trial_device(None)
        self.model: Optional[DartsSupernet] = None

    def build(self, total_steps: int) -> None:
        self.model = DartsSupernet(
            self.primitives, init_channels=self.init_channels, input_channels=self.input_channels,
            num_classes=self.num_classes, num_layers=self.num_layers, num_nodes=self.num_nodes,
            stem_multiplier=self.stem_multiplier, generator=torch.Generator().manual_seed(self.seed),
        ).to(self.device)
        self.virtual = copy.deepcopy(self.model)
        self.total_steps = max(self.schedule_horizon or total_steps, 1)
        self.w_opt = WeightOptimizer(self.model.weights(), self.w_weight_decay, self.w_momentum, self.w_grad_clip)
        self.a_opt = AlphaOptimizer(self.model.alphas(), self.alpha_weight_decay, self.alpha_lr)
        self.step_idx = 0

    def lr(self) -> float:
        """The cosine learning rate (the reference's lr_scheduler), also the
        virtual step's xi: w_lr_min + (w_lr - w_lr_min) (1 + cos(pi t/T)) / 2."""
        frac = min(max(self.step_idx / self.total_steps, 0.0), 1.0)
        return self.w_lr_min + (self.w_lr - self.w_lr_min) * 0.5 * (1.0 + math.cos(math.pi * frac))

    def step(self, train_batch: Batch, valid_batch: Batch) -> torch.Tensor:
        """One search step; returns the training loss at the new alphas,
        before the weights' update, as a 0-d tensor on the device."""
        xi = self.lr()
        with f32_convolutions.hold():
            dalpha = architect_alpha_grad(self.model, self.virtual, self.w_opt.trace, train_batch, valid_batch,
                                          xi, self.w_momentum, self.w_weight_decay, self.hessian_mode)
            self.a_opt.step(dalpha)
            loss = F.cross_entropy(self.model(train_batch[0]), train_batch[1])
            self.w_opt.step(torch.autograd.grad(loss, self.model.weights()), xi)
        self.step_idx += 1
        return loss.detach()

    def epoch_indices(self, n: int, rng: np.random.Generator) -> torch.Tensor:
        """One epoch's batches as [batches, batch] indices on the device: a
        split smaller than a batch is one batch, in order, and draws
        nothing; else ``batch_indices`` (the ragged tail dropped)."""
        if n < self.batch_size:
            return torch.arange(n, device=self.device)[None]
        return torch.from_numpy(batch_indices(n, self.batch_size, rng)).to(self.device)

    def train_epoch(self, train_data: Batch, valid_data: Batch, rng: np.random.Generator) -> float:
        """One epoch of alternating updates; the mean training loss. Draws
        the train permutation, then the valid one (again when it runs out)."""
        (x_t, y_t), (x_v, y_v) = train_data, valid_data
        train_idx = self.epoch_indices(len(x_t), rng)
        valid_idx, v = self.epoch_indices(len(x_v), rng), 0
        losses = []
        t0 = time.perf_counter()
        for sel in train_idx:
            if v == len(valid_idx):
                valid_idx, v = self.epoch_indices(len(x_v), rng), 0
            losses.append(self.step((x_t[sel], y_t[sel]), (x_v[valid_idx[v]], y_v[valid_idx[v]])))
            v += 1
        mean = float(torch.stack(losses).mean())
        seconds = time.perf_counter() - t0
        log.info("%d search steps in %.3f s, %.2f ms/step", len(losses), seconds, 1e3 * seconds / len(losses))
        return mean

    @torch.no_grad()
    def validate(self, valid_data: Batch, rng: np.random.Generator, max_batches: int = 50) -> float:
        """Mean accuracy over up to ``max_batches`` batches of one drawn epoch
        (batch statistics, as in training)."""
        x_v, y_v = valid_data
        with f32_convolutions.hold():
            accs = [(self.model(x_v[sel]).argmax(-1) == y_v[sel]).float().mean()
                    for sel in self.epoch_indices(len(x_v), rng)[:max_batches]]
        return float(torch.stack(accs).mean()) if accs else 0.0

    def genotype(self) -> Dict[str, Any]:
        return genotype(self.model)


def _search_and_report(search: DartsSearch, train_data: Batch, valid_data: Batch, ctx) -> float:
    """The epoch loop: search, validate, report ``Validation-accuracy`` and
    ``Train-loss`` each epoch; one ``default_rng(0)`` draws every epoch's
    train, valid and validation permutations, in that order."""
    rng = np.random.default_rng(0)
    best_acc = 0.0
    for _ in range(search.num_epochs):
        loss = search.train_epoch(train_data, valid_data, rng)
        acc = search.validate(valid_data, rng)
        best_acc = max(best_acc, acc)
        if ctx is not None:
            ctx.report(**{"Validation-accuracy": acc, "Train-loss": loss})
        else:
            print(f"Validation-accuracy={acc}")
            print(f"Train-loss={loss}")
    return best_acc


def cifar_halves(n_train: Optional[int], device: torch.device) -> Tuple[Batch, Batch]:
    """CIFAR-10's training split as NCHW on ``device``, cut in halves: the
    search's (or retrain's) train and valid data."""
    x, y = cifar10_train_nchw(n_train, device)
    half = len(x) // 2
    return (x[:half], y[:half]), (x[half:], y[half:])


DARTS_HPO_DEFAULT_PRIMITIVES = (
    "separable_convolution_3x3",
    "max_pooling_3x3",
    "skip_connection",
)


def _run_search(primitives: Sequence[str], num_layers: int, settings: Dict[str, Any], ctx) -> DartsSearch:
    device = trial_device(ctx)
    search = DartsSearch(primitives=primitives, num_layers=num_layers, settings=settings, device=device)
    n_train = int(settings.get("num_train_examples", 0) or 0) or None
    train_data, valid_data = cifar_halves(n_train, device)
    search.build(max(len(train_data[0]) // search.batch_size, 1) * search.num_epochs)
    best_acc = _search_and_report(search, train_data, valid_data, ctx)
    print(f"Best-accuracy={best_acc}")
    return search


def run_darts_hpo_trial(assignments: Dict[str, str], ctx=None, **overrides) -> None:
    """HPO entry point: the assignments are DartsSearch settings (w_lr,
    alpha_lr, w_momentum, ...) from an HPO suggester, plus ``num_layers``
    (default 3) and ``primitives``."""
    settings: Dict[str, Any] = dict(assignments)
    settings.update(overrides)
    num_layers = int(settings.pop("num_layers", 3))
    primitives = settings.pop("primitives", list(DARTS_HPO_DEFAULT_PRIMITIVES))
    _run_search(primitives, num_layers, settings, ctx)


def run_darts_trial_scaled(assignments: Dict[str, str], ctx=None, **overrides) -> None:
    """``run_darts_trial`` with ``overrides`` laid over the suggestion's
    algorithm settings."""
    settings = json.loads(assignments["algorithm-settings"].replace("'", '"'))
    settings.update(overrides)
    assignments = dict(assignments)
    assignments["algorithm-settings"] = json.dumps(settings)
    run_darts_trial(assignments, ctx)


def run_darts_trial(assignments: Dict[str, str], ctx=None) -> None:
    """Trial entry point of the darts suggester's assignments
    (``algorithm-settings``, ``search-space``, ``num-layers``): runs the
    search, reports each epoch, then prints ``Best-accuracy`` and
    ``Best-Genotype``."""
    settings = json.loads(assignments["algorithm-settings"].replace("'", '"'))
    search_space = json.loads(assignments["search-space"].replace("'", '"'))
    search = _run_search(search_space, int(assignments["num-layers"]), settings, ctx)
    print(f"Best-Genotype={search.genotype()}")
