"""MNIST HPO trial — the port's own copy of ``katib_tpu/models/mnist_cnn.py``
(``MnistCNN`` and ``run_mnist_trial``), the conv-conv-fc network of Katib's
pytorch-mnist trial image trained by SGD with momentum.

The model takes NHWC images as the flax model does and runs its layers in
NCHW: 5x5 convolutions with SAME padding (``padding=2``), 2x2 max pools
(28 -> 14 -> 7), then two dense layers. It flattens in (c, h, w) order where
flax flattens (h, w, c); ``models.convert.mnist_params_from_flax`` permutes
the first dense layer's rows to match. The packed variant waits for the
packing slice.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.datasets import batch_indices, load_mnist

_LECUN_TRUNC = 0.87962566103423978  # stddev of a standard normal truncated to [-2, 2]


class MnistCNN(nn.Module):
    """Two convolutions and two dense layers; widths default to the
    reference image's 20/50/500. Kernels are drawn as flax's
    ``lecun_normal`` draws them (truncated normal, std sqrt(1/fan_in)), from
    ``generator`` (seeded 0 by default); biases start at zero."""

    def __init__(self, conv1: int = 20, conv2: int = 50, hidden: int = 500,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.conv1 = nn.Conv2d(1, conv1, 5, padding=2)
        self.conv2 = nn.Conv2d(conv1, conv2, 5, padding=2)
        self.fc1 = nn.Linear(conv2 * 7 * 7, hidden)
        self.fc2 = nn.Linear(hidden, 10)
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        with torch.no_grad():
            for layer in (self.conv1, self.conv2, self.fc1, self.fc2):
                std = (1.0 / layer.weight[0].numel()) ** 0.5 / _LECUN_TRUNC
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2 * std, 2 * std, generator=g)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """[N, 28, 28, 1] images -> [N, 10] logits."""
        x = x.permute(0, 3, 1, 2)
        x = F.max_pool2d(F.relu(self.conv1(x)), 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 2)
        return self.fc2(F.relu(self.fc1(x.flatten(1))))


class _HeldFlag:
    """Holds ``torch.backends.cudnn.allow_tf32`` False while any holder is
    inside ``hold()``. The flag is process-wide and trials run on threads:
    the first holder saves it and the last one puts it back."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._holders = 0
        self._saved = True

    @contextlib.contextmanager
    def hold(self):
        with self._lock:
            if self._holders == 0:
                self._saved = torch.backends.cudnn.allow_tf32
            self._holders += 1
            torch.backends.cudnn.allow_tf32 = False
        try:
            yield
        finally:
            with self._lock:
                self._holders -= 1
                if self._holders == 0:
                    torch.backends.cudnn.allow_tf32 = self._saved


# torch lets cuDNN convolutions run in TF32 by default; the JAX reference
# convolves in full f32, and so does the trial.
f32_convolutions = _HeldFlag()


def make_mnist_train_step(model: MnistCNN, lr: float, momentum: float) -> Callable:
    """``step(bx, by)``: one SGD-with-momentum step on the mean softmax
    cross-entropy, its convolutions in full f32; returns the loss before the
    step as a 0-d tensor on the device. ``torch.optim.SGD`` with dampening 0
    is optax's ``sgd``: ``v = g + m * v; p -= lr * v``."""
    optimizer = torch.optim.SGD(model.parameters(), lr=lr, momentum=momentum)

    def step(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        with f32_convolutions.hold():
            optimizer.zero_grad(set_to_none=True)
            loss = F.cross_entropy(model(bx), by)
            loss.backward()
            optimizer.step()
        return loss.detach()

    return step


_data_lock = threading.Lock()


@functools.lru_cache(maxsize=4)
def _cached_mnist(split: str, n: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    x, y = load_mnist(split, n=n)
    x.setflags(write=False)
    y.setflags(write=False)
    return x, y


def _mnist(split: str, n: Optional[int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split on ``device``. Every trial of a process trains on the same
    data, so it is made once (60 000 images take seconds of NumPy) and
    kept, read-only, for the next trials."""
    with _data_lock:
        x, y = _cached_mnist(split, n)
    return torch.tensor(x, device=device), torch.tensor(y, dtype=torch.long, device=device)


def run_mnist_trial(assignments: Dict[str, str], ctx=None) -> None:
    """Entry point: ``lr`` and ``momentum`` (and ``batch_size``,
    ``num_epochs``, ``num_train_examples``), with the JAX trial's defaults;
    reports ``loss`` (the epoch's mean training loss) and ``accuracy`` (the
    mean of per-batch test accuracy) once per epoch. The data stays on the
    trial's device; one ``np.random.default_rng(0)`` orders the training
    batches and then the test batches of each epoch, as in the JAX trial."""
    lr = float(assignments.get("lr", "0.01"))
    momentum = float(assignments.get("momentum", "0.5"))
    batch_size = int(assignments.get("batch_size", "64"))
    num_epochs = int(assignments.get("num_epochs", "1"))
    n_train = int(assignments.get("num_train_examples", "0")) or None

    devices = ctx.torch_devices() if ctx is not None else []
    if devices:
        device = devices[0]
    else:
        from ..utils.backend import require_devices

        device = require_devices()[0]
    x, y = _mnist("train", n_train, device)
    x_test, y_test = _mnist("test", n_train // 5 if n_train else None, device)

    model = MnistCNN().to(device)
    step = make_mnist_train_step(model, lr, momentum)

    @torch.no_grad()
    def accuracy(bx: torch.Tensor, by: torch.Tensor) -> torch.Tensor:
        return (model(bx).argmax(-1) == by).float().mean()

    rng = np.random.default_rng(0)
    with f32_convolutions.hold():
        for _ in range(num_epochs):
            train_idx = torch.from_numpy(batch_indices(len(x), batch_size, rng)).to(device)
            losses = [step(x[sel], y[sel]) for sel in train_idx]
            test_idx = torch.from_numpy(batch_indices(len(x_test), batch_size, rng)).to(device)
            accs = [accuracy(x_test[sel], y_test[sel]) for sel in test_idx]
            if not accs and len(x_test):  # test split smaller than one batch
                accs = [accuracy(x_test, y_test)]
            metrics = {
                "loss": float(torch.stack(losses).mean()) if losses else float("nan"),
                "accuracy": float(torch.stack(accs).mean()) if accs else 0.0,
            }
            if ctx is not None:
                ctx.report(**metrics)
            else:
                print(f"loss={metrics['loss']}")
                print(f"accuracy={metrics['accuracy']}")
