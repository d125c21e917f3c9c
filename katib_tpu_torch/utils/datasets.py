"""Synthetic MNIST and CIFAR-10 — the port's own copy of
``katib_tpu/utils/datasets.py`` (``_prototype_bank``, ``_synthetic_images``,
``load_mnist``, ``load_cifar10``, and the batch order of ``batches``).

NumPy only, with the same seeds and the same calls in the same order, so
the images, labels and batch order are bit-identical to the JAX package's.
Real CIFAR-10 is read only from the local ``.npz`` that ``KATIB_TPU_CIFAR10``
names (arrays ``x_train``, ``y_train``, ``x_test``, ``y_test``), as in the
JAX package; nothing is downloaded.
The stand-in is calibrated to discriminate: each class is a bank of
prototype patterns mixed per sample, neighbouring classes share their
coarse component, and samples are shifted, scaled, overlaid with another
class's pattern and noised. The difficulty is fixed at the JAX package's
defaults, the values it takes when no ``KATIB_TPU_SYNTH_*`` variable is set
(and so no training label is redrawn at random, CIFAR-10's included).
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

SYNTH_NOISE = 0.45  # per-pixel Gaussian noise
SYNTH_DISTRACTOR = 0.3  # weight of the other class's overlaid pattern
SYNTH_VARIANTS = 4  # prototype patterns per class
CIFAR10_ENV = "KATIB_TPU_CIFAR10"  # path to a local .npz of CIFAR-10


def _prototype_bank(num_classes: int, image_size: int, channels: int, variants: int) -> np.ndarray:
    """[num_classes, variants, S, S, C]: classes c and c+1 share the coarse
    component; the variant's fine component carries the class."""
    yy, xx = np.meshgrid(np.arange(image_size), np.arange(image_size), indexing="ij")
    proto_rng = np.random.default_rng(1234)  # the bank is fixed; samples vary
    bank = np.zeros((num_classes, variants, image_size, image_size, channels), dtype=np.float32)
    for c in range(num_classes):
        shared = c // 2
        fx, fy = 1 + shared % 3, 1 + (shared // 3) % 3
        coarse = np.sin(2 * np.pi * (fx * xx + fy * yy) / image_size + shared * 0.9)
        for v in range(variants):
            gx = int(proto_rng.integers(3, 7))
            gy = int(proto_rng.integers(3, 7))
            psi = float(proto_rng.uniform(0, 2 * np.pi)) + c * 2.1
            fine = np.sin(2 * np.pi * (gx * xx + gy * yy) / image_size + psi)
            for ch in range(channels):
                chan_gain = 0.6 + 0.4 * ((c + ch) % 2)
                bank[c, v, :, :, ch] = (0.5 * coarse + 1.0 * fine) * chan_gain
    return bank


def _synthetic_images(n: int, num_classes: int, image_size: int, channels: int,
                      rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """n images [n, S, S, C] f32 and their int32 labels."""
    variants = SYNTH_VARIANTS
    bank = _prototype_bank(num_classes, image_size, channels, variants)
    ys = rng.integers(0, num_classes, size=n)
    w = rng.dirichlet(np.ones(variants) * 0.7, size=n).astype(np.float32)  # mixture of the class's variants
    xs = np.einsum("nv,nvhwc->nhwc", w, bank[ys])
    offs = rng.integers(1, num_classes, size=n)  # a distractor from another class
    yd = (ys + offs) % num_classes
    vd = rng.integers(0, variants, size=n)
    xs = xs + SYNTH_DISTRACTOR * bank[yd, vd]
    max_shift = max(1, image_size // 4)  # cyclic shift by up to a quarter frame, amplitude jitter
    sh = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
    rows = (np.arange(image_size)[None, :] + sh[:, 0:1]) % image_size
    cols = (np.arange(image_size)[None, :] + sh[:, 1:2]) % image_size
    xs = xs[np.arange(n)[:, None, None], rows[:, :, None], cols[:, None, :], :]
    xs = xs * rng.uniform(0.7, 1.3, size=(n, 1, 1, 1)).astype(np.float32)
    xs = xs + SYNTH_NOISE * rng.standard_normal(xs.shape).astype(np.float32)
    return xs.astype(np.float32), ys.astype(np.int32)


def load_mnist(split: str = "train", n: Optional[int] = None, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """MNIST-shaped data: [n, 28, 28, 1] f32 (NHWC) and int32 labels of 10
    classes; 60 000 train and 10 000 test images unless ``n`` is given."""
    rng = np.random.default_rng(seed if split == "train" else seed + 1)
    count = n if n is not None else (60000 if split == "train" else 10000)
    return _synthetic_images(count, 10, 28, 1, rng)


def load_cifar10(split: str = "train", n: Optional[int] = None, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """CIFAR-10: [n, 32, 32, 3] f32 (NHWC) and int32 labels; the ``.npz``
    that ``KATIB_TPU_CIFAR10`` names if that file exists (NCHW arrays are
    made NHWC, bytes scaled to [-1, 1]), else 50 000 train and 10 000 test
    synthetic images unless ``n`` is given."""
    path = os.environ.get(CIFAR10_ENV)
    if path and os.path.exists(path):
        data = np.load(path)
        x = data[f"x_{split}"].astype(np.float32)
        y = data[f"y_{split}"].astype(np.int32).reshape(-1)
        if x.ndim == 4 and x.shape[1] == 3:
            x = x.transpose(0, 2, 3, 1)
        if x.max() > 2.0:
            x = (x / 127.5) - 1.0
        if n is not None:
            x, y = x[:n], y[:n]
        return x, y
    rng = np.random.default_rng(seed if split == "train" else seed + 1)
    count = n if n is not None else (50000 if split == "train" else 10000)
    return _synthetic_images(count, 10, 32, 3, rng)


_split_lock = threading.Lock()


@functools.lru_cache(maxsize=4)
def _cached_split(load: Callable, split: str, n: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    x, y = load(split, n=n)
    x.setflags(write=False)
    y.setflags(write=False)
    return x, y


def split_on_device(load: Callable, split: str, n: Optional[int],
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``load(split, n=n)`` as (f32 images, int64 labels) on ``device``.
    Every trial of a process trains on the same data, so it is made once
    (60 000 images take seconds of NumPy) and kept, read-only, for the next
    trials."""
    with _split_lock:
        x, y = _cached_split(load, split, n)
    return torch.tensor(x, device=device), torch.tensor(y, dtype=torch.long, device=device)


def cifar10_train_nchw(n: Optional[int], device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """CIFAR-10's training split (``n`` images, all when None) as NCHW f32
    images and int64 labels on ``device``."""
    x, y = split_on_device(load_cifar10, "train", n, device)
    return x.permute(0, 3, 1, 2).contiguous(), y


def batch_indices(n: int, batch_size: int, rng: np.random.Generator) -> np.ndarray:
    """[n // batch_size, batch_size]: one shuffled epoch's sample indices,
    the ragged tail dropped. Draws one permutation of n from ``rng``, also
    when not one batch fits."""
    idx = rng.permutation(n)
    n_batches = n // batch_size
    return idx[: n_batches * batch_size].reshape(n_batches, batch_size)

