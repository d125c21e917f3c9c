"""Full-f32 convolutions for the trials whose JAX references convolve in f32.

torch lets cuDNN convolve f32 tensors in TF32 by default (10-bit mantissa);
the JAX package computes them in full f32. The MNIST and DARTS trials take
``f32_convolutions.hold()`` around their steps, double backward included.
"""

from __future__ import annotations

import contextlib
import threading

import torch


class HeldFlag:
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


f32_convolutions = HeldFlag()
