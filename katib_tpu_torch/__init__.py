"""katib_tpu_torch — the PyTorch/CUDA port of katib_tpu.

An experiment runs in-process: a JSON spec goes to
``controller.experiment.ExperimentController``, a suggester proposes
assignments, and each trial either trains on a CUDA device through
hand-written Hopper kernels (``ops/csrc``) or runs as a command in a
subprocess of its own, its metrics read by a collector. The package imports
torch, numpy and the standard library only; it shares no code with
``katib_tpu``.
"""

from .runtime.metrics import report_metrics  # noqa: F401  (Katib's SDK push call)

__version__ = "0.1.0"
