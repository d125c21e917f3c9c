"""katib_tpu_torch — the PyTorch/CUDA port of katib_tpu.

One HPO experiment runs in-process: a JSON spec goes to
``controller.experiment.ExperimentController``, a NumPy suggester (TPE,
random) proposes assignments, and each trial trains on a CUDA device through
hand-written Hopper kernels (``ops/csrc``). The package imports torch, numpy
and the standard library only; it shares no code with ``katib_tpu``.
"""

__version__ = "0.1.0"
