"""What a trial function receives — the port's own copy of
``katib_tpu/runtime/context.py``, with ``torch_devices()`` in place of
``jax_devices()`` and ``mesh()``. ``checkpoint_dir`` is the trial's PBT
lineage directory (None for other algorithms); ``workdir`` a command
trial's directory, where its ``stdout.log`` is written."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import torch

from .metrics import MetricsReporter


@dataclass
class TrialContext:
    trial_name: str
    experiment_name: str
    assignments: Dict[str, str]
    reporter: MetricsReporter
    devices: Optional[List[Any]] = None  # the device slots allocated to this trial
    checkpoint_dir: Optional[str] = None
    workdir: Optional[str] = None

    def report(self, **metrics: float) -> None:
        """Push metrics to the observation store; raises TrialKilled when
        the controller asked for a kill (after the metrics are stored)."""
        self.reporter.report(**metrics)

    def torch_devices(self) -> List[torch.device]:
        """The trial's allocated slots that are torch devices; empty when the
        controller allocated none (the trial then asks the backend probe)."""
        return [d for d in (self.devices or []) if isinstance(d, torch.device)]
