"""Learning-curve reads over the observation store — the port's own copy of
``katib_tpu/earlystop/curves.py``, cut to the head mean that median stop
reads."""

from __future__ import annotations

from typing import Optional

from ..api.spec import ObjectiveSpec
from ..db.store import InMemoryObservationStore


class ObjectiveCurveReader:
    """Objective-metric curve reads for one experiment's objective."""

    def __init__(self, store: InMemoryObservationStore, objective: ObjectiveSpec):
        self.store = store
        self.objective = objective

    def head_mean(self, trial_name: str, start_step: int) -> Optional[float]:
        """Mean of the trial's first ``start_step`` objective reports,
        skipping non-numeric values; None when none is numeric."""
        first = self.store.get_observation_log(
            trial_name, metric_name=self.objective.objective_metric_name, limit=start_step)
        values = []
        for log in first:
            try:
                values.append(float(log.value))
            except ValueError:
                continue
        if not values:
            return None
        return sum(values) / len(values)
