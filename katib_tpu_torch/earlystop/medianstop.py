"""Median-stop rule generator — the port's own copy of
``katib_tpu/earlystop/medianstop.py`` (Katib's
``pkg/earlystopping/v1beta1/medianstop/service.py``).

For each newly succeeded trial it averages the first ``start_step``
objective reports; once ``min_trials_required`` trials are recorded it
emits the rule ``objective <comparison> <aggregate>``, the comparison LESS
for maximize and GREATER for minimize, the aggregate the arithmetic mean of
the per-trial averages (Katib computes a mean despite the name). The rules
are enforced by ``runtime.metrics.EarlyStoppingMonitor``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from ..api.spec import ComparisonType, EarlyStoppingRule, ExperimentSpec, ObjectiveType
from ..api.status import Trial, TrialCondition
from ..db.store import InMemoryObservationStore
from .curves import ObjectiveCurveReader


class MedianStop:
    """One per experiment: it remembers the averages of the trials it has
    read."""

    name = "medianstop"

    DEFAULT_MIN_TRIALS_REQUIRED = 3
    DEFAULT_START_STEP = 4

    def __init__(self) -> None:
        self._avg_history: Dict[str, float] = {}

    def validate_settings(self, experiment: ExperimentSpec) -> None:
        es = experiment.early_stopping
        if es is None:
            return
        for s in es.algorithm_settings:
            if s.name == "min_trials_required":
                if int(s.value) <= 0:
                    raise ValueError("min_trials_required must be greater than zero")
            elif s.name == "start_step":
                if int(s.value) < 1:
                    raise ValueError("start_step must be greater or equal than one")
            else:
                raise ValueError(f"unknown medianstop setting {s.name!r}")

    def get_early_stopping_rules(self, experiment: ExperimentSpec, trials: Sequence[Trial],
                                 store: InMemoryObservationStore) -> List[EarlyStoppingRule]:
        es = experiment.early_stopping
        settings = es.settings_dict() if es else {}
        min_trials = int(settings.get("min_trials_required", self.DEFAULT_MIN_TRIALS_REQUIRED))
        start_step = int(settings.get("start_step", self.DEFAULT_START_STEP))
        comparison = (ComparisonType.LESS if experiment.objective.type == ObjectiveType.MAXIMIZE
                      else ComparisonType.GREATER)
        reader = ObjectiveCurveReader(store, experiment.objective)
        for trial in trials:
            if trial.name in self._avg_history or trial.condition != TrialCondition.SUCCEEDED:
                continue
            avg = reader.head_mean(trial.name, start_step)
            if avg is not None:
                self._avg_history[trial.name] = avg
        if len(self._avg_history) < min_trials:
            return []
        aggregate = sum(self._avg_history.values()) / len(self._avg_history)
        return [EarlyStoppingRule(name=experiment.objective.objective_metric_name, value=str(aggregate),
                                  comparison=comparison, start_step=start_step)]


_EARLY_STOPPERS = {"medianstop": MedianStop}


def create_early_stopper(name: str) -> MedianStop:
    if name not in _EARLY_STOPPERS:
        raise KeyError(f"unknown early-stopping algorithm {name!r}; the port has {sorted(_EARLY_STOPPERS)}")
    return _EARLY_STOPPERS[name]()
