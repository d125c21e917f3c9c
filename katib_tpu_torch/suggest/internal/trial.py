"""Trial-history view passed to the suggesters — the port's own copy of
``katib_tpu/suggest/internal/trial.py``. Completed (Succeeded or
EarlyStopped) trials become training data; the full history is passed on
every call, so a suggester keeps no state between calls."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ...api.spec import ObjectiveSpec
from ...api.status import Trial, TrialCondition
from ...db.store import objective_value


@dataclass
class ObservedTrial:
    name: str
    assignments: Dict[str, str]
    objective: Optional[float]
    labels: Dict[str, str] = field(default_factory=dict)
    condition: TrialCondition = TrialCondition.SUCCEEDED


def completed_trials(
    trials: Sequence[Trial], objective: ObjectiveSpec, include_early_stopped: bool = True
) -> List[ObservedTrial]:
    wanted = {TrialCondition.SUCCEEDED}
    if include_early_stopped:
        wanted.add(TrialCondition.EARLY_STOPPED)
    return [
        ObservedTrial(
            name=t.name,
            assignments=t.assignments_dict(),
            objective=objective_value(t.observation, objective),
            labels=dict(t.labels),
            condition=t.condition,
        )
        for t in trials
        if t.condition in wanted
    ]
