"""How many new trials the controller asks the suggester for — the port's
own copy of ``katib_tpu/controller/suggestion.py:suggestion_request_plan``
(Katib's ReconcileTrials).

``add_count = min(maxTrialCount - completed, parallelTrialCount) - active``,
where ``completed`` counts Succeeded, Failed, Killed and EarlyStopped trials
(not MetricsUnavailable ones) and ``active`` every trial that is not
terminal. A trial that ends MetricsUnavailable thus frees its place in the
budget, so the experiment can make more than ``maxTrialCount`` trials, as
Katib's does.
"""

from __future__ import annotations

from typing import Sequence

from ..api.status import TRIAL_TERMINAL, Experiment, Trial, TrialCondition

COMPLETED = frozenset({
    TrialCondition.SUCCEEDED,
    TrialCondition.FAILED,
    TrialCondition.KILLED,
    TrialCondition.EARLY_STOPPED,
})


def suggestion_request_plan(exp: Experiment, trials: Sequence[Trial]) -> int:
    """The number of new trials to ask for now (0 or less: none)."""
    parallel = exp.spec.parallel_trial_count or 1
    completed = sum(t.condition in COMPLETED for t in trials)
    active = sum(t.condition not in TRIAL_TERMINAL for t in trials)
    if exp.spec.max_trial_count is None:
        return parallel - active
    return min(exp.spec.max_trial_count - completed, parallel) - active
