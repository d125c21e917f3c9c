"""Push metric reporting and early-stopping enforcement — the port's own
copy of the reporter half of ``katib_tpu/runtime/metrics.py``. Trial code
calls ``ctx.report(loss=...)``; the rows land in the observation store
before a kill request or a tripped early-stopping rule unwinds the trial.
The stdout/file collectors are a later slice.

Rule enforcement follows Katib's metrics-collector sidecar
(``updateStopRules``): each rule is dropped once it trips and the trial
stops when every rule has tripped; the objective metric is compared through
its running optimum (max for maximize, min for minimize); a rule with
``start_step`` > 0 is evaluated exactly at the ``start_step``-th report of
its metric, and never after.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence

from ..api.spec import ComparisonType, EarlyStoppingRule, ObjectiveType
from ..db.store import InMemoryObservationStore, MetricLog


class EarlyStopped(Exception):
    """Raised inside trial code when every early-stopping rule tripped."""


class TrialKilled(Exception):
    """Raised inside trial code when the controller asked for a kill."""


def validate_metric_value(name: str, value: Any) -> float:
    """A reported value as float, or ValueError: a malformed value must fail
    the trial, not reach the store as an unusable objective."""
    try:
        return float(value)
    except (TypeError, ValueError):
        raise ValueError(f"metric {name!r} value {value!r} is not convertible to float") from None


class EarlyStoppingMonitor:
    """The rules of one trial, fed one report at a time."""

    def __init__(self, rules: Sequence[EarlyStoppingRule], objective_metric: str,
                 objective_type: ObjectiveType):
        self.rules = list(rules)
        self.objective_metric = objective_metric
        self.objective_type = objective_type
        self.optimal_obj_value: Optional[float] = None
        self._start_step_left: Dict[str, int] = {r.name: r.start_step for r in rules if r.start_step != 0}
        self._had_rules = False

    def observe(self, metric_name: str, value: float) -> bool:
        """Feed one metric report; True when the trial must stop."""
        if not self.rules:
            return self._had_rules
        self._had_rules = True
        for rule in list(self.rules):
            if rule.name == metric_name:
                self._apply_rule(rule, value)
        return not self.rules

    def _apply_rule(self, rule: EarlyStoppingRule, value: float) -> None:
        if rule.name == self.objective_metric:  # the running optimum stands in for the value
            if self.optimal_obj_value is None:
                self.optimal_obj_value = value
            elif self.objective_type == ObjectiveType.MAXIMIZE:
                self.optimal_obj_value = max(self.optimal_obj_value, value)
            elif self.objective_type == ObjectiveType.MINIMIZE:
                self.optimal_obj_value = min(self.optimal_obj_value, value)
            value = self.optimal_obj_value
        if rule.name in self._start_step_left:
            self._start_step_left[rule.name] -= 1
            if self._start_step_left[rule.name] != 0:
                return
        rule_value = float(rule.value)
        if ((rule.comparison == ComparisonType.EQUAL and value == rule_value)
                or (rule.comparison == ComparisonType.LESS and value < rule_value)
                or (rule.comparison == ComparisonType.GREATER and value > rule_value)):
            self.rules.remove(rule)


@dataclass
class MetricsReporter:
    """Push reporter bound to one trial; checks the kill request, then the
    early-stopping rules, after each write."""

    store: InMemoryObservationStore
    trial_name: str
    kill_event: Optional[Any] = None  # threading.Event set by the controller
    monitor: Optional[EarlyStoppingMonitor] = None
    _stopped: bool = False

    def report(self, timestamp: Optional[float] = None, **metrics: Any) -> None:
        ts = timestamp if timestamp is not None else time.time()
        values = {k: validate_metric_value(k, v) for k, v in metrics.items()}
        self.store.report_observation_log(
            self.trial_name, [MetricLog(timestamp=ts, metric_name=k, value=str(f)) for k, f in values.items()])
        if self.kill_event is not None and self.kill_event.is_set():
            self.store.flush()
            raise TrialKilled(f"trial {self.trial_name} killed")
        if self.monitor is not None:
            for k, f in values.items():
                if self.monitor.observe(k, f):
                    self._stopped = True
        if self._stopped:
            raise EarlyStopped(f"trial {self.trial_name} early stopped")
