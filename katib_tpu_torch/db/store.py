"""Observation-log store — the port's own copy of ``katib_tpu/db/store.py``,
cut to the in-memory store, the min/max/latest fold and objective lookup.

Rows are (timestamp, metric name, value) with the value kept as a string,
as Katib stores them; folding honours timestamps the way Katib's getMetrics
does. The SQLite, buffered and remote stores are later slices.
"""

from __future__ import annotations

import math
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..api.spec import UNAVAILABLE_METRIC_VALUE, Metric, MetricStrategyType, ObjectiveSpec, Observation


@dataclass
class MetricLog:
    timestamp: float
    metric_name: str
    value: str


class InMemoryObservationStore:
    """Thread-safe dict-backed store: trials of one process report into it."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._logs: Dict[str, List[MetricLog]] = {}

    def report_observation_log(self, trial_name: str, logs: Sequence[MetricLog]) -> None:
        with self._lock:
            self._logs.setdefault(trial_name, []).extend(logs)

    def get_observation_log(self, trial_name: str, metric_name: Optional[str] = None,
                            limit: Optional[int] = None) -> List[MetricLog]:
        """The trial's rows in time order, optionally of one metric, and
        with ``limit`` only the first ``limit`` of them (the head read of
        ``earlystop.curves.head_mean``)."""
        with self._lock:
            rows = list(self._logs.get(trial_name, []))
        if metric_name is not None:
            rows = [r for r in rows if r.metric_name == metric_name]
        rows.sort(key=lambda r: r.timestamp)
        return rows if limit is None else rows[:limit]

    def folded(self, trial_name: str, metric_names: Sequence[str]) -> Observation:
        return fold_observation(self.get_observation_log(trial_name), metric_names)

    def flush(self) -> None:
        """Durability barrier; the in-memory store is always durable."""

    def close(self) -> None:
        pass


def _parse_float(value: str) -> Optional[float]:
    try:
        f = float(value)
    except (TypeError, ValueError):
        return None
    return None if math.isnan(f) else f


class _FoldEntry:
    """Running fold of one metric: 'latest' is the last value among the
    rows with the greatest timestamp; min/max skip non-numeric values."""

    __slots__ = ("count", "lo", "hi", "has_numeric", "latest", "best_ts")

    def __init__(self) -> None:
        self.count = 0
        self.lo = math.inf
        self.hi = -math.inf
        self.has_numeric = False
        self.latest: str = UNAVAILABLE_METRIC_VALUE
        self.best_ts = -math.inf

    def add(self, row: MetricLog) -> None:
        self.count += 1
        if row.timestamp >= self.best_ts:
            self.best_ts = row.timestamp
            self.latest = row.value
        f = _parse_float(row.value)
        if f is not None:
            self.has_numeric = True
            self.lo = min(self.lo, f)
            self.hi = max(self.hi, f)

    def metric(self, name: str) -> Metric:
        if self.count == 0:
            return Metric(name=name)
        return Metric(
            name=name,
            min=repr(self.lo) if self.has_numeric else UNAVAILABLE_METRIC_VALUE,
            max=repr(self.hi) if self.has_numeric else UNAVAILABLE_METRIC_VALUE,
            latest=self.latest,
        )


def fold_observation(logs: Sequence[MetricLog], metric_names: Sequence[str]) -> Observation:
    """Fold raw rows into per-metric {min, max, latest}; a metric with no
    parseable value reports 'unavailable'."""
    entries = {name: _FoldEntry() for name in metric_names}
    for row in logs:
        entry = entries.get(row.metric_name)
        if entry is not None:
            entry.add(row)
    return Observation(metrics=[entries[name].metric(name) for name in metric_names])


def objective_value(observation: Optional[Observation], objective: ObjectiveSpec) -> Optional[float]:
    """The objective metric's value under its strategy (min/max/latest)."""
    if observation is None:
        return None
    m = observation.metric(objective.objective_metric_name)
    if m is None:
        return None
    raw = {
        MetricStrategyType.MIN: m.min,
        MetricStrategyType.MAX: m.max,
        MetricStrategyType.LATEST: m.latest,
    }[objective.strategy_for(objective.objective_metric_name)]
    return _parse_float(raw)
