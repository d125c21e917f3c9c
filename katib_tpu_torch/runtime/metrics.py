"""Push metric reporting — the port's own copy of the reporter half of
``katib_tpu/runtime/metrics.py``. Trial code calls ``ctx.report(loss=...)``;
the rows land in the observation store before any kill request unwinds the
trial. Early-stopping rules and the stdout/file collectors are later
slices; ``EarlyStopped`` is here so trial code can end a trial early."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Optional

from ..db.store import InMemoryObservationStore, MetricLog


class EarlyStopped(Exception):
    """Raised inside trial code to end the trial as EarlyStopped."""


class TrialKilled(Exception):
    """Raised inside trial code when the controller asked for a kill."""


def validate_metric_value(name: str, value: Any) -> float:
    """A reported value as float, or ValueError: a malformed value must fail
    the trial, not reach the store as an unusable objective."""
    try:
        return float(value)
    except (TypeError, ValueError):
        raise ValueError(f"metric {name!r} value {value!r} is not convertible to float") from None


@dataclass
class MetricsReporter:
    """Push reporter bound to one trial."""

    store: InMemoryObservationStore
    trial_name: str
    kill_event: Optional[Any] = None  # threading.Event set by the controller

    def report(self, timestamp: Optional[float] = None, **metrics: Any) -> None:
        ts = timestamp if timestamp is not None else time.time()
        logs = [MetricLog(timestamp=ts, metric_name=k, value=str(validate_metric_value(k, v)))
                for k, v in metrics.items()]
        self.store.report_observation_log(self.trial_name, logs)
        if self.kill_event is not None and self.kill_event.is_set():
            self.store.flush()
            raise TrialKilled(f"trial {self.trial_name} killed")
