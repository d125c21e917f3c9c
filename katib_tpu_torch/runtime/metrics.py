"""Metric reporting, collection and early-stopping enforcement — the port's
own copy of ``katib_tpu/runtime/metrics.py``. In-process trial code calls
``ctx.report(loss=...)`` (or ``report_metrics``); the rows land in the
observation store before a kill request or a tripped early-stopping rule
unwinds the trial. A command trial prints ``name=value`` lines, or writes
them to a file, and the collectors' parsers here turn them into rows:
TEXT lines under regex filters (Katib's file-metricscollector and its
default filter, const.go), JSON lines and Prometheus text.

Rule enforcement follows Katib's metrics-collector sidecar
(``updateStopRules``): each rule is dropped once it trips and the trial
stops when every rule has tripped; the objective metric is compared through
its running optimum (max for maximize, min for minimize); a rule with
``start_step`` > 0 is evaluated exactly at the ``start_step``-th report of
its metric, and never after.
"""

from __future__ import annotations

import contextlib
import contextvars
import json
import re
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Sequence

from ..api.spec import ComparisonType, EarlyStoppingRule, ObjectiveType
from ..db.store import InMemoryObservationStore, MetricLog

# Katib's default TEXT filter (const.go): name = value
DEFAULT_FILTER = r"([\w|-]+)\s*=\s*([+-]?\d*(\.\d+)?([Ee][+-]?\d+)?)"
# what the executor tells a command trial: its name, and its metrics file
# under a File collector
ENV_TRIAL_NAME = "KATIB_TPU_TRIAL_NAME"
ENV_METRICS_FILE = "KATIB_TPU_METRICS_FILE"


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


# -- report_metrics ----------------------------------------------------------

_current_reporter: contextvars.ContextVar[Optional[MetricsReporter]] = contextvars.ContextVar(
    "katib_tpu_torch_reporter", default=None)


@contextlib.contextmanager
def current_reporter(reporter: MetricsReporter) -> Iterator[None]:
    """``reporter`` bound to the in-process trial that runs in the block
    (the controller binds it around the trial function)."""
    token = _current_reporter.set(reporter)
    try:
        yield
    finally:
        _current_reporter.reset(token)


def report_metrics(metrics: Optional[Dict[str, float]] = None, **kw: float) -> None:
    """Report metrics from trial code, as Katib's SDK ``report_metrics``.
    Inside an in-process trial the rows go to its reporter; in a command
    trial each value is printed as a ``name=value`` line for the StdOut
    collector. The JAX package's other bindings (framed ingest, RPC,
    SQLite) need stores the port does not have yet."""
    merged = dict(metrics or {})
    merged.update(kw)
    reporter = _current_reporter.get()
    if reporter is not None:
        reporter.report(**merged)
        return
    for k, v in merged.items():
        # normalised, so that the TEXT collector's numeric filter matches
        print(f"{k}={validate_metric_value(k, v)}", flush=True)


# -- the collectors' parsers ---------------------------------------------------

def parse_text_lines(lines: Sequence[str], metric_names: Sequence[str], filters: Optional[Sequence[str]] = None,
                     base_time: Optional[float] = None) -> List[MetricLog]:
    """TEXT collector: regex filters with two groups (name, value); only the
    wanted names are kept. Line i is stamped ``base_time + i * 1e-6``, so
    ``latest`` follows the order of the lines."""
    regs = [re.compile(f) for f in (filters or [DEFAULT_FILTER])]
    wanted = set(metric_names)
    t0 = base_time if base_time is not None else time.time()
    out: List[MetricLog] = []
    for i, line in enumerate(lines):
        for reg in regs:
            for m in reg.finditer(line):
                name = m.group(1).strip()
                value = (m.group(2) or "").strip()
                if name not in wanted or value == "":
                    continue
                out.append(MetricLog(timestamp=t0 + i * 1e-6, metric_name=name, value=value))
    return out


_PROM_LINE_RE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{[^}]*\})?\s+([-+0-9.eEnaifNI]+)(?:\s+\d+)?$")


def parse_prometheus_text(text: str, metric_names: Sequence[str],
                          base_time: Optional[float] = None) -> List[MetricLog]:
    """Prometheus text exposition: the samples of the wanted names, all
    stamped ``base_time`` (one scrape)."""
    wanted = set(metric_names)
    t0 = base_time if base_time is not None else time.time()
    out: List[MetricLog] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _PROM_LINE_RE.match(line)
        if m is None or m.group(1) not in wanted:
            continue
        out.append(MetricLog(timestamp=t0, metric_name=m.group(1), value=m.group(2)))
    return out


def parse_json_lines(lines: Sequence[str], metric_names: Sequence[str],
                     base_time: Optional[float] = None) -> List[MetricLog]:
    """JSON collector: one object per line, values strings or numbers, a
    ``timestamp`` key overriding the line's stamp; lines that do not parse
    are skipped (a trial's output is noisy)."""
    wanted = set(metric_names)
    t0 = base_time if base_time is not None else time.time()
    out: List[MetricLog] = []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line.startswith("{"):
            continue
        try:
            obj = json.loads(line)
        except json.JSONDecodeError:
            continue
        ts = t0 + i * 1e-6
        if "timestamp" in obj:
            try:
                ts = float(obj["timestamp"])
            except (TypeError, ValueError):
                pass
        for k, v in obj.items():
            if k in wanted:
                out.append(MetricLog(timestamp=ts, metric_name=k, value=str(v)))
    return out
