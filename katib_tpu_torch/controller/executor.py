"""Command trials — the port's own copy of the subprocess half of
``katib_tpu/controller/executor.py`` and of the condition rule of
``katib_tpu/controller/scheduler.py`` (``_apply_conditions``).

A command template's trial runs as a process of its own, in the place of
Katib's trial job and its metrics-collector sidecar:

- ``render_command`` substitutes ``${trialParameters.x}`` through the
  template's trial parameters to the assignments, and ``${trialSpec.*}``
  to the trial's metadata (Katib's manifest/generator.go);
- ``SubprocessExecutor`` starts the process in a session of its own, its
  stdout and stderr in ``<trial dir>/stdout.log``, and with
  ``CUDA_VISIBLE_DEVICES`` naming the CUDA cards of the trial's slots (``""``
  for CPU slots): a program the port does not control gets the trial's
  cards as a Katib trial pod gets its GPU limit. While it runs the executor
  tails the watched file for the early-stopping rules, scrapes a Prometheus
  endpoint, and ends the process group on a kill request or a tripped
  rule (SIGTERM, then SIGKILL after 10 s). When it has exited, the
  collector reads its metrics: StdOut and File (TEXT or JSON lines),
  TfEvent, or a Custom collector's program;
- ``apply_conditions`` classifies the finished trial by its success and
  failure conditions (controller/conditions.py).

Not here, each for a later slice: the pid files of crash recovery,
telemetry, tracing, the profile variable, the SQLite drain of pushed
metrics and the multi-host gang executor.
"""

from __future__ import annotations

import logging
import os
import re
import signal
import subprocess
import threading
import time
from dataclasses import dataclass
from enum import Enum
from typing import Any, Dict, List, Optional, Sequence

import torch

from ..api.spec import UNAVAILABLE_METRIC_VALUE, CollectorKind, ExperimentSpec, Observation, TrialTemplate
from ..api.status import Experiment, Trial
from ..api.validation import META_PARAM_RE, TRIAL_PARAM_RE
from ..db.store import InMemoryObservationStore, MetricLog
from ..runtime.context import TrialContext
from ..runtime.metrics import (
    ENV_METRICS_FILE,
    ENV_TRIAL_NAME,
    EarlyStoppingMonitor,
    parse_json_lines,
    parse_prometheus_text,
    parse_text_lines,
)
from .conditions import ConditionError, evaluate_condition

log = logging.getLogger("katib_tpu_torch.executor")

CONDITION_STDOUT_TAIL = 65536  # bytes of a trial's stdout that its conditions see
SIGKILL_MESSAGE = "process killed by SIGKILL (rc=-9) — likely OOM-killed by the kernel"


class TrialOutcome(str, Enum):
    COMPLETED = "completed"  # the process or function finished
    EARLY_STOPPED = "early_stopped"
    FAILED = "failed"
    KILLED = "killed"


@dataclass
class ExecutionResult:
    outcome: TrialOutcome
    message: str = ""
    # the terminal state that success and failure conditions read
    exit_code: Optional[int] = None
    stdout_path: Optional[str] = None


def render_command(template: TrialTemplate, trial: Trial) -> List[str]:
    """The template's argv with its placeholders substituted (Katib's
    applyParameters): ``${trialParameters.x}`` through the trial parameter
    named x to the assignment it references, ``${trialSpec.*}`` to the
    trial's name, namespace (the experiment) or a label."""
    assignments = trial.assignments_dict()
    ref_by_name = {tp.name: tp.reference for tp in template.trial_parameters}

    def sub_param(m: re.Match) -> str:
        name = m.group(1)
        ref = ref_by_name.get(name, name)
        if ref in assignments:
            return assignments[ref]
        if name in assignments:
            return assignments[name]
        raise KeyError(f"unresolved trial parameter placeholder {name!r}")

    def sub_meta(m: re.Match) -> str:
        key = m.group(1)
        if key == "Name":
            return trial.name
        if key == "Namespace":
            return trial.experiment_name
        if key.startswith("Labels["):
            return trial.labels.get(key[len("Labels["):-1], "")
        return ""

    return [META_PARAM_RE.sub(sub_meta, TRIAL_PARAM_RE.sub(sub_param, arg)) for arg in template.command or []]


def cuda_visible_devices(slots: Sequence[Any], parent: Optional[str] = None) -> str:
    """``CUDA_VISIBLE_DEVICES`` for a child that holds ``slots``: the CUDA
    indices of the slots that are CUDA devices, as this process's own
    ``CUDA_VISIBLE_DEVICES`` (``parent``) names them when it is set; ``""``
    when no slot is a CUDA device."""
    indices = [s.index or 0 for s in slots if isinstance(s, torch.device) and s.type == "cuda"]
    if parent is not None:
        visible = [v.strip() for v in parent.split(",") if v.strip()]
        return ",".join(visible[i] for i in indices)
    return ",".join(str(i) for i in indices)


def apply_conditions(template: TrialTemplate, result: ExecutionResult, observation: Observation) -> ExecutionResult:
    """The trial's own success and failure conditions over its terminal
    state: failure first, then success, else the default classification.
    A met failure condition fails the trial whatever its exit code; a met
    success condition passes it whatever its exit code; an unmet success
    condition fails it, since a process that has exited sends no more state
    (Katib's job_util.go would keep such a job Running). Killed and
    early-stopped trials are the controller's doing and are left as they
    are; a condition that does not evaluate counts as not met."""
    if not (template.success_condition or template.failure_condition):
        return result
    if result.outcome not in (TrialOutcome.COMPLETED, TrialOutcome.FAILED):
        return result
    metrics: Dict[str, float] = {}
    for m in observation.metrics:
        if m.latest != UNAVAILABLE_METRIC_VALUE:
            try:
                metrics[m.name] = float(m.latest)
            except ValueError:
                pass
    stdout = ""
    if result.stdout_path:
        try:
            with open(result.stdout_path, "rb") as f:
                f.seek(0, 2)
                f.seek(max(0, f.tell() - CONDITION_STDOUT_TAIL))
                stdout = f.read().decode(errors="replace")
        except OSError:
            pass
    state = dict(exit_code=result.exit_code, outcome=result.outcome.value, metrics=metrics, stdout=stdout)
    if template.failure_condition:
        try:
            if evaluate_condition(template.failure_condition, **state):
                return ExecutionResult(TrialOutcome.FAILED, f"failure condition met: {template.failure_condition}",
                                       exit_code=result.exit_code, stdout_path=result.stdout_path)
        except ConditionError as e:
            log.warning("trial failure condition error: %s", e)
    if template.success_condition:
        try:
            met = evaluate_condition(template.success_condition, **state)
        except ConditionError as e:
            met = False
            log.warning("trial success condition error: %s", e)
        if met:
            return ExecutionResult(TrialOutcome.COMPLETED, f"success condition met: {template.success_condition}",
                                   exit_code=result.exit_code, stdout_path=result.stdout_path)
        msg = f"success condition not met: {template.success_condition}"
        if result.message:
            msg += f" ({result.message})"
        return ExecutionResult(TrialOutcome.FAILED, msg, exit_code=result.exit_code, stdout_path=result.stdout_path)
    return result


class _AdaptivePoll:
    """The wait loop's sleep: ``base`` while the trial shows signs of life
    (output, scraped rows), doubling toward ``maximum`` once it has been
    quiet for ``backoff_after`` seconds, so a long silent trial does not
    wake the controller ten times a second."""

    def __init__(self, base: float, backoff_after: float = 30.0, maximum: float = 1.0):
        self.base = base
        self.backoff_after = backoff_after
        self.maximum = max(maximum, base)
        self._quiet_since = time.time()
        self._delay = base

    def activity(self, now: Optional[float] = None) -> None:
        self._quiet_since = time.time() if now is None else now
        self._delay = self.base

    def next_delay(self, now: Optional[float] = None) -> float:
        now = time.time() if now is None else now
        if now - self._quiet_since < self.backoff_after:
            return self.base
        self._delay = min(self._delay * 2, self.maximum)
        return self._delay


class SubprocessExecutor:
    POLL_INTERVAL = 0.1
    POLL_BACKOFF_AFTER = 30.0  # seconds of quiet before the poll backs off
    POLL_BACKOFF_MAX = 1.0
    SCRAPE_INTERVAL = 1.0  # seconds between Prometheus scrapes
    # a scrape samples state: an unchanged value is recorded again only after
    # this many seconds, so a constant metric still advances the
    # early-stopping rules' step counts
    SCRAPE_DEDUP_WINDOW = 10.0
    CUSTOM_COLLECTOR_TIMEOUT = 60.0
    TERMINATE_GRACE = 10.0  # seconds between SIGTERM and SIGKILL

    def __init__(self, obs_store: InMemoryObservationStore):
        self.obs_store = obs_store

    def execute(self, exp: Experiment, trial: Trial, ctx: TrialContext, kill: threading.Event,
                rules: Sequence[Any] = ()) -> ExecutionResult:
        """Run the trial's command to its end (or to a kill request or a
        tripped rule) and collect its metrics into the store."""
        spec = exp.spec
        cmd = render_command(spec.trial_template, trial)
        workdir = ctx.workdir or os.getcwd()
        os.makedirs(workdir, exist_ok=True)
        stdout_path = os.path.join(workdir, "stdout.log")

        env = dict(os.environ)
        env.update(spec.trial_template.env)
        env[ENV_TRIAL_NAME] = trial.name
        env["CUDA_VISIBLE_DEVICES"] = cuda_visible_devices(ctx.devices or [], os.environ.get("CUDA_VISIBLE_DEVICES"))
        metrics_file = None
        mc = spec.metrics_collector_spec
        if mc.collector_kind == CollectorKind.FILE and mc.source and mc.source.file_path:
            metrics_file = mc.source.file_path
            if not os.path.isabs(metrics_file):
                metrics_file = os.path.join(workdir, metrics_file)
            env[ENV_METRICS_FILE] = metrics_file
        monitor = None
        if rules:
            monitor = EarlyStoppingMonitor(rules, spec.objective.objective_metric_name, spec.objective.type)

        prom_logs: List[MetricLog] = []
        with open(stdout_path, "wb") as out:
            proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, env=env,
                                    cwd=spec.trial_template.working_dir or workdir, start_new_session=True)
            outcome = self._wait(proc, stdout_path, metrics_file, monitor, spec, kill, prom_logs)
        if prom_logs:
            self.obs_store.report_observation_log(trial.name, prom_logs)
        self._collect(trial, stdout_path, metrics_file, spec)  # Katib's sidecar: CollectObservationLog

        if outcome is not None:
            outcome.exit_code = proc.returncode
            outcome.stdout_path = stdout_path
            return outcome
        if proc.returncode == 0:
            return ExecutionResult(TrialOutcome.COMPLETED, exit_code=0, stdout_path=stdout_path)
        # nobody here sent a SIGKILL (the kill path returned above): the
        # kernel's OOM killer's signature
        message = (SIGKILL_MESSAGE if proc.returncode in (-9, 137)
                   else f"process exited with code {proc.returncode}")
        return ExecutionResult(TrialOutcome.FAILED, message, exit_code=proc.returncode, stdout_path=stdout_path)

    def _scrape_prometheus(self, spec: ExperimentSpec, prom_logs: List[MetricLog],
                           monitor: Optional[EarlyStoppingMonitor],
                           last_scraped: Dict[str, Any]) -> Optional[ExecutionResult]:
        from urllib.request import urlopen

        src = spec.metrics_collector_spec.source
        url = f"http://{src.http_host}:{src.http_port}{src.http_path}"
        try:
            with urlopen(url, timeout=2) as resp:
                text = resp.read().decode(errors="replace")
        except Exception:
            # the endpoint is not up yet, is going down, or does not speak
            # HTTP: skip this scrape and keep polling
            return None
        now = time.time()
        fresh = []
        for row in parse_prometheus_text(text, spec.objective.all_metric_names()):
            prev = last_scraped.get(row.metric_name)
            if prev is not None and prev[0] == row.value and now - prev[1] < self.SCRAPE_DEDUP_WINDOW:
                continue
            last_scraped[row.metric_name] = (row.value, now)
            fresh.append(row)
        prom_logs.extend(fresh)
        if monitor is not None:
            for row in fresh:
                try:
                    value = float(row.value)
                except ValueError:
                    continue
                if monitor.observe(row.metric_name, value):
                    return ExecutionResult(TrialOutcome.EARLY_STOPPED)
        return None

    def _wait(self, proc: subprocess.Popen, stdout_path: str, metrics_file: Optional[str],
              monitor: Optional[EarlyStoppingMonitor], spec: ExperimentSpec, kill: threading.Event,
              prom_logs: List[MetricLog]) -> Optional[ExecutionResult]:
        """Poll for the exit; tail the watched file for the rules (Katib's
        sidecar's watchMetricsFile loop) and scrape the Prometheus endpoint
        when the collector asks for it. None when the process ended by
        itself."""
        mc = spec.metrics_collector_spec
        scrape = mc.collector_kind == CollectorKind.PROMETHEUS and mc.source is not None
        last_scrape = 0.0
        last_scraped: Dict[str, Any] = {}  # metric -> (value, recorded at)
        tailer = self._make_stop_tailer(spec, metrics_file or stdout_path) if monitor else None
        poll = _AdaptivePoll(self.POLL_INTERVAL, backoff_after=self.POLL_BACKOFF_AFTER,
                             maximum=self.POLL_BACKOFF_MAX)
        while True:
            if kill.is_set():
                self._terminate(proc)
                return ExecutionResult(TrialOutcome.KILLED, "kill requested")
            rc = proc.poll()
            if scrape and time.time() - last_scrape >= self.SCRAPE_INTERVAL:
                last_scrape = time.time()
                before = len(prom_logs)
                stopped = self._scrape_prometheus(spec, prom_logs, monitor, last_scraped)
                if len(prom_logs) > before:
                    poll.activity()
                if stopped is not None:
                    self._terminate(proc)
                    return stopped
            if tailer is not None:
                parsed = tailer.poll()
                if parsed:
                    poll.activity()
                for name, raw, _idx in parsed:
                    if monitor.observe(name, float(raw)):
                        self._terminate(proc)
                        return ExecutionResult(TrialOutcome.EARLY_STOPPED)
            if rc is not None:
                if scrape:  # values published within the last interval die with the endpoint otherwise
                    self._scrape_prometheus(spec, prom_logs, monitor, last_scraped)
                return None
            time.sleep(poll.next_delay())

    @staticmethod
    def _make_stop_tailer(spec: ExperimentSpec, watch_path: str):
        from ..runtime.tailer import make_tailer

        mc = spec.metrics_collector_spec
        filters = mc.source.filter.metrics_format if mc.source and mc.source.filter else None
        return make_tailer(watch_path, spec.objective.all_metric_names(), filters=filters,
                           json_format=bool(mc.source and mc.source.file_format == "JSON"))

    @classmethod
    def _terminate(cls, proc: subprocess.Popen) -> None:
        """SIGTERM to the trial's process group; SIGKILL if it still runs
        ``TERMINATE_GRACE`` seconds later."""
        try:
            os.killpg(os.getpgid(proc.pid), signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            pass
        try:
            proc.wait(timeout=cls.TERMINATE_GRACE)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(os.getpgid(proc.pid), signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            proc.wait(timeout=5)

    def _run_custom_collector(self, trial: Trial, stdout_path: str, metrics_file: Optional[str],
                              spec: ExperimentSpec) -> None:
        """The Custom collector's program, in the trial's directory, after
        the trial; its stdout is parsed as a File collector's lines. A
        collector that fails or outlives its limit reports nothing."""
        workdir = os.path.dirname(stdout_path)
        env = dict(os.environ)
        env[ENV_TRIAL_NAME] = trial.name
        env["KATIB_TRIAL_WORKDIR"] = workdir
        env["KATIB_TRIAL_STDOUT"] = stdout_path
        if metrics_file:
            env[ENV_METRICS_FILE] = metrics_file
        try:
            proc = subprocess.run(list(spec.metrics_collector_spec.custom_command), capture_output=True, text=True,
                                  env=env, cwd=workdir, timeout=self.CUSTOM_COLLECTOR_TIMEOUT)
        except (subprocess.TimeoutExpired, OSError):
            return
        if proc.returncode != 0:
            return
        self._parse_and_report(trial, proc.stdout.splitlines(), spec)

    def _parse_and_report(self, trial: Trial, lines: List[str], spec: ExperimentSpec) -> None:
        """TEXT or JSON lines of the File, StdOut and Custom collectors into
        the store, stamped from the trial's start."""
        mc = spec.metrics_collector_spec
        names = spec.objective.all_metric_names()
        filters = mc.source.filter.metrics_format if mc.source and mc.source.filter else None
        base = trial.start_time or time.time()
        if mc.source and mc.source.file_format == "JSON":
            logs = parse_json_lines(lines, names, base_time=base)
        else:
            logs = parse_text_lines(lines, names, filters, base_time=base)
        if logs:
            self.obs_store.report_observation_log(trial.name, logs)

    def _collect(self, trial: Trial, stdout_path: str, metrics_file: Optional[str], spec: ExperimentSpec) -> None:
        mc = spec.metrics_collector_spec
        kind = mc.collector_kind
        if kind in (CollectorKind.NONE, CollectorKind.PUSH, CollectorKind.PROMETHEUS):
            return  # nothing to report, or scraped while the trial ran
        if kind == CollectorKind.CUSTOM and mc.custom_command:
            self._run_custom_collector(trial, stdout_path, metrics_file, spec)
            return
        if kind == CollectorKind.TF_EVENT:
            from ..runtime.tfevent import collect_tfevent_metrics

            event_dir = mc.source.file_path if mc.source else None
            if event_dir and not os.path.isabs(event_dir):
                event_dir = os.path.join(os.path.dirname(stdout_path), event_dir)
            if event_dir and os.path.isdir(event_dir):
                logs = collect_tfevent_metrics(event_dir, spec.objective.all_metric_names())
                if logs:
                    self.obs_store.report_observation_log(trial.name, logs)
            return
        path = metrics_file if kind == CollectorKind.FILE and metrics_file else stdout_path
        if not os.path.exists(path):
            return
        with open(path, "r", errors="replace") as f:
            lines = f.read().splitlines()
        self._parse_and_report(trial, lines, spec)
