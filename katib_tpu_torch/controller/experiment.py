"""Experiment controller — a slim counterpart of
``katib_tpu/controller/experiment.py``, ``scheduler.py``, ``status.py`` and
the in-process half of ``executor.py``.

``run`` drives one experiment to a terminal condition: it asks the suggester
for up to ``parallelTrialCount`` assignments at a time, gives each trial
``numDevices`` device slots from the controller's pool, runs the trial on a
thread of its own (the trial function in-process, or a command template as
a subprocess, ``controller/executor.py``, in ``<root>/<experiment>/<trial>``),
folds the reported metrics, applies the trial's success and failure
conditions, and picks the optimal trial, with Katib's terminal conditions
(goal, max failed, max trials, suggestion end). Without ``retain`` a
Succeeded or EarlyStopped command trial's directory is removed; a Failed or
Killed one's is kept. The device pool is the process's CUDA devices unless
the caller passes ``devices`` (``[torch.device("cpu")]`` for the CPU).

A suggester that answers ``TrialsNotCompleted`` (Hyperband between rungs)
is asked again once a trial has ended; the settings a reply hands back are
laid over the spec's algorithm settings for the next request. With an
``earlyStopping`` section, one stopper per experiment computes the rules
at each trial's start, and the trial's reporter enforces them: a stopped
trial ends as EarlyStopped, which counts as completed, not failed.
How many trials to ask for is Katib's ReconcileTrials
(``controller/suggestion.py``). With ``reuseDuplicateResults``, a new trial
whose assignments equal those of a Succeeded trial takes that trial's
metric log and succeeds at once, without a device; a trial whose
suggester keeps a checkpoint lineage (PBT) gets its directory as
``ctx.checkpoint_dir``, is labelled ``checkpoint-lineage``, and is never
reused or reused from. Replicas, tenancy,
recovery, the compile service, packing and fused populations are later
slices of the port.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from ..api.defaults import set_defaults
from ..api.spec import (
    UNAVAILABLE_METRIC_VALUE,
    AlgorithmSetting,
    AlgorithmSpec,
    CollectorKind,
    ExperimentSpec,
    MetricStrategyType,
    ObjectiveType,
    TrialTemplate,
    ValidationError,
)
from ..api.status import (
    Experiment,
    ExperimentCondition,
    ExperimentReason,
    OptimalTrial,
    Trial,
    TrialCondition,
)
from ..api.validation import validate_experiment
from ..db.store import InMemoryObservationStore
from ..earlystop.medianstop import create_early_stopper
from ..runtime.context import TrialContext
from ..runtime.metrics import EarlyStopped, EarlyStoppingMonitor, MetricsReporter, TrialKilled, current_reporter
from ..suggest import base as suggest_base
from ..suggest.nas.enas import STATE_FILE as ENAS_STATE_FILE
from .executor import ExecutionResult, SubprocessExecutor, TrialOutcome, apply_conditions
from .suggestion import suggestion_request_plan

LINEAGE_LABEL = "checkpoint-lineage"  # a trial trained from a parent's checkpoint (PBT)
JAX_PACKAGE = "katib_tpu"
PORT_PACKAGE = "katib_tpu_torch"
# Trials of the JAX package that the port has, as "module:function" below
# the package: a spec's "katib_tpu.<path>" entry point runs
# "katib_tpu_torch.<path>".
PORTED_TRIALS = frozenset({
    "parallel.train:run_lm_trial",
    "models.mnist_cnn:run_mnist_trial",
    "models.darts_trainer:run_darts_trial",
    "models.darts_trainer:run_darts_hpo_trial",
    "models.darts_derived:run_darts_retrain_trial",
    "models.enas_child:run_enas_trial",
    "models.simple_pbt:run_pbt_trial",
})


def port_entry_point(entry_point: str) -> str:
    """The entry point the port runs for ``entry_point``: the port's
    counterpart of a ported JAX-package trial, any entry point outside the
    JAX package as it is. A JAX-package trial that is not ported raises
    ValidationError before anything is imported."""
    if entry_point.partition(":")[0].split(".")[0] != JAX_PACKAGE:
        return entry_point
    path = entry_point[len(JAX_PACKAGE) + 1:]
    if path not in PORTED_TRIALS:
        raise ValidationError(
            f"entryPoint {entry_point!r} is a trial of the JAX package that is not yet ported; "
            f"the port runs {sorted(JAX_PACKAGE + '.' + p for p in PORTED_TRIALS)}")
    return f"{PORT_PACKAGE}.{path}"


def resolve_entry_point(template: TrialTemplate) -> Callable[..., Any]:
    if template.function is not None:
        return template.function
    if not template.entry_point:
        raise ValidationError("trialTemplate needs an entryPoint ('module:function')")
    mod_name, _, fn_name = port_entry_point(template.entry_point).partition(":")
    if not fn_name:
        raise ValidationError(f"entryPoint {template.entry_point!r} must be 'module:function'")
    return getattr(importlib.import_module(mod_name), fn_name)


def validate_spec(spec: ExperimentSpec, n_devices: int) -> None:
    """The JAX package's admission rules (``api/validation.py``), then the
    port's own: the entry point, the algorithm and its settings, hosts and
    devices."""
    validate_experiment(spec)
    if spec.trial_template.command is None:
        try:
            resolve_entry_point(spec.trial_template)
        except (ImportError, AttributeError) as e:
            raise ValidationError(f"entryPoint {spec.trial_template.entry_point!r} does not resolve: {e}") from e
    algo = spec.algorithm.algorithm_name
    if algo not in suggest_base.registered_algorithms():
        raise ValidationError(
            f"unknown algorithm {algo!r}; the port has {sorted(suggest_base.registered_algorithms())}"
        )
    res = spec.trial_template.resources
    if res.num_hosts != 1:
        raise ValidationError("multi-host trials are a later slice of the port")
    if not 1 <= res.num_devices <= n_devices:
        raise ValidationError(f"numDevices={res.num_devices} but the controller holds {n_devices} device(s)")
    if spec.trial_template.entry_point is not None and res.num_devices > 1:
        trial = port_entry_point(spec.trial_template.entry_point)
        if trial.startswith(PORT_PACKAGE + ".") and trial[len(PORT_PACKAGE) + 1:] in PORTED_TRIALS:
            raise ValidationError(
                f"numDevices={res.num_devices}: the port's trial {trial!r} trains on one card; "
                "data parallelism over several comes with the multi-GPU slice of the port")
    try:
        suggest_base.create(algo).validate_algorithm_settings(spec)
    except (ValueError, KeyError) as e:
        raise ValidationError(f"algorithm settings invalid: {e}") from e
    if spec.early_stopping is not None:
        try:
            create_early_stopper(spec.early_stopping.algorithm_name).validate_settings(spec)
        except (ValueError, KeyError) as e:
            raise ValidationError(f"early stopping settings invalid: {e}") from e


# ---------------------------------------------------------------------------
# status aggregation (katib_tpu/controller/status.py, Katib's status_util.go)
# ---------------------------------------------------------------------------

def objective_value_str(exp: Experiment, trial: Trial) -> str:
    """The strategy's value, falling back to latest when min/max is unavailable."""
    if trial.observation is None:
        return UNAVAILABLE_METRIC_VALUE
    obj = exp.spec.objective
    m = trial.observation.metric(obj.objective_metric_name)
    if m is None:
        return UNAVAILABLE_METRIC_VALUE
    strategy = obj.strategy_for(obj.objective_metric_name)
    if strategy == MetricStrategyType.MIN:
        return m.latest if m.min == UNAVAILABLE_METRIC_VALUE else m.min
    if strategy == MetricStrategyType.MAX:
        return m.latest if m.max == UNAVAILABLE_METRIC_VALUE else m.max
    return m.latest


_BUCKETS = {
    TrialCondition.KILLED: "trials_killed",
    TrialCondition.FAILED: "trials_failed",
    TrialCondition.SUCCEEDED: "trials_succeeded",
    TrialCondition.EARLY_STOPPED: "trials_early_stopped",
    TrialCondition.RUNNING: "trials_running",
    TrialCondition.METRICS_UNAVAILABLE: "trials_metrics_unavailable",
}


def update_experiment_status(exp: Experiment, trials: Sequence[Trial], suggestion_end: bool = False) -> None:
    """Trial buckets and optimal trial, then the terminal condition in
    Katib's order: goal, max failed, max trials, suggestion end."""
    sts, obj = exp.status, exp.spec.objective
    counts = dict.fromkeys(list(_BUCKETS.values()) + ["trials_pending"], 0)
    best: Optional[Trial] = None
    best_value: Optional[float] = None
    goal_reached = False
    for trial in trials:
        counts[_BUCKETS.get(trial.condition, "trials_pending")] += 1
        value_str = objective_value_str(exp, trial)
        if value_str == UNAVAILABLE_METRIC_VALUE:
            continue
        try:
            value = float(value_str)
        except ValueError:
            best = trial  # a string-valued metric: the latest reporting trial wins
            continue
        minimize = obj.type == ObjectiveType.MINIMIZE
        if best_value is None or (value < best_value if minimize else value > best_value):
            best_value, best = value, trial
        if obj.goal is not None and (best_value <= obj.goal if minimize else best_value >= obj.goal):
            goal_reached = True
    sts.trials = len(trials)
    for key, n in counts.items():
        setattr(sts, key, n)
    if best is not None:
        sts.current_optimal_trial = OptimalTrial(
            best_trial_name=best.name,
            parameter_assignments=list(best.parameter_assignments),
            observation=best.observation,
        )
    if sts.is_completed:
        return
    completed = (sts.trials_succeeded + sts.trials_failed + sts.trials_killed
                 + sts.trials_early_stopped + sts.trials_metrics_unavailable)
    failed = sts.trials_failed + sts.trials_metrics_unavailable
    spec = exp.spec
    if goal_reached:
        sts.set_condition(ExperimentCondition.SUCCEEDED, ExperimentReason.GOAL_REACHED,
                          "Experiment has succeeded because Objective goal has reached")
    elif spec.max_failed_trial_count is not None and failed and failed >= spec.max_failed_trial_count:
        sts.set_condition(ExperimentCondition.FAILED, ExperimentReason.MAX_FAILED_TRIALS_REACHED,
                          "Experiment has failed because max failed count has reached")
    elif spec.max_trial_count is not None and completed >= spec.max_trial_count:
        sts.set_condition(ExperimentCondition.SUCCEEDED, ExperimentReason.MAX_TRIALS_REACHED,
                          "Experiment has succeeded because max trial count has reached")
    elif suggestion_end and sts.trials_pending + sts.trials_running == 0:
        sts.set_condition(ExperimentCondition.SUCCEEDED, ExperimentReason.SUGGESTION_END_REACHED,
                          "Experiment has succeeded because suggestion service has reached the end")
    else:
        sts.set_condition(ExperimentCondition.RUNNING, ExperimentReason.NONE, "Experiment is running")


def _with_settings(spec: ExperimentSpec, settings: Dict[str, str]) -> ExperimentSpec:
    """The spec with ``settings`` laid over its algorithm settings."""
    if not settings:
        return spec
    merged = dict(spec.algorithm.settings_dict(), **settings)
    algorithm = AlgorithmSpec(spec.algorithm.algorithm_name, [AlgorithmSetting(k, v) for k, v in merged.items()])
    return dataclasses.replace(spec, algorithm=algorithm)


# ---------------------------------------------------------------------------

class ExperimentController:
    def __init__(self, root_dir: Optional[str] = None, devices: Optional[Sequence[Any]] = None,
                 obs_store: Optional[InMemoryObservationStore] = None):
        if devices is None:
            from ..utils.backend import require_devices

            devices = require_devices()  # raises BackendUnavailable without CUDA
        self.root_dir = root_dir
        self.devices = list(devices)
        self.obs_store = obs_store or InMemoryObservationStore()
        self._experiments: Dict[str, Experiment] = {}
        self._trials: Dict[str, Dict[str, Trial]] = {}
        self._free = list(self.devices)
        self._cv = threading.Condition()
        self._running: Dict[str, tuple] = {}  # trial name -> (thread, kill event, slots)
        self._stoppers: Dict[str, Any] = {}  # experiment name -> its early stopper
        self._suggesters: Dict[str, suggest_base.Suggester] = {}  # experiment name -> its run's suggester
        self._subprocess = SubprocessExecutor(self.obs_store)

    # -- experiments ----------------------------------------------------------

    def create_experiment(self, spec: ExperimentSpec) -> Experiment:
        if spec.name in self._experiments:
            raise ValidationError(f"experiment {spec.name!r} already exists")
        set_defaults(spec)  # before admission, as Katib does
        validate_spec(spec, len(self.devices))
        exp = Experiment(spec=spec)
        exp.status.set_condition(ExperimentCondition.CREATED, message="Experiment is created")
        self._experiments[spec.name] = exp
        self._trials[spec.name] = {}
        if self.root_dir:
            # the port does not resume an experiment: a PBT lineage or an
            # ENAS controller state left on this root by an earlier run of
            # the same name is stale
            shutil.rmtree(self._pbt_root(spec.name), ignore_errors=True)
            for stale in (ENAS_STATE_FILE, ENAS_STATE_FILE + ".tmp"):
                with contextlib.suppress(FileNotFoundError):
                    os.remove(os.path.join(self.root_dir, spec.name, stale))
        if spec.early_stopping is not None:
            self._stoppers[spec.name] = create_early_stopper(spec.early_stopping.algorithm_name)
        return exp

    def get_experiment(self, name: str) -> Experiment:
        return self._experiments[name]

    def list_trials(self, name: str) -> List[Trial]:
        with self._cv:
            return list(self._trials[name].values())

    def run(self, name: str, timeout: Optional[float] = None) -> Experiment:
        """Drive the experiment until a terminal condition (or ``timeout``
        seconds, after which running trials are killed and it fails)."""
        exp = self._experiments[name]
        spec = exp.spec
        suggester = suggest_base.create(spec.algorithm.algorithm_name, **self._suggester_kwargs(spec))
        self._suggesters[name] = suggester  # its trials' checkpoint directories, while they run
        deadline = None if timeout is None else time.monotonic() + timeout
        suggestion_end = False
        settings: Dict[str, str] = {}  # handed back by the suggester's replies
        waiting_on = None  # what the suggester saw when it said TrialsNotCompleted
        exp.status.set_condition(ExperimentCondition.RUNNING, message="Experiment is running")
        with self._cv:
            while True:
                trials = list(self._trials[name].values())
                update_experiment_status(exp, trials, suggestion_end)
                if exp.status.is_completed:
                    break
                if deadline is not None and time.monotonic() > deadline:
                    exp.status.set_condition(ExperimentCondition.FAILED, ExperimentReason.EXPERIMENT_FAILED,
                                             f"Experiment timed out after {timeout}s")
                    break
                active = [t for t in trials if not t.is_terminal]
                want = suggestion_request_plan(exp, trials)
                seen = (want, tuple((t.name, t.condition) for t in trials))
                if want > 0 and not suggestion_end and seen != waiting_on:
                    request = suggest_base.SuggestionRequest(
                        experiment=_with_settings(spec, settings), trials=trials, current_request_number=want)
                    try:
                        reply = suggester.get_suggestions(request)
                    except suggest_base.TrialsNotCompleted as e:
                        if not active:  # no trial left whose end could change the answer
                            exp.status.set_condition(ExperimentCondition.FAILED, ExperimentReason.EXPERIMENT_FAILED,
                                                     f"the suggester waits for trials, but none is running: {e}")
                            break
                        waiting_on = seen  # ask again once a trial has ended
                        reply = suggest_base.SuggestionReply()
                    settings.update(reply.algorithm_settings)
                    suggestion_end = reply.search_ended
                    for assignment in reply.assignments:
                        trial = Trial.from_assignment(assignment, name)
                        trial.set_condition(TrialCondition.PENDING, message="waiting for devices")
                        if suggester.checkpoint_dir(trial.name):
                            trial.labels[LINEAGE_LABEL] = "1"  # trains from a parent's checkpoint
                        if spec.reuse_duplicate_results:
                            self._reuse_duplicate(exp, trial)
                        self._trials[name][trial.name] = trial
                    if reply.assignments or suggestion_end:
                        continue
                self._dispatch(exp)
                self._cv.wait(timeout=0.5)
        self._stop_trials(name)
        del self._suggesters[name]
        update_experiment_status(exp, list(self._trials[name].values()), suggestion_end)
        self._save(exp)
        return exp

    def _suggester_kwargs(self, spec: ExperimentSpec) -> Dict[str, Any]:
        """ENAS keeps its controller's state in the experiment's directory
        and runs the controller on the controller's first device; PBT keeps
        its queue and its trials' checkpoint lineage in ``<experiment>/pbt``.
        Without a root directory each falls back to its own default."""
        algo = spec.algorithm.algorithm_name
        if algo == "pbt":
            return {"checkpoint_root": self._pbt_root(spec.name) if self.root_dir else None}
        if algo != "enas":
            return {}
        device = self.devices[0] if isinstance(self.devices[0], torch.device) else None
        return {"state_dir": os.path.join(self.root_dir, spec.name) if self.root_dir else None, "device": device}

    def _pbt_root(self, name: str) -> str:
        return os.path.join(self.root_dir, name, "pbt")

    # -- trials ---------------------------------------------------------------

    def _reuse_duplicate(self, exp: Experiment, trial: Trial) -> bool:
        """Finish ``trial`` with the result of a Succeeded trial of the
        experiment with the same assignments, if there is one: its metric
        log is copied and folded, and the trial passes through Running to
        Succeeded without taking a device. Only trials that have already
        succeeded are sources, not twins still in flight; a trial trained
        from a parent's checkpoint is never a source or a target."""
        key = sorted((a.name, a.value) for a in trial.parameter_assignments)
        if not key or trial.labels.get(LINEAGE_LABEL):
            return False
        source = next((t for t in self._trials[exp.name].values()
                       if t.condition == TrialCondition.SUCCEEDED and t.labels.get(LINEAGE_LABEL) != "1"
                       and sorted((a.name, a.value) for a in t.parameter_assignments) == key), None)
        if source is None:
            return False
        logs = self.obs_store.get_observation_log(source.name)
        if logs:
            self.obs_store.report_observation_log(trial.name, logs)
        trial.observation = self.obs_store.folded(trial.name, exp.spec.objective.all_metric_names())
        trial.set_condition(TrialCondition.RUNNING, "TrialRunning", f"reusing result of trial {source.name}")
        trial.set_condition(TrialCondition.SUCCEEDED, "DuplicateResultReused",
                            f"reused result of trial {source.name} (identical assignments)")
        return True

    def _dispatch(self, exp: Experiment) -> None:
        """Start pending trials, in order, while device slots are free."""
        need = exp.spec.trial_template.resources.num_devices
        rules = None
        for trial in self._trials[exp.name].values():
            if trial.condition != TrialCondition.PENDING or len(self._free) < need:
                continue
            if rules is None:
                rules = self._early_stopping_rules(exp)
            slots, self._free = self._free[:need], self._free[need:]
            kill = threading.Event()
            trial.set_condition(TrialCondition.RUNNING, message="trial is running")
            thread = threading.Thread(target=self._run_trial, args=(exp, trial, slots, kill, rules),
                                      name=f"trial-{trial.name}", daemon=True)
            self._running[trial.name] = (thread, kill, slots)
            thread.start()

    def _early_stopping_rules(self, exp: Experiment) -> list:
        """The rules for trials starting now, from the trials so far."""
        stopper = self._stoppers.get(exp.name)
        if stopper is None:
            return []
        return stopper.get_early_stopping_rules(exp.spec, list(self._trials[exp.name].values()), self.obs_store)

    def _run_trial(self, exp: Experiment, trial: Trial, slots: List[Any], kill: threading.Event,
                   rules: Sequence[Any] = ()) -> None:
        obj, template = exp.spec.objective, exp.spec.trial_template
        workdir = None
        if template.command is not None:
            workdir = (os.path.join(self.root_dir, exp.name, trial.name) if self.root_dir
                       else tempfile.mkdtemp(prefix=f"{trial.name}-"))
        monitor = EarlyStoppingMonitor(rules, obj.objective_metric_name, obj.type) if rules else None
        ctx = TrialContext(
            trial_name=trial.name, experiment_name=exp.name, assignments=trial.assignments_dict(),
            reporter=MetricsReporter(self.obs_store, trial.name, kill_event=kill, monitor=monitor),
            devices=slots, checkpoint_dir=self._suggesters[exp.name].checkpoint_dir(trial.name), workdir=workdir,
        )
        try:
            if template.command is not None:
                result = self._subprocess.execute(exp, trial, ctx, kill, rules)
            else:
                result = self._run_in_process(exp, ctx)
        except Exception:  # e.g. a program that cannot be started: this trial fails, not the controller
            result = ExecutionResult(TrialOutcome.FAILED, traceback.format_exc(limit=5))
        # fold, then the trial's own conditions (the JAX scheduler's _classify)
        observation = self.obs_store.folded(trial.name, obj.all_metric_names())
        result = apply_conditions(template, result, observation)
        with self._cv:
            trial.observation = observation
            self._finalize(exp, trial, result)
        if (workdir and not template.retain
                and trial.condition in (TrialCondition.SUCCEEDED, TrialCondition.EARLY_STOPPED)):
            # Katib deletes a finished trial's job unless retain; a Failed or
            # Killed trial's directory stays for its post-mortem. The trial
            # counts as running until it is gone: _stop_trials joins it.
            shutil.rmtree(workdir, ignore_errors=True)
        with self._cv:
            self._free.extend(slots)
            self._running.pop(trial.name, None)
            self._cv.notify_all()

    @staticmethod
    def _run_in_process(exp: Experiment, ctx: TrialContext) -> ExecutionResult:
        """The trial function on this thread, with ``report_metrics`` bound to
        the trial's reporter."""
        try:
            with current_reporter(ctx.reporter):
                result = resolve_entry_point(exp.spec.trial_template)(ctx.assignments, ctx)
            if isinstance(result, dict):  # a returned dict of numbers is reported
                numeric = {k: v for k, v in result.items() if isinstance(v, (int, float))}
                if numeric:
                    ctx.report(**numeric)
            return ExecutionResult(TrialOutcome.COMPLETED, exit_code=0)
        except EarlyStopped:
            return ExecutionResult(TrialOutcome.EARLY_STOPPED)
        except TrialKilled:
            return ExecutionResult(TrialOutcome.KILLED, "kill requested")
        except Exception:
            return ExecutionResult(TrialOutcome.FAILED, traceback.format_exc(limit=10), exit_code=1)

    @staticmethod
    def _finalize(exp: Experiment, trial: Trial, result: ExecutionResult) -> None:
        """The trial's terminal condition from its classified result, as the
        JAX scheduler's _finalize sets it (Katib's trial_controller_util.go):
        a trial that completed without its objective metric is
        MetricsUnavailable, unless its collector is None."""
        objective = trial.observation.metric(exp.spec.objective.objective_metric_name) if trial.observation else None
        metrics_available = objective is not None and objective.latest != UNAVAILABLE_METRIC_VALUE
        if result.outcome == TrialOutcome.EARLY_STOPPED:
            trial.set_condition(TrialCondition.EARLY_STOPPED, "TrialEarlyStopped", "Trial is early stopped")
        elif result.outcome == TrialOutcome.KILLED:
            trial.set_condition(TrialCondition.KILLED, "TrialKilled", result.message)
        elif result.outcome == TrialOutcome.FAILED:
            trial.set_condition(TrialCondition.FAILED, "TrialFailed", result.message)
        elif not metrics_available and exp.spec.metrics_collector_spec.collector_kind != CollectorKind.NONE:
            trial.set_condition(TrialCondition.METRICS_UNAVAILABLE, "MetricsUnavailable", "Metrics are not available")
        else:
            trial.set_condition(TrialCondition.SUCCEEDED, "TrialSucceeded", "Trial has succeeded")

    def _stop_trials(self, name: str) -> None:
        """Kill what still runs (a report is the kill point) and wait for it."""
        with self._cv:
            running = [(n, r) for n, r in self._running.items() if n in self._trials[name]]
        for _, (_, kill, _) in running:
            kill.set()
        for _, (thread, _, _) in running:
            thread.join()
        with self._cv:
            for trial in self._trials[name].values():
                if not trial.is_terminal:
                    trial.set_condition(TrialCondition.KILLED, message="experiment ended")

    def _save(self, exp: Experiment) -> None:
        """Write the experiment, its trials and their metric logs to
        ``<root>/<name>/experiment.json`` for ``cli status``."""
        if not self.root_dir:
            return
        path = os.path.join(self.root_dir, exp.name, "experiment.json")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        doc = {
            "experiment": exp.to_dict(),
            "trials": [t.to_dict() for t in self._trials[exp.name].values()],
            "logs": {
                t: [[r.timestamp, r.metric_name, r.value] for r in self.obs_store.get_observation_log(t)]
                for t in self._trials[exp.name]
            },
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    def close(self) -> None:
        for name in list(self._trials):
            self._stop_trials(name)
        self.obs_store.close()
