"""The port's early stopping against the JAX package's, on the CPU.

The same observation logs go through both packages: median stop's rules
(katib_tpu.earlystop.medianstop), its settings checks, and the decisions of
EarlyStoppingMonitor (katib_tpu.runtime.metrics) report by report. The
port's reporter raises EarlyStopped after the report is stored, and the
controller ends such a trial EarlyStopped without counting it as failed.
"""

import numpy as np
import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.db import store as jax_store
from katib_tpu.earlystop.medianstop import MedianStop as JaxMedianStop
from katib_tpu.runtime.metrics import EarlyStoppingMonitor as JaxMonitor
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import ExperimentReason, Trial, TrialCondition
from katib_tpu_torch.controller.experiment import ExperimentController, ValidationError
from katib_tpu_torch.db import store
from katib_tpu_torch.earlystop.medianstop import MedianStop, create_early_stopper
from katib_tpu_torch.runtime.metrics import EarlyStopped, EarlyStoppingMonitor, MetricsReporter


def _doc(objective="maximize", metric="accuracy", settings=None):
    doc = {
        "name": "es",
        "parameters": [{"name": "x", "parameterType": "double", "feasibleSpace": {"min": "0", "max": "1"}}],
        "objective": {"type": objective, "objectiveMetricName": metric},
        "algorithm": {"algorithmName": "random", "algorithmSettings": [{"name": "random_state", "value": "1"}]},
        "earlyStopping": {"algorithmName": "medianstop",
                          "algorithmSettings": [{"name": k, "value": v} for k, v in (settings or {}).items()]},
    }
    return doc


def _logs(seed, n_trials, n_reports, metric="accuracy"):
    """Per trial, (timestamp, metric, value) rows: a numeric curve with a
    non-numeric row and a row of another metric mixed in."""
    rng = np.random.default_rng(seed)
    logs = {}
    for i in range(n_trials):
        rows = [(float(j), metric, repr(float(v))) for j, v in enumerate(rng.uniform(0, 1, n_reports))]
        rows.insert(1, (0.5, metric, "unavailable"))
        rows.append((0.25, "other", "3.0"))
        logs[f"t{i}"] = rows
    return logs


@pytest.mark.parametrize("objective", ["maximize", "minimize"])
@pytest.mark.parametrize("settings", [{}, {"min_trials_required": "2", "start_step": "2"},
                                      {"min_trials_required": "4", "start_step": "1"}])
def test_medianstop_rules_match_jax(objective, settings):
    """Rules from the same trials and logs, asked three times as trials
    succeed one by one (the stopper remembers the averages it read)."""
    doc = _doc(objective, settings=settings)
    ours_spec, jax_exp = spec.ExperimentSpec.from_dict(doc), jax_spec.ExperimentSpec.from_dict(doc)
    logs = _logs(0, 6, 6)
    ours_store, jax_st = store.InMemoryObservationStore(), jax_store.InMemoryObservationStore()
    for name, rows in logs.items():
        ours_store.report_observation_log(name, [store.MetricLog(*r) for r in rows])
        jax_st.report_observation_log(name, [jax_store.MetricLog(*r) for r in rows])
    ours_stopper, jax_stopper = MedianStop(), JaxMedianStop()
    conditions = ["SUCCEEDED", "SUCCEEDED", "RUNNING", "FAILED", "SUCCEEDED", "SUCCEEDED"]
    for done in (2, 4, 6):
        ours, theirs = [], []
        for i, name in enumerate(logs):
            cond = conditions[i] if i < done else "RUNNING"
            t, jt = Trial(name=name, experiment_name="es"), JaxTrial(name=name, experiment_name="es")
            t.condition, jt.condition = TrialCondition[cond], JaxTrialCondition[cond]
            ours.append(t)
            theirs.append(jt)
        got = ours_stopper.get_early_stopping_rules(ours_spec, ours, ours_store)
        want = jax_stopper.get_early_stopping_rules(jax_exp, theirs, jax_st)
        assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert got  # four trials succeeded: every case has a rule by now


@pytest.mark.parametrize("settings,match", [
    ({"min_trials_required": "0"}, "min_trials_required"),
    ({"start_step": "0"}, "start_step"),
    ({"window": "3"}, "unknown medianstop setting"),
])
def test_medianstop_settings_are_checked_as_jax_does(settings, match):
    doc = _doc(settings=settings)
    with pytest.raises(ValueError, match=match):
        JaxMedianStop().validate_settings(jax_spec.ExperimentSpec.from_dict(doc))
    with pytest.raises(ValueError, match=match):
        MedianStop().validate_settings(spec.ExperimentSpec.from_dict(doc))
    with pytest.raises(ValidationError, match=match):
        ExperimentController(devices=[torch.device("cpu")]).create_experiment(spec.ExperimentSpec.from_dict(
            dict(doc, trialTemplate={"entryPoint": "katib_tpu.models.mnist_cnn:run_mnist_trial"})))


def test_unknown_early_stopper_is_refused():
    with pytest.raises(KeyError, match="unknown early-stopping"):
        create_early_stopper("truncation")


def _rules(pkg, rows):
    return [pkg.EarlyStoppingRule(name=n, value=v, comparison=pkg.ComparisonType(c), start_step=s)
            for n, v, c, s in rows]


MONITOR_CASES = {
    # median stop's own rule: the running optimum of the objective at the 4th report
    "medianstop-max": (["0.5", "accuracy", "less", 4], "maximize", [0.1, 0.6, 0.2, 0.3, 0.1, 0.0]),
    "medianstop-min": (["1.0", "loss", "greater", 3], "minimize", [3.0, 2.0, 1.5, 0.5]),
    "trips-at-start-step": (["0.5", "accuracy", "less", 2], "maximize", [0.1, 0.2, 0.9]),
    "no-start-step": (["0.35", "accuracy", "greater", 0], "maximize", [0.1, 0.2, 0.4, 0.3]),
    "equal": (["0.25", "accuracy", "equal", 0], "maximize", [0.1, 0.25, 0.3]),
}


@pytest.mark.parametrize("case", list(MONITOR_CASES))
def test_monitor_decisions_match_jax(case):
    (value, metric, comparison, start_step), objective, values = MONITOR_CASES[case]
    rows = [(metric, value, comparison, start_step), ("other", "2.0", "greater", 0)]
    ours = EarlyStoppingMonitor(_rules(spec, rows), metric, spec.ObjectiveType(objective))
    theirs = JaxMonitor(_rules(jax_spec, rows), metric, jax_spec.ObjectiveType(objective))
    for i, v in enumerate(values):
        for name, x in ((metric, v), ("other", 1.0 + i)):
            assert ours.observe(name, x) == theirs.observe(name, x), (case, i, name)
    assert [r.to_dict() for r in ours.rules] == [r.to_dict() for r in theirs.rules]
    assert ours.optimal_obj_value == theirs.optimal_obj_value


def test_reporter_stores_the_report_then_raises_early_stopped():
    st = store.InMemoryObservationStore()
    rule = spec.EarlyStoppingRule(name="accuracy", value="0.5", comparison=spec.ComparisonType.LESS, start_step=2)
    monitor = EarlyStoppingMonitor([rule], "accuracy", spec.ObjectiveType.MAXIMIZE)
    reporter = MetricsReporter(st, "t", monitor=monitor)
    reporter.report(accuracy=0.1, loss=2.0)
    with pytest.raises(EarlyStopped):
        reporter.report(accuracy=0.2, loss=1.9)
    assert [r.value for r in st.get_observation_log("t", "accuracy")] == ["0.1", "0.2"]
    assert len(st.get_observation_log("t", "accuracy", limit=1)) == 1


def test_store_head_read_matches_jax():
    rows = [(3.0, "a", "3"), (1.0, "a", "1"), (2.0, "b", "2"), (2.5, "a", "x"), (0.5, "a", "0")]
    ours, theirs = store.InMemoryObservationStore(), jax_store.InMemoryObservationStore()
    ours.report_observation_log("t", [store.MetricLog(*r) for r in rows])
    theirs.report_observation_log("t", [jax_store.MetricLog(*r) for r in rows])
    for metric in ("a", None):
        for limit in (None, 0, 2, 9):
            got = [(r.timestamp, r.value) for r in ours.get_observation_log("t", metric, limit=limit)]
            want = [(r.timestamp, r.value) for r in theirs.get_observation_log("t", metric_name=metric, limit=limit)]
            assert got == want


def test_controller_ends_a_stopped_trial_early_stopped():
    """Median stop through the controller with plain Python trials, one at
    a time in grid order: the first three (x 0.9, 0.8, 0.7) succeed and set
    the rule accuracy < 0.3, the mean of their first two reports; x 0.1 and
    0.2 stay below it and stop at their second report, as early stopped and
    not failed; x 0.6 reaches 0.3 and succeeds."""
    def trial(assignments, ctx):
        x = float(assignments["x"])
        for epoch in range(4):
            ctx.report(accuracy=x * (epoch + 1) / 4)

    doc = _doc(settings={"min_trials_required": "3", "start_step": "2"})
    doc.update(maxTrialCount=6, parallelTrialCount=1, maxFailedTrialCount=1,
               parameters=[{"name": "x", "parameterType": "discrete",
                            "feasibleSpace": {"list": ["0.9", "0.8", "0.7", "0.1", "0.2", "0.6"]}}],
               algorithm={"algorithmName": "grid"})
    s = spec.ExperimentSpec.from_dict(doc)
    s.trial_template = spec.TrialTemplate(function=trial)
    ctrl = ExperimentController(devices=[torch.device("cpu")])
    ctrl.create_experiment(s)
    exp = ctrl.run("es", timeout=60)
    trials = ctrl.list_trials("es")
    ctrl.close()
    assert exp.status.is_succeeded and exp.status.reason == ExperimentReason.MAX_TRIALS_REACHED
    assert [t.condition for t in trials[:3]] == [TrialCondition.SUCCEEDED] * 3
    stopped = [t for t in trials if t.condition == TrialCondition.EARLY_STOPPED]
    assert [t.assignments_dict()["x"] for t in stopped] == ["0.1", "0.2"]
    assert exp.status.trials_early_stopped == 2 and exp.status.trials_failed == 0
    assert trials[-1].condition == TrialCondition.SUCCEEDED
    for t in stopped:
        assert len(ctrl.obs_store.get_observation_log(t.name, "accuracy")) == 2
