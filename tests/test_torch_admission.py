"""The port's admission, request count and duplicate-result reuse against the
JAX package's, on the CPU.

- specs that the JAX package's validator refuses (examples/random.json with
  one change each, and reuseDuplicateResults without maxTrialCount) are
  refused by the port's controller with the same messages;
- the number of trials the controller asks for equals
  katib_tpu.controller.suggestion.suggestion_request_plan's for mixes of
  trial conditions, and an experiment whose first trial never reports
  makes the JAX controller's four trials;
- with reuseDuplicateResults, a trial whose assignments equal a Succeeded
  trial's takes its metric log without running; without it, every trial
  runs.
"""

import copy
import json
import threading
from collections import Counter
from pathlib import Path

import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api import validation as jax_validation
from katib_tpu.api.defaults import set_defaults as jax_set_defaults
from katib_tpu.api.status import Experiment as JaxExperiment
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.controller.experiment import ExperimentController as JaxController
from katib_tpu.controller.suggestion import suggestion_request_plan as jax_request_plan
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Experiment, Trial, TrialCondition
from katib_tpu_torch.controller.experiment import ExperimentController
from katib_tpu_torch.controller.suggestion import suggestion_request_plan
from katib_tpu_torch.models import mnist_cnn

REPO = Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    return json.loads((REPO / "examples" / f"{name}.json").read_text())


# -- admission -----------------------------------------------------------------

def _drop_max_trials(d):
    del d["maxTrialCount"]


REFUSED = {  # examples/random.json with one change each
    "upper-case name": lambda d: d.update(name="Random-Example"),
    "maxFailedTrialCount 99": lambda d: d.update(maxFailedTrialCount=99),
    "parallelTrialCount 99": lambda d: d.update(parallelTrialCount=99),
    "objective among additional metrics": lambda d: d["objective"].update(additionalMetricNames=["accuracy", "loss"]),
    "double with a list": lambda d: d["parameters"][0]["feasibleSpace"].update(list=["0.1"]),
    "categorical with min": lambda d: d["parameters"].append(
        {"name": "opt", "parameterType": "categorical", "feasibleSpace": {"list": ["sgd", "adam"], "min": "0"}}),
    "empty feasibleSpace": lambda d: d["parameters"].append(
        {"name": "z", "parameterType": "double", "feasibleSpace": {}}),
    "reuse without maxTrialCount": lambda d: (d.update(reuseDuplicateResults=True), _drop_max_trials(d)),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_specs_the_jax_package_refuses_are_refused_with_its_message(case):
    doc = _example("random")
    REFUSED[case](doc)
    theirs = jax_spec.ExperimentSpec.from_dict(copy.deepcopy(doc))
    jax_set_defaults(theirs)
    with pytest.raises(jax_validation.ValidationError) as jax_error:
        jax_validation.validate_experiment(theirs)
    with pytest.raises(spec.ValidationError) as port_error:
        ExperimentController(devices=CPU).create_experiment(spec.ExperimentSpec.from_dict(doc))
    assert str(jax_error.value) in str(port_error.value)
    assert port_error.value.errors == jax_error.value.errors


def test_random_json_itself_is_admitted_by_both():
    doc = _example("random")
    theirs = jax_spec.ExperimentSpec.from_dict(copy.deepcopy(doc))
    jax_set_defaults(theirs)
    jax_validation.validate_experiment(theirs)
    ExperimentController(devices=CPU).create_experiment(spec.ExperimentSpec.from_dict(doc))


# -- how many trials to ask for ---------------------------------------------------

MIXES = {  # (maxTrialCount, parallelTrialCount, trial conditions)
    "empty": (12, 3, []),
    "pending and running": (12, 3, ["PENDING", "RUNNING"]),
    "created": (12, 3, ["CREATED", "SUCCEEDED"]),
    "two done, one running": (12, 3, ["SUCCEEDED", "SUCCEEDED", "RUNNING"]),
    "metrics unavailable frees a place": (3, 3, ["METRICS_UNAVAILABLE", "RUNNING", "RUNNING"]),
    "every terminal kind": (12, 3, ["FAILED", "KILLED", "EARLY_STOPPED", "METRICS_UNAVAILABLE", "PENDING"]),
    "near the budget": (12, 3, ["SUCCEEDED"] * 10 + ["RUNNING"]),
    "budget spent": (4, 2, ["SUCCEEDED", "FAILED", "KILLED", "EARLY_STOPPED"]),
    "only unavailable": (3, 3, ["METRICS_UNAVAILABLE"] * 3),
    "no budget": (None, 3, ["SUCCEEDED"] * 5 + ["RUNNING"]),
    "no budget, idle": (None, 2, ["FAILED", "METRICS_UNAVAILABLE"]),
    "over-full": (6, 2, ["RUNNING", "RUNNING", "PENDING"]),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_request_count_matches_the_jax_plan(mix):
    max_trials, parallel, conditions = MIXES[mix]
    doc = dict(_example("random"), maxTrialCount=max_trials, parallelTrialCount=parallel)
    ours = [Trial(name=f"t{i}", experiment_name="e", condition=TrialCondition[c]) for i, c in enumerate(conditions)]
    theirs = [JaxTrial(name=f"t{i}", experiment_name="e") for i in range(len(conditions))]
    for t, c in zip(theirs, conditions):
        t.condition = JaxTrialCondition[c]
    want, _ = jax_request_plan(JaxExperiment(spec=jax_spec.ExperimentSpec.from_dict(doc)), theirs, lambda t: True)
    assert suggestion_request_plan(Experiment(spec=spec.ExperimentSpec.from_dict(doc)), ours) == want


def _first_never_reports():
    """A trial function whose first call returns without reporting; the
    three others wait until all three run, report, and wait until all
    three reported, so neither controller can end the experiment between
    their reports. The barriers wait long enough that load alone never
    breaks them; a controller that runs fewer than three reporting trials
    still breaks them, and its trials then fail."""
    lock, calls = threading.Lock(), [0]
    started, reported = threading.Barrier(3, timeout=60), threading.Barrier(3, timeout=60)

    def trial(assignments, ctx):
        with lock:
            calls[0] += 1
            first = calls[0] == 1
        if first:
            return
        started.wait()
        ctx.report(loss=float(assignments["x"]))
        reported.wait()

    return trial


def _never_reporting_doc():
    return {
        "name": "never-reports", "maxTrialCount": 3, "parallelTrialCount": 3, "maxFailedTrialCount": 3,
        "parameters": [{"name": "x", "parameterType": "double", "feasibleSpace": {"min": "0", "max": "1"}}],
        "objective": {"type": "minimize", "objectiveMetricName": "loss"},
        "algorithm": {"algorithmName": "random", "algorithmSettings": [{"name": "random_state", "value": "0"}]},
    }


def test_a_trial_that_never_reports_is_replaced_as_the_jax_controller_replaces_it(tmp_path):
    theirs = jax_spec.ExperimentSpec.from_dict(_never_reporting_doc())
    theirs.trial_template = jax_spec.TrialTemplate(function=_first_never_reports())
    jax_ctrl = JaxController(root_dir=str(tmp_path), devices=[0, 1, 2])
    try:
        jax_ctrl.create_experiment(theirs)
        jax_exp = jax_ctrl.run(theirs.name, timeout=180)
        jax_conditions = Counter(t.condition.value for t in jax_ctrl.state.list_trials(theirs.name))
    finally:
        jax_ctrl.close()

    ours = spec.ExperimentSpec.from_dict(_never_reporting_doc())
    ours.trial_template = spec.TrialTemplate(function=_first_never_reports())
    ctrl = ExperimentController(devices=[torch.device("cpu", i) for i in range(3)])
    try:
        ctrl.create_experiment(ours)
        exp = ctrl.run(ours.name, timeout=180)
        conditions = Counter(t.condition.value for t in ctrl.list_trials(ours.name))
    finally:
        ctrl.close()
    assert jax_conditions == {"MetricsUnavailable": 1, "Succeeded": 3}
    assert conditions == jax_conditions
    assert exp.status.reason.value == jax_exp.status.reason.value == "ExperimentMaxTrialsReached"


# -- duplicate-result reuse --------------------------------------------------------

def _reuse_doc(reuse):
    """reuse-duplicate-results.json over 2 points (lr 0.05, batch 16 or 32),
    4 trials one at a time, on 64 training images."""
    doc = _example("reuse-duplicate-results")
    lists = {"lr": ["0.05"], "batch_size": ["16", "32"], "num_train_examples": ["64"]}
    for p in doc["parameters"]:
        p["feasibleSpace"]["list"] = lists[p["name"]]
    doc.update(name=f"reuse-{str(reuse).lower()}", maxTrialCount=4, parallelTrialCount=1,
               reuseDuplicateResults=reuse)
    doc["algorithm"]["algorithmSettings"] = [{"name": "random_state", "value": "3"}]
    return doc


@pytest.fixture(scope="module")
def reuse_runs(tmp_path_factory):
    """Both runs on the CPU through the port's controller, counting the
    trial function's calls: {flag: (experiment, trials, logs, calls)}."""
    runs = {}
    for reuse in (True, False):
        calls = []
        ctrl = ExperimentController(root_dir=str(tmp_path_factory.mktemp("reuse")), devices=CPU)
        original = mnist_cnn.run_mnist_trial
        mnist_cnn.run_mnist_trial = lambda a, ctx=None: (calls.append(dict(a)), original(a, ctx))[1]
        try:
            ctrl.create_experiment(spec.ExperimentSpec.from_dict(_reuse_doc(reuse)))
            exp = ctrl.run(f"reuse-{str(reuse).lower()}", timeout=120)
            trials = ctrl.list_trials(exp.name)
            logs = {t.name: [(r.timestamp, r.metric_name, r.value) for r in ctrl.obs_store.get_observation_log(t.name)]
                    for t in trials}
        finally:
            mnist_cnn.run_mnist_trial = original
            ctrl.close()
        runs[reuse] = exp, trials, logs, calls
    return runs


def _reason(trial):
    return trial.conditions[-1].reason


def test_duplicates_reuse_their_sources_result(reuse_runs):
    exp, trials, logs, calls = reuse_runs[True]
    assert exp.status.is_succeeded and exp.status.reason.value == "ExperimentMaxTrialsReached"
    assert len(trials) == 4 and all(t.condition == TrialCondition.SUCCEEDED for t in trials)
    reused = [t for t in trials if _reason(t) == "DuplicateResultReused"]
    ran = [t for t in trials if _reason(t) != "DuplicateResultReused"]
    # one at a time over 2 points: the 3rd and 4th draws repeat a finished trial
    assert len(reused) >= 2 and len(calls) == len(ran) == len({tuple(sorted(c.items())) for c in calls})
    by_name = {t.name: t for t in trials}
    for t in reused:
        source = by_name[t.message.split("reused result of trial ")[1].split(" ")[0]]
        assert source in ran and source.assignments_dict() == t.assignments_dict()
        assert logs[t.name] == logs[source.name] and logs[t.name]
        assert t.observation.to_dict() == source.observation.to_dict()
        assert [c.type for c in t.conditions] == ["Pending", "Running", "Succeeded"] and t.completion_time - t.start_time < 0.1
        assert trials.index(source) < trials.index(t)


def test_without_the_flag_every_trial_runs(reuse_runs):
    exp, trials, logs, calls = reuse_runs[False]
    assert exp.status.is_succeeded and len(trials) == 4 == len(calls)
    assert all(_reason(t) != "DuplicateResultReused" and logs[t.name] for t in trials)
    assert len({tuple(sorted(t.assignments_dict().items())) for t in trials}) <= 2


def test_reuse_round_trips_as_the_jax_package_writes_it():
    doc = _reuse_doc(True)
    theirs = jax_spec.ExperimentSpec.from_dict(doc).to_dict()
    ours = spec.ExperimentSpec.from_dict(theirs).to_dict()
    assert ours["reuseDuplicateResults"] is True and ours == {k: theirs[k] for k in ours}
    assert "reuseDuplicateResults" not in spec.ExperimentSpec.from_dict(_reuse_doc(False)).to_dict()


def test_a_lineage_trial_is_never_a_source_or_a_target():
    """A trial trained from a parent's checkpoint (the checkpoint-lineage
    label) neither lends nor takes a result."""
    ctrl = ExperimentController(devices=CPU)
    s = spec.ExperimentSpec.from_dict(dict(_reuse_doc(True), name="lineage"))
    exp = ctrl.create_experiment(s)
    assignments = [spec.ParameterAssignment("lr", "0.05"), spec.ParameterAssignment("batch_size", "16")]

    def trial(name, labels, condition=TrialCondition.PENDING):
        t = Trial(name=name, experiment_name="lineage", parameter_assignments=list(assignments), labels=labels)
        t.condition = condition
        return t

    ctrl._trials["lineage"]["parent"] = trial("parent", {"checkpoint-lineage": "1"}, TrialCondition.SUCCEEDED)
    assert not ctrl._reuse_duplicate(exp, trial("a", {}))
    ctrl._trials["lineage"]["plain"] = trial("plain", {}, TrialCondition.SUCCEEDED)
    assert not ctrl._reuse_duplicate(exp, trial("b", {"checkpoint-lineage": "1"}))
    target = trial("c", {})
    assert ctrl._reuse_duplicate(exp, target) and "trial plain" in target.message
    ctrl.close()
