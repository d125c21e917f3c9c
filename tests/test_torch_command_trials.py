"""Command trials through the port's controller, on the CPU.

- ``render_command`` gives the JAX package's argv for a table of templates
  and trials, and its KeyError for a placeholder that resolves to nothing;
- admission refuses bad templates and collectors with the JAX package's
  messages, letter for letter (examples/trial-conditions.json, and
  examples/random.json for an in-process trial, with one change each);
- the port's own behaviour: a median-stop rule ends the trial EarlyStopped
  and kills its process group; the controller's timeout kills the child; a
  program that cannot be started fails its trial only, with the JAX
  package's exception; without ``retain`` a Succeeded trial's directory is
  removed and a Failed one's kept; a trial on CPU slots sees
  ``CUDA_VISIBLE_DEVICES=""``, and a trial on cards their indices;
- examples/trial-conditions.json runs whole through the port's CLI, and
  examples/pytorch-subprocess.json in a copy cut to 2 trials of 1 epoch,
  with this interpreter for argv[0] and the repository's root for
  workingDir. Its trials are the only children of these tests that import
  torch; every other child is a Python process of the standard library.
"""

import copy
import json
import os
import shutil
import sys
import textwrap
import time
from pathlib import Path

import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api import validation as jax_validation
from katib_tpu.api.defaults import set_defaults as jax_set_defaults
from katib_tpu.api.spec import ParameterAssignment as JaxAssignment
from katib_tpu.api.status import Experiment as JaxExperiment
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.controller.executor import SubprocessExecutor as JaxExecutor
from katib_tpu.controller.executor import TrialExecution as JaxHandle
from katib_tpu.controller.executor import render_command as jax_render_command
from katib_tpu.db.store import InMemoryObservationStore as JaxStore
from katib_tpu.runtime import metrics as jax_metrics
from katib_tpu.runtime.context import TrialContext as JaxContext
from katib_tpu_torch import cli
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.spec import ParameterAssignment
from katib_tpu_torch.api.status import ExperimentReason, Trial, TrialCondition
from katib_tpu_torch.controller.executor import cuda_visible_devices, render_command
from katib_tpu_torch.controller.experiment import ExperimentController

REPO = Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "katib_tpu", "scipy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    return json.loads((REPO / "examples" / f"{name}.json").read_text())


def _python(argv):
    """``argv`` with this interpreter for a leading ``python`` when ``python``
    on PATH is another one (or none): the examples name ``python``."""
    found = shutil.which("python")
    if argv[0] == "python" and (found is None or os.path.realpath(found) != os.path.realpath(sys.executable)):
        return [sys.executable] + argv[1:]
    return argv


def _child(body):
    return [sys.executable, "-c", textwrap.dedent(body)]


# -- rendering -------------------------------------------------------------------------

RENDER = {  # (command, trialParameters, assignments, labels)
    "by reference": (["train", "--lr=${trialParameters.learningRate}", "${trialParameters.m}"],
                     [("learningRate", "lr"), ("m", "momentum")], {"lr": "0.1", "momentum": "0.9"}, {}),
    "by name without an entry": (["train", "${trialParameters.lr}"], [], {"lr": "0.25"}, {}),
    "meta keys": (["run", "${trialSpec.Name}", "${trialSpec.Namespace}", "${trialSpec.Labels[team]}",
                   "${trialSpec.Labels[none]}", "${trialSpec.Annotations[a]}", "${trialSpec.Kind}"],
                  [], {}, {"team": "ml"}),
    "several in one argument": (["--args=${trialParameters.a},${trialParameters.b}:${trialSpec.Name}"],
                                [("a", "x"), ("b", "y")], {"x": "1", "y": "2"}, {}),
    "nothing to substitute": (["python", "-c", "print('$ {x}')"], [], {"lr": "1"}, {}),
}


@pytest.mark.parametrize("case", list(RENDER))
def test_render_command_gives_the_jax_packages_argv(case):
    command, params, assignments, labels = RENDER[case]
    ours = render_command(
        spec.TrialTemplate(command=command, trial_parameters=[spec.TrialParameterSpec(n, reference=r)
                                                              for n, r in params]),
        Trial(name="exp-abc", experiment_name="exp", labels=dict(labels),
              parameter_assignments=[ParameterAssignment(k, v) for k, v in assignments.items()]))
    theirs = jax_render_command(
        jax_spec.TrialTemplate(command=command, trial_parameters=[jax_spec.TrialParameterSpec(n, reference=r)
                                                                  for n, r in params]),
        JaxTrial(name="exp-abc", experiment_name="exp", labels=dict(labels),
                 parameter_assignments=[JaxAssignment(k, v) for k, v in assignments.items()]))
    assert ours == theirs


def test_an_unresolved_placeholder_raises_the_jax_packages_key_error():
    errors = []
    for render, template, trial in (
            (render_command, spec.TrialTemplate(command=["${trialParameters.gone}"]), Trial("t", "e")),
            (jax_render_command, jax_spec.TrialTemplate(command=["${trialParameters.gone}"]), JaxTrial("t", "e"))):
        with pytest.raises(KeyError) as e:
            render(template, trial)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# -- admission -----------------------------------------------------------------------

def _command(d, *argv):
    d["trialTemplate"]["command"] = list(argv)


REFUSED = {  # (example, change)
    "command and entryPoint": ("trial-conditions", lambda d: d["trialTemplate"].update(entryPoint="m:f")),
    "no command": ("trial-conditions", lambda d: d["trialTemplate"].pop("command")),
    "duplicate trial parameter": ("trial-conditions", lambda d: d["trialTemplate"]["trialParameters"].append(
        {"name": "lr", "reference": "lr"})),
    "trial parameter without reference": ("trial-conditions", lambda d: d["trialTemplate"]["trialParameters"][0]
                                          .pop("reference")),
    "reference outside the space": ("trial-conditions", lambda d: d["trialTemplate"]["trialParameters"][0]
                                    .update(reference="momentum")),
    "dangling placeholder": ("trial-conditions", lambda d: _command(d, "echo", "${trialParameters.lr}",
                                                                   "${trialParameters.batch}")),
    "unused trial parameter": ("trial-conditions", lambda d: _command(d, "echo", "1")),
    "unknown meta placeholder": ("trial-conditions", lambda d: _command(d, "echo", "${trialParameters.lr}",
                                                                       "${trialSpec.Uid}")),
    "condition syntax": ("trial-conditions", lambda d: d["trialTemplate"].update(successCondition="exit_code ==")),
    "condition call": ("trial-conditions", lambda d: d["trialTemplate"].update(failureCondition="len(stdout) > 1")),
    "condition name": ("trial-conditions", lambda d: d["trialTemplate"].update(successCondition="rc == 0")),
    "stdout in an in-process trial": ("random", lambda d: d["trialTemplate"].update(
        failureCondition="'nan' in stdout")),
    "numHosts 0": ("trial-conditions", lambda d: d["trialTemplate"].update(resources={"numHosts": 0})),
    "filter of one group": ("trial-conditions", lambda d: d.update(metricsCollectorSpec={
        "collector": {"kind": "File"}, "source": {"filePath": "m.log", "filter": {"metricsFormat": ["(\\w+)=.*"]}}})),
    "filter not a regex": ("trial-conditions", lambda d: d.update(metricsCollectorSpec={
        "collector": {"kind": "File"}, "source": {"filePath": "m.log", "filter": {"metricsFormat": ["(a"]}}})),
    "Custom without its program": ("trial-conditions", lambda d: d.update(metricsCollectorSpec={
        "collector": {"kind": "Custom"}})),
    "a program under StdOut": ("trial-conditions", lambda d: d.update(metricsCollectorSpec={
        "collector": {"kind": "StdOut", "customCollector": {"command": ["cat"]}}})),
    "File source without a path": ("trial-conditions", lambda d: d.update(metricsCollectorSpec={
        "collector": {"kind": "File"}, "source": {"fileFormat": "JSON"}})),
    "several at once": ("trial-conditions", lambda d: (
        d["trialTemplate"].update(successCondition="rc", failureCondition="x.y"), _command(d, "echo"))),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_bad_templates_and_collectors_are_refused_with_the_jax_packages_messages(case):
    name, change = REFUSED[case]
    doc = _example(name)
    change(doc)
    theirs = jax_set_defaults(jax_spec.ExperimentSpec.from_dict(copy.deepcopy(doc)))
    with pytest.raises(jax_validation.ValidationError) as jax_error:
        jax_validation.validate_experiment(theirs)
    with pytest.raises(spec.ValidationError) as port_error:
        ExperimentController(devices=CPU).create_experiment(spec.ExperimentSpec.from_dict(doc))
    assert port_error.value.errors == jax_error.value.errors


@pytest.mark.parametrize("name", ["trial-conditions", "pytorch-subprocess"])
def test_the_command_examples_are_admitted_by_both_and_default_to_stdout(name):
    doc = _example(name)
    theirs = jax_set_defaults(jax_spec.ExperimentSpec.from_dict(copy.deepcopy(doc)))
    jax_validation.validate_experiment(theirs)
    exp = ExperimentController(devices=CPU).create_experiment(spec.ExperimentSpec.from_dict(doc))
    assert exp.spec.metrics_collector_spec.to_dict() == theirs.metrics_collector_spec.to_dict() == \
        {"collector": {"kind": "StdOut"}}
    ours = exp.spec.to_dict()  # metric strategies are defaulted where they are read, not written
    assert {k: v for k, v in ours.items() if k != "objective"} == \
        {k: theirs.to_dict()[k] for k in ours if k != "objective"}
    assert ours["trialTemplate"]["trialParameters"] == [dict(p, description="") for p in
                                                        doc["trialTemplate"]["trialParameters"]]
    assert spec.ExperimentSpec.from_dict(ours).to_dict() == ours


# -- the port's own behaviour ---------------------------------------------------------

def _command_doc(command, name="cmd", trials=1, **extra):
    doc = {"name": name, "parameters": [{"name": "acc", "parameterType": "categorical",
                                         "feasibleSpace": {"list": ["0.9"]}}],
           "objective": {"type": "maximize", "objectiveMetricName": "accuracy"},
           "algorithm": {"algorithmName": "grid"}, "maxTrialCount": trials, "parallelTrialCount": 1,
           "trialTemplate": {"command": command, "trialParameters": [{"name": "acc", "reference": "acc"}]}}
    doc.update(extra)
    return doc


def _run(root, doc, timeout=60, devices=CPU):
    ctrl = ExperimentController(root_dir=str(root), devices=devices)
    ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))
    t0 = time.monotonic()
    exp = ctrl.run(doc["name"], timeout=timeout)
    wall = time.monotonic() - t0
    trials = ctrl.list_trials(doc["name"])
    ctrl.close()
    return exp, trials, wall


def _gone(pid, within=10.0):
    """The process has exited (reaped, or a zombie) within ``within`` seconds."""
    deadline = time.monotonic() + within
    while time.monotonic() < deadline:
        try:
            with open(f"/proc/{pid}/stat") as f:
                if f.read().rsplit(")", 1)[1].split()[0] == "Z":
                    return True
        except FileNotFoundError:
            return True
        time.sleep(0.05)
    return False


STOPPED_CHILD = """
    import subprocess, sys, time
    acc = sys.argv[1]
    if float(acc) < 0.5:  # the trial the rule stops: it leaves a grandchild in its process group
        grandchild = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        print(f"grandchild {grandchild.pid}", flush=True)
    for _ in range(2):
        print(f"accuracy={acc}", flush=True)
    if float(acc) < 0.5:
        time.sleep(60)
"""


def test_a_median_stop_rule_kills_the_trials_process_group(tmp_path):
    """Median stop after 2 trials at step 2: the third trial, at accuracy 0.1
    below the mean of 0.9 and 0.8, is stopped at its second report; its
    process and the grandchild it started are killed."""
    doc = _command_doc(_child(STOPPED_CHILD) + ["${trialParameters.acc}"], name="stop", trials=3,
                       earlyStopping={"algorithmName": "medianstop", "algorithmSettings": [
                           {"name": "min_trials_required", "value": "2"}, {"name": "start_step", "value": "2"}]})
    doc["parameters"][0]["feasibleSpace"]["list"] = ["0.9", "0.8", "0.1"]
    doc["trialTemplate"]["retain"] = True
    exp, trials, wall = _run(tmp_path, doc)
    assert [t.condition for t in trials] == [TrialCondition.SUCCEEDED] * 2 + [TrialCondition.EARLY_STOPPED]
    assert trials[2].conditions[-1].reason == "TrialEarlyStopped" and wall < 30
    assert exp.status.reason == ExperimentReason.MAX_TRIALS_REACHED
    out = (tmp_path / "stop" / trials[2].name / "stdout.log").read_text()
    assert out.count("accuracy=0.1") == 2
    assert _gone(int(out.split("grandchild ")[1].split()[0]))


def test_the_controllers_timeout_kills_the_child(tmp_path):
    doc = _command_doc(_child("import os, time; print(f'pid {os.getpid()}', flush=True); time.sleep(60)"),
                       name="slow")
    doc["trialTemplate"]["trialParameters"] = []
    exp, trials, wall = _run(tmp_path, doc, timeout=1.0)
    assert wall < 15 and not exp.status.is_succeeded and "timed out" in exp.status.message
    assert trials[0].condition == TrialCondition.KILLED and trials[0].message == "kill requested"
    out = (tmp_path / "slow" / trials[0].name / "stdout.log").read_text()
    assert _gone(int(out.split("pid ")[1].split()[0]))


def test_a_program_that_cannot_start_fails_its_trial_as_in_the_jax_package(tmp_path):
    """Both trials fail with the exception the JAX executor raises for the
    same template; the controller ends the experiment by its failure budget."""
    missing = str(tmp_path / "no-such-program")
    doc = _command_doc([missing, "${trialParameters.acc}"], name="missing", trials=2, maxFailedTrialCount=2)
    doc["parameters"][0]["feasibleSpace"]["list"] = ["0.9", "0.8"]
    exp, trials, _ = _run(tmp_path, doc)
    assert exp.status.reason == ExperimentReason.MAX_FAILED_TRIALS_REACHED
    assert [t.condition for t in trials] == [TrialCondition.FAILED] * 2
    s = jax_set_defaults(jax_spec.ExperimentSpec.from_dict(doc))
    trial = JaxTrial("missing-1", "missing", [JaxAssignment("acc", "0.9")])
    ctx = JaxContext("missing-1", "missing", {"acc": "0.9"}, jax_metrics.MetricsReporter(JaxStore(), "missing-1"),
                     workdir=str(tmp_path / "jax"))
    with pytest.raises(FileNotFoundError) as jax_error:
        JaxExecutor(JaxStore()).execute(JaxExperiment(spec=s), trial, ctx, JaxHandle())
    for t in trials:
        assert t.conditions[-1].reason == "TrialFailed"
        assert t.message.strip().splitlines()[-1] == f"FileNotFoundError: {jax_error.value}"


def test_retain_keeps_directories_as_in_the_jax_package(tmp_path):
    """Without retain the Succeeded trial's directory goes and the Failed
    one's stays (its stdout.log for a post-mortem); with retain both stay."""
    body = "import sys; print(f'accuracy={sys.argv[1]}'); sys.exit(0 if float(sys.argv[1]) > 0.5 else 1)"
    for retain in (False, True):
        doc = _command_doc(_child(body) + ["${trialParameters.acc}"], name=f"retain-{str(retain).lower()}",
                           trials=2, maxFailedTrialCount=2)
        doc["parameters"][0]["feasibleSpace"]["list"] = ["0.9", "0.1"]
        doc["trialTemplate"]["retain"] = retain
        _, trials, _ = _run(tmp_path, doc)
        assert [t.condition for t in trials] == [TrialCondition.SUCCEEDED, TrialCondition.FAILED]
        assert [(tmp_path / doc["name"] / t.name).exists() for t in trials] == [retain, True]
        assert (tmp_path / doc["name"] / trials[1].name / "stdout.log").read_text() == "accuracy=0.1\n"


def test_a_trial_on_cpu_slots_sees_no_card(tmp_path):
    doc = _command_doc(_child("import os; print(f\"CVD=[{os.environ['CUDA_VISIBLE_DEVICES']}] accuracy=1\")"),
                       name="cards")
    doc["trialTemplate"].update(trialParameters=[], successCondition="'CVD=[]' in stdout")
    _, trials, _ = _run(tmp_path, doc)
    assert trials[0].condition == TrialCondition.SUCCEEDED, trials[0].message
    assert trials[0].message == "Trial has succeeded"  # the condition's message is the result's, not the trial's


@pytest.mark.parametrize("slots,parent,want", [
    ([torch.device("cpu")], None, ""),
    ([torch.device("cuda", 0)], None, "0"),
    ([torch.device("cuda", 1), torch.device("cuda", 3)], None, "1,3"),
    ([torch.device("cuda", 1)], "4,6", "6"),
    ([torch.device("cuda", 0), torch.device("cuda", 1)], "GPU-a, GPU-b", "GPU-a,GPU-b"),
    ([0, "slot"], None, ""),
])
def test_a_trial_on_cards_sees_their_indices(slots, parent, want):
    assert cuda_visible_devices(slots, parent) == want


# -- the examples through the CLI ----------------------------------------------------

def _cli_run(root, doc, cwd=None):
    path = root / f"{doc['name']}.json"
    path.write_text(json.dumps(doc))
    before = set(sys.modules)
    rc = cli.main(["run", str(path), "--root", str(root), "--device", "cpu", "--timeout", "120"])
    imported = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in JAX_MODULES)
    record = json.loads((root / doc["name"] / "experiment.json").read_text())
    return rc, record, imported


def test_trial_conditions_json_runs_whole_through_the_cli(tmp_path):
    doc = _example("trial-conditions")
    doc["trialTemplate"]["command"] = _python(doc["trialTemplate"]["command"])
    rc, record, imported = _cli_run(tmp_path, doc)
    status, trials = record["experiment"]["status"], record["trials"]
    failed = [t for t in trials if float(t["parameterAssignments"][0]["value"]) > 0.3]
    if len(failed) >= doc["maxFailedTrialCount"]:
        assert status["reason"] == "ExperimentMaxFailedTrialsReached"
    else:
        assert rc == 0 and status["reason"] == "ExperimentMaxTrialsReached" and len(trials) == 8
    for t in trials:
        lr = float(t["parameterAssignments"][0]["value"])
        if lr > 0.3:
            assert t["condition"] == "Failed"
            assert t["message"] == "failure condition met: 'LOSS DIVERGED' in stdout"
            assert (tmp_path / doc["name"] / t["name"] / "stdout.log").read_text() == "LOSS DIVERGED\n"
        else:
            assert t["condition"] == "Succeeded" and t["message"] == "Trial has succeeded"
            assert record["logs"][t["name"]] == [[t["startTime"], "score", repr(1 - (lr - 0.05) ** 2)]]
            assert not (tmp_path / doc["name"] / t["name"]).exists()
    assert imported == []


def test_pytorch_subprocess_json_runs_in_a_cut_copy_through_the_cli(tmp_path):
    """2 trials of 1 epoch (and a failure budget of 2); the experiment ends as Katib's rules say: goal
    0.99 reached by a trial (the other one is then killed, or never
    started), or both trials run."""
    doc = _example("pytorch-subprocess")
    command = doc["trialTemplate"]["command"]
    command[command.index("--epochs") + 1] = "1"
    doc["trialTemplate"]["command"] = [sys.executable] + command[1:]
    doc["trialTemplate"]["workingDir"] = str(REPO)
    doc["maxTrialCount"] = doc["maxFailedTrialCount"] = 2  # admission: no more failures than trials
    rc, record, imported = _cli_run(tmp_path, doc)
    status, trials = record["experiment"]["status"], record["trials"]
    ran = [t for t in trials if t["condition"] == "Succeeded"]
    assert rc == 0 and ran and imported == []
    for t in ran:
        rows = record["logs"][t["name"]]
        assert [m for _, m, _ in rows] == ["loss", "accuracy"]  # "epoch" is not stored
        assert all(0 <= float(v) < float("inf") for _, _, v in rows)
        assert not (tmp_path / doc["name"] / t["name"]).exists()  # retain: false
    best = max(float(v) for t in ran for _, m, v in record["logs"][t["name"]] if m == "accuracy")
    if best >= 0.99:
        assert status["reason"] == "ExperimentGoalReached"
        assert {t["condition"] for t in trials} <= {"Succeeded", "Killed"}
    else:
        assert status["reason"] == "ExperimentMaxTrialsReached" and len(ran) == 2
