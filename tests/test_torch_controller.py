"""The port's control plane on the CPU: an end-to-end TPE experiment of LM
trials through katib_tpu_torch's controller, parity of the copied spec,
suggester and fold code with the JAX package's, the CUDA probe's refusal to
run on the CPU unasked, and a scan of the package's sources for imports of
JAX or katib_tpu. The run in a fresh interpreter (CLI, no JAX loaded) is in
test_torch_flash_attention.py.
"""

import json
import re
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api import validation as jax_validation
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.db import store as jax_store
from katib_tpu.suggest import base as jax_suggest
from katib_tpu.suggest import vectorized as jax_vectorized
from katib_tpu.suggest.random_search import RandomSearch as JaxRandomSearch
from katib_tpu.suggest.tpe import TPE as JaxTPE
from katib_tpu.suggest.tpe import MultivariateTPE as JaxMultivariateTPE
from katib_tpu_torch import cli
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import ExperimentReason, Trial, TrialCondition
from katib_tpu_torch.controller.experiment import ExperimentController
from katib_tpu_torch.db import store
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.utils import backend

REPO = Path(__file__).resolve().parents[1]
EXAMPLE = REPO / "katib_tpu_torch" / "examples" / "lm-h100.json"
SMALL = {"vocab_size": "512", "embed_dim": "128", "num_layers": "2", "num_heads": "4",
         "seq_len": "128", "batch_size": "2", "num_steps": "5"}
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX compiles and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _small_doc(name="lm-cpu", trials=2):
    doc = json.loads(EXAMPLE.read_text())
    doc["name"] = name
    for p in doc["parameters"]:
        if p["name"] in SMALL:
            p["feasibleSpace"]["list"] = [SMALL[p["name"]]]
    doc["maxTrialCount"] = trials
    return doc


# -- the end-to-end CPU experiment -------------------------------------------

@pytest.fixture(scope="module")
def cpu_experiment(tmp_path_factory):
    """2 TPE trials x 5 steps of the CPU smoke LM (E 128, 2 layers, T 128)."""
    root = tmp_path_factory.mktemp("runs")
    ctrl = ExperimentController(root_dir=str(root), devices=CPU)
    ctrl.create_experiment(spec.ExperimentSpec.from_dict(_small_doc()))
    exp = ctrl.run("lm-cpu", timeout=120)
    trials = ctrl.list_trials("lm-cpu")
    ctrl.close()
    return ctrl, exp, trials, root


def test_cpu_experiment_reaches_max_trials(cpu_experiment):
    _, exp, trials, _ = cpu_experiment
    assert exp.status.reason == ExperimentReason.MAX_TRIALS_REACHED
    assert exp.status.is_succeeded and exp.status.trials_succeeded == 2 == len(trials)
    assert all(t.condition == TrialCondition.SUCCEEDED for t in trials)


def test_cpu_experiment_has_an_optimal_trial(cpu_experiment):
    ctrl, exp, trials, _ = cpu_experiment
    best = exp.status.current_optimal_trial
    losses = {t.name: float(t.observation.metric("loss").min) for t in trials}
    assert best.best_trial_name == min(losses, key=losses.get)
    assert {a.name for a in best.parameter_assignments} >= {"learning_rate", "embed_dim"}
    for t in trials:
        rows = ctrl.obs_store.get_observation_log(t.name, "loss")
        assert len(rows) == 1 and np.isfinite(float(rows[0].value))  # 5 steps: one report


def test_cpu_experiment_record_is_written(cpu_experiment):
    *_, root = cpu_experiment
    doc = json.loads((root / "lm-cpu" / "experiment.json").read_text())
    assert doc["experiment"]["status"]["reason"] == "ExperimentMaxTrialsReached"
    assert len(doc["trials"]) == 2 and all(doc["logs"].values())


def test_cli_status_reads_the_record(cpu_experiment, capsys):
    root = str(cpu_experiment[-1])
    assert cli.main(["status", "lm-cpu", "--root", root]) == 0
    out = capsys.readouterr().out
    assert "Succeeded (ExperimentMaxTrialsReached)" in out and "optimal trial" in out
    assert cli.main(["status", "lm-cpu", "--root", root, "--format", "json"]) == 0
    assert json.loads(capsys.readouterr().out)["status"]["trials"] == 2
    assert cli.main(["status", "missing", "--root", root]) == 1


def test_cli_refuses_a_bad_spec(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps(dict(_small_doc(), algorithm={"algorithmName": "nope"})))
    assert cli.main(["run", str(path), "--root", str(tmp_path), "--device", "cpu"]) == 2


# -- the spec and the example -------------------------------------------------

def test_example_is_the_full_width_lm():
    doc = json.loads(EXAMPLE.read_text())
    s = spec.ExperimentSpec.from_dict(doc)
    fixed = {p.name: p.feasible_space.list for p in s.parameters if p.feasible_space.list}
    assert fixed == {"vocab_size": ["32768"], "embed_dim": ["1024"], "num_layers": ["8"], "num_heads": ["16"],
                     "seq_len": ["2048"], "batch_size": ["4"], "num_steps": ["10"]}
    lr = s.parameters[0]
    assert (lr.name, lr.feasible_space.min, lr.feasible_space.max) == ("learning_rate", "1e-4", "1e-2")
    assert lr.feasible_space.distribution == spec.Distribution.LOG_UNIFORM
    assert s.algorithm.algorithm_name == "tpe"
    assert s.trial_template.entry_point == "katib_tpu_torch.parallel.train:run_lm_trial"
    assert s.trial_template.resources.num_devices == 1
    assert (s.max_trial_count, s.parallel_trial_count) == (3, 1)


def test_spec_round_trip_matches_the_jax_package():
    doc = json.loads(EXAMPLE.read_text())
    ours = spec.ExperimentSpec.from_dict(doc).to_dict()
    theirs = jax_spec.ExperimentSpec.from_dict(doc).to_dict()
    assert ours == {k: theirs[k] for k in ours}
    assert spec.ExperimentSpec.from_json(json.dumps(ours)).to_dict() == ours


def test_command_templates_are_refused():
    with pytest.raises(ValueError, match="entryPoint"):
        spec.TrialTemplate.from_dict({"command": ["python", "train.py"]})


@pytest.mark.parametrize("section,value", [
    ("reuseDuplicateResults", True),
    ("metricsCollectorSpec", {"collector": {"kind": "StdOut"}}),
    ("resumePolicy", "LongRunning"),
    ("priorityClass", "high"),
    ("fairShareWeight", 2.0),
    ("tenant", "a"),  # a key the port does not know at all
])
def test_sections_the_port_does_not_carry_are_refused(section, value):
    doc = dict(_small_doc(), **{section: value})
    if section == "reuseDuplicateResults":
        # carried: refused at admission only without a trial budget, with the JAX package's message
        del doc["maxTrialCount"]
        message = "reuseDuplicateResults requires maxTrialCount to bound the experiment"
        with pytest.raises(jax_validation.ValidationError, match=message):
            jax_validation.validate_experiment(jax_spec.ExperimentSpec.from_dict(doc))
        with pytest.raises(spec.ValidationError, match=message):
            ExperimentController(devices=CPU).create_experiment(spec.ExperimentSpec.from_dict(doc))
        return
    with pytest.raises(spec.ValidationError, match=repr(section)):
        spec.ExperimentSpec.from_dict(doc)


def test_default_sections_and_comments_are_accepted():
    """What the JAX package writes by default (push collector, resumePolicy
    Never) and a false reuseDuplicateResults parse; _comment keys are
    ignored; earlyStopping round-trips as the JAX package writes it."""
    doc = dict(_small_doc(), _comment="notes", reuseDuplicateResults=False, fairShareWeight=1,
               earlyStopping={"algorithmName": "medianstop",
                              "algorithmSettings": [{"name": "start_step", "value": "2"}]})
    theirs = jax_spec.ExperimentSpec.from_dict(doc).to_dict()
    assert theirs["metricsCollectorSpec"] == {"collector": {"kind": "Push"}} and theirs["resumePolicy"] == "Never"
    ours = spec.ExperimentSpec.from_dict(theirs).to_dict()
    assert ours == {k: theirs[k] for k in ours} and ours["earlyStopping"]["algorithmName"] == "medianstop"
    assert spec.ExperimentSpec.from_dict(dict(doc, metricsCollectorSpec={})).early_stopping is not None


def test_jax_package_entry_points_resolve_to_the_port(monkeypatch):
    """A ported katib_tpu trial resolves to katib_tpu_torch's; an unported
    one raises ValidationError before anything is imported; an entry point
    outside the JAX package is left as it is."""
    from katib_tpu_torch.controller import experiment as ce

    assert ce.port_entry_point("katib_tpu.models.mnist_cnn:run_mnist_trial") == \
        "katib_tpu_torch.models.mnist_cnn:run_mnist_trial"
    assert ce.port_entry_point("katib_tpu.parallel.train:run_lm_trial") == \
        "katib_tpu_torch.parallel.train:run_lm_trial"
    assert ce.port_entry_point("mypkg.trial:run") == "mypkg.trial:run"
    fn = ce.resolve_entry_point(spec.TrialTemplate(entry_point="katib_tpu.models.mnist_cnn:run_mnist_trial"))
    assert fn.__module__ == "katib_tpu_torch.models.mnist_cnn"
    monkeypatch.setattr(ce.importlib, "import_module", lambda name: pytest.fail(f"imported {name}"))
    for entry in ("katib_tpu.models.simple_pbt:run_pbt_trial", "katib_tpu:main"):
        with pytest.raises(ce.ValidationError, match="not yet ported"):
            ce.resolve_entry_point(spec.TrialTemplate(entry_point=entry))


# -- suggesters and folding, against the JAX package's -------------------------

def _history(n, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        lr = float(np.exp(rng.uniform(np.log(1e-4), np.log(1e-2))))
        rows.append((f"t{i}", dict(SMALL, learning_rate=repr(lr)), float(rng.uniform(1, 5))))
    return rows


def _requests(n_trials, algorithm, want=3, settings=None):
    doc = _small_doc()
    doc["algorithm"] = {"algorithmName": algorithm,
                        "algorithmSettings": [{"name": k, "value": v} for k, v in (settings or {}).items()]}
    ours_spec, jax_exp = spec.ExperimentSpec.from_dict(doc), jax_spec.ExperimentSpec.from_dict(doc)
    ours, theirs = [], []
    for name, assign, loss in _history(n_trials):
        metric = {"name": "loss", "min": repr(loss), "max": repr(loss), "latest": repr(loss)}
        t = Trial(name=name, experiment_name="lm-cpu",
                  parameter_assignments=[spec.ParameterAssignment(k, v) for k, v in assign.items()])
        t.condition, t.observation = TrialCondition.SUCCEEDED, spec.Observation([spec.Metric(**metric)])
        jt = JaxTrial(name=name, experiment_name="lm-cpu",
                      parameter_assignments=[jax_spec.ParameterAssignment(k, v) for k, v in assign.items()])
        jt.condition, jt.observation = JaxTrialCondition.SUCCEEDED, jax_spec.Observation([jax_spec.Metric(**metric)])
        ours.append(t)
        theirs.append(jt)
    return (suggest.SuggestionRequest(ours_spec, ours, want),
            jax_suggest.SuggestionRequest(jax_exp, theirs, want))


def _values(reply):
    return [[(a.name, a.value) for a in s.parameter_assignments] for s in reply.assignments]


@pytest.mark.parametrize("algorithm,n_trials", [("tpe", 0), ("tpe", 12), ("multivariate-tpe", 12),
                                                ("random", 4)])
def test_suggestions_match_the_jax_oracle(monkeypatch, algorithm, n_trials):
    monkeypatch.setattr(jax_vectorized, "_ENABLED", False)  # the JAX package's NumPy oracle path
    ours, theirs = _requests(n_trials, algorithm, settings={"random_state": "7", "n_startup_trials": "10"})
    got = _values(suggest.create(algorithm).get_suggestions(ours))
    jax_cls = {"tpe": JaxTPE, "multivariate-tpe": JaxMultivariateTPE, "random": JaxRandomSearch}[algorithm]
    want = _values(jax_cls().get_suggestions(theirs))
    assert got == want and len(got) == 3


def test_tpe_settings_are_validated():
    ours, _ = _requests(0, "tpe", settings={"gamma": "1.5"})
    with pytest.raises(ValueError, match="gamma"):
        suggest.create("tpe").validate_algorithm_settings(ours.experiment)


def test_fold_and_objective_match_the_jax_store():
    rows = [(1.0, "loss", "3.5"), (2.0, "loss", "2.5"), (2.0, "loss", "nan"), (0.5, "loss", "9"),
            (3.0, "acc", "x"), (1.5, "acc", "0.7")]
    ours = store.fold_observation([store.MetricLog(*r) for r in rows], ["loss", "acc", "missing"])
    theirs = jax_store.fold_observation([jax_store.MetricLog(*r) for r in rows], ["loss", "acc", "missing"])
    assert ours.to_dict() == theirs.to_dict()
    for objective in ({"type": "minimize", "objectiveMetricName": "loss"},
                      {"type": "maximize", "objectiveMetricName": "acc"}):
        assert store.objective_value(ours, spec.ObjectiveSpec.from_dict(objective)) == \
            jax_store.objective_value(theirs, jax_spec.ObjectiveSpec.from_dict(objective))


# -- conditions and validation with plain Python trials ------------------------

def _fn_spec(fn, name="fn", trials=3, parallel=1, **kw):
    s = spec.ExperimentSpec.from_dict(dict(_small_doc(name, trials=trials), parallelTrialCount=parallel, **kw))
    s.trial_template = spec.TrialTemplate(function=fn)
    return s


def _run(s, devices=CPU):
    ctrl = ExperimentController(devices=devices)
    ctrl.create_experiment(s)
    exp = ctrl.run(s.name, timeout=60)
    trials = ctrl.list_trials(s.name)
    ctrl.close()
    return exp, trials


def test_failing_trials_fail_the_experiment():
    def boom(assignments, ctx):
        raise RuntimeError("bad trial")

    exp, trials = _run(_fn_spec(boom, trials=5))
    assert exp.status.reason == ExperimentReason.MAX_FAILED_TRIALS_REACHED and not exp.status.is_succeeded
    assert [t.condition for t in trials] == [TrialCondition.FAILED] * 2
    assert "bad trial" in trials[0].message


def test_goal_ends_the_experiment_early():
    def good(assignments, ctx):
        ctx.report(loss=0.5)

    s = _fn_spec(good, trials=5)
    s.objective.goal = 1.0
    exp, trials = _run(s)
    assert exp.status.reason == ExperimentReason.GOAL_REACHED and len(trials) == 1


def test_unreported_objective_is_metrics_unavailable():
    def silent(assignments, ctx):
        return {"other": 1.0}

    exp, trials = _run(_fn_spec(silent, trials=1, maxFailedTrialCount=1))
    assert trials[0].condition == TrialCondition.METRICS_UNAVAILABLE
    assert exp.status.reason == ExperimentReason.MAX_FAILED_TRIALS_REACHED


def test_returned_numbers_are_reported():
    exp, trials = _run(_fn_spec(lambda a, ctx: {"loss": 2.0}, trials=1, maxFailedTrialCount=1))
    assert trials[0].observation.metric("loss").latest == "2.0"
    assert exp.status.current_optimal_trial.best_trial_name == trials[0].name


def test_parallel_trials_each_hold_their_own_slot():
    lock, active, peak, seen = threading.Lock(), [0], [0], []

    def slow(assignments, ctx):
        with lock:
            active[0] += 1
            peak[0] = max(peak[0], active[0])
            seen.append(tuple(ctx.torch_devices()))
        time.sleep(0.05)
        with lock:
            active[0] -= 1
        ctx.report(loss=1.0)

    slots = [torch.device("cpu"), torch.device("cpu", 1)]
    exp, trials = _run(_fn_spec(slow, trials=4, parallel=2), devices=slots)
    assert exp.status.trials_succeeded == 4 and peak[0] == 2
    assert all(len(s) == 1 for s in seen) and {s[0] for s in seen} == set(slots)


def _hyperband_spec(fn):
    """Hyperband with r_l 3, eta 3 over x and an INT budget: 3 trials of
    budget 1, the best for 3, then 2 of 3."""
    s = spec.ExperimentSpec.from_dict({
        "name": "hb", "maxTrialCount": 6, "parallelTrialCount": 3, "maxFailedTrialCount": 3,
        "parameters": [{"name": "x", "parameterType": "double", "feasibleSpace": {"min": "0", "max": "1"}},
                       {"name": "budget", "parameterType": "int", "feasibleSpace": {"min": "1", "max": "3"}}],
        "objective": {"type": "maximize", "objectiveMetricName": "score"},
        "algorithm": {"algorithmName": "hyperband", "algorithmSettings": [
            {"name": "r_l", "value": "3"}, {"name": "resource_name", "value": "budget"},
            {"name": "random_state", "value": "0"}]},
    })
    s.trial_template = spec.TrialTemplate(function=fn)
    return s


@pytest.mark.parametrize("slots", [1, 3])
def test_hyperband_waits_for_its_rungs(slots):
    """The controller asks again after TrialsNotCompleted once a trial has
    ended, and lays the reply's bracket settings over the spec's: the
    rungs come out whole with one device slot or three."""
    def trial(assignments, ctx):
        time.sleep(0.01)
        ctx.report(score=float(assignments["x"]) * float(assignments["budget"]))

    exp, trials = _run(_hyperband_spec(trial), devices=[torch.device("cpu", i) for i in range(slots)])
    assert exp.status.reason == ExperimentReason.MAX_TRIALS_REACHED and exp.status.trials_succeeded == 6
    budgets = [t.assignments_dict()["budget"] for t in trials]
    assert budgets == ["1", "1", "1", "3", "3", "3"]
    first = {t.assignments_dict()["x"]: t for t in trials[:3]}
    assert trials[3].assignments_dict()["x"] == max(first, key=float)


def test_a_rung_that_cannot_complete_fails_the_experiment():
    """A failed trial in Hyperband's rung leaves the suggester waiting for
    good: with no trial running, the experiment fails instead of hanging."""
    def trial(assignments, ctx):
        if float(assignments["x"]) < 0.5:
            raise RuntimeError("bad trial")
        ctx.report(score=1.0)

    exp, trials = _run(_hyperband_spec(trial))
    assert not exp.status.is_succeeded and "none is running" in exp.status.message
    assert len(trials) == 3 and any(t.condition == TrialCondition.FAILED for t in trials)


@pytest.mark.parametrize("edit,match", [
    (lambda d: d["algorithm"].update(algorithmName="nope"), "unknown algorithm"),
    (lambda d: d["trialTemplate"]["resources"].update(numDevices=2), "numDevices"),
    (lambda d: d["trialTemplate"].update(entryPoint="katib_tpu_torch.parallel.train"), "module:function"),
    (lambda d: d["trialTemplate"].update(entryPoint="katib_tpu_torch.parallel.train:nope"), "does not resolve"),
    (lambda d: d.update(parameters=[]), "parameters"),
    pytest.param(lambda d: d.update(nasConfig={"graphConfig": {"numLayers": 2}}),
                 "only one of spec.parameters and spec.nasConfig",  # the JAX package's message
                 id="<lambda>-only one of parameters and nasConfig"),
    (lambda d: d["objective"].update(type="sideways"), "sideways"),
])
def test_invalid_specs_are_refused(edit, match):
    doc = _small_doc()
    edit(doc)
    ctrl = ExperimentController(devices=CPU)
    with pytest.raises(ValueError, match=match):
        ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))


@pytest.mark.parametrize("entry_point", ["katib_tpu.parallel.train:run_lm_trial",
                                         "katib_tpu_torch.parallel.train:run_lm_trial",
                                         "katib_tpu.models.mnist_cnn:run_mnist_trial",
                                         "katib_tpu.models.darts_trainer:run_darts_trial",
                                         "katib_tpu.models.darts_trainer:run_darts_hpo_trial",
                                         "katib_tpu.models.darts_derived:run_darts_retrain_trial"])
def test_ported_trials_refuse_more_than_one_card(entry_point):
    """The ported trials train on one card: a spec that gives one several
    is refused, not run on the first while the others idle."""
    doc = _small_doc()
    doc["trialTemplate"].update(entryPoint=entry_point)
    doc["trialTemplate"]["resources"].update(numDevices=2)
    ctrl = ExperimentController(devices=[torch.device("cpu", i) for i in range(4)])
    with pytest.raises(spec.ValidationError, match="numDevices=2: .* trains on one card"):
        ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))
    doc["trialTemplate"]["resources"].update(numDevices=1)
    ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))


# -- no silent CPU, no JAX ----------------------------------------------------

@pytest.fixture
def no_cuda(monkeypatch):
    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    yield
    backend.reset_probe_state()


def test_probe_raises_without_cuda(no_cuda):
    with pytest.raises(backend.BackendUnavailable, match="device='cpu'"):
        backend.require_devices()
    assert backend.probe_verdict() is False and backend.bounded_cuda_devices() is None


def test_probe_on_this_machine():
    """Unpatched: CUDA devices where there are some, BackendUnavailable (not
    a silent CPU) where there are none, as on a CPU-only test box."""
    backend.reset_probe_state()
    try:
        if torch.cuda.is_available():
            assert all(d.type == "cuda" for d in backend.require_devices())
        else:
            with pytest.raises(backend.BackendUnavailable):
                backend.require_devices()
    finally:
        backend.reset_probe_state()


def test_controller_without_devices_refuses_the_cpu(no_cuda):
    with pytest.raises(backend.BackendUnavailable):
        ExperimentController()


def test_probe_is_bounded(monkeypatch):
    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: time.sleep(2) or True)
    try:
        t0 = time.monotonic()
        with pytest.raises(backend.BackendUnavailable, match="hung"):
            backend.require_devices(timeout_seconds=0.1)
        assert time.monotonic() - t0 < 1.5
    finally:
        backend.reset_probe_state()


_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|katib_tpu)\b"
    r"|import_module\(\s*['\"](?:jax|flax|optax|katib_tpu)\b"
    r"|\bkatib_tpu\.(?!\w*\()\w",
    re.M,
)


def test_port_sources_import_no_jax():
    """No import of jax/flax/optax/katib_tpu, and no dotted katib_tpu.*
    module path (file paths like katib_tpu/ops/... in prose are fine)."""
    root = REPO / "katib_tpu_torch"
    files = [p for p in root.rglob("*") if p.suffix in (".py", ".json", ".cu", ".cuh")]
    assert len(files) > 20
    offenders = {str(p.relative_to(REPO)): m.group(0) for p in files for m in [_FORBIDDEN.search(p.read_text())] if m}
    assert not offenders
