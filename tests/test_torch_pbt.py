"""katib_tpu_torch's PBT suggester and trial against the JAX package's, on
the CPU.

- With uuid4 replaced in both modules by one seeded sequence, the same
  requests (the population seeded, scored completions, a Failed and a
  Killed trial queued again, exploit and explore generations, with and
  without resample_probability, over simple-pbt.json's space and one with
  an int and a categorical parameter too) get equal replies from both
  suggesters (names, params, labels), and both leave equal lineage trees
  (every trial's directory and checkpoint, byte for byte; each queue
  snapshot aside);
- run_pbt_trial reports and writes what the JAX one does from the same
  checkpoint, and from none;
- a fresh suggester on the same root continues from _state_torch.json
  exactly as the uninterrupted one goes on; a truncated or foreign file,
  or the snapshot of an earlier run whose trials are not the request's,
  reseeds the population with a warning;
- simple-pbt.json, shrunk to 10 trials (2 in parallel, so a generation
  fills before the budget ends) on a temporary root, runs through the
  port's CLI: generation 1 is reached, every parent is a trial of the
  experiment, every checkpoint's step is 20 x (generation + 1), and with
  reuseDuplicateResults on no trial is reused;
- run twice on one root (the CLI's) or one suggestion_trial_dir (no
  root), the second run of the experiment starts afresh: no trial, parent
  or checkpoint of the first run shows in it.
"""

import json
import logging
import os
from pathlib import Path

import numpy as np
import pytest

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.models import simple_pbt as jax_simple_pbt
from katib_tpu.suggest import pbt as jax_pbt
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu_torch import cli
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Trial, TrialCondition
from katib_tpu_torch.models import simple_pbt
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest import pbt

REPO = Path(__file__).resolve().parents[1]
METRIC = "Validation-accuracy"
STATE_FILES = {"_state.pkl", pbt.STATE_FILE}
# request sizes, round by round; the trials of a round end before the next
ROUNDS = (5, 5, 3, 2, 5, 5, 5, 4, 6)
FAILS = {7: "FAILED", 12: "KILLED"}  # trial index -> how it ends


class _SeededUuid:
    """Stands in for the uuid module: uuid4() from a seeded generator."""

    class _Id:
        def __init__(self, value):
            self.hex = f"{value:032x}"

    def __init__(self, seed):
        self._rng = np.random.default_rng(seed)

    def uuid4(self):
        return self._Id(int(self._rng.integers(0, 2 ** 63)) << 64 | int(self._rng.integers(0, 2 ** 63)))


class _Ctx:
    def __init__(self, checkpoint_dir):
        self.checkpoint_dir = checkpoint_dir
        self.reported = {}

    def report(self, **metrics):
        self.reported.update(metrics)


def _doc(space="example", settings=None):
    doc = json.loads((REPO / "examples" / "simple-pbt.json").read_text())
    merged = {s["name"]: s["value"] for s in doc["algorithm"]["algorithmSettings"]}
    merged.update(random_state="3", **(settings or {}))
    doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in merged.items()]
    if space == "mixed":
        doc["parameters"] += [
            {"name": "width", "parameterType": "int", "feasibleSpace": {"min": "8", "max": "64", "step": "8"}},
            {"name": "opt", "parameterType": "categorical", "feasibleSpace": {"list": ["sgd", "adam", "rmsprop"]}},
        ]
    return doc


class _Side:
    """One suggester and the trials it made, each run by its package's
    run_pbt_trial in the suggester's lineage directory."""

    def __init__(self, port, root, doc, uuids):
        self.port, self.doc, self.trials = port, doc, []
        module = pbt if port else jax_pbt
        module.uuid = uuids  # restored by the monkeypatch fixture below
        self.suggester = (pbt.PBT if port else jax_pbt.PBT)(checkpoint_root=str(root))
        self.exp = (spec if port else jax_spec).ExperimentSpec.from_dict(doc)

    def ask(self, want):
        request = (suggest.SuggestionRequest if self.port else JaxSuggestionRequest)(self.exp, self.trials, want)
        reply = self.suggester.get_suggestions(request)
        api = spec if self.port else jax_spec
        for a in reply.assignments:
            t = (Trial if self.port else JaxTrial)(
                name=a.name, experiment_name=self.doc["name"], labels=dict(a.labels),
                parameter_assignments=[api.ParameterAssignment(p.name, p.value) for p in a.parameter_assignments])
            t.condition = (TrialCondition if self.port else JaxTrialCondition).RUNNING
            self.trials.append(t)
        return [(a.name, [(p.name, p.value) for p in a.parameter_assignments], a.labels) for a in reply.assignments]

    def finish_running(self):
        conditions = TrialCondition if self.port else JaxTrialCondition
        api = spec if self.port else jax_spec
        for i, t in enumerate(self.trials):
            if t.condition != conditions.RUNNING:
                continue
            if i in FAILS:
                t.condition = conditions[FAILS[i]]
                continue
            ctx = _Ctx(self.suggester.checkpoint_dir(t.name))
            (simple_pbt if self.port else jax_simple_pbt).run_pbt_trial(t.assignments_dict(), ctx)
            v = repr(ctx.reported[METRIC])
            t.observation = api.Observation.from_dict({"metrics": [{"name": METRIC, "min": v, "max": v, "latest": v}]})
            t.condition = conditions.SUCCEEDED


@pytest.fixture(autouse=True)
def restore_uuid(monkeypatch):
    monkeypatch.setattr(pbt, "uuid", pbt.uuid)
    monkeypatch.setattr(jax_pbt, "uuid", jax_pbt.uuid)


def _tree(root):
    """{relative path: file bytes, or None for a directory}, snapshots aside."""
    out = {}
    for path in sorted(Path(root).rglob("*")):
        if path.name not in STATE_FILES:
            out[str(path.relative_to(root))] = None if path.is_dir() else path.read_bytes()
    return out


def _drive(side, rounds):
    replies = []
    for want in rounds:
        replies.append(side.ask(want))
        side.finish_running()
    return replies


@pytest.mark.parametrize("space,settings", [
    ("example", None),
    ("example", {"resample_probability": "0.5"}),
    ("mixed", None),
    ("mixed", {"resample_probability": "0.3", "truncation_threshold": "0.2"}),
], ids=["example", "example-resample", "mixed", "mixed-resample"])
def test_replies_and_lineage_equal_the_jax_package(tmp_path, space, settings):
    doc = _doc(space, settings)
    ours = _Side(True, tmp_path / "port", doc, _SeededUuid(11))
    theirs = _Side(False, tmp_path / "jax", doc, _SeededUuid(11))
    got, want = _drive(ours, ROUNDS), _drive(theirs, ROUNDS)
    assert got == want
    assert len(ours.trials) == sum(ROUNDS) == 40
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    labels = [labels for round_ in got for _, _, labels in round_]
    generations = [int(label[pbt.GENERATION_LABEL]) for label in labels]
    assert max(generations) >= 2
    parents = [label.get(pbt.PARENT_LABEL) for label in labels]
    names = {t.name for t in ours.trials}
    assert all(p in names for p in parents if p is not None) and any(p is not None for p in parents)
    # a Failed and a Killed trial come back with the same params, parent and generation
    for index in FAILS:
        name, params, label = [r for round_ in got for r in round_][index]
        again = [r for round_ in got for r in round_ if r[1] == params and r[2] == label and r[0] != name]
        assert again, f"trial {index} ({FAILS[index]}) was not queued again"
    for t in ours.trials:
        if t.condition == TrialCondition.SUCCEEDED:
            state = json.loads((tmp_path / "port" / t.name / "training.json").read_text())
            assert state["step"] == 20 * (int(t.labels[pbt.GENERATION_LABEL]) + 1)


def test_run_pbt_trial_equals_the_jax_trial(tmp_path, capsys):
    for case, checkpoint in (("fresh", None), ("resumed", {"step": 57, "score": 0.3125})):
        dirs = [tmp_path / case / "port", tmp_path / case / "jax"]
        for d in dirs:
            d.mkdir(parents=True)
            if checkpoint is not None:
                (d / "training.json").write_text(json.dumps(checkpoint))
        ours, theirs = _Ctx(str(dirs[0])), _Ctx(str(dirs[1]))
        simple_pbt.run_pbt_trial({"lr": "0.0137"}, ours)
        jax_simple_pbt.run_pbt_trial({"lr": "0.0137"}, theirs)
        assert ours.reported == theirs.reported and set(ours.reported) == {METRIC}
        assert (dirs[0] / "training.json").read_bytes() == (dirs[1] / "training.json").read_bytes()
        assert sorted(os.listdir(dirs[0])) == ["training.json"]
    simple_pbt.run_pbt_trial({"lr": "0.004"})
    jax_simple_pbt.run_pbt_trial({"lr": "0.004"})
    printed = capsys.readouterr().out.splitlines()
    assert len(printed) == 2 and printed[0] == printed[1] and printed[0].startswith(METRIC + "=")
    assert [simple_pbt._optimal_lr(s) for s in range(0, 200, 7)] == \
        [jax_simple_pbt._optimal_lr(s) for s in range(0, 200, 7)]


def test_a_fresh_suggester_continues_from_the_snapshot(tmp_path):
    doc = _doc("mixed", {"resample_probability": "0.4"})
    uninterrupted = _Side(True, tmp_path / "a", doc, _SeededUuid(5))
    want = _drive(uninterrupted, ROUNDS)
    uuids = _SeededUuid(5)
    first = _Side(True, tmp_path / "b", doc, uuids)
    got = _drive(first, ROUNDS[:4])
    state = json.loads((tmp_path / "b" / pbt.STATE_FILE).read_text())
    assert state["format"] == pbt.STATE_FORMAT and state["rng"]["bit_generator"] == "PCG64"
    second = _Side(True, tmp_path / "b", doc, uuids)  # a restarted controller: same root, same trials
    second.trials = first.trials
    got += _drive(second, ROUNDS[4:])
    assert got == want
    assert _tree(tmp_path / "a") == _tree(tmp_path / "b")


@pytest.mark.parametrize("content", ['{"format": "katib_tpu_torch.pbt/1", "pending": [', '{"format": "other"}', None],
                         ids=["truncated", "foreign", "stale"])
def test_an_unreadable_snapshot_reseeds_with_a_warning(tmp_path, caplog, content):
    """``None`` stands for the well-formed snapshot an earlier run left: its
    trials are not the new experiment's, so it is stale."""
    doc = _doc()
    if content is None:
        _drive(_Side(True, tmp_path / "b", doc, _SeededUuid(2)), ROUNDS[:3])
    else:
        (tmp_path / "b").mkdir()
        (tmp_path / "b" / pbt.STATE_FILE).write_text(content)
    fresh = _Side(True, tmp_path / "a", doc, _SeededUuid(9)).ask(5)
    with caplog.at_level(logging.WARNING, logger="katib_tpu_torch.pbt"):
        reseeded = _Side(True, tmp_path / "b", doc, _SeededUuid(9)).ask(5)
    assert reseeded == fresh and len(reseeded) == 5
    assert any("reseeding population" in r.getMessage() for r in caplog.records)
    assert json.loads((tmp_path / "b" / pbt.STATE_FILE).read_text())["format"] == pbt.STATE_FORMAT


BAD_SETTINGS = {
    "missing": {"n_population": None},
    "population": {"n_population": "4"},
    "threshold": {"truncation_threshold": "1.5"},
    "resample": {"resample_probability": "-0.1"},
}


@pytest.mark.parametrize("case", list(BAD_SETTINGS))
def test_bad_settings_are_refused_as_jax_refuses_them(case):
    doc = _doc()
    settings = {s["name"]: s["value"] for s in doc["algorithm"]["algorithmSettings"]}
    settings.update(BAD_SETTINGS[case])
    doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in settings.items() if v is not None]
    with pytest.raises(ValueError) as jax_error:
        jax_pbt.PBT().validate_algorithm_settings(jax_spec.ExperimentSpec.from_dict(doc))
    with pytest.raises(ValueError) as port_error:
        pbt.PBT().validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    assert str(port_error.value) == str(jax_error.value)


def test_shrunk_example_runs_through_the_port_cli(tmp_path):
    doc = json.loads((REPO / "examples" / "simple-pbt.json").read_text())
    doc.update(maxTrialCount=10, parallelTrialCount=2, maxFailedTrialCount=2, reuseDuplicateResults=True)
    path = tmp_path / "simple-pbt.json"
    path.write_text(json.dumps(doc))
    rc = cli.main(["run", str(path), "--root", str(tmp_path), "--device", "cpu", "--timeout", "60"])
    record = json.loads((tmp_path / doc["name"] / "experiment.json").read_text())
    status, trials = record["experiment"]["status"], record["trials"]
    assert rc == 0 and status["condition"] == "Succeeded" and len(trials) == 10
    names = {t["name"] for t in trials}
    generations = []
    for t in trials:
        assert t["condition"] == "Succeeded" and t["conditions"][-1]["reason"] != "DuplicateResultReused"
        assert t["labels"]["checkpoint-lineage"] == "1" and t["name"].startswith(doc["name"] + "-")
        parent = t["labels"].get(pbt.PARENT_LABEL)
        assert parent is None or parent in names
        generation = int(t["labels"][pbt.GENERATION_LABEL])
        generations.append(generation)
        state = json.loads((tmp_path / doc["name"] / "pbt" / t["name"] / "training.json").read_text())
        assert state["step"] == 20 * (generation + 1)
        assert [float(v) for _, m, v in record["logs"][t["name"]] if m == METRIC] == [state["score"]]
    assert max(generations) >= 1


def test_without_a_root_the_lineage_goes_to_suggestion_trial_dir(tmp_path):
    """A controller with no root directory gives PBT no root; the suggester
    then keeps its lineage in the suggestion_trial_dir setting, as the
    JAX package's does, and each trial gets its directory there."""
    import torch

    from katib_tpu_torch.controller.experiment import ExperimentController

    doc = _doc(settings={"suggestion_trial_dir": str(tmp_path / "lineage")})
    doc.update(maxTrialCount=6, parallelTrialCount=2, maxFailedTrialCount=2)
    ctrl = ExperimentController(root_dir=None, devices=[torch.device("cpu")])
    try:
        ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))
        exp = ctrl.run(doc["name"], timeout=60)
        trials = ctrl.list_trials(doc["name"])
    finally:
        ctrl.close()
    assert exp.status.condition.value == "Succeeded" and len(trials) == 6
    for t in trials:
        assert t.labels["checkpoint-lineage"] == "1"
        state = json.loads((tmp_path / "lineage" / t.name / "training.json").read_text())
        assert state["step"] == 20 * (int(t.labels[pbt.GENERATION_LABEL]) + 1)
    assert (tmp_path / "lineage" / pbt.STATE_FILE).is_file()


def _run_twice(tmp_path, doc, root):
    """Two runs of ``doc``: through the CLI on one root, or through two
    controllers with no root (the lineage in suggestion_trial_dir).
    Returns each run's trials as {name: labels}."""
    import torch

    from katib_tpu_torch.controller.experiment import ExperimentController

    runs = []
    for _ in range(2):
        if root:
            path = tmp_path / "simple-pbt.json"
            path.write_text(json.dumps(doc))
            rc = cli.main(["run", str(path), "--root", str(tmp_path), "--device", "cpu", "--timeout", "60"])
            record = json.loads((tmp_path / doc["name"] / "experiment.json").read_text())
            assert rc == 0 and record["experiment"]["status"]["condition"] == "Succeeded"
            runs.append({t["name"]: t["labels"] for t in record["trials"]})
            continue
        ctrl = ExperimentController(root_dir=None, devices=[torch.device("cpu")])
        try:
            ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))
            assert ctrl.run(doc["name"], timeout=60).status.condition.value == "Succeeded"
            runs.append({t.name: t.labels for t in ctrl.list_trials(doc["name"])})
        finally:
            ctrl.close()
    return runs


@pytest.mark.parametrize("root", [True, False], ids=["cli-root", "suggestion-trial-dir"])
def test_a_second_run_on_the_same_root_starts_afresh(tmp_path, caplog, root):
    """The port does not resume an experiment, so the queue snapshot and the
    lineage a first run left must not leak into a second run of the same
    experiment: its trials are new, each parent names one of its own
    trials, and each checkpoint holds its own lineage's steps. On a root
    the controller clears the experiment's lineage; in
    suggestion_trial_dir the suggester reseeds from the stale snapshot,
    with a warning."""
    doc = _doc(settings=None if root else {"suggestion_trial_dir": str(tmp_path / "lineage")})
    doc.update(maxTrialCount=8, parallelTrialCount=2, maxFailedTrialCount=2)
    with caplog.at_level(logging.WARNING, logger="katib_tpu_torch.pbt"):
        first, second = _run_twice(tmp_path, doc, root)
    lineage = tmp_path / doc["name"] / "pbt" if root else tmp_path / "lineage"
    assert len(first) == len(second) == 8 and not set(first) & set(second)
    assert any(pbt.PARENT_LABEL in labels for labels in second.values())
    for name, labels in second.items():
        assert labels.get(pbt.PARENT_LABEL, name) in second
        state = json.loads((lineage / name / "training.json").read_text())
        assert state["step"] == 20 * (int(labels[pbt.GENERATION_LABEL]) + 1)
    stale = [r for r in caplog.records if "reseeding population" in r.getMessage()]
    dirs = {p.name for p in lineage.iterdir() if p.is_dir()}  # queued jobs' too
    assert set(second) <= dirs
    if root:
        assert not dirs & set(first) and not stale
    else:
        assert len(stale) == 1
