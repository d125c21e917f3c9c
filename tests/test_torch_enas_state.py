"""A second run of one ENAS experiment on one root starts its controller
from the seed, on the CPU.

The port does not resume an experiment, so the controller state that an
earlier run left in ``<root>/<experiment>/`` is stale: creating the
experiment again must not hand it to the new run's suggester. The suggester
is driven directly (one round that samples arcs and saves the state, then a
round that trains the controller on two results); no child network is
trained.
"""

import json
from pathlib import Path

import pytest
import torch

from katib_tpu_torch.api import spec
from katib_tpu_torch.api.spec import Metric, Observation
from katib_tpu_torch.api.status import Trial, TrialCondition
from katib_tpu_torch.controller.experiment import ExperimentController
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest.nas import enas

REPO = Path(__file__).resolve().parents[1]
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spec():
    """examples/nas/enas.json with a seed and a 2-step training round."""
    doc = json.loads((REPO / "examples" / "nas" / "enas.json").read_text())
    doc["algorithm"]["algorithmSettings"] = [{"name": "random_state", "value": "3"},
                                             {"name": "controller_train_steps", "value": "2"}]
    return spec.ExperimentSpec.from_dict(doc)


def _finished(assignment, accuracy):
    trial = Trial.from_assignment(assignment, "enas-example")
    trial.observation = Observation([Metric("Validation-accuracy", min=str(accuracy), max=str(accuracy),
                                            latest=str(accuracy))])
    trial.set_condition(TrialCondition.SUCCEEDED)
    return trial


def _run(root):
    """One run of the experiment on ``root``: the first round's arcs, and
    the second round's after the controller trained on the first round's
    two results."""
    ctrl = ExperimentController(root_dir=str(root), devices=CPU)
    exp_spec = _spec()
    ctrl.create_experiment(exp_spec)
    suggester = suggest.create("enas", **ctrl._suggester_kwargs(exp_spec))
    first = suggester.get_suggestions(suggest.SuggestionRequest(exp_spec, [], 2)).assignments
    done = [_finished(a, acc) for a, acc in zip(first, (0.3, 0.6))]
    second = suggester.get_suggestions(suggest.SuggestionRequest(exp_spec, done, 2)).assignments
    ctrl.close()

    def arcs(assignments):
        return [[p.value for p in a.parameter_assignments] for a in assignments]

    return arcs(first), arcs(second)


def test_a_second_run_on_one_root_starts_the_controller_from_its_seed(tmp_path):
    state = tmp_path / "enas-example" / enas.STATE_FILE
    first_run = _run(tmp_path)
    assert state.exists()  # the first run left its trained controller behind
    second_run = _run(tmp_path)
    assert second_run == first_run
    assert first_run[0] != first_run[1]  # the controller did move between rounds
