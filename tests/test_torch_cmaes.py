"""katib_tpu_torch.suggest.cmaes against katib_tpu.suggest.cmaes on the CPU.

- with random_state set, the port's assignments, generation labels and
  settings feedback equal the JAX suggester's NumPy path on the same
  labelled history, for restart strategies none, ipop and bipop, with
  histories that end inside a generation and with generations not yet
  terminal;
- the strategy the port rebuilds from a history (mean, sigma, C, paths)
  equals, within 1e-9 relative, the JAX package's compiled replay
  (katib_tpu.suggest.vectorized.cma_replay);
- a flat objective held past the stall window restarts IPOP (popsize
  doubled) and BIPOP (small regime, then a doubled large one) at the JAX
  package's restart means, and the assignments still agree after it;
- bad settings are refused with the JAX suggester's messages.
"""

import json
from pathlib import Path

import jax
import jax.experimental
import numpy as np
import pytest

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.suggest import vectorized as jax_vectorized
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu.suggest.cmaes import CMAES as JaxCMAES
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Trial, TrialCondition
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest.cmaes import CMAES, GENERATION_LABEL, stall_generations

REPO = Path(__file__).resolve().parents[1]
POPSIZE = 6  # cma-es.json's default for D = 2: 4 + floor(3 ln 2)


@pytest.fixture
def numpy_path(monkeypatch):
    """The JAX package's NumPy replay (its compiled replay switched off)."""
    monkeypatch.setattr(jax_vectorized, "_ENABLED", False)


def _doc(strategy="none", settings=None):
    doc = json.loads((REPO / "examples" / "cma-es.json").read_text())
    merged = {"sigma": "0.3", "random_state": "11", "restart_strategy": strategy, **(settings or {})}
    doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in merged.items()]
    return doc


def _loss(lr, momentum):
    return float((np.log(lr) - np.log(0.08)) ** 2 + 3.0 * (momentum - 0.9) ** 2)


def _pair(doc, history, want):
    """(port request, JAX request) over the same trials; history rows are
    (assignments, loss or None, condition name, generation label)."""
    ours, theirs = [], []
    for i, (assign, loss, condition, gen) in enumerate(history):
        kw = dict(name=f"t{i}", experiment_name=doc["name"], labels={GENERATION_LABEL: str(gen)})
        t = Trial(parameter_assignments=[spec.ParameterAssignment(k, v) for k, v in assign.items()], **kw)
        jt = JaxTrial(parameter_assignments=[jax_spec.ParameterAssignment(k, v) for k, v in assign.items()], **kw)
        t.condition, jt.condition = TrialCondition[condition], JaxTrialCondition[condition]
        if loss is not None:
            obs = {"metrics": [{"name": "loss", "min": repr(loss), "max": repr(loss), "latest": repr(loss)}]}
            t.observation, jt.observation = spec.Observation.from_dict(obs), jax_spec.Observation.from_dict(obs)
        ours.append(t)
        theirs.append(jt)
    return (suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), ours, want),
            JaxSuggestionRequest(jax_spec.ExperimentSpec.from_dict(doc), theirs, want))


def _outcome(reply):
    return ([([(a.name, a.value) for a in s.parameter_assignments], s.labels) for s in reply.assignments],
            reply.algorithm_settings)


def _history(n, seed=0):
    """n trials over lr and momentum, labelled POPSIZE to a generation; the
    7th fails, and from 13 trials on the last two still run (their
    generation does not fold)."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        lr, momentum = float(rng.uniform(0.01, 0.5)), float(rng.uniform(0.5, 0.99))
        condition = "FAILED" if i == 6 else "RUNNING" if n >= 13 and i >= n - 2 else "SUCCEEDED"
        loss = _loss(lr, momentum) if condition == "SUCCEEDED" else None
        rows.append(({"lr": repr(lr), "momentum": repr(momentum)}, loss, condition, i // POPSIZE))
    return rows


@pytest.mark.parametrize("n_trials", [0, 6, 13, 30])
@pytest.mark.parametrize("strategy", ["none", "ipop", "bipop"])
def test_assignments_match_the_jax_numpy_path(numpy_path, strategy, n_trials):
    ours, theirs = _pair(_doc(strategy), _history(n_trials), want=4)
    got, want = _outcome(CMAES().get_suggestions(ours)), _outcome(JaxCMAES().get_suggestions(theirs))
    assert got == want and len(got[0]) == 4
    assert got[1] == {"cmaes_current_popsize": str(POPSIZE), "cmaes_restarts": "0"}


def test_labels_fill_the_generation_then_spill(numpy_path):
    """13 trials: generation 0 folds; generation 1 is full but one of its
    trials still runs, so it does not fold and a request of 8 is labelled
    past it, popsize to a label, as the JAX suggester labels it."""
    ours, theirs = _pair(_doc(), _history(13), want=8)
    reply = CMAES().get_suggestions(ours)
    assert [a.labels[GENERATION_LABEL] for a in reply.assignments] == ["2"] * 6 + ["3"] * 2
    assert _outcome(reply) == _outcome(JaxCMAES().get_suggestions(theirs))


def test_replayed_state_matches_the_compiled_jax_replay(monkeypatch):
    """Five complete generations (one with a failed trial) folded by the
    port's NumPy loop and by the JAX package's lax.scan. cma_replay asks
    jax.experimental for enable_x64, which newer JAX keeps as jax.enable_x64
    only: the test hands it that one."""
    monkeypatch.setattr(jax_vectorized, "_ENABLED", True)
    if not hasattr(jax.experimental, "enable_x64"):
        monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    history = _history(30)[:28] + [(a, _loss(float(a["lr"]), float(a["momentum"])), "SUCCEEDED", g)
                                   for a, _, _, g in _history(30)[28:]]
    ours, theirs = _pair(_doc(), history, want=1)
    replay = CMAES().replay(ours)
    space = JaxCMAES.search_space(theirs.experiment)
    done = [t for t in JaxCMAES.history(theirs) if t.objective is not None]
    generations = []
    for g in range(5):
        rows = [t for t in done if t.labels[GENERATION_LABEL] == str(g)]
        generations.append((space.encode_many([t.assignments for t in rows]), np.array([t.objective for t in rows])))
    mean, sigma, C, p_sigma, p_c = jax_vectorized.cma_replay(generations, 2, POPSIZE, 0.3, np.full(2, 0.5))
    state = replay.state
    assert replay.generation == 5 and state.generation == 5
    for got, want in ((state.mean, mean), (state.sigma, sigma), (state.C, C), (state.p_sigma, p_sigma),
                      (state.p_c, p_c)):
        np.testing.assert_allclose(got, want, rtol=1e-9, atol=0)
    assert not np.allclose(state.mean, 0.5) and sigma != 0.3


def _drive_flat(strategy, rounds_after_restarts):
    """Ask both suggesters for the current popsize, round after round, on a
    flat objective, until ``rounds_after_restarts`` restarts have happened;
    every reply must agree. Returns the popsizes and restart counts seen
    and, at each restart, the port's and the JAX package's restart means."""
    doc = _doc(strategy)
    history, seen, means = [], [], []
    restarts = 0
    while restarts < rounds_after_restarts:
        ours, _ = _pair(doc, history, want=0)
        replay = CMAES().replay(ours)  # one generation a round, whatever its popsize
        ours, theirs = _pair(doc, history, want=replay.popsize)
        reply = CMAES().get_suggestions(ours)
        assert _outcome(reply) == _outcome(JaxCMAES().get_suggestions(theirs))
        popsize = int(reply.algorithm_settings["cmaes_current_popsize"])
        if int(reply.algorithm_settings["cmaes_restarts"]) > restarts:
            restarts += 1
            want = np.random.default_rng(JaxCMAES.restart_seed(theirs.experiment, restarts)).uniform(0.0, 1.0, 2)
            assert replay.state.generation == 0  # nothing folded since the restart
            means.append((replay.state.mean, want))
        seen.append((popsize, restarts))
        history += [({a.name: a.value for a in s.parameter_assignments}, 1.0, "SUCCEEDED",
                     int(s.labels[GENERATION_LABEL])) for s in reply.assignments]
    return seen, means


def test_ipop_restarts_with_a_doubled_population(numpy_path):
    seen, means = _drive_flat("ipop", 1)
    stall = stall_generations(2, POPSIZE)
    assert seen[stall] == (POPSIZE, 0) and seen[stall + 1] == (2 * POPSIZE, 1)
    for got, want in means:
        np.testing.assert_array_equal(got, want)


def test_bipop_restarts_small_then_large(numpy_path):
    """The regime that has spent less runs next: small (the first popsize)
    after the first run, large (doubled) once the two have spent the same,
    then small again."""
    seen, means = _drive_flat("bipop", 3)
    assert [next(p for p, r in seen if r == k) for k in range(4)] == [POPSIZE, POPSIZE, 2 * POPSIZE, POPSIZE]
    assert len(means) == 3
    for got, want in means:
        np.testing.assert_array_equal(got, want)


def test_restart_seed_without_random_state_comes_from_the_name():
    doc = _doc()
    doc["algorithm"]["algorithmSettings"] = [{"name": "sigma", "value": "0.3"}]
    assert CMAES.restart_seed(spec.ExperimentSpec.from_dict(doc), 2) == \
        JaxCMAES.restart_seed(jax_spec.ExperimentSpec.from_dict(doc), 2)


BAD_SETTINGS = {
    "categorical": ({"popsize": "6"}, lambda d: d["parameters"].append(
        {"name": "opt", "parameterType": "categorical", "feasibleSpace": {"list": ["sgd", "adam"]}})),
    "one parameter": ({}, lambda d: d["parameters"].pop()),
    "sigma 0": ({"sigma": "0"}, None),
    "popsize 1": ({"popsize": "1"}, None),
    "unknown restart": ({"restart_strategy": "lipop"}, None),
}


@pytest.mark.parametrize("case", list(BAD_SETTINGS))
def test_bad_settings_are_refused_as_jax_refuses_them(case):
    settings, edit = BAD_SETTINGS[case]
    doc = _doc(settings=settings)
    if edit:
        edit(doc)
    with pytest.raises(ValueError) as jax_error:
        JaxCMAES().validate_algorithm_settings(jax_spec.ExperimentSpec.from_dict(doc))
    with pytest.raises(ValueError) as port_error:
        CMAES().validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    assert str(port_error.value) == str(jax_error.value)


@pytest.mark.parametrize("name", ["cma-es", "cma-es-ipop"])
def test_examples_pass_the_settings_check(name):
    doc = json.loads((REPO / "examples" / f"{name}.json").read_text())
    CMAES().validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    assert "cmaes" in suggest.registered_algorithms()
