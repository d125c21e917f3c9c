"""katib_tpu_torch.suggest.bayesopt against katib_tpu.suggest.bayesopt's
NumPy/scipy path (its vectorized programs switched off), on the CPU.

- On the same numpy-seeded histories (0, 4, 5, 12 and 30 trials over a
  double, an int and a categorical parameter, some trials labelled with the
  portfolio member that proposed them, one Failed), for each acq_func,
  minimize and maximize, length_scale fixed and fitted, with random_state
  set, a request of 3 gets the same assignments and labels from both.
  The rule for a pick that differs: the port's Cholesky and normal cdf are
  torch's, not scipy's, so a candidate's score may differ in its last bits
  and an argmax may flip between near-equal candidates. Such a pick passes
  only if its label equals the reference's and the reference's acquisition
  scores of both picks (the reference's GP, history and liar rows at that
  pick) agree within 1e-9 relative. Each case counts these near ties
  (report property ``near_ties``) and allows at most one of its 3 picks.
  PI is where they arise: with 5 trials its value is 1 to the last bit on
  many candidates, so the argmax rests on the cdf's last bits.
- The fitted GP's hyperparameters are the same; its mean and std on 612
  candidates agree within 1e-9 relative (atol 1e-9 times the largest
  magnitude of the reference's vector), and so do the hedge gains.
- Bad settings are refused with the JAX suggester's messages.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.suggest import bayesopt as jax_bo
from katib_tpu.suggest import vectorized as jax_vectorized
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Trial, TrialCondition
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest import bayesopt as bo

REPO = Path(__file__).resolve().parents[1]
N_INITIAL = 5
RTOL = 1e-9


@pytest.fixture(autouse=True)
def numpy_path(monkeypatch):
    """The JAX package's NumPy/scipy path (its compiled programs off)."""
    monkeypatch.setattr(jax_vectorized, "_ENABLED", False)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's factorisations on one thread while this module runs: on
    matrices this small, its OpenMP threads and scipy's BLAS threads (which
    spin after each reference call) contend, and a 30 x 30 Cholesky takes
    milliseconds instead of microseconds. Results do not depend on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


PARAMETERS = [
    {"name": "lr", "parameterType": "double", "feasibleSpace": {"min": "0.01", "max": "0.5"}},
    {"name": "layers", "parameterType": "int", "feasibleSpace": {"min": "1", "max": "6"}},
    {"name": "opt", "parameterType": "categorical", "feasibleSpace": {"list": ["sgd", "adam", "rmsprop"]}},
]


def _doc(acq="gp_hedge", goal="minimize", length_scale=None, extra=None):
    settings = {"base_estimator": "GP", "n_initial_points": str(N_INITIAL), "acq_func": acq,
                "random_state": "5", **({} if length_scale is None else {"length_scale": length_scale}),
                **(extra or {})}
    return {
        "name": "bo-parity",
        "parameters": PARAMETERS,
        "objective": {"type": goal, "objectiveMetricName": "loss"},
        "algorithm": {"algorithmName": "bayesianoptimization",
                      "algorithmSettings": [{"name": k, "value": v} for k, v in settings.items()]},
        "trialTemplate": {"entryPoint": "katib_tpu.models.mnist_cnn:run_mnist_trial"},
        "maxTrialCount": 40, "parallelTrialCount": 3,
    }


def _history(n, seed=0):
    """n trials: (assignments, loss or None, condition, bo-acq label or None).
    The 8th fails; from the 6th on, trials carry a portfolio label."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(n):
        lr = float(rng.uniform(0.01, 0.5))
        layers, opt = int(rng.integers(1, 7)), ["sgd", "adam", "rmsprop"][int(rng.integers(3))]
        loss = (np.log(lr) - np.log(0.08)) ** 2 + 0.1 * (layers - 3) ** 2 + 0.3 * (opt == "sgd") \
            + 0.05 * float(rng.normal())
        label = None if i < N_INITIAL else str(rng.choice(bo.PORTFOLIO))
        rows.append(({"lr": repr(lr), "layers": str(layers), "opt": opt}, None if i == 7 else float(loss),
                     "FAILED" if i == 7 else "SUCCEEDED", label))
    return rows


def _pair(doc, history, want):
    ours, theirs = [], []
    for i, (assign, loss, condition, label) in enumerate(history):
        kw = dict(name=f"t{i}", experiment_name=doc["name"], labels={} if label is None else {bo.ACQ_LABEL: label})
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


def _recording(suggester):
    """Wrap the suggester's _acquire to record (xs, ys, hypers, pick, label)
    for each model-based pick."""
    picks = []
    acquire = suggester._acquire

    def wrapped(xs, ys, space, rng, acq, hypers, gains):
        u, label = acquire(xs, ys, space, rng, acq, hypers, gains)
        picks.append((xs.copy(), ys.copy(), hypers, u.copy(), label))
        return u, label

    suggester._acquire = wrapped
    return picks


def _reference_score(xs, ys, hypers, label, u):
    gp = jax_bo._GP(xs, ys, length=hypers[0], noise=hypers[1])
    mu, sigma = gp.predict(u[None, :])
    return float(jax_bo._acq_scores(label, mu, sigma, ys.min())[0])


def _assert_close(got, want):
    want = np.asarray(want, dtype=np.float64)
    scale = float(np.max(np.abs(want))) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale)


@pytest.mark.parametrize("length_scale", [None, "0.3"], ids=["fitted", "fixed"])
@pytest.mark.parametrize("goal", ["minimize", "maximize"])
@pytest.mark.parametrize("acq", ["gp_hedge", "ei", "pi", "lcb"])
@pytest.mark.parametrize("n_trials", [0, 4, 5, 12, 30])
def test_replies_equal_the_jax_numpy_path(n_trials, acq, goal, length_scale, request):
    ours, theirs = _pair(_doc(acq, goal, length_scale), _history(n_trials), want=3)
    port, jax = bo.BayesianOptimization(), jax_bo.BayesianOptimization()
    port_picks, jax_picks = _recording(port), _recording(jax)
    got, want = port.get_suggestions(ours).assignments, jax.get_suggestions(theirs).assignments
    model_based = n_trials - (n_trials > 7) >= N_INITIAL  # the completed trials reach n_initial_points
    assert len(got) == len(want) == 3
    assert len(port_picks) == len(jax_picks) == (3 if model_based else 0)
    near_ties = 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.labels == w.labels
        if [(a.name, a.value) for a in g.parameter_assignments] == [(a.name, a.value) for a in w.parameter_assignments]:
            continue
        assert jax_picks, "a random pick differs"
        xs, ys, hypers, u_ref, label = jax_picks[i]
        u_port = port_picks[i][3]
        assert label == port_picks[i][4]
        np.testing.assert_allclose(_reference_score(xs, ys, hypers, label, u_port),
                                   _reference_score(xs, ys, hypers, label, u_ref), rtol=RTOL, atol=0)
        near_ties += 1
    request.node.user_properties.append(("near_ties", near_ties))  # a report property, as record_property
    assert near_ties <= 1
    if model_based:
        assert all(g.labels[bo.ACQ_LABEL] in bo.PORTFOLIO for g in got)
        if acq != "gp_hedge":
            assert {g.labels[bo.ACQ_LABEL] for g in got} == {acq}
    else:
        assert all(not g.labels for g in got)


@pytest.mark.parametrize("length_scale", [None, 0.3], ids=["fitted", "fixed"])
@pytest.mark.parametrize("n_trials", [5, 12, 30])
def test_gp_and_hedge_gains_agree(n_trials, length_scale):
    ours, _ = _pair(_doc(), _history(n_trials), want=1)
    space = bo.BayesianOptimization.search_space(ours.experiment)
    history, xs, ys = bo.BayesianOptimization.history_arrays(ours, space)
    labels = [t.labels.get(bo.ACQ_LABEL) for t in history]
    if length_scale is None:
        port, ref = bo._GP.fit_mle(xs, ys), jax_bo._GP.fit_mle(xs, ys)
        assert (port.length, port.noise) == (ref.length, ref.noise)
    else:
        port, ref = bo._GP(xs, ys, length=length_scale), jax_bo._GP(xs, ys, length=length_scale)
    np.testing.assert_allclose(port.log_marginal_likelihood(), ref.log_marginal_likelihood(), rtol=RTOL)
    rng = np.random.default_rng(n_trials)
    cands = np.vstack([rng.random((512, 3)), np.clip(np.repeat(xs[:5], 20, axis=0)
                                                     + rng.normal(0, 0.02, (100, 3)), 0, 1 - 1e-9)])
    (mu, sigma), (ref_mu, ref_sigma) = port.predict(cands), ref.predict(cands)
    _assert_close(mu, ref_mu)
    _assert_close(sigma, ref_sigma)
    for acq in bo.PORTFOLIO:
        _assert_close(bo._acq_scores(acq, ref_mu, ref_sigma, ys.min()),
                      jax_bo._acq_scores(acq, ref_mu, ref_sigma, ys.min()))
    gains = bo.BayesianOptimization.hedge_gains(port, xs, labels)
    ref_gains = jax_bo.BayesianOptimization.hedge_gains(ref, xs, labels)
    _assert_close(gains, ref_gains)
    assert np.any(gains != 0) == (n_trials > N_INITIAL)  # the first N_INITIAL trials carry no label


def test_a_grid_point_that_fails_to_factor_is_skipped(monkeypatch):
    """Each package's factorisation is made to fail at the grid's smallest
    noise (its own LinAlgError: numpy's for scipy, torch's for the port):
    both skip those grid points and pick the same one of the rest."""
    ours, _ = _pair(_doc(), _history(12), want=1)
    _, xs, ys = bo.BayesianOptimization.history_arrays(ours, bo.BayesianOptimization.search_space(ours.experiment))
    cho_factor, cholesky = jax_bo.cho_factor, bo.torch.linalg.cholesky

    def smallest_noise(K):
        return abs(float(K[0, 0]) - (1.0 + bo._NOISE_GRID[0])) < 1e-12

    def failing_cho_factor(K, **kw):
        if smallest_noise(K):
            raise np.linalg.LinAlgError("not positive definite")
        return cho_factor(K, **kw)

    def failing_cholesky(K):
        if smallest_noise(K):
            raise bo.torch.linalg.LinAlgError("not positive definite")
        return cholesky(K)

    best = bo._GP.fit_mle(xs, ys)
    monkeypatch.setattr(jax_bo, "cho_factor", failing_cho_factor)
    monkeypatch.setattr(bo.torch.linalg, "cholesky", failing_cholesky)
    port, ref = bo._GP.fit_mle(xs, ys), jax_bo._GP.fit_mle(xs, ys)
    assert (port.length, port.noise) == (ref.length, ref.noise)
    assert port.noise > bo._NOISE_GRID[0] and best.noise == bo._NOISE_GRID[0]


BAD_SETTINGS = {
    "estimator": {"base_estimator": "RF"},
    "initial points": {"n_initial_points": "0"},
    "acq": {"acq_func": "ucb"},
    "length scale": {"length_scale": "0"},
}


@pytest.mark.parametrize("case", list(BAD_SETTINGS))
def test_bad_settings_are_refused_as_jax_refuses_them(case):
    doc = _doc(extra=BAD_SETTINGS[case])
    with pytest.raises(ValueError) as jax_error:
        jax_bo.BayesianOptimization().validate_algorithm_settings(jax_spec.ExperimentSpec.from_dict(doc))
    with pytest.raises(ValueError) as port_error:
        bo.BayesianOptimization().validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    assert str(port_error.value) == str(jax_error.value)


def test_the_example_passes_the_settings_check():
    doc = json.loads((REPO / "examples" / "bayesian-optimization.json").read_text())
    bo.BayesianOptimization().validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    assert {"bayesianoptimization", "sobol", "pbt"} <= suggest.registered_algorithms()
