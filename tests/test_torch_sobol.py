"""katib_tpu_torch's Sobol engine and search against scipy and the JAX
package, on the CPU.

- the port's scrambled Sobol engine gives scipy.stats.qmc.Sobol's points bit
  for bit (array_equal) for d in {1, 2, 7, 40}, seeds {0, 3}, skips {0, 1,
  3, 5, 12} and n in {1, 3, 8}, twice in a row; its unscrambled direction
  numbers equal scipy's in all 21201 dimensions;
- the direction table the port carries equals the one scipy ships;
- SobolSearch's assignments equal katib_tpu.suggest.sobol.SobolSearch's,
  as strings, for the same requests (history lengths, request sizes,
  random_state set or not, a double, an int, a log-scaled double and a
  categorical parameter).
"""

import warnings
from pathlib import Path

import numpy as np
import pytest
from scipy.stats import qmc

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu.suggest.sobol import SobolSearch as JaxSobolSearch
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Trial
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest.internal import sobol_engine
from katib_tpu_torch.suggest.sobol import SobolSearch

SCIPY_TABLE = Path(qmc.__file__).resolve().parent / "_sobol_direction_numbers.npz"


@pytest.mark.parametrize("n", [1, 3, 8])
@pytest.mark.parametrize("skip", [0, 1, 3, 5, 12])
@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("d", [1, 2, 7, 40])
def test_engine_equals_scipy(d, seed, skip, n):
    ref = qmc.Sobol(d, scramble=True, seed=seed)
    ours = sobol_engine.SobolEngine(d, seed=seed)
    if skip:
        ref.fast_forward(skip)
        ours.fast_forward(skip)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # scipy's advice on powers of 2
        for _ in range(2):
            want = ref.random(n)
            got = ours.random(n)
            assert got.dtype == want.dtype == np.float64
            assert np.array_equal(got, want)
    assert ours.num_generated == ref.num_generated


def test_direction_numbers_equal_scipy_in_every_dimension():
    ref = qmc.Sobol(sobol_engine.MAXDIM, scramble=False)
    assert np.array_equal(sobol_engine.direction_numbers(sobol_engine.MAXDIM), ref._sv)


def test_carried_table_equals_scipys():
    with np.load(SCIPY_TABLE, allow_pickle=False) as theirs, \
            np.load(sobol_engine.TABLE, allow_pickle=False) as ours:
        assert sorted(ours.files) == sorted(theirs.files) == ["poly", "vinit"]
        for key in ("poly", "vinit"):
            assert ours[key].dtype == theirs[key].dtype and np.array_equal(ours[key], theirs[key])
    poly, vinit = sobol_engine.direction_table()
    assert poly.shape == (21201,) and vinit.shape == (21201, 18)


def test_engine_refuses_too_many_points_and_dimensions():
    with pytest.raises(ValueError, match="Maximum supported dimensionality"):
        sobol_engine.SobolEngine(sobol_engine.MAXDIM + 1)
    engine = sobol_engine.SobolEngine(2, seed=0).fast_forward(2 ** sobol_engine.BITS - 1)
    assert engine.random(1).shape == (1, 2)
    with pytest.raises(ValueError, match="At most 2\\*\\*30"):
        engine.random(1)


PARAMETERS = [
    {"name": "lr", "parameterType": "double", "feasibleSpace": {"min": "0.01", "max": "0.5"}},
    {"name": "wd", "parameterType": "double",
     "feasibleSpace": {"min": "1e-5", "max": "1e-1", "distribution": "logUniform"}},
    {"name": "layers", "parameterType": "int", "feasibleSpace": {"min": "1", "max": "8"}},
    {"name": "opt", "parameterType": "categorical", "feasibleSpace": {"list": ["sgd", "adam", "rmsprop"]}},
]


def _doc(n_params, random_state):
    settings = [] if random_state is None else [{"name": "random_state", "value": str(random_state)}]
    return {
        "name": "sobol-parity",
        "parameters": PARAMETERS[:n_params],
        "objective": {"type": "minimize", "objectiveMetricName": "loss"},
        "algorithm": {"algorithmName": "sobol", "algorithmSettings": settings},
        "trialTemplate": {"entryPoint": "katib_tpu.models.mnist_cnn:run_mnist_trial"},
        "maxTrialCount": 40, "parallelTrialCount": 3,
    }


@pytest.mark.parametrize("n_params,random_state", [(2, None), (4, None), (4, 7)])
def test_search_replies_equal_the_jax_package(n_params, random_state):
    """The Sobol stream depends on the history only through its length, so
    the trials here are bare; a request of n continues where the last
    ended."""
    doc = _doc(n_params, random_state)
    ours, theirs = SobolSearch(), JaxSobolSearch()
    exp, jexp = spec.ExperimentSpec.from_dict(doc), jax_spec.ExperimentSpec.from_dict(doc)
    created = 0
    for want in (1, 3, 2, 5, 1, 8):
        trials = [Trial(name=f"t{i}", experiment_name=doc["name"]) for i in range(created)]
        jtrials = [JaxTrial(name=f"t{i}", experiment_name=doc["name"]) for i in range(created)]
        got = ours.get_suggestions(suggest.SuggestionRequest(exp, trials, want))
        ref = theirs.get_suggestions(JaxSuggestionRequest(jexp, jtrials, want))
        as_strings = [[(a.name, a.value) for a in s.parameter_assignments] for s in got.assignments]
        assert as_strings == [[(a.name, a.value) for a in s.parameter_assignments] for s in ref.assignments]
        assert len(as_strings) == want and all(s.name.startswith("sobol-parity-") for s in got.assignments)
        created += want
