"""Hyperband — the port's own copy of ``katib_tpu/suggest/hyperband.py``
(Katib's ``pkg/suggestion/v1beta1/hyperband/service.py``).

The suggester keeps no state: the bracket (eta, s_max, r_l, b_l, r, n,
current_s, current_i, resource_name, evaluating_trials) travels in the
algorithm settings. Each reply carries the updated settings, which the
controller lays over the spec's settings for the next request.

- current_s == -1: the outer loop is done; an empty reply ends the search.
- evaluating_trials == 0: a master bracket, n random configurations with the
  budget parameter (``resource_name``) set to r.
- otherwise a child bracket: the ``evaluating_trials`` most recently started
  trials, those not started yet counted as the newest, must all have
  succeeded (else ``TrialsNotCompleted``); the best ceil(n_i / eta) of them
  by objective go on with budget r * eta^current_i.
- after the last rung of a bracket, bracket current_s - 1 follows.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from ..api.spec import UNAVAILABLE_METRIC_VALUE, ParameterAssignment, ParameterType, TrialAssignment
from ..api.status import Trial, TrialCondition
from ..db.store import objective_value
from .base import Suggester, SuggestionReply, SuggestionRequest, TrialsNotCompleted, register
from .internal.search_space import MIN_GOAL, SearchSpace


@dataclass
class HyperBandParam:
    """The bracket state and its settings codec (Katib's parameter.py)."""

    eta: float = 3
    s_max: int = -1
    r_l: float = -1
    b_l: float = -1
    r: float = -1
    n: int = -1
    current_s: int = -2
    current_i: int = -1
    resource_name: str = ""
    evaluating_trials: int = 0

    @classmethod
    def from_settings(cls, settings: Dict[str, str]) -> "HyperBandParam":
        p = cls()
        floats = {"eta", "r_l", "b_l", "r"}
        ints = {"n", "current_s", "current_i", "s_max", "evaluating_trials"}
        for k, v in settings.items():
            if k in floats:
                setattr(p, k, float(v))
            elif k in ints:
                setattr(p, k, int(float(v)))
            elif k == "resource_name":
                p.resource_name = v
        if p.current_s == -1:
            return p
        if p.eta <= 0:
            p.eta = 3
        if p.s_max < 0:
            p.s_max = int(math.log(p.r_l) / math.log(p.eta))
        if p.b_l < 0:
            p.b_l = (p.s_max + 1) * p.r_l
        if p.current_s < 0:
            p.current_s = p.s_max
        if p.current_i < 0:
            p.current_i = 0
        if p.n < 0:
            p.n = int(math.ceil((p.s_max + 1) * (p.eta**p.current_s) / (p.current_s + 1)))
        if p.r < 0:
            p.r = p.r_l * p.eta ** (-p.current_s)
        return p

    def to_settings(self) -> Dict[str, str]:
        return {
            "eta": str(self.eta), "s_max": str(self.s_max), "r_l": str(self.r_l), "b_l": str(self.b_l),
            "r": str(self.r), "n": str(self.n), "current_s": str(self.current_s),
            "current_i": str(self.current_i), "resource_name": self.resource_name,
            "evaluating_trials": str(self.evaluating_trials),
        }

    def advance_rung(self) -> None:
        self.current_i += 1
        if self.current_i > self.current_s:
            self.advance_bracket()

    def advance_bracket(self) -> None:
        self.current_s -= 1
        self.current_i = 0
        if self.current_s >= 0:
            self.n = int(math.ceil((self.s_max + 1) * (self.eta**self.current_s) / (self.current_s + 1)))
            self.r = self.r_l * self.eta ** (-self.current_s)


def _observation_available(trial: Trial, experiment) -> bool:
    """The objective's latest value exists: the predicate by which the
    request math leaves out early-stopped trials that never reported."""
    if trial.observation is None:
        return False
    m = trial.observation.metric(experiment.objective.objective_metric_name)
    return m is not None and m.latest != UNAVAILABLE_METRIC_VALUE


@register
class HyperBand(Suggester):
    name = "hyperband"

    def validate_algorithm_settings(self, experiment) -> None:
        s = self.settings(experiment)
        if "r_l" not in s or "resource_name" not in s:
            raise ValueError("r_l and resource_name must be set")
        try:
            r_l = float(s["r_l"])
        except ValueError:
            raise ValueError("r_l must be a positive float number") from None
        if r_l < 0:
            raise ValueError("r_l must be a positive float number")
        eta = int(float(s.get("eta", 3)))
        if eta <= 0:
            eta = 3
        s_max = int(math.log(r_l) / math.log(eta))
        max_parallel = int(math.ceil(eta**s_max))
        if (experiment.parallel_trial_count or 0) < max_parallel:
            raise ValueError(f"parallelTrialCount must be not less than {max_parallel}")
        if s["resource_name"] not in [p.name for p in experiment.parameters]:
            raise ValueError("value of resource_name setting must be in parameters")

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        experiment = request.experiment
        param = HyperBandParam.from_settings(self.settings(experiment))
        if param.current_s < 0:
            return SuggestionReply(search_ended=True)
        # Rung sizes follow the request number, so wait for the full width
        # the controller can request: parallelism, or what the trial budget
        # still allows, less the early-stopped trials that never reported.
        incomplete_es = sum(1 for t in request.trials if t.condition == TrialCondition.EARLY_STOPPED
                            and not _observation_available(t, experiment))
        parallel = experiment.parallel_trial_count or 1
        max_t = experiment.max_trial_count
        budget_left = (max_t - len(request.trials)) if max_t else parallel
        full_width = max(1, min(parallel, budget_left) - incomplete_es)
        if request.current_request_number < full_width:
            raise TrialsNotCompleted(
                f"hyperband request for {request.current_request_number} < {full_width} requestable "
                "slots; waiting for the full width so rung sizes stay deterministic")
        param.n = max(request.current_request_number, 1)

        space = self.search_space(experiment)
        if param.evaluating_trials == 0:
            rng = np.random.default_rng(self.seed_from(experiment, salt=len(request.trials)))
            specs = self._master_bracket(space, param, rng)
        else:
            specs = self._child_bracket(request, space, param)
        if param.current_i < param.current_s:
            param.evaluating_trials = len(specs)
        else:
            param.evaluating_trials = 0
        if param.evaluating_trials == 0:
            param.advance_bracket()
        assignments = [TrialAssignment(name=self.make_trial_name(experiment), parameter_assignments=pa)
                       for pa in specs]
        return SuggestionReply(assignments=assignments, algorithm_settings=param.to_settings())

    def _master_bracket(self, space: SearchSpace, param: HyperBandParam, rng) -> List[List[ParameterAssignment]]:
        budget = self._format_budget(space, param.resource_name, param.r)
        return [[ParameterAssignment(a.name, budget) if a.name == param.resource_name else a
                 for a in space.decode(u)]
                for u in space.sample_uniform(rng, param.n)]

    def _child_bracket(self, request: SuggestionRequest, space: SearchSpace,
                       param: HyperBandParam) -> List[List[ParameterAssignment]]:
        n_i = math.ceil(param.n * param.eta ** (-param.current_i))
        top_n = int(math.ceil(n_i / param.eta))
        param.advance_rung()
        r_i = param.r * param.eta**param.current_i
        # A trial that has not started yet (queued for a device) is among
        # the newest: it sorts last, where the JAX package sorts it first
        # (start time 0) and would rank the previous rung in its place.
        trials = sorted(request.trials, key=lambda t: math.inf if t.start_time is None else t.start_time)
        latest = trials[-param.evaluating_trials:] if param.evaluating_trials else trials
        for t in latest:
            if t.condition != TrialCondition.SUCCEEDED:
                raise TrialsNotCompleted(f"trial {t.name} not completed yet for hyperband child bracket")
        objective = request.experiment.objective

        def value(t: Trial) -> float:
            v = objective_value(t.observation, objective)
            return v if v is not None else float("-inf")

        top = sorted(latest, key=value, reverse=space.goal != MIN_GOAL)[:top_n]
        budget = self._format_budget(space, param.resource_name, r_i)
        return [[ParameterAssignment(name, budget if name == param.resource_name else v)
                 for name, v in t.assignments_dict().items()]
                for t in top]

    @staticmethod
    def _format_budget(space: SearchSpace, resource_name: str, r: float) -> str:
        """An INT budget is truncated (Katib's int(param.r)); a DOUBLE one
        keeps its fraction."""
        try:
            p = space.param(resource_name)
        except KeyError:
            return str(int(r))
        if p.is_numeric and p.type == ParameterType.DOUBLE:
            return repr(float(r))
        return str(int(r))
