"""Suggestion algorithm interface and registry — the port's own copy of
``katib_tpu/suggest/base.py``, without warm-start priors.

A suggester gets the experiment, the full trial history and how many new
assignments are wanted, and returns them; everything it needs comes from
the request.
"""

from __future__ import annotations

import abc
import secrets
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Type

import numpy as np

from ..api.spec import ExperimentSpec, TrialAssignment
from ..api.status import Trial
from .internal.search_space import SearchSpace
from .internal.trial import ObservedTrial, completed_trials


@dataclass
class SuggestionRequest:
    experiment: ExperimentSpec
    trials: List[Trial]
    current_request_number: int


@dataclass
class SuggestionReply:
    assignments: List[TrialAssignment] = field(default_factory=list)
    search_ended: bool = False  # the search space is exhausted
    # settings the suggester hands back; the controller lays them over the
    # spec's algorithm settings for the next request (Hyperband's bracket)
    algorithm_settings: Dict[str, str] = field(default_factory=dict)


class TrialsNotCompleted(Exception):
    """The suggester cannot answer until running trials end (Hyperband's
    next rung): the controller waits for a trial to end and asks again."""


class Suggester(abc.ABC):
    name: str = ""

    @abc.abstractmethod
    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        ...

    def validate_algorithm_settings(self, experiment: ExperimentSpec) -> None:
        """Raise ValueError on bad settings, before the first suggestion."""

    @staticmethod
    def search_space(experiment: ExperimentSpec) -> SearchSpace:
        return SearchSpace.from_experiment(experiment)

    @staticmethod
    def history(request: SuggestionRequest) -> List[ObservedTrial]:
        return completed_trials(request.trials, request.experiment.objective)

    @staticmethod
    def history_arrays(request: SuggestionRequest, space: SearchSpace):
        """(history, xs, ys): completed trials with an objective, encoded to
        the unit cube."""
        history = [t for t in Suggester.history(request) if t.objective is not None]
        xs = space.encode_many([t.assignments for t in history])
        ys = np.array([t.objective for t in history], dtype=np.float64)
        return history, xs, ys

    @staticmethod
    def make_trial_name(experiment: ExperimentSpec) -> str:
        """``<experiment>-<rand8>``, as Katib names trials."""
        suffix = "".join(secrets.choice("abcdefghijklmnopqrstuvwxyz0123456789") for _ in range(8))
        return f"{experiment.name}-{suffix}"

    @staticmethod
    def settings(experiment: ExperimentSpec) -> Dict[str, str]:
        return experiment.algorithm.settings_dict()

    @staticmethod
    def seed_from(experiment: ExperimentSpec, salt: int = 0) -> Optional[int]:
        s = experiment.algorithm.settings_dict().get("random_state")
        return None if s is None else int(s) + salt


_REGISTRY: Dict[str, Type[Suggester]] = {}


def register(cls: Type[Suggester]) -> Type[Suggester]:
    if not cls.name:
        raise ValueError(f"{cls.__name__} must set a name")
    _REGISTRY[cls.name] = cls
    return cls


def registered_algorithms() -> set:
    _ensure_builtins()
    return set(_REGISTRY)


def create(name: str, **kwargs) -> Suggester:
    _ensure_builtins()
    if name not in _REGISTRY:
        raise KeyError(f"unknown algorithm {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def _ensure_builtins() -> None:
    from . import cmaes, grid, hyperband, random_search, tpe  # noqa: F401  (registration side effects)
    from .nas import darts, enas  # noqa: F401
