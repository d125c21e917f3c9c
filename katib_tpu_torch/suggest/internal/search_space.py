"""Search-space model shared by the suggesters — the port's own copy of
``katib_tpu/suggest/internal/search_space.py``.

Each parameter maps to one axis of the unit cube: DOUBLE/INT through their
uniform or logUniform scale, DISCRETE/CATEGORICAL through the index of the
choice. Suggesters work on unit-cube points and decode them to assignments.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from ...api.spec import (
    Distribution,
    ExperimentSpec,
    ParameterAssignment,
    ParameterSpec,
    ParameterType,
)

MAX_GOAL = "MAXIMIZE"
MIN_GOAL = "MINIMIZE"


@dataclass
class HyperParameter:
    """Parsed parameter, reference search_space.py HyperParameter."""

    name: str
    type: ParameterType
    min: float = 0.0
    max: float = 0.0
    step: Optional[float] = None
    choices: List[str] = field(default_factory=list)
    distribution: Distribution = Distribution.UNIFORM

    @classmethod
    def from_spec(cls, p: ParameterSpec) -> "HyperParameter":
        fs = p.feasible_space
        if p.parameter_type in (ParameterType.DOUBLE, ParameterType.INT):
            lo = float(fs.min) if fs.min not in (None, "") else 0.0
            hi = float(fs.max) if fs.max not in (None, "") else lo
            step = float(fs.step) if fs.step not in (None, "") else None
            dist = fs.distribution or Distribution.UNIFORM
            if dist in (Distribution.LOG_UNIFORM, Distribution.LOG_NORMAL) and lo <= 0:
                raise ValueError(
                    f"parameter {p.name!r}: logUniform requires min > 0, got {lo}"
                )
            return cls(name=p.name, type=p.parameter_type, min=lo, max=hi, step=step, distribution=dist)
        return cls(name=p.name, type=p.parameter_type, choices=list(fs.list or []))

    # -- unit-cube transforms ------------------------------------------------

    @property
    def is_numeric(self) -> bool:
        return self.type in (ParameterType.DOUBLE, ParameterType.INT)

    @property
    def is_log(self) -> bool:
        return self.distribution in (Distribution.LOG_UNIFORM, Distribution.LOG_NORMAL)

    @property
    def num_choices(self) -> int:
        return len(self.choices)

    def to_unit(self, value: str) -> float:
        """Map a string assignment into [0,1]."""
        if self.is_numeric:
            v = float(value)
            lo, hi = self.min, self.max
            if self.is_log:
                lo, hi, v = math.log(lo), math.log(hi), math.log(max(v, 1e-300))
            if hi <= lo:
                return 0.0
            return min(max((v - lo) / (hi - lo), 0.0), 1.0)
        try:
            idx = self.choices.index(value)
        except ValueError:
            idx = 0
        n = max(self.num_choices, 1)
        return (idx + 0.5) / n

    def from_unit(self, u: float) -> str:
        """Map u in [0,1) back to an assignment string."""
        u = min(max(float(u), 0.0), 1.0 - 1e-12)
        if self.is_numeric:
            lo, hi = self.min, self.max
            if self.is_log:
                v = math.exp(math.log(lo) + u * (math.log(hi) - math.log(lo)))
            else:
                v = lo + u * (hi - lo)
            if self.step:
                v = self.min + round((v - self.min) / self.step) * self.step
                v = min(max(v, self.min), self.max)
            if self.type == ParameterType.INT:
                return str(int(round(v)))
            return format_float(v)
        idx = int(u * self.num_choices)
        return self.choices[min(idx, self.num_choices - 1)]

    def grid_values(self) -> List[str]:
        """Every value grid search visits: the choices, ``min + i * step``
        for a numeric parameter with a step, every integer of an INT range."""
        if not self.is_numeric:
            return list(self.choices)
        if self.step:
            n = int(math.floor((self.max - self.min) / self.step + 1e-9)) + 1
            vals = [self.min + i * self.step for i in range(n)]
        elif self.type == ParameterType.INT:
            vals = [float(v) for v in range(int(self.min), int(self.max) + 1)]
        else:
            raise ValueError(f"grid search requires feasibleSpace.step for double parameter {self.name!r}")
        if self.type == ParameterType.INT:
            return [str(int(round(v))) for v in vals]
        return [format_float(v) for v in vals]


def format_float(v: float) -> str:
    """Stable short decimal formatting for assignments."""
    s = repr(float(v))
    return s


@dataclass
class SearchSpace:
    """reference search_space.py HyperParameterSearchSpace."""

    params: List[HyperParameter]
    goal: str = MAX_GOAL

    @classmethod
    def from_experiment(cls, spec: ExperimentSpec) -> "SearchSpace":
        from ...api.spec import ObjectiveType

        goal = MIN_GOAL if spec.objective.type == ObjectiveType.MINIMIZE else MAX_GOAL
        return cls(params=[HyperParameter.from_spec(p) for p in spec.parameters], goal=goal)

    def __len__(self) -> int:
        return len(self.params)

    def param(self, name: str) -> HyperParameter:
        for p in self.params:
            if p.name == name:
                return p
        raise KeyError(name)

    # -- encode/decode -----------------------------------------------------

    def encode(self, assignments: Dict[str, str]) -> np.ndarray:
        """Assignment dict -> point in the unit cube, shape [D]."""
        return np.array([p.to_unit(assignments[p.name]) for p in self.params], dtype=np.float64)

    def encode_many(self, assignment_dicts: Sequence[Dict[str, str]]) -> np.ndarray:
        if not assignment_dicts:
            return np.zeros((0, len(self.params)), dtype=np.float64)
        return np.stack([self.encode(a) for a in assignment_dicts])

    def decode(self, u: np.ndarray) -> List[ParameterAssignment]:
        """Unit-cube point [D] -> parameter assignments."""
        return [
            ParameterAssignment(name=p.name, value=p.from_unit(float(u[i])))
            for i, p in enumerate(self.params)
        ]

    def sample_uniform(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """n uniform unit-cube samples honoring distributions implicitly via
        from_unit. Shape [n, D]."""
        return rng.random((n, len(self.params)))

    def grid_combinations(self) -> List[List[ParameterAssignment]]:
        """The Cartesian product of every parameter's grid values, the
        first parameter varying slowest."""
        per_param = [p.grid_values() for p in self.params]
        return [[ParameterAssignment(name=p.name, value=v) for p, v in zip(self.params, values)]
                for values in itertools.product(*per_param)]
