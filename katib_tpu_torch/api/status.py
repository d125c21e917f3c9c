"""Trial and experiment records with their condition machinery — the port's
own copy of ``katib_tpu/api/status.py``, cut to one in-process experiment."""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from .spec import ExperimentSpec, Observation, ParameterAssignment, TrialAssignment


class TrialCondition(str, enum.Enum):
    CREATED = "Created"
    PENDING = "Pending"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    KILLED = "Killed"
    FAILED = "Failed"
    METRICS_UNAVAILABLE = "MetricsUnavailable"
    EARLY_STOPPED = "EarlyStopped"


TRIAL_TERMINAL = {
    TrialCondition.SUCCEEDED,
    TrialCondition.KILLED,
    TrialCondition.FAILED,
    TrialCondition.METRICS_UNAVAILABLE,
    TrialCondition.EARLY_STOPPED,
}


class ExperimentCondition(str, enum.Enum):
    CREATED = "Created"
    RUNNING = "Running"
    SUCCEEDED = "Succeeded"
    FAILED = "Failed"


class ExperimentReason(str, enum.Enum):
    NONE = ""
    GOAL_REACHED = "ExperimentGoalReached"
    MAX_TRIALS_REACHED = "ExperimentMaxTrialsReached"
    MAX_FAILED_TRIALS_REACHED = "ExperimentMaxFailedTrialsReached"
    SUGGESTION_END_REACHED = "ExperimentSuggestionEndReached"
    EXPERIMENT_FAILED = "ExperimentFailed"


@dataclass
class Condition:
    type: str
    status: bool = True
    reason: str = ""
    message: str = ""
    last_transition_time: float = field(default_factory=time.time)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "type": self.type,
            "status": self.status,
            "reason": self.reason,
            "message": self.message,
            "lastTransitionTime": self.last_transition_time,
        }


def _update_conditions(conditions: List[Condition], new: Condition) -> None:
    """The newest condition of a type wins; conditions of other types drop
    to status False."""
    for c in conditions:
        if c.type == new.type:
            c.status, c.reason, c.message = new.status, new.reason, new.message
            c.last_transition_time = new.last_transition_time
            break
    else:
        conditions.append(new)
    for c in conditions:
        if c.type != new.type:
            c.status = False


@dataclass
class Trial:
    name: str
    experiment_name: str
    parameter_assignments: List[ParameterAssignment] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
    uid: str = field(default_factory=lambda: uuid.uuid4().hex[:12])
    condition: TrialCondition = TrialCondition.CREATED
    conditions: List[Condition] = field(default_factory=list)
    observation: Optional[Observation] = None
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    message: str = ""

    def assignments_dict(self) -> Dict[str, str]:
        return {a.name: a.value for a in self.parameter_assignments}

    @property
    def is_terminal(self) -> bool:
        return self.condition in TRIAL_TERMINAL

    def set_condition(self, cond: TrialCondition, reason: str = "", message: str = "") -> None:
        self.condition = cond
        _update_conditions(self.conditions, Condition(type=cond.value, reason=reason, message=message))
        if cond == TrialCondition.RUNNING and self.start_time is None:
            self.start_time = time.time()
        if cond in TRIAL_TERMINAL and self.completion_time is None:
            self.completion_time = time.time()
        if message:
            self.message = message

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "experimentName": self.experiment_name,
            "uid": self.uid,
            "parameterAssignments": [a.to_dict() for a in self.parameter_assignments],
            "labels": dict(self.labels),
            "condition": self.condition.value,
            "conditions": [c.to_dict() for c in self.conditions],
            "observation": self.observation.to_dict() if self.observation else None,
            "startTime": self.start_time,
            "completionTime": self.completion_time,
            "message": self.message,
        }

    @classmethod
    def from_assignment(cls, assignment: TrialAssignment, experiment_name: str) -> "Trial":
        return cls(
            name=assignment.name,
            experiment_name=experiment_name,
            parameter_assignments=list(assignment.parameter_assignments),
            labels=dict(assignment.labels),
        )


@dataclass
class OptimalTrial:
    best_trial_name: str = ""
    parameter_assignments: List[ParameterAssignment] = field(default_factory=list)
    observation: Observation = field(default_factory=Observation)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "bestTrialName": self.best_trial_name,
            "parameterAssignments": [a.to_dict() for a in self.parameter_assignments],
            "observation": self.observation.to_dict(),
        }


@dataclass
class ExperimentStatus:
    """Condition, trial counts by bucket, and the current optimal trial."""

    condition: ExperimentCondition = ExperimentCondition.CREATED
    conditions: List[Condition] = field(default_factory=list)
    reason: ExperimentReason = ExperimentReason.NONE
    message: str = ""
    start_time: Optional[float] = None
    completion_time: Optional[float] = None
    trials: int = 0
    trials_succeeded: int = 0
    trials_failed: int = 0
    trials_killed: int = 0
    trials_pending: int = 0
    trials_running: int = 0
    trials_early_stopped: int = 0
    trials_metrics_unavailable: int = 0
    current_optimal_trial: OptimalTrial = field(default_factory=OptimalTrial)

    @property
    def is_completed(self) -> bool:
        return self.condition in (ExperimentCondition.SUCCEEDED, ExperimentCondition.FAILED)

    @property
    def is_succeeded(self) -> bool:
        return self.condition == ExperimentCondition.SUCCEEDED

    def set_condition(self, cond: ExperimentCondition, reason: ExperimentReason = ExperimentReason.NONE,
                      message: str = "") -> None:
        self.condition, self.reason, self.message = cond, reason, message
        _update_conditions(self.conditions, Condition(type=cond.value, reason=reason.value, message=message))
        if cond == ExperimentCondition.RUNNING and self.start_time is None:
            self.start_time = time.time()
        if self.is_completed and self.completion_time is None:
            self.completion_time = time.time()

    def to_dict(self) -> Dict[str, Any]:
        return {
            "condition": self.condition.value,
            "conditions": [c.to_dict() for c in self.conditions],
            "reason": self.reason.value,
            "message": self.message,
            "startTime": self.start_time,
            "completionTime": self.completion_time,
            "trials": self.trials,
            "trialsSucceeded": self.trials_succeeded,
            "trialsFailed": self.trials_failed,
            "trialsKilled": self.trials_killed,
            "trialsPending": self.trials_pending,
            "trialsRunning": self.trials_running,
            "trialsEarlyStopped": self.trials_early_stopped,
            "trialsMetricsUnavailable": self.trials_metrics_unavailable,
            "currentOptimalTrial": self.current_optimal_trial.to_dict(),
        }


@dataclass
class Experiment:
    spec: ExperimentSpec
    status: ExperimentStatus = field(default_factory=ExperimentStatus)

    @property
    def name(self) -> str:
        return self.spec.name

    def to_dict(self) -> Dict[str, Any]:
        return {"spec": self.spec.to_dict(), "status": self.status.to_dict()}
