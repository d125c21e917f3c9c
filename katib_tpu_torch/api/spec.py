"""Experiment specification types — the port's own copy of
``katib_tpu/api/spec.py``, cut to what one in-process HPO experiment uses.

JSON field names and their meaning are the JAX package's (and Katib's), so a
spec file runs under either package: a ``katib_tpu.`` entry point runs the
port's counterpart of that trial where the port has one
(``controller/experiment.py:PORTED_TRIALS``). A section the port does not
carry yet raises ``ValidationError`` naming it, as does any other key it
does not know (keys that start with ``_``, such as ``_comment``, are
ignored): a metrics collector other than the default push collector, a
resume policy other than ``Never``, fair-share fields, and command
templates.
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

UNAVAILABLE_METRIC_VALUE = "unavailable"


class ValidationError(ValueError):
    """A spec the port cannot run as written: one message, or every error
    admission found (``errors``), joined as the JAX package joins them."""

    def __init__(self, errors):
        self.errors = [errors] if isinstance(errors, str) else list(errors)
        super().__init__("; ".join(self.errors))


class ObjectiveType(str, enum.Enum):
    MINIMIZE = "minimize"
    MAXIMIZE = "maximize"
    UNKNOWN = ""


class MetricStrategyType(str, enum.Enum):
    MIN = "min"
    MAX = "max"
    LATEST = "latest"


class ComparisonType(str, enum.Enum):
    """An early-stopping rule's comparison (Katib's common_types.go)."""

    EQUAL = "equal"
    LESS = "less"
    GREATER = "greater"


class ParameterType(str, enum.Enum):
    DOUBLE = "double"
    INT = "int"
    DISCRETE = "discrete"
    CATEGORICAL = "categorical"
    UNKNOWN = "unknown"


class Distribution(str, enum.Enum):
    UNIFORM = "uniform"
    LOG_UNIFORM = "logUniform"
    NORMAL = "normal"
    LOG_NORMAL = "logNormal"
    UNKNOWN = "unknown"


@dataclass
class FeasibleSpace:
    """min/max/step stay strings at the API boundary, as in Katib."""

    min: Optional[str] = None
    max: Optional[str] = None
    list: Optional[List[str]] = None
    step: Optional[str] = None
    distribution: Optional[Distribution] = None

    def __post_init__(self):
        if self.distribution is not None and not isinstance(self.distribution, Distribution):
            self.distribution = Distribution(self.distribution)
        for f in ("min", "max", "step"):
            v = getattr(self, f)
            if v is not None and not isinstance(v, str):
                setattr(self, f, str(v))
        if self.list is not None:
            self.list = [str(x) for x in self.list]

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        for f in ("min", "max"):
            if getattr(self, f) is not None:
                d[f] = getattr(self, f)
        if self.list is not None:
            d["list"] = list(self.list)
        if self.step is not None:
            d["step"] = self.step
        if self.distribution is not None:
            d["distribution"] = self.distribution.value
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "FeasibleSpace":
        return cls(
            min=d.get("min"),
            max=d.get("max"),
            list=d.get("list"),
            step=d.get("step"),
            distribution=Distribution(d["distribution"]) if d.get("distribution") else None,
        )


@dataclass
class ParameterSpec:
    name: str
    parameter_type: ParameterType
    feasible_space: FeasibleSpace

    def to_dict(self) -> Dict[str, Any]:
        return {
            "name": self.name,
            "parameterType": self.parameter_type.value,
            "feasibleSpace": self.feasible_space.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParameterSpec":
        return cls(
            name=d["name"],
            parameter_type=ParameterType(d["parameterType"]),
            feasible_space=FeasibleSpace.from_dict(d.get("feasibleSpace", {})),
        )


@dataclass
class MetricStrategy:
    name: str
    value: MetricStrategyType

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "value": self.value.value}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "MetricStrategy":
        return cls(name=d["name"], value=MetricStrategyType(d["value"]))


@dataclass
class ObjectiveSpec:
    type: ObjectiveType = ObjectiveType.UNKNOWN
    goal: Optional[float] = None
    objective_metric_name: str = ""
    additional_metric_names: List[str] = field(default_factory=list)
    metric_strategies: List[MetricStrategy] = field(default_factory=list)

    def all_metric_names(self) -> List[str]:
        return [self.objective_metric_name] + list(self.additional_metric_names)

    def strategy_for(self, metric: str) -> MetricStrategyType:
        for s in self.metric_strategies:
            if s.name == metric:
                return s.value
        # Katib's default: minimize -> min, otherwise max
        return MetricStrategyType.MIN if self.type == ObjectiveType.MINIMIZE else MetricStrategyType.MAX

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"type": self.type.value, "objectiveMetricName": self.objective_metric_name}
        if self.goal is not None:
            d["goal"] = self.goal
        if self.additional_metric_names:
            d["additionalMetricNames"] = list(self.additional_metric_names)
        if self.metric_strategies:
            d["metricStrategies"] = [s.to_dict() for s in self.metric_strategies]
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ObjectiveSpec":
        return cls(
            type=ObjectiveType(d.get("type", "")),
            goal=d.get("goal"),
            objective_metric_name=d.get("objectiveMetricName", ""),
            additional_metric_names=list(d.get("additionalMetricNames", [])),
            metric_strategies=[MetricStrategy.from_dict(s) for s in d.get("metricStrategies", [])],
        )


@dataclass
class AlgorithmSetting:
    name: str
    value: str

    def to_dict(self) -> Dict[str, str]:
        return {"name": self.name, "value": self.value}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlgorithmSetting":
        return cls(name=d["name"], value=str(d["value"]))


@dataclass
class AlgorithmSpec:
    algorithm_name: str = ""
    algorithm_settings: List[AlgorithmSetting] = field(default_factory=list)

    def settings_dict(self) -> Dict[str, str]:
        return {s.name: s.value for s in self.algorithm_settings}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "algorithmName": self.algorithm_name,
            "algorithmSettings": [s.to_dict() for s in self.algorithm_settings],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "AlgorithmSpec":
        return cls(
            algorithm_name=d.get("algorithmName", ""),
            algorithm_settings=[AlgorithmSetting.from_dict(s) for s in d.get("algorithmSettings", [])],
        )


@dataclass
class EarlyStoppingSpec:
    algorithm_name: str = ""
    algorithm_settings: List[AlgorithmSetting] = field(default_factory=list)

    def settings_dict(self) -> Dict[str, str]:
        return {s.name: s.value for s in self.algorithm_settings}

    def to_dict(self) -> Dict[str, Any]:
        return {
            "algorithmName": self.algorithm_name,
            "algorithmSettings": [s.to_dict() for s in self.algorithm_settings],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "EarlyStoppingSpec":
        return cls(
            algorithm_name=d.get("algorithmName", ""),
            algorithm_settings=[AlgorithmSetting.from_dict(s) for s in d.get("algorithmSettings", [])],
        )


@dataclass
class EarlyStoppingRule:
    """Stop the trial when metric ``name`` compares to ``value`` as
    ``comparison`` says; with ``start_step`` > 0, only at that report."""

    name: str
    value: str
    comparison: ComparisonType
    start_step: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "value": self.value, "comparison": self.comparison.value,
                "startStep": self.start_step}


@dataclass
class TrialResources:
    """Devices one trial holds; the controller hands out that many slots."""

    num_devices: int = 1
    num_hosts: int = 1

    def to_dict(self) -> Dict[str, Any]:
        return {"numDevices": self.num_devices, "numHosts": self.num_hosts}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrialResources":
        return cls(num_devices=int(d.get("numDevices", 1)), num_hosts=int(d.get("numHosts", 1)))


@dataclass
class TrialTemplate:
    """An in-process trial: ``entry_point`` "module:function", or a Python
    ``function`` (not serialisable), called as fn(assignments, ctx)."""

    entry_point: Optional[str] = None
    function: Optional[Callable[..., Any]] = None
    resources: TrialResources = field(default_factory=TrialResources)
    retain: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"trialParameters": [], "resources": self.resources.to_dict(), "retain": self.retain}
        if self.entry_point is not None:
            d["entryPoint"] = self.entry_point
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "TrialTemplate":
        if d.get("command") is not None:
            raise ValidationError("command trial templates are not part of the port yet; use entryPoint")
        return cls(
            entry_point=d.get("entryPoint"),
            resources=TrialResources.from_dict(d.get("resources", {})),
            retain=bool(d.get("retain", False)),
        )


@dataclass
class NasOperation:
    """One candidate operation of a NAS search space."""

    operation_type: str
    parameters: List[ParameterSpec] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "operationType": self.operation_type,
            "parameters": [p.to_dict() for p in self.parameters],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NasOperation":
        return cls(
            operation_type=d["operationType"],
            parameters=[ParameterSpec.from_dict(p) for p in d.get("parameters", [])],
        )


@dataclass
class GraphConfig:
    num_layers: Optional[int] = None
    input_sizes: Optional[List[int]] = None
    output_sizes: Optional[List[int]] = None

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {}
        if self.num_layers is not None:
            d["numLayers"] = self.num_layers
        if self.input_sizes is not None:
            d["inputSizes"] = list(self.input_sizes)
        if self.output_sizes is not None:
            d["outputSizes"] = list(self.output_sizes)
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GraphConfig":
        return cls(
            num_layers=d.get("numLayers"),
            input_sizes=d.get("inputSizes"),
            output_sizes=d.get("outputSizes"),
        )


@dataclass
class NasConfig:
    """A NAS experiment's search space: the graph and its operations."""

    graph_config: GraphConfig = field(default_factory=GraphConfig)
    operations: List[NasOperation] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "graphConfig": self.graph_config.to_dict(),
            "operations": [o.to_dict() for o in self.operations],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "NasConfig":
        return cls(
            graph_config=GraphConfig.from_dict(d.get("graphConfig", {})),
            operations=[NasOperation.from_dict(o) for o in d.get("operations", [])],
        )


@dataclass
class ExperimentSpec:
    name: str = ""
    parameters: List[ParameterSpec] = field(default_factory=list)
    objective: ObjectiveSpec = field(default_factory=ObjectiveSpec)
    algorithm: AlgorithmSpec = field(default_factory=AlgorithmSpec)
    trial_template: TrialTemplate = field(default_factory=TrialTemplate)
    parallel_trial_count: Optional[int] = None
    max_trial_count: Optional[int] = None
    max_failed_trial_count: Optional[int] = None
    early_stopping: Optional[EarlyStoppingSpec] = None
    nas_config: Optional[NasConfig] = None
    # a trial whose assignments equal a Succeeded trial's takes its result
    # instead of running (controller/experiment.py)
    reuse_duplicate_results: bool = False

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {
            "name": self.name,
            "parameters": [p.to_dict() for p in self.parameters],
            "objective": self.objective.to_dict(),
            "algorithm": self.algorithm.to_dict(),
            "trialTemplate": self.trial_template.to_dict(),
        }
        if self.early_stopping is not None:
            d["earlyStopping"] = self.early_stopping.to_dict()
        for key, value in (
            ("parallelTrialCount", self.parallel_trial_count),
            ("maxTrialCount", self.max_trial_count),
            ("maxFailedTrialCount", self.max_failed_trial_count),
        ):
            if value is not None:
                d[key] = value
        if self.reuse_duplicate_results:
            d["reuseDuplicateResults"] = True
        if self.nas_config:
            d["nasConfig"] = self.nas_config.to_dict()
        return d

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ExperimentSpec":
        refuse_sections_not_carried(d)
        return cls(
            name=d.get("name", ""),
            parameters=[ParameterSpec.from_dict(p) for p in d.get("parameters", [])],
            objective=ObjectiveSpec.from_dict(d.get("objective", {})),
            algorithm=AlgorithmSpec.from_dict(d.get("algorithm", {})),
            trial_template=TrialTemplate.from_dict(d.get("trialTemplate", {})),
            parallel_trial_count=d.get("parallelTrialCount"),
            max_trial_count=d.get("maxTrialCount"),
            max_failed_trial_count=d.get("maxFailedTrialCount"),
            early_stopping=EarlyStoppingSpec.from_dict(d["earlyStopping"]) if d.get("earlyStopping") else None,
            nas_config=NasConfig.from_dict(d["nasConfig"]) if d.get("nasConfig") else None,
            reuse_duplicate_results=bool(d.get("reuseDuplicateResults", False)),
        )

    @classmethod
    def from_json(cls, s: str) -> "ExperimentSpec":
        return cls.from_dict(json.loads(s))


_CARRIED_KEYS = frozenset({
    "name", "parameters", "objective", "algorithm", "trialTemplate", "parallelTrialCount",
    "maxTrialCount", "maxFailedTrialCount", "earlyStopping", "nasConfig", "reuseDuplicateResults",
})


def _default_collector(mc: Any) -> bool:
    """The JAX package's default collector: push reporting, as its
    ``MetricsCollectorSpec().to_dict()`` writes it, or the section left out."""
    if not mc:
        return True
    collector = mc.get("collector") or {} if isinstance(mc, dict) else None
    return (isinstance(collector, dict) and set(mc) <= {"collector"} and set(collector) <= {"kind"}
            and collector.get("kind", "Push") == "Push")


def refuse_sections_not_carried(d: Dict[str, Any]) -> None:
    """Raise ValidationError naming the first top-level section of a spec
    document that the port would otherwise drop. The values that the JAX
    package writes by default (push collector, ``resumePolicy: Never``,
    ``fairShareWeight: 1``, no priority class) are accepted."""
    refused = {
        "metricsCollectorSpec": lambda v: not _default_collector(v),
        "resumePolicy": lambda v: v not in (None, "Never"),
        "priorityClass": bool,
        "fairShareWeight": lambda v: float(v) != 1.0,
    }
    for key, value in d.items():
        if key.startswith("_") or key in _CARRIED_KEYS:
            continue
        if key not in refused:
            raise ValidationError(f"spec section {key!r} is unknown to the port")
        if refused[key](value):
            shown = "" if isinstance(value, (dict, list)) else f" ({value!r})"
            raise ValidationError(f"spec section {key!r}{shown} is not part of the port yet; the JAX package runs it")


@dataclass
class ParameterAssignment:
    name: str
    value: str

    def to_dict(self) -> Dict[str, str]:
        return {"name": self.name, "value": self.value}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ParameterAssignment":
        return cls(name=d["name"], value=str(d["value"]))


@dataclass
class Metric:
    """One metric's log folded to min/max/latest."""

    name: str
    min: str = UNAVAILABLE_METRIC_VALUE
    max: str = UNAVAILABLE_METRIC_VALUE
    latest: str = UNAVAILABLE_METRIC_VALUE

    def to_dict(self) -> Dict[str, str]:
        return {"name": self.name, "min": self.min, "max": self.max, "latest": self.latest}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Metric":
        return cls(
            name=d["name"],
            min=str(d.get("min", UNAVAILABLE_METRIC_VALUE)),
            max=str(d.get("max", UNAVAILABLE_METRIC_VALUE)),
            latest=str(d.get("latest", UNAVAILABLE_METRIC_VALUE)),
        )


@dataclass
class Observation:
    metrics: List[Metric] = field(default_factory=list)

    def metric(self, name: str) -> Optional[Metric]:
        for m in self.metrics:
            if m.name == name:
                return m
        return None

    def to_dict(self) -> Dict[str, Any]:
        return {"metrics": [m.to_dict() for m in self.metrics]}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "Observation":
        return cls(metrics=[Metric.from_dict(m) for m in d.get("metrics", [])])


@dataclass
class TrialAssignment:
    """One suggestion: a trial name and its parameter assignments."""

    name: str
    parameter_assignments: List[ParameterAssignment] = field(default_factory=list)
    labels: Dict[str, str] = field(default_factory=dict)
