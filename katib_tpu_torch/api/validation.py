"""Experiment admission — the port's own copy of the rules of
``katib_tpu/api/validation.py:validate_experiment`` (Katib's validating
webhook) that apply to the sections the port carries: the name, the trial
budgets, ``reuseDuplicateResults``, the objective and the parameters, with
the JAX package's messages. Errors are collected and raised together as one
``ValidationError``, as the JAX package raises them.

Not here, because the port does not carry their sections: restart edits,
fair share, metrics collectors, command templates. The port's own checks
(entry point, registered algorithm and its settings, devices, hosts) are
``controller/experiment.py:validate_spec``'s.
"""

from __future__ import annotations

import re
from typing import List

from .spec import ExperimentSpec, FeasibleSpace, ObjectiveType, ParameterType, ValidationError

NAME_RE = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")
# the JAX package's step-statistics rows live under this prefix and are never
# folded as objectives, so a spec must not name a metric there
PERF_PREFIX = "katib-tpu/perf/"


def validate_experiment(spec: ExperimentSpec) -> None:
    """Raise ValidationError listing every rule the spec breaks."""
    errs: List[str] = []
    if not NAME_RE.match(spec.name or ""):
        errs.append(
            f"name {spec.name!r} must consist of lower case alphanumeric characters or '-', "
            "start with an alphabetic character, and end with an alphanumeric character"
        )
    _validate_budgets(spec, errs)
    _validate_objective(spec, errs)
    if not spec.algorithm.algorithm_name:
        errs.append("algorithm.algorithmName must be specified")
    if spec.early_stopping is not None and not spec.early_stopping.algorithm_name:
        errs.append("earlyStopping.algorithmName must be specified")
    if not spec.parameters and spec.nas_config is None:
        errs.append("spec.parameters or spec.nasConfig must be specified")
    if spec.parameters and spec.nas_config is not None:
        errs.append("only one of spec.parameters and spec.nasConfig can be specified")
    if spec.parameters:
        _validate_parameters(spec.parameters, errs)
    if errs:
        raise ValidationError(errs)


def _validate_budgets(spec: ExperimentSpec, errs: List[str]) -> None:
    max_trials, parallel, max_failed = spec.max_trial_count, spec.parallel_trial_count, spec.max_failed_trial_count
    if max_failed is not None and max_failed < 0:
        errs.append("maxFailedTrialCount should not be less than 0")
    if max_trials is not None and max_trials <= 0:
        errs.append("maxTrialCount must be greater than 0")
    if parallel is not None and parallel <= 0:
        errs.append("parallelTrialCount must be greater than 0")
    if max_failed is not None and max_trials is not None and max_failed > max_trials:
        errs.append("maxFailedTrialCount should be less than or equal to maxTrialCount")
    if parallel is not None and max_trials is not None and parallel > max_trials:
        errs.append("parallelTrialCount should be less than or equal to maxTrialCount")
    if spec.reuse_duplicate_results and max_trials is None:
        # a reused trial ends as it is created: without a trial budget, an
        # exhausted discrete space and a goal never reached would create
        # reused trials without end
        errs.append("reuseDuplicateResults requires maxTrialCount to bound the experiment")


def _validate_objective(spec: ExperimentSpec, errs: List[str]) -> None:
    obj = spec.objective
    if obj.type not in (ObjectiveType.MINIMIZE, ObjectiveType.MAXIMIZE):
        errs.append("objective.type must be minimize or maximize")
    if not obj.objective_metric_name:
        errs.append("objective.objectiveMetricName must be specified")
    if obj.objective_metric_name in obj.additional_metric_names:
        errs.append("objective.additionalMetricNames should not contain objectiveMetricName")
    for name in [obj.objective_metric_name, *obj.additional_metric_names]:
        if name and name.startswith(PERF_PREFIX):
            errs.append(
                f"metric name {name!r} is under the reserved {PERF_PREFIX!r} "
                "namespace (step-statistics rows; never folded as objectives)"
            )


def _validate_parameters(parameters, errs: List[str]) -> None:
    seen = set()
    for i, p in enumerate(parameters):
        if p.name in seen:
            errs.append(f"parameters[{i}]: duplicate parameter name {p.name!r}")
        seen.add(p.name)
        fs = p.feasible_space
        if fs == FeasibleSpace():
            errs.append(f"parameters[{i}].feasibleSpace must be specified")
            continue
        if p.parameter_type in (ParameterType.DOUBLE, ParameterType.INT):
            if fs.list:
                errs.append(
                    f"parameters[{i}]: feasibleSpace.list is not supported for parameterType {p.parameter_type.value}"
                )
            if not fs.max and not fs.min:
                errs.append(
                    f"parameters[{i}]: feasibleSpace.max or feasibleSpace.min must be specified "
                    f"for parameterType {p.parameter_type.value}"
                )
        elif p.parameter_type in (ParameterType.CATEGORICAL, ParameterType.DISCRETE):
            if fs.max or fs.min or fs.step:
                errs.append(
                    f"parameters[{i}]: feasibleSpace .max, .min and .step are not supported "
                    f"for parameterType {p.parameter_type.value}"
                )
            if not fs.list:
                errs.append(f"parameters[{i}]: feasibleSpace.list must be specified")
        else:
            errs.append(f"parameters[{i}]: parameterType {p.parameter_type.value!r} is not supported")
