"""Experiment admission — the port's own copy of the rules of
``katib_tpu/api/validation.py:validate_experiment`` (Katib's validating
webhook) that apply to the sections the port carries: the name, the trial
budgets, ``reuseDuplicateResults``, the objective, the trial template (its
one source, trial parameters, placeholders and conditions), the parameters
and the metrics collector, with the JAX package's messages, in its order.
Errors are collected and raised together as one ``ValidationError``, as the
JAX package raises them.

Not here, because the port does not carry their sections: restart edits,
fair share, packing and topologies. The port's own checks (entry point,
registered algorithm and its settings, devices, hosts) are
``controller/experiment.py:validate_spec``'s.
"""

from __future__ import annotations

import ast
import re
from typing import List

from ..controller.conditions import ConditionError, parse_condition
from .spec import CollectorKind, ExperimentSpec, FeasibleSpace, ObjectiveType, ParameterType, ValidationError

NAME_RE = re.compile(r"^[a-z]([-a-z0-9]*[a-z0-9])?$")
# a command template's placeholders (Katib's consts/const.go)
TRIAL_PARAM_RE = re.compile(r"\$\{trialParameters\.([^}]+)\}")
META_PARAM_RE = re.compile(r"\$\{trialSpec\.([^}]+)\}")
META_KEYS = {"Name", "Namespace", "Kind", "APIVersion"}
# what a NAS suggester assigns (ENAS: architecture, nn_config; DARTS:
# algorithm-settings, search-space, num-layers)
NAS_ASSIGNMENTS = {"architecture", "nn_config", "algorithm-settings", "search-space", "num-layers"}
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
    _validate_trial_template(spec, errs)
    if not spec.parameters and spec.nas_config is None:
        errs.append("spec.parameters or spec.nasConfig must be specified")
    if spec.parameters and spec.nas_config is not None:
        errs.append("only one of spec.parameters and spec.nasConfig can be specified")
    if spec.parameters:
        _validate_parameters(spec.parameters, errs)
    _validate_metrics_collector(spec, errs)
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


def _validate_trial_template(spec: ExperimentSpec, errs: List[str]) -> None:
    """Katib's validator.go rules for the template: one source; every trial
    parameter unique and resolving to a search-space parameter (or a meta
    key); conditions that parse, ``stdout`` only where it is captured; no
    dangling or unused placeholder."""
    t = spec.trial_template
    sources = [t.command is not None, t.entry_point is not None, t.function is not None]
    if sum(sources) == 0:
        errs.append("trialTemplate must define one of command, entryPoint or function")
        return
    if sum(sources) > 1:
        errs.append("trialTemplate must define exactly one of command, entryPoint or function")
        return
    search_params = {p.name for p in spec.parameters}
    if spec.nas_config is not None:
        search_params |= NAS_ASSIGNMENTS
    tp_names = set()
    for tp in t.trial_parameters:
        if tp.name in tp_names:
            errs.append(f"trialParameters: duplicate name {tp.name!r}")
        tp_names.add(tp.name)
        if not tp.reference:
            errs.append(f"trialParameters[{tp.name}]: reference must be specified")
        elif tp.reference not in search_params and not _is_meta_key(tp.reference):
            errs.append(f"trialParameters[{tp.name}]: reference {tp.reference!r} not found in search space")
    if t.resources.num_hosts < 1:
        errs.append("trialTemplate.resources.numHosts must be >= 1")
    if t.resources.num_hosts > 1 and t.function is not None:
        errs.append(
            "trialTemplate.resources.numHosts > 1 requires a command or "
            "entryPoint template (an in-memory function cannot be "
            "distributed across worker processes)"
        )
    for cond_field, expr in (("successCondition", t.success_condition), ("failureCondition", t.failure_condition)):
        if not expr:
            continue
        try:
            tree = parse_condition(expr)
        except ConditionError as e:
            errs.append(f"trialTemplate.{cond_field}: {e}")
            continue
        # an in-process trial captures no stdout, so a condition on it would never match
        if t.command is None and t.resources.num_hosts <= 1 and any(
                isinstance(n, ast.Name) and n.id == "stdout" for n in ast.walk(tree)):
            errs.append(
                f"trialTemplate.{cond_field}: 'stdout' is only "
                "available for command templates (in-process trials "
                "capture no stdout)"
            )
    if t.command is not None:
        text = "\n".join(t.command)
        used = set(TRIAL_PARAM_RE.findall(text))
        for name in used - tp_names:
            errs.append(f"template placeholder ${{trialParameters.{name}}} has no trialParameters entry")
        for name in tp_names - used:
            errs.append(f"trialParameters[{name}] is not used in the template")
        for meta in META_PARAM_RE.findall(text):
            base = meta.split("[", 1)[0]
            if base not in META_KEYS and not meta.startswith(("Annotations[", "Labels[")):
                errs.append(f"unknown trialSpec meta placeholder ${{trialSpec.{meta}}}")


def _is_meta_key(reference: str) -> bool:
    """Katib's isMetaKey: ``${trialSpec.<key>}`` of a meta key, a label or an annotation."""
    if reference in {f"${{trialSpec.{k}}}" for k in META_KEYS}:
        return True
    return bool(re.match(r"^\$\{trialSpec\.(Annotations|Labels)\[[^\]]+\]\}$", reference))


def _validate_metrics_collector(spec: ExperimentSpec, errs: List[str]) -> None:
    """Katib's collector rules (validator.go), without its container checks."""
    mc = spec.metrics_collector_spec
    if mc.collector_kind in (CollectorKind.FILE, CollectorKind.TF_EVENT):
        if mc.source is None or not mc.source.file_path:
            errs.append(f"metricsCollector kind {mc.collector_kind.value} requires source.filePath")
    if mc.custom_command is not None:
        if mc.collector_kind != CollectorKind.CUSTOM:
            errs.append("customCollector.command requires collector kind Custom")
        elif not (isinstance(mc.custom_command, list) and mc.custom_command
                  and all(isinstance(a, str) for a in mc.custom_command)):
            errs.append("customCollector.command must be a non-empty list of strings")
    elif mc.collector_kind == CollectorKind.CUSTOM:
        # otherwise the user's collector never runs and metrics come from the wrong source
        errs.append("collector kind Custom requires customCollector.command")
    if mc.collector_kind == CollectorKind.FILE and mc.source and mc.source.filter:
        for f in mc.source.filter.metrics_format:
            try:
                ngroups = re.compile(f).groups
            except re.error:
                errs.append(f"metricsCollector filter {f!r} is not a valid regex")
                continue
            if ngroups != 2:
                errs.append(f"metricsCollector filter {f!r} must have exactly 2 capture groups")
