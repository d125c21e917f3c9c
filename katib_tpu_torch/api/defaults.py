"""Experiment defaulting — the port's own copy of the parts of
``katib_tpu/api/defaults.py:set_defaults`` (Katib's mutating webhook) that
the port's sections need: the parallel trial count and the metrics
collector. Metric strategies are defaulted where they are read
(``ObjectiveSpec.strategy_for``).
"""

from __future__ import annotations

from .spec import CollectorKind, ExperimentSpec, SourceSpec

DEFAULT_PARALLEL_TRIAL_COUNT = 3  # Katib's default
# Katib's default metrics file is /var/log/katib/metrics.log; here it is
# relative to the trial's directory
DEFAULT_METRICS_FILE = "metrics.log"


def set_defaults(spec: ExperimentSpec) -> ExperimentSpec:
    """Fill the defaultable fields in place (and return the spec): a
    Prometheus collector gets the default endpoint, a File or TfEvent
    collector ``metrics.log``, and a command trial's push collector becomes
    StdOut, since a program the port does not control reports by printing."""
    if spec.parallel_trial_count is None:
        spec.parallel_trial_count = DEFAULT_PARALLEL_TRIAL_COUNT
    mc = spec.metrics_collector_spec
    if mc.collector_kind == CollectorKind.PROMETHEUS and mc.source is None:
        mc.source = SourceSpec()
    if mc.collector_kind in (CollectorKind.FILE, CollectorKind.TF_EVENT) and mc.source is None:
        mc.source = SourceSpec(file_path=DEFAULT_METRICS_FILE)
    is_subprocess_trial = spec.trial_template.command is not None or spec.trial_template.resources.num_hosts > 1
    if is_subprocess_trial and mc.collector_kind == CollectorKind.PUSH:
        mc.collector_kind = CollectorKind.STDOUT
    return spec
