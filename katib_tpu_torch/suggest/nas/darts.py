"""DARTS suggestion algorithm — the port's own copy of
``katib_tpu/suggest/nas/darts.py``.

DARTS runs one trial: the suggestion serialises the search space (each
operation expanded per filter size), the algorithm settings (the reference's
defaults under the spec's own) and the layer count as JSON strings with
single quotes for double quotes; the bilevel search runs inside the trial
(``models/darts_trainer.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List

from ...api.spec import ExperimentSpec, NasConfig, ParameterAssignment, TrialAssignment
from ..base import Suggester, SuggestionReply, SuggestionRequest, register

# the reference's get_algorithm_settings defaults
DARTS_DEFAULT_SETTINGS: Dict[str, object] = {
    "num_epochs": 50,
    "w_lr": 0.025,
    "w_lr_min": 0.001,
    "w_momentum": 0.9,
    "w_weight_decay": 3e-4,
    "w_grad_clip": 5.0,
    "alpha_lr": 3e-4,
    "alpha_weight_decay": 1e-3,
    "batch_size": 128,
    "num_workers": 4,
    "init_channels": 16,
    "print_step": 50,
    "num_nodes": 4,
    "stem_multiplier": 3,
}


def darts_search_space(nas_config: NasConfig) -> List[str]:
    """The flat operation names: 'skip_connection' as it is, any other
    operation once per filter size ('separable_convolution_3x3', ...)."""
    space: List[str] = []
    for op in nas_config.operations:
        if op.operation_type == "skip_connection":
            space.append(op.operation_type)
        else:
            params = op.parameters
            sizes = params[0].feasible_space.list or [] if params else []
            for fs in sizes:
                space.append(f"{op.operation_type}_{fs}x{fs}")
    return space


def darts_algorithm_settings(spec: ExperimentSpec) -> Dict[str, object]:
    settings = dict(DARTS_DEFAULT_SETTINGS)
    for s in spec.algorithm.algorithm_settings:
        settings[s.name] = None if s.value == "None" else s.value
    return settings


@register
class Darts(Suggester):
    name = "darts"

    def validate_algorithm_settings(self, experiment: ExperimentSpec) -> None:
        if experiment.nas_config is None:
            raise ValueError("darts requires nasConfig")
        if not experiment.nas_config.operations:
            raise ValueError("nasConfig.operations must not be empty")
        for s in experiment.algorithm.algorithm_settings:
            name, value = s.name, s.value
            try:
                if name == "num_epochs" and not int(value) > 0:
                    raise ValueError(f"{name} should be greater than zero")
                if name in {"w_lr", "w_lr_min", "alpha_lr", "w_weight_decay",
                            "alpha_weight_decay", "w_momentum", "w_grad_clip"}:
                    if not float(value) >= 0.0:
                        raise ValueError(f"{name} should be >= 0")
                if name == "batch_size" and value != "None" and not int(value) >= 1:
                    raise ValueError("batch_size should be >= 1")
                if name == "num_workers" and not int(value) >= 0:
                    raise ValueError("num_workers should be >= 0")
                if name in {"init_channels", "print_step", "num_nodes", "stem_multiplier"}:
                    if not int(value) >= 1:
                        raise ValueError(f"{name} should be >= 1")
                # the trainer's normalisation, so that admission refuses
                # exactly what the trainer would refuse
                if name == "hessian_mode" and value != "None":
                    if str(value).strip().lower() not in ("jvp", "fd"):
                        raise ValueError("hessian_mode should be 'jvp' or 'fd'")
            except ValueError:
                raise
            except Exception as e:
                raise ValueError(f"failed to validate {name}({value}): {e}")

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        spec = request.experiment
        if spec.nas_config is None:
            raise ValueError("darts requires nasConfig")
        num_layers = str(spec.nas_config.graph_config.num_layers or 0)
        search_space_str = json.dumps(darts_search_space(spec.nas_config)).replace('"', "'")
        settings_str = json.dumps(darts_algorithm_settings(spec)).replace('"', "'")
        assignments = [
            TrialAssignment(
                name=self.make_trial_name(spec),
                parameter_assignments=[
                    ParameterAssignment("algorithm-settings", settings_str),
                    ParameterAssignment("search-space", search_space_str),
                    ParameterAssignment("num-layers", num_layers),
                ],
            )
            for _ in range(request.current_request_number)
        ]
        return SuggestionReply(assignments=assignments)
