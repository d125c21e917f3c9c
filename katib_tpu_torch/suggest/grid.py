"""Grid search — the port's own copy of ``katib_tpu/suggest/grid.py``.

The grid is enumerated in a fixed order, skipping assignments already
tried; a reply shorter than the request ends the search, which the
controller turns into reason SuggestionEndReached.
"""

from __future__ import annotations

from ..api.spec import TrialAssignment
from .base import Suggester, SuggestionReply, SuggestionRequest, register


@register
class GridSearch(Suggester):
    name = "grid"

    def validate_algorithm_settings(self, experiment) -> None:
        self.search_space(experiment).grid_combinations()  # a double without a step raises

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        tried = {tuple(sorted(t.assignments_dict().items())) for t in request.trials}
        assignments = []
        for combo in self.search_space(request.experiment).grid_combinations():
            if len(assignments) >= request.current_request_number:
                break
            key = tuple(sorted((a.name, a.value) for a in combo))
            if key in tried:
                continue
            tried.add(key)
            assignments.append(
                TrialAssignment(name=self.make_trial_name(request.experiment), parameter_assignments=combo))
        return SuggestionReply(assignments=assignments,
                               search_ended=len(assignments) < request.current_request_number)
