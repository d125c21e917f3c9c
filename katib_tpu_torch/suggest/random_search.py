"""Random search — the port's own copy of ``katib_tpu/suggest/random_search.py``:
uniform samples of the unit cube, decoded through each parameter's scale."""

from __future__ import annotations

import numpy as np

from ..api.spec import TrialAssignment
from .base import Suggester, SuggestionReply, SuggestionRequest, register


@register
class RandomSearch(Suggester):
    name = "random"

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        space = self.search_space(request.experiment)
        rng = np.random.default_rng(self.seed_from(request.experiment, salt=len(request.trials)))
        seen = {tuple(sorted(t.assignments_dict().items())) for t in request.trials}
        assignments = []
        attempts = 0
        while len(assignments) < request.current_request_number:
            pa = space.decode(space.sample_uniform(rng, 1)[0])
            key = tuple(sorted((a.name, a.value) for a in pa))
            attempts += 1
            # skip exact duplicates while the space has room; give up after a
            # bounded number of retries (tiny discrete spaces)
            if key in seen and attempts < 100 * request.current_request_number:
                continue
            seen.add(key)
            assignments.append(
                TrialAssignment(name=self.make_trial_name(request.experiment), parameter_assignments=pa)
            )
        return SuggestionReply(assignments=assignments)
