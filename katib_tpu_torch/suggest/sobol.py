"""Sobol quasi-random search — the port's own copy of
``katib_tpu/suggest/sobol.py``, on its own scrambled Sobol engine
(``internal/sobol_engine.py``, scipy's ``qmc.Sobol`` stream bit for bit)
instead of scipy.

The engine is seeded with ``random_state`` (0 when unset) and skips the
trials already created, so successive calls walk one sequence.
"""

from __future__ import annotations

from ..api.spec import TrialAssignment
from .base import Suggester, SuggestionReply, SuggestionRequest, register
from .internal.sobol_engine import SobolEngine


@register
class SobolSearch(Suggester):
    name = "sobol"

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        space = self.search_space(request.experiment)
        sampler = SobolEngine(len(space), seed=self.seed_from(request.experiment) or 0)
        skip = len(request.trials)
        if skip:
            sampler.fast_forward(skip)
        points = sampler.random(request.current_request_number)
        return SuggestionReply(assignments=[
            TrialAssignment(name=self.make_trial_name(request.experiment), parameter_assignments=space.decode(u))
            for u in points
        ])
