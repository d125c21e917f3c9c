"""CMA-ES — the port's own copy of ``katib_tpu/suggest/cmaes.py``, NumPy only:
(mu/mu_w, lambda)-CMA-ES with cumulative step-size adaptation and rank-one
plus rank-mu covariance updates, and IPOP/BIPOP restarts.

The suggester keeps no state between calls. Every assignment is labelled
``cmaes-generation``, and each request rebuilds the strategy (mean, sigma,
C, evolution paths) by folding the generations whose created trials are
all terminal, in order, from the assignments re-encoded to the unit cube.
With ``random_state`` set, the draws come from
``default_rng(random_state + len(trials))``, so the port's assignments equal
the JAX package's NumPy path for the same history.

Numeric (int/double) parameters only, at least 2 of them. Settings: sigma
(initial step, 0.3), popsize (4 + floor(3 ln D)), restart_strategy (none,
ipop or bipop), random_state. Restarts are decided while folding: a
collapsed step size, or no gain in the generation-best beyond ``TOLFUN``
over the stall window, restarts the strategy at a mean drawn from a seed
that depends only on the experiment and the restart's number. ``ipop``
doubles popsize at each restart; ``bipop`` runs whichever of the large
(doubling) and small (first popsize) regimes has used fewer evaluations.
The current popsize and restart count go back to the controller as
settings (``cmaes_current_popsize``, ``cmaes_restarts``).

Not ported: the JAX package's compiled replay (``_vectorized_replay``,
``katib_tpu/suggest/vectorized.py:cma_replay``), which folds the same
generations in one ``lax.scan`` (ROADMAP Queue 1 item 8), and the warm-start
anchor of the first mean, since the port's requests carry no warm start.
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Dict, List, NamedTuple, Optional

import numpy as np

from ..api.spec import TrialAssignment
from .base import Suggester, SuggestionReply, SuggestionRequest, register
from .internal.search_space import MIN_GOAL

GENERATION_LABEL = "cmaes-generation"
RESTART_STRATEGIES = ("none", "ipop", "bipop")
TOLFUN = 1e-12  # generation-best gain below which a stall window counts as stagnation


def stall_generations(dim: int, popsize: int) -> int:
    """The stagnation window: 10 + 30·D/λ generations."""
    return 10 + int(30 * dim / popsize)


@dataclass
class _CmaState:
    dim: int
    popsize: int
    sigma: float
    mean: np.ndarray
    C: np.ndarray
    p_sigma: np.ndarray
    p_c: np.ndarray
    generation: int = 0
    # C's eigendecomposition, taken once each time C is assigned; it serves
    # the next update's C^{-1/2} and every sample until C changes
    eig_B: Optional[np.ndarray] = None
    eig_D: Optional[np.ndarray] = None  # sqrt of the clamped eigenvalues
    eig_inv_sqrt: Optional[np.ndarray] = None  # C^{-1/2}

    @classmethod
    def fresh(cls, dim: int, popsize: int, sigma0: float) -> "_CmaState":
        state = cls(dim=dim, popsize=popsize, sigma=sigma0, mean=np.full(dim, 0.5), C=np.eye(dim),
                    p_sigma=np.zeros(dim), p_c=np.zeros(dim))
        state.refresh_eigen()
        return state

    def refresh_eigen(self) -> None:
        eigval, eigvec = np.linalg.eigh(self.C)
        eigval = np.maximum(eigval, 1e-20)
        self.eig_B = eigvec
        self.eig_D = np.sqrt(eigval)
        self.eig_inv_sqrt = eigvec @ np.diag(eigval**-0.5) @ eigvec.T

    @property
    def mu(self) -> int:
        return self.popsize // 2

    def weights(self) -> np.ndarray:
        w = np.log(self.mu + 0.5) - np.log(np.arange(1, self.mu + 1))
        return w / w.sum()

    def update(self, xs: np.ndarray, fitnesses: np.ndarray) -> None:
        """One generation: xs [n, D] in the unit cube, fitnesses minimised."""
        d = self.dim
        order = np.argsort(fitnesses)
        mu = min(self.mu, len(order))
        if mu == 0:
            self.generation += 1
            return
        w = self.weights()[:mu]
        w = w / w.sum()
        mu_eff = 1.0 / (w**2).sum()

        c_sigma = (mu_eff + 2) / (d + mu_eff + 5)
        d_sigma = 1 + 2 * max(0.0, math.sqrt((mu_eff - 1) / (d + 1)) - 1) + c_sigma
        c_c = (4 + mu_eff / d) / (d + 4 + 2 * mu_eff / d)
        c_1 = 2 / ((d + 1.3) ** 2 + mu_eff)
        c_mu = min(1 - c_1, 2 * (mu_eff - 2 + 1 / mu_eff) / ((d + 2) ** 2 + mu_eff))
        chi_n = math.sqrt(d) * (1 - 1 / (4 * d) + 1 / (21 * d * d))

        old_mean = self.mean
        ys = (xs[order[:mu]] - old_mean) / self.sigma  # [mu, D]
        y_w = (w[:, None] * ys).sum(axis=0)
        self.mean = old_mean + self.sigma * y_w

        self.p_sigma = (1 - c_sigma) * self.p_sigma + math.sqrt(
            c_sigma * (2 - c_sigma) * mu_eff
        ) * (self.eig_inv_sqrt @ y_w)
        ps_norm = np.linalg.norm(self.p_sigma)
        h_sigma = ps_norm / math.sqrt(
            1 - (1 - c_sigma) ** (2 * (self.generation + 1))
        ) < (1.4 + 2 / (d + 1)) * chi_n
        self.p_c = (1 - c_c) * self.p_c + (
            math.sqrt(c_c * (2 - c_c) * mu_eff) * y_w if h_sigma else 0.0
        )

        rank_mu = (w[:, None, None] * (ys[:, :, None] @ ys[:, None, :])).sum(axis=0)
        delta_h = (1 - h_sigma) * c_c * (2 - c_c)
        self.C = (
            (1 - c_1 - c_mu) * self.C
            + c_1 * (np.outer(self.p_c, self.p_c) + delta_h * self.C)
            + c_mu * rank_mu
        )
        self.sigma *= math.exp((c_sigma / d_sigma) * (ps_norm / chi_n - 1))
        self.sigma = float(np.clip(self.sigma, 1e-8, 1e4))
        self.generation += 1
        self.refresh_eigen()

    def sample(self, rng: np.random.Generator, n: int) -> np.ndarray:
        z = rng.standard_normal((n, self.dim))
        xs = self.mean[None, :] + self.sigma * (z * self.eig_D[None, :]) @ self.eig_B.T
        return np.clip(xs, 0.0, 1.0 - 1e-9)


class Replay(NamedTuple):
    """The strategy rebuilt from a request's history."""

    state: _CmaState
    generation: int  # the first generation not yet folded
    popsize: int
    restarts: int
    created_by_gen: Dict[int, int]


@register
class CMAES(Suggester):
    name = "cmaes"

    def validate_algorithm_settings(self, experiment) -> None:
        space = self.search_space(experiment)
        if any(not p.is_numeric for p in space.params):
            raise ValueError("cmaes supports only int/double parameters")
        if len(space) < 2:
            raise ValueError("cmaes requires at least 2 parameters")
        s = self.settings(experiment)
        if "sigma" in s and float(s["sigma"]) <= 0:
            raise ValueError("sigma must be > 0")
        if "popsize" in s and int(s["popsize"]) < 2:
            raise ValueError("popsize must be >= 2")
        if s.get("restart_strategy", "none") not in RESTART_STRATEGIES:
            raise ValueError("restart_strategy must be none, ipop or bipop")

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        space = self.search_space(request.experiment)
        rng = np.random.default_rng(self.seed_from(request.experiment, salt=len(request.trials)))
        replay = self.replay(request)
        # fill the current generation, then spill into the next label: the
        # distribution does not change until the generation folds
        assignments: List[TrialAssignment] = []
        slot = replay.created_by_gen.get(replay.generation, 0)
        for x in replay.state.sample(rng, request.current_request_number):
            label_gen = replay.generation + slot // replay.popsize
            slot += 1
            assignments.append(TrialAssignment(
                name=self.make_trial_name(request.experiment),
                parameter_assignments=space.decode(x),
                labels={GENERATION_LABEL: str(label_gen)},
            ))
        # namespaced, since the controller lays them over the spec's settings,
        # whose "popsize" seeds the first generation
        return SuggestionReply(assignments=assignments, algorithm_settings={
            "cmaes_current_popsize": str(replay.popsize),
            "cmaes_restarts": str(replay.restarts),
        })

    def replay(self, request: SuggestionRequest) -> Replay:
        """Fold the request's complete generations in order, restarting as
        the strategy says."""
        experiment = request.experiment
        space = self.search_space(experiment)
        s = self.settings(experiment)
        dim = len(space)
        popsize0 = int(s.get("popsize", 4 + int(3 * math.log(max(dim, 1)))))
        sigma0 = float(s.get("sigma", 0.3))
        strategy = s.get("restart_strategy", "none")
        minimize = space.goal == MIN_GOAL

        by_gen: Dict[int, List] = {}
        created_by_gen: Dict[int, int] = {}
        terminal_by_gen: Dict[int, int] = {}
        for t in request.trials:
            g = t.labels.get(GENERATION_LABEL)
            if g is None:
                continue
            created_by_gen[int(g)] = created_by_gen.get(int(g), 0) + 1
            if t.is_terminal:
                terminal_by_gen[int(g)] = terminal_by_gen.get(int(g), 0) + 1
        for t in self.history(request):
            g = t.labels.get(GENERATION_LABEL)
            if g is None or t.objective is None:
                continue
            by_gen.setdefault(int(g), []).append(t)

        popsize = popsize0
        state = _CmaState.fresh(dim, popsize, sigma0)
        restarts = large_restarts = 0
        gen_best: List[float] = []  # best fitness of each generation folded since the last restart
        evals_large = evals_small = 0  # BIPOP's budgets
        in_large = True
        gen = 0
        while True:
            created = created_by_gen.get(gen, 0)
            # fold once every created trial of the generation is terminal:
            # the folded set is then the same whenever a request sees it,
            # even when a generation holds more than popsize trials
            if created < popsize or terminal_by_gen.get(gen, 0) < created:
                break
            done = by_gen.get(gen, [])
            if done:
                xs = space.encode_many([t.assignments for t in done])
                ys = np.array([t.objective for t in done])
                if not minimize:
                    ys = -ys
                state.update(xs, ys)
                gen_best.append(float(ys.min()))
                if strategy == "bipop":
                    if in_large:
                        evals_large += len(done)
                    else:
                        evals_small += len(done)
            else:
                state.generation += 1
            gen += 1
            if strategy != "none" and self._stagnated(state, gen_best, dim, popsize):
                restarts += 1
                if strategy == "ipop":
                    popsize *= 2
                else:  # bipop
                    in_large = evals_large <= evals_small
                    if in_large:
                        large_restarts += 1
                    popsize = popsize0 * (2 ** large_restarts if in_large else 1)
                state = _CmaState.fresh(dim, popsize, sigma0)
                state.mean = np.random.default_rng(self.restart_seed(experiment, restarts)).uniform(0.0, 1.0, dim)
                gen_best = []
        return Replay(state, gen, popsize, restarts, created_by_gen)

    @classmethod
    def restart_seed(cls, experiment, restarts: int) -> int:
        """The seed of restart number ``restarts``'s mean. It must be the same
        on every call (the sampling seed is salted by the trial count), so
        without ``random_state`` it comes from the experiment's name."""
        base = cls.seed_from(experiment, salt=0)
        if base is None:
            base = int.from_bytes(hashlib.blake2b(experiment.name.encode(), digest_size=4).digest(), "big")
        return base + 100_000 + restarts

    @staticmethod
    def _stagnated(state: _CmaState, gen_best: List[float], dim: int, popsize: int) -> bool:
        """A collapsed step size, or no generation-best gain beyond TOLFUN
        over the stall window."""
        if state.sigma <= 1e-8:
            return True
        stall = stall_generations(dim, popsize)
        if len(gen_best) <= stall:
            return False
        return min(gen_best[:-stall]) - min(gen_best[-stall:]) < TOLFUN
