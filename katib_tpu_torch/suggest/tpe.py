"""Tree-structured Parzen Estimator — the port's own copy of
``katib_tpu/suggest/tpe.py``, NumPy only (the JAX package's vectorized plane
is a later slice of the port).

Observations are split at the gamma-quantile into good and bad sets; each
set is modelled per dimension with a Parzen window on the unit interval;
candidates are drawn from the good density l(x) and ranked by l(x)/g(x).
Settings: n_startup_trials (10), n_ei_candidates (24), gamma (0.25),
random_state.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .base import Suggester, SuggestionReply, SuggestionRequest, register
from ..api.spec import TrialAssignment
from .internal.search_space import MIN_GOAL, SearchSpace


def _split_observations(
    xs: np.ndarray, ys: np.ndarray, gamma: float, minimize: bool
) -> Tuple[np.ndarray, np.ndarray]:
    """Split into (good, bad) by the gamma quantile of the objective."""
    order = np.argsort(ys if minimize else -ys)
    n_good = max(1, int(np.ceil(gamma * len(ys))))
    good_idx = order[:n_good]
    bad_idx = order[n_good:]
    if len(bad_idx) == 0:
        bad_idx = good_idx
    return xs[good_idx], xs[bad_idx]


def _kde_logpdf(points: np.ndarray, candidates: np.ndarray) -> np.ndarray:
    """Truncated-Gaussian Parzen density on [0,1] per dimension.

    points: [n, D] kernel centers; candidates: [m, D].
    Returns log density [m, D] (per-dimension marginal log-pdf).
    Bandwidth: Scott-style n^{-1/(d+4)} with d=1 per marginal, floored so tiny
    samples stay smooth.
    """
    n = max(len(points), 1)
    bw = max(n ** (-0.2) * 0.5, 0.05)
    # [m, n, D] pairwise squared distances per dim
    diff = candidates[:, None, :] - points[None, :, :]
    log_norm = -0.5 * np.log(2 * np.pi) - np.log(bw)
    logk = log_norm - 0.5 * (diff / bw) ** 2
    # log-mean-exp over kernel centers
    mx = logk.max(axis=1, keepdims=True)
    return (mx + np.log(np.exp(logk - mx).mean(axis=1, keepdims=True)))[:, 0, :]


def _sample_from_kernels(
    points: np.ndarray, rng: np.random.Generator, m: int
) -> np.ndarray:
    """Draw m candidates from the Parzen mixture built on `points` ([n, D])."""
    n, d = points.shape
    bw = max(n ** (-0.2) * 0.5, 0.05)
    centers = points[rng.integers(0, n, size=m)]
    samples = centers + rng.normal(0.0, bw, size=(m, d))
    # reflect at the boundaries to stay in [0,1]
    samples = np.abs(samples)
    samples = 1.0 - np.abs(1.0 - samples)
    return np.clip(samples, 0.0, 1.0 - 1e-9)


@register
class TPE(Suggester):
    name = "tpe"
    multivariate = False

    def validate_algorithm_settings(self, experiment) -> None:
        s = self.settings(experiment)
        if "n_startup_trials" in s and int(s["n_startup_trials"]) < 1:
            raise ValueError("n_startup_trials must be >= 1")
        if "n_ei_candidates" in s and int(s["n_ei_candidates"]) < 1:
            raise ValueError("n_ei_candidates must be >= 1")
        if "gamma" in s and not (0.0 < float(s["gamma"]) < 1.0):
            raise ValueError("gamma must be in (0, 1)")

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        space = self.search_space(request.experiment)
        s = self.settings(request.experiment)
        n_startup = int(s.get("n_startup_trials", 10))
        n_candidates = int(s.get("n_ei_candidates", 24))
        gamma = float(s.get("gamma", 0.25))
        seed = self.seed_from(request.experiment, salt=len(request.trials))
        rng = np.random.default_rng(seed)

        minimize = space.goal == MIN_GOAL
        _, xs, ys = self.history_arrays(request, space)
        n_obs = len(ys)
        batch = request.current_request_number

        # the constant-liar buffers are preallocated once per call
        d = len(space)
        xs_buf = np.empty((n_obs + batch, d), dtype=np.float64)
        ys_buf = np.empty(n_obs + batch, dtype=np.float64)
        xs_buf[:n_obs] = xs.reshape(n_obs, d)
        ys_buf[:n_obs] = ys
        n_aug = n_obs

        assignments: List[TrialAssignment] = []
        for _ in range(batch):
            if n_obs < n_startup:
                u = space.sample_uniform(rng, 1)[0]
            else:
                u = self._tpe_point(
                    xs_buf[:n_aug], ys_buf[:n_aug], space, rng, gamma, n_candidates
                )
            assignments.append(
                TrialAssignment(
                    name=self.make_trial_name(request.experiment),
                    parameter_assignments=space.decode(u),
                )
            )
            # Parallel-suggestion diversity: treat the freshly proposed point as
            # a pseudo-observation at the current worst objective (the
            # "constant liar" strategy) so a batch of suggestions spreads out.
            if n_obs >= n_startup and n_aug:
                lie = ys_buf[:n_aug].max() if minimize else ys_buf[:n_aug].min()
                xs_buf[n_aug] = u
                ys_buf[n_aug] = lie
                n_aug += 1

        return SuggestionReply(assignments=assignments)

    def _tpe_point(
        self,
        xs: np.ndarray,
        ys: np.ndarray,
        space: SearchSpace,
        rng: np.random.Generator,
        gamma: float,
        n_candidates: int,
    ) -> np.ndarray:
        good, bad = _split_observations(xs, ys, gamma, space.goal == MIN_GOAL)
        cands = _sample_from_kernels(good, rng, n_candidates)
        log_l = _kde_logpdf(good, cands)
        log_g = _kde_logpdf(bad, cands)
        if self.multivariate:
            score = (log_l - log_g).sum(axis=1)  # joint ranking
            return cands[int(np.argmax(score))]
        # Independent per-dimension choice (hyperopt-style TPE).
        per_dim = log_l - log_g  # [m, D]
        best = per_dim.argmax(axis=0)  # per-dim best candidate index
        return cands[best, np.arange(cands.shape[1])]


@register
class MultivariateTPE(TPE):
    name = "multivariate-tpe"
    multivariate = True
