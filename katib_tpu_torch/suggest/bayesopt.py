"""Gaussian-process Bayesian optimisation — the port's own copy of the NumPy
path of ``katib_tpu/suggest/bayesopt.py`` (the JAX package's parity oracle),
with torch float64 on the CPU in place of scipy.

A GP with a Matérn-5/2 kernel over the unit cube; its length-scale and noise
are picked from a 6 x 3 grid by log marginal likelihood, on the real
history, once a call. Acquisition takes the best of 512 (or 64·D) uniform
candidates plus jittered copies of the five best points, one pick at a
time; each pick is appended to the history with the worst objective seen
(a constant liar) before the next. ``gp_hedge`` picks among the portfolio's
(EI, PI, LCB) nominations by a softmax over gains: the GP's predicted mean,
standardised and negated, at each past trial that a member proposed (label
``bo-acq``). The Cholesky, its solves and the normal cdf are torch's
(``torch.linalg.cholesky``, ``torch.cholesky_solve``,
``torch.special.ndtr``); every random draw is NumPy's ``default_rng`` in the
reference's order.

Settings: base_estimator (only "GP"), n_initial_points (10), acq_func
(gp_hedge, ei, pi or lcb), random_state, length_scale (pins the
length-scale, noise 1e-6). Not ported: the vectorized batch acquisition
(ROADMAP Queue 1 item 8) and warm-start rows, which the port's requests do
not carry.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..api.spec import TrialAssignment
from .base import Suggester, SuggestionReply, SuggestionRequest, register
from .internal.search_space import MIN_GOAL

ACQ_LABEL = "bo-acq"
PORTFOLIO = ("ei", "pi", "lcb")

# Marginal-likelihood grid (unit-cube inputs, standardized targets).
_LENGTH_GRID = (0.05, 0.1, 0.2, 0.35, 0.6, 1.0)
_NOISE_GRID = (1e-6, 1e-4, 1e-2)
_NORM_PDF_C = np.sqrt(2 * np.pi)


def _matern52(a: np.ndarray, b: np.ndarray, length: float) -> np.ndarray:
    """Matérn-5/2 kernel matrix between [n,D] and [m,D]."""
    d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    d = np.sqrt(np.maximum(d2, 1e-300)) / length
    s5 = math.sqrt(5.0)
    return (1.0 + s5 * d + 5.0 / 3.0 * d * d) * np.exp(-s5 * d)


def _cho_solve(chol: torch.Tensor, b: np.ndarray) -> np.ndarray:
    """Solve (L Lᵀ) x = b for b [n] or [n, m]."""
    rhs = torch.from_numpy(np.ascontiguousarray(b.reshape(len(b), -1)))
    return torch.cholesky_solve(rhs, chol).numpy().reshape(b.shape)


class _GP:
    def __init__(self, xs: np.ndarray, ys: np.ndarray, length: float = 0.25, noise: float = 1e-6):
        self.xs = xs
        self.y_mean = ys.mean()
        self.y_std = ys.std() + 1e-12
        self.ys = (ys - self.y_mean) / self.y_std
        if not np.isfinite(self.ys).all():
            raise ValueError("array must not contain infs or NaNs")
        self.length = length
        self.noise = noise
        K = _matern52(xs, xs, length) + noise * np.eye(len(xs))
        self.chol = torch.linalg.cholesky(torch.from_numpy(K))  # lower
        self.alpha = _cho_solve(self.chol, self.ys)

    def log_marginal_likelihood(self) -> float:
        n = len(self.ys)
        log_det = 2.0 * np.log(np.diag(self.chol.numpy())).sum()
        return float(-0.5 * self.ys @ self.alpha - 0.5 * log_det - 0.5 * n * math.log(2 * math.pi))

    @classmethod
    def fit_mle(cls, xs: np.ndarray, ys: np.ndarray) -> "_GP":
        """Grid-search length-scale × noise by log marginal likelihood; a
        grid point whose kernel matrix is not positive definite is skipped."""
        best: Optional[_GP] = None
        best_lml = -np.inf
        for length in _LENGTH_GRID:
            for noise in _NOISE_GRID:
                try:
                    gp = cls(xs, ys, length=length, noise=noise)
                except torch.linalg.LinAlgError:
                    continue
                lml = gp.log_marginal_likelihood()
                if lml > best_lml:
                    best, best_lml = gp, lml
        return best if best is not None else cls(xs, ys)

    def predict(self, cands: np.ndarray):
        Ks = _matern52(cands, self.xs, self.length)  # [m, n]
        mu = Ks @ self.alpha
        v = _cho_solve(self.chol, Ks.T)  # [n, m]
        var = np.maximum(1.0 - (Ks * v.T).sum(axis=1), 1e-12)
        return mu * self.y_std + self.y_mean, np.sqrt(var) * self.y_std


def _norm_cdf(z: np.ndarray) -> np.ndarray:
    return torch.special.ndtr(torch.from_numpy(np.asarray(z, dtype=np.float64))).numpy()


def _norm_pdf(z: np.ndarray) -> np.ndarray:
    return np.exp(-z ** 2 / 2.0) / _NORM_PDF_C


def _acq_scores(acq: str, mu: np.ndarray, sigma: np.ndarray, y_best: float) -> np.ndarray:
    """Higher is better; inputs are in minimization orientation."""
    if acq == "lcb":
        return -(mu - 1.96 * sigma)  # minimize LCB -> maximize negative
    imp = y_best - mu  # improvement for minimization
    z = imp / sigma
    if acq == "pi":
        return _norm_cdf(z)
    return imp * _norm_cdf(z) + sigma * _norm_pdf(z)  # ei


@register
class BayesianOptimization(Suggester):
    name = "bayesianoptimization"

    def validate_algorithm_settings(self, experiment) -> None:
        s = self.settings(experiment)
        if s.get("base_estimator", "GP") != "GP":
            raise ValueError("only base_estimator=GP is supported")
        if "n_initial_points" in s and int(s["n_initial_points"]) < 1:
            raise ValueError("n_initial_points must be >= 1")
        if s.get("acq_func", "gp_hedge") not in ("ei", "pi", "lcb", "gp_hedge"):
            raise ValueError("acq_func must be one of ei, pi, lcb, gp_hedge")
        if "length_scale" in s and not (float(s["length_scale"]) > 0):
            raise ValueError("length_scale must be > 0")

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        space = self.search_space(request.experiment)
        s = self.settings(request.experiment)
        n_initial = int(s.get("n_initial_points", 10))
        acq = s.get("acq_func", "gp_hedge")
        fixed_length = float(s["length_scale"]) if "length_scale" in s else None
        rng = np.random.default_rng(self.seed_from(request.experiment, salt=len(request.trials)))

        history, xs, ys = self.history_arrays(request, space)
        if space.goal != MIN_GOAL:  # internally always minimize, like skopt
            ys = -ys
        acq_labels = [t.labels.get(ACQ_LABEL) for t in history]
        n_real = len(ys)

        # kernel hyperparameters once a call, on the real history
        hypers: Optional[Tuple[float, float]] = None
        gp_real: Optional[_GP] = None
        if fixed_length is not None:
            hypers = (fixed_length, 1e-6)
        elif n_real >= n_initial:
            gp_real = _GP.fit_mle(xs, ys)
            hypers = (gp_real.length, gp_real.noise)

        # hedge gains from the real history only, fixed across the batch
        gains: Optional[np.ndarray] = None
        if acq == "gp_hedge" and hypers is not None and n_real >= n_initial:
            if gp_real is None:
                gp_real = _GP(xs, ys, length=hypers[0], noise=hypers[1])
            gains = self.hedge_gains(gp_real, xs, acq_labels)

        assignments: List[TrialAssignment] = []
        for _ in range(request.current_request_number):
            labels: Dict[str, str] = {}
            if len(ys) < n_initial:
                u = space.sample_uniform(rng, 1)[0]
            else:
                u, chosen = self._acquire(xs, ys, space, rng, acq, hypers, gains)
                if chosen is not None:
                    labels[ACQ_LABEL] = chosen
                # constant liar for batch diversity
                xs = np.vstack([xs, u[None, :]])
                ys = np.append(ys, ys.max())
            assignments.append(TrialAssignment(name=self.make_trial_name(request.experiment),
                                               parameter_assignments=space.decode(u), labels=labels))
        return SuggestionReply(assignments=assignments)

    @staticmethod
    def hedge_gains(gp: _GP, xs: np.ndarray, acq_labels: List[Optional[str]]) -> np.ndarray:
        """Gains per portfolio member: minus the GP's standardised predicted
        mean at each past proposal of that member."""
        gains = np.zeros(len(PORTFOLIO))
        if len(xs) == 0:
            return gains
        mu, _ = gp.predict(xs)
        mu_z = (mu - gp.y_mean) / gp.y_std
        for x_mu, label in zip(mu_z, acq_labels):
            if label in PORTFOLIO:
                gains[PORTFOLIO.index(label)] -= x_mu
        return gains

    def _acquire(self, xs: np.ndarray, ys: np.ndarray, space, rng, acq: str, hypers: Tuple[float, float],
                 gains: Optional[np.ndarray]) -> Tuple[np.ndarray, Optional[str]]:
        gp = _GP(xs, ys, length=hypers[0], noise=hypers[1])
        n_cand = max(512, 64 * len(space))
        cands = space.sample_uniform(rng, n_cand)
        # include jittered copies of the best points (local exploitation)
        best_k = xs[np.argsort(ys)[: min(5, len(ys))]]
        local = np.clip(
            np.repeat(best_k, 20, axis=0) + rng.normal(0, 0.02, (len(best_k) * 20, xs.shape[1])),
            0.0,
            1.0 - 1e-9,
        )
        cands = np.vstack([cands, local])
        mu, sigma = gp.predict(cands)
        y_best = ys.min()

        if acq != "gp_hedge":
            score = _acq_scores(acq, mu, sigma, y_best)
            return cands[int(np.argmax(score))], acq

        # every member nominates its argmax; a softmax over the gains picks one
        if gains is None:
            gains = np.zeros(len(PORTFOLIO))
        nominations = [cands[int(np.argmax(_acq_scores(a, mu, sigma, y_best)))] for a in PORTFOLIO]
        logits = gains - gains.max()
        probs = np.exp(logits) / np.exp(logits).sum()
        idx = int(rng.choice(len(PORTFOLIO), p=probs))
        return nominations[idx], PORTFOLIO[idx]
