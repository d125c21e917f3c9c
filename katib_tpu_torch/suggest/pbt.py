"""Population Based Training — the port's own copy of
``katib_tpu/suggest/pbt.py``: Katib's PBT job queue.

- The population is seeded from the search space (step-quantized value
  lists).
- Trials carry ``pbt.katib-tpu/generation`` and ``pbt.katib-tpu/parent``
  labels. The suggester names its trials ``<experiment>-<uid>`` itself, so
  each trial's checkpoint directory exists before the trial starts.
- When a generation's pool of scored trials outgrows the population, it is
  cut at the truncation quantiles: the bottom trials are replaced by
  *exploit* jobs (a top trial's params, trained on from the bottom trial's
  checkpoint), the rest become *explore* jobs (each param ×0.8 or ×1.2, or
  resampled with ``resample_probability``).
- Failed and Killed trials are queued again with the same params and
  parent.
- The checkpoint lineage lives in ``checkpoint_root/<trial>``, copied from
  the parent with ``shutil.copytree``; the controller hands that directory
  to the trial as ``ctx.checkpoint_dir``.

PBT keeps state between calls, so the controller keeps one suggester per
experiment. After every call the queue (jobs, sample pools and the random
generator's state) is written to ``<checkpoint_root>/_state_torch.json``,
atomically, and a fresh instance on the same root continues from it when
the trials the snapshot handed out are the experiment's trials. A file it
cannot read, or one a stale run left, reseeds the population with a
warning.

Not ported: the break at a generation boundary for packed trials
(``packSize``), since the port does not pack trials (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import shutil
import tempfile
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..api.spec import ParameterAssignment, TrialAssignment
from ..api.status import Trial, TrialCondition
from ..db.store import objective_value
from .base import Suggester, SuggestionReply, SuggestionRequest, register
from .internal.search_space import MIN_GOAL, HyperParameter

GENERATION_LABEL = "pbt.katib-tpu/generation"
PARENT_LABEL = "pbt.katib-tpu/parent"
STATE_FILE = "_state_torch.json"
STATE_FORMAT = "katib_tpu_torch.pbt/1"

log = logging.getLogger("katib_tpu_torch.pbt")


class _Sampler:
    """Sample and perturb one parameter."""

    def __init__(self, hp: HyperParameter, rng: np.random.Generator):
        self.hp = hp
        self.rng = rng
        if hp.is_numeric:
            step = hp.step if hp.step else (hp.max - hp.min) / 100.0 or 1.0
            n = int(np.floor((hp.max - hp.min) / step + 1e-9)) + 1
            self.values = [hp.min + i * step for i in range(max(n, 1))]
        else:
            self.values = list(hp.choices)

    def _fmt(self, v) -> str:
        if not self.hp.is_numeric:
            return str(v)
        if self.hp.type.value == "int":
            return str(int(round(float(v))))
        return repr(float(v))

    def sample(self) -> str:
        return self._fmt(self.values[self.rng.integers(0, len(self.values))])

    def perturb(self, value: str) -> str:
        if self.hp.is_numeric:
            factor = float(self.rng.choice([0.8, 1.2]))
            v = float(value) * factor
            v = max(self.hp.min, min(self.hp.max, v))
            return self._fmt(v)
        try:
            idx = self.values.index(value) + int(self.rng.choice([-1, 1]))
        except ValueError:
            idx = 0
        return str(self.values[idx % len(self.values)])


@dataclass
class _PbtJob:
    uid: str
    params: Dict[str, str]
    generation: int
    parent: Optional[str] = None
    metric_value: Optional[float] = None


@register
class PBT(Suggester):
    name = "pbt"

    def __init__(self, checkpoint_root: Optional[str] = None):
        self.checkpoint_root = checkpoint_root
        self._initialized = False
        self.pending: List[_PbtJob] = []
        self.running: Dict[str, _PbtJob] = {}
        self.completed: Dict[str, _PbtJob] = {}
        self.sample_pool: Dict[str, List[str]] = {"previous": [], "current": []}

    def validate_algorithm_settings(self, experiment) -> None:
        """The numeric settings are required; suggestion_trial_dir is
        optional, as the controller supplies the root."""
        s = self.settings(experiment)
        missing = [k for k in ("n_population", "truncation_threshold") if k not in s]
        if missing:
            raise ValueError(f"Required params missing: {', '.join(missing)}")
        if int(s["n_population"]) < 5:
            raise ValueError("Param(n_population) should be >= 5")
        if not 0 <= float(s["truncation_threshold"]) <= 1:
            raise ValueError("Param(truncation_threshold) should be between 0 and 1, inclusive")
        if "resample_probability" in s and not 0 <= float(s["resample_probability"]) <= 1:
            raise ValueError("Param(resample_probability) should be between 0 and 1")

    # ------------------------------------------------------------------

    def _init(self, request: SuggestionRequest) -> None:
        if self._initialized:
            return
        s = self.settings(request.experiment)
        self.population_size = int(s["n_population"])
        self.truncation_threshold = float(s["truncation_threshold"])
        self.resample_probability = (
            float(s["resample_probability"]) if "resample_probability" in s else None
        )
        self.rng = np.random.default_rng(self.seed_from(request.experiment))
        space = self.search_space(request.experiment)
        self.metric_scale = -1.0 if space.goal == MIN_GOAL else 1.0
        self.samplers = [_Sampler(p, self.rng) for p in space.params]
        self.experiment_name = request.experiment.name
        if self.checkpoint_root is None:
            self.checkpoint_root = s.get(
                "suggestion_trial_dir",
                os.path.join(tempfile.gettempdir(), "katib-tpu-pbt", self.experiment_name),
            )
        os.makedirs(self.checkpoint_root, exist_ok=True)
        self._initialized = True
        if self._load_state({t.name for t in request.trials}):
            return  # resumed: queues and rng restored, no reseed
        self._seed_from_base(self.population_size)

    # -- queue snapshot ---------------------------------------------------------

    def _state_path(self) -> str:
        assert self.checkpoint_root is not None
        return os.path.join(self.checkpoint_root, STATE_FILE)

    def _save_state(self) -> None:
        if not self._initialized or self.checkpoint_root is None:
            return
        payload = {
            "format": STATE_FORMAT,
            "pending": [dataclasses.asdict(j) for j in self.pending],
            "running": [dataclasses.asdict(j) for j in self.running.values()],
            "completed": [dataclasses.asdict(j) for j in self.completed.values()],
            "sample_pool": self.sample_pool,
            "rng": self.rng.bit_generator.state,
        }
        tmp = self._state_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, self._state_path())

    def _load_state(self, trial_names) -> bool:
        """Restore the queue from the snapshot, if it is this experiment's:
        the trials it handed out are exactly ``trial_names``."""
        if self.checkpoint_root is None or not os.path.exists(self._state_path()):
            return False
        try:
            with open(self._state_path()) as f:
                payload = json.load(f)
            if payload.get("format") != STATE_FORMAT:
                raise ValueError(f"format {payload.get('format')!r}, not {STATE_FORMAT!r}")
            pending = [_PbtJob(**j) for j in payload["pending"]]
            running = {j.uid: j for j in (_PbtJob(**j) for j in payload["running"])}
            completed = {j.uid: j for j in (_PbtJob(**j) for j in payload["completed"])}
            sample_pool = {k: list(payload["sample_pool"][k]) for k in ("previous", "current")}
            rng = np.random.default_rng()
            rng.bit_generator.state = payload["rng"]
            handed_out = set(running) | set(completed)
            if handed_out != set(trial_names):
                raise ValueError(f"it handed out {len(handed_out)} trials, {len(handed_out - set(trial_names))} "
                                 f"of them not among the experiment's {len(trial_names)}: a stale run's")
        except Exception as e:
            # a corrupt, truncated, foreign or stale snapshot must not wedge
            # the experiment: reseed the population, loudly
            log.warning("unusable PBT queue state at %s (%s: %s); reseeding population",
                        self._state_path(), type(e).__name__, e)
            return False
        self.pending, self.running, self.completed, self.sample_pool = pending, running, completed, sample_pool
        self.rng = rng
        for s in self.samplers:
            # the samplers were built on the fresh seed's rng: rebind them
            # so they continue the restored stream
            s.rng = self.rng
        return True

    def _seed_from_base(self, count: int) -> None:
        for _ in range(count):
            self._append({s.hp.name: s.sample() for s in self.samplers}, generation=0)

    def _append(self, params: Dict[str, str], generation: int, parent: Optional[str] = None) -> str:
        job = _PbtJob(
            uid=f"{self.experiment_name}-{uuid.uuid4().hex[:8]}",
            params=dict(params),
            generation=generation,
            parent=parent,
        )
        self.pending.append(job)
        trial_dir = os.path.join(self.checkpoint_root, job.uid)
        if os.path.isdir(trial_dir):
            shutil.rmtree(trial_dir)
        parent_dir = None if parent is None else os.path.join(self.checkpoint_root, parent)
        if parent_dir is not None and os.path.isdir(parent_dir):
            shutil.copytree(parent_dir, trial_dir)  # the child trains on from its parent's checkpoint
        else:
            os.makedirs(trial_dir, exist_ok=True)
        return job.uid

    def _update(self, trial: Trial) -> None:
        """Fold a trial's result into the queue."""
        if trial.condition in (TrialCondition.CREATED, TrialCondition.PENDING, TrialCondition.RUNNING):
            return
        if trial.name in self.completed or trial.name not in self.running:
            return
        job = self.running.pop(trial.name)
        v = objective_value(trial.observation, self._objective)
        job.metric_value = self.metric_scale * v if v is not None else None
        self.completed[job.uid] = job

        if trial.condition in (TrialCondition.KILLED, TrialCondition.FAILED):
            # run it again with the same params and parent
            self._append(job.params, generation=job.generation, parent=job.parent)
            return
        if job.metric_value is not None:
            self.sample_pool["current"].append(job.uid)

    def _segment(self, pool: str, count: int):
        """Cut a pool at the truncation quantiles: (exploit, explore, upper)."""
        jobs = [self.completed[uid] for uid in self.sample_pool[pool]]
        values = np.array([j.metric_value for j in jobs])
        lo, hi = np.quantile(values, (self.truncation_threshold, 1 - self.truncation_threshold))
        exploit, explore, upper = [], [], []
        for j in jobs:
            if j.metric_value < lo:
                exploit.append(j.uid)
            else:
                explore.append(j.uid)
                if j.metric_value >= hi:
                    upper.append(j.uid)
        self.rng.shuffle(exploit)
        self.rng.shuffle(explore)
        exploit = exploit[: int(count * self.truncation_threshold)]
        explore = explore[: count - len(exploit)]
        return exploit, explore, upper

    def _generate(self, min_count: int) -> None:
        """Queue the next generation's jobs."""
        if len(self.sample_pool["current"]) <= self.population_size:
            if len(self.sample_pool["previous"]) == 0:
                self._seed_from_base(min_count)
                return
            exploit, explore, upper = self._segment("previous", min_count)
        else:
            exploit, explore, upper = self._segment("current", self.population_size)
            self.sample_pool["previous"] = self.sample_pool["current"]
            self.sample_pool["current"] = []

        if not upper:
            upper = explore or exploit
        replacements = self.rng.choice(upper, len(exploit)) if exploit else []
        for uid, repl in zip(exploit, replacements):
            job = self.completed[uid]
            self._append(self.completed[repl].params, generation=job.generation + 1, parent=job.uid)
        for uid in explore:
            job = self.completed[uid]
            params = {}
            for s in self.samplers:
                if self.resample_probability is None:
                    params[s.hp.name] = s.perturb(job.params[s.hp.name])
                elif self.rng.random() < self.resample_probability:
                    params[s.hp.name] = s.sample()
                else:
                    params[s.hp.name] = job.params[s.hp.name]
            self._append(params, generation=job.generation + 1, parent=job.uid)

    # ------------------------------------------------------------------

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        self._objective = request.experiment.objective
        self._init(request)
        for t in request.trials:
            self._update(t)
        n = request.current_request_number
        if len(self.pending) < n:
            self._generate(n)
        assignments: List[TrialAssignment] = []
        for _ in range(n):
            if not self.pending:
                break
            job = self.pending.pop(0)
            self.running[job.uid] = job
            labels = {GENERATION_LABEL: str(job.generation)}
            if job.parent is not None:
                labels[PARENT_LABEL] = job.parent
            assignments.append(TrialAssignment(
                name=job.uid,  # the suggester names PBT's trials
                parameter_assignments=[ParameterAssignment(k, v) for k, v in job.params.items()],
                labels=labels,
            ))
        self._save_state()
        return SuggestionReply(assignments=assignments)

    def checkpoint_dir(self, trial_name: str) -> Optional[str]:
        assert self.checkpoint_root is not None
        return os.path.join(self.checkpoint_root, trial_name)
