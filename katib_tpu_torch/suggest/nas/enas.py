"""ENAS suggestion algorithm — the port's own copy of
``katib_tpu/suggest/nas/enas.py``: a REINFORCE-trained LSTM controller
samples one operation per layer and, past the first layer, one skip bit per
earlier layer.

- The search space: each NAS operation's parameter grid expanded into a
  flat list of concrete operations (``expand_operations``).
- ``EnasController`` is the JAX package's parameter dict as an ``nn.Module``
  with the same names (``w_lstm``, ``g_emb``, ``w_emb``, ``w_soft``,
  ``attn_w1``, ``attn_w2``, ``attn_v``). The LSTM is ``[x, h] @ w_lstm``
  with gates in the order i, f, o, g (not ``nn.LSTMCell``'s i, f, g, o).
  ``rollout`` is ``_sample_and_score`` split in two: ``sample_arc`` makes
  the draws, ``score_arc`` is teacher-forced and returns, for a given arc,
  the log-probability, entropy, skip penalty and skip count exactly as the
  JAX function computes them for the arc it sampled.
- Draws are Gumbel-max over uniforms from a CPU ``torch.Generator`` seeded
  from the spec's ``random_state`` (0 when unset). The uniforms are drawn on
  the CPU and moved to the controller's device, so the card and the CPU
  pick the same arcs. The stream is not ``jax.random``'s: the port and the
  JAX package sample different arcs from the same seed.
- Training: ``torch.optim.Adam`` with optax's defaults, whose state carries
  over from round to round; the EMA baseline moves toward the reward with
  its entropy bonus, and the loss is ``log_prob * (reward - baseline) +
  skip_weight * skip_penalty``.
- The controller's state is pickled to ``enas_controller_torch.pkl`` in the
  experiment's directory (numpy arrays, replaced atomically). It is not the
  JAX package's pickle and cannot be exchanged with it; a state that does
  not load reseeds the controller, with a warning.
- The fused-population opt-in (``fused``, ``fused_generations`` and the
  other ``fused_*`` settings) is not ported and is refused by name.
"""

from __future__ import annotations

import io
import itertools
import json
import logging
import os
import pickle
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ...api.spec import ExperimentSpec, NasConfig, ParameterAssignment, ParameterType, TrialAssignment
from ..base import Suggester, SuggestionReply, SuggestionRequest, register

log = logging.getLogger("katib_tpu_torch.enas")

ENAS_DEFAULT_SETTINGS: Dict[str, Any] = {
    "controller_hidden_size": 64,
    "controller_temperature": 5.0,
    "controller_tanh_const": 2.25,
    "controller_entropy_weight": 1e-5,
    "controller_baseline_decay": 0.999,
    "controller_learning_rate": 5e-5,
    "controller_skip_target": 0.4,
    "controller_skip_weight": 0.8,
    "controller_train_steps": 50,
    "controller_log_every_steps": 10,
}

_SETTING_TYPES = {
    "controller_hidden_size": int,
    "controller_temperature": float,
    "controller_tanh_const": float,
    "controller_entropy_weight": float,
    "controller_baseline_decay": float,
    "controller_learning_rate": float,
    "controller_skip_target": float,
    "controller_skip_weight": float,
    "controller_train_steps": int,
    "controller_log_every_steps": int,
}
_NONE_ALLOWED = {
    "controller_temperature",
    "controller_tanh_const",
    "controller_entropy_weight",
    "controller_skip_weight",
}
# settings read outside the controller: the shared seed and the population
# size (the fused family is refused, see _refuse_fused)
_PASSTHROUGH_SETTINGS = {"random_state", "n_population"}
_SETTING_RANGES = {
    "controller_hidden_size": (1, float("inf")),
    "controller_temperature": (0, float("inf")),
    "controller_tanh_const": (0, float("inf")),
    "controller_entropy_weight": (0.0, float("inf")),
    "controller_baseline_decay": (0.0, 1.0),
    "controller_learning_rate": (0.0, 1.0),
    "controller_skip_target": (0.0, 1.0),
    "controller_skip_weight": (0.0, float("inf")),
    "controller_train_steps": (1, float("inf")),
    "controller_log_every_steps": (1, float("inf")),
}
_TRUTHY = ("1", "true", "on", "yes")
STATE_FILE = "enas_controller_torch.pkl"
STATE_FORMAT = "katib_tpu_torch.enas/1"


def parse_enas_settings(spec: ExperimentSpec) -> Dict[str, Any]:
    settings = dict(ENAS_DEFAULT_SETTINGS)
    for s in spec.algorithm.algorithm_settings:
        if s.value == "None":
            settings[s.name] = None
        elif s.name in _SETTING_TYPES:
            settings[s.name] = _SETTING_TYPES[s.name](s.value)
    return settings


def expand_operations(nas_config: NasConfig) -> List[Dict[str, Any]]:
    """Flatten the operations' parameter grids: [{'opt_id', 'opt_type',
    'opt_params'}, ...]. Categorical values stay strings, int ones are
    Python ints."""
    ops: List[Dict[str, Any]] = []
    opt_id = 0
    for op in nas_config.operations:
        avail: Dict[str, List[Any]] = {}
        for p in op.parameters:
            fs = p.feasible_space
            if p.parameter_type == ParameterType.CATEGORICAL:
                avail[p.name] = list(fs.list or [])
            elif p.parameter_type == ParameterType.INT:
                avail[p.name] = list(range(int(fs.min), int(fs.max) + 1, int(fs.step or 1)))
            elif p.parameter_type == ParameterType.DOUBLE:
                step = float(fs.step or 1.0)
                vals = list(np.arange(float(fs.min), float(fs.max) + step, step))
                if vals and vals[-1] > float(fs.max):
                    vals = vals[:-1]
                avail[p.name] = vals
        keys, values = list(avail), list(avail.values())
        for combo in itertools.product(*values):
            ops.append({"opt_id": opt_id, "opt_type": op.operation_type, "opt_params": dict(zip(keys, combo))})
            opt_id += 1
    return ops


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

class EnasController(nn.Module):
    """The LSTM controller. Parameters are drawn from Uniform(-0.01, 0.01)
    by ``generator`` (seeded 0 by default). ``temperature`` and
    ``tanh_const`` may be None (not applied)."""

    def __init__(self, num_ops: int, num_layers: int, hidden: int = 64, temperature: Optional[float] = 5.0,
                 tanh_const: Optional[float] = 2.25, skip_target: float = 0.4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        self.num_ops, self.num_layers, self.hidden = num_ops, num_layers, hidden
        self.temperature, self.tanh_const, self.skip_target = temperature, tanh_const, skip_target
        shapes = {"w_lstm": (2 * hidden, 4 * hidden), "g_emb": (1, hidden), "w_emb": (num_ops, hidden),
                  "w_soft": (hidden, num_ops), "attn_w1": (hidden, hidden), "attn_w2": (hidden, hidden),
                  "attn_v": (hidden, 1)}
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.rand(shape, generator=g) * 0.02 - 0.01))

    @property
    def num_draws(self) -> int:
        """Uniforms one rollout consumes: an op's worth per layer and two
        per skip bit."""
        return self.num_layers * self.num_ops + self.num_layers * (self.num_layers - 1)

    def draw(self, generator: torch.Generator) -> torch.Tensor:
        """One rollout's uniforms, drawn on the CPU, on the controller's
        device."""
        return torch.rand(self.num_draws, generator=generator).to(self.w_lstm.device)

    def _shape_logits(self, logits: torch.Tensor) -> torch.Tensor:
        if self.temperature is not None:
            logits = logits / self.temperature
        if self.tanh_const is not None:
            logits = self.tanh_const * torch.tanh(logits)
        return logits

    def _lstm(self, x: torch.Tensor, c: torch.Tensor, h: torch.Tensor):
        i, f, o, g = (torch.cat([x, h], dim=1) @ self.w_lstm).chunk(4, dim=1)
        c = torch.sigmoid(i) * torch.tanh(g) + torch.sigmoid(f) * c
        return c, torch.sigmoid(o) * torch.tanh(c)

    def rollout(self, draws: Optional[torch.Tensor] = None, arc: Optional[Sequence[int]] = None):
        """One pass of the controller: with ``draws`` (``draw``'s uniforms)
        it picks each choice by Gumbel-max, with ``arc`` (flat: per layer
        the op, then its skip bits) it takes the arc's. Returns (arc_flat,
        log_prob, entropy, skip_penalty, skip_count) as tensors;
        ``log_prob`` is the cross-entropy of the choices (-log pi), and the
        entropy carries no gradient."""
        if (draws is None) == (arc is None):
            raise ValueError("rollout takes draws or an arc, not both")
        dev = self.w_lstm.device
        if arc is not None:
            arc = torch.as_tensor(arc, dtype=torch.long).to(dev)
        c = h = torch.zeros(1, self.hidden, device=dev)
        inputs = self.g_emb
        skip_targets = torch.tensor([1.0 - self.skip_target, self.skip_target], device=dev)
        picks, log_probs, entropies, penalties, counts, all_h, all_h_w = [], [], [], [], [], [], []
        pos = used = 0

        def gumbel(n: int) -> torch.Tensor:
            nonlocal used
            u = draws[used:used + n].clamp_min(torch.finfo(draws.dtype).tiny)
            used += n
            return -torch.log(-torch.log(u))

        for layer in range(self.num_layers):
            c, h = self._lstm(inputs, c, h)
            logits = self._shape_logits(h @ self.w_soft)[0]
            op = (logits.detach() + gumbel(self.num_ops)).argmax() if arc is None else arc[pos]
            pos += 1
            logp = F.log_softmax(logits, dim=0)[op]
            log_probs.append(-logp)
            entropies.append((-logp * logp.exp()).detach())
            picks.append(op.view(1))
            inputs = self.w_emb.index_select(0, op.view(1))
            c, h = self._lstm(inputs, c, h)
            if layer > 0:
                query = torch.tanh(h @ self.attn_w2 + torch.cat(all_h_w)) @ self.attn_v  # [layer, 1]
                skip_logits = self._shape_logits(torch.cat([-query, query], dim=1))
                if arc is None:
                    skips = (skip_logits.detach() + gumbel(2 * layer).view(layer, 2)).argmax(1)
                else:
                    skips = arc[pos:pos + layer]
                pos += layer
                sel = F.log_softmax(skip_logits, dim=1).gather(1, skips[:, None])[:, 0]
                log_probs.append((-sel).sum())
                entropies.append((-sel * sel.exp()).sum().detach())
                skip_prob = torch.sigmoid(skip_logits)
                penalties.append((skip_prob * torch.log(skip_prob / skip_targets)).sum())
                picks.append(skips)
                skips_f = skips.to(h.dtype)[None]
                counts.append(skips_f.sum())
                inputs = (skips_f @ torch.cat(all_h)) / (1.0 + skips_f.sum())
            else:
                inputs = self.g_emb
            all_h.append(h)
            all_h_w.append(h @ self.attn_w1)
        zero = torch.zeros((), device=dev)
        return (torch.cat(picks), torch.stack(log_probs).sum(), torch.stack(entropies).sum(),
                torch.stack(penalties).mean() if penalties else zero,
                torch.stack(counts).sum() if counts else zero)

    @torch.no_grad()
    def sample_arc(self, generator: torch.Generator) -> List[int]:
        """One arc, flat, drawn from ``generator``."""
        return self.rollout(draws=self.draw(generator))[0].tolist()

    def score_arc(self, arc: Sequence[int]):
        """(log_prob, entropy, skip_penalty, skip_count) of ``arc``, with
        gradients (but none through the entropy)."""
        return self.rollout(arc=arc)[1:]


def make_controller_optimizer(controller: EnasController, lr: float) -> torch.optim.Adam:
    """Adam with optax's defaults."""
    return torch.optim.Adam(controller.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)


def train_controller(controller: EnasController, optimizer: torch.optim.Optimizer, baseline: float,
                     result: float, settings: Dict[str, Any], generator: Optional[torch.Generator] = None,
                     arcs: Optional[Sequence[Sequence[int]]] = None) -> float:
    """``controller_train_steps`` REINFORCE steps toward ``result`` (the
    mean objective, negated for minimize); each step samples an arc from
    ``generator`` (or takes the next of ``arcs``). Returns the baseline
    after them. The baseline stays on the device between steps."""
    ent_w, skip_w = settings["controller_entropy_weight"], settings["controller_skip_weight"]
    decay = float(settings["controller_baseline_decay"])
    steps = int(settings["controller_train_steps"]) if arcs is None else len(arcs)
    base = torch.tensor(float(baseline), device=controller.w_lstm.device)
    for i in range(steps):
        if arcs is None:
            _, log_prob, entropy, skip_penalty, _ = controller.rollout(draws=controller.draw(generator))
        else:
            log_prob, entropy, skip_penalty, _ = controller.score_arc(arcs[i])
        reward = result + (float(ent_w) * entropy if ent_w is not None else 0.0)
        new_base = base - (1.0 - decay) * (base - reward)
        loss = log_prob * (reward - new_base)
        if skip_w is not None:
            loss = loss + float(skip_w) * skip_penalty
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        base = new_base.detach()
    return float(base)


# ---------------------------------------------------------------------------
# the controller's state on disk
# ---------------------------------------------------------------------------

def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_torch(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return tree


class _StateUnpickler(pickle.Unpickler):
    """Loads builtins and numpy arrays only: a pickle that names any other
    class (the JAX package's, whose optimiser state is optax's) is refused
    without importing it."""

    def find_class(self, module: str, name: str):
        if module == "builtins" or module.split(".")[0] == "numpy":
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"{module}.{name} is not part of the port's ENAS state")


@register
class ENAS(Suggester):
    name = "enas"

    def __init__(self, state_dir: Optional[str] = None, device: Optional[torch.device] = None):
        self.state_dir = state_dir
        self.device = device
        self._state: Optional[Dict[str, Any]] = None

    def validate_algorithm_settings(self, experiment: ExperimentSpec) -> None:
        nas = experiment.nas_config
        if nas is None:
            raise ValueError("enas requires nasConfig")
        gc = nas.graph_config
        if not gc.num_layers or gc.num_layers < 1:
            raise ValueError("graphConfig.numLayers must be >= 1")
        if not gc.input_sizes or not gc.output_sizes:
            raise ValueError("graphConfig.inputSizes and outputSizes must be set")
        if not nas.operations:
            raise ValueError("nasConfig.operations must not be empty")
        if not expand_operations(nas):
            raise ValueError("nasConfig.operations expand to an empty search space")
        for s in experiment.algorithm.algorithm_settings:
            if s.name.startswith("fused_") or (s.name == "fused" and s.value.lower() in _TRUTHY):
                raise ValueError(f"setting {s.name}: the fused ENAS population program is not part of the port "
                                 "(the job-queue search runs instead when fused settings are left out)")
            if s.name in _PASSTHROUGH_SETTINGS or s.name == "fused":
                continue
            if s.name not in _SETTING_TYPES:
                raise ValueError(f"unknown ENAS setting {s.name!r}")
            if s.value == "None":
                if s.name not in _NONE_ALLOWED:
                    raise ValueError(f"setting {s.name} must not be None")
                continue
            try:
                v = _SETTING_TYPES[s.name](s.value)
            except ValueError:
                raise ValueError(f"setting {s.name}={s.value!r} has wrong type")
            lo, hi = _SETTING_RANGES[s.name]
            if not (lo <= v <= hi):
                raise ValueError(f"setting {s.name}={v} out of range [{lo}, {hi}]")

    # -- state ------------------------------------------------------------

    def _ckpt_path(self) -> Optional[str]:
        return os.path.join(self.state_dir, STATE_FILE) if self.state_dir else None

    def _device(self) -> torch.device:
        if self.device is None:
            from ...utils.backend import require_devices

            self.device = require_devices()[0]  # raises BackendUnavailable without CUDA
        return self.device

    def _fresh_state(self, spec: ExperimentSpec) -> Dict[str, Any]:
        settings = parse_enas_settings(spec)
        ops = expand_operations(spec.nas_config)
        num_layers = int(spec.nas_config.graph_config.num_layers)
        seed = self.seed_from(spec) or 0
        generator = torch.Generator().manual_seed(seed)
        controller = EnasController(
            len(ops), num_layers, int(settings["controller_hidden_size"]), settings["controller_temperature"],
            settings["controller_tanh_const"], float(settings["controller_skip_target"]), generator,
        ).to(self._device())
        return {"controller": controller,
                "optimizer": make_controller_optimizer(controller, float(settings["controller_learning_rate"])),
                "generator": generator, "baseline": 0.0, "step": 0, "first_run": True, "settings": settings,
                "ops": ops, "num_layers": num_layers}

    def _load_or_init(self, request: SuggestionRequest) -> Dict[str, Any]:
        if self._state is not None:
            return self._state
        spec = request.experiment
        state = self._fresh_state(spec)
        path = self._ckpt_path()
        if path and os.path.exists(path):
            try:
                with open(path, "rb") as f:
                    raw = _StateUnpickler(io.BytesIO(f.read())).load()
                if raw.get("format") != STATE_FORMAT:
                    raise ValueError(f"format {raw.get('format')!r}, not {STATE_FORMAT!r}")
                state["controller"].load_state_dict(_to_torch(raw["params"]))
                state["optimizer"].load_state_dict(_to_torch(raw["optimizer"]))
                state["generator"].set_state(torch.from_numpy(raw["generator"].copy()))
                for key in ("baseline", "step", "first_run"):
                    state[key] = raw[key]
            except Exception as e:
                # a corrupt or foreign state must not wedge the experiment:
                # the trial history is in the store, so reseed the controller
                log.warning("unreadable ENAS controller state at %s (%s: %s); reseeding controller",
                            path, type(e).__name__, e)
                state = self._fresh_state(spec)
        self._state = state
        return state

    def _save(self) -> None:
        path = self._ckpt_path()
        if not path or self._state is None:
            return
        state = self._state
        raw = {"format": STATE_FORMAT, "params": _to_numpy(state["controller"].state_dict()),
               "optimizer": _to_numpy(state["optimizer"].state_dict()),
               "generator": state["generator"].get_state().numpy(),
               **{key: state[key] for key in ("baseline", "step", "first_run", "settings", "ops", "num_layers")}}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"  # a crash mid-dump leaves the previous state whole
        with open(tmp, "wb") as f:
            pickle.dump(raw, f)
        os.replace(tmp, path)

    # -- suggestions -------------------------------------------------------

    def _evaluation_result(self, request: SuggestionRequest) -> Optional[float]:
        """The mean objective over completed trials."""
        vals = [t.objective for t in self.history(request) if t.objective is not None]
        return float(sum(vals) / len(vals)) if vals else None

    def get_suggestions(self, request: SuggestionRequest) -> SuggestionReply:
        state = self._load_or_init(request)
        spec = request.experiment
        num_layers = state["num_layers"]
        controller, generator = state["controller"], state["generator"]
        if not state["first_run"]:
            result = self._evaluation_result(request)
            if result is not None:  # when every trial so far failed, no update
                if spec.objective.type.value == "minimize":
                    result = -result
                state["baseline"] = train_controller(controller, state["optimizer"], state["baseline"], result,
                                                     state["settings"], generator)
                state["step"] += int(state["settings"]["controller_train_steps"])
        candidates = [controller.sample_arc(generator) for _ in range(max(request.current_request_number, 0))]
        state["first_run"] = False
        self._save()

        gc = spec.nas_config.graph_config
        assignments = []
        for arc in candidates:
            organized, record = [], 0
            for layer in range(num_layers):
                organized.append([int(v) for v in arc[record:record + layer + 1]])
                record += layer + 1
            nn_config: Dict[str, Any] = {"num_layers": num_layers, "input_sizes": gc.input_sizes,
                                         "output_sizes": gc.output_sizes, "embedding": {}}
            for layer in range(num_layers):
                opt = organized[layer][0]
                nn_config["embedding"][opt] = state["ops"][opt]
            assignments.append(TrialAssignment(
                name=self.make_trial_name(spec),
                parameter_assignments=[
                    ParameterAssignment("architecture", json.dumps(organized).replace('"', "'")),
                    ParameterAssignment("nn_config", json.dumps(nn_config).replace('"', "'")),
                ],
            ))
        return SuggestionReply(assignments=assignments)
