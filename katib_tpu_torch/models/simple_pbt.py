"""PBT's example workload — the port's own copy of ``run_pbt_trial`` from
``katib_tpu/models/simple_pbt.py`` (Katib's simple-pbt trial image): a
triangle-wave optimal learning rate, so the score can only be maximised by
adapting lr over generations. Its state (step, score) carries from parent
to child through the PBT lineage directory, ``ctx.checkpoint_dir``.

Pure Python, no device. Not ported: ``run_pbt_trial_packed``, which scores
a whole packed generation in one program (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import json
import os
from typing import Dict

_STEPS_PER_ROUND = 20
_LR_PERIOD = 100


def _optimal_lr(step: int, period: int = _LR_PERIOD) -> float:
    """Triangle wave in [0, 0.02]."""
    phase = (step % period) / period
    tri = 2 * phase if phase < 0.5 else 2 * (1 - phase)
    return 0.02 * tri


def run_pbt_trial(assignments: Dict[str, str], ctx=None) -> None:
    """Score improves when lr tracks the moving optimum; ``training.json``
    in the checkpoint directory keeps (step, score) across generations."""
    lr = float(assignments["lr"])

    step, score = 0, 0.0
    ckpt_path = None
    if ctx is not None and ctx.checkpoint_dir:
        os.makedirs(ctx.checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(ctx.checkpoint_dir, "training.json")
        if os.path.exists(ckpt_path):
            with open(ckpt_path) as f:
                state = json.load(f)
            step, score = int(state["step"]), float(state["score"])

    for _ in range(_STEPS_PER_ROUND):
        target = _optimal_lr(step)
        score += max(0.0, 1.0 - abs(lr - target) / 0.02) * 0.01  # reward closeness to the optimal lr
        step += 1

    if ckpt_path is not None:
        # tmp + os.replace: a crash mid-write leaves the previous checkpoint
        # whole for the next generation
        tmp = ckpt_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"step": step, "score": score}, f)
        os.replace(tmp, ckpt_path)

    if ctx is not None:
        ctx.report(**{"Validation-accuracy": score})
    else:
        print(f"Validation-accuracy={score}")
