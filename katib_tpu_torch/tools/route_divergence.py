"""How far two training runs of the LM drift apart in ten AdamW steps, by
learning rate: the two attention designs against each other, and each design
against itself after a change of one rounding unit in the weights.

    python -m katib_tpu_torch.tools.route_divergence [--seeds 0 1 2 3]
        [--lrs 1e-3 2e-3 ...] [--steps 10] [--out FILE]

Trains the full-width LM of ``examples/lm-h100.json`` on one CUDA device,
from the weights and the batch that each seed draws (seed 0 is what every
trial of that experiment trains on), six ways:

- ``sm90``: K1, K2 and K3 on the wgmma/TMA kernels, the main path's design;
- ``mma``: K1, K2 and K3 on the mma.sync kernels (``forced_route("mma")``);
- ``sm90+one``, ``mma+one``: the same, with one element of the token
  embedding (the first token's first column) one bf16 unit higher;
- ``sm90+all``, ``mma+all``: the same, with every weight scaled by
  1 +- 2^-8 (about one bf16 unit, the sign drawn from the seed), a change
  of every weight about as large as the rounding differences that the two
  designs leave in every attention output.

For each seed and learning rate it prints the largest loss difference over
the steps between the two designs and between each design and its own
perturbed runs, the signed difference of the last losses (sm90 - mma), and
for each run whether it passes the experiment's per-trial gate: the loss
reported at step 10 below the one reported at step 5. Where a rounding-size
change of the weights moves one design as far as the other design does, the
gap between the designs is the training's own sensitivity to rounding, not
a fault of a kernel; a fault shows as design gaps above the perturbation
gaps at most seeds, or as a last-loss difference of one sign at every seed.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import time
from typing import Dict, List

RUNS = ("sm90", "mma", "sm90+one", "mma+one", "sm90+all", "mma+all")
REPORT_STEPS = (5, 10)  # run_lm_trial reports the loss after every 5 steps


def _gap(a: List[float], b: List[float]) -> float:
    return max(abs(x - y) for x, y in zip(a, b))


def _passes_gate(curve: List[float]) -> bool:
    first, last = (curve[s - 1] for s in REPORT_STEPS)
    return last < first


def _fixed_assignments() -> Dict[str, int]:
    from ..api.spec import ExperimentSpec

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "lm-h100.json")
    with open(path) as f:
        spec = ExperimentSpec.from_json(f.read())
    return {p.name: int(p.feasible_space.list[0]) for p in spec.parameters if p.feasible_space.list}


def _one_ulp_up(torch, weight, row: int) -> None:
    """weight[row, 0] becomes the next bf16 value above its bf16 rounding."""
    v = float(weight[row, 0].to(torch.bfloat16).float())
    weight[row, 0] = v + 2.0 ** (math.floor(math.log2(abs(v))) - 7)


def _scale_all(torch, model, seed: int) -> None:
    """Every weight times 1 + s * 2^-8, s = +-1 drawn from ``seed``."""
    g = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    for p in model.parameters():
        sign = torch.randint(0, 2, p.shape, generator=g, device=p.device, dtype=p.dtype) * 2 - 1
        p.mul_(1 + sign * 2.0 ** -8)


def run_seed(torch, fixed: Dict[str, int], seed: int, lrs: List[float], steps: int, device="cuda:0") -> List[dict]:
    import numpy as np

    from ..models.transformer import TransformerConfig
    from ..ops import flash_attention as fa
    from ..parallel.train import make_lm_train_step

    vocab, seq, batch = fixed["vocab_size"], fixed["seq_len"], fixed["batch_size"]
    cfg = TransformerConfig(vocab_size=vocab, embed_dim=fixed["embed_dim"], num_layers=fixed["num_layers"],
                            num_heads=fixed["num_heads"], max_seq_len=seq)
    model, optimizer, step_fn, put_batch = make_lm_train_step(cfg, torch.device(device), lrs[0], seed=seed)
    initial = {name: t.detach().clone() for name, t in model.state_dict().items()}
    data = np.random.default_rng(seed).integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    tokens, targets, positions = put_batch(data[:, :-1], data[:, 1:])

    def curve(run: str, lr: float) -> List[float]:
        with torch.no_grad():
            for name, t in model.state_dict().items():
                t.copy_(initial[name])
            if run.endswith("+one"):
                _one_ulp_up(torch, model.embed, int(data[0, 0]))
            elif run.endswith("+all"):
                _scale_all(torch, model, seed)
        optimizer.state.clear()  # fresh AdamW moments and step count
        for group in optimizer.param_groups:
            group["lr"] = lr
        with fa.forced_route(run.split("+")[0]):
            return [float(step_fn(tokens, targets, positions)) for _ in range(steps)]

    rows = []
    for lr in lrs:
        curves = {run: curve(run, lr) for run in RUNS}
        rows.append({
            "seed": seed, "lr": lr, "curves": curves,
            "routes": _gap(curves["sm90"], curves["mma"]),
            **{f"{design}{change}": _gap(curves[design], curves[design + change])
               for design in ("sm90", "mma") for change in ("+one", "+all")},
            "last_sm90_minus_mma": curves["sm90"][-1] - curves["mma"][-1],
            "gate": {run: _passes_gate(c) for run, c in curves.items()},
        })
    del model, optimizer, step_fn, initial
    torch.cuda.empty_cache()
    return rows


def row_line(row: dict) -> str:
    gate = " ".join(f"{run}={'pass' if ok else 'FAIL'}" for run, ok in row["gate"].items())
    gaps = ", ".join(f"{run} {row[run]:.4f}" for run in RUNS[2:])
    return (f"seed {row['seed']} lr {row['lr']:g}: largest loss gap, sm90 vs mma {row['routes']:.4f}; "
            f"each design vs itself perturbed: {gaps}; last loss sm90 - mma {row['last_sm90_minus_mma']:+.4f}; "
            f"step-10 loss below step-5: {gate}")


def summary(rows: List[dict], lrs: List[float]) -> List[str]:
    """One line per learning rate over the seeds, and one over every cell."""
    lines = []
    for lr in lrs:
        at = [r for r in rows if r["lr"] == lr]
        fails = {run: sum(not r["gate"][run] for r in at) for run in RUNS}
        medians = ", ".join(f"{run} {statistics.median(r[run] for r in at):.4f}" for run in RUNS[2:])
        lines.append(f"lr {lr:g} over {len(at)} seeds: median gap sm90 vs mma "
                     f"{statistics.median(r['routes'] for r in at):.4f}; vs itself perturbed: {medians}; "
                     f"last loss sm90 - mma {[round(r['last_sm90_minus_mma'], 4) for r in at]}; "
                     f"per-trial gate failures {fails}")
    above_max = sum(r["routes"] > max(r[run] for run in RUNS[2:]) for r in rows)
    above_min = sum(r["routes"] > min(r[run] for run in RUNS[2:]) for r in rows)
    signs = [r["last_sm90_minus_mma"] for r in rows]
    fails = {run: sum(not r["gate"][run] for r in rows) for run in RUNS}
    lines.append(f"all {len(rows)} cells: design gap above all four perturbation gaps in {above_max}, "
                 f"above the smallest in {above_min}; last loss sm90 - mma > 0 in {sum(x > 0 for x in signs)}, "
                 f"median {statistics.median(signs):+.4f}; per-trial gate failures {fails}")
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 2e-3, 3e-3, 3.96e-3, 5e-3, 7e-3, 1e-2])
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--out", default=None, help="also write every curve here, as JSON")
    args = ap.parse_args(argv)
    if args.steps < max(REPORT_STEPS):
        ap.error(f"--steps must reach the last report, step {max(REPORT_STEPS)}")

    import torch

    from ..ops import _build
    from ..utils.backend import require_devices

    require_devices()
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=30).stdout.strip()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.build()
    fixed = _fixed_assignments()
    t0 = time.perf_counter()
    rows = []
    for seed in args.seeds:
        for row in run_seed(torch, fixed, seed, args.lrs, args.steps):
            print(row_line(row), flush=True)
            rows.append(row)
    for line in summary(rows, args.lrs):
        print(line, flush=True)
    print(f"{len(rows) * len(RUNS)} runs of {args.steps} steps in {time.perf_counter() - t0:.1f}s", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "steps": args.steps, "rows": rows}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
