"""Command line of the port: run an experiment spec, show an experiment's status.

    python -m katib_tpu_torch.cli run katib_tpu_torch/examples/lm-h100.json --root runs
    python -m katib_tpu_torch.cli status lm-h100 --root runs

``run`` uses the CUDA devices of the machine (``--device cpu`` for the CPU)
and exits 0 when the experiment succeeded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional


def _print_status(doc: Dict[str, Any]) -> None:
    exp, trials = doc["experiment"], doc["trials"]
    st = exp["status"]
    print(f"experiment {exp['spec']['name']}: {st['condition']} ({st['reason'] or 'running'}) "
          f"succeeded {st['trialsSucceeded']}/{st['trials']}")
    for t in trials:
        params = ", ".join(f"{a['name']}={a['value']}" for a in t["parameterAssignments"])
        metrics = (t.get("observation") or {}).get("metrics", [])
        shown = ", ".join(f"{m['name']}={m['latest']}" for m in metrics)
        print(f"  {t['name']}  {t['condition']:<18} {shown}  [{params}]")
    best = st["currentOptimalTrial"]
    if best["bestTrialName"]:
        print(f"optimal trial: {best['bestTrialName']} "
              f"{[(a['name'], a['value']) for a in best['parameterAssignments']]}")


def cmd_run(args) -> int:
    import torch

    from .api.spec import ExperimentSpec
    from .controller.experiment import ExperimentController, ValidationError

    with open(args.spec) as f:
        try:
            spec = ExperimentSpec.from_json(f.read())
        except (ValueError, KeyError, TypeError) as e:
            print(f"invalid experiment spec: {type(e).__name__}: {e}", file=sys.stderr)
            return 2
    devices = [torch.device("cpu")] if args.device == "cpu" else None
    ctrl = ExperimentController(root_dir=args.root, devices=devices)
    try:
        try:
            ctrl.create_experiment(spec)
        except ValidationError as e:
            print(f"invalid experiment spec: {e}", file=sys.stderr)
            return 2
        print(f"experiment {spec.name} created; running...", flush=True)
        exp = ctrl.run(spec.name, timeout=args.timeout)
    finally:
        ctrl.close()
    _print_status({
        "experiment": exp.to_dict(),
        "trials": [t.to_dict() for t in ctrl.list_trials(spec.name)],
    })
    return 0 if exp.status.is_succeeded else 1


def cmd_status(args) -> int:
    path = os.path.join(args.root, args.name, "experiment.json")
    if not os.path.exists(path):
        print(f"experiment {args.name!r} not found under {args.root}", file=sys.stderr)
        return 1
    with open(path) as f:
        doc = json.load(f)
    if args.format == "json":
        print(json.dumps(doc["experiment"], indent=1))
    else:
        _print_status(doc)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="katib_tpu_torch", description="PyTorch/CUDA port of katib_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)
    run = sub.add_parser("run", help="run an experiment spec to completion")
    run.add_argument("spec")
    run.add_argument("--root", default="katib-runs", help="directory for experiment records")
    run.add_argument("--timeout", type=float, default=None)
    run.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    run.set_defaults(fn=cmd_run)
    st = sub.add_parser("status", help="status of an experiment run under --root")
    st.add_argument("name")
    st.add_argument("--root", default="katib-runs")
    st.add_argument("--format", choices=("text", "json"), default="text")
    st.set_defaults(fn=cmd_status)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
