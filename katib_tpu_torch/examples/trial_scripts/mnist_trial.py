"""The MNIST trial as a command trial: the port's counterpart of Katib's
pytorch-mnist trial image, a program that prints its metrics for the
StdOut collector.

    python katib_tpu_torch/examples/trial_scripts/mnist_trial.py --lr 0.01 --momentum 0.5 --num_epochs 1

It runs ``katib_tpu_torch.models.mnist_cnn.run_mnist_trial`` with no trial
context, so the trial takes ``cuda:0`` of the cards the process can see (the
controller names the trial's card in ``CUDA_VISIBLE_DEVICES``) and prints
``loss=`` and ``accuracy=`` lines, each float's ``repr``, once an epoch.
cuDNN is held to its deterministic algorithms, so the metrics depend only
on the assignments: the process does not inherit its parent's flags.
"""

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", "..")))

from katib_tpu_torch.models.mnist_cnn import run_mnist_trial  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lr", required=True)
    ap.add_argument("--momentum", required=True)
    ap.add_argument("--num_epochs", default="1")
    args = ap.parse_args()
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    run_mnist_trial({"lr": args.lr, "momentum": args.momentum, "num_epochs": args.num_epochs})


if __name__ == "__main__":
    main()
