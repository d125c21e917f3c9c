"""The DARTS search step's second-order term, two ways, on one CUDA device:
the time of each and how far they differ.

    python -m katib_tpu_torch.tools.darts_hvp [--layers 5] [--channels 8]
        [--nodes 3] [--batch 128] [--repeats 3]

The term is d/dalpha <dw L_train(w, alpha), v> for a direction v in weight
space, on a supernet of examples/nas/darts.json's 8 operations (by default
at darts.json's shape), f32 with cuDNN's TF32 off:

- ``reverse over forward`` (``models.darts_trainer.mixed_hessian_vector``,
  what the search step runs): the training loss's derivative along v by
  forward-mode AD, then its alpha gradient;
- ``double backward`` (``double_backward`` here): the weight gradient with
  ``create_graph``, then the alpha gradient of its product with v. torch's
  double backward of a grouped (depthwise) convolution runs one convolution
  per channel.

Each is timed with CUDA events (the median of ``--repeats`` after one
untimed call), with the device's name and power limit, and held against
the same product in float64 (both ways, which must agree to 1e-8): the
term sums many products of opposite signs, so f32 leaves relative errors
far above f32's rounding unit in it.
"""

from __future__ import annotations

import argparse
import statistics
import subprocess
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

PRIMITIVES = ("separable_convolution_3x3", "separable_convolution_5x5", "dilated_convolution_3x3",
              "dilated_convolution_5x5", "avg_pooling_3x3", "max_pooling_3x3", "skip_connection", "none")


def double_backward(model, direction: Sequence[torch.Tensor],
                    batch: Tuple[torch.Tensor, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """d/dalpha <dw L(w, alpha), direction> by torch's double backward."""
    grads = torch.autograd.grad(F.cross_entropy(model(batch[0]), batch[1]), model.weights(), create_graph=True)
    return torch.autograd.grad(grads, model.alphas(), grad_outputs=list(direction))


def _median_ms(fn, repeats: int) -> float:
    fn()
    times = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main(argv=None) -> int:
    from ..models.darts_supernet import DartsSupernet
    from ..models.darts_trainer import mixed_hessian_vector
    from ..utils.backend import require_devices
    from ..utils.precision import f32_convolutions

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=5)
    ap.add_argument("--channels", type=int, default=8)
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    device = require_devices()[0]
    g = torch.Generator().manual_seed(0)
    model = DartsSupernet(PRIMITIVES, init_channels=args.channels, num_layers=args.layers, num_nodes=args.nodes,
                          generator=g).to(device)
    batch = (torch.randn(args.batch, 3, 32, 32, generator=g).to(device),
             torch.randint(0, 10, (args.batch,), generator=g).to(device))
    direction = [torch.randn(w.shape, generator=g).to(device) for w in model.weights()]
    try:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        card = ""
    card = card or torch.cuda.get_device_name(device)
    methods = {"reverse over forward": mixed_hessian_vector, "double backward": double_backward}

    def products(dtype):
        m = model.to(dtype)
        b, d = (batch[0].to(dtype), batch[1]), [v.to(dtype) for v in direction]
        return {name: torch.cat([h.ravel() for h in fn(m, d, b)]).double() for name, fn in methods.items()}

    with f32_convolutions.hold():
        exact = products(torch.float64)
        f32 = products(torch.float32)
        ms = {name: _median_ms(lambda: fn(model, direction, batch), args.repeats) for name, fn in methods.items()}
    reference = exact["double backward"]

    def rel(x):
        return float((x - reference).norm() / reference.norm())

    shape = f"{args.layers} layers, {args.channels} channels, {args.nodes} nodes, batch {args.batch}"
    for name, t in ms.items():
        print(f"darts_hvp [{card}]: {shape}: {name} {t:.1f} ms (f32, CUDA events, median of {args.repeats}); "
              f"relative error against float64 {rel(f32[name]):.2e}")
    f64_gap = rel(exact["reverse over forward"])
    print(f"darts_hvp [{card}]: the two products in float64 differ by {f64_gap:.2e} (relative)")
    return 0 if f64_gap < 1e-8 else 1


if __name__ == "__main__":
    raise SystemExit(main())
