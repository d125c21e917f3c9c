"""LM training step and the HPO trial entry point — the single-device subset
of ``katib_tpu/parallel/train.py``.

``run_lm_trial`` takes the same assignments, trains on the same synthetic
batch (``np.random.default_rng(0)``) and reports ``loss`` on the same cadence
(every 5 steps, plus a final report when ``num_steps`` is not a multiple of
5). Tensor and sequence parallelism come with the multi-GPU slice; a head
dim above 128 is refused before anything is built.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.transformer import TransformerConfig, TransformerLM
from ..ops.flash_attention import HEAD_DIMS


def lm_loss(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy over every position (optax's
    ``softmax_cross_entropy_with_integer_labels(...).mean()``)."""
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]).float(), targets.reshape(-1).long())


def make_lm_train_step(
    config: TransformerConfig,
    device: Optional[torch.device] = None,
    learning_rate: float = 1e-3,
    seed: int = 0,
) -> Tuple[TransformerLM, torch.optim.Optimizer, Callable, Callable]:
    """Returns ``(model, optimizer, step_fn, put_batch)``.

    ``step_fn(tokens, targets, positions)`` runs one AdamW step and returns
    the loss of the parameters before it, as a 0-d tensor on the device.
    AdamW is ``optax.adamw(learning_rate, weight_decay=0.01)``: betas (0.9,
    0.999), eps 1e-8, decoupled decay on every parameter. ``device`` defaults
    to the first CUDA device (``utils.backend.require_devices``).
    """
    if device is None:
        from ..utils.backend import require_devices

        device = require_devices()[0]
    device = torch.device(device)
    model = TransformerLM(config, generator=torch.Generator().manual_seed(seed)).to(device)
    optimizer = torch.optim.AdamW(
        model.parameters(), lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01
    )

    def step_fn(tokens: torch.Tensor, targets: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        optimizer.zero_grad(set_to_none=True)
        loss = lm_loss(model(tokens, positions), targets)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def put_batch(tokens, targets, positions=None):
        tokens = torch.as_tensor(np.asarray(tokens), dtype=torch.long, device=device)
        targets = torch.as_tensor(np.asarray(targets), dtype=torch.long, device=device)
        if positions is None:
            b, t = tokens.shape
            positions = torch.arange(t, device=device).expand(b, t)
        else:
            positions = torch.as_tensor(np.asarray(positions), dtype=torch.long, device=device)
        return tokens, targets, positions

    return model, optimizer, step_fn, put_batch


def run_lm_trial(assignments: Dict[str, str], ctx=None) -> None:
    """HPO trial over the LM: trains ``num_steps`` AdamW steps on the trial's
    first allocated device and reports ``loss``."""
    lr = float(assignments.get("learning_rate", "1e-3"))
    embed_dim = int(assignments.get("embed_dim", "128"))
    num_layers = int(assignments.get("num_layers", "2"))
    num_heads = int(assignments.get("num_heads", "4"))
    tp = int(assignments.get("tensor_parallel", "1"))
    sp = int(assignments.get("sequence_parallel", "1"))
    steps = int(assignments.get("num_steps", "20"))
    batch = int(assignments.get("batch_size", "8"))
    seq_len = int(assignments.get("seq_len", "128"))
    vocab = int(assignments.get("vocab_size", "512"))
    if tp > 1 or sp > 1:
        raise NotImplementedError(
            f"tensor_parallel={tp}, sequence_parallel={sp}: tensor and sequence "
            "parallelism come with the multi-GPU slice of the port"
        )
    if embed_dim // num_heads > HEAD_DIMS[-1]:
        raise ValueError(
            f"head dim {embed_dim // num_heads} (embed_dim {embed_dim} / num_heads {num_heads}): "
            f"the flash-attention kernels take head dims up to {HEAD_DIMS[-1]}"
        )

    devices = ctx.torch_devices() if ctx is not None else []
    config = TransformerConfig(
        vocab_size=vocab,
        embed_dim=embed_dim,
        num_layers=num_layers,
        num_heads=num_heads,
        max_seq_len=seq_len,
    )
    _, _, step_fn, put_batch = make_lm_train_step(config, devices[0] if devices else None, lr)

    rng = np.random.default_rng(0)
    data = rng.integers(0, vocab, size=(batch, seq_len + 1), dtype=np.int32)
    # the synthetic batch is constant across steps: stage it once
    tokens, targets, positions = put_batch(data[:, :-1], data[:, 1:])
    loss = None
    for i in range(steps):
        loss = step_fn(tokens, targets, positions)
        if ctx is not None and (i + 1) % 5 == 0:
            ctx.report(loss=float(loss))
    if loss is None:
        return
    if ctx is not None:
        if steps % 5 != 0:  # final value not yet reported by the loop
            ctx.report(loss=float(loss))
    else:
        print(f"loss={float(loss)}")
