#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (katib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, all of them on every run, each fatal on failure:

1. build   — compile the flash-attention kernels from katib_tpu_torch/ops/csrc
             (one nvcc per source, in parallel), print the build seconds and
             each kernel's registers and spills, and fail if ptxas
             serialised the wgmma of any *_sm90.cu kernel;
2. kernels — hold K1 (fwd), K2 (dq) and K3 (dkv) against their plain PyTorch
             versions on the card: at the LM's shape (B=4, T=2048, H=16,
             D=64, bf16, causal) with q, k, v as slices of one [B, T, 3, H,
             D] tensor as the model passes them, at ragged T (against both
             the 64- and the 128-row tiles), non-causal, at softmax scales 0
             and -0.2, in f32 and at head dims 32 and 128, at head dims 16
             and 96 (zero-padded to 32 and 128 by the wrapper) in both
             dtypes, causal and not, and the bf16 mma design of all three
             (forced_route) at the LM's shape, element by element (see
             TOL); a small f32 model on the card against the same model on
             the CPU; and three bf16 AdamW steps of a small LM on the card
             against the same steps on the CPU (BF16_STEP_TOL);
3. e2e     — run katib_tpu_torch/examples/lm-h100.json (3 TPE trials of the
             full-width transformer LM, 10 AdamW steps each, the suggester
             seeded from --seed, default 0) through the port's controller on
             cuda:0, with the launch and route counters set to 0 just before
             and read just after: every trial must succeed with a loss that
             falls between its two reports, and every (bf16) K1, K2 and K3
             launch must have taken the sm90 (wgmma/TMA) route; then train
             the same LM 10 steps on the sm90 route and on the mma kernels
             and hold the two loss curves together (ROUTE_TOL);
4. times   — each kernel, its plain version, the mma.sync design of K1,
             K2 and K3 that f32 still takes (the "mma" route, called
             directly) and
             scaled_dot_product_attention (a yardstick the port never calls)
             at the LM's shape with CUDA events, each the median of 5
             repeats; the train step's ms and tokens/s; a profiler breakdown
             of two train steps;
5. mnist   — with torch's default TF32 flags (cuDNN may use TF32) for its
             duration: five SGD steps of the MNIST trial's step on the card
             against the same steps on the CPU, f32, from the same weights
             and batches (MNIST_TOL; the step holds its convolutions in
             f32 itself), and a control with that hold undone, which must
             miss MNIST_TOL; the step's ms at batch 64; then
             examples/random.json and examples/hyperband.json, unchanged,
             through the port's CLI on the card (full width, 60 000
             images): every trial must succeed with finite loss and
             accuracy, and Hyperband must run its brackets to the trial
             budget.

Last, it checks that nothing of JAX or of the JAX package was imported.
The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device, or without
the katib_tpu_torch package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

MAIN = dict(b=4, t=2048, h=16, d=64)  # the LM's attention shape (lm-h100.json)
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # H100 SXM dense, 700 W
PEAK_BYTES = 3.35e12
# Tolerances, element by element: |got - ref| <= ATOL * rms(ref) + RTOL * |ref|,
# keyed by the dtype of the output, with rms(ref) the root mean square of the
# reference tensor.
# bf16 outputs (O, dQ, dK, dV): kernel and plain version both round their
#   result to bf16, so they may differ by one unit in the last place, at most
#   2^-7 |ref| (RTOL). The kernels also round P and dS to bf16 before their
#   second product, as the TPU kernels do, where the plain versions keep f32:
#   about 2^-9 of each term, a few hundredths of rms(ref) (ATOL). The scale is
#   the RMS, not the largest value: in causal attention the largest values sit
#   in the first rows (row 0 of O is v_0), several times the typical value, and
#   a share of them would let through a whole 64-key tile missing from the
#   late rows, which errs by more than 1 rms(ref).
#   tests/test_torch_flash_attention.py holds this check to both cases.
# f32 outputs (the lse, and every output of the f32 instances): full f32 on
#   both sides, summed in different orders.
TOL = {"bfloat16": (0.1, 2.0 ** -7), "float32": (1e-3, 1e-5)}  # (ATOL, RTOL)
REPLACES = {  # the source of the route the main path takes (bf16, D 64)
    "fwd": ("katib_tpu_torch/ops/csrc/flash_fwd_sm90.cu", "katib_tpu/ops/flash_attention.py:74"),
    "dq": ("katib_tpu_torch/ops/csrc/flash_bwd_dq_sm90.cu", "katib_tpu/ops/flash_attention.py:199"),
    "dkv": ("katib_tpu_torch/ops/csrc/flash_bwd_dkv_sm90.cu", "katib_tpu/ops/flash_attention.py:232"),
}
REPEATS = 5  # timings are the median of this many cuda_ms runs
ROUTE_TOL = 0.05  # nats: loss difference of the two routes over 10 steps at lr 1e-3, seed 0 (see route_agreement)
# nats: bf16 LM losses on the card against the CPU over 3 AdamW steps, the
# bf16 tolerance of the CPU tests against the JAX step
# (tests/test_torch_train.py::test_bf16_adamw_steps_match_jax).
BF16_STEP_TOL = 3e-2
# MNIST trial step, f32, card against CPU: losses and parameters after five
# SGD steps, absolute; the CPU tests' gradient and parameter tolerance
# against optax. The phase also runs a control, the same steps with the
# step's f32 hold undone (cuDNN free to convolve in TF32), and fails unless
# the control misses this tolerance: the check must catch a lost hold.
MNIST_TOL = 1e-4
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "katib_tpu")  # never imported by the port
OUT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "smoke_out")  # git-ignored


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build(torch) -> None:
    from katib_tpu_torch.ops import _build

    t0 = time.perf_counter()
    libs = _build.build()
    serialised = []
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {len(libs)} libraries")
    for src, path in libs.items():
        secs = _build.BUILD_SECONDS.get(src)
        log(f"build: {src} -> {os.path.basename(path)} "
            f"({'cached' if secs is None else f'{secs:.1f}s nvcc'})")
        report = path.with_name(path.name + ".log")
        text = report.read_text() if report.exists() else ""
        for line in ptxas_summary(text):
            log(f"  ptxas: {line}")
        for line in serialised_wgmma(text):
            log(f"  ptxas WARNING: {line}")
            if src.endswith("_sm90.cu"):
                serialised.append(f"{src}: {line}")
    check(not serialised, "ptxas serialised the wgmma of an sm90 kernel:\n" + "\n".join(serialised))


def serialised_wgmma(text: str):
    """ptxas's "Potential Performance Loss" lines (C75xx: wgmma serialised,
    the kernel lost its overlap of products and arithmetic)."""
    return [line.split(":", 1)[-1].strip() for line in text.splitlines() if "Performance Loss" in line]


def ptxas_summary(text: str):
    """One line per kernel instance: registers and spills from -Xptxas -v."""
    import re

    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '_Z\w*?\d+(flash_\w+?_kernel)I(13__nv_bfloat16|f)?Li(\d+)E", line)
        if m:  # the sm90 kernels are templated on D alone: bf16
            name, spill = f"{m.group(1)}<{'f32' if m.group(2) == 'f' else 'bf16'}, D={m.group(3)}>", ""
        elif "spill" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            yield f"{name}: {line.split(':', 1)[-1].strip()}; {spill}"
            name = None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(torch, b, t, h, d, dtype, seed=0, fused=False):
    """q, k, v, do. ``fused``: q, k, v are the strided slices [:, :, i] of
    one [B, T, 3, H, D] tensor, as the model's fused projection gives them."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    if fused:
        qkv = torch.randn((b, t, 3, h, d), generator=g, device="cuda", dtype=torch.float32).to(dtype)
        do = torch.randn((b, t, h, d), generator=g, device="cuda", dtype=torch.float32).to(dtype)
        return [qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2], do]
    return [torch.randn((b, t, h, d), generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(4)]


def _compare(torch, got, ref):
    """(max |got - ref|, the ATOL this pair needs, its limit) under TOL. An
    all-zero reference needs ATOL 0 if got is exact and inf otherwise."""
    check(bool(torch.isfinite(got).all()), "kernel output has non-finite values")
    atol, rtol = TOL[str(ref.dtype).replace("torch.", "")]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    excess, rms = float((err - rtol * ref.abs()).max()), float(ref.pow(2).mean().sqrt())
    need = excess / rms if rms > 0 else (0.0 if excess <= 0 else math.inf)
    return float(err.max()), need, atol


def compare_case(torch, b, t, h, d, dtype, causal, fused=False, scale=None):
    """K1, K2 and K3 against their plain versions on one set of inputs, output
    by output; logs every comparison, then raises if any exceeds TOL. Returns
    each kernel's max abs error. ``scale`` defaults to 1/sqrt(d)."""
    from katib_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(torch, b, t, h, d, dtype, fused=fused)
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    o_ref, lse_ref = fa.fwd_plain(q, k, v, causal, scale)
    delta = fa.attention_delta(o_ref, do)
    o, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq = fa.flash_bwd_dq(q, k, v, do, lse_ref, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, lse_ref, delta, causal, scale)
    dk_ref, dv_ref = fa.bwd_dkv_plain(q, k, v, do, lse_ref, delta, causal, scale)
    pairs = {"fwd": {"o": (o, o_ref), "lse": (lse, lse_ref)},
             "dq": {"dq": (dq, fa.bwd_dq_plain(q, k, v, do, lse_ref, delta, causal, scale))},
             "dkv": {"dk": (dk, dk_ref), "dv": (dv, dv_ref)}}
    torch.cuda.synchronize()
    routes = "/".join(fa.route(name, dtype, d) for name in pairs)
    label = (f"B={b} T={t} H={h} D={d} {str(dtype).replace('torch.', '')} causal={causal}"
             f"{' qkv-slices' if fused else ''} scale={scale:.4g} routes={routes}")
    errs, failed = {}, []
    for name, outputs in pairs.items():
        for out, (got, ref) in outputs.items():
            err, need, atol = _compare(torch, got, ref)
            errs[name] = max(errs.get(name, 0.0), err)
            log(f"kernels: {name:3s} {out:3s} {label}: max_abs_err={err:.3e}, needs ATOL {need:.4f} "
                f"(limit {atol:g}) {'ok' if need <= atol else 'FAIL'}")
            if not need <= atol:
                failed.append(f"{name}/{out}")
    check(not failed, f"{', '.join(failed)} disagree with the plain versions at {label}")
    return errs


def phase_kernels(torch, record) -> None:
    from katib_tpu_torch.ops import flash_attention as fa

    main = compare_case(torch, **MAIN, dtype=torch.bfloat16, causal=True, fused=True)  # as the model calls it
    for name, err in main.items():
        record[name]["max_abs_err"] = err
    compare_case(torch, **MAIN, dtype=torch.bfloat16, causal=True)  # contiguous operands
    compare_case(torch, 2, 2000, 4, 64, torch.bfloat16, True, fused=True)  # ragged against 128-row tiles
    compare_case(torch, 2, 100, 4, 64, torch.bfloat16, True)      # shorter than one 128-row tile
    compare_case(torch, 2, 1000, 4, 64, torch.bfloat16, True)     # ragged T
    compare_case(torch, 2, 300, 4, 64, torch.bfloat16, True, scale=-0.2)  # any softmax scale
    compare_case(torch, 2, 300, 4, 64, torch.bfloat16, True, scale=0.0)
    compare_case(torch, 2, 2048, 4, 64, torch.bfloat16, False)    # non-causal
    compare_case(torch, 1, 77, 3, 64, torch.bfloat16, False)      # one ragged tile
    compare_case(torch, 2, 200, 4, 64, torch.float32, True)       # f32, full FMA
    compare_case(torch, 1, 130, 2, 32, torch.float32, False)
    compare_case(torch, 2, 300, 4, 32, torch.bfloat16, True)      # other head dims
    compare_case(torch, 2, 1000, 4, 32, torch.bfloat16, False)
    compare_case(torch, 2, 300, 4, 128, torch.bfloat16, True)
    compare_case(torch, 1, 2048, 8, 128, torch.bfloat16, True)
    compare_case(torch, 1, 100, 2, 128, torch.float32, True)
    for d in (16, 96):  # zero-padded to 32 and 128 at the wrapper
        for dtype in (torch.bfloat16, torch.float32):
            compare_case(torch, 2, 300, 4, d, dtype, True)
            compare_case(torch, 1, 130, 3, d, dtype, False)
    with fa.forced_route("mma"):  # the bf16 mma design: f32's kernels, and the yardstick of route_agreement
        compare_case(torch, **MAIN, dtype=torch.bfloat16, causal=True, fused=True)
    model_check(torch)
    bf16_step_check(torch)


def model_check(torch) -> None:
    """A small f32 LM on the card (kernels) against the same weights on the
    CPU (plain versions): logits and every gradient."""
    from katib_tpu_torch.models.transformer import TransformerConfig, TransformerLM
    from katib_tpu_torch.parallel.train import lm_loss

    cfg = TransformerConfig(vocab_size=512, embed_dim=128, num_layers=2, num_heads=2,
                            max_seq_len=200, dtype=torch.float32)
    model_cpu = TransformerLM(cfg, generator=torch.Generator().manual_seed(0))
    model_gpu = TransformerLM(cfg, generator=torch.Generator().manual_seed(0)).to("cuda")
    tokens = torch.randint(0, 512, (2, 201), generator=torch.Generator().manual_seed(1))
    results = []
    for model, dev in ((model_cpu, "cpu"), (model_gpu, "cuda")):
        tok = tokens.to(dev)
        logits = model(tok[:, :-1])
        lm_loss(logits, tok[:, 1:]).backward()
        results.append((logits.detach().cpu(), {n: p.grad.cpu() for n, p in model.named_parameters()}))
    torch.cuda.synchronize()
    err = float((results[0][0] - results[1][0]).abs().max())
    gerr = max(float((results[0][1][n] - results[1][1][n]).abs().max()) for n in results[0][1])
    log(f"kernels: model f32 cuda vs cpu: logits max_abs_err={err:.3e}, grads max_abs_err={gerr:.3e} (tol 1e-4)")
    check(err <= 1e-4 and gerr <= 1e-4, "the model on the card disagrees with the model on the CPU")


def bf16_step_check(torch, steps=3) -> None:
    """Three AdamW steps of a small bf16 LM (the main path's dtype) on the
    card against the same steps on the CPU, from the same seeded weights and
    batch: the kernels against the plain versions, through the train step."""
    import numpy as np

    from katib_tpu_torch.models.transformer import TransformerConfig
    from katib_tpu_torch.parallel.train import make_lm_train_step

    cfg = TransformerConfig(vocab_size=512, embed_dim=128, num_layers=2, num_heads=2, max_seq_len=200,
                            dtype=torch.bfloat16)
    data = np.random.default_rng(1).integers(0, 512, size=(2, 201), dtype=np.int32)
    curves = {}
    for dev in ("cpu", "cuda"):
        _, _, step_fn, put_batch = make_lm_train_step(cfg, torch.device(dev), 1e-3)
        batch = put_batch(data[:, :-1], data[:, 1:])
        curves[dev] = [float(step_fn(*batch)) for _ in range(steps)]
    err = max(abs(a - b) for a, b in zip(curves["cpu"], curves["cuda"]))
    log(f"kernels: LM bf16, {steps} AdamW steps, cuda {[round(x, 5) for x in curves['cuda']]} vs cpu "
        f"{[round(x, 5) for x in curves['cpu']]}: max loss difference {err:.3e} (tol {BF16_STEP_TOL})")
    check(err <= BF16_STEP_TOL, "the bf16 train step on the card disagrees with the CPU")


# ---------------------------------------------------------------------------
# phase 3: the port's main path
# ---------------------------------------------------------------------------

def lm_spec(seed=None):
    """The main path's spec and its one-value (fixed) assignments; with a
    seed, the suggester draws from it (the spec's ``random_state``)."""
    from katib_tpu_torch.api.spec import AlgorithmSetting, ExperimentSpec

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "katib_tpu_torch", "examples", "lm-h100.json")
    with open(path) as f:
        spec = ExperimentSpec.from_json(f.read())
    if seed is not None:
        spec.algorithm.algorithm_settings.append(AlgorithmSetting("random_state", str(seed)))
    return spec, {p.name: p.feasible_space.list[0] for p in spec.parameters if p.feasible_space.list}


def phase_e2e(torch, record, seed) -> None:
    from katib_tpu_torch.api.status import TrialCondition
    from katib_tpu_torch.controller.experiment import ExperimentController
    from katib_tpu_torch.ops import flash_attention as fa

    spec, fixed = lm_spec(seed)
    trials = spec.max_trial_count
    per_kernel = int(fixed["num_layers"]) * int(fixed["num_steps"]) * trials

    import tempfile

    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="katib-smoke-", dir=OUT_DIR)
    ctrl = ExperimentController(root_dir=root)
    try:
        ctrl.create_experiment(spec)
        for counts in (fa.LAUNCHES, fa.ROUTES):
            for key in counts:
                counts[key] = 0
        t0 = time.perf_counter()
        exp = ctrl.run(spec.name, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, routes = dict(fa.LAUNCHES), dict(fa.ROUTES)
        log(f"e2e: {spec.name} (suggester seed {seed}): {exp.status.condition.value} ({exp.status.reason.value}) in {wall:.1f}s; "
            f"trials succeeded {exp.status.trials_succeeded}/{exp.status.trials}")
        losses = {}
        for trial in ctrl.list_trials(spec.name):
            rows = ctrl.obs_store.get_observation_log(trial.name, "loss")
            losses[trial.name] = [float(r.value) for r in rows]
            log(f"e2e: trial {trial.name} lr={trial.assignments_dict()['learning_rate']} "
                f"{trial.condition.value} losses={losses[trial.name]}"
                + (f"\n{trial.message}" if trial.condition != TrialCondition.SUCCEEDED else ""))
            check(trial.condition == TrialCondition.SUCCEEDED, f"trial {trial.name} did not succeed")
            vals = losses[trial.name]
            check(len(vals) >= 2 and all(math.isfinite(x) for x in vals), f"trial {trial.name}: bad losses {vals}")
            check(vals[-1] < vals[0], f"trial {trial.name}: last loss {vals[-1]} not below first {vals[0]}")
        check(exp.status.trials_succeeded == trials, "not every trial succeeded")
        best = exp.status.current_optimal_trial
        check(bool(best.best_trial_name), "no optimal trial")
        log(f"e2e: optimal trial {best.best_trial_name} "
            f"{[(a.name, a.value) for a in best.parameter_assignments if a.name == 'learning_rate']} "
            f"loss={best.observation.metric('loss').min}")
        log(f"e2e: launches {launches}, expected {per_kernel} each "
            f"(num_layers x num_steps x trials = {fixed['num_layers']} x {fixed['num_steps']} x {trials})")
        log(f"e2e: routes {routes}")
        for name in fa.LAUNCHES:
            record[name]["launches"] = launches[name]
            check(launches[name] == per_kernel, f"kernel {name} launched {launches[name]} times, expected {per_kernel}")
        for name in fa.SM90_KERNELS:  # bf16 at D 64: every launch on the wgmma/TMA route
            check(routes[f"{name}.sm90"] == per_kernel,
                  f"kernel {name}: {routes[f'{name}.sm90']} of {per_kernel} launches took the sm90 route")
    finally:
        ctrl.close()
    route_agreement(torch, fixed)


def route_agreement(torch, fixed, lr=1e-3, steps=10) -> None:
    """The LM's losses over its first `steps` steps on the main path's route
    and with K1, K2 and K3 forced onto the mma kernels, from the experiment's
    weights and batch (seed 0). The routes round P and dS to bf16 in the
    same places and sum in different orders. Ten AdamW steps amplify such
    rounding differences, the more so the higher the learning rate
    (katib_tpu_torch.tools.route_divergence measures it): at lr 1e-3 on
    these weights one bf16 unit in one weight moves either route's curve by
    about 0.015 and the routes differ by about 0.006, while at lr 4e-3 to
    1e-2 rounding-size changes move a route by tenths of a nat to 2 nats.
    So the check is made here, where it is tight: ROUTE_TOL is about 3x
    the one-unit gap and a tenth of one step's change."""
    import numpy as np

    from katib_tpu_torch.models.transformer import TransformerConfig
    from katib_tpu_torch.ops import flash_attention as fa
    from katib_tpu_torch.parallel.train import make_lm_train_step

    vocab, seq, batch = int(fixed["vocab_size"]), int(fixed["seq_len"]), int(fixed["batch_size"])
    cfg = TransformerConfig(vocab_size=vocab, embed_dim=int(fixed["embed_dim"]),
                            num_layers=int(fixed["num_layers"]), num_heads=int(fixed["num_heads"]),
                            max_seq_len=seq)
    data = np.random.default_rng(0).integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    curves = {}
    for design in ("sm90", "mma"):
        with fa.forced_route(design):
            model, _, step_fn, put_batch = make_lm_train_step(cfg, torch.device("cuda:0"), lr)
            tokens, targets, positions = put_batch(data[:, :-1], data[:, 1:])
            curves[design] = [float(step_fn(tokens, targets, positions)) for _ in range(steps)]
        del model, step_fn
        torch.cuda.empty_cache()
    diff = max(abs(a - b) for a, b in zip(curves["sm90"], curves["mma"]))
    log(f"e2e: LM at lr {lr:g}, {steps} steps, sm90 route {[round(x, 4) for x in curves['sm90']]}; "
        f"K1-K3 on the mma kernels {[round(x, 4) for x in curves['mma']]}; "
        f"largest difference {diff:.4f} (limit {ROUTE_TOL})")
    check(diff <= ROUTE_TOL, f"the sm90 and mma routes train apart: {diff:.4f} > {ROUTE_TOL}")
    check(curves["sm90"][-1] < curves["sm90"][0], f"the LM did not learn at lr {lr:g}: {curves['sm90']}")


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

def median_ms(torch, fn, **kw) -> float:
    """The median of REPEATS cuda_ms runs."""
    import statistics

    return statistics.median(cuda_ms(torch, fn, **kw) for _ in range(REPEATS))


def cuda_ms(torch, fn, iters=20, warmup=3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(b, t, h, d, dtype_name, causal, products, reads, writes, rows):
    """Least time for the work: `products` [T x T x D] products over the
    causal triangle (or the full square) at the tensor-core peak, against
    the bytes of each [B,T,H,D] input read once and each output written once
    plus `rows` f32 [B,H,T] row vectors (lse, delta)."""
    pairs = t * (t + 1) // 2 if causal else t * t
    flops = 2.0 * products * b * h * d * pairs
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = (reads + writes) * b * t * h * d * elem + rows * b * h * t * 4
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype_name], nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes"), flops


def phase_times(torch, record) -> None:
    import torch.nn.functional as F

    from katib_tpu_torch.ops import flash_attention as fa

    b, t, h, d = MAIN["b"], MAIN["t"], MAIN["h"], MAIN["d"]
    q, k, v, do = _inputs(torch, b, t, h, d, torch.bfloat16, fused=True)  # the model's operands
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.flash_fwd(q, k, v, True, scale)
    delta = fa.attention_delta(o, do)
    plan = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, True, scale),
                lambda: fa.fwd_plain(q, k, v, True, scale), 2, 3, 1, 1),
        "dq": (lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, True, scale),
               lambda: fa.bwd_dq_plain(q, k, v, do, lse, delta, True, scale), 3, 4, 1, 2),
        "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, True, scale),
                lambda: fa.bwd_dkv_plain(q, k, v, do, lse, delta, True, scale), 4, 4, 2, 2),
    }
    mma_design = {  # the mma route's bf16 kernels, timed beside the route the main path takes
        "fwd": lambda: fa._fwd_cuda("mma", q, k, v, True, scale),
        "dq": lambda: fa._dq_cuda("mma", q, k, v, do, lse, delta, True, scale),
        "dkv": lambda: fa._dkv_cuda("mma", q, k, v, do, lse, delta, True, scale),
    }
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = median_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    for name, (kernel, plain, products, reads, writes, rows) in plan.items():
        ms = median_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
        bound_ms, bound_by, flops = bound(b, t, h, d, "bfloat16", True, products, reads, writes, rows)
        record[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=sdpa_fwd if name == "fwd" else None)
        old = ""
        if name in mma_design:
            mma_ms = median_ms(torch, mma_design[name])
            old = f", mma route {mma_ms:.4f} ms = {100 * bound_ms / mma_ms:.1f}% of bound"
        log(f"times: {name} ({fa.route(name, q.dtype, d)} route): {ms:.4f} ms (plain {plain_ms:.3f} ms, "
            f"bound {bound_ms:.4f} ms by {bound_by}, {flops / ms / 1e9:.1f} TFLOP/s = "
            f"{100 * bound_ms / ms:.1f}% of bound{old})"
            + (f"; scaled_dot_product_attention fwd {sdpa_fwd:.4f} ms" if name == "fwd" else ""))

    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_step():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    qf, kf, vf = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def flash_step():
        out = fa.flash_attention(qf, kf, vf, causal=True)
        torch.autograd.grad(out, (qf, kf, vf), do)

    flash_both, sdpa_both = median_ms(torch, flash_step), median_ms(torch, sdpa_step)
    log(f"times: fwd+bwd at B={b} T={t} H={h} D={d} bf16 causal: flash kernels "
        f"{flash_both:.4f} ms, scaled_dot_product_attention {sdpa_both:.4f} ms "
        f"(yardstick; the port never calls it)")
    log(f"times: backward alone (fwd+bwd - fwd): flash kernels {flash_both - record['fwd']['ms']:.4f} ms "
        f"(dq {record['dq']['ms']:.4f} + dkv {record['dkv']['ms']:.4f} ms, and the delta reduction), "
        f"scaled_dot_product_attention {sdpa_both - sdpa_fwd:.4f} ms: the yardstick for K2 + K3")
    train_step_times(torch, lm_spec()[1])


def train_step_times(torch, fixed) -> None:
    import numpy as np

    from katib_tpu_torch.models.transformer import TransformerConfig
    from katib_tpu_torch.parallel.train import make_lm_train_step

    vocab, seq, batch = int(fixed["vocab_size"]), int(fixed["seq_len"]), int(fixed["batch_size"])
    cfg = TransformerConfig(vocab_size=vocab, embed_dim=int(fixed["embed_dim"]),
                            num_layers=int(fixed["num_layers"]), num_heads=int(fixed["num_heads"]),
                            max_seq_len=seq)
    model, _, step_fn, put_batch = make_lm_train_step(cfg, torch.device("cuda:0"), 1e-4)
    data = np.random.default_rng(0).integers(0, vocab, size=(batch, seq + 1), dtype=np.int32)
    tokens, targets, positions = put_batch(data[:, :-1], data[:, 1:])
    for _ in range(3):
        step_fn(tokens, targets, positions)
    torch.cuda.synchronize()
    n = 10
    t0 = time.perf_counter()
    for _ in range(n):
        step_fn(tokens, targets, positions)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n
    params = sum(p.numel() for p in model.parameters())
    log(f"times: train step ({params / 1e6:.1f}M params, batch {batch} x seq {seq}, bf16): "
        f"{step_s * 1e3:.2f} ms/step, {batch * seq / step_s:.0f} tokens/s; "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            step_fn(tokens, targets, positions)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="device_time_total", row_limit=15)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "train_step_profile.txt"), "w") as f:
        f.write(table)
    log("times: profiler, 2 train steps, top device time:\n" + table)


# ---------------------------------------------------------------------------
# phase 5: the MNIST trial and the repo's examples
# ---------------------------------------------------------------------------

def phase_mnist(torch) -> None:
    """Runs with torch's default TF32 flags (cuDNN convolutions may use
    TF32) and puts back the flags main() set."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True  # torch's defaults
    try:
        mnist_step_check(torch)
        for name in ("random", "hyperband"):
            run_example(torch, name)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def mnist_step_check(torch, steps=5, batch=64) -> None:
    """The MNIST trial's step on the card against the CPU (same weights, same
    batches, f32), then its time on the card."""
    import numpy as np

    from katib_tpu_torch.models import mnist_cnn
    from katib_tpu_torch.utils.datasets import batch_indices, load_mnist

    x, y = load_mnist("train", n=batch * steps)
    idx = torch.from_numpy(batch_indices(len(x), batch, np.random.default_rng(0)))
    os.makedirs(OUT_DIR, exist_ok=True)

    def run(dev):
        model = mnist_cnn.MnistCNN().to(dev)
        step = mnist_cnn.make_mnist_train_step(model, 0.05, 0.9)
        xd, yd = torch.tensor(x, device=dev), torch.tensor(y, dtype=torch.long, device=dev)
        losses = [float(step(xd[sel], yd[sel])) for sel in idx.to(dev)]
        return losses, {n: p.detach().cpu() for n, p in model.named_parameters()}

    def errors(a, b):
        return (max(abs(u - v) for u, v in zip(a[0], b[0])),
                max(float((a[1][n] - b[1][n]).abs().max()) for n in a[1]))

    cpu = run("cpu")
    loss_err, param_err = errors(cpu, run("cuda"))
    log(f"mnist: trial step f32 cuda vs cpu, {steps} SGD steps at batch {batch} (cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32} outside the step): losses max_abs_err={loss_err:.3e}, "
        f"params max_abs_err={param_err:.3e} (tol {MNIST_TOL})")
    check(loss_err <= MNIST_TOL and param_err <= MNIST_TOL, "the MNIST step on the card disagrees with the CPU")
    check(torch.backends.cudnn.allow_tf32, "the MNIST step did not put cuDNN's TF32 flag back")

    class Unheld:  # the control: the step's hold undone, TF32 left as torch's default allows
        @staticmethod
        def hold():
            return contextlib.nullcontext()

    held, mnist_cnn.f32_convolutions = mnist_cnn.f32_convolutions, Unheld()
    try:
        control = errors(cpu, run("cuda"))
    finally:
        mnist_cnn.f32_convolutions = held
    log(f"mnist: control, the same steps with the hold undone (cuDNN in TF32): losses max_abs_err="
        f"{control[0]:.3e}, params max_abs_err={control[1]:.3e} (must exceed tol {MNIST_TOL})")
    check(max(control) > MNIST_TOL, "MNIST_TOL does not catch TF32 convolutions: the check is too loose")

    model = mnist_cnn.MnistCNN().to("cuda")
    step = mnist_cnn.make_mnist_train_step(model, 0.01, 0.5)
    xd, yd = torch.tensor(x, device="cuda"), torch.tensor(y, dtype=torch.long, device="cuda")
    sel = idx[0].to("cuda")
    ms = median_ms(torch, lambda: step(xd[sel], yd[sel]), iters=200, warmup=20)
    log(f"mnist: trial step (convs 20/50, hidden 500, batch {batch}, f32, SGD momentum): {ms:.4f} ms/step "
        f"(median of {REPEATS} runs of 200 steps, CUDA events); 60 000 images = {60000 // batch} steps/epoch")
    from torch.profiler import ProfilerActivity, profile

    n = 50
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step(xd[sel], yd[sel])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    from torch.autograd import DeviceType

    # the device's own events (kernels, copies), not a user range over them
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3 / n
    launches = len(on_device) / n
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    with open(os.path.join(OUT_DIR, "mnist_step_profile.txt"), "w") as f:
        f.write(table)
    log(f"mnist: profiler, {n} trial steps: wall {wall_ms:.4f} ms/step (profiled), device busy "
        f"{device_ms:.4f} ms/step ({100 * device_ms / wall_ms:.1f}% busy, {100 - 100 * device_ms / wall_ms:.1f}% "
        f"idle), {launches:.1f} device ops/step; top device time:\n{table}")


def run_example(torch, name) -> None:
    """examples/<name>.json, unchanged, through the port's CLI on the card."""
    from katib_tpu_torch import cli

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.json")
    with open(path) as f:
        doc = json.load(f)
    import tempfile

    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"mnist-{name}-", dir=OUT_DIR)
    t0 = time.perf_counter()
    rc = cli.main(["run", path, "--root", root, "--timeout", "900"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(root, doc["name"], "experiment.json")) as f:
        record = json.load(f)
    status, trials = record["experiment"]["status"], record["trials"]
    walls = sorted(t["completionTime"] - t["startTime"] for t in trials)
    log(f"mnist: examples/{name}.json through the port's CLI: rc {rc}, {status['condition']} "
        f"({status['reason']}), {status['trialsSucceeded']}/{len(trials)} trials succeeded, "
        f"experiment wall {wall:.1f}s; trial wall min {walls[0]:.2f}s, median {walls[len(walls) // 2]:.2f}s, "
        f"max {walls[-1]:.2f}s")
    check(rc == 0 and status["condition"] == "Succeeded", f"examples/{name}.json did not succeed")
    check(len(trials) == doc["maxTrialCount"], f"examples/{name}.json ran {len(trials)} trials")
    for t in trials:
        a = {p["name"]: p["value"] for p in t["parameterAssignments"]}
        rows = record["logs"][t["name"]]
        values = {m: [float(v) for _, metric, v in rows if metric == m] for m in ("loss", "accuracy")}
        epochs = int(a.get("num_epochs", "1"))
        log(f"mnist:   {t['name']} {t['condition']} lr={float(a['lr']):.4f} momentum={float(a['momentum']):.3f} "
            f"epochs={epochs} wall={t['completionTime'] - t['startTime']:.2f}s "
            f"loss={[round(v, 4) for v in values['loss']]} accuracy={[round(v, 4) for v in values['accuracy']]}")
        check(t["condition"] == "Succeeded", f"trial {t['name']} did not succeed:\n{t.get('message', '')}")
        for metric, vals in values.items():
            check(len(vals) == epochs and all(math.isfinite(v) for v in vals),
                  f"trial {t['name']}: {metric} {vals} is not one finite value per epoch")
    if name == "hyperband":
        check_hyperband_rungs(record)


def check_hyperband_rungs(record) -> None:
    """r_l 9, eta 3, 18 trials: 9 of 1 epoch, the best 3 of them for 3, the
    best of those for 9, then 5 new ones of 3 (the trial budget cuts the
    second bracket). "Best" is Hyperband's ranking: the lowest loss a trial
    reported (a trial with none ranks first, as the suggester ranks it)."""
    trials = record["trials"]
    params = [{p["name"]: p["value"] for p in t["parameterAssignments"]} for t in trials]
    budgets = [p["num_epochs"] for p in params]
    log(f"mnist: hyperband budgets (num_epochs) in order: {budgets}")
    check(budgets[:13] == ["1"] * 9 + ["3"] * 3 + ["9"] and set(budgets[13:]) == {"3"},
          f"hyperband's brackets are off: {budgets}")

    def best(indices, k):
        def loss(i):
            values = [float(v) for _, m, v in record["logs"][trials[i]["name"]] if m == "loss"]
            values = [v for v in values if not math.isnan(v)]
            return min(values) if values else -math.inf
        return sorted(sorted(indices, key=loss)[:k])

    def config(i):
        return params[i]["lr"], params[i]["momentum"]

    promoted = sorted(config(i) for i in range(9, 12))
    check(promoted == sorted(config(i) for i in best(range(9), 3)),
          f"hyperband promoted {promoted}, not the best three of its first rung")
    check(config(12) == config(best(range(9, 12), 1)[0]),
          f"hyperband's 9-epoch trial {config(12)} is not the best of its 3-epoch rung")
    log("mnist: hyperband promoted the best 3 of 9 to 3 epochs and the best of those to 9")


# ---------------------------------------------------------------------------

def device_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi gave nothing (rc {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0, help="the e2e experiment's suggester seed")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    try:
        import katib_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the katib_tpu_torch package is not beside this script ({e})", file=sys.stderr)
        return 2
    from katib_tpu_torch.utils.backend import device_name

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 references in full f32
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}; "
        f"device {device_name(0)} x{torch.cuda.device_count()}")

    record = {name: {"name": name, "route": "cuda", "source": src, "replaces": rep, "launches": None,
                     "max_abs_err": None, "ms": None, "plain_ms": None, "bound_ms": None,
                     "bound_by": None, "library_ms": None}
              for name, (src, rep) in REPLACES.items()}
    phases = {"build": lambda: phase_build(torch), "kernels": lambda: phase_kernels(torch, record),
              "e2e": lambda: phase_e2e(torch, record, args.seed), "times": lambda: phase_times(torch, record),
              "mnist": lambda: phase_mnist(torch)}
    try:
        for phase, run in phases.items():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            log(f"phase {phase}: done in {time.perf_counter() - t0:.1f}s")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)
        log(f"imports: modules of JAX or of the JAX package loaded: {leaked or 'none'}")
        check(not leaked, f"the port imported {leaked}")
    except Exception as e:
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": list(record.values())}), flush=True)
    print(device_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
