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
             examples/random.json, cut in a copy to RANDOM_MAX_TRIALS
             trials (the cut is printed), and examples/hyperband.json,
             unchanged, through the port's CLI on the card (full width,
             60 000 images): every trial must succeed with finite loss and
             accuracy, and Hyperband must run its brackets to the trial
             budget, or to the objective's goal, at which every trial still
             pending must be Killed unstarted, as Katib ends a run (the
             suggester is unseeded, so a 9-epoch trial may reach the goal
             while the next bracket waits for the card). The CLI runs of phases 5-7 hold cuDNN to its
             deterministic algorithms (deterministic_cudnn), so a trial's
             metrics are a function of its assignments: the MNIST step run
             twice on the card under that hold must agree bit for bit;
6. suggest — with torch's default TF32 flags too: examples/cma-es.json
             and reuse-duplicate-results.json, unchanged, and
             cma-es-ipop.json and multivariate-tpe.json, cut in copies to
             CMAES_IPOP_MAX_TRIALS and MULTIVARIATE_TPE_MAX_TRIALS trials
             (the cuts are printed), through the port's CLI on the card: every trial must succeed with finite metrics; the
             CMA-ES trials must carry generation labels, each generation but
             the last at least popsize trials, inside the feasible space; at
             least one reuse trial must have taken a Succeeded twin's result
             (reason DuplicateResultReused), with its source's metric log and
             in under 0.1 s;
7. search  — with torch's default TF32 flags too: examples/sobol.json,
             cut in a copy to SOBOL_MAX_TRIALS trials (the cut is
             printed), bayesian-optimization.json and simple-pbt.json,
             unchanged, through the port's CLI on the card: every trial must succeed
             with finite metrics inside the feasible space; the Sobol
             trials must carry, in order and as strings, the decode of
             scipy's qmc.Sobol(2, scramble=True, seed=0) stream; a BO trial
             asked for once n_initial_points trials had ended must carry a
             bo-acq label of the portfolio (ei, pi, lcb), and one asked for
             before none; PBT must reach generation 2, every parent label
             must name a trial of the experiment, every trial must carry
             checkpoint-lineage and none may be reused, and every
             checkpoint must hold step 20 x (generation + 1); then the host
             ms of one BO call of 3 at histories of 12 and 200 trials
             (median of 5);
8. darts   — with torch's default TF32 flags too: three f32 search steps
             (second order, hessian_mode jvp) and one fd step of a small
             supernet (2 layers, 2 nodes, 4 channels, batch 16, 32x32,
             darts.json's 8 operations) on the card against the same steps
             on the CPU from the same weights and batches (DARTS_TOL); the
             full-width search step (8 layers, 16 channels, 4 nodes, batch
             128, or 64 if 128 does not fit) timed with CUDA events and its
             peak memory, and the device operations and busy share of the
             same width cut to DARTS_PROFILE_LAYERS layers under the
             profiler; then examples/nas/darts.json through the port's
             CLI on the card, its num_epochs cut in a copy to
             DARTS_SEARCH_EPOCHS and its images to DARTS_SEARCH_EXAMPLES
             (its trial must succeed with a finite
             accuracy and print a Best-Genotype of the search space's
             operations, two edges a node), and
             examples/nas/darts-retrain.json on that genotype, cut to 2
             trials of DARTS_RETRAIN_EPOCHS epochs (both must succeed with
             finite metrics);
9. enas    — with torch's default TF32 flags too: three Adam steps of a
             small ENAS child (every op kind, skips to the image, a
             reduction whose map is padded beside larger ones, depth
             multiplier 2) on the card against the CPU, from the same
             weights, batches and dropout masks (ENAS_TOL), and an arc
             whose 3x3 pool meets a 2x2 map (NaN logits and argmax 0 on
             both, as in JAX); the controller at enas.json's settings on
             both: the same arcs from the same seed, log_prob within
             CONTROLLER_LOGP_TOL, the parameters after one
             controller_train_steps round within CONTROLLER_TOL, and the
             round's time; the full-width child step (enas.json's 8
             layers, 32x32x3, batch 128) of the widest arc and of an arc a
             fresh controller samples, timed with CUDA events, its peak
             memory, and its device operations and busy share under the
             profiler; then examples/nas/enas.json through the port's CLI
             on the card, cut in a copy to ENAS_MAX_TRIALS trials (the
             cut is printed): every trial must succeed with a finite
             accuracy each epoch (and a finite loss unless its network
             averages an empty map), and the controller's parameters must
             change from one suggestion round to the next;
10. command — command trials, each a process of its own that the
             controller starts with CUDA_VISIBLE_DEVICES naming the trial's
             card, its metrics read by the StdOut collector, through the
             port's CLI: examples/trial-conditions.json, unchanged (every
             trial with lr > 0.3 Failed by its failure condition, every other
             Succeeded with score 1 - (lr - 0.05) ** 2 as the child computes
             it, and the experiment's end as Katib's rule for its counts
             says); examples/pytorch-subprocess.json, unchanged (it ends as
             Katib's rules say: by its goal of 0.99 once a trial reaches
             it, which the blob task does in its first or second trial, the
             trials not yet run then Killed; every trial that ran Succeeded
             with 3 finite values each of accuracy and loss, and retain:
             false left no Succeeded trial's directory); then
             katib_tpu_torch/examples/mnist-command-h100.json: 3 MNIST trials
             on the card, each a child process on cuda:0 of its own, whose
             per-epoch loss and accuracy must equal bit for bit those of the
             same assignments run in-process through the port's entryPoint
             path on cuda:0 under deterministic_cudnn and torch's default
             TF32 flags, as the child runs (else the largest difference is
             printed and held to MNIST_TOL); each trial's wall time beside
             the in-process trial's, and the difference, the cost of a
             process, and that cost taken apart in one more child (start,
             import torch, CUDA context, the MNIST data on the card, the
             first step). Where ``python`` on PATH is missing or is not this
             interpreter, each copy names this interpreter for argv[0]
             (printed); the port never rewrites a user's command.

Last, it imports every module of the port and checks that nothing of JAX
or of the JAX package was imported.
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
# DARTS search steps, f32, card against CPU: losses, weights and alphas after
# three second-order steps (and one fd step), absolute; the CPU tests'
# tolerance against the JAX package's step (tests/test_torch_darts.py).
DARTS_TOL = 1e-4
DARTS_PRIMITIVES = ("separable_convolution_3x3", "separable_convolution_5x5", "dilated_convolution_3x3",
                    "dilated_convolution_5x5", "avg_pooling_3x3", "max_pooling_3x3", "skip_connection")
# the search network of the DARTS paper at the reference's defaults
# (katib_tpu_torch/suggest/nas/darts.py): 8 layers, 16 channels, 4 nodes
DARTS_FULL = {"init_channels": "16", "num_nodes": "4", "stem_multiplier": "3", "batch_size": "128"}
# examples/nas/darts.json runs 3 epochs of 195 steps; its search step is
# bound by the host, 1.30-1.38 s at its shape on an NVIDIA H100 80GB HBM3 at
# 700.00 W (PERF.md §5), so 585 steps (~800 s) would not fit the phase's
# 600 s: the phase runs a copy cut to this many epochs, and prints the cut.
DARTS_SEARCH_EPOCHS = "1"
# ...and to this many of CIFAR-10's 50 000 training images (1 280 to search
# on, 1 280 to validate: 10 search steps of 128, ~17 s instead of ~270 s),
# to leave the script room for phases enas and search on a slow host
# (1169.5 s of phases with 12 800 images, PERF.md §6); printed with the
# epochs' cut.
DARTS_SEARCH_EXAMPLES = "2560"
# the full-width search step is timed at the paper's 8 layers; the profiler
# takes one step at this many (the same cells, channels, nodes and batch):
# reading back the profile of an 8-layer step (118 602 device operations)
# took 90-107 s of host time, the largest piece of the script's time on a
# slow host (PERF.md §6).
DARTS_PROFILE_LAYERS = 3
# examples/nas/darts-retrain.json trains 10 epochs a trial; the phase's copy
# trains this many (and 2 of its 8 trials), for the script's time; printed.
DARTS_RETRAIN_EPOCHS = 1
# ENAS child steps, f32, card against CPU: losses and parameters after three
# Adam steps, absolute; the CPU tests' tolerance against the JAX package's
# step (tests/test_torch_enas.py) and MNIST_TOL.
ENAS_TOL = 1e-4
# ENAS controller, card against CPU: log_prob of the same arcs within
# CONTROLLER_LOGP_TOL + 1e-6 |log_prob| (the CPU tests' tolerance for the
# scores: log_prob sums 36 terms to ~42 at enas.json's shape, where one f32
# unit is 3.8e-6) and the parameters after one round of
# controller_train_steps Adam steps (their tolerance for a round).
CONTROLLER_LOGP_TOL = 1e-5
CONTROLLER_TOL = 1e-4
# examples/nas/enas.json runs 12 trials of 3 epochs (1053 steps at batch
# 128); the phase runs a copy cut to this many trials (the time of the
# script, see PERF.md), so the controller is asked at least twice and
# trains between rounds; the cut is printed.
ENAS_MAX_TRIALS = 4
# examples/cma-es-ipop.json runs 40 trials (7 generations of 6, the last
# short: [6, 6, 6, 6, 6, 6, 4]; IPOP's stall window is 20 generations, so
# it restarts only on the CPU, in tests/test_torch_cmaes.py); the phase runs
# a copy cut to this many, for the script's time, which still ends on a
# short generation ([6, 6, 4]); the cut is printed.
CMAES_IPOP_MAX_TRIALS = 16
# examples/random.json, multivariate-tpe.json and sobol.json run 12 trials
# each; the phases run copies cut to these, for the script's time on a slow
# host (1057.6 s in all on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md §6);
# the cuts are printed.
# hyperband.json stays whole: with fewer than its 18 trials the trial
# budget narrows its first bracket's rungs.
RANDOM_MAX_TRIALS = 4
MULTIVARIATE_TPE_MAX_TRIALS = 8
SOBOL_MAX_TRIALS = 8
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "katib_tpu")  # never imported by the port
COMMAND_MODULES = ("katib_tpu_torch.api.defaults", "katib_tpu_torch.controller.conditions",
                   "katib_tpu_torch.controller.executor", "katib_tpu_torch.runtime.tailer",
                   "katib_tpu_torch.runtime.tfevent")
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

@contextlib.contextmanager
def torch_default_tf32(torch):
    """torch's default TF32 flags (cuDNN convolutions may use TF32, the
    trials hold theirs in f32) for the block; then the flags main() set."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = False, True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@contextlib.contextmanager
def deterministic_cudnn(torch):
    """cuDNN held to deterministic algorithms for the block (its default
    convolution backward is not: two runs of one seeded trial then differ,
    and SGD near the edge of stability can amplify that into a NaN in one
    run and not the next); then the flags as they were."""
    saved = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


@contextlib.contextmanager
def timed(torch, label):
    """Logs the seconds the block took, its device work included."""
    t0 = time.perf_counter()
    yield
    torch.cuda.synchronize()
    log(f"{label}: {time.perf_counter() - t0:.1f}s")


def phase_mnist(torch) -> None:
    with torch_default_tf32(torch):
        with timed(torch, "mnist: step check and times"):
            mnist_step_check(torch)
        run_example(torch, "mnist", "random", max_trials=RANDOM_MAX_TRIALS)
        run_example(torch, "mnist", "hyperband")


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
    with deterministic_cudnn(torch):
        first, again = run("cuda"), run("cuda")
    same = first[0] == again[0] and all(torch.equal(first[1][n], again[1][n]) for n in first[1])
    log(f"mnist: the same steps twice on the card under deterministic_cudnn: bit for bit equal: {same}")
    check(same, "the MNIST step is not repeatable on the card under deterministic_cudnn")

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


def run_example(torch, phase, name, trial_metrics=("loss", "accuracy"), max_trials=None) -> dict:
    """examples/<name>.json, unchanged (or a copy cut to ``max_trials``),
    through the port's CLI on the card; every trial that ran must succeed
    with one finite value of the objective and of each of ``trial_metrics``
    (the MNIST trial reports loss and accuracy) per epoch. The run ends at
    the trial budget, or, as Katib ends it, at the objective's goal once a
    trial has reached it; then every trial still pending is Killed without
    having started. Returns the experiment's record, its root under
    "root"."""
    import tempfile

    from katib_tpu_torch import cli

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", f"{name}.json")
    with open(path) as f:
        doc = json.load(f)
    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix=f"{phase}-{name}-", dir=OUT_DIR)
    if max_trials is not None:
        log(f"{phase}: examples/{name}.json, cut in a copy: maxTrialCount {doc['maxTrialCount']} -> {max_trials} "
            "(the script's time; everything else as the file has it)")
        doc["maxTrialCount"] = max_trials
        path = os.path.join(root, f"{name}.json")
        with open(path, "w") as f:
            json.dump(doc, f)
    t0 = time.perf_counter()
    with deterministic_cudnn(torch):
        rc = cli.main(["run", path, "--root", root, "--timeout", "900"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(root, doc["name"], "experiment.json")) as f:
        record = json.load(f)
    status, trials = record["experiment"]["status"], record["trials"]
    ran = [t for t in trials if t["startTime"] is not None]
    walls = sorted(t["completionTime"] - t["startTime"] for t in ran) or [math.nan]
    log(f"{phase}: examples/{name}.json through the port's CLI: rc {rc}, {status['condition']} "
        f"({status['reason']}), {status['trialsSucceeded']}/{len(trials)} trials succeeded, {len(ran)} ran, "
        f"experiment wall {wall:.1f}s; trial wall min {walls[0]:.2f}s, median {walls[len(walls) // 2]:.2f}s, "
        f"max {walls[-1]:.2f}s")
    check(rc == 0 and status["condition"] == "Succeeded", f"examples/{name}.json did not succeed")
    objective = doc["objective"]
    metrics = list(dict.fromkeys([objective["objectiveMetricName"], *objective.get("additionalMetricNames", []),
                                  *trial_metrics]))
    for t in trials:
        a = {p["name"]: p["value"] for p in t["parameterAssignments"]}
        if t["startTime"] is None:
            log(f"{phase}:   {t['name']} {t['condition']} ({t['message']}) {' '.join(f'{k}={v}' for k, v in a.items())}"
                " never started")
            check(status["reason"] == "ExperimentGoalReached" and t["condition"] == "Killed"
                  and t["message"] == "experiment ended",
                  f"trial {t['name']} never started, and is {t['condition']} ({t['message']!r}) at {status['reason']}")
            continue
        rows = record["logs"][t["name"]]
        values = {m: [float(v) for _, metric, v in rows if metric == m] for m in metrics}
        epochs = int(a.get("num_epochs", "1"))
        log(f"{phase}:   {t['name']} {t['condition']} ({t['conditions'][-1]['reason'] or 'ran'}) "
            f"{' '.join(f'{k}={v}' for k, v in a.items())} labels={t['labels']} "
            f"wall={t['completionTime'] - t['startTime']:.4f}s "
            + " ".join(f"{m}={[round(v, 4) for v in values[m]]}" for m in metrics))
        check(t["condition"] == "Succeeded", f"trial {t['name']} did not succeed:\n{t.get('message', '')}")
        check(all(len(vals) == epochs and all(math.isfinite(v) for v in vals) for vals in values.values()),
              f"trial {t['name']}: {values} is not one finite value of each metric per epoch")
    if status["reason"] == "ExperimentGoalReached":
        # the objective's strategy is its type (min for minimize), so the
        # goal is reached by a reported value at or beyond it
        minimize, goal = objective["type"] == "minimize", float(objective["goal"])
        reached = [float(v) for t in ran for _, m, v in record["logs"][t["name"]]
                   if m == objective["objectiveMetricName"] and (float(v) <= goal if minimize else float(v) >= goal)]
        check(bool(reached), f"examples/{name}.json ended GoalReached, but no trial reported "
              f"{objective['objectiveMetricName']} {'<=' if minimize else '>='} {goal}")
        log(f"{phase}: examples/{name}.json reached its goal ({objective['objectiveMetricName']} "
            f"{reached[0]} against {goal}) after {len(ran)} of {doc['maxTrialCount']} trials")
    else:
        check(len(trials) == doc["maxTrialCount"], f"examples/{name}.json ran {len(trials)} trials")
    log(f"{phase}: examples/{name}.json: objective {objective['type']} {objective['objectiveMetricName']}, "
        f"best {status['currentOptimalTrial']['bestTrialName']} "
        f"{[(p['name'], p['value']) for p in status['currentOptimalTrial']['parameterAssignments']]}")
    if name == "hyperband":
        check_hyperband_rungs(record)
    record["root"] = root
    return record


# ---------------------------------------------------------------------------
# phase 6: the suggesters and duplicate-result reuse
# ---------------------------------------------------------------------------

def phase_suggest(torch) -> None:
    with torch_default_tf32(torch):
        check_cmaes(run_example(torch, "suggest", "cma-es"))
        check_cmaes(run_example(torch, "suggest", "cma-es-ipop", max_trials=CMAES_IPOP_MAX_TRIALS))
        run_example(torch, "suggest", "multivariate-tpe", max_trials=MULTIVARIATE_TPE_MAX_TRIALS)
        check_reuse(run_example(torch, "suggest", "reuse-duplicate-results"))


def check_feasible(record) -> None:
    """Every assignment lies inside its parameter's [min, max], or is one
    of its list."""
    doc = record["experiment"]["spec"]
    space = {p["name"]: p["feasibleSpace"] for p in doc["parameters"]}
    for t in record["trials"]:
        for p in t["parameterAssignments"]:
            fs = space[p["name"]]
            if fs.get("list"):
                check(p["value"] in fs["list"], f"{doc['name']}: {p} is not one of {fs['list']}")
                continue
            lo, hi = float(fs["min"]), float(fs["max"])
            check(lo <= float(p["value"]) <= hi, f"{doc['name']}: {p} lies outside [{lo}, {hi}]")


def check_cmaes(record) -> None:
    """Every trial carries a generation label; the generations come in
    order, each but the last holding at least popsize trials (so each one
    folded before the next was drawn); every assignment lies inside the
    feasible space."""
    doc = record["experiment"]["spec"]
    settings = {s["name"]: s["value"] for s in doc["algorithm"]["algorithmSettings"]}
    popsize = int(settings.get("popsize", 4 + int(3 * math.log(len(doc["parameters"])))))
    trials = record["trials"]
    labels = [t["labels"].get("cmaes-generation") for t in trials]
    check(None not in labels, f"{doc['name']}: a trial has no cmaes-generation label: {labels}")
    sizes = [labels.count(str(g)) for g in range(max(map(int, labels)) + 1)]
    log(f"suggest: {doc['name']}: trials per generation {sizes} (popsize {popsize}, restart strategy "
        f"{settings.get('restart_strategy', 'none')})")
    check(labels == sorted(labels, key=int) and all(n >= popsize for n in sizes[:-1]) and sizes[-1] > 0,
          f"{doc['name']}: generations out of order or short of popsize {popsize}: {labels}")
    check_feasible(record)


def check_reuse(record) -> None:
    """At least one trial reused a result (12 draws over 6 points repeat;
    twins in flight together both run); each reused trial's metric log is
    its source's, and it took no time."""
    trials = {t["name"]: t for t in record["trials"]}
    reused = [t for t in trials.values() if t["conditions"][-1]["reason"] == "DuplicateResultReused"]
    log(f"suggest: reuse-duplicate-results: {len(reused)} of {len(trials)} trials reused a result, "
        f"{len({tuple(sorted((p['name'], p['value']) for p in t['parameterAssignments'])) for t in trials.values()})}"
        f" distinct assignments")
    check(reused, "no trial reused a result")
    for t in reused:
        source = trials[t["message"].split("reused result of trial ")[1].split(" ")[0]]
        wall = t["completionTime"] - t["startTime"]
        check(record["logs"][t["name"]] == record["logs"][source["name"]] and record["logs"][t["name"]],
              f"{t['name']}'s log is not {source['name']}'s")
        check(source["parameterAssignments"] == t["parameterAssignments"] and wall < 0.1,
              f"{t['name']} reused {source['name']} with other assignments or took {wall:.4f}s")


def check_hyperband_rungs(record) -> None:
    """r_l 9, eta 3, 18 trials: 9 of 1 epoch, the best 3 of them for 3, the
    best of those for 9, then 5 new ones of 3 (the trial budget cuts the
    second bracket). "Best" is Hyperband's ranking: the lowest loss a trial
    reported (a trial with none ranks first, as the suggester ranks it).
    A run that reached its goal early holds the rungs it made to this."""
    trials = record["trials"]
    params = [{p["name"]: p["value"] for p in t["parameterAssignments"]} for t in trials]
    budgets = [p["num_epochs"] for p in params]
    log(f"mnist: hyperband budgets (num_epochs) in order: {budgets}")
    expected = ["1"] * 9 + ["3"] * 3 + ["9"] + ["3"] * 5
    check(budgets == expected[:len(budgets)] and (len(budgets) == len(expected)
                                                  or record["experiment"]["status"]["reason"] == "ExperimentGoalReached"),
          f"hyperband's brackets are off: {budgets}")

    def best(indices, k):
        def loss(i):
            values = [float(v) for _, m, v in record["logs"][trials[i]["name"]] if m == "loss"]
            values = [v for v in values if not math.isnan(v)]
            return min(values) if values else -math.inf
        return sorted(sorted(indices, key=loss)[:k])

    def config(i):
        return params[i]["lr"], params[i]["momentum"]

    if len(trials) < 12:
        log("mnist: hyperband reached its goal in its first rung; no promotion to check")
        return
    promoted = sorted(config(i) for i in range(9, 12))
    check(promoted == sorted(config(i) for i in best(range(9), 3)),
          f"hyperband promoted {promoted}, not the best three of its first rung")
    if len(trials) < 13:
        log("mnist: hyperband promoted the best 3 of 9 to 3 epochs, then reached its goal")
        return
    check(config(12) == config(best(range(9, 12), 1)[0]),
          f"hyperband's 9-epoch trial {config(12)} is not the best of its 3-epoch rung")
    log("mnist: hyperband promoted the best 3 of 9 to 3 epochs and the best of those to 9")


# ---------------------------------------------------------------------------
# phase 7: Sobol, Bayesian optimisation and PBT
# ---------------------------------------------------------------------------

BO_HOST_HISTORIES = (12, 200)  # trials in the history of a timed BO call


def phase_search(torch) -> None:
    with torch_default_tf32(torch):
        check_sobol(run_example(torch, "search", "sobol", max_trials=SOBOL_MAX_TRIALS))
        check_bayesopt(run_example(torch, "search", "bayesian-optimization"))
        check_pbt(run_example(torch, "search", "simple-pbt", trial_metrics=()))
    bayesopt_host_times()


def check_sobol(record) -> None:
    """The trials, in the order they were made, carry the decode of scipy's
    scrambled Sobol stream (2 dimensions, seed 0), as strings."""
    from scipy.stats import qmc

    from katib_tpu_torch.api.spec import ExperimentSpec
    from katib_tpu_torch.suggest.internal.search_space import SearchSpace

    doc, trials = record["experiment"]["spec"], record["trials"]
    check_feasible(record)
    space = SearchSpace.from_experiment(ExperimentSpec.from_dict(doc))
    want = [[(a.name, a.value) for a in space.decode(u)]
            for u in qmc.Sobol(len(space), scramble=True, seed=0).random_base2(4)[:len(trials)]]
    got = [[(p["name"], p["value"]) for p in t["parameterAssignments"]] for t in trials]
    check(got == want, f"sobol: the assignments are not scipy's stream:\n{got}\n{want}")
    log(f"search: sobol: the {len(got)} assignments equal scipy's qmc.Sobol({len(space)}, scramble=True, seed=0) "
        "stream")


def check_bayesopt(record) -> None:
    """A trial asked for once n_initial_points trials had ended carries a
    bo-acq label of the portfolio; one asked for before carries none. (One
    card runs the trials in turn, so the trials asked for as the first ones
    end are random too.)"""
    from katib_tpu_torch.suggest.bayesopt import ACQ_LABEL, PORTFOLIO

    doc, trials = record["experiment"]["spec"], record["trials"]
    n_initial = int({s["name"]: s["value"] for s in doc["algorithm"]["algorithmSettings"]}["n_initial_points"])
    check_feasible(record)
    ended = sorted(t["completionTime"] for t in trials)
    labelled = 0
    for t in trials:
        created = next(c["lastTransitionTime"] for c in t["conditions"] if c["type"] == "Pending")
        model_based = sum(e <= created for e in ended) >= n_initial
        label = t["labels"].get(ACQ_LABEL)
        check((label in PORTFOLIO) == model_based and (model_based or label is None),
              f"bayesian-optimization: {t['name']} ({sum(e <= created for e in ended)} trials ended before it) "
              f"carries label {label!r}")
        labelled += model_based
    check(labelled > 0, "bayesian-optimization: no trial came from the GP")
    log(f"search: bayesian-optimization: {labelled} of {len(trials)} trials from the GP, labelled "
        f"{[t['labels'].get(ACQ_LABEL) for t in trials]}")


def check_pbt(record) -> None:
    """Generation 2 reached; every parent names a trial of the experiment;
    every trial's checkpoint holds step 20 x (generation + 1); no trial
    reused a result; every trial carries the lineage label."""
    from katib_tpu_torch.suggest.pbt import GENERATION_LABEL, PARENT_LABEL

    doc, trials = record["experiment"]["spec"], record["trials"]
    check_feasible(record)
    names = {t["name"] for t in trials}
    generations = []
    for t in trials:
        generation = int(t["labels"][GENERATION_LABEL])
        generations.append(generation)
        parent = t["labels"].get(PARENT_LABEL)
        check(parent is None or parent in names, f"simple-pbt: {t['name']}'s parent {parent} is not a trial")
        check(t["labels"].get("checkpoint-lineage") == "1" and t["conditions"][-1]["reason"] != "DuplicateResultReused",
              f"simple-pbt: {t['name']} has no lineage label or reused a result")
        with open(os.path.join(record["root"], doc["name"], "pbt", t["name"], "training.json")) as f:
            step = json.load(f)["step"]
        check(step == 20 * (generation + 1), f"simple-pbt: {t['name']} of generation {generation} is at step {step}")
    sizes = [generations.count(g) for g in range(max(generations) + 1)]
    log(f"search: simple-pbt: trials per generation {sizes}; every checkpoint at step 20 x (generation + 1)")
    check(max(generations) >= 2, f"simple-pbt: reached generation {max(generations)} only")


def bayesopt_host_times(repeats=5) -> None:
    """Host ms of one get_suggestions call of 3 on bayesian-optimization.json
    (2 parameters, gp_hedge, 5 initial points) at histories of 12 and 200
    Succeeded trials, random_state set; median of ``repeats``."""
    import numpy as np

    from katib_tpu_torch.api.spec import ExperimentSpec, Observation, ParameterAssignment
    from katib_tpu_torch.api.status import Trial, TrialCondition
    from katib_tpu_torch.suggest.base import SuggestionRequest
    from katib_tpu_torch.suggest.bayesopt import ACQ_LABEL, PORTFOLIO, BayesianOptimization

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "bayesian-optimization.json")
    with open(path) as f:
        doc = json.load(f)
    doc["algorithm"]["algorithmSettings"].append({"name": "random_state", "value": "0"})
    exp = ExperimentSpec.from_dict(doc)
    for n in BO_HOST_HISTORIES:
        rng = np.random.default_rng(n)
        trials = []
        for i in range(n):
            lr, momentum = rng.uniform(0.01, 0.5), rng.uniform(0.5, 0.99)
            loss = repr(float((np.log(lr) - np.log(0.08)) ** 2 + (momentum - 0.9) ** 2))
            t = Trial(name=f"t{i}", experiment_name=doc["name"],
                      parameter_assignments=[ParameterAssignment("lr", repr(lr)),
                                             ParameterAssignment("momentum", repr(momentum))],
                      labels={} if i < 5 else {ACQ_LABEL: PORTFOLIO[i % 3]})
            t.condition = TrialCondition.SUCCEEDED
            t.observation = Observation.from_dict({"metrics": [{"name": "loss", "min": loss, "max": loss,
                                                                "latest": loss}]})
            trials.append(t)
        request = SuggestionRequest(exp, trials, 3)
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            reply = BayesianOptimization().get_suggestions(request)
            times.append((time.perf_counter() - t0) * 1e3)
            check(len(reply.assignments) == 3 and all(a.labels.get(ACQ_LABEL) in PORTFOLIO
                                                      for a in reply.assignments), "a timed BO call failed")
        log(f"search: bayesian-optimization host time of one call of 3 at {n} trials (2 parameters, gp_hedge): "
            f"median {sorted(times)[len(times) // 2]:.2f} host ms of {repeats} ({', '.join(f'{t:.2f}' for t in times)})")


# ---------------------------------------------------------------------------
# phase 8: the DARTS search and its retraining
# ---------------------------------------------------------------------------

def phase_darts(torch) -> None:
    card = device_line()
    with torch_default_tf32(torch):
        for mode, steps in (("jvp", 3), ("fd", 1)):
            with timed(torch, f"darts: {mode} step check"):
                darts_step_check(torch, card, mode, steps)
        with timed(torch, "darts: full-width step"):
            darts_full_width(torch, card)
        with timed(torch, "darts: darts.json"):
            genotype = run_darts_search(torch, card)
        with timed(torch, "darts: darts-retrain.json"):
            run_darts_retrain(torch, card, genotype)


def _darts_search(torch, device, settings, num_layers):
    from katib_tpu_torch.models.darts_trainer import DartsSearch

    return DartsSearch(DARTS_PRIMITIVES, num_layers=num_layers, settings=settings, device=torch.device(device))


def _darts_batches(torch, n_steps, batch, device):
    """``n_steps`` (train, valid) batches of synthetic CIFAR-10, NCHW."""
    from katib_tpu_torch.utils.datasets import load_cifar10

    x, y = load_cifar10("train", n=2 * n_steps * batch)
    x = torch.tensor(x, device=device).permute(0, 3, 1, 2).contiguous()
    y = torch.tensor(y, dtype=torch.long, device=device)
    return [((x[2 * i * batch:(2 * i + 1) * batch], y[2 * i * batch:(2 * i + 1) * batch]),
             (x[(2 * i + 1) * batch:(2 * i + 2) * batch], y[(2 * i + 1) * batch:(2 * i + 2) * batch]))
            for i in range(n_steps)]


def darts_step_check(torch, card, mode, steps, batch=16) -> None:
    """Search steps of a small supernet (2 layers, 2 nodes, 4 channels, the
    8 operations) on the card against the same steps on the CPU: the same
    seeded weights and alphas, the same batches."""
    settings = {"init_channels": "4", "num_nodes": "2", "batch_size": str(batch), "hessian_mode": mode}
    runs = {}
    for device in ("cpu", "cuda"):
        search = _darts_search(torch, device, settings, 2)
        search.build(10)
        losses = [float(search.step(tb, vb)) for tb, vb in _darts_batches(torch, steps, batch, device)]
        runs[device] = losses, {k: v.detach().cpu() for k, v in search.model.state_dict().items()}
    (cpu_losses, cpu_state), (gpu_losses, gpu_state) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
    alpha_err = max(float((cpu_state[k] - gpu_state[k]).abs().max()) for k in cpu_state if k.startswith("alpha_"))
    weight_err = max(float((cpu_state[k] - gpu_state[k]).abs().max()) for k in cpu_state if not k.startswith("alpha_"))
    log(f"darts [{card}]: {steps} search step(s), hessian_mode {mode}, f32, batch {batch} 32x32, cuda vs cpu "
        f"(cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} outside the step): losses max_abs_err={loss_err:.3e}, "
        f"alphas {alpha_err:.3e}, weights {weight_err:.3e} (tol {DARTS_TOL}); cuda losses {gpu_losses}")
    check(max(loss_err, alpha_err, weight_err) <= DARTS_TOL, f"the DARTS {mode} step on the card disagrees with the CPU")
    check(all(math.isfinite(x) for x in gpu_losses), f"DARTS losses are not finite: {gpu_losses}")


def darts_full_width(torch, card, steps=5) -> None:
    """The search step of the DARTS paper's search network (8 layers, 16
    channels, 4 nodes, the 8 operations) at the reference's batch 128, or
    64 where 128 does not fit: CUDA-event time per step (median of
    ``steps``) and peak memory; then, under the profiler, device
    operations and busy share over one step of the same network cut to
    DARTS_PROFILE_LAYERS layers (reading back an 8-layer step's profile
    takes one and a half to two minutes of host time)."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for batch in (128, 64):
        try:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            search = _darts_search(torch, "cuda", dict(DARTS_FULL, batch_size=str(batch)), 8)
            search.build(1000)
            batches = _darts_batches(torch, steps + 1, batch, "cuda")
            search.step(*batches[0])  # first use: cuDNN's algorithm choice
            torch.cuda.synchronize()
            times, walls = [], []
            for tb, vb in batches[1:steps + 1]:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                search.step(tb, vb)
                end.record()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
                times.append(start.elapsed_time(end))
            peak = torch.cuda.max_memory_allocated() / 2**30
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"darts [{card}]: full width at batch {batch} does not fit ({e}); cut to batch 64, the DARTS paper's")
            search = batches = None
            check(batch == 128, "the full-width DARTS step does not fit at batch 64 either")
    n_weights = sum(p.numel() for p in search.model.weights())
    log(f"darts [{card}]: full-width search step (8 layers, 16 channels, 4 nodes, 8 operations, "
        f"{n_weights / 1e6:.2f}M weights, batch {batch}, f32, hessian_mode jvp): {statistics.median(times):.1f} ms/step "
        f"(CUDA events, median of {steps}: {[round(t, 1) for t in times]}; host wall {[round(w, 1) for w in walls]}); "
        f"peak memory {peak:.2f} GiB")
    del search
    search = _darts_search(torch, "cuda", dict(DARTS_FULL, batch_size=str(batch)), DARTS_PROFILE_LAYERS)
    search.build(1000)
    search.step(*batches[0])  # first use of the cut network's shapes
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search.step(*batches[1])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "darts_step_profile.txt"), "w") as f:
        f.write(table)
    log(f"darts [{card}]: profiler, 1 search step at the same width cut to {DARTS_PROFILE_LAYERS} of 8 layers "
        f"(the script's time): wall {wall_ms:.1f} ms/step (profiled), device busy {device_ms:.1f} ms/step "
        f"({100 * device_ms / wall_ms:.1f}% busy), {len(on_device)} device ops/step; top device time:\n{table}")
    del search, batches
    torch.cuda.empty_cache()


class _Tee:
    """Writes to the real stdout and keeps a copy (the trials print their
    Best-Genotype there)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def _run_cli(torch, doc, prefix, timeout):
    """``doc`` through the port's CLI on the card: (rc, wall seconds, the
    experiment's record with its root under "root", what the run printed)."""
    import tempfile

    from katib_tpu_torch import cli

    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix=prefix, dir=OUT_DIR)
    path = os.path.join(root, "spec.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = cli.main(["run", path, "--root", root, "--timeout", str(timeout)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with open(os.path.join(root, doc["name"], "experiment.json")) as f:
        record = json.load(f)
    record["root"] = root
    return rc, wall, record, "".join(tee.lines)


class _StepLog:
    """Collects the search's per-epoch step times (the trainer's log)."""

    def __init__(self):
        import logging

        self.epochs = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.epochs.append(record.args)
        self.logger = logging.getLogger("katib_tpu_torch.darts")

    def __enter__(self):
        import logging

        self.level = self.logger.level
        self.logger.setLevel(logging.INFO)
        self.logger.addHandler(self.handler)
        return self

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)
        self.logger.setLevel(self.level)


def run_darts_search(torch, card) -> dict:
    """examples/nas/darts.json through the CLI, its epochs cut to
    DARTS_SEARCH_EPOCHS and its images to DARTS_SEARCH_EXAMPLES; returns
    the printed genotype."""
    import ast

    from katib_tpu_torch.api.spec import ExperimentSpec
    from katib_tpu_torch.suggest.nas.darts import darts_search_space

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "nas", "darts.json")) as f:
        doc = json.load(f)
    epochs = next(s for s in doc["algorithm"]["algorithmSettings"] if s["name"] == "num_epochs")
    log(f"darts [{card}]: examples/nas/darts.json, cut in a copy: num_epochs {epochs['value']} -> "
        f"{DARTS_SEARCH_EPOCHS}, num_train_examples 50000 -> {DARTS_SEARCH_EXAMPLES} (an added setting; the "
        f"script's time; everything else as the file has it)")
    epochs["value"] = DARTS_SEARCH_EPOCHS
    doc["algorithm"]["algorithmSettings"].append({"name": "num_train_examples", "value": DARTS_SEARCH_EXAMPLES})
    with _StepLog() as steps:
        rc, wall, record, printed = _run_cli(torch, doc, "darts-search-", 540)
    status, (trial,) = record["experiment"]["status"], record["trials"]
    rows = record["logs"][trial["name"]]
    acc = [float(v) for _, m, v in rows if m == "Validation-accuracy"]
    loss = [float(v) for _, m, v in rows if m == "Train-loss"]
    ran = record["experiment"]["spec"]
    settings = {s["name"]: s["value"] for s in ran["algorithm"]["algorithmSettings"]}
    log(f"darts [{card}]: examples/nas/darts.json through the port's CLI ({ran['nasConfig']['graphConfig']['numLayers']} "
        f"layers, {settings}): rc {rc}, {status['condition']} ({status['reason']}), trial {trial['condition']}, "
        f"experiment wall {wall:.1f}s, trial wall {trial['completionTime'] - trial['startTime']:.1f}s; "
        f"Validation-accuracy {acc}, Train-loss {loss}")
    for n, seconds, ms in steps.epochs:
        log(f"darts [{card}]:   epoch: {n} search steps in {seconds:.1f}s, {ms:.1f} ms/step")
    check(rc == 0 and status["condition"] == "Succeeded" and trial["condition"] == "Succeeded",
          f"examples/nas/darts.json did not succeed:\n{trial.get('message', '')}")
    check(len(acc) == int(settings["num_epochs"]) and all(math.isfinite(a) for a in acc + loss),
          f"darts.json's metrics are not one finite value per epoch: {acc}, {loss}")
    genes = [line.split("=", 1)[1] for line in printed.splitlines() if line.startswith("Best-Genotype=")]
    check(len(genes) == 1, f"darts.json printed {len(genes)} Best-Genotype lines")
    gene = ast.literal_eval(genes[0])
    space = set(darts_search_space(ExperimentSpec.from_dict(ran).nas_config))
    nodes = int(settings["num_nodes"])
    for key in ("normal", "reduce"):
        check(len(gene[key]) == nodes, f"{key} gene has {len(gene[key])} nodes, not {nodes}")
        for i, node in enumerate(gene[key]):
            check(len(node) == 2 and all(op in space and 0 <= j < 2 + i for op, j in node),
                  f"{key} gene node {i} is not two edges of the search space: {node}")
    log(f"darts [{card}]: Best-Genotype={genes[0]}")
    return genes[0]


def run_darts_retrain(torch, card, genotype: str) -> None:
    """examples/nas/darts-retrain.json on the searched genotype, cut to 2
    trials of DARTS_RETRAIN_EPOCHS epochs."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "nas",
                           "darts-retrain.json")) as f:
        doc = json.load(f)
    next(p for p in doc["parameters"] if p["name"] == "genotype")["feasibleSpace"]["list"] = [genotype]
    doc["maxTrialCount"] = 2  # cut from 8
    doc["parameters"].append({"name": "num_epochs", "parameterType": "categorical",
                              "feasibleSpace": {"list": [str(DARTS_RETRAIN_EPOCHS)]}})  # the trial's default: 10
    log(f"darts [{card}]: examples/nas/darts-retrain.json on that genotype, cut: maxTrialCount 8 -> 2, "
        f"num_epochs 10 -> {DARTS_RETRAIN_EPOCHS} (a one-value categorical parameter)")
    rc, wall, record, _ = _run_cli(torch, doc, "darts-retrain-", 300)
    status, trials = record["experiment"]["status"], record["trials"]
    log(f"darts [{card}]: retrain: rc {rc}, {status['condition']} ({status['reason']}), "
        f"{status['trialsSucceeded']}/{len(trials)} trials succeeded, experiment wall {wall:.1f}s")
    check(rc == 0 and status["condition"] == "Succeeded" and len(trials) == 2, "darts-retrain.json did not succeed")
    for t in trials:
        a = {p["name"]: p["value"] for p in t["parameterAssignments"]}
        rows = record["logs"][t["name"]]
        values = {m: [float(v) for _, metric, v in rows if metric == m] for m in ("Validation-accuracy", "Train-loss")}
        log(f"darts [{card}]:   {t['name']} {t['condition']} lr={float(a['lr']):.4f} "
            f"momentum={float(a['momentum']):.3f} wall={t['completionTime'] - t['startTime']:.1f}s {values}")
        check(t["condition"] == "Succeeded", f"retrain trial {t['name']} did not succeed:\n{t.get('message', '')}")
        for metric, vals in values.items():
            check(len(vals) == DARTS_RETRAIN_EPOCHS and all(math.isfinite(v) for v in vals),
                  f"retrain trial {t['name']}: {metric} {vals} is not one finite value per epoch")


# ---------------------------------------------------------------------------
# phase 9: the ENAS search
# ---------------------------------------------------------------------------

def phase_enas(torch) -> None:
    card = device_line()
    with torch_default_tf32(torch):
        with timed(torch, "enas: card against CPU"):
            enas_child_check(torch, card)
            enas_empty_map_check(torch, card)
            enas_controller_check(torch, card)
        with timed(torch, "enas: full-width steps"):
            for label, arc in (("widest", enas_widest_arc()), ("sampled", enas_sampled_arc(torch))):
                enas_full_width(torch, card, label, arc)
        run_enas_search(torch, card)


ENAS_SMALL_OPS = {  # every op kind of the child, depth multiplier 2
    "0": {"opt_type": "convolution", "opt_params": {"filter_size": "3", "num_filter": "16"}},
    "1": {"opt_type": "convolution", "opt_params": {"filter_size": "5", "num_filter": "8"}},
    "2": {"opt_type": "separable_convolution",
          "opt_params": {"filter_size": "3", "num_filter": "16", "depth_multiplier": "2"}},
    "3": {"opt_type": "depthwise_convolution", "opt_params": {"filter_size": "3", "depth_multiplier": "2"}},
    "4": {"opt_type": "reduction", "opt_params": {"reduction_type": "max_pooling", "pool_size": 2}},
    "5": {"opt_type": "reduction", "opt_params": {"reduction_type": "avg_pooling", "pool_size": 3}},
}
# skips to the image (layers 2, 4 and 6); layer 3's 16x16 map and layer
# 5's 10x10 one padded beside 32x32 maps
ENAS_SMALL_ARCH = [[0], [2, 1], [4, 0, 1], [1, 1, 0, 1], [5, 0, 1, 0, 1], [3, 1, 0, 0, 1, 1]]


def enas_child_check(torch, card, steps=3, batch=16) -> None:
    """Three Adam steps of a small child (ENAS_SMALL_ARCH) on the card
    against the CPU, from the same seeded weights, batches and dropout
    masks: the losses, every step's gradients, and the parameters after
    the steps. Adam moves an element by about lr * sign(g) where its
    gradient g is rounding noise: the convolutions' biases (a batch norm
    follows each, so their gradient is zero up to rounding and they do not
    change the output) and elements whose gradient cancels below 1e-6 at
    some step; those parameters are held to the losses and gradients
    alone, and their count is printed."""
    from katib_tpu_torch.models import enas_child
    from katib_tpu_torch.utils.datasets import load_cifar10

    x, y = load_cifar10("train", n=steps * batch)
    runs = {}
    for device in ("cpu", "cuda"):
        model = enas_child.EnasChildNet(ENAS_SMALL_ARCH, ENAS_SMALL_OPS).to(device)
        step = enas_child.make_child_train_step(model, 0.002, torch.Generator().manual_seed(0))
        xd = torch.tensor(x, device=device).permute(0, 3, 1, 2).contiguous()
        yd = torch.tensor(y, dtype=torch.long, device=device)
        losses, grads = [], []
        for i in range(steps):
            losses.append(float(step(xd[i * batch:(i + 1) * batch], yd[i * batch:(i + 1) * batch])))
            grads.append({n: p.grad.detach().cpu().clone() for n, p in model.named_parameters()})
        runs[device] = losses, grads, {k: v.detach().cpu() for k, v in model.state_dict().items()}
    (cpu_losses, cpu_grads, cpu_state), (gpu_losses, gpu_grads, gpu_state) = runs["cpu"], runs["cuda"]
    loss_err = max(abs(a - b) for a, b in zip(cpu_losses, gpu_losses))
    grad_err = max(float((a[n] - b[n]).abs().max()) for a, b in zip(cpu_grads, gpu_grads) for n in a)
    held = {n: torch.stack([g[n].abs() >= 1e-6 for g in cpu_grads]).all(0) & (not n.endswith("_conv.bias"))
            & (not n.endswith("_dw.bias")) & (not n.endswith("_pw.bias")) for n in cpu_state}
    param_err = float(torch.cat([(cpu_state[n] - gpu_state[n])[held[n]].abs() for n in cpu_state]).max())
    n_held, n_all = sum(int(h.sum()) for h in held.values()), sum(h.numel() for h in held.values())
    shapes = [layer.shape_out for layer in enas_child.EnasChildNet(ENAS_SMALL_ARCH, ENAS_SMALL_OPS).plan]
    log(f"enas [{card}]: child {ENAS_SMALL_ARCH} (layer shapes {shapes}), {steps} Adam steps, f32, dropout 0.4, "
        f"batch {batch} 32x32, cuda vs cpu (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} outside the step): "
        f"losses max_abs_err={loss_err:.3e}, gradients {grad_err:.3e}, params {param_err:.3e} over {n_held} of "
        f"{n_all} elements (tol {ENAS_TOL}); cuda losses {gpu_losses}")
    check(max(loss_err, grad_err, param_err) <= ENAS_TOL, "the ENAS child step on the card disagrees with the CPU")
    check(all(math.isfinite(v) for v in gpu_losses), f"ENAS child losses are not finite: {gpu_losses}")


def enas_empty_map_check(torch, card) -> None:
    """A 3x3 pool over a 2x2 map: an empty map, the head's mean NaN, and
    argmax 0 (as jnp.argmax of NaN), on the card as on the CPU."""
    from katib_tpu_torch.models import enas_child

    x = torch.randn(4, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    ops = {"0": {"opt_type": "reduction", "opt_params": {"reduction_type": "max_pooling", "pool_size": 3}}}
    out = {}
    for device in ("cpu", "cuda"):
        model = enas_child.EnasChildNet([[0]], ops, input_shape=(3, 2, 2)).to(device)
        logits = model(x.to(device))
        out[device] = (bool(torch.isnan(logits).all()), logits.argmax(-1).tolist())
    log(f"enas [{card}]: arc [[3x3 max pool]] on 2x2 images: logits all NaN, argmax: cpu {out['cpu']}, "
        f"cuda {out['cuda']}")
    check(out["cpu"] == out["cuda"] == (True, [0, 0, 0, 0]), "the empty-map arc differs between card and CPU")


def _enas_spec(torch):
    from katib_tpu_torch.api.spec import ExperimentSpec

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "nas", "enas.json")) as f:
        return ExperimentSpec.from_json(f.read())


def _enas_controller(torch, spec, device):
    from katib_tpu_torch.suggest.nas import enas

    settings = enas.parse_enas_settings(spec)
    return settings, enas.EnasController(
        len(enas.expand_operations(spec.nas_config)), spec.nas_config.graph_config.num_layers,
        settings["controller_hidden_size"], settings["controller_temperature"], settings["controller_tanh_const"],
        settings["controller_skip_target"], torch.Generator().manual_seed(0)).to(device)


def enas_controller_check(torch, card, arcs=3) -> None:
    """The controller at enas.json's settings on the card and on the CPU:
    arcs from the same generator seed, their log_prob, then one round of
    controller_train_steps from the same seed (and so the same draws)."""
    from katib_tpu_torch.suggest.nas import enas

    spec = _enas_spec(torch)
    runs = {}
    for device in ("cpu", "cuda"):
        settings, controller = _enas_controller(torch, spec, device)
        generator = torch.Generator().manual_seed(1)
        sampled = [controller.sample_arc(generator) for _ in range(arcs)]
        log_probs = [float(controller.score_arc(a)[0].detach()) for a in sampled]
        optimizer = enas.make_controller_optimizer(controller, settings["controller_learning_rate"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        baseline = enas.train_controller(controller, optimizer, 0.0, 0.5, settings, generator)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        runs[device] = sampled, log_probs, {k: v.detach().cpu() for k, v in controller.state_dict().items()}, ms
    (cpu_arcs, cpu_lp, cpu_state, cpu_ms), (gpu_arcs, gpu_lp, gpu_state, gpu_ms) = runs["cpu"], runs["cuda"]
    lp_err = max(abs(a - b) - 1e-6 * abs(a) for a, b in zip(cpu_lp, gpu_lp))
    param_err = max(float((cpu_state[k] - gpu_state[k]).abs().max()) for k in cpu_state)
    steps = settings["controller_train_steps"]
    log(f"enas [{card}]: controller (8 layers, hidden 64, 18 operations): {arcs} arcs from seed 1 equal on card and "
        f"CPU: {cpu_arcs == gpu_arcs}; log_prob {gpu_lp}, max |err| - 1e-6 |log_prob| = {lp_err:.3e} (tol {CONTROLLER_LOGP_TOL}); "
        f"one round of {steps} steps: params max_abs_err={param_err:.3e} (tol {CONTROLLER_TOL}); round {gpu_ms:.1f} ms "
        f"on the card ({gpu_ms / steps:.2f} ms a step), {cpu_ms:.1f} ms on the CPU; arcs {gpu_arcs}")
    check(cpu_arcs == gpu_arcs, f"the controller samples other arcs on the card: {gpu_arcs} vs {cpu_arcs}")
    check(lp_err <= CONTROLLER_LOGP_TOL, "the controller's log_prob on the card disagrees with the CPU")
    check(param_err <= CONTROLLER_TOL, "the controller's round on the card disagrees with the CPU")


def enas_widest_arc():
    """Every layer a 5x5 convolution of 64 filters (enas.json's operation 5),
    every skip bit on."""
    return [[5] + [1] * layer for layer in range(8)]


def enas_sampled_arc(torch):
    """The first arc a fresh controller (enas.json, seed 0) samples."""
    _, controller = _enas_controller(torch, _enas_spec(torch), "cuda")
    flat = controller.sample_arc(torch.Generator().manual_seed(0))
    return [flat[layer * (layer + 1) // 2:(layer + 1) * (layer + 2) // 2] for layer in range(8)]


def enas_step_flops(model, batch) -> float:
    """Forward and backward products of the convolutions: 3x the
    forward's 2 * N * H * W * C_in / groups * C_out * k * k."""
    total = 0.0
    for name, module in model.named_modules():
        if hasattr(module, "groups"):  # a SameConv
            layer = model.plan[int(name[len("layer"):].split("_")[0]) - 1]
            c_out, c_in_g, k, _ = module.weight.shape
            h, w = layer.shape_out[1:]
            total += 2.0 * batch * h * w * c_in_g * c_out * k * k
    return 3 * total


def enas_full_width(torch, card, label, arch, batch=128, steps=5) -> None:
    """The child step of ``arch`` at enas.json's graph (8 layers, 32x32x3)
    and the trial's batch of 128: CUDA-event time per step (median of
    ``steps``), peak memory, and, under the profiler, device operations and
    busy share over two steps."""
    import statistics

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from katib_tpu_torch.models import enas_child
    from katib_tpu_torch.suggest.nas import enas
    from katib_tpu_torch.utils.datasets import load_cifar10

    ops = enas.expand_operations(_enas_spec(torch).nas_config)
    embedding = {str(layer[0]): ops[layer[0]] for layer in arch}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = enas_child.EnasChildNet(arch, embedding).to("cuda")
    step = enas_child.make_child_train_step(model, 0.002, torch.Generator().manual_seed(0))
    x, y = load_cifar10("train", n=batch)
    bx = torch.tensor(x, device="cuda").permute(0, 3, 1, 2).contiguous()
    by = torch.tensor(y, dtype=torch.long, device="cuda")
    step(bx, by)  # first use: cuDNN's algorithm choice
    torch.cuda.synchronize()
    times = []
    for _ in range(steps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step(bx, by)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(bx, by)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / 2
    on_device = [e for e in prof.events() if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    device_ms = sum(e.time_range.elapsed_us() for e in on_device) / 1e3 / 2
    table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=12)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"enas_{label}_step_profile.txt"), "w") as f:
        f.write(table)
    ms = statistics.median(times)
    flops = enas_step_flops(model, batch)
    shapes = [layer.shape_in for layer in model.plan]
    log(f"enas [{card}]: full-width child step, {label} arc {arch} (layer inputs (C, H, W) {shapes}, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f}M weights, batch {batch}, f32): {ms:.2f} ms/step "
        f"(CUDA events, median of {steps}: {[round(t, 2) for t in times]}); convolution products "
        f"{flops / 1e12:.3f} TFLOP a step = {flops / ms / 1e9:.1f} TFLOP/s; peak memory {peak:.2f} GiB")
    log(f"enas [{card}]: profiler, 2 {label} steps: wall {wall_ms:.2f} ms/step (profiled), device busy "
        f"{device_ms:.2f} ms/step ({100 * device_ms / wall_ms:.1f}% busy), {len(on_device) / 2:.0f} device ops/step; "
        f"top device time:\n{table}")
    del model, step, bx, by
    torch.cuda.empty_cache()


class _ControllerLog:
    """Records the controller's parameters at each suggestion round (each
    time the suggester saves its state)."""

    def __enter__(self):
        from katib_tpu_torch.suggest.nas import enas

        self.rounds, self.cls = [], enas.ENAS
        self.save = self.cls._save
        rounds, save = self.rounds, self.save

        def recording(suggester):
            rounds.append({k: v.detach().cpu().clone() for k, v in suggester._state["controller"].state_dict().items()})
            save(suggester)

        self.cls._save = recording
        return self

    def __exit__(self, *exc):
        self.cls._save = self.save


def run_enas_search(torch, card) -> None:
    """examples/nas/enas.json through the CLI, cut to ENAS_MAX_TRIALS."""
    from katib_tpu_torch.models import enas_child

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples", "nas", "enas.json")) as f:
        doc = json.load(f)
    log(f"enas [{card}]: examples/nas/enas.json, cut in a copy: maxTrialCount {doc['maxTrialCount']} -> "
        f"{ENAS_MAX_TRIALS} (the script's time; everything else as the file has it)")
    doc["maxTrialCount"] = ENAS_MAX_TRIALS
    with _ControllerLog() as controller:
        rc, wall, record, _ = _run_cli(torch, doc, "enas-search-", 900)
    status, trials = record["experiment"]["status"], record["trials"]
    log(f"enas [{card}]: examples/nas/enas.json through the port's CLI: rc {rc}, {status['condition']} "
        f"({status['reason']}), {status['trialsSucceeded']}/{len(trials)} trials succeeded, experiment wall "
        f"{wall:.1f}s, {len(controller.rounds)} suggestion rounds")
    check(rc == 0 and status["condition"] == "Succeeded" and len(trials) == ENAS_MAX_TRIALS,
          "examples/nas/enas.json did not succeed")
    for t in trials:
        a = {p["name"]: p["value"] for p in t["parameterAssignments"]}
        arch, nn_config = enas_child.parse_assignments(a)
        shapes = [layer.shape_out for layer in enas_child.EnasChildNet(arch, nn_config["embedding"]).plan]
        empty_head = shapes[-1][1] * shapes[-1][2] == 0
        rows = record["logs"][t["name"]]
        values = {m: [float(v) for _, metric, v in rows if metric == m] for m in ("Validation-accuracy", "Train-loss")}
        log(f"enas [{card}]:   {t['name']} {t['condition']} wall={t['completionTime'] - t['startTime']:.1f}s "
            f"arc={arch} last map {shapes[-1]} {values}")
        check(t["condition"] == "Succeeded", f"trial {t['name']} did not succeed:\n{t.get('message', '')}")
        check(len(values["Validation-accuracy"]) == 3 and all(math.isfinite(v) for v in values["Validation-accuracy"]),
              f"trial {t['name']}: Validation-accuracy is not one finite value per epoch")
        check(len(values["Train-loss"]) == 3 and (empty_head or all(math.isfinite(v) for v in values["Train-loss"])),
              f"trial {t['name']}: Train-loss is not one finite value per epoch")
    moved = [max(float((a[k] - b[k]).abs().max()) for k in a) for a, b in zip(controller.rounds, controller.rounds[1:])]
    log(f"enas [{card}]: the controller's largest parameter change from each round to the next: {moved}")
    check(len(moved) >= 1 and all(m > 0 for m in moved), "the controller did not train between suggestion rounds")


# ---------------------------------------------------------------------------
# phase 10: command trials
# ---------------------------------------------------------------------------

def phase_command(torch) -> None:
    here = os.getcwd()
    os.chdir(os.path.dirname(os.path.abspath(__file__)))  # the examples' workingDir "." is the repository
    try:
        run_trial_conditions(torch)
        run_pytorch_subprocess(torch)
        run_mnist_command(torch)
    finally:
        os.chdir(here)


def _command_example(path):
    """The spec at ``path`` (from the repository's root), with this
    interpreter for a leading ``python`` when ``python`` on PATH is missing
    or is another interpreter (printed)."""
    import shutil

    with open(path) as f:
        doc = json.load(f)
    command = doc["trialTemplate"]["command"]
    found = shutil.which("python")
    if command[0] == "python" and (found is None or os.path.realpath(found) != os.path.realpath(sys.executable)):
        log(f"command: {path}, in a copy: argv[0] 'python' -> {sys.executable} ('python' on PATH is {found})")
        command[0] = sys.executable
    else:
        log(f"command: {path}: 'python' on PATH is {found}, this interpreter; argv[0] unchanged")
    return doc


def _trial_lines(phase, record, metrics):
    """Logs each trial; returns {trial name: {metric: [float values]}}."""
    values = {}
    for t in record["trials"]:
        rows = record["logs"][t["name"]]
        values[t["name"]] = {m: [float(v) for _, metric, v in rows if metric == m] for m in metrics}
        a = " ".join(f"{p['name']}={p['value']}" for p in t["parameterAssignments"])
        wall = (t["completionTime"] - t["startTime"]) if t["startTime"] else float("nan")
        log(f"{phase}:   {t['name']} {t['condition']} ({t['conditions'][-1]['reason']}: {t['message'][:80]!r}) "
            f"{a} wall={wall:.2f}s {values[t['name']]}")
    return values


def run_trial_conditions(torch) -> None:
    doc = _command_example(os.path.join("examples", "trial-conditions.json"))
    rc, wall, record, _ = _run_cli(torch, doc, "command-conditions-", 300)
    status, trials = record["experiment"]["status"], record["trials"]
    log(f"command: examples/trial-conditions.json through the port's CLI: rc {rc}, {status['condition']} "
        f"({status['reason']}), {status['trialsSucceeded']} succeeded, {status['trialsFailed']} failed of "
        f"{len(trials)}, experiment wall {wall:.1f}s")
    _trial_lines("command", record, ["score"])
    diverged = [t for t in trials if float(t["parameterAssignments"][0]["value"]) > 0.3]
    if len(diverged) >= doc["maxFailedTrialCount"]:
        check(status["reason"] == "ExperimentMaxFailedTrialsReached", "trial-conditions.json: wrong end")
    else:
        check(rc == 0 and status["reason"] == "ExperimentMaxTrialsReached" and len(trials) == doc["maxTrialCount"],
              "examples/trial-conditions.json did not run its trials to MaxTrialsReached")
    for t in trials:
        lr = float(t["parameterAssignments"][0]["value"])
        if lr > 0.3:
            check(t["condition"] == "Failed" and t["message"] == "failure condition met: 'LOSS DIVERGED' in stdout",
                  f"trial {t['name']} (lr {lr}) was not failed by its failure condition: {t['message']}")
        else:
            scores = [float(v) for _, m, v in record["logs"][t["name"]] if m == "score"]
            check(t["condition"] == "Succeeded" and scores == [1 - (lr - 0.05) ** 2],
                  f"trial {t['name']} (lr {lr}): {t['condition']}, score {scores}, not 1 - (lr - 0.05) ** 2")
    log(f"command: trial-conditions.json: {len(diverged)} trials above lr 0.3 Failed by the failure condition, "
        f"{len(trials) - len(diverged)} Succeeded with score 1 - (lr - 0.05) ** 2 exactly")


def run_pytorch_subprocess(torch) -> None:
    doc = _command_example(os.path.join("examples", "pytorch-subprocess.json"))
    epochs = int(doc["trialTemplate"]["command"][doc["trialTemplate"]["command"].index("--epochs") + 1])
    rc, wall, record, _ = _run_cli(torch, doc, "command-pytorch-", 600)
    status, trials = record["experiment"]["status"], record["trials"]
    ran = [t for t in trials if t["condition"] == "Succeeded"]
    log(f"command: examples/pytorch-subprocess.json through the port's CLI: rc {rc}, {status['condition']} "
        f"({status['reason']}), {len(ran)} of {len(trials)} trials ran and succeeded, experiment wall {wall:.1f}s")
    values = _trial_lines("command", record, ["accuracy", "loss"])
    check(rc == 0 and ran, "examples/pytorch-subprocess.json did not succeed")
    for t in ran:
        check(all(len(v) == epochs and all(math.isfinite(x) for x in v) for v in values[t["name"]].values()),
              f"trial {t['name']}: {values[t['name']]} is not {epochs} finite values of accuracy and loss")
        check(not os.path.exists(os.path.join(record["root"], doc["name"], t["name"])),
              f"retain: false, but Succeeded trial {t['name']}'s directory is still there")
    best = max(max(values[t["name"]]["accuracy"]) for t in ran)
    if best >= doc["objective"]["goal"]:
        check(status["reason"] == "ExperimentGoalReached"
              and all(t["condition"] == "Killed" for t in trials if t not in ran),
              "pytorch-subprocess.json reached its goal, but did not end by it")
    else:
        check(status["reason"] == "ExperimentMaxTrialsReached" and len(ran) == doc["maxTrialCount"],
              "pytorch-subprocess.json did not run every trial")


def run_mnist_command(torch) -> None:
    """mnist-command-h100.json through the CLI, then each trial's assignments
    in-process through the entryPoint path on cuda:0, under the flags the
    child runs with: the per-epoch metrics must agree bit for bit."""
    import struct

    from katib_tpu_torch.api.spec import TrialTemplate
    from katib_tpu_torch.controller.experiment import resolve_entry_point
    from katib_tpu_torch.db.store import InMemoryObservationStore
    from katib_tpu_torch.runtime.context import TrialContext
    from katib_tpu_torch.runtime.metrics import MetricsReporter

    doc = _command_example(os.path.join("katib_tpu_torch", "examples", "mnist-command-h100.json"))
    rc, wall, record, _ = _run_cli(torch, doc, "command-mnist-", 600)
    status, trials = record["experiment"]["status"], record["trials"]
    log(f"command: katib_tpu_torch/examples/mnist-command-h100.json through the port's CLI on the card: rc {rc}, "
        f"{status['condition']} ({status['reason']}), {status['trialsSucceeded']}/{len(trials)} succeeded, "
        f"experiment wall {wall:.1f}s")
    children = _trial_lines("command", record, ["loss", "accuracy"])
    check(rc == 0 and len(trials) == doc["maxTrialCount"] and all(t["condition"] == "Succeeded" for t in trials),
          "not every MNIST command trial succeeded")
    fn = resolve_entry_point(TrialTemplate(entry_point="katib_tpu.models.mnist_cnn:run_mnist_trial"))
    worst = 0.0
    for t in trials:
        assignments = {p["name"]: p["value"] for p in t["parameterAssignments"]}
        assignments["num_epochs"] = doc["trialTemplate"]["command"][-1]
        store = InMemoryObservationStore()
        ctx = TrialContext(trial_name=t["name"], experiment_name="in-process", assignments=assignments,
                           reporter=MetricsReporter(store, t["name"]), devices=[torch.device("cuda", 0)])
        with torch_default_tf32(torch), deterministic_cudnn(torch):
            t0 = time.perf_counter()
            fn(assignments, ctx)
            torch.cuda.synchronize()
            in_process = time.perf_counter() - t0
        ours = {m: [float(r.value) for r in store.get_observation_log(t["name"], m)] for m in ("loss", "accuracy")}
        theirs = children[t["name"]]
        same = all(len(ours[m]) == len(theirs[m]) and all(struct.pack("<d", a) == struct.pack("<d", b)
                                                          for a, b in zip(ours[m], theirs[m])) for m in ours)
        diff = max((abs(a - b) for m in ours for a, b in zip(ours[m], theirs[m])), default=float("nan"))
        worst = max(worst, diff)
        child_wall = t["completionTime"] - t["startTime"]
        log(f"command:   {t['name']} child {theirs} | in-process {ours} | bit for bit equal: {same} "
            f"(largest difference {diff:.3e}); wall: child {child_wall:.2f}s, in-process {in_process:.2f}s, "
            f"process cost {child_wall - in_process:.2f}s")
        check(all(len(ours[m]) == len(theirs[m]) == int(assignments["num_epochs"]) for m in ours),
              f"trial {t['name']}: the child and the in-process trial reported different numbers of epochs")
        check(same or diff <= MNIST_TOL, f"trial {t['name']}: the child's metrics differ from the in-process "
              f"trial's by {diff:.3e} > MNIST_TOL {MNIST_TOL}")
    log(f"command: MNIST command trials against in-process: largest difference {worst:.3e} (MNIST_TOL {MNIST_TOL})")
    process_cost(torch)


_PROCESS_COST = """
import json, sys, time
t = [time.time()]
import torch
t.append(time.time())
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t.append(time.time())
from katib_tpu_torch.models import mnist_cnn
from katib_tpu_torch.utils.datasets import load_mnist, split_on_device
t.append(time.time())
x, y = split_on_device(load_mnist, "train", None, torch.device("cuda"))
split_on_device(load_mnist, "test", None, torch.device("cuda"))
torch.cuda.synchronize()
t.append(time.time())
torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
step = mnist_cnn.make_mnist_train_step(mnist_cnn.MnistCNN().to("cuda"), 0.01, 0.5)
float(step(x[:64], y[:64]))
t.append(time.time())
float(step(x[64:128], y[64:128]))
t.append(time.time())
print(json.dumps(t))
"""


def process_cost(torch) -> None:
    """Where a command trial's process cost goes: one child that does what
    mnist_trial.py does before its first epoch, each part stamped."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="0",
               PYTHONPATH=os.pathsep.join([os.getcwd(), os.environ.get("PYTHONPATH", "")]))
    t0 = time.time()
    out = subprocess.run([sys.executable, "-c", _PROCESS_COST], capture_output=True, text=True, env=env,
                         timeout=300)
    end = time.time()
    check(out.returncode == 0, f"the process-cost child failed:\n{out.stderr[-2000:]}")
    t = json.loads(out.stdout.strip().splitlines()[-1])
    parts = {"interpreter start": t[0] - t0, "import torch": t[1] - t[0], "CUDA context": t[2] - t[1],
             "import the port's MNIST trial": t[3] - t[2], "MNIST data made and on the card": t[4] - t[3],
             "first step (cuDNN, kernels)": t[5] - t[4], "second step": t[6] - t[5], "exit": end - t[6]}
    log(f"command: a command trial's process cost, one child on cuda:0: {end - t0:.2f}s in all; "
        + ", ".join(f"{k} {v:.2f}s" for k, v in parts.items()))


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
              "mnist": lambda: phase_mnist(torch), "suggest": lambda: phase_suggest(torch),
              "search": lambda: phase_search(torch), "darts": lambda: phase_darts(torch),
              "enas": lambda: phase_enas(torch), "command": lambda: phase_command(torch)}
    try:
        for phase, run in phases.items():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            log(f"phase {phase}: done in {time.perf_counter() - t0:.1f}s")
        import pkgutil

        walked = [module.name for module in pkgutil.walk_packages(katib_tpu_torch.__path__, "katib_tpu_torch.")]
        for name in walked:
            __import__(name)
        check(set(COMMAND_MODULES) <= set(walked), f"the import scan missed {set(COMMAND_MODULES) - set(walked)}")
        leaked = sorted(m for m in sys.modules if m.split(".")[0] in JAX_MODULES)
        log(f"imports: every module of the port imported ({len(walked)}, the command-trial modules among them); "
            f"modules of JAX or of the JAX package loaded: "
            f"{leaked or 'none'}")
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
