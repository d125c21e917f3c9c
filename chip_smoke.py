#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (katib_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, all of them on every run, each fatal on failure:

1. build   — compile the flash-attention kernels from katib_tpu_torch/ops/csrc
             (one nvcc per source, in parallel) and print the build seconds;
2. kernels — hold K1 (fwd), K2 (dq) and K3 (dkv) against their plain PyTorch
             versions on the card: at the LM's shape (B=4, T=2048, H=16,
             D=64, bf16, causal), at a ragged T, non-causal, in f32 and at the
             other head dims, element by element (see TOL); and a small model
             on the card against the same model on the CPU;
3. e2e     — run katib_tpu_torch/examples/lm-h100.json (3 TPE trials of the
             full-width transformer LM, 10 AdamW steps each) through the
             port's controller on cuda:0, with the launch counters set to 0
             just before and read just after;
4. times   — each kernel, its plain version and scaled_dot_product_attention
             (a yardstick the port never calls) at the LM's shape with CUDA
             events; the train step's ms and tokens/s; a profiler breakdown
             of two train steps.

The last lines are the kernels' JSON record, the card's name and power
limit, and {"ok": true, "device": {...}}. Without a CUDA device, or without
the katib_tpu_torch package beside this script, it exits non-zero and prints
no result.
"""

from __future__ import annotations

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
REPLACES = {
    "fwd": ("katib_tpu_torch/ops/csrc/flash_fwd.cu", "katib_tpu/ops/flash_attention.py:74"),
    "dq": ("katib_tpu_torch/ops/csrc/flash_bwd.cu", "katib_tpu/ops/flash_attention.py:199"),
    "dkv": ("katib_tpu_torch/ops/csrc/flash_bwd.cu", "katib_tpu/ops/flash_attention.py:232"),
}
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
    log(f"build: {time.perf_counter() - t0:.1f}s wall for {len(libs)} libraries")
    for src, path in libs.items():
        secs = _build.BUILD_SECONDS.get(src)
        log(f"build: {src} -> {os.path.basename(path)} "
            f"({'cached' if secs is None else f'{secs:.1f}s nvcc'})")
        report = path.with_name(path.name + ".log")
        if report.exists():
            for line in ptxas_summary(report.read_text()):
                log(f"  ptxas: {line}")


def ptxas_summary(text: str):
    """One line per kernel instance: registers and spills from -Xptxas -v."""
    import re

    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '\w*?katib_flash\d+(\w+?)I(13__nv_bfloat16|f)Li(\d+)E", line)
        if m:
            name, spill = f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}, D={m.group(3)}>", ""
        elif "spill" in line and name:
            spill = line.split(":", 1)[-1].strip()
        elif "Used" in line and "registers" in line and name:
            yield f"{name}: {line.split(':', 1)[-1].strip()}; {spill}"
            name = None


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def _inputs(torch, b, t, h, d, dtype, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, t, h, d), generator=g, device="cuda", dtype=torch.float32).to(dtype)
            for _ in range(4)]


def _compare(torch, got, ref):
    """(max |got - ref|, the ATOL this pair needs, its limit) under TOL."""
    check(bool(torch.isfinite(got).all()), "kernel output has non-finite values")
    atol, rtol = TOL[str(ref.dtype).replace("torch.", "")]
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    need = float((err - rtol * ref.abs()).max() / ref.pow(2).mean().sqrt())
    return float(err.max()), need, atol


def compare_case(torch, b, t, h, d, dtype, causal):
    """K1, K2 and K3 against their plain versions on one set of inputs, output
    by output; logs every comparison, then raises if any exceeds TOL. Returns
    each kernel's max abs error."""
    from katib_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _inputs(torch, b, t, h, d, dtype)
    scale = 1.0 / math.sqrt(d)
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
    label = f"B={b} T={t} H={h} D={d} {str(dtype).replace('torch.', '')} causal={causal}"
    errs, failed = {}, []
    for name, outputs in pairs.items():
        for out, (got, ref) in outputs.items():
            err, need, atol = _compare(torch, got, ref)
            errs[name] = max(errs.get(name, 0.0), err)
            log(f"kernels: {name:3s} {out:3s} {label}: max_abs_err={err:.3e}, needs ATOL {need:.4f} "
                f"(limit {atol:g}) {'ok' if need <= atol else 'FAIL'}")
            if need > atol:
                failed.append(f"{name}/{out}")
    check(not failed, f"{', '.join(failed)} disagree with the plain versions at {label}")
    return errs


def phase_kernels(torch, record) -> None:
    main = compare_case(torch, **MAIN, dtype=torch.bfloat16, causal=True)
    for name, err in main.items():
        record[name]["max_abs_err"] = err
    compare_case(torch, 2, 1000, 4, 64, torch.bfloat16, True)     # ragged T
    compare_case(torch, 2, 2048, 4, 64, torch.bfloat16, False)    # non-causal
    compare_case(torch, 1, 77, 3, 64, torch.bfloat16, False)      # one ragged tile
    compare_case(torch, 2, 200, 4, 64, torch.float32, True)       # f32, full FMA
    compare_case(torch, 1, 130, 2, 32, torch.float32, False)
    compare_case(torch, 2, 300, 4, 32, torch.bfloat16, True)      # other head dims
    compare_case(torch, 2, 300, 4, 128, torch.bfloat16, True)
    compare_case(torch, 1, 100, 2, 128, torch.float32, True)
    model_check(torch)


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


# ---------------------------------------------------------------------------
# phase 3: the port's main path
# ---------------------------------------------------------------------------

def lm_spec():
    """The main path's spec and its one-value (fixed) assignments."""
    from katib_tpu_torch.api.spec import ExperimentSpec

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "katib_tpu_torch", "examples", "lm-h100.json")
    with open(path) as f:
        spec = ExperimentSpec.from_json(f.read())
    return spec, {p.name: p.feasible_space.list[0] for p in spec.parameters if p.feasible_space.list}


def phase_e2e(torch, record) -> None:
    from katib_tpu_torch.api.status import TrialCondition
    from katib_tpu_torch.controller.experiment import ExperimentController
    from katib_tpu_torch.ops import flash_attention as fa

    spec, fixed = lm_spec()
    trials = spec.max_trial_count
    per_kernel = int(fixed["num_layers"]) * int(fixed["num_steps"]) * trials

    import tempfile

    os.makedirs(OUT_DIR, exist_ok=True)
    root = tempfile.mkdtemp(prefix="katib-smoke-", dir=OUT_DIR)
    ctrl = ExperimentController(root_dir=root)
    try:
        ctrl.create_experiment(spec)
        for key in fa.LAUNCHES:
            fa.LAUNCHES[key] = 0
        t0 = time.perf_counter()
        exp = ctrl.run(spec.name, timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fa.LAUNCHES)
        log(f"e2e: {spec.name}: {exp.status.condition.value} ({exp.status.reason.value}) in {wall:.1f}s; "
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
        for name in fa.LAUNCHES:
            record[name]["launches"] = launches[name]
            check(launches[name] == per_kernel, f"kernel {name} launched {launches[name]} times, expected {per_kernel}")
    finally:
        ctrl.close()


# ---------------------------------------------------------------------------
# phase 4: times
# ---------------------------------------------------------------------------

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
    q, k, v, do = _inputs(torch, b, t, h, d, torch.bfloat16)
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
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa_fwd = cuda_ms(torch, lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
    for name, (kernel, plain, products, reads, writes, rows) in plan.items():
        ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain, iters=5, warmup=1)
        bound_ms, bound_by, flops = bound(b, t, h, d, "bfloat16", True, products, reads, writes, rows)
        record[name].update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                            library_ms=sdpa_fwd if name == "fwd" else None)
        log(f"times: {name}: {ms:.4f} ms (plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms by {bound_by}, "
            f"{flops / ms / 1e9:.1f} TFLOP/s = {100 * bound_ms / ms:.1f}% of bound)")

    qg, kg, vg = (x.detach().clone().requires_grad_(True) for x in (qt, kt, vt))
    dot = do.transpose(1, 2)

    def sdpa_step():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        torch.autograd.grad(out, (qg, kg, vg), dot)

    qf, kf, vf = (x.detach().clone().requires_grad_(True) for x in (q, k, v))

    def flash_step():
        out = fa.flash_attention(qf, kf, vf, causal=True)
        torch.autograd.grad(out, (qf, kf, vf), do)

    log(f"times: fwd+bwd at B={b} T={t} H={h} D={d} bf16 causal: flash kernels "
        f"{cuda_ms(torch, flash_step):.4f} ms, scaled_dot_product_attention {cuda_ms(torch, sdpa_step):.4f} ms "
        f"(yardstick; the port never calls it)")
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

def device_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or f"nvidia-smi gave nothing (rc {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main() -> int:
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
              "e2e": lambda: phase_e2e(torch, record), "times": lambda: phase_times(torch, record)}
    try:
        for phase, run in phases.items():
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            log(f"phase {phase}: done in {time.perf_counter() - t0:.1f}s")
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
