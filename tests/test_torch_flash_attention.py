"""katib_tpu_torch.ops.flash_attention against the JAX package's flash
attention, on the CPU; and the port's CPU path run as a user runs it.

On CPU tensors the port's wrappers run the plain PyTorch versions of the
three CUDA kernels (K1 fwd, K2 dq, K3 dkv) through the same autograd
Function the card uses. They are held to the Pallas kernels run in interpret
mode (forward and ``jax.vjp``), and to JAX's dense attention at ragged
lengths, in bf16 and with a custom scale. Tolerances are those of
tests/test_ops_pallas.py: forward 1e-5, gradients 1e-4, bf16 3e-2. The CUDA
kernels themselves are checked against the plain versions on the card by
chip_smoke.py.

A fresh interpreter runs a small LM experiment through the port's CLI on
the CPU and reports what it loaded: no JAX, no katib_tpu, no triton, no
kernel library, no kernel launch. It runs beside this module's JAX work,
which takes about as long as its start-up, and is read by the last tests.
"""

import ctypes
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.ops.flash_attention import flash_attention as jax_flash_attention
from katib_tpu.ops.ring_attention import dense_attention as jax_dense_attention
from katib_tpu_torch.ops import _build
from katib_tpu_torch.ops import flash_attention as fa
from katib_tpu_torch.ops.ring_attention import dense_attention

CSRC = Path(fa.__file__).resolve().parent / "csrc"
REPO = Path(__file__).resolve().parents[1]

TINY = {"vocab_size": "512", "embed_dim": "32", "num_layers": "2", "num_heads": "2",
        "seq_len": "16", "batch_size": "2", "num_steps": "1"}
_CPU_RUN = textwrap.dedent(
    """
    import json, os, sys
    from katib_tpu_torch import cli
    from katib_tpu_torch.ops import _build, flash_attention
    rc = cli.main(["run", sys.argv[1], "--root", sys.argv[2], "--device", "cpu", "--timeout", "120"])
    print(json.dumps({
        "rc": rc,
        "leaked": sorted(m for m in sys.modules
                         if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "katib_tpu", "triton")),
        "loaded": sorted(_build._loaded), "launches": flash_attention.LAUNCHES,
        "routes": flash_attention.ROUTES,
    }), flush=True)
    os._exit(0)  # the result is out; skip the interpreter's teardown
    """
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX compiles and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def cli_run(tmp_path_factory):
    """Starts the CLI run in a fresh interpreter before this module's first
    test; calling the fixture's value waits for its result."""
    root = tmp_path_factory.mktemp("cli-run")
    doc = json.loads((REPO / "katib_tpu_torch" / "examples" / "lm-h100.json").read_text())
    for p in doc["parameters"]:
        if p["name"] in TINY:
            p["feasibleSpace"]["list"] = [TINY[p["name"]]]
    doc.update(name="lm-tiny", maxTrialCount=1, maxFailedTrialCount=1)
    (root / "lm-tiny.json").write_text(json.dumps(doc))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _CPU_RUN, str(root / "lm-tiny.json"), str(root)],
                            cwd=str(REPO), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def read():
        if not result:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err
            result.update(json.loads(out.strip().splitlines()[-1]), stdout=out)
        return result

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


def _arrays(b=2, t=128, h=4, d=16, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, t, h, d)).astype(np.float32) for _ in range(n)]


def _port(x, requires_grad=False, dtype=torch.float32):
    return torch.tensor(x, dtype=dtype, requires_grad=requires_grad)


# -- against the Pallas kernels in interpret mode (two interpret calls) ------

@pytest.fixture(scope="module")
def interpret_refs():
    """JAX interpret-mode (o, dq, dk, dv) by causal flag: both interpret
    calls traced and compiled as one program."""

    @jax.jit
    def refs(q, k, v, do):
        out = {}
        for causal in (False, True):
            o, vjp = jax.vjp(
                lambda q, k, v: jax_flash_attention(q, k, v, causal=causal, block_q=64, block_k=64,
                                                    interpret=True),
                q, k, v,
            )
            out[causal] = (o, *vjp(do))
        return out

    return {c: [np.asarray(x) for x in r] for c, r in refs(*_arrays()).items()}


@pytest.fixture(params=[False, True], ids=["full", "causal"])
def interpret_pair(request, interpret_refs):
    """(JAX interpret-mode o, dq, dk, dv) and the port's, same inputs."""
    causal = request.param
    q, k, v, do = _arrays()
    tq, tk, tv = (_port(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_port(do))
    return interpret_refs[causal], [out.detach().numpy(), tq.grad.numpy(), tk.grad.numpy(), tv.grad.numpy()]


def test_forward_matches_pallas_interpret(interpret_pair):
    ref, got = interpret_pair
    np.testing.assert_allclose(got[0], ref[0], atol=1e-5)


@pytest.mark.parametrize("which", [1, 2, 3], ids=["dq", "dk", "dv"])
def test_gradients_match_pallas_interpret(interpret_pair, which):
    ref, got = interpret_pair
    np.testing.assert_allclose(got[which], ref[which], atol=1e-4)


# -- against JAX's dense attention --------------------------------------------

_jax_dense = jax.jit(jax_dense_attention, static_argnums=3)


@jax.jit
def _jax_dense_vjp(q, k, v, do):
    """JAX's dense attention and its vjp, by causal flag, in one program."""
    out = {}
    for causal in (False, True):
        o, vjp = jax.vjp(lambda q, k, v: jax_dense_attention(q, k, v, causal=causal), q, k, v)
        out[causal] = (o, vjp(do))
    return out


@pytest.mark.parametrize("t", [130])
@pytest.mark.parametrize("causal", [False, True])
def test_ragged_lengths_match_jax_dense(t, causal):
    q, k, v, do = _arrays(t=t, seed=t)
    ref, ref_grads = _jax_dense_vjp(q, k, v, do)[causal]
    tq, tk, tv = (_port(x, requires_grad=True) for x in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=causal)
    out.backward(_port(do))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), atol=1e-5)
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref_grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_bfloat16_matches_jax_dense():
    q, k, v = _arrays(n=3)
    ref = _jax_dense(*(jnp.asarray(x, dtype=jnp.bfloat16) for x in (q, k, v)), True)
    out = fa.flash_attention(*(_port(x, dtype=torch.bfloat16) for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), np.asarray(ref, dtype=np.float32), atol=3e-2)


def test_custom_scale_matches_jax():
    """sm_scale multiplies the scores: flash(q, sm_scale=s) is JAX's dense
    attention (scale 1/sqrt(d)) of q * s * sqrt(d)."""
    q, k, v, do = _arrays(t=130, seed=130)
    ref, _ = _jax_dense_vjp(q * np.float32(0.3 * math.sqrt(16)), k, v, do)[True]  # the ragged test's program
    out = fa.flash_attention(*(_port(x) for x in (q, k, v)), causal=True, sm_scale=0.3)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_reference_matches_jax(causal):
    q, k, v, do = _arrays(t=130, seed=130)  # the ragged test's shape: its compiled program
    ref, _ = _jax_dense_vjp(q, k, v, do)[causal]
    np.testing.assert_allclose(dense_attention(*(_port(x) for x in (q, k, v)), causal=causal).numpy(),
                               np.asarray(ref), atol=1e-5)


# -- the plain versions' own contracts -----------------------------------------

def test_forward_lse_is_row_logsumexp():
    q, k, v = (_port(x) for x in _arrays(t=70, n=3))
    _, lse = fa.fwd_plain(q, k, v, True, 0.25)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * 0.25
    s = s.masked_fill(~torch.ones(70, 70, dtype=torch.bool).tril(), fa.NEG_INF)
    assert lse.shape == (2, 4, 70) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), torch.logsumexp(s, dim=-1).numpy(), atol=1e-5, rtol=0)


def test_backward_kernels_take_lse_and_delta_as_inputs():
    """K2/K3 recompute P from the lse they are given (the ring backward
    feeds a global lse), so a shifted lse scales every gradient term."""
    q, k, v, do = (_port(x) for x in _arrays(t=40))
    o, lse = fa.fwd_plain(q, k, v, True, 0.25)
    delta = fa.attention_delta(o, do)
    dq = fa.bwd_dq_plain(q, k, v, do, lse, delta, True, 0.25)
    dq_shift = fa.bwd_dq_plain(q, k, v, do, lse + math.log(2.0), delta, True, 0.25)
    np.testing.assert_allclose(dq_shift.numpy(), (dq / 2).numpy(), atol=1e-6, rtol=1e-5)
    dk, dv = fa.bwd_dkv_plain(q, k, v, do, lse + math.log(2.0), delta, True, 0.25)
    dk_ref, dv_ref = fa.bwd_dkv_plain(q, k, v, do, lse, delta, True, 0.25)
    np.testing.assert_allclose(dv.numpy(), (dv_ref / 2).numpy(), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(dk.numpy(), (dk_ref / 2).numpy(), atol=1e-6, rtol=1e-5)


def test_delta_is_rowsum_of_o_times_do():
    o, do = (_port(x) for x in _arrays(n=2))
    delta = fa.attention_delta(o, do)
    assert delta.shape == (2, 4, 128) and delta.is_contiguous()
    np.testing.assert_allclose(delta.numpy(), (o * do).sum(-1).transpose(1, 2).numpy(), rtol=1e-6)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [16, 96])
def test_padded_head_dim_equals_the_unpadded_plain_path(d, causal):
    """A head dim outside HEAD_DIMS runs at the next one up on the card:
    q, k, v and dO padded with zero columns, the true D's scale, the outputs
    sliced back. The padded plain path gives the unpadded one's O, lse, dQ,
    dK and dV, and the padded columns of each output are 0."""
    assert fa.padded_head_dim(d) == {16: 32, 96: 128}[d]
    q, k, v, do = (_port(x) for x in _arrays(t=40, d=d))
    scale = 1.0 / math.sqrt(d)
    o, lse = fa.fwd_plain(q, k, v, causal, scale)
    delta = fa.attention_delta(o, do)
    want = {"fwd": (o, lse), "dq": fa.bwd_dq_plain(q, k, v, do, lse, delta, causal, scale),
            "dkv": fa.bwd_dkv_plain(q, k, v, do, lse, delta, causal, scale)}
    got = {"fwd": fa.head_dim_padded(fa.fwd_plain, 3, q, k, v, causal, scale),
           "dq": fa.head_dim_padded(fa.bwd_dq_plain, 4, q, k, v, do, lse, delta, causal, scale),
           "dkv": fa.head_dim_padded(fa.bwd_dkv_plain, 4, q, k, v, do, lse, delta, causal, scale)}
    for name in want:
        for g, w in zip(*(x if isinstance(x, tuple) else (x,) for x in (got[name], want[name]))):
            assert g.shape == w.shape
            torch.testing.assert_close(g, w, atol=1e-5, rtol=1e-5)
    qp, kp, vp, dop = (torch.nn.functional.pad(x, (0, fa.padded_head_dim(d) - d)) for x in (q, k, v, do))
    for out in (fa.fwd_plain(qp, kp, vp, causal, scale)[0], fa.bwd_dq_plain(qp, kp, vp, dop, lse, delta, causal, scale),
                *fa.bwd_dkv_plain(qp, kp, vp, dop, lse, delta, causal, scale)):
        assert not out[..., d:].any()
    for dtype in (torch.bfloat16, torch.float32):
        assert fa.route("fwd", dtype, d) == ("sm90" if dtype == torch.bfloat16 else "mma")


def test_head_dims_above_128_are_refused_on_the_card():
    assert fa.padded_head_dim(256) == 256 and fa.route("fwd", torch.bfloat16, 256) == "mma"
    q = torch.zeros((1, 8, 2, 256))
    with pytest.raises(ValueError, match="head_dim"):
        fa.head_dim_padded(lambda *xs: fa._check(*xs[:3]), 3, q, q, q)


def test_cpu_tensors_launch_no_kernel():
    before, routes = dict(fa.LAUNCHES), dict(fa.ROUTES)
    q, k, v = (_port(x, requires_grad=True) for x in _arrays(t=32, n=3))
    fa.flash_attention(q, k, v, causal=True).sum().backward()
    assert fa.LAUNCHES == before and fa.ROUTES == routes
    assert not _build._loaded


def test_other_devices_raise_instead_of_falling_back():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(RuntimeError, match="CUDA or CPU"):
        fa.flash_fwd(q, q, q, True, 0.125)


def test_kernel_operand_checks():
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="head_dim"):
        fa._check(q, q, q)
    h = torch.zeros((1, 8, 2, 64), dtype=torch.float16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa._check(h, h, h)
    with pytest.raises(ValueError, match="differ"):
        fa._check(torch.zeros((1, 8, 2, 64)), torch.zeros((1, 9, 2, 64)))
    assert fa._check(torch.zeros((3, 8, 2, 64), dtype=torch.bfloat16)) == (1, 64, 3, 8, 2)


def test_strided_views_reach_the_kernel_without_a_copy():
    qkv = torch.zeros((2, 10, 3, 4, 64), dtype=torch.bfloat16)
    v = qkv[:, :, 2]
    assert fa._operand(v) is v  # the model's v slice is read in place
    assert fa._view(v)[1:] == [10 * 3 * 4 * 64, 3 * 4 * 64, 64]
    transposed = torch.zeros((2, 4, 10, 64)).transpose(1, 2)
    assert fa._operand(transposed) is transposed  # D stays contiguous
    odd = torch.zeros((2, 10, 4, 65))[..., :64]
    assert fa._operand(odd).is_contiguous()  # rows off a 16-byte boundary are copied


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke.py as a module (it imports torch only inside its phases)."""
    loader = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module


def test_smoke_check_passes_bf16_rounding_and_fails_a_dropped_tile(smoke):
    """chip_smoke.py's kernel check, on the CPU: an O made as the bf16
    kernels make it (P rounded to bf16 before P V) passes, and an O with one
    64-key tile missing from the late rows fails, at B 1, T 1024, H 2, D 64."""
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 1024, 2, 64), generator=g).to(torch.bfloat16) for _ in range(3))
    o_ref, lse = fa.fwd_plain(q, k, v, True, 0.125)
    p = torch.exp(fa._scores(q, k, True, 0.125) - lse.unsqueeze(-1))
    rounded = torch.einsum("bhqk,bkhd->bqhd", p.to(torch.bfloat16).float(), v.float()).to(torch.bfloat16)
    keep = torch.ones((1024, 1024))
    keep[512:, 64:128] = 0
    dropped = torch.einsum("bhqk,bkhd->bqhd", p * keep, v.float()).to(torch.bfloat16)
    _, need, atol = smoke._compare(torch, rounded, o_ref)
    assert need < atol / 2
    _, need, atol = smoke._compare(torch, dropped, o_ref)
    assert need > 10 * atol


def test_smoke_check_holds_an_all_zero_reference_exactly(smoke):
    """At softmax scale 0, dQ and dK are exactly zero: chip_smoke.py's check
    then passes an exact result and fails any other, instead of 0/0."""
    zero = torch.zeros((2, 8, 2, 64), dtype=torch.bfloat16)
    _, need, atol = smoke._compare(torch, zero.clone(), zero)
    assert need == 0.0 <= atol
    off = zero.clone()
    off[0, 0, 0, 0] = 2.0 ** -20
    _, need, atol = smoke._compare(torch, off, zero)
    assert need == math.inf and not need <= atol


def _ptxas_entry(mangled, registers, spill_bytes=0):
    return (f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'\n"
            f"ptxas info    : Function properties for {mangled}\n"
            f"    0 bytes stack frame, {spill_bytes} bytes spill stores, {spill_bytes} bytes spill loads\n"
            f"ptxas info    : Used {registers} registers, used 1 barriers, 40 bytes smem, 1040 bytes cmem[0]\n")


# -Xptxas -v as nvcc prints it for flash_bwd_dq_sm90.cu, and for one mma.sync kernel.
_DQ_SM90_LOG = "ptxas info    : 0 bytes gmem\n" + "".join(
    _ptxas_entry(f"_ZN11katib_flash4sm9024flash_bwd_dq_sm90_kernelILi{d}EEEvNS0_8DqParamsE", regs, spill)
    for d, regs, spill in ((32, 90, 0), (64, 128, 0), (128, 168, 8)))
_MMA_LOG = _ptxas_entry("_ZN11katib_flash19flash_bwd_dq_kernelI13__nv_bfloat16Li64EEEvNS_9BwdParamsE", 134)
_SERIALISED = ("ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are "
               "serialized due to non wgmma instructions defining accumulator registers of a wgmma between "
               "start and end of the pipeline stage in the function "
               "'_ZN11katib_flash4sm9024flash_bwd_dq_sm90_kernelILi64EEEvNS0_8DqParamsE'\n")


def test_smoke_ptxas_summary_names_the_dq_kernel_at_every_head_dim(smoke):
    lines = list(smoke.ptxas_summary(_DQ_SM90_LOG + _MMA_LOG))
    assert [line.split(":")[0] for line in lines] == [
        "flash_bwd_dq_sm90_kernel<bf16, D=32>", "flash_bwd_dq_sm90_kernel<bf16, D=64>",
        "flash_bwd_dq_sm90_kernel<bf16, D=128>", "flash_bwd_dq_kernel<bf16, D=64>"]
    assert "Used 90 registers" in lines[0] and "0 bytes spill stores" in lines[0]
    assert "Used 168 registers" in lines[2] and "8 bytes spill stores" in lines[2]
    assert smoke.serialised_wgmma(_DQ_SM90_LOG) == []
    assert smoke.serialised_wgmma(_DQ_SM90_LOG + _SERIALISED) == [_SERIALISED.split(":", 1)[1].strip()]


@pytest.mark.parametrize("source,fatal", [("flash_bwd_dq_sm90.cu", True), ("flash_fwd_sm90.cu", True),
                                          ("flash_bwd.cu", False)])
def test_smoke_build_fails_on_serialised_wgmma_in_an_sm90_kernel(smoke, monkeypatch, tmp_path, capsys,
                                                                 source, fatal):
    """chip_smoke.py's build phase on canned ptxas logs: a clean build
    passes; a "Performance Loss" line fails it when it comes from an sm90
    source, and is printed only for the other sources."""
    libs = {src: tmp_path / f"lib{Path(src).stem}-0.so" for src in (source, "flash_fwd.cu")}
    monkeypatch.setattr(_build, "build", lambda: libs)
    for lib in libs.values():
        lib.with_name(lib.name + ".log").write_text(_DQ_SM90_LOG)
    smoke.phase_build(torch)
    assert "ptxas: flash_bwd_dq_sm90_kernel<bf16, D=128>" in capsys.readouterr().out
    log = libs[source].with_name(libs[source].name + ".log")
    log.write_text(_DQ_SM90_LOG + _SERIALISED)
    if fatal:
        with pytest.raises(smoke.SmokeFailure, match="serialised the wgmma"):
            smoke.phase_build(torch)
    else:
        smoke.phase_build(torch)
    assert "ptxas WARNING: (C7515) Potential Performance Loss" in capsys.readouterr().out


# -- the CUDA sources and their binding (compiled on the card only) ------------

def _c_params(name):
    text = "".join((CSRC / src).read_text() for src in _build.SOURCES)
    m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text, re.S)
    assert m, name
    return [p.strip() for p in m.group(1).split(",")]


@pytest.mark.parametrize("name", sorted(fa._ARGTYPES))
def test_ctypes_signatures_match_the_c_interface(name):
    params = _c_params(name)
    argtypes = fa._ARGTYPES[name]
    assert len(params) == len(argtypes)
    for param, ctype in zip(params, argtypes):
        if "*" in param:
            assert ctype is fa._P, param  # pointers and the stream as c_void_p
        elif param.startswith("long long"):
            assert ctype is fa._L, param
        elif param.startswith("float"):
            assert ctype is ctypes.c_float, param
        else:
            assert ctype is fa._I, param


def test_sources_target_sm90a_and_carry_notes():
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    fwd = (CSRC / "flash_fwd.cu").read_text()
    bwd = (CSRC / "flash_bwd.cu").read_text()
    assert "::_fwd_kernel" in fwd and "Bound on this card" in fwd
    assert "::_bwd_dq_kernel" in bwd and "::_bwd_dkv_kernel" in bwd and "Bound on this card" in bwd
    assert "mma.sync.aligned.m16n8k16" in (CSRC / "flash_common.cuh").read_text()


@pytest.mark.parametrize("head_dim", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("kernel", ["fwd", "dq", "dkv"])
def test_route_table(kernel, dtype, head_dim):
    """The route follows dtype and head dim alone: bf16 K1, K2 and K3 take
    the wgmma/TMA kernels at every head dim; f32 (no TF32) stays on the FMA
    kernels. Each route names an entry point of its own source."""
    design = fa.route(kernel, dtype, head_dim)
    want = "sm90" if dtype == torch.bfloat16 else "mma"
    assert design == want
    entry = fa._ENTRY[kernel, design]
    assert entry.endswith("_sm90") == (design == "sm90")
    source = fa._SOURCE[entry]
    assert source in _build.SOURCES
    assert re.search(r'extern "C" int ' + entry + r"\(", (CSRC / source).read_text())
    assert f"{kernel}.{design}" in fa.ROUTES


@pytest.mark.parametrize("design", ["mma", "sm90"])
def test_forced_route_moves_k1_k2_and_k3_and_restores(design):
    """Inside forced_route, K1, K2 and K3 take the forced design at every
    dtype and head dim, and the table comes back on exit, also after an
    exception; an unknown design, and an unknown kernel, is refused."""
    table = {(k, dt, d): fa.route(k, dt, d) for k in ("fwd", "dq", "dkv")
             for dt in (torch.bfloat16, torch.float32) for d in fa.HEAD_DIMS}
    assert fa.SM90_KERNELS == ("fwd", "dq", "dkv")
    with pytest.raises(KeyError):
        with fa.forced_route(design):
            for kernel, dtype, head_dim in table:
                assert fa.route(kernel, dtype, head_dim) == design
            raise KeyError("leave the block")
    assert {key: fa.route(*key) for key in table} == table
    with pytest.raises(ValueError):
        with fa.forced_route("tf32"):
            pass
    with pytest.raises(ValueError, match="no kernel"):
        fa.route("bwd", torch.bfloat16, 64)


def _translation_unit(source):
    """A source with the text of the headers it includes, one level deep at a time."""
    text, seen = (CSRC / source).read_text(), set()
    while True:
        headers = set(re.findall(r'#include "(\w+\.cuh)"', text)) - seen
        if not headers:
            return text
        seen |= headers
        text += "".join((CSRC / h).read_text() for h in sorted(headers))


@pytest.mark.parametrize("source,replaces", [("flash_fwd_sm90.cu", "::_fwd_kernel"),
                                             ("flash_bwd_dq_sm90.cu", "::_bwd_dq_kernel"),
                                             ("flash_bwd_dkv_sm90.cu", "::_bwd_dkv_kernel")])
def test_sm90_sources_carry_notes_and_use_wgmma_and_tma(source, replaces):
    text = (CSRC / source).read_text()
    assert replaces in text and "Bound on this card" in text and "Design:" in text
    unit = _translation_unit(source)
    for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor", "mbarrier.try_wait", "mbarrier.arrive.expect_tx"):
        assert ptx in unit, ptx
    assert "cudaGetDriverEntryPoint" in unit and "__grid_constant__" in text  # no -lcuda needed


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
        _build.build()
    assert not list(tmp_path.iterdir())


def test_library_name_follows_the_sources():
    path = _build.library_path("flash_fwd.cu")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libflash_fwd-")
    assert _build.library_path("flash_bwd.cu").name != path.name
    dq = _build.library_path("flash_bwd_dq_sm90.cu")
    assert "flash_bwd_dq_sm90.cu" in _build.SOURCES and dq.name.startswith("libflash_bwd_dq_sm90-")
    assert len({_build.library_path(src).name for src in _build.SOURCES}) == len(_build.SOURCES)


def test_import_builds_and_loads_nothing():
    """Importing the ops (as every test here does) runs no nvcc, loads no
    library and imports no triton: the package names triton nowhere."""
    assert not _build._loaded and not _build.BUILD_SECONDS
    sources = Path(fa.__file__).resolve().parents[1].rglob("*.py")
    assert not [p for p in sources if re.search(r"^\s*(import|from)\s+triton", p.read_text(), re.M)]


# -- the CLI run in a fresh interpreter (read last) ---------------------------

def test_cli_run_succeeds_in_a_fresh_interpreter(cli_run):
    result = cli_run()
    assert result["rc"] == 0 and "Succeeded (ExperimentMaxTrialsReached)" in result["stdout"]


def test_port_run_imports_no_jax(cli_run):
    assert cli_run()["leaked"] == []


def test_cpu_run_builds_and_launches_no_kernel(cli_run):
    result = cli_run()
    assert result["loaded"] == [] and result["launches"] == {"fwd": 0, "dq": 0, "dkv": 0}
    assert not any(result["routes"].values())
