"""The port's DARTS slice against the JAX package, on the CPU.

The same numpy inputs and parameters (drawn by numpy in the flax tree's
shapes, converted with ``darts_params_from_flax``) go through the JAX code
and the port:

- every operation of the search space at strides 1 and 2, StdConv (1x1 and
  3x3) and FactorizedReduce, on an 8x8 input of 4 channels: within 1e-5
  (an even size, so that XLA's asymmetric SAME padding at stride 2 shows);
- the supernet (2 layers, the second a reduction; 2 nodes, 4 channels, the
  8 operations of examples/nas/darts.json): logits within 1e-5, genotype
  equal;
- ``architect_alpha_grad`` in both Hessian modes on the setup of
  tests/test_nas.py (TestDartsSecondOrderExact): within 1e-4 in relative
  norm, that test's tolerance;
- three search steps of each mode against the JAX package's compiled step:
  losses, weights and alphas within 1e-4;
- the derived network (3 layers, so a cell follows a reduction): logits
  within 1e-5, two retraining steps within 1e-4;
- the darts suggester's assignments for examples/nas/darts.json (string
  equal), its refusals of bad settings (same messages), nasConfig's round
  trip, load_cifar10 (bit-identical), and one search epoch's batches and
  validation batches (equal, also for a split smaller than a batch);
- shrunk copies of examples/nas/darts.json and darts-retrain.json through
  the port's CLI, the retraining on the genotype the search printed.
"""

import ast
import contextlib
import io
import json
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from katib_tpu.api import spec as jax_spec
from katib_tpu.models import darts_trainer as jax_trainer
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu.suggest.nas.darts import Darts as JaxDarts
from katib_tpu.utils import datasets as jax_datasets
from katib_tpu_torch import cli
from katib_tpu_torch.api import spec
from katib_tpu_torch.models import darts_derived, darts_supernet, darts_trainer
from katib_tpu_torch.models.convert import darts_params_from_flax
from katib_tpu_torch.ops import darts_ops
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.tools.darts_hvp import double_backward
from katib_tpu_torch.utils import backend, datasets

import darts_jax_references as refs

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
PRIMITIVES = ("separable_convolution_3x3", "separable_convolution_5x5", "dilated_convolution_3x3",
              "dilated_convolution_5x5", "avg_pooling_3x3", "max_pooling_3x3", "skip_connection", "none")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX work and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _draw(port, seed=0, alpha_scale=1e-3):
    """Parameters for ``port`` (a port module) and its flax counterpart,
    drawn by numpy in the port's layout: kernels at lecun scale, biases at
    0.1, alphas at ``alpha_scale``. Returns the flax tree; the port loads it
    back through ``darts_params_from_flax``, its inverse."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, value in port.state_dict().items():
        parts = name.split(".")
        if parts[0] in ("alpha_normal", "alpha_reduce"):
            draw = alpha_scale * rng.standard_normal(value.shape)
            tree[(f"{parts[0]}_{parts[1]}",)] = draw
            continue
        scale = 0.1 if parts[-1] == "bias" else 1 / np.sqrt(value[0].numel())
        draw = scale * rng.standard_normal(value.shape)
        if draw.ndim == 4:
            draw = draw.transpose(2, 3, 1, 0)  # [F, C, kh, kw] -> [kh, kw, C, F]
        elif draw.ndim == 2:
            draw = draw.T
        path = tuple("MatmulConv_0" if p == "conv" else p for p in parts[:-1])
        tree[path + ({"weight": "kernel", "bias": "bias"}[parts[-1]],)] = draw
    params = traverse_util.unflatten_dict({k: v.astype(np.float32) for k, v in tree.items()})
    _port(port, params)
    return params


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


def _port(module, params):
    module.load_state_dict(darts_params_from_flax(params))
    return module


# -- the cases: one JAX program per model shape (tests/darts_jax_references.py) --

OP_CASES = [(name, stride) for name in PRIMITIVES for stride in (1, 2)] + [
    ("std_conv_1x1", 1), ("std_conv_1x1", 2), ("std_conv_3x3", 1), ("std_conv_3x3", 2), ("factorized_reduce", 2)]
OP_INPUT = np.random.default_rng(1).standard_normal((3, 8, 8, 4)).astype(np.float32)


def _port_op(name, stride):
    if name.startswith("std_conv"):
        return darts_ops.StdConv(4, 6, int(name[-1]), stride)
    if name == "factorized_reduce":
        return darts_ops.FactorizedReduce(4, 6)
    return darts_ops.make_op(name, 4, stride)


# the supernet: 2 layers (the second a reduction), 2 nodes, 4 channels,
# darts.json's 8 operations, a batch of 4 8x8 images
SUPERNET = dict(init_channels=4, num_layers=2, num_nodes=2)
SUPERNET_INPUT = np.random.default_rng(2).standard_normal((4, 8, 8, 3)).astype(np.float32)

# the alpha gradient: tests/test_nas.py's setup (TestDartsSecondOrderExact:
# its 3 operations, 2 channels, 2 layers, 1 node, 4 classes, stem multiplier
# 1, batches of 4 8x8 images, a momentum buffer of 0.01)
ARCHITECT_PRIMITIVES = ("max_pooling_3x3", "skip_connection", "separable_convolution_3x3")
ARCHITECT_NET = dict(init_channels=2, num_layers=2, num_nodes=1, num_classes=4, stem_multiplier=1)
ARCHITECT = dict(xi=0.025, w_momentum=0.9, w_weight_decay=3e-4)
# the search steps: the same at 1 layer (the compile time of the JAX step
# triples at 2), over the 'none' the search appends too
SEARCH_PRIMITIVES = ARCHITECT_PRIMITIVES + ("none",)
SEARCH_NET = dict(ARCHITECT_NET, num_layers=1)
SEARCH_STEPS, SCHEDULE = 3, 10  # steps of a cosine schedule over 10


def _search_batches():
    rng = np.random.default_rng(0)
    xt, yt = rng.standard_normal((SEARCH_STEPS, 4, 8, 8, 3)).astype(np.float32), rng.integers(0, 4, (SEARCH_STEPS, 4))
    xv, yv = rng.standard_normal((SEARCH_STEPS, 4, 8, 8, 3)).astype(np.float32), rng.integers(0, 4, (SEARCH_STEPS, 4))
    return (xt, yt.astype(np.int32)), (xv, yv.astype(np.int32))


def _search_setting(mode):
    return darts_trainer.DartsSearch(SEARCH_PRIMITIVES, num_layers=1, num_classes=4, device=CPU, settings={
        "init_channels": 2, "num_nodes": 1, "stem_multiplier": 1, "hessian_mode": mode})


def _search_settings(mode):
    s = _search_setting(mode)
    return {k: getattr(s, k) for k in ("w_lr", "w_lr_min", "w_momentum", "w_weight_decay", "w_grad_clip",
                                       "alpha_lr", "alpha_weight_decay")}


# the derived network: 3 layers (reductions at 1 and 2, so cell 2 follows a
# reduction), 4 channels, two retraining steps on batches of 4 8x8 images
GENE = {"normal": [[("separable_convolution_3x3", 0), ("skip_connection", 1)],
                   [("max_pooling_3x3", 0), ("dilated_convolution_5x5", 2)]],
        "reduce": [[("skip_connection", 0), ("avg_pooling_3x3", 1)],
                   [("separable_convolution_5x5", 1), ("dilated_convolution_3x3", 2)]]}
DERIVED = dict(init_channels=4, num_layers=3)
RETRAIN = dict(lr=0.05, momentum=0.9, weight_decay=3e-4, grad_clip=5.0, total_steps=4)
_rng = np.random.default_rng(6)
DERIVED_INPUT = _rng.standard_normal((8, 8, 8, 3)).astype(np.float32), _rng.integers(0, 10, 8).astype(np.int32)


def _derived_port():
    return darts_derived.DerivedNetwork(darts_derived.gene_from_json(GENE["normal"]),
                                        darts_derived.gene_from_json(GENE["reduce"]), **DERIVED)


@pytest.fixture(scope="module", autouse=True)
def references():
    """Every case's parameters (drawn here) and the JAX package's outputs,
    computed from the module's first test on (the tests that need none come
    first): the training programs in spawned processes (tracing one holds
    the interpreter lock for seconds), the forward passes on threads here
    (XLA compiles without the lock). Each output is a future."""
    (xt, yt), (xv, yv) = _search_batches()
    params = {
        "ops": {f"{n}-{s}": _draw(_port_op(n, s), seed=i) for i, (n, s) in enumerate(OP_CASES)},
        "supernet": _draw(darts_supernet.DartsSupernet(PRIMITIVES, **SUPERNET), seed=3),
        "architect": _draw(darts_supernet.DartsSupernet(ARCHITECT_PRIMITIVES, **ARCHITECT_NET), seed=4),
        "steps": _draw(darts_supernet.DartsSupernet(SEARCH_PRIMITIVES, **SEARCH_NET), seed=5),
        "derived": _draw(_derived_port(), seed=7),
    }
    architect = (ARCHITECT_PRIMITIVES, ARCHITECT_NET)
    first = ((xt[0], yt[0]), (xv[0], yv[0]))
    spawned = {
        "architect-jvp": (refs.architect_grad, *architect, "jvp", ARCHITECT, params["architect"], *first),
        "architect-fd": (refs.architect_grad, *architect, "fd", ARCHITECT, params["architect"], *first),
        "steps-jvp": (refs.search_steps, SEARCH_PRIMITIVES, SEARCH_NET, "jvp", _search_settings("jvp"), SCHEDULE,
                      params["steps"], _search_batches()),
        "steps-fd": (refs.search_steps, SEARCH_PRIMITIVES, SEARCH_NET, "fd", _search_settings("fd"), SCHEDULE,
                     params["steps"], _search_batches()),
        "derived": (refs.derived_outputs, GENE, DERIVED, RETRAIN, params["derived"], *DERIVED_INPUT, 2),
    }
    with ProcessPoolExecutor(len(spawned), mp_context=multiprocessing.get_context("spawn")) as procs, \
            ThreadPoolExecutor(2) as threads:
        futures = {name: procs.submit(*task) for name, task in spawned.items()}
        futures["supernet"] = threads.submit(refs.supernet_outputs, PRIMITIVES, SUPERNET, params["supernet"],
                                             SUPERNET_INPUT)
        futures["ops"] = threads.submit(refs.op_outputs, OP_CASES, 6, params["ops"], OP_INPUT)
        yield params, futures


# -- suggester, spec, data ------------------------------------------------------

def _nas_doc(name="darts", settings=None):
    doc = json.loads((REPO / "examples" / "nas" / f"{name}.json").read_text())
    if settings is not None:
        doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in settings.items()]
    return doc


def _assignments(reply):
    return [[(a.name, a.value) for a in s.parameter_assignments] for s in reply.assignments]


def test_suggestion_matches_jax():
    doc = _nas_doc()
    got = suggest.create("darts").get_suggestions(suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), [], 1))
    want = JaxDarts().get_suggestions(JaxSuggestionRequest(jax_spec.ExperimentSpec.from_dict(doc), [], 1))
    assert _assignments(got) == _assignments(want)
    values = dict(_assignments(got)[0])
    assert values["num-layers"] == "5" and "'" in values["search-space"] and '"' not in values["algorithm-settings"]
    assert json.loads(values["search-space"].replace("'", '"')) == list(PRIMITIVES[:-1])


@pytest.mark.parametrize("settings", [
    {"num_epochs": "0"}, {"w_lr": "-1"}, {"alpha_weight_decay": "-0.1"}, {"batch_size": "0"},
    {"num_workers": "-1"}, {"init_channels": "0"}, {"num_nodes": "0"}, {"hessian_mode": "bogus"},
    {"num_epochs": "three"}, {"hessian_mode": " FD "}, {"hessian_mode": "None"}, {"batch_size": "None"},
])
def test_settings_are_validated_as_jax_validates_them(settings):
    doc = _nas_doc(settings=settings)
    outcomes = []
    for validate, parse in ((suggest.create("darts").validate_algorithm_settings, spec.ExperimentSpec.from_dict),
                            (JaxDarts().validate_algorithm_settings, jax_spec.ExperimentSpec.from_dict)):
        try:
            validate(parse(doc))
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


def test_darts_needs_nas_config():
    doc = dict(_nas_doc(), nasConfig=None)
    with pytest.raises(ValueError, match="requires nasConfig"):
        suggest.create("darts").validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))
    doc = _nas_doc()
    doc["nasConfig"]["operations"] = []
    with pytest.raises(ValueError, match="must not be empty"):
        suggest.create("darts").validate_algorithm_settings(spec.ExperimentSpec.from_dict(doc))


@pytest.mark.parametrize("name", ["darts", "enas"])
def test_nas_config_round_trips_as_the_jax_package_writes_it(name):
    doc = _nas_doc(name)
    ours = spec.ExperimentSpec.from_dict(doc).to_dict()
    theirs = jax_spec.ExperimentSpec.from_dict(doc).to_dict()
    assert ours == {k: theirs[k] for k in ours} and ours["nasConfig"] == theirs["nasConfig"]
    assert spec.ExperimentSpec.from_json(json.dumps(ours)).to_dict() == ours


@pytest.mark.parametrize("split", ["train", "test"])
def test_load_cifar10_is_bit_identical(split):
    want, got = jax_datasets.load_cifar10(split, n=64), datasets.load_cifar10(split, n=64)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert got[0].shape == (64, 32, 32, 3)


@pytest.mark.parametrize("n_train,n_valid,batch_size", [(40, 40, 16), (10, 40, 16), (40, 41, 50)])
def test_epoch_batches_match_jax(n_train, n_valid, batch_size):
    """Two epochs of search and validation, the JAX package's DartsSearch
    and the port's with their steps stubbed, from one default_rng(0) each:
    the same train, valid and validation batches in the same order, and the
    generators left in the same state. Splits smaller than a batch run as
    one batch and draw nothing."""
    y = np.arange(n_train + n_valid, dtype=np.int32)
    x = np.broadcast_to(y[:, None, None, None], (len(y), 2, 2, 1)).astype(np.float32)  # image i is all i
    train, valid = (x[:n_train], y[:n_train]), (x[n_train:], y[n_train:])
    seen = {"jax": [], "port": []}

    theirs = jax_trainer.DartsSearch(("skip_connection",), num_layers=2, settings={"batch_size": batch_size})
    theirs._built, theirs.step_idx = True, 0
    theirs.weights = theirs.alphas = theirs.w_opt_state = theirs.a_opt_state = theirs.hyper = None

    def jax_step(w, a, ws, as_, i, hyper, tb, vb):
        seen["jax"].append(("step", np.asarray(tb[1]).tolist(), np.asarray(vb[1]).tolist()))
        return w, a, ws, as_, jnp.float32(0.0)

    def jax_eval(w, a, batch):
        seen["jax"].append(("validate", np.asarray(batch[1]).tolist()))
        return jnp.float32(0.0)

    theirs._search_step, theirs._eval_step = jax_step, jax_eval

    class Model(torch.nn.Module):
        def forward(self, bx):
            seen["port"].append(("validate", bx[:, 0, 0, 0].long().tolist()))
            return torch.zeros(len(bx), 10)

    def port_step(tb, vb):
        seen["port"].append(("step", tb[1].tolist(), vb[1].tolist()))
        return torch.zeros(())

    ours = darts_trainer.DartsSearch(("skip_connection",), num_layers=2, settings={"batch_size": batch_size},
                                     device=CPU)
    ours.step, ours.model = port_step, Model()
    t_port, v_port = ((_nchw(a), torch.tensor(b, dtype=torch.long)) for a, b in (train, valid))
    r_jax, r_port = np.random.default_rng(0), np.random.default_rng(0)
    for _ in range(2):
        theirs.train_epoch(train, valid, r_jax)
        theirs.validate(valid, r_jax)
        ours.train_epoch(t_port, v_port, r_port)
        ours.validate(v_port, r_port)
    assert seen["port"] == seen["jax"] and len(seen["jax"]) >= 4
    assert r_jax.random() == r_port.random()


# -- the NAS examples through the port's CLI -------------------------------------

SEARCH_CUTS = {  # examples/nas/darts.json, cut for the CPU
    "num_epochs": "1",          # from 3
    "init_channels": "2",       # from 8
    "num_nodes": "2",           # from 3
    "batch_size": "8",          # from 128
    "num_train_examples": "16",  # from 50 000 images: 8 to search on, 8 to validate (one step)
}
SEARCH_LAYERS = 3  # numLayers from 5: reductions at 1 and 2, so cell 2 follows a reduction
RETRAIN_CUTS = {  # examples/darts-retrain.json's fixed settings, cut for the CPU
    "num_epochs": "1", "batch_size": "8", "num_train_examples": "16", "init_channels": "2", "num_layers": "3"}


@pytest.fixture(scope="module")
def nas_examples(tmp_path_factory):
    """The shrunk search through the CLI, then the shrunk retraining (2
    trials) on the genotype it printed; their exit codes, records and
    printed lines."""
    root = tmp_path_factory.mktemp("nas")
    search = _nas_doc()
    search["algorithm"]["algorithmSettings"] = [
        s for s in search["algorithm"]["algorithmSettings"] if s["name"] not in SEARCH_CUTS]
    search["algorithm"]["algorithmSettings"] += [{"name": k, "value": v} for k, v in SEARCH_CUTS.items()]
    search["nasConfig"]["graphConfig"]["numLayers"] = SEARCH_LAYERS
    (root / "search.json").write_text(json.dumps(search))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc_search = cli.main(["run", str(root / "search.json"), "--root", str(root), "--device", "cpu",
                              "--timeout", "120"])
    lines = out.getvalue().splitlines()
    printed = [line.split("=", 1)[1] for line in lines if line.startswith("Best-Genotype=")]
    retrain = _nas_doc("darts-retrain")
    retrain["maxTrialCount"] = 2  # from 8
    for p in retrain["parameters"]:
        if p["name"] == "genotype" and printed:
            p["feasibleSpace"]["list"] = [printed[-1]]
    retrain["parameters"] += [{"name": k, "parameterType": "discrete", "feasibleSpace": {"list": [v]}}
                              for k, v in RETRAIN_CUTS.items()]
    (root / "retrain.json").write_text(json.dumps(retrain))
    with contextlib.redirect_stdout(io.StringIO()):
        rc_retrain = cli.main(["run", str(root / "retrain.json"), "--root", str(root), "--device", "cpu",
                               "--timeout", "120"])
    records = {key: json.loads((root / doc["name"] / "experiment.json").read_text())
               for key, doc in (("search", search), ("retrain", retrain))}
    return {"rcs": {"search": rc_search, "retrain": rc_retrain}, "records": records, "genotypes": printed}


@pytest.mark.parametrize("name", ["search", "retrain"])
def test_nas_example_runs_through_the_port_cli(nas_examples, name):
    record = nas_examples["records"][name]
    status = record["experiment"]["status"]
    assert nas_examples["rcs"][name] == 0, record["trials"]
    assert status["condition"] == "Succeeded" and status["reason"] == "ExperimentMaxTrialsReached"
    trials = record["trials"]
    assert len(trials) == record["experiment"]["spec"]["maxTrialCount"] == {"search": 1, "retrain": 2}[name]
    for t in trials:
        assert t["condition"] == "Succeeded", t.get("message")
        rows = record["logs"][t["name"]]
        assert {m for _, m, _ in rows} == {"Validation-accuracy", "Train-loss"}
        assert all(np.isfinite(float(v)) for _, _, v in rows)


def test_the_printed_genotype_parses(nas_examples):
    """The search printed one Best-Genotype: a Python literal naming only
    operations of the search space, two edges per node in both genes, which
    the retraining ran on."""
    (printed,) = nas_examples["genotypes"]
    gene = ast.literal_eval(printed)
    assert gene["normal_concat"] == gene["reduce_concat"] == [2, 3]
    for key in ("normal", "reduce"):
        assert len(gene[key]) == 2
        for i, node in enumerate(gene[key]):
            assert len(node) == 2 and all(op in PRIMITIVES[:-1] and 0 <= j < 2 + i for op, j in node)
    retrain = nas_examples["records"]["retrain"]["experiment"]["spec"]
    genotypes = next(p for p in retrain["parameters"] if p["name"] == "genotype")["feasibleSpace"]["list"]
    assert genotypes == [printed]


# -- operations ---------------------------------------------------------------

@pytest.mark.parametrize("name,stride", OP_CASES)
def test_operation_matches_flax(references, name, stride):
    params, futures = references
    want = futures["ops"].result()[f"{name}-{stride}"]
    got = _port(_port_op(name, stride), params["ops"][f"{name}-{stride}"])(_nchw(OP_INPUT))
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (3, 8 // stride, 8 // stride, want.shape[-1])
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("size,window,stride,want", [(32, 3, 2, (0, 1)), (32, 5, 2, (1, 2)), (8, 3, 1, (1, 1)),
                                                     (7, 3, 2, (1, 1)), (8, 1, 2, (0, 0))])
def test_same_padding_is_xla_s(size, window, stride, want):
    assert darts_ops.same_padding(size, window, stride) == want


# -- supernet -------------------------------------------------------------------

@pytest.fixture(scope="module")
def supernet(references):
    params, futures = references
    logits, gene = futures["supernet"].result()
    return _port(darts_supernet.DartsSupernet(PRIMITIVES, **SUPERNET), params["supernet"]), logits, gene


def test_supernet_logits_match_flax(supernet):
    port, want, _ = supernet
    np.testing.assert_allclose(port(_nchw(SUPERNET_INPUT)).detach().numpy(), want, atol=1e-5)


def test_supernet_genotype_matches_jax(supernet):
    port, _, want = supernet
    got = darts_supernet.genotype(port)
    assert got == want and set(got) == {"normal", "normal_concat", "reduce", "reduce_concat"}
    assert [len(node) for node in got["normal"] + got["reduce"]] == [2, 2, 2, 2]


def test_supernet_groups_weights_and_alphas(supernet):
    port = supernet[0]
    alphas, weights = port.alphas(), port.weights()
    assert [tuple(a.shape) for a in alphas] == [(2, 8), (3, 8), (2, 8), (3, 8)]
    assert len(alphas) + len(weights) == len(list(port.parameters()))
    assert not {id(a) for a in alphas} & {id(w) for w in weights}


# -- the second-order alpha gradient and the search step ----------------------

def _torch_batch(x, y):
    return _nchw(x), torch.tensor(np.asarray(y), dtype=torch.long)


def _alpha_flat(tree):
    """JAX alphas in the port's order: normal by node, then reduce."""
    names = sorted(tree, key=lambda k: (not k.startswith("alpha_normal_"), int(k.rsplit("_", 1)[1])))
    return np.concatenate([np.asarray(tree[k]).ravel() for k in names])


@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_architect_alpha_grad_matches_jax(references, mode):
    """The unrolled alpha gradient within 1e-4 in relative norm."""
    params, futures = references
    want = futures[f"architect-{mode}"].result()
    (xt, yt), (xv, yv) = _search_batches()

    def port_model():
        return _port(darts_supernet.DartsSupernet(ARCHITECT_PRIMITIVES, **ARCHITECT_NET), params["architect"])

    ours = port_model()
    got = darts_trainer.architect_alpha_grad(ours, port_model(), [torch.full_like(w, 0.01) for w in ours.weights()],
                                             _torch_batch(xt[0], yt[0]), _torch_batch(xv[0], yv[0]),
                                             hessian_mode=mode, **ARCHITECT)
    got_flat, want_flat = torch.cat([g.ravel() for g in got]).numpy(), _alpha_flat(want)
    rel = np.linalg.norm(got_flat - want_flat) / (np.linalg.norm(want_flat) + 1e-12)
    assert rel < 1e-4, rel


@pytest.mark.parametrize("mode", ["jvp", "fd"])
def test_three_search_steps_match_jax(references, mode):
    """Three steps of the port's DartsSearch against the JAX package's
    compiled step, from the same parameters and batches: losses, weights and
    alphas within 1e-4."""
    params, futures = references
    want_params, want_losses = futures[f"steps-{mode}"].result()
    (xt, yt), (xv, yv) = _search_batches()
    search = _search_setting(mode)
    search.build(SCHEDULE)
    _port(search.model, params["steps"])
    got_losses = [float(search.step(_torch_batch(xt[i], yt[i]), _torch_batch(xv[i], yv[i])))
                  for i in range(SEARCH_STEPS)]
    np.testing.assert_allclose(got_losses, want_losses, atol=1e-4)
    want, got = darts_params_from_flax(want_params), search.model.state_dict()
    assert set(got) == set(want)
    for name, value in want.items():
        np.testing.assert_allclose(got[name].numpy(), value.numpy(), atol=1e-4, err_msg=name)


def test_hessian_vector_product_equals_double_backward():
    """mixed_hessian_vector (reverse over forward: the training loss's
    derivative along a direction, then its alpha gradient) against torch's
    double backward of the same product (tools/darts_hvp.py, which times
    the two on the card), on a supernet of every operation
    at stride 1 and 2: batch_norm's written-out formula for dual inputs
    keeps the batch statistics differentiable."""
    torch.manual_seed(0)
    model = darts_supernet.DartsSupernet(PRIMITIVES, init_channels=2, num_layers=2, num_nodes=1, num_classes=4)
    with torch.no_grad():
        for a in model.alphas():
            a.normal_()
    x, y = torch.randn(4, 3, 8, 8), torch.randint(0, 4, (4,))
    direction = [torch.randn_like(w) for w in model.weights()]
    want = torch.cat([h.ravel() for h in double_backward(model, direction, (x, y))])
    got = torch.cat([h.ravel() for h in darts_trainer.mixed_hessian_vector(model, direction, (x, y))])
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_search_settings_are_checked():
    with pytest.raises(ValueError, match="hessian_mode"):
        darts_trainer.DartsSearch(("skip_connection",), num_layers=2, settings={"hessian_mode": "jpv"}, device=CPU)
    assert darts_trainer.DartsSearch(("skip_connection",), settings={"hessian_mode": " FD "},
                                     device=CPU).hessian_mode == "fd"
    with pytest.raises(ValueError, match="remat_cells"):
        darts_trainer.DartsSearch(("skip_connection",), settings={"remat_cells": "true"}, device=CPU)
    assert darts_trainer.DartsSearch(("skip_connection",), settings={"remat_cells": "false"},
                                     device=CPU).primitives == ["skip_connection", "none"]


def test_search_without_devices_asks_the_cuda_probe(monkeypatch):
    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(backend.BackendUnavailable):
            darts_trainer.DartsSearch(("skip_connection",))
    finally:
        backend.reset_probe_state()


# -- the derived network ----------------------------------------------------------

def test_derived_logits_match_flax(references):
    params, futures = references
    want = futures["derived"].result()[0]
    got = _port(_derived_port(), params["derived"])(_nchw(DERIVED_INPUT[0])).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_two_retrain_steps_match_optax(references):
    params, futures = references
    _, want_losses, want_params = futures["derived"].result()
    port = _port(_derived_port(), params["derived"])
    step = darts_derived.make_retrain_step(port, **RETRAIN)
    x, y = _torch_batch(*DERIVED_INPUT)
    got_losses = [float(step(x[4 * i:4 * i + 4], y[4 * i:4 * i + 4])) for i in range(2)]
    np.testing.assert_allclose(got_losses, want_losses, atol=1e-4)
    for name, value in darts_params_from_flax(want_params).items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), value.numpy(), atol=1e-4, err_msg=name)


def test_a_gene_reading_a_later_state_is_refused():
    with pytest.raises(ValueError, match="reads state 3"):
        darts_derived.DerivedNetwork([[("skip_connection", 0), ("skip_connection", 3)]], num_layers=1)
