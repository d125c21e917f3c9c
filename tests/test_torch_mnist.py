"""The port's MNIST slice against the JAX package, on the CPU.

- the synthetic data and its batch order are bit-identical to
  katib_tpu.utils.datasets for the same seeds;
- MnistCNN from converted flax weights gives the flax logits (1e-5), and
  three SGD-with-momentum steps give optax's gradients and parameters
  (1e-4), at small widths (convs 4/6, hidden 16);
- run_mnist_trial reports loss and accuracy once per epoch;
- grid and Hyperband suggestions equal the JAX suggesters' letter for
  letter on the same experiment and trial history, TrialsNotCompleted
  included;
- in a fresh interpreter, beside this module's JAX work: every
  examples/*.json and examples/nas/*.json with an entryPoint validates
  through the port or raises ValidationError, and then every module of the
  port imports, neither step importing jax or katib_tpu; no import
  statement of the port names them;
- shrunk copies of examples/random.json, tpe.json, grid.json,
  hyperband.json and early-stopping-medianstop.json run end to end through
  the port's CLI, side by side (the MNIST trial at full width on 32 or 64
  training images in batches of 16), a median-stop trial ending
  EarlyStopped.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.api import spec as jax_spec
from katib_tpu.api.status import Trial as JaxTrial
from katib_tpu.api.status import TrialCondition as JaxTrialCondition
from katib_tpu.models.mnist_cnn import MnistCNN as JaxMnistCNN
from katib_tpu.suggest.base import SuggestionRequest as JaxSuggestionRequest
from katib_tpu.suggest.grid import GridSearch as JaxGridSearch
from katib_tpu.suggest.hyperband import HyperBand as JaxHyperBand
from katib_tpu.suggest.hyperband import TrialsNotCompleted as JaxTrialsNotCompleted
from katib_tpu.utils import datasets as jax_datasets
from katib_tpu_torch import cli
from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import Trial, TrialCondition
from katib_tpu_torch.db.store import InMemoryObservationStore
from katib_tpu_torch.models import mnist_cnn
from katib_tpu_torch.models.convert import mnist_params_from_flax
from katib_tpu_torch.runtime.context import TrialContext
from katib_tpu_torch.runtime.metrics import MetricsReporter
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.utils import backend, datasets

REPO = Path(__file__).resolve().parents[1]
SMALL = dict(conv1=4, conv2=6, hidden=16)
CPU = [torch.device("cpu")]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX compiles and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- data ---------------------------------------------------------------------

@pytest.mark.parametrize("split,n", [("train", 128), ("test", 25), ("train", 700)])
def test_load_mnist_is_bit_identical(split, n):
    want, got = jax_datasets.load_mnist(split, n=n), datasets.load_mnist(split, n=n)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
    assert got[0].shape == (n, 28, 28, 1)


@pytest.mark.parametrize("batch_size", [16, 50, 200])
def test_batches_are_bit_identical(batch_size):
    """The port's batch indices select the JAX package's batches from the
    same generator, and leave it in the same state, also when not one batch
    fits (batch 200 of 128)."""
    x, y = datasets.load_mnist("train", n=128)
    r_jax, r_port = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(2):  # two epochs from one generator
        want = list(jax_datasets.batches(x, y, batch_size, r_jax))
        got = [(x[sel], y[sel]) for sel in datasets.batch_indices(len(x), batch_size, r_port)]
        assert len(got) == len(want) == 128 // batch_size
        for (wx, wy), (gx, gy) in zip(want, got):
            assert np.array_equal(wx, gx) and np.array_equal(wy, gy)
    assert r_jax.random() == r_port.random()


# -- model and step -------------------------------------------------------------

@pytest.fixture(scope="module")
def flax_small():
    """The JAX model at small widths, parameters of its tree's shapes drawn
    by numpy (kernels at lecun scale, biases at 0.1 so that their conversion
    counts; eval_shape traces the init and compiles nothing), and 3 batches."""
    model = JaxMnistCNN(**SMALL)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((2, 28, 28, 1)))["params"]
    rng = np.random.default_rng(0)

    def draw(s):
        scale = 0.1 if len(s.shape) == 1 else 1 / np.sqrt(np.prod(s.shape[:-1]))
        return (scale * rng.standard_normal(s.shape)).astype(np.float32)

    params = jax.tree_util.tree_map(draw, shapes)
    x, y = datasets.load_mnist("train", n=48)
    return model, params, x, y


def _port_model(params):
    model = mnist_cnn.MnistCNN(**SMALL)
    model.load_state_dict(mnist_params_from_flax(params))
    return model


def test_forward_matches_flax(flax_small):
    model, params, x, _ = flax_small
    want = np.asarray(jax.jit(model.apply)({"params": params}, x))
    got = _port_model(params)(torch.tensor(x)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_three_sgd_momentum_steps_match_optax(flax_small):
    model, params, x, y = flax_small
    lr, momentum = 0.05, 0.9
    tx = optax.sgd(lr, momentum=momentum)

    @jax.jit
    def step(params, state, bx, by):
        def loss_fn(p):
            return optax.softmax_cross_entropy_with_integer_labels(model.apply({"params": p}, bx), by).mean()

        grads = jax.grad(loss_fn)(params)
        updates, state = tx.update(grads, state, params)
        return optax.apply_updates(params, updates), state, grads

    want_params, state, want_grads = params, tx.init(params), []
    for i in range(3):
        want_params, state, grads = step(want_params, state, x[16 * i:16 * (i + 1)], y[16 * i:16 * (i + 1)])
        want_grads.append(jax.device_get(grads))
    want_params = jax.device_get(want_params)
    port = _port_model(params)
    step = mnist_cnn.make_mnist_train_step(port, lr, momentum)
    xt, yt = torch.tensor(x), torch.tensor(y, dtype=torch.long)
    for i in range(3):
        step(xt[16 * i:16 * (i + 1)], yt[16 * i:16 * (i + 1)])
        got = {name: p.grad for name, p in port.named_parameters()}
        for name, want in mnist_params_from_flax(want_grads[i]).items():
            np.testing.assert_allclose(got[name].numpy(), want.numpy(), atol=1e-4, err_msg=f"step {i} {name}")
    for name, want in mnist_params_from_flax(want_params).items():
        np.testing.assert_allclose(port.state_dict()[name].numpy(), want.numpy(), atol=1e-4, err_msg=name)


def test_init_draws_lecun_normal():
    """Kernels at flax's lecun_normal scale (std sqrt(1/fan_in), truncated at
    two deviations), biases zero, the same draw from the same seed."""
    a, b = mnist_cnn.MnistCNN(), mnist_cnn.MnistCNN()
    for name, w in a.state_dict().items():
        assert torch.equal(w, b.state_dict()[name])
        if name.endswith("bias"):
            assert not w.any()
        else:
            std = (1.0 / w[0].numel()) ** 0.5
            assert abs(float(w.std()) / std - 1) < 0.1 and float(w.abs().max()) <= 2 * std / 0.8796 + 1e-6


def _ctx(store, name="t"):
    return TrialContext(trial_name=name, experiment_name="e", assignments={},
                        reporter=MetricsReporter(store, name), devices=CPU)


def test_trial_reports_loss_and_accuracy_each_epoch():
    store = InMemoryObservationStore()
    mnist_cnn.run_mnist_trial({"num_train_examples": "128", "num_epochs": "2", "lr": "0.05"}, _ctx(store))
    for metric in ("loss", "accuracy"):
        values = [float(r.value) for r in store.get_observation_log("t", metric)]
        assert len(values) == 2 and all(np.isfinite(values))
    assert all(0.0 <= float(r.value) <= 1.0 for r in store.get_observation_log("t", "accuracy"))


def test_trial_holds_convolutions_in_f32():
    """cuDNN's TF32 flag is off while any trial holds it, and the last
    holder puts the caller's value back."""
    flag = torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cudnn.allow_tf32 = True
        with mnist_cnn.f32_convolutions.hold():
            with mnist_cnn.f32_convolutions.hold():
                assert torch.backends.cudnn.allow_tf32 is False
            assert torch.backends.cudnn.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is True
    finally:
        torch.backends.cudnn.allow_tf32 = flag


def test_trial_without_devices_asks_the_cuda_probe(monkeypatch):
    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(backend.BackendUnavailable):
            mnist_cnn.run_mnist_trial({"num_train_examples": "32"}, None)
    finally:
        backend.reset_probe_state()


# -- grid and Hyperband against the JAX suggesters -----------------------------

def _doc(name, settings=None):
    doc = json.loads((REPO / "examples" / f"{name}.json").read_text())
    if settings:
        merged = {s["name"]: s["value"] for s in doc["algorithm"]["algorithmSettings"]}
        merged.update(settings)
        doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in merged.items()]
    return doc


def _pair(doc, history, want):
    """(port request, JAX request) over the same trials: history rows are
    (name, assignments, loss or None, condition name, start time)."""
    ours, theirs = [], []
    for name, assign, loss, condition, start in history:
        obs = None
        if loss is not None:
            obs = {"metrics": [{"name": "loss", "min": repr(loss), "max": repr(loss), "latest": repr(loss)}]}
        t = Trial(name=name, experiment_name=doc["name"],
                  parameter_assignments=[spec.ParameterAssignment(k, v) for k, v in assign.items()])
        jt = JaxTrial(name=name, experiment_name=doc["name"],
                      parameter_assignments=[jax_spec.ParameterAssignment(k, v) for k, v in assign.items()])
        t.condition, jt.condition = TrialCondition[condition], JaxTrialCondition[condition]
        t.start_time = jt.start_time = start
        if obs is not None:
            t.observation, jt.observation = spec.Observation.from_dict(obs), jax_spec.Observation.from_dict(obs)
        ours.append(t)
        theirs.append(jt)
    return (suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), ours, want),
            JaxSuggestionRequest(jax_spec.ExperimentSpec.from_dict(doc), theirs, want))


def _values(reply):
    return [[(a.name, a.value) for a in s.parameter_assignments] for s in reply.assignments]


@pytest.mark.parametrize("tried,want", [(0, 3), (4, 5), (13, 3)])
def test_grid_suggestions_match_jax(tried, want):
    """grid.json has 5 x 3 = 15 points: the first request, one after 4
    tried points, and one past the end of the grid (search ended)."""
    doc = _doc("grid")
    combos = suggest.create("grid").search_space(spec.ExperimentSpec.from_dict(doc)).grid_combinations()
    history = [(f"t{i}", {a.name: a.value for a in c}, 1.0, "SUCCEEDED", float(i)) for i, c in enumerate(combos[:tried])]
    ours, theirs = _pair(doc, history, want)
    got, expected = suggest.create("grid").get_suggestions(ours), JaxGridSearch().get_suggestions(theirs)
    assert _values(got) == _values(expected) and got.search_ended == expected.search_ended
    assert len(got.assignments) == min(want, 15 - tried)
    assert [v for _, v in _values(got)[0]][0] in ("0.01", "0.02", "0.03", "0.04", "0.05")


def _loss(assign):
    """A deterministic objective of an assignment: lower for lr near 0.1 and
    for more epochs."""
    return abs(float(assign["lr"]) - 0.1) + float(assign["momentum"]) / (1 + float(assign["num_epochs"]))


def test_hyperband_protocol_matches_jax():
    """hyperband.json (r_l 9, eta 3, 9 parallel, 18 trials) driven as the
    controller drives it, the port's and the JAX suggester side by side:
    the same assignments and bracket settings at every request, and the same
    TrialsNotCompleted while a rung is short or still running."""
    settings, history, start = {"random_state": "3"}, [], 0.0
    port, jax_hb = suggest.create("hyperband"), JaxHyperBand()
    waits = rungs = 0
    while len(history) < 18:
        doc = _doc("hyperband", settings)
        running = sum(1 for h in history if h[3] == "RUNNING")
        want = min(9, 18 - len(history)) - running
        if want > 1:  # a request one short of the full width waits in both packages
            ours, theirs = _pair(doc, history, want - 1)
            with pytest.raises(suggest.TrialsNotCompleted):
                port.get_suggestions(ours)
            with pytest.raises(JaxTrialsNotCompleted):
                jax_hb.get_suggestions(theirs)
            waits += 1
        ours, theirs = _pair(doc, history, want)
        try:
            got = port.get_suggestions(ours)
        except suggest.TrialsNotCompleted:
            with pytest.raises(JaxTrialsNotCompleted):
                jax_hb.get_suggestions(theirs)
            waits += 1
            history = [h[:2] + (_loss(h[1]), "SUCCEEDED", h[4]) for h in history]  # the rung ends
            continue
        expected = jax_hb.get_suggestions(theirs)
        assert _values(got) == _values(expected)
        assert got.algorithm_settings == expected.algorithm_settings and got.search_ended == expected.search_ended
        if got.search_ended or not got.assignments:
            break
        rungs += 1
        settings.update(got.algorithm_settings)
        for assignment in got.assignments:
            start += 1.0
            history.append((f"t{len(history)}", {a.name: a.value for a in assignment.parameter_assignments},
                            None, "RUNNING", start))
    budgets = [h[1]["num_epochs"] for h in history]
    assert budgets[:13] == ["1"] * 9 + ["3"] * 3 + ["9"] and rungs >= 4 and waits >= 4


def test_hyperband_waits_for_a_rung_still_queued():
    """A rung whose trials wait for a device (pending, not started) is not
    complete: the port raises TrialsNotCompleted until they have run, then
    promotes the best of them. The JAX package sorts such trials as the
    oldest and would rank the previous rung's last trials in their place."""
    hb = suggest.create("hyperband")
    settings = {"random_state": "3"}
    reply = hb.get_suggestions(_pair(_doc("hyperband", settings), [], 9)[0])
    settings.update(reply.algorithm_settings)
    rung0 = [(f"a{i}", {p.name: p.value for p in s.parameter_assignments}, _loss_of(i), "SUCCEEDED", float(i))
             for i, s in enumerate(reply.assignments)]
    reply = hb.get_suggestions(_pair(_doc("hyperband", settings), rung0, 9)[0])
    settings.update(reply.algorithm_settings)
    assert len(reply.assignments) == 3 and settings["evaluating_trials"] == "3"
    rung1 = [(f"b{i}", {p.name: p.value for p in s.parameter_assignments}) for i, s in enumerate(reply.assignments)]
    queued = [(n, a, None, "PENDING", None) for n, a in rung1]
    for ran in range(3):  # one card: the rung's trials run one at a time
        history = rung0 + [(n, a, 1.0 + i, "SUCCEEDED", 10.0 + i) for i, (n, a) in enumerate(rung1[:ran])]
        with pytest.raises(suggest.TrialsNotCompleted):
            hb.get_suggestions(_pair(_doc("hyperband", settings), history + queued[ran:], 6)[0])
    done = [(n, a, [0.5, 0.2, 0.9][i], "SUCCEEDED", 10.0 + i) for i, (n, a) in enumerate(rung1)]
    reply = hb.get_suggestions(_pair(_doc("hyperband", settings), rung0 + done, 6)[0])
    got = [{p.name: p.value for p in s.parameter_assignments} for s in reply.assignments]
    assert got == [dict(rung1[1][1], num_epochs="9")]


def _loss_of(i):
    return [2.3, 0.4, 2.2, 0.9, 2.4, 0.3, 2.1, 2.5, 2.0][i]


# -- the repo's examples through the port, in a fresh interpreter ---------------

SHRUNK = {"num_train_examples": "32", "batch_size": "16"}


def _shrunk(name, **edits):
    """examples/<name>.json with the one-value parameters SHRUNK (and any
    given as ``fixed``) added, its other fields edited as given."""
    doc = json.loads((REPO / "examples" / f"{name}.json").read_text())
    fixed = dict(SHRUNK, **edits.pop("fixed", {}))
    doc["parameters"] = [p for p in doc["parameters"] if p["name"] not in fixed]
    doc["parameters"] += [{"name": k, "parameterType": "discrete", "feasibleSpace": {"list": [v]}}
                          for k, v in fixed.items()]
    doc.update(edits)
    return doc


def _hyperband_doc():
    """r_l 3 (two brackets: 3 trials of 1 epoch, the best of them for 3,
    then 2 of 3), so 3 parallel trials suffice."""
    doc = _shrunk("hyperband", maxTrialCount=6, parallelTrialCount=3)
    doc["algorithm"]["algorithmSettings"] = [{"name": "r_l", "value": "3"}, {"name": "eta", "value": "3"},
                                             {"name": "resource_name", "value": "num_epochs"}]
    next(p for p in doc["parameters"] if p["name"] == "num_epochs")["feasibleSpace"]["max"] = "3"
    return doc


def _medianstop_doc():
    """5 epochs, so each trial reports past the rule's start_step 4, on 64
    training images (a test split of 12); the random draws are seeded."""
    doc = _shrunk("early-stopping-medianstop", fixed={"num_epochs": "5", "num_train_examples": "64"},
                  maxTrialCount=4)
    doc["algorithm"]["algorithmSettings"] = [{"name": "random_state", "value": "8"}]
    return doc


SHRUNK_EXAMPLES = {
    "random": lambda: _shrunk("random", maxTrialCount=2, parallelTrialCount=2, maxFailedTrialCount=2),
    "tpe": lambda: _shrunk("tpe", maxTrialCount=2, parallelTrialCount=2, maxFailedTrialCount=2),
    "grid": lambda: _shrunk("grid", maxTrialCount=2, parallelTrialCount=2, maxFailedTrialCount=2),
    "hyperband": _hyperband_doc,
    "early-stopping-medianstop": _medianstop_doc,
}

JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "katib_tpu")

_FRESH_INTERPRETER = textwrap.dedent(
    """
    import glob, importlib, json, os, pkgutil, sys
    import katib_tpu_torch
    from katib_tpu_torch.api.spec import ExperimentSpec, ValidationError
    from katib_tpu_torch.controller.experiment import validate_spec

    def leaked():
        return sorted(m for m in sys.modules if m.split(".")[0] in %r)

    validated = {}
    for path in sorted(glob.glob("examples/*.json") + glob.glob("examples/nas/*.json")):
        with open(path) as f:
            doc = json.load(f)
        if not doc.get("trialTemplate", {}).get("entryPoint"):
            continue
        try:
            validate_spec(ExperimentSpec.from_dict(doc), 4)  # a host of four cards
            validated[path] = "valid"
        except ValidationError as e:
            validated[path] = "ValidationError: " + str(e)
    after_validation = leaked()
    modules = [m.name for m in pkgutil.walk_packages(katib_tpu_torch.__path__, "katib_tpu_torch.")]
    for name in modules:
        importlib.import_module(name)
    print(json.dumps({"validated": validated, "after_validation": after_validation, "modules": modules,
                      "after_imports": leaked()}), flush=True)
    os._exit(0)  # the result is out; skip the interpreter's teardown
    """ % (JAX_MODULES,)
)


@pytest.fixture(scope="module", autouse=True)
def fresh_interpreter():
    """Starts, before this module's first test, a fresh interpreter that
    validates every example with an entryPoint through the port and then
    imports every module of the port; calling the fixture's value waits for
    its result."""
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, "-c", _FRESH_INTERPRETER], cwd=str(REPO), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    result = {}

    def read():
        if not result:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, err
            result.update(json.loads(out.strip().splitlines()[-1]))
        return result

    yield read
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """The shrunk examples through the port's CLI on the CPU, side by side
    on threads of this process: their exit codes, the experiments' records
    and the modules of JAX or the JAX package that the runs imported."""
    root = tmp_path_factory.mktemp("port-run")
    names = {}
    for key, make in SHRUNK_EXAMPLES.items():
        doc = make()
        names[key] = doc["name"]
        (root / f"{key}.json").write_text(json.dumps(doc))

    def run(key):
        return cli.main(["run", str(root / f"{key}.json"), "--root", str(root), "--device", "cpu",
                         "--timeout", "120"])

    before = set(sys.modules)
    with ThreadPoolExecutor(len(SHRUNK_EXAMPLES)) as pool:
        rcs = dict(zip(SHRUNK_EXAMPLES, pool.map(run, SHRUNK_EXAMPLES)))
    imported = sorted(m for m in set(sys.modules) - before if m.split(".")[0] in JAX_MODULES)
    records = {key: json.loads((root / name / "experiment.json").read_text()) for key, name in names.items()}
    return {"rcs": rcs, "records": records, "imported": imported}


def _imports(path):
    """The absolute module names that the source file imports, wherever
    the import statement stands (functions included)."""
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_the_port_imports_nothing_of_jax():
    """No import statement of the port, at module level or inside a
    function, names jax, flax, optax or the JAX package: a run imports
    nothing of them whatever path it takes (entry points are resolved
    through the port's table; see the test below)."""
    sources = sorted((REPO / "katib_tpu_torch").rglob("*.py"))
    assert len(sources) >= 38
    bad = {str(f.relative_to(REPO)): m for f in sources for m in _imports(f) if m.split(".")[0] in JAX_MODULES}
    assert bad == {}


def test_examples_validate_or_are_refused_without_importing_jax(fresh_interpreter, port_run):
    """Every example with an entryPoint either validates through the port
    (a katib_tpu. trial that is ported runs its counterpart) or raises
    ValidationError; neither jax nor any katib_tpu module was imported by
    validation or by importing every module of the port, in a fresh
    interpreter, nor newly by the shrunk examples' runs here."""
    result = fresh_interpreter()
    validated = result["validated"]
    assert len(validated) == 17
    valid = sorted(Path(p).stem for p, outcome in validated.items() if outcome == "valid")
    assert valid == ["cma-es", "cma-es-ipop", "darts", "darts-retrain", "early-stopping-medianstop", "enas",
                     "grid", "hyperband", "multivariate-tpe", "random", "reuse-duplicate-results", "tpe"]
    refused = {Path(p).stem: outcome for p, outcome in validated.items() if outcome != "valid"}
    assert sorted(refused) == ["bayesian-optimization", "distributed-lm", "multihost-lm", "simple-pbt", "sobol"]
    assert all(outcome.startswith("ValidationError: ") for outcome in refused.values())
    assert "unknown algorithm 'bayesianoptimization'" in refused["bayesian-optimization"]
    assert "unknown algorithm 'sobol'" in refused["sobol"]
    assert "not yet ported" in refused["simple-pbt"] and \
        "katib_tpu.models.simple_pbt:run_pbt_trial" in refused["simple-pbt"]
    assert "numDevices=4" in refused["distributed-lm"] and "one card" in refused["distributed-lm"]
    assert "multi-host trials" in refused["multihost-lm"]
    assert {"katib_tpu_torch.cli", "katib_tpu_torch.models.mnist_cnn", "katib_tpu_torch.models.darts_trainer",
            "katib_tpu_torch.models.darts_derived", "katib_tpu_torch.suggest.nas.darts",
            "katib_tpu_torch.models.enas_child", "katib_tpu_torch.suggest.nas.enas", "katib_tpu_torch.suggest.cmaes",
            "katib_tpu_torch.api.validation", "katib_tpu_torch.controller.suggestion"} <= set(result["modules"])
    assert result["after_validation"] == [] and result["after_imports"] == []
    assert port_run["imported"] == []


@pytest.mark.parametrize("name", list(SHRUNK_EXAMPLES))
def test_shrunk_example_runs_through_the_port_cli(port_run, name):
    result = port_run
    assert result["rcs"][name] == 0
    record = result["records"][name]
    status = record["experiment"]["status"]
    assert status["condition"] == "Succeeded" and status["reason"] == "ExperimentMaxTrialsReached"
    trials = record["trials"]
    assert len(trials) == record["experiment"]["spec"]["maxTrialCount"]
    assert status["currentOptimalTrial"]["bestTrialName"]
    for t in trials:
        values = [float(v) for _, _, v in record["logs"][t["name"]]]
        assert values and all(np.isfinite(values)), t["name"]
    conditions = {t["condition"] for t in trials}
    if name == "early-stopping-medianstop":
        stopped = [t for t in trials if t["condition"] == "EarlyStopped"]
        assert stopped and status["trialsEarlyStopped"] == len(stopped)
        for t in stopped:  # stopped at the rule's start_step, the 4th report
            assert len([r for r in record["logs"][t["name"]] if r[1] == "accuracy"]) == 4
        assert conditions == {"Succeeded", "EarlyStopped"}
    else:
        assert conditions == {"Succeeded"}
    if name == "hyperband":
        assigned = [{a["name"]: a["value"] for a in t["parameterAssignments"]} for t in trials]
        assert [a["num_epochs"] for a in assigned] == ["1", "1", "1", "3", "3", "3"]
        losses = [min(float(v) for _, m, v in record["logs"][t["name"]] if m == "loss") for t in trials[:3]]
        best = assigned[losses.index(min(losses))]
        assert (assigned[3]["lr"], assigned[3]["momentum"]) == (best["lr"], best["momentum"])
