"""The port's ENAS slice against the JAX package, on the CPU.

The same numpy inputs and parameters go through the JAX code and the port:

- ``expand_operations`` and the settings' validation on
  examples/nas/enas.json (the same operations; the same messages, the
  ranges and the None cases included); the fused population settings and
  ``dataset: digits`` are refused by the port by name;
- the controller (4 layers, hidden 16, enas.json's 18 operations):
  ``score_arc`` on the arc ``_sample_and_score`` sampled for each of four
  keys, with and without temperature and tanh constant: log_prob,
  entropy, skip_penalty and skip_count within 1e-5, the gradients of
  log_prob and skip_penalty within 1e-4; then a 3-step training round on
  the arcs the JAX suggester's own loop sampled: parameters and baseline
  within 1e-4;
- the child network at dropout 0 for every op kind, both pool types and
  sizes, depth multiplier 2, skips to the image, padded concatenation, the
  pool's identity at 1x1 and pools larger than their map (an empty map,
  NaN logits where the head averages it, as in JAX): logits within 1e-5,
  gradients and one Adam step within 1e-4;
- the trial's batch order over two epochs, equal to the JAX trial's,
  also for splits smaller than a batch;
- the suggester's assignment strings, built as the JAX suggester builds
  them and parsed by the port's trial; the controller's pickle round trip,
  and a corrupt or foreign pickle reseeding it;
- a two-round experiment through the port's controller on the CPU, whose
  controller parameters change between rounds.
"""

import json
import multiprocessing
import pickle
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from katib_tpu_torch.api import spec
from katib_tpu_torch.api.status import TrialCondition
from katib_tpu_torch.controller.experiment import ExperimentController, validate_spec
from katib_tpu_torch.models import enas_child
from katib_tpu_torch.models.convert import enas_child_params_from_flax, enas_controller_params_from_jax
from katib_tpu_torch.suggest import base as suggest
from katib_tpu_torch.suggest.nas import enas

import enas_jax_references as refs  # imports JAX only in the processes it runs in

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _doc(settings=None):
    doc = json.loads((REPO / "examples" / "nas" / "enas.json").read_text())
    if settings is not None:
        doc["algorithm"]["algorithmSettings"] = [{"name": k, "value": v} for k, v in settings.items()]
    return doc


# -- the cases ------------------------------------------------------------------

NUM_OPS = 18  # enas.json's operations, expanded
CONTROLLER = dict(num_layers=4, hidden=16, skip_target=0.4)
SHAPINGS = {"shaped": (5.0, 2.25), "raw": (None, None)}
SEEDS = (0, 1, 2, 3)
ROUND_SETTINGS = dict(enas.ENAS_DEFAULT_SETTINGS, controller_train_steps=3, controller_learning_rate=1e-2)
ROUND_RESULT, ROUND_SEED = 0.7, 5


def _controller_params(seed=0):
    rng = np.random.default_rng(seed)
    h, n = CONTROLLER["hidden"], NUM_OPS
    shapes = {"w_lstm": (2 * h, 4 * h), "g_emb": (1, h), "w_emb": (n, h), "w_soft": (h, n),
              "attn_w1": (h, h), "attn_w2": (h, h), "attn_v": (h, 1)}
    return {k: rng.uniform(-0.5, 0.5, s).astype(np.float32) for k, s in shapes.items()}


def _port_controller(params, shaping="shaped"):
    temperature, tanh_const = SHAPINGS[shaping]
    c = enas.EnasController(NUM_OPS, CONTROLLER["num_layers"], CONTROLLER["hidden"], temperature, tanh_const,
                            CONTROLLER["skip_target"])
    c.load_state_dict(enas_controller_params_from_jax(params))
    return c


OPS = {  # every op kind, both pool types and sizes, depth multiplier 2
    "0": {"opt_type": "convolution", "opt_params": {"filter_size": "3", "num_filter": "4"}},
    "1": {"opt_type": "convolution", "opt_params": {"filter_size": "5", "num_filter": "3"}},
    "2": {"opt_type": "separable_convolution",
          "opt_params": {"filter_size": "3", "num_filter": "4", "depth_multiplier": "2"}},
    "3": {"opt_type": "separable_convolution",
          "opt_params": {"filter_size": "5", "num_filter": "2", "depth_multiplier": "1"}},
    "4": {"opt_type": "depthwise_convolution", "opt_params": {"filter_size": "3", "depth_multiplier": "2"}},
    "5": {"opt_type": "reduction", "opt_params": {"reduction_type": "max_pooling", "pool_size": 2}},
    "6": {"opt_type": "reduction", "opt_params": {"reduction_type": "avg_pooling", "pool_size": 3}},
    "7": {"opt_type": "reduction", "opt_params": {"reduction_type": "avg_pooling", "pool_size": 2}},
    "8": {"opt_type": "reduction", "opt_params": {"reduction_type": "max_pooling", "pool_size": 3}},
}
CHILD_CASES = {  # name: (arch, image size)
    # conv 3 and 5, separable at depth multiplier 2, depthwise, max 2 and
    # avg 3; skips to the image; 4x4 and 2x2 maps padded beside 8x8 ones
    "every_op": ([[0], [2, 1], [5, 0, 1], [1, 1, 0, 1], [6, 0, 1, 0, 1], [4, 1, 0, 0, 1, 1]], 8),
    # separable 5x5 at depth multiplier 1, max 3 (10 -> 3), a convolution
    # over a concat that pads 3x3 to 10x10 (the odd extra row and column
    # after), avg 2 over another
    "pools": ([[3], [8, 1], [0, 0, 1], [7, 0, 0, 1]], 10),
    # 8 -> 4 -> 2 -> 1 by max 2, then the pool's identity at 1x1
    "identity": ([[5], [5, 0], [5, 0, 0], [7, 0, 0, 0]], 8),
    # a 3x3 pool over a 2x2 map: empty, so the head's mean is NaN
    "empty_head": ([[8]], 2),
    # the empty map padded to zeros beside the image
    "empty_then_skip": ([[8], [0, 0], [0, 1, 1]], 2),
}
CHILD_LR = 0.01


def _child_port(name):
    arch, size = CHILD_CASES[name]
    return enas_child.EnasChildNet(arch, OPS, input_shape=(3, size, size), dropout_rate=0.0)


def _child_params(port, seed):
    """Parameters drawn by numpy in the port's layout (kernels at lecun
    scale, biases at 0.1) as the flax tree; the port loads them back
    through ``enas_child_params_from_flax``."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, value in port.state_dict().items():
        module, leaf = name.split(".")
        if leaf == "bias":
            tree.setdefault(module, {})["bias"] = (0.1 * rng.standard_normal(value.shape)).astype(np.float32)
            continue
        draw = (rng.standard_normal(value.shape) / np.sqrt(value[0].numel())).astype(np.float32)
        tree.setdefault(module, {})["kernel"] = draw.transpose(2, 3, 1, 0) if draw.ndim == 4 else draw.T
    port.load_state_dict(enas_child_params_from_flax(tree))
    return tree


def _child_inputs(name, seed):
    size = CHILD_CASES[name][1]
    rng = np.random.default_rng(seed)
    return rng.standard_normal((4, size, size, 3)).astype(np.float32), rng.integers(0, 10, 4).astype(np.int32)


def _nchw(x):
    return torch.tensor(np.asarray(x)).permute(0, 3, 1, 2).contiguous()


BATCH_CASES = {  # (images, batch size): 90/10 split
    "batches": (100, 8),       # 11 training batches, one validation batch
    "small_valid": (40, 16),   # validation split of 4, smaller than a batch
    "whole_set": (10, 16),     # training split of 9, smaller than a batch
}


@pytest.fixture(scope="module", autouse=True)
def references():
    """The JAX package's outputs for every case, computed in spawned
    processes (tracing holds the interpreter lock for seconds) from the
    module's first test on; each output is a future."""
    children = {name: (CHILD_CASES[name][0], OPS) for name in CHILD_CASES}
    params = {name: _child_params(_child_port(name), seed=i) for i, name in enumerate(CHILD_CASES)}
    inputs = {name: _child_inputs(name, seed=10 + i) for i, name in enumerate(CHILD_CASES)}
    nl, sk = CONTROLLER["num_layers"], CONTROLLER["skip_target"]
    tasks = {  # the longest first: four workers take them in this order
        "round": (refs.controller_round, _controller_params(1), ROUND_SEED, nl, ROUND_SETTINGS, ROUND_RESULT),
        **{f"scores-{k}": (refs.controller_scores, _controller_params(), SEEDS, nl, *v, sk)
           for k, v in SHAPINGS.items()},
        "child": (refs.child_outputs, children, params, inputs, CHILD_LR),
        **{f"batches-{k}": (refs.trial_batches, n, b, 2) for k, (n, b) in BATCH_CASES.items()},
    }
    with ProcessPoolExecutor(4, mp_context=multiprocessing.get_context("spawn")) as procs:
        yield {"params": params, "inputs": inputs,
               **{name: procs.submit(*task) for name, task in tasks.items()}}


@pytest.fixture(scope="module")
def jax_side():
    """The JAX package's spec and ENAS modules, imported once the
    references' processes are under way."""
    from katib_tpu.api import spec as jax_spec
    from katib_tpu.suggest.nas import enas as jax_enas

    return jax_spec, jax_enas


# -- search space and settings --------------------------------------------------

def test_operations_expand_as_jax_expands_them(jax_side):
    jax_spec, jax_enas = jax_side
    doc = _doc()
    got = enas.expand_operations(spec.ExperimentSpec.from_dict(doc).nas_config)
    want = jax_enas.expand_operations(jax_spec.ExperimentSpec.from_dict(doc).nas_config)
    assert got == want and len(got) == NUM_OPS
    assert [op["opt_type"] for op in got] == ["convolution"] * 6 + ["separable_convolution"] * 8 + ["reduction"] * 4
    pool_sizes = {op["opt_params"]["pool_size"] for op in got if op["opt_type"] == "reduction"}
    assert pool_sizes == {2, 3} and all(type(s) is int for s in pool_sizes)
    assert got[0]["opt_params"] == {"filter_size": "3", "num_filter": "32"}


def test_double_parameters_expand_as_jax_expands_them(jax_side):
    jax_spec, jax_enas = jax_side
    doc = _doc()
    doc["nasConfig"]["operations"] = [{"operationType": "convolution", "parameters": [
        {"name": "scale", "parameterType": "double", "feasibleSpace": {"min": "0.1", "max": "0.35", "step": "0.1"}}]}]
    got = enas.expand_operations(spec.ExperimentSpec.from_dict(doc).nas_config)
    assert got == jax_enas.expand_operations(jax_spec.ExperimentSpec.from_dict(doc).nas_config) and len(got) == 3


@pytest.mark.parametrize("settings", [
    {}, {"controller_hidden_size": "0"}, {"controller_hidden_size": "32"}, {"controller_temperature": "None"},
    {"controller_tanh_const": "None"}, {"controller_entropy_weight": "None"}, {"controller_skip_weight": "None"},
    {"controller_learning_rate": "None"}, {"controller_train_steps": "None"}, {"controller_baseline_decay": "1.5"},
    {"controller_learning_rate": "2"}, {"controller_skip_target": "-0.1"}, {"controller_train_steps": "0"},
    {"controller_log_every_steps": "0"}, {"controller_temperature": "hot"}, {"controller_hidden_size": "1.5"},
    {"controller_entropy_weight": "-1"}, {"bogus": "1"}, {"random_state": "7"}, {"n_population": "4"},
])
def test_settings_are_validated_as_jax_validates_them(settings, jax_side):
    jax_spec, jax_enas = jax_side
    doc = _doc(settings)
    outcomes = []
    for validate, parse in ((suggest.create("enas").validate_algorithm_settings, spec.ExperimentSpec.from_dict),
                            (jax_enas.ENAS().validate_algorithm_settings, jax_spec.ExperimentSpec.from_dict)):
        try:
            validate(parse(doc))
            outcomes.append("ok")
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]
    if outcomes[0] == "ok":
        parsed = enas.parse_enas_settings(spec.ExperimentSpec.from_dict(doc))
        assert parsed == jax_enas.parse_enas_settings(jax_spec.ExperimentSpec.from_dict(doc))


@pytest.mark.parametrize("nas_edit,message", [
    (lambda nas: nas.pop("operations"), "must not be empty"),
    (lambda nas: nas["graphConfig"].update(numLayers=0), "numLayers must be >= 1"),
    (lambda nas: nas["graphConfig"].pop("inputSizes"), "inputSizes and outputSizes"),
])
def test_bad_nas_configs_are_refused_as_jax_refuses_them(nas_edit, message, jax_side):
    jax_spec, jax_enas = jax_side
    doc = _doc()
    nas_edit(doc["nasConfig"])
    for validate, parse in ((suggest.create("enas").validate_algorithm_settings, spec.ExperimentSpec.from_dict),
                            (jax_enas.ENAS().validate_algorithm_settings, jax_spec.ExperimentSpec.from_dict)):
        with pytest.raises(ValueError, match=message):
            validate(parse(doc))


@pytest.mark.parametrize("setting", [("fused", "true"), ("fused", "1"), ("fused_generations", "4"),
                                     ("fused_population_size", "8"), ("fused_child_lr", "0.1")])
def test_the_fused_population_is_refused_by_name(setting):
    doc = _doc({setting[0]: setting[1], "random_state": "3", "n_population": "4"})
    with pytest.raises(spec.ValidationError, match=f"setting {setting[0]}: the fused ENAS population"):
        validate_spec(spec.ExperimentSpec.from_dict(doc), 1)
    validate_spec(spec.ExperimentSpec.from_dict(_doc({"fused": "false", "random_state": "3"})), 1)


def test_enas_json_validates_unchanged_through_the_port():
    validate_spec(spec.ExperimentSpec.from_dict(_doc()), 1)


def test_digits_is_refused_by_name():
    with pytest.raises(ValueError, match="scikit-learn"):
        enas_child.load_child_data("digits", 8, CPU)
    with pytest.raises(ValueError, match="unknown dataset 'mnist'"):
        enas_child.load_child_data("mnist", 8, CPU)


# -- the controller -------------------------------------------------------------

@pytest.mark.parametrize("shaping", list(SHAPINGS))
@pytest.mark.parametrize("index", range(len(SEEDS)))
def test_score_arc_matches_sample_and_score(references, shaping, index):
    want = {k: np.asarray(v[index]) if not isinstance(v, dict) else {n: np.asarray(g[index]) for n, g in v.items()}
            for k, v in references[f"scores-{shaping}"].result().items()}
    arc = want["arc"].tolist()
    assert len(arc) == CONTROLLER["num_layers"] * (CONTROLLER["num_layers"] + 1) // 2
    controller = _port_controller(_controller_params(), shaping)
    log_prob, entropy, penalty, count = controller.score_arc(arc)
    for name, got in (("log_prob", log_prob), ("entropy", entropy), ("skip_penalty", penalty),
                      ("skip_count", count)):
        np.testing.assert_allclose(float(got.detach()), want[name], atol=1e-5, rtol=1e-6, err_msg=name)
    assert not entropy.requires_grad
    for name, value in (("log_prob", log_prob), ("skip_penalty", penalty)):
        grads = torch.autograd.grad(value, list(controller.parameters()), allow_unused=True, retain_graph=True)
        for (param, _), g in zip(controller.named_parameters(), grads):
            got = np.zeros(_.shape, np.float32) if g is None else g.numpy()
            np.testing.assert_allclose(got, want[f"grad_{name}"][param], atol=1e-4, err_msg=f"{name}/{param}")


def test_sampling_is_the_scored_rollout():
    """A sampled arc's rollout scores equal score_arc's for that arc, and
    the same generator seed gives the same arcs."""
    controller = _port_controller(_controller_params())
    arc, *scores = controller.rollout(draws=controller.draw(torch.Generator().manual_seed(3)))
    for a, b in zip(scores, controller.score_arc(arc.tolist())):
        assert float(a.detach()) == float(b.detach())
    arcs = [_port_controller(_controller_params()).sample_arc(torch.Generator().manual_seed(3)) for _ in range(2)]
    assert arcs[0] == arcs[1] == arc.tolist()
    with pytest.raises(ValueError, match="draws or an arc"):
        controller.rollout()


def test_a_controller_round_matches_jax(references):
    arcs, want_params, want_baseline = references["round"].result()
    assert len(arcs) == ROUND_SETTINGS["controller_train_steps"]
    controller = _port_controller(_controller_params(1))
    optimizer = enas.make_controller_optimizer(controller, ROUND_SETTINGS["controller_learning_rate"])
    baseline = enas.train_controller(controller, optimizer, 0.0, ROUND_RESULT, ROUND_SETTINGS, arcs=arcs)
    np.testing.assert_allclose(baseline, want_baseline, atol=1e-6)
    moved = 0.0
    for name, value in controller.state_dict().items():
        np.testing.assert_allclose(value.numpy(), want_params[name], atol=1e-4, err_msg=name)
        moved = max(moved, float(np.abs(want_params[name] - _controller_params(1)[name]).max()))
    assert moved > 1e-3  # the round moved the parameters well past the tolerance


# -- the child network ------------------------------------------------------------

@pytest.mark.parametrize("name", list(CHILD_CASES))
def test_child_matches_flax(references, name):
    """Logits (1e-5), gradients and one Adam step (1e-4), NaN where JAX
    gives NaN; a parameter no output depends on gets no gradient here and a
    zero one in JAX. Adam's first step moves each element by lr * g / (|g|
    + 1e-8): where the gradient is zero up to rounding (the convolutions'
    biases, which a batch norm always follows, and sums that cancel) its
    sign is rounding noise, so there both steps are held to Adam's bound of
    lr instead of to each other."""
    want = references["child"].result()[name]
    port = _child_port(name)
    port.load_state_dict(enas_child_params_from_flax(references["params"][name]))
    x, y = references["inputs"][name]
    logits = port(_nchw(x))
    np.testing.assert_allclose(logits.detach().numpy(), want["logits"], atol=1e-5, equal_nan=True)
    loss = torch.nn.functional.cross_entropy(logits, torch.tensor(y, dtype=torch.long))
    loss.backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in port.named_parameters()}
    for key, value in enas_child_params_from_flax(want["grads"]).items():
        np.testing.assert_allclose(grads[key].numpy(), value.numpy(), atol=1e-4, equal_nan=True, err_msg=key)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    torch.optim.Adam(port.parameters(), lr=CHILD_LR, betas=(0.9, 0.999), eps=1e-8).step()
    want_grads = enas_child_params_from_flax(want["grads"])
    for key, value in enas_child_params_from_flax(want["stepped"]).items():
        got, value = port.state_dict()[key].numpy(), value.numpy()
        defined = ~(np.abs(want_grads[key].numpy()) < 1e-6)  # NaN counts as defined
        if key != "classifier.bias" and key.endswith(".bias"):
            defined[:] = False
        np.testing.assert_allclose(got[defined], value[defined], atol=1e-4, equal_nan=True, err_msg=key)
        for stepped in (got, value):
            assert (np.abs(stepped - before[key].numpy())[~defined] <= CHILD_LR * (1 + 1e-5)).all(), key
    if name == "empty_head":
        assert np.isnan(want["logits"]).all() and torch.isnan(logits).all()
        assert (logits.argmax(-1) == 0).all()  # argmax of NaN is the first class, as jnp.argmax's
    else:
        assert np.isfinite(want["logits"]).all()


def test_child_shapes_follow_the_arch():
    port = _child_port("every_op")
    assert [layer.shape_out for layer in port.plan] == [(4, 8, 8), (4, 8, 8), (8, 4, 4), (3, 8, 8), (15, 2, 2),
                                                         (58, 8, 8)]
    assert [layer.reads for layer in port.plan] == [[0], [1, 0], [2, 1], [3, 0, 2], [4, 1, 3], [5, 0, 3, 4]]
    assert set(dict(port.named_children())) == {"layer1_conv", "layer2_dw", "layer2_pw", "layer4_conv",
                                                "layer6_dw", "classifier"}
    assert [layer.shape_out for layer in _child_port("empty_then_skip").plan] == [(3, 0, 0), (4, 0, 0), (4, 2, 2)]


def test_dropout_masks_come_from_the_trial_generator():
    """Masks keep each pooled feature with probability 0.6 and scale the
    kept ones by 1 / 0.6, as flax's Dropout(0.4); the same seed gives the
    same masks."""
    port = enas_child.EnasChildNet([[0]], OPS, input_shape=(3, 8, 8))
    masks = [port.dropout_mask(64, torch.Generator().manual_seed(0)) for _ in range(2)]
    assert torch.equal(masks[0], masks[1]) and masks[0].shape == (64, 4)
    assert 0.45 < masks[0].float().mean() < 0.75
    assert enas_child.EnasChildNet([[0]], OPS, input_shape=(3, 8, 8), dropout_rate=0.0).dropout_mask(
        64, torch.Generator()) is None
    with torch.no_grad():
        port.classifier.weight.zero_()
        port.classifier.weight[:4] = torch.eye(4)  # logits 0-3 are the pooled features
        x = torch.randn(64, 3, 8, 8)
        kept, plain = port(x, masks[0])[:, :4], port(x)[:, :4]
    assert torch.allclose(kept, torch.where(masks[0], plain / 0.6, 0.0), atol=1e-6)


# -- the trial --------------------------------------------------------------------

@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_trial_batch_order_matches_jax(references, case):
    """Two epochs of the port's epoch loop, its step and evaluation
    stubbed, on images numbered as the JAX trial's were: the same training
    and validation batches in the same order. Where the validation split is
    smaller than a batch, both validate once on all of it (the JAX trial
    outside the batches it stages)."""
    n, batch_size = BATCH_CASES[case]
    want = references[f"batches-{case}"].result()
    x = torch.arange(n, dtype=torch.float32)[:, None, None, None].expand(n, 1, 2, 2)
    y = torch.arange(n) % 10
    split = int(n * 0.9)
    seen, epoch = [], {}

    def step(bx, by):
        epoch.setdefault("train", []).append(bx[:, 0, 0, 0].long().tolist())
        return torch.zeros(())

    def evaluate(bx, by):
        if len(bx) == n - split and len(bx) < batch_size:  # the whole-split fallback
            epoch.setdefault("whole", True)
        else:
            epoch.setdefault("valid", []).append(bx[:, 0, 0, 0].long().tolist())
        return torch.zeros(())

    class Reporter:
        def report(self, **metrics):
            seen.extend([epoch.pop("train"), epoch.pop("valid", [])])
            assert epoch.pop("whole", False) == (n - split < batch_size)

    enas_child.train_and_report(step, evaluate, (x[:split], y[:split]), (x[split:], y[split:]), batch_size, 2,
                                np.random.default_rng(0), Reporter())
    assert seen == want and len(seen) == 4


def _port_suggestions(doc, state_dir=None, n=2):
    s = suggest.create("enas", state_dir=state_dir, device=CPU)
    reply = s.get_suggestions(suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), [], n))
    return s, [{a.name: a.value for a in t.parameter_assignments} for t in reply.assignments]


def test_assignment_strings_are_the_jax_suggesters_and_parse_in_the_trial(jax_side):
    """The strings the JAX suggester would write for the port's arcs
    (organised per layer, the operations of the layers' ops, single
    quotes), parsed by the port's trial into a network of enas.json's
    8 layers."""
    jax_spec, jax_enas = jax_side
    doc = _doc()
    suggester, assignments = _port_suggestions(doc)
    ops = jax_enas.expand_operations(jax_spec.ExperimentSpec.from_dict(doc).nas_config)
    for values in assignments:
        arch, nn_config = enas_child.parse_assignments(values)
        flat = [v for layer in arch for v in layer]
        organized = [flat[l * (l + 1) // 2:(l + 1) * (l + 2) // 2] for l in range(8)]
        want_config = {"num_layers": 8, "input_sizes": [32, 32, 3], "output_sizes": [10],
                       "embedding": {layer[0]: ops[layer[0]] for layer in organized}}
        assert values["architecture"] == json.dumps(organized).replace('"', "'")
        assert values["nn_config"] == json.dumps(want_config).replace('"', "'")
        assert '"' not in values["architecture"] + values["nn_config"]
        net = enas_child.EnasChildNet(arch, nn_config["embedding"])
        assert len(net.plan) == 8 and net.classifier.out_features == 10


def test_the_controller_state_round_trips_and_a_bad_one_reseeds(tmp_path, caplog):
    doc = _doc({"controller_train_steps": "2", "random_state": "4"})
    first, _ = _port_suggestions(doc, str(tmp_path))
    path = tmp_path / enas.STATE_FILE
    assert path.exists() and not (tmp_path / (enas.STATE_FILE + ".tmp")).exists()
    state = first._state
    state["baseline"] = 0.25
    enas.train_controller(state["controller"], state["optimizer"], 0.0, 0.5, state["settings"], state["generator"])
    first._save()
    restored = suggest.create("enas", state_dir=str(tmp_path), device=CPU)
    got = restored._load_or_init(suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), [], 1))
    for key in ("baseline", "step", "first_run"):
        assert got[key] == state[key]
    for name, value in state["controller"].state_dict().items():
        assert torch.equal(got["controller"].state_dict()[name], value)
    for a, b in zip(state["optimizer"].state.values(), got["optimizer"].state.values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert torch.equal(got["generator"].get_state(), state["generator"].get_state())

    fresh = _port_suggestions(doc)[0]._state
    for content in (b"not a pickle", pickle.dumps({"params": {}, "opt_state": None}),
                    pickle.dumps({"format": enas.STATE_FORMAT, "params": {"w_lstm": np.zeros(3)}}),
                    b"\x80\x04cos\nsystem\n."):
        path.write_bytes(content)
        reseeded = suggest.create("enas", state_dir=str(tmp_path), device=CPU)
        with caplog.at_level("WARNING", logger="katib_tpu_torch.enas"):
            got = reseeded._load_or_init(suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(doc), [], 1))
        assert "reseeding controller" in caplog.text
        caplog.clear()
        assert got["first_run"] and got["baseline"] == 0.0
        for name, value in fresh["controller"].state_dict().items():
            assert torch.equal(got["controller"].state_dict()[name], value)


def test_the_suggester_without_a_device_asks_the_cuda_probe(monkeypatch):
    from katib_tpu_torch.utils import backend

    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(backend.BackendUnavailable):
            suggest.create("enas").get_suggestions(
                suggest.SuggestionRequest(spec.ExperimentSpec.from_dict(_doc()), [], 1))
    finally:
        backend.reset_probe_state()


# -- an experiment through the port's controller ------------------------------------

SMALL_OPS = [  # enas.json's operations at CPU size
    {"operationType": "convolution", "parameters": [
        {"name": "filter_size", "parameterType": "categorical", "feasibleSpace": {"list": ["3", "5"]}},
        {"name": "num_filter", "parameterType": "categorical", "feasibleSpace": {"list": ["4", "6"]}}]},
    {"operationType": "separable_convolution", "parameters": [
        {"name": "filter_size", "parameterType": "categorical", "feasibleSpace": {"list": ["3"]}},
        {"name": "num_filter", "parameterType": "categorical", "feasibleSpace": {"list": ["4"]}},
        {"name": "depth_multiplier", "parameterType": "categorical", "feasibleSpace": {"list": ["1", "2"]}}]},
    {"operationType": "reduction", "parameters": [
        {"name": "reduction_type", "parameterType": "categorical",
         "feasibleSpace": {"list": ["max_pooling", "avg_pooling"]}},
        {"name": "pool_size", "parameterType": "int", "feasibleSpace": {"min": "2", "max": "3", "step": "1"}}]},
]
SMALL_TRIAL = {"num_train_examples": "200", "batch_size": "32", "num_epochs": "1"}


def small_enas_trial(assignments, ctx=None):
    enas_child.run_enas_trial(dict(assignments, **SMALL_TRIAL), ctx)


def test_a_two_round_experiment_runs_through_the_port(tmp_path, monkeypatch):
    """enas.json cut to 2 layers and small filters, 4 trials 2 at a time on
    one CPU slot, through the port's controller: the suggester is asked 3
    times (2, then 1 and 1 as trials end), trains the controller from the
    second request on, and every trial succeeds with one finite accuracy
    and one loss."""
    doc = _doc({"controller_train_steps": "3"})
    doc["nasConfig"]["graphConfig"]["numLayers"] = 2
    doc["nasConfig"]["operations"] = SMALL_OPS
    doc.update(name="enas-cpu", maxTrialCount=4, parallelTrialCount=2)
    doc["trialTemplate"]["entryPoint"] = f"{__name__}:small_enas_trial"
    saved = []
    original = enas.ENAS._save

    def recording_save(self):
        saved.append({k: v.clone() for k, v in self._state["controller"].state_dict().items()})
        original(self)

    monkeypatch.setattr(enas.ENAS, "_save", recording_save)
    ctrl = ExperimentController(root_dir=str(tmp_path), devices=[CPU])
    try:
        ctrl.create_experiment(spec.ExperimentSpec.from_dict(doc))
        exp = ctrl.run("enas-cpu", timeout=120)
        trials = ctrl.list_trials("enas-cpu")
        logs = {t.name: ctrl.obs_store.get_observation_log(t.name) for t in trials}
    finally:
        ctrl.close()
    assert exp.status.condition.value == "Succeeded" and exp.status.reason.value == "ExperimentMaxTrialsReached"
    assert len(trials) == 4 and all(t.condition == TrialCondition.SUCCEEDED for t in trials), \
        [t.message for t in trials]
    for rows in logs.values():
        assert sorted(r.metric_name for r in rows) == ["Train-loss", "Validation-accuracy"]
        assert all(np.isfinite(float(r.value)) for r in rows)
    assert len(saved) == 3 and (tmp_path / "enas-cpu" / enas.STATE_FILE).exists()
    assert all(torch.equal(saved[0][k], v) for k, v in enas.EnasController(
        10, 2, generator=torch.Generator().manual_seed(0)).state_dict().items())
    for before, after in zip(saved, saved[1:]):
        assert any(not torch.equal(before[k], after[k]) for k in before)
