"""katib_tpu_torch.parallel.train against katib_tpu.parallel.train on the CPU.

Three AdamW steps of the port's train step, started from the JAX step's own
initial parameters (carried over with lm_state_dict_from_flax), give the
JAX step's losses, in f32 (1e-4) and in bf16, the main path's dtype (3e-2);
the optimizer alone matches optax.adamw; the trial entry point keeps the
JAX trial's report cadence and refuses head dims above 128. Width: vocab
512, E 128, 1 layer, 4 heads, at T = 64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from katib_tpu.models.transformer import TransformerConfig as JaxConfig
from katib_tpu.parallel.train import lm_loss as jax_lm_loss
from katib_tpu.parallel.train import make_lm_train_step as jax_make_lm_train_step
from katib_tpu_torch.db.store import InMemoryObservationStore
from katib_tpu_torch.models.convert import lm_state_dict_from_flax
from katib_tpu_torch.models.transformer import TransformerConfig
from katib_tpu_torch.parallel import train
from katib_tpu_torch.runtime.context import TrialContext
from katib_tpu_torch.runtime.metrics import MetricsReporter
from katib_tpu_torch.utils import backend

WIDTH = dict(vocab_size=512, embed_dim=128, num_layers=1, num_heads=4, max_seq_len=64)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX compiles and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_three_adamw_steps_match_jax():
    lr = 1e-3
    data = np.random.default_rng(0).integers(0, 512, size=(2, 65), dtype=np.int32)
    params, opt_state, step_fn, put_batch = jax_make_lm_train_step(
        JaxConfig(**WIDTH, dtype=jnp.float32), None, lr
    )
    state = lm_state_dict_from_flax(jax.device_get(params))
    batch = put_batch(data[:, :-1], data[:, 1:])
    want = []
    for _ in range(3):
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        want.append(float(loss))

    model, _, port_step, port_batch = train.make_lm_train_step(
        TransformerConfig(**WIDTH, dtype=torch.float32), torch.device("cpu"), lr
    )
    model.load_state_dict(state)
    batch = port_batch(data[:, :-1], data[:, 1:])
    got = [float(port_step(*batch)) for _ in range(3)]
    assert want[2] < want[0]
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bf16_adamw_steps_match_jax():
    """The main path's dtype: three AdamW steps of the LM in bf16 (f32
    parameters, bf16 activations) against the JAX step, at T 64, to the
    bf16 tolerance 3e-2. The two differ by rounding: among other places, the
    port's tied head rounds the f32 logit gradient to bf16 once before both
    of its products (katib_tpu_torch/models/transformer.py:170-173), where
    JAX takes the f32 cotangent into both products."""
    lr = 1e-3
    data = np.random.default_rng(3).integers(0, 512, size=(2, 65), dtype=np.int32)
    params, opt_state, step_fn, put_batch = jax_make_lm_train_step(
        JaxConfig(**WIDTH, dtype=jnp.bfloat16), None, lr
    )
    state = lm_state_dict_from_flax(jax.device_get(params))
    batch = put_batch(data[:, :-1], data[:, 1:])
    want = []
    for _ in range(3):
        params, opt_state, loss = step_fn(params, opt_state, *batch)
        want.append(float(loss))

    model, _, port_step, port_batch = train.make_lm_train_step(
        TransformerConfig(**WIDTH, dtype=torch.bfloat16), torch.device("cpu"), lr
    )
    model.load_state_dict(state)
    batch = port_batch(data[:, :-1], data[:, 1:])
    got = [float(port_step(*batch)) for _ in range(3)]
    assert want[2] < want[0] and got[2] < got[0]
    np.testing.assert_allclose(got, want, atol=3e-2)


def test_lm_loss_matches_optax():
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(2, 5, 11)).astype(np.float32) * 3
    targets = rng.integers(0, 11, size=(2, 5))
    want = float(jax.jit(jax_lm_loss)(jnp.asarray(logits), jnp.asarray(targets)))
    got = float(train.lm_loss(torch.tensor(logits), torch.tensor(targets)))
    assert abs(got - want) <= 1e-5


def test_adamw_matches_optax_adamw():
    """The optimizer settings behind make_lm_train_step: decoupled decay 0.01,
    betas (0.9, 0.999), eps 1e-8, on a parameter with fixed gradients."""
    rng = np.random.default_rng(2)
    p0 = rng.normal(size=(7,)).astype(np.float32)
    grads = [rng.normal(size=(7,)).astype(np.float32) for _ in range(4)]
    tx = optax.adamw(3e-2, weight_decay=0.01)
    p, state = jnp.asarray(p0), tx.init(jnp.asarray(p0))

    @jax.jit
    def step(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state

    for g in grads:
        p, state = step(jnp.asarray(g), state, p)
    w = torch.nn.Parameter(torch.tensor(p0))
    opt = torch.optim.AdamW([w], lr=3e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for g in grads:
        w.grad = torch.tensor(g)
        opt.step()
    np.testing.assert_allclose(w.detach().numpy(), np.asarray(p), atol=1e-6)


def _ctx(store, name="t"):
    return TrialContext(trial_name=name, experiment_name="e", assignments={},
                        reporter=MetricsReporter(store, name), devices=[torch.device("cpu")])


TINY = {"vocab_size": "64", "embed_dim": "32", "num_layers": "1", "num_heads": "2",
        "seq_len": "16", "batch_size": "2", "learning_rate": "1e-2"}


@pytest.mark.parametrize("steps,reports", [(5, 1), (7, 2), (10, 2)])
def test_trial_report_cadence(steps, reports):
    store = InMemoryObservationStore()
    train.run_lm_trial(dict(TINY, num_steps=str(steps)), _ctx(store))
    losses = [float(r.value) for r in store.get_observation_log("t", "loss")]
    assert len(losses) == reports and all(np.isfinite(losses))


def test_trial_loss_falls_on_its_fixed_batch():
    store = InMemoryObservationStore()
    train.run_lm_trial(dict(TINY, num_steps="10"), _ctx(store))
    first, last = (float(r.value) for r in store.get_observation_log("t", "loss"))
    assert last < first


def test_head_dims_above_128_are_refused_up_front():
    with pytest.raises(ValueError, match="up to 128"):
        train.run_lm_trial(dict(TINY, embed_dim="512", num_heads="2", num_steps="1"), None)


@pytest.mark.parametrize("axis", ["tensor_parallel", "sequence_parallel"])
def test_parallelism_is_a_later_slice(axis):
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        train.run_lm_trial(dict(TINY, num_steps="1", **{axis: "2"}), _ctx(InMemoryObservationStore()))


def test_trial_without_devices_asks_the_cuda_probe(monkeypatch):
    backend.reset_probe_state()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(backend.BackendUnavailable):
            train.run_lm_trial(dict(TINY, num_steps="1"), None)
    finally:
        backend.reset_probe_state()


def test_put_batch_stages_long_tokens_and_positions():
    *_, put_batch = train.make_lm_train_step(
        TransformerConfig(vocab_size=16, embed_dim=32, num_layers=1, num_heads=2, dtype=torch.float32),
        "cpu",
    )
    tokens, targets, positions = put_batch(np.zeros((2, 5), np.int32), np.ones((2, 5), np.int32))
    assert tokens.dtype == targets.dtype == torch.long
    assert positions.tolist() == [[0, 1, 2, 3, 4]] * 2
