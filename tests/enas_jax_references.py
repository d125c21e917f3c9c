"""The JAX package's side of tests/test_torch_enas.py: each function runs
the JAX package's ENAS code on numpy inputs and returns numpy outputs.

A module of its own, which imports JAX and the JAX package only inside
its functions and never torch: the test process imports it for nothing
and hands its functions to spawned processes, which import JAX while the
test process goes on. XLA's compile time dominates at the tests' sizes,
so the programs compile with fewer optimisation passes (the arithmetic is
the same).
"""

import numpy as np

FEW_PASSES = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """fn(*args) as one XLA program; numpy results."""
    import jax

    return jax.device_get(jax.jit(fn).lower(*args).compile(compiler_options=FEW_PASSES)(*args))


def controller_scores(params, seeds, num_layers, temperature, tanh_const, skip_target):
    """For each seed's key: the arc ``_sample_and_score`` samples, its
    log_prob, entropy, skip_penalty and skip_count, and the gradients of
    log_prob and skip_penalty in the parameters."""
    import jax
    import jax.numpy as jnp

    from katib_tpu.suggest.nas import enas as jax_enas

    def one(p, key):
        def scores(q):
            out = jax_enas._sample_and_score(q, key, num_layers, temperature, tanh_const, skip_target)
            return jnp.stack([out[1], out[3]]), out

        jacobian, (arc, log_prob, entropy, penalty, count) = jax.jacrev(scores, has_aux=True)(p)
        return {"arc": arc, "log_prob": log_prob, "entropy": entropy, "skip_penalty": penalty,
                "skip_count": count, "grad_log_prob": jax.tree.map(lambda g: g[0], jacobian),
                "grad_skip_penalty": jax.tree.map(lambda g: g[1], jacobian)}

    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])
    return compiled(jax.vmap(one, in_axes=(None, 0)), params, keys)


def controller_round(params, seed, num_layers, settings, result):
    """The JAX suggester's own ``_train_controller`` loop from ``params``
    and a fresh Adam state: the arc each step sampled (recorded by a
    callback around ``_sample_and_score``), the parameters and the
    baseline after the round."""
    import jax
    import jax.numpy as jnp
    import optax

    from katib_tpu.suggest.nas import enas as jax_enas

    arcs = []
    original = jax_enas._sample_and_score

    def recording(*args, **kwargs):
        out = original(*args, **kwargs)
        jax.debug.callback(lambda arc: arcs.append(np.asarray(arc).tolist()), out[0])
        return out

    jax_enas._sample_and_score = recording
    try:
        params = jax.tree.map(jnp.asarray, params)
        state = {"params": params, "baseline": 0.0, "rng": jax.random.PRNGKey(seed), "step": 0,
                 "num_layers": num_layers,
                 "opt_state": optax.adam(float(settings["controller_learning_rate"])).init(params)}
        jax_enas.ENAS()._train_controller(state, None, result, settings)
    finally:
        jax_enas._sample_and_score = original
    return arcs, jax.device_get(state["params"]), state["baseline"]


def child_outputs(cases, params, inputs, lr):
    """For each case ({name: (arch, embedding)}), its network (dropout 0)
    on its (x, y): the logits, the gradient of the mean cross-entropy, and
    the parameters after one optax Adam step at ``lr``."""
    import jax
    import optax

    from katib_tpu.models import enas_child as jax_child

    models = {name: jax_child.EnasChildNet(arch=tuple(tuple(a) for a in arch), embedding=embedding, dropout_rate=0.0)
              for name, (arch, embedding) in cases.items()}
    tx = optax.adam(lr)

    def program(params, inputs):
        out = {}
        for name, model in models.items():
            x, y = inputs[name]

            def loss_fn(p):
                logits = model.apply({"params": p}, x, train=True)
                return optax.softmax_cross_entropy_with_integer_labels(logits, y).mean()

            p = params[name]
            grads = jax.grad(loss_fn)(p)
            updates, _ = tx.update(grads, tx.init(p), p)
            out[name] = {"logits": model.apply({"params": p}, x, train=True), "grads": grads,
                         "stepped": optax.apply_updates(p, updates)}
        return out

    return compiled(program, params, inputs)


def trial_batches(n, batch_size, num_epochs):
    """The JAX trial's training and validation batches over ``num_epochs``
    epochs: n images, image i all i (label i % 10), a one-layer 3x3
    convolution of 2 filters; the images' first pixels, batch by batch, in
    the order the trial trains and validates on them."""
    from katib_tpu.models import enas_child as jax_child
    from katib_tpu.utils import prefetch

    seen = []
    y = np.arange(n, dtype=np.int32)
    x = np.broadcast_to(y[:, None, None, None], (n, 2, 2, 1)).astype(np.float32)
    original, stage = jax_child.load_dataset, prefetch.prefetch_to_device

    def recording(iterator, *args, **kwargs):
        batches = list(iterator)
        seen.append([np.asarray(bx)[:, 0, 0, 0].astype(int).tolist() for bx, _ in batches])
        return stage(batches, *args, **kwargs)

    jax_child.load_dataset = lambda name, split, n=None: (x, y % 10)
    prefetch.prefetch_to_device = recording
    try:
        embedding = {"0": {"opt_id": 0, "opt_type": "convolution",
                           "opt_params": {"filter_size": "3", "num_filter": "2"}}}
        jax_child.run_enas_trial({
            "architecture": "[[0]]", "nn_config": str({"embedding": embedding, "output_sizes": [10]}),
            "num_epochs": str(num_epochs), "batch_size": str(batch_size)})
    finally:
        jax_child.load_dataset = original
        prefetch.prefetch_to_device = stage
    return seen
