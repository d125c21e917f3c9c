"""The JAX package's side of tests/test_torch_darts.py: each function runs
one JAX program on numpy inputs and returns numpy outputs.

A module of its own, importing JAX and the JAX package but not torch, so
that the processes test_torch_darts.py spawns to compute these programs in
parallel start quickly. XLA's compile time dominates these programs at the
tests' sizes, so they compile with fewer optimisation passes (the
arithmetic is the same).
"""

import jax
import jax.numpy as jnp
import optax

from katib_tpu.models import darts_derived as jax_derived
from katib_tpu.models import darts_supernet as jax_supernet
from katib_tpu.models import darts_trainer as jax_trainer
from katib_tpu.ops import darts_ops as jax_ops

FEW_PASSES = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def compiled(fn, *args):
    """fn(*args) as one XLA program; numpy results."""
    return jax.device_get(jax.jit(fn).lower(*args).compile(compiler_options=FEW_PASSES)(*args))


def op_module(name, stride, channels_out):
    if name.startswith("std_conv"):
        return jax_ops.StdConv(channels=channels_out, kernel_size=int(name[-1]), stride=stride)
    if name == "factorized_reduce":
        return jax_ops.FactorizedReduce(channels=channels_out)
    return jax_ops.make_op(name, 4, stride)


def op_outputs(cases, channels_out, params, x):
    """{"name-stride": output} of every case, one program."""
    modules = {f"{n}-{s}": op_module(n, s, channels_out) for n, s in cases}
    return compiled(lambda p, x: {k: m.apply({"params": p[k]}, x) for k, m in modules.items()}, params, x)


def supernet_outputs(primitives, net, params, x):
    """The supernet's logits and genotype."""
    model = jax_supernet.DartsSupernet(primitives=primitives, **net)
    logits = compiled(lambda p, x: model.apply({"params": p}, x), params, x)
    return logits, jax_supernet.genotype(params, primitives, net["num_nodes"])


def architect_grad(primitives, net, mode, architect, params, train_batch, valid_batch):
    """``architect_alpha_grad`` with a momentum buffer of 0.01."""
    model = jax_supernet.DartsSupernet(primitives=primitives, **net)

    def program(weights, alphas, tb, vb):
        mom = jax.tree.map(lambda w: 0.01 * jnp.ones_like(w), weights)
        return jax_trainer.architect_alpha_grad(model, weights, alphas, mom, tb, vb, hessian_mode=mode, **architect)

    return compiled(program, *jax_supernet.split_params(params), train_batch, valid_batch)


def search_steps(primitives, net, mode, settings, schedule, params, batches):
    """Steps of the JAX package's compiled search step over ``batches``
    (stacked train and valid batches, one per step): the parameters
    (weights and alphas) after them and the losses."""
    model = jax_supernet.DartsSupernet(primitives=primitives, **net)
    s = settings
    step = jax_trainer._compiled_search_step(model, schedule, s["w_lr_min"], s["w_grad_clip"], mode)
    weights, alphas = jax_supernet.split_params(params)
    w_state = jax_trainer._make_w_tx(s["w_weight_decay"], s["w_momentum"], s["w_lr"], s["w_grad_clip"]).init(weights)
    a_state = jax_trainer._make_a_tx(s["alpha_weight_decay"], s["alpha_lr"]).init(alphas)
    hyper = {k: jnp.float32(s[k]) for k in ("w_lr", "w_momentum", "w_weight_decay", "alpha_lr", "alpha_weight_decay")}

    def program(weights, alphas, w_state, a_state, batches):
        def body(carry, inputs):
            i, tb, vb = inputs
            *carry, loss = step(*carry, i, hyper, tb, vb)
            return tuple(carry), loss

        n = len(batches[0][0])
        (w, a, _, _), losses = jax.lax.scan(body, (weights, alphas, w_state, a_state), (jnp.arange(n),) + batches)
        return jax_supernet.merge_params(w, a), losses

    return compiled(program, weights, alphas, w_state, a_state, batches)


def derived_outputs(gene, net, retrain, params, x, y, steps):
    """The derived network's logits on ``x``, then ``steps`` steps of the
    JAX retraining's update (decay, clip, SGD with momentum at a cosine
    schedule; darts_derived.py:172-190) on equal slices of ``x``: their
    losses and the parameters after them."""
    model = jax_derived.DerivedNetwork(normal=jax_derived.gene_from_json(gene["normal"]),
                                       reduce=jax_derived.gene_from_json(gene["reduce"]), **net)
    r = retrain
    tx = optax.chain(optax.add_decayed_weights(r["weight_decay"]), optax.clip_by_global_norm(r["grad_clip"]),
                     optax.sgd(optax.cosine_decay_schedule(r["lr"], r["total_steps"]), momentum=r["momentum"]))

    def program(p, x, y):
        def body(carry, batch):
            p, state = carry

            def loss_fn(q):
                logits = model.apply({"params": q}, batch[0])
                return optax.softmax_cross_entropy_with_integer_labels(logits, batch[1]).mean()

            loss, grads = jax.value_and_grad(loss_fn)(p)
            updates, state = tx.update(grads, state, p)
            return (optax.apply_updates(p, updates), state), loss

        batches = (x.reshape(steps, -1, *x.shape[1:]), y.reshape(steps, -1))
        (p_end, _), losses = jax.lax.scan(body, (p, tx.init(p)), batches)
        return model.apply({"params": p}, x), losses, p_end

    return compiled(program, params, x, y)
