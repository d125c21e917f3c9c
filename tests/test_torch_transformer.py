"""katib_tpu_torch.models against katib_tpu.models.transformer on the CPU.

The flax LM runs at the CPU smoke width (bench_lm_config(_, on_tpu=False):
vocab 512, E 128, 2 layers, 4 heads, f32) with T = 128, on a parameter tree
of the flax init's shapes drawn with numpy; the tree is carried into the
port with lm_state_dict_from_flax, and both models see the same numpy
tokens.
Tolerances are those of tests/test_ops_pallas.py: forward 1e-5, bf16 3e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from katib_tpu.models import transformer as jt
from katib_tpu.parallel.train import lm_loss as jax_lm_loss
from katib_tpu_torch.models import transformer as pt
from katib_tpu_torch.models.convert import lm_state_dict_from_flax
from katib_tpu_torch.parallel.train import lm_loss

T = 128


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one torch thread, so no idle OpenMP team
    spins beside the JAX compiles and the other tests' processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(jax_dtype, torch_dtype):
    kwargs, _, _, _ = jt.bench_lm_config("large", on_tpu=False)
    kwargs = dict(kwargs, max_seq_len=T)
    return (jt.TransformerConfig(**dict(kwargs, dtype=jax_dtype)),
            pt.TransformerConfig(**dict(kwargs, dtype=torch_dtype)))


def _flax_params(cfg, seed=0):
    """A flax parameter tree of the LM drawn with numpy, at JAX init scales."""
    rng = np.random.default_rng(seed)
    e, h, d, hidden = cfg.embed_dim, cfg.num_heads, cfg.head_dim, cfg.embed_dim * cfg.mlp_ratio

    def normal(shape, fan_in):
        return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(np.float32)

    params = {"embed": (0.02 * rng.normal(size=(cfg.vocab_size, e))).astype(np.float32),
              "ln_f": {"scale": (1 + 0.1 * rng.normal(size=e)).astype(np.float32)}}
    for i in range(cfg.num_layers):
        params[f"block{i}"] = {
            "ln1": {"scale": (1 + 0.1 * rng.normal(size=e)).astype(np.float32)},
            "ln2": {"scale": (1 + 0.1 * rng.normal(size=e)).astype(np.float32)},
            "attn": {"qkv": {"kernel": normal((e, 3, h, d), e)}, "out": {"kernel": normal((h, d, e), h * d)}},
            "mlp": {"up": {"kernel": normal((e, hidden), e)}, "gate": {"kernel": normal((e, hidden), e)},
                    "down": {"kernel": normal((hidden, e), hidden)}},
        }
    return params


def _pair(jax_dtype, torch_dtype, num_layers=None):
    """(tokens, flax logits, flax loss, port logits, flax params, port model)."""
    jcfg, tcfg = _configs(jax_dtype, torch_dtype)
    if num_layers is not None:
        jcfg, tcfg = (dataclasses.replace(c, num_layers=num_layers) for c in (jcfg, tcfg))
    data = np.random.default_rng(0).integers(0, jcfg.vocab_size, size=(2, T + 1), dtype=np.int32)
    params = _flax_params(jcfg)
    model = jt.TransformerLM(jcfg)

    @jax.jit
    def forward(params, tokens, targets):
        logits = model.apply({"params": params}, tokens)
        return logits, jax_lm_loss(logits, targets)

    logits, loss = forward(params, jnp.asarray(data[:, :-1]), jnp.asarray(data[:, 1:]))
    port = pt.TransformerLM(tcfg)
    port.load_state_dict(lm_state_dict_from_flax(params))
    with torch.no_grad():
        port_logits = port(torch.as_tensor(data[:, :-1]).long())
    return data, np.asarray(logits), float(loss), port_logits, params, port


@pytest.fixture(scope="module")
def f32_pair():
    return _pair(jnp.float32, torch.float32)


def test_flax_tree_has_the_init_shapes():
    jcfg, _ = _configs(jnp.float32, torch.float32)
    shapes = jax.eval_shape(jt.TransformerLM(jcfg).init, jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    want = jax.tree_util.tree_map(lambda x: x.shape, shapes["params"])
    assert want == jax.tree_util.tree_map(lambda x: x.shape, _flax_params(jcfg))


def test_logits_match_flax(f32_pair):
    _, logits, _, port_logits, _, _ = f32_pair
    assert port_logits.dtype == torch.float32 and port_logits.shape == (2, T, 512)
    np.testing.assert_allclose(port_logits.numpy(), logits, atol=1e-5)


def test_loss_matches_flax(f32_pair):
    data, _, loss, port_logits, _, _ = f32_pair
    assert abs(float(lm_loss(port_logits, torch.as_tensor(data[:, 1:]))) - loss) <= 1e-5


def test_bfloat16_logits_match_flax():
    """One block carries every bf16 dtype step (RMSNorm's f32 output, rotary
    in x's dtype, the f32 head)."""
    data, logits, loss, port_logits, _, _ = _pair(jnp.bfloat16, torch.bfloat16, num_layers=1)
    assert port_logits.dtype == torch.float32  # the head sums in f32, as in JAX
    np.testing.assert_allclose(port_logits.numpy(), logits, atol=3e-2)
    assert abs(float(lm_loss(port_logits, torch.as_tensor(data[:, 1:]))) - loss) <= 3e-2


def test_state_dict_covers_every_parameter(f32_pair):
    _, _, _, _, params, port = f32_pair
    converted = lm_state_dict_from_flax(params)
    expected = port.state_dict()
    assert set(converted) == set(expected)
    for name, tensor in converted.items():
        assert tensor.shape == expected[name].shape, name
    n_flax = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(params))
    assert n_flax == sum(p.numel() for p in port.parameters())


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_rotary_matches_jax(dtypes):
    jax_dtype, torch_dtype = dtypes
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 16, 4, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 19, dtype=np.int32), (2, 16))
    want = jax.jit(jt.rotary_embed)(jnp.asarray(x, dtype=jax_dtype), jnp.asarray(pos))
    got = pt.rotary_embed(torch.tensor(x, dtype=torch_dtype), torch.as_tensor(pos.copy()))
    assert got.dtype == torch_dtype
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, dtype=np.float32),
                               atol=1e-5 if torch_dtype == torch.float32 else 3e-2)


@pytest.mark.parametrize("dtypes", [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)],
                         ids=["f32", "bf16"])
def test_rmsnorm_matches_jax_with_f32_output(dtypes):
    jax_dtype, torch_dtype = dtypes
    x = np.random.default_rng(2).normal(size=(2, 5, 32)).astype(np.float32)
    scale = np.linspace(0.5, 1.5, 32).astype(np.float32)
    want = jax.jit(jt.RMSNorm().apply)({"params": {"scale": scale}}, jnp.asarray(x, dtype=jax_dtype))
    norm = pt.RMSNorm(32)
    norm.scale.data = torch.tensor(scale)
    got = norm(torch.tensor(x, dtype=torch_dtype))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32  # bf16 * f32 scale -> f32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)


def test_config_defaults_follow_the_jax_package():
    jcfg, tcfg = jt.TransformerConfig(), pt.TransformerConfig()
    assert tcfg.dtype == torch.bfloat16 and jcfg.dtype == jnp.bfloat16
    for field in ("vocab_size", "embed_dim", "num_layers", "num_heads", "mlp_ratio", "max_seq_len",
                  "causal", "num_experts", "head_dim"):
        assert getattr(tcfg, field) == getattr(jcfg, field), field


@pytest.mark.parametrize("size", ["large", "small", "cpu_smoke"])
def test_bench_lm_config_matches_jax(size):
    on = size != "cpu_smoke"
    jkw, jb, js, jsize = jt.bench_lm_config(size, on_tpu=on)
    tkw, tb, ts, tsize = pt.bench_lm_config(size, on_gpu=on)
    assert (jb, js, jsize) == (tb, ts, tsize)
    assert {k: v for k, v in jkw.items() if k != "dtype"} == {k: v for k, v in tkw.items() if k != "dtype"}
    assert str(tkw["dtype"]).replace("torch.", "") == jnp.dtype(jkw["dtype"]).name


def test_large_width_has_168m_parameters():
    kwargs, _, _, _ = pt.bench_lm_config("large", on_gpu=True)
    cfg = pt.TransformerConfig(**kwargs)
    e, hidden = cfg.embed_dim, cfg.embed_dim * cfg.mlp_ratio
    per_block = 3 * e * e + e * e + 3 * e * hidden + 2 * e
    total = cfg.vocab_size * e + cfg.num_layers * per_block + e
    assert total == 134_234_112 + 33_554_432 + 1024 and round(total / 1e6) == 168


def test_seeded_init_is_reproducible_and_lecun_scaled():
    cfg = dataclasses.replace(_configs(jnp.float32, torch.float32)[1], num_layers=1)
    a = pt.TransformerLM(cfg, generator=torch.Generator().manual_seed(3))
    b = pt.TransformerLM(cfg, generator=torch.Generator().manual_seed(3))
    c = pt.TransformerLM(cfg, generator=torch.Generator().manual_seed(4))
    assert all(torch.equal(x, b.state_dict()[n]) for n, x in a.state_dict().items())
    assert not torch.equal(a.embed, c.embed)
    w = a.blocks[0].attn.qkv.weight
    assert abs(float(w.detach().std()) - (1 / cfg.embed_dim) ** 0.5) < 0.01
    assert float(w.detach().abs().max()) <= 2 * (1 / cfg.embed_dim) ** 0.5 / 0.87962566103423978 + 1e-6
    assert abs(float(a.embed.std()) - 0.02) < 0.002


def test_mixture_of_experts_is_a_later_slice():
    cfg = dataclasses.replace(pt.TransformerConfig(), num_experts=4)
    with pytest.raises(NotImplementedError, match="mixture-of-experts"):
        pt.Block(cfg)


def test_cpu_bfloat16_head_sums_in_f32():
    x = torch.randn(1, 3, 8).to(torch.bfloat16)
    emb = torch.randn(5, 8).to(torch.bfloat16)
    got = pt.tied_logits(x, emb)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), x.double().matmul(emb.double().t()).numpy(), atol=1e-5, rtol=0)
