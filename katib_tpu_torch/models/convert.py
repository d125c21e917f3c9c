"""Carry the JAX package's parameters into the port's models: the LM's
(``lm_state_dict_from_flax``), the MNIST network's
(``mnist_params_from_flax``), the DARTS supernet's and derived
network's (``darts_params_from_flax``), and ENAS's child network
(``enas_child_params_from_flax``) and controller
(``enas_controller_params_from_jax``).

The input is a flax parameter tree (``katib_tpu/models/transformer.py``,
``katib_tpu/models/mnist_cnn.py``) with numpy arrays as leaves; the output
is a ``state_dict`` for this package's model. Layout changes: flax kernels
are [in, out] and torch weights [out, in]; the attention's ``DenseGeneral``
kernels [E, 3, H, D] and [H, D, E] are flattened to [3*H*D, E] and [E, H*D].
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _t(x: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32))


def lm_state_dict_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    if "params" in params and "embed" not in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {"embed": _t(params["embed"])}
    layers = sorted(
        (int(name[len("block"):]) for name in params if name.startswith("block")),
    )
    for i in layers:
        src = params[f"block{i}"]
        dst = f"blocks.{i}."
        if "moe" in src:
            raise NotImplementedError("mixture-of-experts blocks are a later slice of the port")
        out[dst + "ln1.scale"] = _t(src["ln1"]["scale"])
        out[dst + "ln2.scale"] = _t(src["ln2"]["scale"])
        qkv = np.asarray(src["attn"]["qkv"]["kernel"])  # [E, 3, H, D]
        out[dst + "attn.qkv.weight"] = _t(qkv.reshape(qkv.shape[0], -1).T)
        o = np.asarray(src["attn"]["out"]["kernel"])    # [H, D, E]
        out[dst + "attn.out.weight"] = _t(o.reshape(-1, o.shape[-1]).T)
        for name in ("up", "gate", "down"):
            out[dst + f"mlp.{name}.weight"] = _t(np.asarray(src["mlp"][name]["kernel"]).T)
    out["ln_f.scale"] = _t(params["ln_f"]["scale"])
    return out


def mnist_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's ``MnistCNN`` parameters as a ``state_dict`` of this
    package's ``MnistCNN``: conv kernels HWIO -> OIHW, dense kernels [in,
    out] -> [out, in], and the first dense layer's rows from flax's (h, w, c)
    flatten order to the (c, h, w) order of an NCHW flatten."""
    if "params" in params and "Conv_0" not in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for i in (0, 1):
        out[f"conv{i + 1}.weight"] = _t(np.asarray(params[f"Conv_{i}"]["kernel"]).transpose(3, 2, 0, 1))
        out[f"conv{i + 1}.bias"] = _t(params[f"Conv_{i}"]["bias"])
    fc1 = np.asarray(params["Dense_0"]["kernel"])  # [7 * 7 * C, hidden], rows in (h, w, c) order
    channels = np.asarray(params["Conv_1"]["kernel"]).shape[-1]
    fc1 = fc1.reshape(7, 7, channels, -1).transpose(2, 0, 1, 3).reshape(fc1.shape)
    out["fc1.weight"] = _t(fc1.T)
    out["fc1.bias"] = _t(params["Dense_0"]["bias"])
    out["fc2.weight"] = _t(np.asarray(params["Dense_1"]["kernel"]).T)
    out["fc2.bias"] = _t(params["Dense_1"]["bias"])
    return out


def darts_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """A DARTS supernet's (alphas included) or derived network's flax
    parameters as a ``state_dict`` of the port's ``DartsSupernet`` or
    ``DerivedNetwork``, whose modules carry the flax tree's names. Paths
    join with "."; a ``StdConv``'s ``MatmulConv_0`` is its ``conv``;
    ``alpha_normal_3`` is ``alpha_normal.3``, copied as it is. Kernels
    become weights: convolutions [kh, kw, C, F] -> [F, C, kh, kw]
    (depthwise [kh, kw, 1, C] -> [C, 1, kh, kw]), dense [in, out] -> [out,
    in]; biases as they are."""
    if "params" in params and "stem" not in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(tree: Mapping[str, Any], path: tuple) -> None:
        for name, value in tree.items():
            if isinstance(value, Mapping):
                walk(value, path + ("conv" if name == "MatmulConv_0" else name,))
                continue
            leaf = np.asarray(value)
            if name.startswith("alpha_"):
                kind, node = name.rsplit("_", 1)
                out[".".join(path + (kind, node))] = _t(leaf)
            elif name == "kernel":
                out[".".join(path + ("weight",))] = _t(leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T)
            elif name == "bias":
                out[".".join(path + ("bias",))] = _t(leaf)
            else:
                raise KeyError(f"unexpected DARTS parameter {'/'.join(path + (name,))}")

    walk(params, ())
    return out


def enas_child_params_from_flax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """An ENAS child network's flax parameters (``layer1_conv``,
    ``layer2_dw``, ``layer2_pw``, ``classifier``) as a ``state_dict`` of the
    port's ``EnasChildNet``, whose modules carry the same names:
    convolution kernels HWIO -> OIHW, the dense kernel [in, out] -> [out,
    in], biases as they are."""
    if "params" in params and "classifier" not in params:
        params = params["params"]
    out: Dict[str, torch.Tensor] = {}
    for module, leaves in params.items():
        kernel = np.asarray(leaves["kernel"])
        out[f"{module}.weight"] = _t(kernel.transpose(3, 2, 0, 1) if kernel.ndim == 4 else kernel.T)
        out[f"{module}.bias"] = _t(leaves["bias"])
    return out


def enas_controller_params_from_jax(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX ENAS controller's parameter dict (``w_lstm``, ``g_emb``, ...)
    as a ``state_dict`` of the port's ``EnasController``: the same names and
    layouts."""
    return {name: _t(value) for name, value in params.items()}
